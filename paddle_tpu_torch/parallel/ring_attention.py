"""Ring attention: sequence parallelism over a mesh axis.

The port's counterpart of the JAX package's ``parallel/ring_attention.py``.
The sequence is split over the ``sp`` ranks; each rank keeps its query
shard, and the key/value shards rotate around the ring by ``ppermute``
for ``p`` rounds while each rank accumulates the streaming-softmax state
(running max ``m``, denominator ``l``, weighted accumulator ``o``, all in
float32).  With ``causal`` a key is masked by its global position
(``rows >= cols`` with each shard's offset), the shards lying in
sequence order along the axis.  The blockwise attention is plain torch
(matmuls and a softmax), as the JAX package's ``_block_attn`` is plain
``jnp``; it is differentiable through the rotation.
"""
from __future__ import annotations

import math

import torch

from . import collective

__all__ = ["ring_attention", "ring_attention_sharded"]

NEG_INF = -1e30


def _block_attn(q, k, v, sm_scale, mask):
    """One blockwise contribution with its streaming-softmax statistics:
    q [B,H,Tq,D], k/v [B,H,Tk,D], mask [Tq,Tk] or None."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * sm_scale
    if mask is not None:
        s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v)
    return m, l, o


def ring_attention(qs, ks, vs, causal=False, sm_scale=None):
    """Attention over the whole sequence split over the ranks of a ring.

    ``qs``, ``ks`` and ``vs`` hold each rank's sequence shard
    ``[B, H, T_local, D]`` (a list in ring order, each on its rank's
    device); returns each rank's output shard, in the queries' dtype."""
    collective.count_engine("ring")
    p = len(qs)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(qs[0].shape[-1])
    B, H, Tl, D = qs[0].shape
    perm = [(i, (i + 1) % p) for i in range(p)]
    qf = [q.float() for q in qs]
    k_cur, v_cur = list(ks), list(vs)
    m_acc = [torch.full((B, H, Tl), NEG_INF, dtype=torch.float32, device=q.device)
             for q in qs]
    l_acc = [torch.zeros((B, H, Tl), dtype=torch.float32, device=q.device)
             for q in qs]
    o_acc = [torch.zeros((B, H, Tl, D), dtype=torch.float32, device=q.device)
             for q in qs]
    for r in range(p):
        for i in range(p):
            src = (i - r) % p   # whose key/value shard rank i holds this round
            mask = None
            if causal:
                rows = torch.arange(Tl, device=qs[i].device)[:, None] + i * Tl
                cols = torch.arange(Tl, device=qs[i].device)[None, :] + src * Tl
                mask = rows >= cols
            m_blk, l_blk, o_blk = _block_attn(
                qf[i], k_cur[i].float(), v_cur[i].float(), sm_scale, mask)
            m_new = torch.maximum(m_acc[i], m_blk)
            a_old = torch.exp(m_acc[i] - m_new)
            a_blk = torch.exp(m_blk - m_new)
            l_acc[i] = l_acc[i] * a_old + l_blk * a_blk
            o_acc[i] = o_acc[i] * a_old[..., None] + o_blk * a_blk[..., None]
            m_acc[i] = m_new
        if r + 1 < p:
            k_cur = collective.ppermute(k_cur, perm)
            v_cur = collective.ppermute(v_cur, perm)
    return [(o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
            for o, l, q in zip(o_acc, l_acc, qs)]


def ring_attention_sharded(q, k, v, mesh, axis_name="sp", causal=False,
                           sm_scale=None):
    """Global ``[B, H, T, D]`` q/k/v with T split over ``axis_name`` of
    ``mesh``: each rank of the axis takes its shard, the ring runs, and
    the output shards are concatenated back."""
    devs = collective.axis_devices(mesh, axis_name)
    p = len(devs)

    def split(x):
        return [c.to(d) for c, d in zip(x.chunk(p, 2), devs)]

    outs = ring_attention(split(q), split(k), split(v), causal=causal,
                          sm_scale=sm_scale)
    return torch.cat([o.to(q.device) for o in outs], 2)
