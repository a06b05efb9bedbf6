"""All-to-all sequence parallelism (DeepSpeed-Ulysses), the second
sequence-parallel engine beside ring attention.

The port's counterpart of the JAX package's ``parallel/ulysses.py``.
Each rank trades its sequence shard of every head for the whole sequence
of ``H / p`` heads (``all_to_all`` over the ``sp`` ranks), runs
attention over the whole sequence locally, and trades back.  The head
count must divide by the axis size.

The local attention is the port's :func:`~paddle_tpu_torch.parallel.
flash_attention.flash_attention`: on a CUDA tensor the hand-written flash
forward (B1) and backward (B2) kernels, on a CPU tensor their plain
versions.  The JAX package calls ``mha_reference`` here, the plain
version of its flash kernel (ROADMAP R-11).  Differentiable end to end.
"""
from __future__ import annotations

import torch

from . import collective
from .flash_attention import flash_attention

__all__ = ["ulysses_attention", "ulysses_attention_sharded"]


def ulysses_attention(qs, ks, vs, causal=False, sm_scale=None):
    """Attention over the whole sequence split over the ranks of an axis.

    ``qs``, ``ks`` and ``vs`` hold each rank's sequence shard
    ``[B, H, T_local, D]`` (a list in sequence order); H must divide by
    the number of ranks.  Returns each rank's output shard."""
    p = len(qs)
    H = qs[0].shape[1]
    if H % p != 0:
        raise ValueError(
            "ulysses_attention needs head count %% axis size == 0, got H=%d p=%d"
            % (H, p))
    collective.count_engine("ulysses")

    def seq_to_heads(xs):
        # [B, H, T/p, D] -> [B, H/p, T, D]: give away H/p-head slices of
        # my sequence shard, receive my heads' shards of the whole sequence
        return collective.all_to_all(xs, split_axis=1, concat_axis=2)

    qh, kh, vh = seq_to_heads(qs), seq_to_heads(ks), seq_to_heads(vs)
    outs = [flash_attention(q, k, v, None, causal, sm_scale)
            for q, k, v in zip(qh, kh, vh)]
    back = collective.all_to_all(outs, split_axis=2, concat_axis=1)
    return [o.to(q.dtype) for o, q in zip(back, qs)]


def ulysses_attention_sharded(q, k, v, mesh, axis_name="sp", causal=False,
                              sm_scale=None):
    """Global ``[B, H, T, D]`` q/k/v with T split over ``axis_name`` of
    ``mesh``; returns the global output."""
    devs = collective.axis_devices(mesh, axis_name)
    p = len(devs)

    def split(x):
        return [c.to(d) for c, d in zip(x.chunk(p, 2), devs)]

    outs = ulysses_attention(split(q), split(k), split(v), causal=causal,
                             sm_scale=sm_scale)
    return torch.cat([o.to(q.device) for o in outs], 2)
