"""Fused attention op rule: the port's flash attention.

No reference analog op: the reference composes matmul+softmax+matmul
(nets.py:233).  The rule calls :func:`paddle_tpu_torch.parallel.
flash_attention.flash_attention` — the hand-written CUDA forward and
backward kernels for a CUDA tensor, their plain versions for a CPU one.
Translated from the JAX package's ``paddle_tpu/ops/attention_ops.py``.

Sequence parallelism over the executor mesh's ``sp`` axis: a mesh with
an ``sp`` axis above 1 is the opt-in (``sequence_parallel=False``
forces the one-shard kernels).  Engine choice (``sp_engine="auto"``):
Ulysses (``parallel/ulysses.py``, whose local attention is the flash
kernels) when the head count divides the axis, else ring attention
(``parallel/ring_attention.py``).  With ``KVLens`` given, or a sequence
that does not divide, the rule gathers the whole sequence and runs the
one-shard kernels (counted as ``sp_fallback``), as the JAX package
falls back.  On a one-device mesh the rule runs the kernels as without
a mesh.
"""
from __future__ import annotations

import torch

from ..registry import register


@register("flash_attention")
def _flash_attention(ctx, op):
    from ..parallel import collective
    from ..parallel.flash_attention import flash_attention

    q = ctx.get_input(op, "Q")  # [B, H, T, D]
    k = ctx.get_input(op, "K")
    v = ctx.get_input(op, "V")
    kv_lens = ctx.get_input(op, "KVLens", None)  # [B] int, optional
    if kv_lens is not None:
        kv_lens = kv_lens.reshape(-1).to(torch.int32)
    causal = bool(op.attrs.get("causal", False))
    mesh = ctx.mesh
    sp = mesh.axis_size("sp") if mesh is not None else 1
    if bool(op.attrs.get("sequence_parallel", True)) and sp > 1:
        if kv_lens is None and q.shape[2] % sp == 0:
            engine = op.attrs.get("sp_engine", "auto")
            if engine == "auto":
                engine = "ulysses" if q.shape[1] % sp == 0 else "ring"
            if engine == "ulysses":
                from ..parallel.ulysses import ulysses_attention_sharded as run
            else:
                from ..parallel.ring_attention import ring_attention_sharded as run
            ctx.set_output(op, "Out", run(q, k, v, mesh, axis_name="sp",
                                          causal=causal))
            return
        collective.count_engine("sp_fallback")
    ctx.set_output(op, "Out", flash_attention(q, k, v, kv_lens, causal))
