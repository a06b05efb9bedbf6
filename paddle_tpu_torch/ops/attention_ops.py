"""Fused attention op rule: the port's flash attention.

No reference analog op: the reference composes matmul+softmax+matmul
(nets.py:233).  The rule calls :func:`paddle_tpu_torch.parallel.
flash_attention.flash_attention` — the hand-written CUDA forward and
backward kernels for a CUDA tensor, their plain versions for a CPU one.
Translated from the JAX package's ``paddle_tpu/ops/attention_ops.py``;
its sequence-parallel branch (ring / Ulysses over a mesh's ``sp`` axis
of more than one device) waits for ROADMAP A11.2.  On a one-device mesh
(``Executor.attach_mesh``) the rule runs the kernels as without a mesh,
as the JAX package does when the mesh's ``sp`` axis is 1.
"""
from __future__ import annotations

import torch

from ..registry import register


@register("flash_attention")
def _flash_attention(ctx, op):
    from ..parallel.flash_attention import flash_attention

    mesh = ctx.mesh
    if (bool(op.attrs.get("sequence_parallel", True)) and mesh is not None
            and int(mesh.shape.get("sp", 1)) > 1):
        raise NotImplementedError(
            "flash_attention: the sequence-parallel engines (ring, Ulysses) "
            "over an sp axis of %d devices wait for ROADMAP A11.2"
            % int(mesh.shape["sp"]))
    q = ctx.get_input(op, "Q")  # [B, H, T, D]
    k = ctx.get_input(op, "K")
    v = ctx.get_input(op, "V")
    kv_lens = ctx.get_input(op, "KVLens", None)  # [B] int, optional
    if kv_lens is not None:
        kv_lens = kv_lens.reshape(-1).to(torch.int32)
    causal = bool(op.attrs.get("causal", False))
    ctx.set_output(op, "Out", flash_attention(q, k, v, kv_lens, causal))
