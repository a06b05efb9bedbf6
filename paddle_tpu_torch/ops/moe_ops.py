"""The ``switch_moe`` op rule (``layers.switch_moe``).

The port's counterpart of the JAX package's ``ops/moe_ops.py``, its dense
top-1 branch: the gate's softmax picks each token's expert (the first of
equal maxima, as ``jnp.argmax``), every expert's relu FFN runs on every
token as two batched products, and each token reads its expert's output
scaled by its gate probability, so the gate's gradient flows through the
combine.  The JAX package computes these products as ``einsum``s outside
any Pallas kernel, so they are ``torch.einsum`` here (cuBLAS on the
card).  ``capacity_factor`` only bounds the expert-parallel engine's
slots; with every token on every expert nothing is dropped.

An executor mesh with an ``ep`` axis whose size is the expert count
(above 1, dividing the token count) is the opt-in to the expert-parallel
engine (``parallel/moe.py:switch_moe``), as in the JAX package.
"""
from __future__ import annotations

import torch

from ..registry import register


def _expert_fn(p, toks):
    return torch.relu(toks @ p["w1"]) @ p["w2"]


@register("switch_moe")
def _switch_moe(ctx, op):
    x = ctx.get_input(op, "X")            # [B, D] or [B, T, D]
    gate_w = ctx.get_input(op, "GateW")   # [D, E]
    w1 = ctx.get_input(op, "ExpertW1")    # [E, D, H]
    w2 = ctx.get_input(op, "ExpertW2")    # [E, H, D]
    lead = tuple(x.shape[:-1])
    D = x.shape[-1]
    xt = x.reshape(-1, D)
    B = xt.shape[0]
    E = w1.shape[0]
    mesh = ctx.mesh
    ep = mesh.axis_size("ep") if mesh is not None else 0
    if ep > 1 and ep == E and B % ep == 0:
        from ..parallel.moe import switch_moe as moe_engine

        out = moe_engine(xt, gate_w, {"w1": w1, "w2": w2}, _expert_fn, mesh,
                         axis_name="ep",
                         capacity_factor=float(op.attrs.get("capacity_factor", 2.0)))
        ctx.set_output(op, "Out", out.reshape(lead + (D,)))
        return

    probs = torch.softmax(xt @ gate_w, dim=-1)             # [B, E]
    choice = probs.argmax(-1)                              # [B]
    gate = probs.gather(1, choice[:, None])[:, 0]
    all_out = torch.einsum(
        "ebh,ehd->ebd",
        torch.relu(torch.einsum("bd,edh->ebh", xt, w1)), w2)  # [E, B, D]
    picked = all_out.gather(
        0, choice[None, :, None].expand(1, B, D))[0]       # [B, D]
    ctx.set_output(op, "Out", (picked * gate[:, None]).reshape(lead + (D,)))
