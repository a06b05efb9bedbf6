"""Tensor creation / manipulation op rules.

Translated from the JAX package's ``paddle_tpu/ops/tensor_ops.py``, for
the ops the port runs so far.  Random ops draw from the seeded
``torch.Generator`` the LoweringContext gives each op (see
executor.LoweringContext.op_generator): the same Program, seed and step
draw the same numbers, but not the JAX package's numbers.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..registry import register
from ..core import torch_dtype


@register("fill_constant")
def _fill_constant(ctx, op):
    a = op.attrs
    out = torch.full(tuple(int(s) for s in a["shape"]), a["value"],
                     dtype=torch_dtype(a["dtype"]), device=ctx.device)
    ctx.set_output(op, "Out", out)


@register("assign_value")
def _assign_value(ctx, op):
    vals = np.asarray(op.attrs["values"])
    out = torch.as_tensor(vals).to(device=ctx.device,
                                   dtype=torch_dtype(op.attrs["dtype"]))
    ctx.set_output(op, "Out", out)


@register("cast")
def _cast(ctx, op):
    x = ctx.get_input(op, "X")
    ctx.set_output(op, "Out", x.to(torch_dtype(op.attrs["out_dtype"])))


@register("reshape", "reshape2")
def _reshape(ctx, op):
    x = ctx.get_input(op, "X")
    shape = list(op.attrs["shape"])
    # reference semantics: 0 = copy input dim, -1 = infer
    for i, s in enumerate(shape):
        if s == 0:
            shape[i] = x.shape[i]
    ctx.set_output(op, "Out", x.reshape(tuple(shape)))


@register("unsqueeze", "unsqueeze2")
def _unsqueeze(ctx, op):
    out = ctx.get_input(op, "X")
    for a in sorted(op.attrs["axes"]):
        out = out.unsqueeze(a)
    ctx.set_output(op, "Out", out)


@register("transpose", "transpose2")
def _transpose(ctx, op):
    # a view: the flash attention kernels take strided q/k/v
    ctx.set_output(op, "Out", ctx.get_input(op, "X").permute(*op.attrs["axis"]))


@register("slice")
def _slice(ctx, op):
    x = ctx.get_input(op, "X")
    axes, starts, ends = op.attrs["axes"], op.attrs["starts"], op.attrs["ends"]
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(axes, starts, ends):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    ctx.set_output(op, "Out", x[tuple(idx)])


@register("one_hot")
def _one_hot(ctx, op):
    x = ctx.get_input(op, "X")
    depth = op.attrs["depth"]
    flat = x.reshape(x.shape[:-1]) if x.dim() and x.shape[-1] == 1 else x
    ctx.set_output(op, "Out", F.one_hot(flat.long(), depth).to(torch.float32))


@register("uniform_random")
def _uniform_random(ctx, op):
    a = op.attrs
    shape = tuple(int(s) for s in a["shape"])
    gen = ctx.op_generator(op, a.get("seed", 0))
    lo, hi = a.get("min", -1.0), a.get("max", 1.0)
    out = torch.rand(shape, generator=gen, device=ctx.device,
                     dtype=torch_dtype(a.get("dtype", "float32")))
    ctx.set_output(op, "Out", out * (hi - lo) + lo)


@register("increment")
def _increment(ctx, op):
    x = ctx.get_input(op, "X")
    step = op.attrs.get("step", 1.0)
    if not x.is_floating_point():
        step = int(step)
    ctx.set_output(op, "Out", x + step)


@register("label_smooth")
def _label_smooth(ctx, op):
    x = ctx.get_input(op, "X")
    eps = op.attrs.get("epsilon", 0.1)
    prior = ctx.get_input(op, "PriorDist")
    k = x.shape[-1]
    if prior is None:
        out = (1.0 - eps) * x + eps / k
    else:
        out = (1.0 - eps) * x + eps * prior
    ctx.set_output(op, "Out", out)
