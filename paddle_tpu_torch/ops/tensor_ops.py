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

from ..registry import register
from ..core import torch_dtype
from .common import in_range, wrapped_index


@register("fill_constant")
def _fill_constant(ctx, op):
    a = op.attrs
    out = torch.full(tuple(int(s) for s in a["shape"]), a["value"],
                     dtype=torch_dtype(a["dtype"]), device=ctx.device)
    ctx.set_output(op, "Out", out)


@register("fill_constant_batch_size_like")
def _fill_constant_batch_size_like(ctx, op):
    a = op.attrs
    ref = ctx.get_input(op, "Input")
    shape = [int(s) for s in a["shape"]]
    shape[a.get("output_dim_idx", 0)] = ref.shape[a.get("input_dim_idx", 0)]
    out = torch.full(tuple(shape), a["value"], dtype=torch_dtype(a["dtype"]),
                     device=ctx.device)
    ctx.set_output(op, "Out", out)


@register("assign")
def _assign(ctx, op):
    """``Out`` is ``X`` (the same tensor: no rule writes a tensor in
    place), with ``X``'s lengths companions."""
    ctx.set_output(op, "Out", ctx.get_input(op, "X"))
    ctx.copy_lengths(op.inputs["X"][0], op.outputs["Out"][0])


@register("assign_value", reads_host=True)
def _assign_value(ctx, op):
    """The op's ``values`` as a tensor, copied from the host at every run:
    a synchronous copy, which a CUDA graph cannot hold (``reads_host``)."""
    vals = np.asarray(op.attrs["values"])
    out = torch.as_tensor(vals).to(device=ctx.device,
                                   dtype=torch_dtype(op.attrs["dtype"]))
    ctx.set_output(op, "Out", out)


@register("load", reads_host=True)
def _load(ctx, op):
    """Bind a variable from an ``io.save_vars`` ``.npy`` file (reference
    operators/load_op.cc): read on the host at every run, cast to the
    variable's declared dtype (float16 with ``load_as_fp16``) and copied
    to the device.  A file read cannot be replayed and a pageable copy
    cannot be captured (``reads_host``)."""
    path = op.attrs["file_path"]
    if not path.endswith(".npy"):
        path = path + ".npy"
    out = torch.as_tensor(np.load(path))
    var = ctx.var(op.outputs["Out"][0])
    if var is not None and var.dtype:
        out = out.to(torch_dtype(var.dtype))
    if op.attrs.get("load_as_fp16"):
        out = out.to(torch.float16)
    ctx.set_output(op, "Out", out.to(ctx.device))


@register("cast")
def _cast(ctx, op):
    """``x`` in ``out_dtype``.  A float cast to an integer type saturates
    as the JAX package's ``astype`` does: NaN gives 0, and a value past
    the target's range gives its nearest end (torch's own conversion is
    undefined there, and differs between the CPU and the card)."""
    x = ctx.get_input(op, "X")
    dtype = torch_dtype(op.attrs["out_dtype"])
    if x.is_floating_point() and not (dtype.is_floating_point
                                      or dtype == torch.bool):
        info = torch.iinfo(dtype)
        xd = torch.nan_to_num(x.double(), nan=0.0, posinf=info.max,
                              neginf=info.min)
        out = xd.clamp(info.min, info.max).to(dtype)
        # float64 rounds int64's upper end up to 2**63, past the range
        out = torch.where(xd >= float(info.max), info.max, out)
    else:
        out = x.to(dtype)
    ctx.set_output(op, "Out", out)
    ctx.copy_lengths(op.inputs["X"][0], op.outputs["Out"][0])


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


@register("expand")
def _expand(ctx, op):
    """``X`` tiled ``expand_times`` times along each axis (``jnp.tile``'s
    semantics, which ``torch.tile`` shares)."""
    times = tuple(int(t) for t in op.attrs["expand_times"])
    ctx.set_output(op, "Out", torch.tile(ctx.get_input(op, "X"), times))


def _gather_fill(dtype):
    """What the JAX package's ``jnp.take`` gives a row past the end: NaN
    for a float, True for a bool, the largest value of an unsigned type
    and the smallest of a signed one.  The JAX package runs int64 as
    int32 (x64 is off), so an int64 row gets int32's smallest value."""
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    if dtype == torch.uint8:
        return torch.iinfo(dtype).max
    return torch.iinfo(torch.int32 if dtype == torch.int64 else dtype).min


@register("gather")
def _gather(ctx, op):
    """The rows of ``X`` at ``Index`` (flattened), as the JAX package's
    ``jnp.take`` reads them: an index in [-n, 0) wraps to ``n + index``,
    and one outside [-n, n) gives a row of ``_gather_fill`` (where
    ``index_select`` would raise)."""
    x = ctx.get_input(op, "X")
    idx = ctx.get_input(op, "Index").reshape(-1)
    n = x.shape[0]
    out = torch.index_select(x, 0, wrapped_index(idx, n))
    keep = in_range(idx, n).reshape((-1,) + (1,) * (x.dim() - 1))
    ctx.set_output(op, "Out", torch.where(keep, out, _gather_fill(x.dtype)))


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
    # an id outside [0, depth), negatives included, gives a row of zeros
    # (jax.nn.one_hot compares ids against arange(depth))
    cols = torch.arange(depth, device=flat.device)
    ctx.set_output(op, "Out", (flat.long()[..., None] == cols).to(torch.float32))


@register("top_k")
def _top_k(ctx, op):
    """The k largest entries along the last axis and their int64
    indices, equal values in index order (``jax.lax.top_k``'s order: a
    stable descending sort; ``torch.topk`` does not promise one)."""
    x = ctx.get_input(op, "X")
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    k = op.attrs["k"]
    ctx.set_output(op, "Out", vals[..., :k])
    ctx.set_output(op, "Indices", idx[..., :k])


def _random_shape(ctx, op):
    """The op's ``shape`` attr; a ``*_batch_size_like`` op takes dim
    ``output_dim_idx`` from its ``Input``'s dim ``input_dim_idx``."""
    a = op.attrs
    shape = [int(s) for s in a["shape"]]
    if op.inputs.get("Input"):
        ref = ctx.get_input(op, "Input")
        shape[a.get("output_dim_idx", 0)] = ref.shape[a.get("input_dim_idx", 0)]
    return tuple(shape)


@register("gaussian_random", "gaussian_random_batch_size_like")
def _gaussian_random(ctx, op):
    a = op.attrs
    gen = ctx.op_generator(op, a.get("seed", 0))
    out = torch.randn(_random_shape(ctx, op), generator=gen,
                      device=ctx.device,
                      dtype=torch_dtype(a.get("dtype", "float32")))
    ctx.set_output(op, "Out", out * a.get("std", 1.0) + a.get("mean", 0.0))


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
