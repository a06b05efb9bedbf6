"""Tensor creation / manipulation op rules.

Translated from the JAX package's ``paddle_tpu/ops/tensor_ops.py``, every
op it registers.  Random ops draw from the seeded ``torch.Generator``
the LoweringContext gives each op (see
executor.LoweringContext.op_generator), once a step: the same Program,
seed and step draw the same numbers, but not the JAX package's numbers.

A bound step is captured as a CUDA graph and replayed, so no rule here
copies a host array to the card at run time unless it is marked
``reads_host`` (``assign_value``, ``load``, ``print``): constants are
built on the device (``torch.full``, ``torch.arange``, comparisons with
Python numbers), and data-dependent offsets stay device tensors.
"""
from __future__ import annotations

import itertools
import math

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


@register("uniform_random", "uniform_random_batch_size_like")
def _uniform_random(ctx, op):
    a = op.attrs
    shape = _random_shape(ctx, op)
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


@register("fill_zeros_like")
def _fill_zeros_like(ctx, op):
    ctx.set_output(op, "Out", torch.zeros_like(ctx.get_input(op, "X")))


@register("concat")
def _concat(ctx, op):
    ctx.set_output(op, "Out", torch.cat(ctx.get_inputs(op, "X"),
                                        dim=op.attrs.get("axis", 0)))


@register("split")
def _split(ctx, op):
    """``num`` equal pieces, or pieces at the running sums of
    ``sections`` (the last piece takes whatever is left, as
    ``jnp.split`` at those indices gives it)."""
    x = ctx.get_input(op, "X")
    axis = op.attrs.get("axis", -1)
    sections = op.attrs.get("sections")
    if sections:
        cuts = list(itertools.accumulate(int(s) for s in sections))[:-1]
        outs = torch.tensor_split(x, cuts, dim=axis)
    else:
        outs = torch.tensor_split(x, op.attrs.get("num", 0), dim=axis)
    ctx.set_outputs(op, "Out", outs)


@register("squeeze", "squeeze2")
def _squeeze(ctx, op):
    """``X`` without the listed axes that have length 1 (every such axis
    when ``axes`` is empty); an axis longer than 1 stays."""
    x = ctx.get_input(op, "X")
    axes = op.attrs.get("axes") or [i for i, s in enumerate(x.shape) if s == 1]
    drop = {a % x.dim() for a in axes if x.shape[a % x.dim()] == 1}
    ctx.set_output(op, "Out", x.reshape(tuple(
        s for i, s in enumerate(x.shape) if i not in drop)))


@register("flatten")
def _flatten(ctx, op):
    x = ctx.get_input(op, "X")
    ax = op.attrs.get("axis", 1)
    ctx.set_output(op, "Out", x.reshape((math.prod(x.shape[:ax]), -1)))


@register("stack")
def _stack(ctx, op):
    ctx.set_output(op, "Y", torch.stack(ctx.get_inputs(op, "X"),
                                        dim=op.attrs.get("axis", 0)))


@register("unstack")
def _unstack(ctx, op):
    x = ctx.get_input(op, "X")
    ctx.set_outputs(op, "Y", torch.unbind(x, dim=op.attrs.get("axis", 0)))


@register("shape")
def _shape(ctx, op):
    """``Input``'s shape as int32, written into a device tensor one
    length at a time (no host array is copied to the card)."""
    x = ctx.get_input(op, "Input")
    out = torch.zeros((x.dim(),), dtype=torch.int32, device=ctx.device)
    for i, s in enumerate(x.shape):
        out[i] = s
    ctx.set_output(op, "Out", out)


@register("scatter")
def _scatter(ctx, op):
    """``X`` with its rows at ``Ids`` set to ``Updates``, as the JAX
    package's ``x.at[ids].set(updates)`` gives them: an id in [-n, 0)
    wraps, one outside [-n, n) is dropped, and where an id repeats the
    last update wins.  Each row's winner is the largest position that
    names it (``scatter_reduce`` with ``amax``, exact in any order), so
    the card gives the same bits on every run (``index_put_`` does not
    promise which of two updates lands) and raises no device assert for
    an id out of range.  Only the winning update gets a gradient, as in
    JAX."""
    x = ctx.get_input(op, "X")
    ids = ctx.get_input(op, "Ids").reshape(-1).long()
    upd = ctx.get_input(op, "Updates").to(x.dtype)
    n = x.shape[0]
    # ids out of range go to a spare row n, cut off below
    rows = torch.where(in_range(ids, n), wrapped_index(ids, n),
                       torch.full_like(ids, n))
    pos = torch.arange(ids.shape[0], device=ids.device)
    last = torch.full((n + 1,), -1, dtype=torch.long,
                      device=ids.device).scatter_reduce(0, rows, pos, "amax")[:n]
    hit = (last >= 0).reshape((-1,) + (1,) * (x.dim() - 1))
    new = torch.index_select(upd, 0, torch.where(last >= 0, last,
                                                 torch.zeros_like(last)))
    ctx.set_output(op, "Out", torch.where(hit, new, x))


def _pairs(p, ndim):
    """``paddings`` [before_0, after_0, before_1, ...] as ``F.pad``'s
    flat tuple, last axis first."""
    return tuple(int(v) for i in reversed(range(ndim))
                 for v in (p[2 * i], p[2 * i + 1]))


@register("pad")
def _pad(ctx, op):
    x = ctx.get_input(op, "X")
    ctx.set_output(op, "Out", torch.nn.functional.pad(
        x, _pairs(op.attrs["paddings"], x.dim()),
        value=op.attrs.get("pad_value", 0.0)))


@register("pad2d")
def _pad2d(ctx, op):
    """NCHW: ``paddings`` [top, bottom, left, right]; ``mode``
    ``constant`` (``pad_value``), ``reflect`` or ``edge``."""
    x = ctx.get_input(op, "X")
    t, b, l, r = (int(v) for v in op.attrs["paddings"])
    mode = op.attrs.get("mode", "constant")
    if mode == "constant":
        out = torch.nn.functional.pad(x, (l, r, t, b),
                                      value=op.attrs.get("pad_value", 0.0))
    else:
        out = torch.nn.functional.pad(
            x, (l, r, t, b), mode="reflect" if mode == "reflect" else "replicate")
    ctx.set_output(op, "Out", out)


@register("pad_constant_like")
def _pad_constant_like(ctx, op):
    """``Y`` padded at the end of each axis to ``X``'s shape."""
    x = ctx.get_input(op, "X")
    y = ctx.get_input(op, "Y")
    flat = tuple(v for xs, ys in reversed(list(zip(x.shape, y.shape)))
                 for v in (0, int(xs - ys)))
    ctx.set_output(op, "Out", torch.nn.functional.pad(
        y, flat, value=op.attrs.get("pad_value", 0.0)))


@register("crop")
def _crop(ctx, op):
    """The window of ``X`` at ``offsets`` (0 by default) of the ``shape``
    attr, else of ``Y``'s shape."""
    x = ctx.get_input(op, "X")
    offsets = op.attrs.get("offsets") or [0] * x.dim()
    shape = op.attrs.get("shape")
    if shape is None:
        shape = ctx.get_input(op, "Y").shape
    idx = tuple(slice(o, o + s) for o, s in zip(offsets, shape))
    ctx.set_output(op, "Out", x[idx])


@register("reverse")
def _reverse(ctx, op):
    axes = op.attrs["axis"]
    if isinstance(axes, int):
        axes = [axes]
    ctx.set_output(op, "Out", torch.flip(ctx.get_input(op, "X"), tuple(axes)))


@register("multiplex")
def _multiplex(ctx, op):
    """Row i of the output is row i of input ``Ids[i]``.  An id is read
    as the JAX package's ``xs[ids, rows]`` reads it: one in [-k, 0)
    wraps, and any other outside [0, k) is clamped to the nearest input
    (where torch's indexing would assert on the card); such a row passes
    no gradient back, as XLA's scatter drops the out-of-range update of
    the gather's transpose."""
    xs = torch.stack(ctx.get_inputs(op, "X"), dim=0)  # [k, n, d]
    ids = ctx.get_input(op, "Ids").reshape(-1)
    k = xs.shape[0]
    rows = torch.arange(ids.shape[0], device=xs.device)
    out = xs[wrapped_index(ids, k), rows]
    keep = in_range(ids, k).reshape((-1,) + (1,) * (out.dim() - 1))
    ctx.set_output(op, "Out", torch.where(keep, out, out.detach()))


@register("arg_max")
def _arg_max(ctx, op):
    """int64 index of the first maximum along ``axis``."""
    ctx.set_output(op, "Out", torch.argmax(ctx.get_input(op, "X"),
                                           dim=op.attrs.get("axis", 0)))


@register("arg_min")
def _arg_min(ctx, op):
    ctx.set_output(op, "Out", torch.argmin(ctx.get_input(op, "X"),
                                           dim=op.attrs.get("axis", 0)))


@register("argsort")
def _argsort(ctx, op):
    """The sorted values and their int64 indices along ``axis``, equal
    values in index order (``jnp.argsort`` is stable; a plain
    ``torch.sort`` is not promised to be)."""
    x = ctx.get_input(op, "X")
    vals, idx = torch.sort(x, dim=op.attrs.get("axis", -1), stable=True)
    ctx.set_output(op, "Indices", idx)
    ctx.set_output(op, "Out", vals)


# the uniform draw whose inverse normal CDF gives a standard normal cut
# at +-2 (jax.random.truncated_normal's construction)
_ERF_2 = math.erf(2.0 / math.sqrt(2.0))


@register("truncated_gaussian_random")
def _truncated_gaussian_random(ctx, op):
    """A normal cut at two standard deviations: one uniform draw over
    (erf(-2/sqrt 2), erf(2/sqrt 2)) through ``sqrt(2) * erfinv``, held
    inside (-2, 2), as ``jax.random.truncated_normal`` draws it; then
    ``* std + mean``.  No gradient reaches a draw."""
    a = op.attrs
    gen = ctx.op_generator(op, a.get("seed", 0))
    u = torch.rand(tuple(int(s) for s in a["shape"]), generator=gen,
                   device=ctx.device,
                   dtype=torch_dtype(a.get("dtype", "float32")))
    z = math.sqrt(2.0) * torch.erfinv(_ERF_2 * (2.0 * u - 1.0))
    z = torch.clamp(z, math.nextafter(-2.0, 0.0), math.nextafter(2.0, 0.0))
    ctx.set_output(op, "Out", z * a.get("std", 1.0) + a.get("mean", 0.0))


@register("sampling_id")
def _sampling_id(ctx, op):
    """One int64 id a row of ``X`` [batch, k] (probabilities), drawn as
    ``jax.random.categorical`` draws it: the argmax of ``log(p + 1e-20)``
    plus Gumbel noise, from one uniform draw."""
    x = ctx.get_input(op, "X")
    gen = ctx.op_generator(op, op.attrs.get("seed", 0))
    u = torch.rand(x.shape, generator=gen, device=ctx.device, dtype=x.dtype)
    gumbel = -torch.log(-torch.log(u))
    ctx.set_output(op, "Out", torch.argmax(torch.log(x + 1e-20) + gumbel,
                                           dim=-1))


@register("random_crop")
def _random_crop(ctx, op):
    """A window of ``shape`` over the trailing axes of ``X``, at one
    start an axis for the whole batch, each uniform over the positions
    that fit (the JAX package's draw).  All starts come from one uniform
    draw, and the window is read with device-side indices
    (``index_select``), so the step never waits on the host."""
    x = ctx.get_input(op, "X")
    shape = [int(s) for s in op.attrs["shape"]]
    lead = x.dim() - len(shape)
    gen = ctx.op_generator(op, op.attrs.get("seed", 0))
    u = torch.rand((len(shape),), generator=gen, device=ctx.device,
                   dtype=torch.float64)
    out = x
    for i, s in enumerate(shape):
        hi = x.shape[lead + i] - s
        if hi <= 0:
            out = out.narrow(lead + i, 0, s)
            continue
        start = torch.floor(u[i] * (hi + 1)).long().clamp(max=hi)
        out = torch.index_select(out, lead + i,
                                 start + torch.arange(s, device=x.device))
    ctx.set_output(op, "Out", out)


@register("sum", "sums")
def _sum(ctx, op):
    xs = ctx.get_inputs(op, "X")
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    ctx.set_output(op, "Out", out)


@register("has_inf")
def _has_inf(ctx, op):
    ctx.set_output(op, "Out", torch.isinf(ctx.get_input(op, "X")).any().reshape(1))


@register("has_nan")
def _has_nan(ctx, op):
    ctx.set_output(op, "Out", torch.isnan(ctx.get_input(op, "X")).any().reshape(1))


@register("isfinite")
def _isfinite(ctx, op):
    ctx.set_output(op, "Out",
                   torch.isfinite(ctx.get_input(op, "X")).all().reshape(1))


@register("print", reads_host=True)
def _print(ctx, op):
    """Print ``message`` and the values of ``In`` on the host, and pass
    ``In`` on as ``Out``.  The text is read back at every run, which a
    replayed CUDA graph cannot do (``reads_host``): a Program that holds
    a ``print`` runs op by op at every step.  (The JAX package's
    ``jax.debug.print`` printed from inside its compiled step.)"""
    x = ctx.get_input(op, "In")
    print(op.attrs.get("message", "") + " " + str(x.detach().cpu().numpy()))
    ctx.set_output(op, "Out", x)


@register("piecewise_decay")
def _piecewise_decay(ctx, op):
    """``values[k]``, k the number of ``boundaries`` at or below the step
    (both float32, as the JAX package compares them).  Built from
    comparisons with Python numbers: nothing is copied from the host, so
    an LR-scheduled step stays on the CUDA graph."""
    step = ctx.get_input(op, "Step").reshape(())
    k = torch.zeros((), dtype=torch.int32, device=step.device)
    for b in op.attrs["boundaries"]:
        k = k + (step >= b).to(torch.int32)
    values = op.attrs["values"]
    out = torch.full((), values[0], dtype=torch.float32, device=step.device)
    for i, v in enumerate(values[1:], 1):
        out = torch.where(k == i, torch.full_like(out, v), out)
    ctx.set_output(op, "Out", out.reshape(1))
