"""Shared helpers for op rules (translated from ``paddle_tpu/ops/common.py``)."""
from __future__ import annotations

import torch


def bcast_y(x, y, axis: int):
    """Reference elementwise broadcast semantics
    (paddle/fluid/operators/elementwise_op_function.h): ``y``'s shape is
    aligned to ``x`` starting at ``axis`` (axis=-1 → trailing alignment)."""
    xs, ys = x.dim(), y.dim()
    if ys == 0 or xs == ys:
        return y
    if axis == -1 or axis is None:
        axis = xs - ys
    new_shape = (1,) * axis + tuple(y.shape) + (1,) * (xs - axis - ys)
    return y.reshape(new_shape)


def reduce_axes(dim, ndim):
    """Normalize the reference reduce ops' ``dim`` attr."""
    if dim is None or dim == [] or dim is False:
        return tuple(range(ndim))
    if isinstance(dim, int):
        dim = [dim]
    return tuple(d % ndim for d in dim)


def at_least_f32(x):
    """``x`` in float32 where it is a half type, else as it is: the JAX
    package does statistics, softmaxes and updates in float32, and a
    float64 Program keeps float64."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return x.float()
    return x


_FLOAT_ORDER = {torch.bfloat16: 0, torch.float16: 0, torch.float32: 1,
                torch.float64: 2}


def mixed_dtypes(x, y):
    """bf16 mixed precision: if both operands are floats of different
    widths, compute in the lower precision (the JAX package's rule).
    Non-float operands are left to torch's type promotion."""
    if x.dtype == y.dtype:
        return x, y
    dx = _FLOAT_ORDER.get(x.dtype)
    dy = _FLOAT_ORDER.get(y.dtype)
    if dx is None or dy is None:
        return x, y
    target = x.dtype if dx <= dy else y.dtype
    return x.to(target), y.to(target)


def wrapped_index(idx, n):
    """``idx`` as int64 indices into an axis of length ``n`` the way the
    JAX package's ``jnp.take``/``take_along_axis`` read them: an index in
    [-n, 0) wraps to ``n + idx``; one outside [-n, n) is clamped to a
    valid row here, and :func:`in_range` marks it for the fill."""
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx).clamp(0, max(n - 1, 0))


def in_range(idx, n):
    """Where ``idx`` is a valid index into an axis of length ``n``
    (negatives in [-n, 0) included); elsewhere the JAX package's gathers
    fill (NaN for a float)."""
    return (idx >= -n) & (idx < n)


def device_values(values, dtype, device):
    """Python numbers as a tensor made on the device by fills, so that a
    captured step can hold it: ``out[i] = v`` would lift ``v`` into a
    host tensor and copy it, which a CUDA graph capture refuses
    (ROADMAP F-22)."""
    out = torch.empty(len(values), dtype=dtype, device=device)
    for i, v in enumerate(values):
        out[i].fill_(v)
    return out
