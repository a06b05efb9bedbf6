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
