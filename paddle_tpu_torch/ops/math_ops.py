"""Math op rules: elementwise (reference broadcast semantics), mul/matmul,
reductions, activations, compares, logicals.

Translated from the JAX package's ``paddle_tpu/ops/math_ops.py``, for the
ops the port runs so far.  Each is a plain torch expression: XLA fused
these on the TPU, and no Pallas kernel ever computed them.  ``mul`` and
``matmul`` stay ``torch.matmul``, as the JAX package left them to XLA.
"""
from __future__ import annotations

import torch

from ..registry import register
from .common import bcast_y, mixed_dtypes, reduce_axes

# ---------------------------------------------------------------------------
# elementwise binary with paddle axis-broadcast
# ---------------------------------------------------------------------------

_BINOPS = {
    "elementwise_add": lambda x, y: x + y,
    "elementwise_mul": lambda x, y: x * y,
    "elementwise_div": lambda x, y: x / y,
    "elementwise_min": torch.minimum,
}


def _make_binop(op_type, fn):
    @register(op_type)
    def _rule(ctx, op, fn=fn):
        x = ctx.get_input(op, "X")
        y = ctx.get_input(op, "Y")
        x, y = mixed_dtypes(x, y)
        y = bcast_y(x, y, op.attrs.get("axis", -1))
        ctx.set_output(op, "Out", fn(x, y))


for _t, _f in _BINOPS.items():
    _make_binop(_t, _f)


@register("scale")
def _scale(ctx, op):
    x = ctx.get_input(op, "X")
    s = op.attrs.get("scale", 1.0)
    b = op.attrs.get("bias", 0.0)
    if op.attrs.get("bias_after_scale", True):
        ctx.set_output(op, "Out", x * s + b)
    else:
        ctx.set_output(op, "Out", (x + b) * s)


@register("mul")
def _mul(ctx, op):
    """x flattened at x_num_col_dims @ y flattened at y_num_col_dims
    (reference operators/mul_op.cc)."""
    x = ctx.get_input(op, "X")
    y = ctx.get_input(op, "Y")
    x, y = mixed_dtypes(x, y)
    xn = op.attrs.get("x_num_col_dims", 1)
    yn = op.attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape((-1, _prod(xs[xn:])))
    y2 = y.reshape((_prod(ys[:yn]), -1))
    out = torch.matmul(x2, y2)
    ctx.set_output(op, "Out", out.reshape(xs[:xn] + ys[yn:]))


def _prod(dims):
    n = 1
    for d in dims:
        n *= int(d)
    return n


@register("matmul")
def _matmul(ctx, op):
    x = ctx.get_input(op, "X")
    y = ctx.get_input(op, "Y")
    x, y = mixed_dtypes(x, y)
    tx, ty = op.attrs.get("transpose_X", False), op.attrs.get("transpose_Y", False)
    alpha = op.attrs.get("alpha", 1.0)
    x_was_1d = x.dim() == 1
    y_was_1d = y.dim() == 1
    if x_was_1d:
        x = x[None, :]
    if y_was_1d:
        y = y[:, None]
    if tx:
        x = x.transpose(-1, -2)
    if ty:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    if alpha != 1.0:
        out = out * alpha
    # strip only the dims we appended, never genuine size-1 batch dims
    if y_was_1d:
        out = out.reshape(out.shape[:-1])
    if x_was_1d:
        out = out.reshape(out.shape[:-2] + out.shape[-1:])
    if x_was_1d and y_was_1d and out.dim() == 0:
        out = out.reshape(1)
    ctx.set_output(op, "Out", out)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------


@register("reduce_sum")
def _reduce_sum(ctx, op):
    x = ctx.get_input(op, "X")
    if op.attrs.get("reduce_all", False):
        axes = tuple(range(x.dim()))
    else:
        axes = reduce_axes(op.attrs.get("dim"), x.dim())
    out = torch.sum(x, dim=axes, keepdim=op.attrs.get("keep_dim", False))
    ctx.set_output(op, "Out", out)


# ---------------------------------------------------------------------------
# activations (reference operators/activation_op.cc)
# ---------------------------------------------------------------------------

_ACTS = {
    "relu": lambda x, a: torch.relu(x),
    "pow": lambda x, a: x ** a.get("factor", 1.0),
}


def _make_act(op_type, fn):
    @register(op_type)
    def _rule(ctx, op, fn=fn):
        x = ctx.get_input(op, "X")
        ctx.set_output(op, "Out", fn(x, op.attrs))


for _t, _f in _ACTS.items():
    _make_act(_t, _f)


# ---------------------------------------------------------------------------
# compares & logicals
# ---------------------------------------------------------------------------


@register("equal")
def _equal(ctx, op):
    x = ctx.get_input(op, "X")
    y = ctx.get_input(op, "Y")
    ctx.set_output(op, "Out", x == y)


@register("logical_not")
def _logical_not(ctx, op):
    ctx.set_output(op, "Out", ~ctx.get_input(op, "X").to(torch.bool))
