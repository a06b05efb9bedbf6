"""Math op rules: elementwise (reference broadcast semantics), mul/matmul,
reductions, activations, compares, logicals, cumsum.

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
    "elementwise_sub": lambda x, y: x - y,
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
    (reference operators/mul_op.cc), plus an optional ``Bias`` per output
    column.  Layers never give mul a ``Bias``; the inference
    transpiler's mul+BN fold does (the JAX package's rule never reads
    one).  Where ``ctx.block_rows`` is set (the serving backends), the
    product runs as :func:`blocked_matmul`; else as one product."""
    x = ctx.get_input(op, "X")
    y = ctx.get_input(op, "Y")
    x, y = mixed_dtypes(x, y)
    xn = op.attrs.get("x_num_col_dims", 1)
    yn = op.attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape((-1, _prod(xs[xn:])))
    y2 = y.reshape((_prod(ys[:yn]), -1))
    out = (torch.matmul(x2, y2) if ctx.block_rows is None else
           torch.ops.paddle_tpu_torch.blocked_mm(x2, y2, ctx.block_rows))
    bias = ctx.get_input(op, "Bias")
    if bias is not None:
        out = out + bias.to(out.dtype).reshape(1, -1)
    ctx.set_output(op, "Out", out.reshape(xs[:xn] + ys[yn:]))


def blocked_matmul(x, y, block_rows):
    """``x [rows, K] @ y [K, N]`` as one batched product over blocks of
    ``block_rows`` rows, ``x`` padded with zero rows to whole blocks, at
    least two, and ``y`` expanded with a batch stride of 0 (no copy): a
    row then meets one product shape, a block of ``block_rows`` rows,
    whatever the number of rows around it, and cuBLAS's strided batched
    SGEMM gives it the same bits at every block count from 2 (PyTorch
    runs a batch of one block as a plain GEMM, whose bits differ).
    tools/serving_gemm_probe.py holds this on the card; the CPU
    multiplies each block alone."""
    rows, k = x.shape
    cols = y.shape[1]
    n = max(2, -(-rows // block_rows))
    if n * block_rows != rows:
        x = torch.cat([x, x.new_zeros((n * block_rows - rows, k))])
    out = torch.bmm(x.reshape(n, block_rows, k), y.expand(n, k, cols))
    return out.reshape(n * block_rows, cols)[:rows]


# the serving backends' product as a PyTorch operator: under torch.export
# its rows stay the symbolic batch and the block count, derived from them,
# is never traced (a traced block count guards on its value), so the
# exported graph runs this same function at every batch
_blocked_mm_op = torch.library.custom_op(
    "paddle_tpu_torch::blocked_mm", mutates_args=(),
    schema="(Tensor x, Tensor y, int block_rows) -> Tensor")(blocked_matmul)


@_blocked_mm_op.register_fake
def _blocked_mm_fake(x, y, block_rows):
    return x.new_empty((x.shape[0], y.shape[1]))


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
    "square": lambda x, a: x * x,
    "log": lambda x, a: torch.log(x),
}


def _make_act(op_type, fn):
    @register(op_type)
    def _rule(ctx, op, fn=fn):
        x = ctx.get_input(op, "X")
        ctx.set_output(op, "Out", fn(x, op.attrs))


for _t, _f in _ACTS.items():
    _make_act(_t, _f)


@register("mean")
def _mean(ctx, op):
    """The mean of every element.  An integer or bool input gives
    float32, as ``jnp.mean`` does: its float32 sum times the float32
    reciprocal of the count, which is how XLA divides by a constant (the
    sum is exact below 2**24)."""
    x = ctx.get_input(op, "X")
    if x.is_floating_point():
        out = x.mean()
    else:
        inv = torch.full((), 1.0 / max(x.numel(), 1), dtype=torch.float32,
                         device=x.device)
        out = x.float().sum() * inv
    ctx.set_output(op, "Out", out.reshape((1,)))


# ---------------------------------------------------------------------------
# compares & logicals
# ---------------------------------------------------------------------------


_CMP = {
    "less_than": lambda x, y: x < y,
    "less_equal": lambda x, y: x <= y,
    "greater_than": lambda x, y: x > y,
    "greater_equal": lambda x, y: x >= y,
    "equal": lambda x, y: x == y,
    "not_equal": lambda x, y: x != y,
}


def _make_cmp(op_type, fn):
    @register(op_type)
    def _rule(ctx, op, fn=fn):
        ctx.set_output(op, "Out", fn(ctx.get_input(op, "X"),
                                     ctx.get_input(op, "Y")))


for _t, _f in _CMP.items():
    _make_cmp(_t, _f)

_LOGICAL = {
    "logical_and": lambda x, y: x & y,
    "logical_or": lambda x, y: x | y,
    "logical_xor": lambda x, y: x ^ y,
}


def _make_logical(op_type, fn):
    @register(op_type)
    def _rule(ctx, op, fn=fn):
        x = ctx.get_input(op, "X").to(torch.bool)
        y = ctx.get_input(op, "Y").to(torch.bool)
        ctx.set_output(op, "Out", fn(x, y))


for _t, _f in _LOGICAL.items():
    _make_logical(_t, _f)


@register("logical_not")
def _logical_not(ctx, op):
    ctx.set_output(op, "Out", ~ctx.get_input(op, "X").to(torch.bool))


# ---------------------------------------------------------------------------
# misc math
# ---------------------------------------------------------------------------


@register("cumsum")
def _cumsum(ctx, op):
    """The running sum along ``axis``; ``reverse`` sums from the end,
    ``exclusive`` leaves each element out of its own sum (the running
    sum minus the element, as the JAX package computes it).  An integer
    or bool input sums in its own type (a bool in int64), not in the
    int64 that ``torch.cumsum`` promotes to."""
    x = ctx.get_input(op, "X")
    if x.dtype == torch.bool:
        x = x.long()
    axis = op.attrs.get("axis", -1)
    if op.attrs.get("reverse", False):
        out = torch.flip(torch.cumsum(torch.flip(x, (axis,)), axis,
                                      dtype=x.dtype), (axis,))
    else:
        out = torch.cumsum(x, axis, dtype=x.dtype)
    if op.attrs.get("exclusive", False):
        out = out - x
    ctx.set_output(op, "Out", out)
