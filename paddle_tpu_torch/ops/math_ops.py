"""Math op rules: elementwise (reference broadcast semantics), mul/matmul,
reductions, activations, compares, logicals, clips, norms, cumsum.

Translated from the JAX package's ``paddle_tpu/ops/math_ops.py``, every
op it registers.  Each is a plain torch expression: XLA fused these on
the TPU, and no Pallas kernel ever computed them.  ``mul`` and
``matmul`` stay ``torch.matmul``, as the JAX package left them to XLA.

Gradients are autograd's, and they follow ``jax.grad`` where the two
could part:
- a clip (``clip``, ``relu6``, ``brelu``, ``hard_sigmoid``, ``soft_relu``)
  is ``minimum(maximum(x, lo), hi)`` over 0-d tensor bounds, as
  ``jnp.clip`` is, so an input exactly at a bound takes half the
  gradient (``torch.clamp`` would give it all);
- ``reduce_max``, ``reduce_min`` and ``maxout`` are ``amax``/``amin``,
  which share the gradient evenly among tied maxima, as JAX does;
- ``leaky_relu`` is ``where(x >= 0, x, alpha * x)``: slope 1 at 0, as
  ``jax.nn.leaky_relu`` (``F.leaky_relu`` gives ``alpha`` there); ``abs``
  has slope 1 at 0 as JAX's (``torch.abs`` gives 0).
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from ..registry import register
from .common import at_least_f32, bcast_y, mixed_dtypes, reduce_axes

# ---------------------------------------------------------------------------
# elementwise binary with paddle axis-broadcast
# ---------------------------------------------------------------------------

_BINOPS = {
    "elementwise_add": lambda x, y: x + y,
    "elementwise_sub": lambda x, y: x - y,
    "elementwise_mul": lambda x, y: x * y,
    "elementwise_div": lambda x, y: x / y,
    "elementwise_min": torch.minimum,
    "elementwise_max": torch.maximum,
    "elementwise_pow": lambda x, y: x ** y,
    # Python's sign rule, as JAX's ``%`` and ``//`` (not ``torch.fmod``)
    "elementwise_mod": torch.remainder,
    "elementwise_floordiv": lambda x, y: torch.div(x, y, rounding_mode="floor"),
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
    ctx.copy_lengths(op.inputs["X"][0], op.outputs["Out"][0])


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


@register_flop_formula(torch.ops.paddle_tpu_torch.blocked_mm)
def _blocked_mm_flops(x, y, block_rows, out_shape=None, **kwargs):
    """The batched product as it runs: whole blocks, at least two, the
    pad rows included (``observability.xla_stats`` counts a step)."""
    (rows, k), cols = x, y[1]
    return 2 * max(2, -(-rows // block_rows)) * block_rows * k * cols


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
    """The sum over ``dim`` (every axis with ``reduce_all``).  An int32
    or int64 input sums in its own type and wraps on overflow, as the
    JAX package's int32 ``jnp.sum`` does (``torch.sum`` would promote it
    to int64).  The narrower types follow the ``cumsum`` rule: int8,
    int16 and uint8 sum in their own type (``jnp.sum`` widens them to
    int32 or uint32), a bool input sums in int64."""
    x = ctx.get_input(op, "X")
    if x.dtype == torch.bool:
        x = x.long()
    out = torch.sum(x, dim=_reduce_dims(op, x),
                    keepdim=op.attrs.get("keep_dim", False),
                    dtype=None if x.is_floating_point() else x.dtype)
    ctx.set_output(op, "Out", out)


def _reduce_dims(op, x):
    """The axes a reduce op reduces (every axis with ``reduce_all``)."""
    if op.attrs.get("reduce_all", False):
        return tuple(range(x.dim()))
    return reduce_axes(op.attrs.get("dim"), x.dim())


@register("reduce_mean")
def _reduce_mean(ctx, op):
    """The mean over ``dim``.  An integer or bool input gives float32, as
    ``jnp.mean`` does: its float32 sum times the float32 reciprocal of
    the count (``torch.mean`` raises on an integer tensor)."""
    x = ctx.get_input(op, "X")
    axes = _reduce_dims(op, x)
    keep = op.attrs.get("keep_dim", False)
    if x.is_floating_point():
        out = torch.mean(x, dim=axes, keepdim=keep)
    else:
        count = _prod(x.shape[a] for a in axes)
        inv = torch.full((), 1.0 / max(count, 1), dtype=torch.float32,
                         device=x.device)
        out = torch.sum(x.float(), dim=axes, keepdim=keep) * inv
    ctx.set_output(op, "Out", out)


def _make_extreme(op_type, fn):
    @register(op_type)
    def _rule(ctx, op, fn=fn):
        """``amax``/``amin`` over ``dim``: tied extremes share the
        gradient evenly, as JAX's ``max``/``min`` do (``max(dim)`` would
        give it all to one index)."""
        x = ctx.get_input(op, "X")
        ctx.set_output(op, "Out", fn(x, dim=_reduce_dims(op, x),
                                     keepdim=op.attrs.get("keep_dim", False)))


_make_extreme("reduce_max", torch.amax)
_make_extreme("reduce_min", torch.amin)


@register("reduce_prod")
def _reduce_prod(ctx, op):
    """The product over ``dim``, one axis at a time (``torch.prod`` takes
    one).  An integer input multiplies in its own type and wraps, as the
    JAX package's int32 ``jnp.prod`` does (``torch.prod`` would promote
    it to int64); a bool input in int64, as ``reduce_sum``'s."""
    x = ctx.get_input(op, "X")
    if x.dtype == torch.bool:
        x = x.long()
    keep = op.attrs.get("keep_dim", False)
    out = x
    for a in sorted(_reduce_dims(op, x), reverse=True):
        out = torch.prod(out, dim=a, keepdim=keep,
                         dtype=None if x.is_floating_point() else x.dtype)
    ctx.set_output(op, "Out", out)


# ---------------------------------------------------------------------------
# activations (reference operators/activation_op.cc)
# ---------------------------------------------------------------------------

def _clip(x, lo, hi):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)`` with 0-d tensor
    bounds, so that an input equal to a bound takes half the gradient."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def _elu(x, alpha):
    """``jax.nn.elu``: ``expm1`` of the input only where it is not
    positive, so that a large input's gradient stays finite."""
    neg = torch.where(x > 0, torch.zeros_like(x), x)
    return torch.where(x > 0, x, alpha * torch.expm1(neg))


def _abs(x):
    """``|x|`` with JAX's gradient: slope 1 at 0 and -0 (``x >= 0``),
    where ``torch.abs`` gives 0; adding 0.0 turns -0.0 into 0.0."""
    if not x.is_floating_point():
        return torch.abs(x)
    return torch.where(x >= 0, x, -x) + 0.0


_ACTS = {
    "relu": lambda x, a: torch.relu(x),
    "relu6": lambda x, a: _clip(x, 0.0, a.get("threshold", 6.0)),
    "leaky_relu": lambda x, a: torch.where(x >= 0, x, a.get("alpha", 0.02) * x),
    "elu": lambda x, a: _elu(x, a.get("alpha", 1.0)),
    "brelu": lambda x, a: _clip(x, a.get("t_min", 0.0), a.get("t_max", 24.0)),
    "soft_relu": lambda x, a: torch.log1p(torch.exp(_clip(
        x, -a.get("threshold", 40.0), a.get("threshold", 40.0)))),
    "sigmoid": lambda x, a: torch.sigmoid(x),
    "logsigmoid": lambda x, a: torch.nn.functional.logsigmoid(x),
    "tanh": lambda x, a: torch.tanh(x),
    "tanh_shrink": lambda x, a: x - torch.tanh(x),
    "stanh": lambda x, a: a.get("scale_b", 1.7159) * torch.tanh(
        x * a.get("scale_a", 2.0 / 3.0)),
    "hard_sigmoid": lambda x, a: _clip(
        x * a.get("slope", 0.2) + a.get("offset", 0.5), 0.0, 1.0),
    "swish": lambda x, a: x * torch.sigmoid(a.get("beta", 1.0) * x),
    # jax.nn.softplus is logaddexp(x, 0) (F.softplus turns linear past 20)
    "softplus": lambda x, a: torch.logaddexp(x, torch.zeros_like(x)),
    "softsign": lambda x, a: x / (1 + torch.abs(x)),
    "softshrink": lambda x, a: torch.sign(x) * torch.maximum(
        torch.abs(x) - a.get("lambda", 0.5), torch.zeros_like(x)),
    "hard_shrink": lambda x, a: torch.where(
        torch.abs(x) > a.get("threshold", 0.5), x, torch.zeros_like(x)),
    "thresholded_relu": lambda x, a: torch.where(
        x > a.get("threshold", 1.0), x, torch.zeros_like(x)),
    "abs": lambda x, a: _abs(x),
    "ceil": lambda x, a: torch.ceil(x),
    "floor": lambda x, a: torch.floor(x),
    "cos": lambda x, a: torch.cos(x),
    "sin": lambda x, a: torch.sin(x),
    # half to even, as jnp.round
    "round": lambda x, a: torch.round(x),
    "reciprocal": lambda x, a: 1.0 / x,
    "square": lambda x, a: x * x,
    "exp": lambda x, a: torch.exp(x),
    "sqrt": lambda x, a: torch.sqrt(x),
    "rsqrt": lambda x, a: 1.0 / torch.sqrt(x),
    "log": lambda x, a: torch.log(x),
    "selu": lambda x, a: a.get("scale", 1.0507009873554805) * _elu(
        x, a.get("alpha", 1.6732632423543772)),
    "pow": lambda x, a: x ** a.get("factor", 1.0),
}


def _make_act(op_type, fn):
    @register(op_type)
    def _rule(ctx, op, fn=fn):
        x = ctx.get_input(op, "X")
        ctx.set_output(op, "Out", fn(x, op.attrs))
        ctx.copy_lengths(op.inputs["X"][0], op.outputs["Out"][0])


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


@register("prelu")
def _prelu(ctx, op):
    """``x`` where positive, else ``alpha * x``; ``alpha`` one value
    (``all``), one a channel (``channel``, axis 1) or one an element."""
    x = ctx.get_input(op, "X")
    alpha = ctx.get_input(op, "Alpha")
    mode = op.attrs.get("mode", "all")
    if mode == "channel":
        alpha = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    elif mode == "all":
        alpha = alpha.reshape(())
    ctx.set_output(op, "Out", torch.where(x > 0, x, alpha * x))


@register("maxout")
def _maxout(ctx, op):
    """NCHW: the max over each run of ``groups`` channels (``amax``, so
    tied maxima share the gradient as in JAX)."""
    x = ctx.get_input(op, "X")
    g = op.attrs["groups"]
    n, c, h, w = x.shape
    ctx.set_output(op, "Out", torch.amax(x.reshape(n, c // g, g, h, w), dim=2))


@register("clip")
def _clip_rule(ctx, op):
    ctx.set_output(op, "Out", _clip(ctx.get_input(op, "X"), op.attrs["min"],
                                    op.attrs["max"]))


@register("clip_by_norm")
def _clip_by_norm(ctx, op):
    """``x`` scaled to L2 norm ``max_norm`` where its norm is larger; the
    norm in float32 for a half type (float64 stays float64)."""
    x = ctx.get_input(op, "X")
    mn = op.attrs["max_norm"]
    norm = torch.sqrt(torch.sum(at_least_f32(x) ** 2))
    scale = torch.where(norm > mn, mn / torch.maximum(
        norm, norm.new_full((), 1e-12)), torch.ones_like(norm))
    ctx.set_output(op, "Out", (x * scale).to(x.dtype))


@register("cos_sim")
def _cos_sim(ctx, op):
    x = ctx.get_input(op, "X")
    y = ctx.get_input(op, "Y")
    xn = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(y * y, dim=-1, keepdim=True))
    out = torch.sum(x * y, dim=-1, keepdim=True) / (xn * yn + 1e-12)
    ctx.set_output(op, "Out", out)
    ctx.set_output(op, "XNorm", xn)
    ctx.set_output(op, "YNorm", yn)


@register("norm")
def _norm(ctx, op):
    x = ctx.get_input(op, "X")
    axis = op.attrs.get("axis", -1)
    eps = op.attrs.get("epsilon", 1e-12)
    norm = torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True) + eps)
    ctx.set_output(op, "Out", x / norm)
    ctx.set_output(op, "Norm", norm)


@register("sign")
def _sign(ctx, op):
    ctx.set_output(op, "Out", torch.sign(ctx.get_input(op, "X")))


@register("bilinear_tensor_product")
def _bilinear_tensor_product(ctx, op):
    """``out[b, s] = x[b] @ Weight[s] @ y[b]`` plus ``Bias``."""
    x = ctx.get_input(op, "X")  # [b, m]
    y = ctx.get_input(op, "Y")  # [b, n]
    w = ctx.get_input(op, "Weight")  # [size, m, n]
    out = torch.einsum("bm,smn,bn->bs", x, w, y)
    b = ctx.get_input(op, "Bias")
    if b is not None:
        out = out + b
    ctx.set_output(op, "Out", out)


@register("conv_shift")
def _conv_shift(ctx, op):
    """The circular convolution of each row of ``X`` [b, m] with its row
    of ``Y`` [b, n] (n odd); the index table is built on the device."""
    x = ctx.get_input(op, "X")
    y = ctx.get_input(op, "Y")
    m, half = x.shape[1], y.shape[1] // 2
    idx = (torch.arange(m, device=x.device)[:, None]
           + torch.arange(-half, half + 1, device=x.device)[None, :]) % m
    ctx.set_output(op, "Out", torch.einsum("bmn,bn->bm", x[:, idx], y))
