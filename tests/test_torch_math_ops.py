"""The math op rules of the port (``paddle_tpu_torch/ops/math_ops.py``)
against the JAX package's on the CPU, one parametrised case an op or an
edge of it, after the matching ``tests/unittests/test_*_op.py`` cases.

Each case builds the same one-op Program with each package (the op
appended raw through ``LayerHelper``, so that both Programs hold the
same op and attrs), copies the JAX startup's state into the port
(``test_torch_ops._pair``, through ``test_torch_tensor_ops._case``),
runs both on the same seeded numpy feed and compares:
- forward: float32 outputs to 1e-5 relative and absolute (XLA and torch
  round transcendental functions and sums differently in the last
  bits); integer, bool and index outputs exactly, dtype included;
- gradient: ``X@GRAD`` (and ``Y@GRAD`` for binary ops) of
  ``mean(op(x))`` through ``calc_gradient`` in both packages, 1e-5.

The tie cases put inputs exactly on a clip's bound, on tied maxima and
on equal operands of ``elementwise_max``: ``jax.grad`` gives such an
input half the gradient (``jnp.clip`` is ``minimum(maximum(x, lo),
hi)``), and ``amax`` shares it among tied maxima; each is asserted to
be exactly 0.5 (a quarter after the mean's 1/n, where stated) besides
matching.  The integer cases hold ``reduce_mean`` of int32 (float32,
the JAX package's bits) and ``reduce_prod`` of int32 (int32, wrapping
as XLA does; ``torch.prod`` would give int64).
"""
import numpy as np
import pytest

from test_torch_tensor_ops import _case


def _rand(seed, shape=(3, 4), lo=-2.0, hi=2.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype("float32")


# ---------------------------------------------------------------------------
# activations (test_activation_op.py): (attrs, input range or array)
# ---------------------------------------------------------------------------

TIES = np.array([[-1.0, 0.0, 3.0, 6.0], [6.5, 0.0, 6.0, -0.5]], "float32")

ACTS = {
    "relu6": ({"threshold": 6.0}, TIES),
    "leaky_relu": ({"alpha": 0.1}, np.array([[0.0, -1.0, 2.0, -0.0]], "float32")),
    "elu": ({"alpha": 0.5}, (-3.0, 3.0)),
    "elu_large": ({"alpha": 1.0}, np.array([[0.0, 50.0, -50.0, 100.0]], "float32")),
    "brelu": ({"t_min": 1.0, "t_max": 4.0},
              np.array([[1.0, 4.0, 0.5, 5.0, 2.0]], "float32")),
    "soft_relu": ({"threshold": 2.0}, np.array([[2.0, -2.0, 0.5, 3.0]], "float32")),
    "sigmoid": ({}, (-6.0, 6.0)),
    "logsigmoid": ({}, (-6.0, 6.0)),
    "tanh": ({}, (-3.0, 3.0)),
    "tanh_shrink": ({}, (-3.0, 3.0)),
    "stanh": ({"scale_a": 0.67, "scale_b": 1.7159}, (-3.0, 3.0)),
    # slope 0.25: x * slope + offset is exact with or without XLA's fused
    # multiply-add, so -2 and 2 land on the bounds in both packages
    "hard_sigmoid": ({"slope": 0.25, "offset": 0.5},
                     np.array([[-2.0, 2.0, 0.0, -3.0, 3.0]], "float32")),
    "swish": ({"beta": 1.5}, (-4.0, 4.0)),
    "softplus": ({}, np.array([[0.0, 30.0, -30.0, 1.0]], "float32")),
    "softsign": ({}, (-3.0, 3.0)),
    "softshrink": ({"lambda": 0.5},
                   np.array([[0.5, -0.5, 0.2, 1.5, -2.0]], "float32")),
    "hard_shrink": ({"threshold": 0.5},
                    np.array([[0.5, -0.5, 0.2, 1.5, -2.0]], "float32")),
    "thresholded_relu": ({"threshold": 1.0},
                         np.array([[1.0, 0.5, 2.0, -1.0]], "float32")),
    "abs": ({}, np.array([[0.0, -1.5, 2.0, -0.0]], "float32")),
    "ceil": ({}, (-3.0, 3.0)),
    "floor": ({}, (-3.0, 3.0)),
    "cos": ({}, (-3.0, 3.0)),
    "sin": ({}, (-3.0, 3.0)),
    "round": ({}, np.array([[0.5, 1.5, 2.5, -0.5, -1.5, 0.49]], "float32")),
    "reciprocal": ({}, (0.5, 3.0)),
    "exp": ({}, (-3.0, 3.0)),
    "sqrt": ({}, (0.1, 4.0)),
    "rsqrt": ({}, (0.1, 4.0)),
    "selu": ({}, (-3.0, 3.0)),
    "sign": ({}, np.array([[0.0, -2.0, 3.0, -0.0]], "float32")),
}


@pytest.mark.parametrize("case", list(ACTS))
def test_activation_matches_jax(case):
    attrs, x = ACTS[case]
    if isinstance(x, tuple):
        x = _rand(len(case), (3, 5), *x)
    op_type = case[:-len("_large")] if case.endswith("_large") else case
    got, _ = _case({"x": x}, op_type, attrs=attrs)
    if case in ("relu6", "brelu", "hard_sigmoid"):
        n = x.size
        on_bound = {"relu6": (x == 0) | (x == 6),
                    "brelu": (x == 1) | (x == 4),
                    "hard_sigmoid": np.abs(x) == 2.0}[case]
        scale = 0.25 if case == "hard_sigmoid" else 1.0
        np.testing.assert_array_equal(got[1][on_bound],
                                      np.float32(0.5 * scale / n))
    if case in ("leaky_relu", "abs"):   # slope 1 at 0 and -0, as in JAX
        np.testing.assert_array_equal(got[1][0, [0, 3]], np.float32(1 / 4))


# ---------------------------------------------------------------------------
# elementwise binary ops (test_elementwise_*_op.py)
# ---------------------------------------------------------------------------


def _mod_pair(kind):
    rng = np.random.RandomState(3)
    if kind == "int":
        x = rng.randint(-20, 20, (4, 5)).astype("int32")
        y = rng.choice([-7, -3, -2, 2, 3, 7], (4, 5)).astype("int32")
    else:
        x = rng.uniform(-9, 9, (4, 5)).astype("float32")
        y = rng.choice([-2.5, -1.5, 1.5, 2.5], (4, 5)).astype("float32")
    return x, y


BINOPS = {
    "elementwise_max": lambda: (TIES, np.array([[0.0, 0.0, 3.0, 5.0],
                                                [7.0, 1.0, 6.0, -0.5]], "float32")),
    "elementwise_max_axis": lambda: (_rand(4, (2, 3, 4)), _rand(5, (3,))),
    "elementwise_pow": lambda: (_rand(6, (3, 4), 0.5, 2.0), _rand(7, (3, 4), -2.0, 2.0)),
    "elementwise_pow_int": lambda: (np.arange(-6, 6).reshape(3, 4).astype("int32"),
                                    np.tile(np.array([0, 1, 2, 3], "int32"), (3, 1))),
    "elementwise_mod": lambda: _mod_pair("float"),
    "elementwise_mod_int": lambda: _mod_pair("int"),
    "elementwise_floordiv": lambda: _mod_pair("float"),
    "elementwise_floordiv_int": lambda: _mod_pair("int"),
}


@pytest.mark.parametrize("case", list(BINOPS))
def test_binary_op_matches_jax(case):
    x, y = BINOPS[case]()
    op_type = case.replace("_axis", "").replace("_int", "")
    attrs = {"axis": 1} if case.endswith("_axis") else {"axis": -1}
    got, _ = _case({"x": x, "y": y}, op_type, attrs=attrs)
    if case == "elementwise_max":   # equal operands split the gradient
        tie = x == np.array([[0.0, 0.0, 3.0, 5.0], [7.0, 1.0, 6.0, -0.5]])
        np.testing.assert_array_equal(got[1][tie], np.float32(0.5 / x.size))
        np.testing.assert_array_equal(got[2][tie], np.float32(0.5 / x.size))
    if op_type == "elementwise_mod":   # Python's sign rule: the divisor's
        r = got[0]
        assert ((r == 0) | (np.sign(r) == np.sign(y))).all()


# ---------------------------------------------------------------------------
# reductions (test_reduce_op.py)
# ---------------------------------------------------------------------------

TIED = np.array([[[1.0, 3.0, 3.0], [2.0, 2.0, -1.0]],
                 [[0.0, 0.0, 0.0], [5.0, 4.0, 5.0]]], "float32")

#: (op, dim, keep_dim, reduce_all, input)
REDUCE = {
    "max_ties_last": ("reduce_max", [-1], False, False, TIED),
    "max_all": ("reduce_max", None, False, True, TIED),
    "min_ties": ("reduce_min", [1], True, False, TIED),
    "min_two_dims": ("reduce_min", [0, 2], False, False, TIED),
    "mean": ("reduce_mean", [1], False, False, None),
    "mean_keep_all": ("reduce_mean", None, True, True, None),
    "prod": ("reduce_prod", [0], False, False, None),
    "prod_two_dims_with_zero": ("reduce_prod", [0, 2], True, False, "zero"),
    "mean_int32": ("reduce_mean", [1], False, False, "int32"),
    "mean_int32_all": ("reduce_mean", None, False, True, "int32"),
    "prod_int32_wraps": ("reduce_prod", [1], False, False, "int32_big"),
    "max_int32": ("reduce_max", [0], False, False, "int32"),
}


@pytest.mark.parametrize("case", list(REDUCE))
def test_reduce_matches_jax(case):
    op_type, dim, keep, red_all, x = REDUCE[case]
    rng = np.random.RandomState(9)
    if x is None:
        x = rng.uniform(0.5, 1.5, (2, 3, 4)).astype("float32")
    elif isinstance(x, str) and x == "zero":
        x = rng.uniform(0.5, 1.5, (2, 3, 4)).astype("float32")
        x[1, 2, 3] = 0.0
    elif isinstance(x, str) and x == "int32":
        x = rng.randint(-7, 8, (4, 5, 3)).astype("int32")
    elif isinstance(x, str):
        x = rng.randint(200, 2000, (3, 6)).astype("int32")
    attrs = {"dim": dim, "keep_dim": keep, "reduce_all": red_all}
    got, want = _case({"x": x}, op_type, attrs=attrs)
    if op_type == "reduce_mean" and x.dtype.kind != "f":
        assert got[0].dtype == np.float32
        assert got[0].tobytes() == want[0].tobytes()
    if case == "prod_int32_wraps":
        assert got[0].dtype == np.int32
        assert (got[0] != np.prod(x.astype(np.int64), axis=1)).any()
    if case == "max_ties_last":   # [1, 3, 3]: half each to the 3s
        n = 4   # the output's size, the mean's 1/n
        np.testing.assert_array_equal(got[1][0, 0], np.float32([0, 0.5 / n, 0.5 / n]))
        np.testing.assert_array_equal(got[1][1, 0], np.float32([1 / 3 / n] * 3))


# ---------------------------------------------------------------------------
# prelu, maxout, clip, clip_by_norm, cos_sim, norm, bilinear, conv_shift
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["all", "channel", "element"])
def test_prelu_matches_jax(mode):
    x = _rand(11, (2, 3, 2, 2))
    x[0, 0, 0, 0] = 0.0
    alpha = {"all": np.array([0.25], "float32"),
             "channel": np.array([0.1, 0.2, 0.3], "float32"),
             "element": _rand(12, (1, 3, 2, 2), 0.0, 0.5)}[mode]
    _case({"x": x, "alpha": alpha}, "prelu", attrs={"mode": mode})


@pytest.mark.parametrize("ties", [False, True])
def test_maxout_matches_jax(ties):
    x = _rand(13, (2, 6, 3, 3))
    if ties:
        x[:, 1] = x[:, 0]   # channels 0 and 1 of group 0 tie everywhere
    got, _ = _case({"x": x}, "maxout", attrs={"groups": 2})
    if ties:
        share = got[1][:, 0][x[:, 0] >= x[:, 1]]
        np.testing.assert_array_equal(share, np.float32(0.5 / (x.size // 2)))


CLIPS = {
    "inside": (-0.5, 0.5, None),
    "on_the_bounds": (-1.0, 1.0, np.array([[-1.0, 1.0, 0.0, 2.0, -3.0]], "float32")),
}


@pytest.mark.parametrize("case", list(CLIPS))
def test_clip_matches_jax(case):
    lo, hi, x = CLIPS[case]
    x = _rand(14, (3, 4)) if x is None else x
    got, _ = _case({"x": x}, "clip", attrs={"min": lo, "max": hi})
    if case == "on_the_bounds":
        np.testing.assert_array_equal(got[1][0, :2], np.float32(0.5 / x.size))


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_norm_matches_jax(max_norm):
    _case({"x": _rand(15, (4, 5))}, "clip_by_norm", attrs={"max_norm": max_norm})


@pytest.mark.parametrize("y_rows", [4, 1])
def test_cos_sim_matches_jax(y_rows):
    _case({"x": _rand(16, (4, 6)), "y": _rand(17, (y_rows, 6))}, "cos_sim",
          outputs={"Out": 1, "XNorm": 1, "YNorm": 1})


@pytest.mark.parametrize("axis", [1, -1])
def test_norm_matches_jax(axis):
    _case({"x": _rand(18, (3, 4, 5))}, "norm", outputs={"Out": 1, "Norm": 1},
          attrs={"axis": axis, "epsilon": 1e-10})


@pytest.mark.parametrize("bias", [False, True])
def test_bilinear_tensor_product_matches_jax(bias):
    feeds = {"x": _rand(19, (4, 3)), "y": _rand(20, (4, 5)),
             "weight": _rand(21, (2, 3, 5))}
    if bias:
        feeds["bias"] = _rand(22, (1, 2))
    _case(feeds, "bilinear_tensor_product")


@pytest.mark.parametrize("n", [1, 3, 5])
def test_conv_shift_matches_jax(n):
    _case({"x": _rand(23, (3, 7)), "y": _rand(24, (3, n))}, "conv_shift")


def test_every_math_ops_name_has_a_port_rule():
    import paddle_tpu.ops  # noqa: F401
    import paddle_tpu_torch.ops  # noqa: F401
    from paddle_tpu import registry as jreg
    from paddle_tpu_torch import registry as treg

    names = {n for n, f in jreg.RULES.items()
             if f.__module__ == "paddle_tpu.ops.math_ops"}
    assert len(names) == 70
    assert not names - set(treg.RULES)
