"""The tensor op rules of the port (``paddle_tpu_torch/ops/tensor_ops.py``)
against the JAX package's on the CPU, one parametrised case an op or an
edge of it, after the matching ``tests/unittests/test_*_op.py`` cases.

Each case builds the same one-op Program with each package (the op
appended raw through ``LayerHelper``), copies the JAX startup's state
into the port (``test_torch_ops._pair``), runs both on the same seeded
numpy feed and compares:
- forward: float32 outputs to 1e-5 relative and absolute, integer, bool
  and index outputs exactly.  An index the reference casts to int64
  comes back int32 from the JAX package (x64 is off) and int64 from the
  port: the values must be equal and the port's dtype int64;
- gradient: the gradient of ``mean`` of the first output with respect
  to each float input, through ``calc_gradient`` in both packages, 1e-5.

Indices out of range follow the JAX package: ``scatter`` drops an id
outside [-n, n), wraps one in [-n, 0), and lets the last of repeated
ids win; ``multiplex`` wraps and clamps as ``xs[ids, rows]`` does.
``argsort`` is stable, as ``jnp.argsort``.

The random ops draw from the port's own generators, so they are held to
their distributions (as ``test_gaussian_random_distribution``): each
sample mean within 5 standard errors, each variance within 5 of its
own (for a uniform, the fourth-moment error), and every value inside
its range; and a Program holding all four, run through the fast path,
gives the bits of the same steps run op by op.
"""
import math

import numpy as np
import pytest

import paddle_tpu as jfluid  # noqa: F401  (the reference _pair runs)
import paddle_tpu_torch as tfluid
from test_torch_ops import _pair

TOL = 1e-5


def _case(feeds, op_type, inputs=None, outputs=None, attrs=None,
          dtypes=None, wrt=None, grad=True):
    """One ``op_type`` op over data variables named as ``feeds``'
    keys; ``inputs`` maps a slot to feed names (by default each feed to
    the slot of its capitalized name: ``x`` to ``X``, ``alpha`` to
    ``Alpha``), ``outputs`` a slot to its number of variables (``Out``,
    one, by default); ``dtypes`` an output slot to its dtype (the first
    input's by default).  Returns (port, JAX) fetches, compared: every
    output, then the gradient of mean(first output) with respect to
    ``wrt`` (every float feed by default)."""
    inputs = inputs or {n.capitalize(): [n] for n in feeds}
    outputs = outputs or {"Out": 1}

    def build(fl):
        vs = {n: fl.layers.data(name=n, shape=list(a.shape), dtype=str(a.dtype),
                                append_batch_size=False,
                                stop_gradient=a.dtype.kind != "f")
              for n, a in feeds.items()}
        helper = fl.layer_helper.LayerHelper(op_type)
        first = vs[next(iter(inputs.values()))[0]]
        outs = {s: [helper.create_variable_for_type_inference(
            dtype=(dtypes or {}).get(s, first.dtype)) for _ in range(k)]
            for s, k in outputs.items()}
        helper.append_op(type=op_type,
                         inputs={s: [vs[n] for n in ns] for s, ns in inputs.items()},
                         outputs=outs, attrs=attrs or {})
        fetch = [v for vl in outs.values() for v in vl]
        names = (wrt if wrt is not None else
                 [n for n, a in feeds.items() if a.dtype.kind == "f"])
        if grad and names:
            fetch += fl.backward.calc_gradient(fl.layers.mean(fetch[0]),
                                               [vs[n] for n in names])
        return fetch

    want, got = _pair(build, feeds)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        if w.dtype.kind == "f":
            assert g.dtype == w.dtype
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
        else:
            assert g.dtype == w.dtype or (w.dtype == np.int32
                                          and g.dtype == np.int64), (g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w)
    return got, want


def _rand(seed, shape, lo=-2.0, hi=2.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype("float32")


def test_fill_zeros_like_matches_jax():
    got, _ = _case({"x": _rand(1, (3, 4))}, "fill_zeros_like", {"X": ["x"]},
                   {"Out": 1}, grad=False)
    assert not got[0].any()


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_concat_matches_jax(axis):
    shapes = {0: [(2, 3), (4, 3), (1, 3)], 1: [(2, 3), (2, 1), (2, 4)],
              -1: [(2, 2, 3), (2, 2, 1), (2, 2, 2)]}[axis]
    feeds = {"x%d" % i: _rand(i, s) for i, s in enumerate(shapes)}
    _case(feeds, "concat", {"X": list(feeds)}, {"Out": 1}, {"axis": axis})


SPLITS = {
    "num": ({"num": 3, "axis": 1}, 3),
    "sections": ({"sections": [2, 3, 1], "axis": -1}, 3),
    # sections short of the axis: the last piece takes the rest
    "sections_short": ({"sections": [2, 2], "axis": 1}, 2),
}


@pytest.mark.parametrize("case", list(SPLITS))
def test_split_matches_jax(case):
    attrs, k = SPLITS[case]
    got, _ = _case({"x": _rand(2, (2, 6))}, "split", {"X": ["x"]}, {"Out": k},
                   attrs)
    if case == "sections_short":
        assert [g.shape for g in got[:2]] == [(2, 2), (2, 4)]


SQUEEZES = {
    "one_axis": ("squeeze", [1], (3, 1, 4)),
    "all_ones": ("squeeze", [], (1, 3, 1, 2)),
    "negative_axis": ("squeeze2", [-1], (3, 4, 1)),
    "not_one_stays": ("squeeze", [0, 1], (3, 1, 4)),
}


@pytest.mark.parametrize("case", list(SQUEEZES))
def test_squeeze_matches_jax(case):
    op_type, axes, shape = SQUEEZES[case]
    _case({"x": _rand(3, shape)}, op_type, {"X": ["x"]}, {"Out": 1},
          {"axes": axes})


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_flatten_matches_jax(axis):
    _case({"x": _rand(4, (2, 3, 4))}, "flatten", {"X": ["x"]}, {"Out": 1},
          {"axis": axis})


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_stack_matches_jax(axis):
    feeds = {"x%d" % i: _rand(10 + i, (2, 3)) for i in range(3)}
    _case(feeds, "stack", {"X": list(feeds)}, {"Y": 1}, {"axis": axis})


@pytest.mark.parametrize("axis", [0, 1])
def test_unstack_matches_jax(axis):
    x = _rand(5, (3, 2, 4))
    _case({"x": x}, "unstack", {"X": ["x"]}, {"Y": x.shape[axis]},
          {"axis": axis})


def test_shape_matches_jax():
    got, _ = _case({"x": _rand(6, (2, 3, 4))}, "shape", {"Input": ["x"]},
                   {"Out": 1}, dtypes={"Out": "int32"}, grad=False)
    assert got[0].dtype == np.int32 and got[0].tolist() == [2, 3, 4]


#: scatter cases: ids into 6 rows
SCATTERS = {
    "unique": [4, 0, 2],
    "repeated_last_wins": [1, 1, 4, 1],
    "negative_wraps": [-1, 2, -6],
    "out_of_range_dropped": [1, 9, -2, -9, 6],
}


@pytest.mark.parametrize("case", list(SCATTERS))
def test_scatter_matches_jax(case):
    ids = np.array(SCATTERS[case], "int32")
    x = _rand(7, (6, 3))
    upd = _rand(8, (len(ids), 3), 5.0, 9.0)
    got, _ = _case({"x": x, "ids": ids, "upd": upd}, "scatter",
                   {"X": ["x"], "Ids": ["ids"], "Updates": ["upd"]},
                   {"Out": 1})
    if case == "repeated_last_wins":
        np.testing.assert_array_equal(got[0][1], upd[3])
        # only the winning update of row 1 gets a gradient
        assert not got[2][:2].any() and got[2][3].all()
    if case == "out_of_range_dropped":
        np.testing.assert_array_equal(got[0][[0, 2, 3, 5]], x[[0, 2, 3, 5]])


def test_pad_matches_jax():
    _case({"x": _rand(9, (2, 3))}, "pad", {"X": ["x"]}, {"Out": 1},
          {"paddings": [1, 0, 0, 2], "pad_value": 0.5})


@pytest.mark.parametrize("mode", ["constant", "reflect", "edge"])
def test_pad2d_matches_jax(mode):
    _case({"x": _rand(10, (2, 2, 4, 5))}, "pad2d", {"X": ["x"]}, {"Out": 1},
          {"paddings": [1, 2, 3, 0], "mode": mode, "pad_value": -1.0})


def test_pad_constant_like_matches_jax():
    _case({"x": _rand(11, (4, 5)), "y": _rand(12, (2, 3))},
          "pad_constant_like", {"X": ["x"], "Y": ["y"]}, {"Out": 1},
          {"pad_value": 1.5}, wrt=["y"])


@pytest.mark.parametrize("by", ["attr", "input"])
def test_crop_matches_jax(by):
    feeds = {"x": _rand(13, (4, 6))}
    attrs = {"offsets": [1, 2]}
    inputs = {"X": ["x"]}
    if by == "attr":
        attrs["shape"] = [2, 3]
    else:
        feeds["y"] = _rand(14, (2, 3))
        inputs["Y"] = ["y"]
    _case(feeds, "crop", inputs, {"Out": 1}, attrs, wrt=["x"])


@pytest.mark.parametrize("axis", [[0], [0, 2], 1])
def test_reverse_matches_jax(axis):
    _case({"x": _rand(15, (2, 3, 4))}, "reverse", {"X": ["x"]}, {"Out": 1},
          {"axis": axis})


MULTIPLEX = {
    "in_range": [[2], [0], [1], [2]],
    "negative_and_past_the_end": [[-1], [5], [-5], [1]],
}


@pytest.mark.parametrize("case", list(MULTIPLEX))
def test_multiplex_matches_jax(case):
    feeds = {"x%d" % i: _rand(20 + i, (4, 5)) for i in range(3)}
    feeds["ids"] = np.array(MULTIPLEX[case], "int32")
    got, _ = _case(feeds, "multiplex", {"X": ["x0", "x1", "x2"], "Ids": ["ids"]},
                   {"Out": 1})
    if case == "negative_and_past_the_end":   # -1 -> 2, 5 -> 2, -5 -> 0
        np.testing.assert_array_equal(got[0][:3], np.stack(
            [feeds["x2"][0], feeds["x2"][1], feeds["x0"][2]]))


TIED = np.array([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, -1.0, 2.0],
                 [5.0, 4.0, 5.0, 4.0]], "float32")


@pytest.mark.parametrize("op_type,axis", [("arg_max", 0), ("arg_max", 1),
                                          ("arg_min", 0), ("arg_min", -1)])
def test_arg_max_min_match_jax(op_type, axis):
    got, _ = _case({"x": TIED}, op_type, {"X": ["x"]}, {"Out": 1},
                   {"axis": axis}, dtypes={"Out": "int64"}, grad=False)
    assert got[0].dtype == np.int64   # ties: the first index
    fn = np.argmax if op_type == "arg_max" else np.argmin
    np.testing.assert_array_equal(got[0], fn(TIED, axis=axis))


ARGSORTS = {
    "ties_stable": (np.array([[1, 0, 1, 0]], "float32"), -1),
    "float_ties_axis0": (TIED, 0),
    "random": (_rand(16, (3, 5)), 1),
    "int32": (np.array([[3, 1, 3, -2, 1]], "int32"), -1),
}


@pytest.mark.parametrize("case", list(ARGSORTS))
def test_argsort_matches_jax(case):
    x, axis = ARGSORTS[case]
    got, _ = _case({"x": x}, "argsort", {"X": ["x"]},
                   {"Out": 1, "Indices": 1}, {"axis": axis},
                   dtypes={"Indices": "int64"})
    np.testing.assert_array_equal(got[1], np.argsort(x, axis=axis, kind="stable"))
    if case == "ties_stable":
        assert got[1].tolist() == [[1, 3, 0, 2]]


@pytest.mark.parametrize("op_type", ["has_inf", "has_nan", "isfinite"])
@pytest.mark.parametrize("fill", [None, np.inf, -np.inf, np.nan])
def test_inf_nan_checks_match_jax(op_type, fill):
    x = _rand(17, (3, 4))
    if fill is not None:
        x[1, 2] = fill
    got, _ = _case({"x": x}, op_type, {"X": ["x"]}, {"Out": 1},
                   dtypes={"Out": "bool"}, grad=False)
    assert got[0].shape == (1,) and got[0].dtype == np.bool_


@pytest.mark.parametrize("op_type", ["sum", "sums"])
def test_sum_matches_jax(op_type):
    feeds = {"x%d" % i: _rand(30 + i, (3, 4)) for i in range(3)}
    _case(feeds, op_type, {"X": list(feeds)}, {"Out": 1})


@pytest.mark.parametrize("step", [0.0, 2.0, 3.0, 4.5, 9.0, 10.0, 11.0])
def test_piecewise_decay_matches_jax(step):
    got, _ = _case({"step": np.array([step], "float32")}, "piecewise_decay",
                   {"Step": ["step"]}, {"Out": 1},
                   {"boundaries": [3.0, 10.0], "values": [0.1, 0.01, 0.001]},
                   grad=False)
    want = 0.1 if step < 3 else 0.01 if step < 10 else 0.001
    assert got[0].dtype == np.float32 and got[0][0] == np.float32(want)


def test_print_prints_message_and_values(capsys):
    x = np.array([[1.5, -2.0], [3.25, 0.0]], "float32")
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        xv = tfluid.layers.data(name="x", shape=[2, 2], dtype="float32",
                                append_batch_size=False, stop_gradient=False)
        out = tfluid.layers.Print(xv, message="the x")
        loss = tfluid.layers.mean(out)
        (grad,) = tfluid.backward.calc_gradient(loss, [xv])
    assert "Print" in tfluid.layers.__all__
    exe = tfluid.Executor(tfluid.CPUPlace())
    for _ in range(2):
        got, g = exe.run(main, feed={"x": x}, fetch_list=[out, grad],
                         scope=tfluid.Scope())
    text = capsys.readouterr().out
    assert text.count("the x ") == 2, text
    assert str(x) in text
    np.testing.assert_array_equal(got, x)
    np.testing.assert_array_equal(g, np.full_like(x, 0.25))
    assert not exe._bound   # the print reads back: never bound


# ---------------------------------------------------------------------------
# random ops: the port's generators, held to their distributions
# ---------------------------------------------------------------------------


def _rng_program(seed=0):
    """A Program holding the four random ops of this file, and its
    fetches."""
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = 3
    with tfluid.program_guard(main, startup):
        ref = tfluid.layers.data(name="ref", shape=[3], dtype="float32")
        probs = tfluid.layers.data(name="p", shape=[5], dtype="float32")
        img = tfluid.layers.data(name="img", shape=[3, 8, 8], dtype="float32")
        helper = tfluid.layer_helper.LayerHelper("truncated_gaussian_random")
        tg = helper.create_variable_for_type_inference(dtype="float32")
        helper.append_op(type="truncated_gaussian_random", outputs={"Out": [tg]},
                         attrs={"shape": [100_000], "mean": 0.5, "std": 2.0,
                                "dtype": "float32", "seed": seed})
        uni = tfluid.layers.uniform_random_batch_size_like(
            ref, shape=[-1, 20_000], min=-2.0, max=3.0)
        ids = tfluid.layers.sampling_id(probs)
        crop = tfluid.layers.random_crop(img, shape=[5, 6])
    return main, [tg, uni, ids, crop]


def _rng_feed(rows=20_000):
    p = np.tile(np.array([0.1, 0.2, 0.3, 0.4, 0.0], "float32"), (rows, 1))
    img = np.arange(4 * 3 * 8 * 8, dtype="float32").reshape(4, 3, 8, 8)
    return {"ref": np.zeros((7, 3), "float32"), "p": p, "img": img}


def test_random_ops_distributions():
    main, fetch = _rng_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    feed = _rng_feed()
    starts = set()
    for step in range(60):
        tg, uni, ids, crop = exe.run(main, feed=feed, fetch_list=fetch,
                                     scope=scope)
        # one crop for the whole batch, at starts inside [0, 3] x [0, 2]
        img = feed["img"]
        found = [(a, b) for a in range(4) for b in range(3)
                 if np.array_equal(crop, img[:, :, a:a + 5, b:b + 6])]
        assert crop.shape == (4, 3, 5, 6) and len(found) == 1
        starts.add(found[0])
        if step:
            continue
        # truncated normal: inside mean +- 2 std, its mean and variance
        n, mean, std = tg.size, 0.5, 2.0
        assert tg.dtype == np.float32 and tg.shape == (n,)
        assert tg.min() > mean - 2 * std and tg.max() < mean + 2 * std
        var1 = 1 - 4 * math.exp(-2) / math.sqrt(2 * math.pi) / math.erf(2 / math.sqrt(2))
        assert abs(tg.mean() - mean) < 5 * std * math.sqrt(var1 / n)
        assert abs(tg.var() / std ** 2 - var1) < 5 * math.sqrt(2 / n)
        # uniform [min, max), the batch from the input
        lo, hi = -2.0, 3.0
        assert uni.shape == (7, 20_000) and uni.dtype == np.float32
        assert uni.min() >= lo and uni.max() < hi
        var_u = (hi - lo) ** 2 / 12
        assert abs(uni.mean() - (lo + hi) / 2) < 5 * math.sqrt(var_u / uni.size)
        assert abs(uni.var() - var_u) < 5 * math.sqrt(0.8 * var_u ** 2 / uni.size)
        # sampling_id: each id's frequency within 5 standard errors, never
        # the id of probability 0
        assert ids.dtype == np.int64 and ids.shape == (20_000,)
        freq = np.bincount(ids, minlength=5) / ids.size
        p = feed["p"][0]
        assert freq[4] == 0
        assert (np.abs(freq - p) < 5 * np.sqrt(p * (1 - p) / ids.size) + 1e-12).all()
    # every start of each axis drawn over 60 steps
    assert {a for a, _ in starts} == set(range(4))
    assert {b for _, b in starts} == set(range(3))


def test_random_ops_fast_path_bitwise_op_by_op():
    """Three steps of the four random ops through the fast path (the
    first eager, then the bound entry) against the same three steps op by
    op: the same bits, and a new draw each step."""
    feed = _rng_feed(rows=64)
    runs = []
    for cache in (True, False):
        main, fetch = _rng_program()
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = tfluid.Scope()
        runs.append([[np.asarray(v) for v in exe.run(
            main, feed=feed, fetch_list=fetch, scope=scope,
            use_program_cache=cache)] for _ in range(3)])
        assert bool(exe._bound) is cache
    for fast, slow in zip(*runs):
        for a, b in zip(fast, slow):
            assert a.tobytes() == b.tobytes()
    assert runs[0][0][0].tobytes() != runs[0][1][0].tobytes()


def test_every_tensor_ops_name_has_a_port_rule():
    import paddle_tpu.ops  # noqa: F401
    import paddle_tpu_torch.ops  # noqa: F401
    from paddle_tpu import registry as jreg
    from paddle_tpu_torch import registry as treg

    names = {n for n, f in jreg.RULES.items()
             if f.__module__ == "paddle_tpu.ops.tensor_ops"}
    assert len(names) == 52
    assert not names - set(treg.RULES)
    assert len(set(jreg.RULES) & set(treg.RULES)) == 221
