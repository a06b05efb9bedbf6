"""Op rules of the port against the JAX package's where an index can fall
outside its axis, on the CPU: ``softmax_with_cross_entropy`` with hard
labels, ``one_hot`` and ``lookup_table``.  Each case builds the same
one-op Program with each package's layers, runs both Executors on the
same seeded numpy feed, and compares the outputs exactly, NaNs in the
same places.  The loss cases feed logits whose log-softmax is exact in
float32 (each row a permutation of 0, -100, -200, ...: the max is 0 and
the exp-sum rounds to 1), so every finite loss is 100 times the class
the rule picked; with general logits XLA's and torch's log-softmax
differ in the last bit, and those feeds are held to 1e-6 relative, NaN
and zero positions still exact.

The JAX package's rules gather with ``jnp.take_along_axis`` /
``jnp.take`` (an index in [-n, 0) wraps, one outside [-n, n) reads NaN)
and one-hot with ``jax.nn.one_hot`` (an id outside [0, depth) gives a
row of zeros)."""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid

N_CLASSES = 7   # softmax_with_cross_entropy's C, one_hot's depth
VOCAB = 9       # lookup_table's V
WIDTH = 5       # lookup_table's D
ROWS = 12


def _run(fl, build, feed, scope, params=None):
    """Run the one-op Program ``build(fl)`` makes, under ``scope``, and
    return its one fetch as numpy."""
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        out = build(fl)
    with fl.scope_guard(scope):
        exe = fl.Executor(fl.CPUPlace())
        exe.run(startup)
        if params is not None:
            params(main, scope)
        (got,) = exe.run(main, feed=feed, fetch_list=[out])
    return np.asarray(got)


def _ids(seed, lo, hi, shape=(ROWS, 1)):
    return np.random.RandomState(seed).randint(lo, hi, size=shape).astype(
        "int64")


def _assert_same(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


#: hard-label cases: (label range [lo, hi), ignore_index or None for the
#: layer's default -100, labels forced to the ignore index)
LOSS_CASES = {
    "in_range": (0, N_CLASSES, None, False),
    "negative_wraps": (-N_CLASSES, 0, None, False),
    "past_the_end": (-3 * N_CLASSES, 3 * N_CLASSES, None, False),
    "default_ignore": (-2 * N_CLASSES, 2 * N_CLASSES, None, True),
    "custom_ignore_in_range": (-2 * N_CLASSES, 2 * N_CLASSES, 3, True),
    "custom_ignore_past_the_end": (-2 * N_CLASSES, 2 * N_CLASSES, 40, True),
    "custom_ignore_negative": (-2 * N_CLASSES, 2 * N_CLASSES, -2, True),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_softmax_with_cross_entropy_hard_labels_match_jax(case):
    lo, hi, ignore, force = LOSS_CASES[case]
    label = _ids(1, lo, hi)
    if force:
        label[::3] = -100 if ignore is None else ignore
    rng = np.random.RandomState(2)
    exact = np.stack([-100.0 * rng.permutation(N_CLASSES)
                      for _ in range(ROWS)]).astype("float32")
    general = rng.randn(ROWS, N_CLASSES).astype("float32")
    kw = {} if ignore is None else {"ignore_index": ignore}

    def build(fl):
        x = fl.layers.data(name="x", shape=[N_CLASSES], dtype="float32")
        y = fl.layers.data(name="y", shape=[1], dtype="int64")
        return fl.layers.softmax_with_cross_entropy(x, y, **kw)

    feed = {"x": exact, "y": label}
    want = _run(jfluid, build, feed, jfluid.Scope())
    got = _run(tfluid, build, feed, tfluid.Scope())
    _assert_same(got, want)
    feed = {"x": general, "y": label}
    want_g = _run(jfluid, build, feed, jfluid.Scope())
    got_g = _run(tfluid, build, feed, tfluid.Scope())
    _assert_same(np.isnan(got_g), np.isnan(want_g))
    _assert_same(got_g == 0, want_g == 0)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-6, atol=0)
    if case == "past_the_end":
        assert np.isnan(got).any() and np.isfinite(got).any()
    if force:
        assert (got[::3] == 0).all()


ONE_HOT_CASES = {
    "in_range": (0, N_CLASSES),
    "negative": (-N_CLASSES - 3, 0),
    "past_the_end": (-2 * N_CLASSES, 3 * N_CLASSES),
}


@pytest.mark.parametrize("case", list(ONE_HOT_CASES))
def test_one_hot_matches_jax(case):
    ids = _ids(3, *ONE_HOT_CASES[case])

    def build(fl):
        x = fl.layers.data(name="x", shape=[1], dtype="int64")
        return fl.layers.one_hot(x, N_CLASSES)

    feed = {"x": ids}
    want = _run(jfluid, build, feed, jfluid.Scope())
    got = _run(tfluid, build, feed, tfluid.Scope())
    _assert_same(got, want)
    if case != "in_range":
        assert (got.sum(-1) == 0).any()


#: lookup cases: (id range [lo, hi), padding_idx passed to the layer)
LOOKUP_CASES = {
    "in_range": (0, VOCAB, None),
    "negative_wraps": (-VOCAB, 0, None),
    "past_the_end": (-3 * VOCAB, 3 * VOCAB, None),
    "padding_idx": (0, VOCAB, 2),
    "padding_idx_negative": (-VOCAB, VOCAB, -1),
    "padding_idx_with_past_the_end": (-3 * VOCAB, 3 * VOCAB, 4),
}


@pytest.mark.parametrize("case", list(LOOKUP_CASES))
def test_lookup_table_matches_jax(case):
    lo, hi, padding_idx = LOOKUP_CASES[case]
    ids = _ids(4, lo, hi)
    if padding_idx is not None:
        ids[::4] = padding_idx % VOCAB
    w = np.random.RandomState(5).randn(VOCAB, WIDTH).astype("float32")

    def build(fl):
        x = fl.layers.data(name="x", shape=[1], dtype="int64")
        return fl.layers.embedding(
            x, size=[VOCAB, WIDTH], padding_idx=padding_idx,
            param_attr=fl.ParamAttr(name="emb_w"))

    def set_w(main, scope):
        if scope.__class__ is jfluid.Scope:
            import jax.numpy as jnp
            scope["emb_w"] = jnp.asarray(w)
        else:
            tfluid.load_numpy_state(main, {"emb_w": w}, scope=scope,
                                    device="cpu")

    feed = {"x": ids}
    want = _run(jfluid, build, feed, jfluid.Scope(), set_w)
    got = _run(tfluid, build, feed, tfluid.Scope(), set_w)
    _assert_same(got, want)
    if case == "past_the_end":
        assert np.isnan(got).any() and np.isfinite(got).any()
    if padding_idx is not None:
        assert (got[::4] == 0).all()
