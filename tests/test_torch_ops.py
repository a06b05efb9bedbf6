"""Op rules of the port against the JAX package's on the CPU.

Where an index can fall outside its axis: ``softmax_with_cross_entropy``
with hard labels, ``one_hot`` and ``lookup_table``.  Each case builds the
same one-op Program with each package's layers, runs both Executors on
the same seeded numpy feed, and compares the outputs exactly, NaNs in the
same places.  The loss cases feed logits whose log-softmax is exact in
float32 (each row a permutation of 0, -100, -200, ...: the max is 0 and
the exp-sum rounds to 1), so every finite loss is 100 times the class
the rule picked; with general logits XLA's and torch's log-softmax
differ in the last bit, and those feeds are held to 1e-6 relative, NaN
and zero positions still exact.

The JAX package's rules gather with ``jnp.take_along_axis`` /
``jnp.take`` (an index in [-n, 0) wraps, one outside [-n, n) reads NaN)
and one-hot with ``jax.nn.one_hot`` (an id outside [0, depth) gives a
row of zeros).

The core IR's rules (conv2d, depthwise_conv2d, pool2d, cross_entropy,
mean, top_k, accuracy) the same way (mean of an integer input and a
float cast to an integer type, ROADMAP F-8 and F-9, exactly), with the JAX startup's parameters
copied into the port: float outputs and the gradients that
``calc_gradient`` gives within 1e-5 (XLA and torch sum in different
orders), integer outputs exact.  ``gaussian_random`` draws from the
port's own generator, so it is held to its distribution instead.
"""
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


def _pair(build, feed, n_fetch=1, edit=None):
    """Build ``build(fl)`` (a list of fetch targets) with each package,
    copy the JAX startup's persistables into the port, run both mains on
    ``feed`` and return (jax fetches, port fetches) as numpy lists.
    ``feed`` may be a callable ``feed(fl)``, for feeds of each package's
    own types (a ragged feed is its ``lod.LoDArray``).
    ``edit(main)`` may change each main Program before it runs."""
    outs = []
    state = None
    for fl in (jfluid, tfluid):
        main, startup = fl.Program(), fl.Program()
        with fl.unique_name.guard(), fl.program_guard(main, startup):
            fetch = build(fl)
        if edit is not None:
            edit(main)
        scope = fl.Scope()
        with fl.scope_guard(scope):
            exe = fl.Executor(fl.CPUPlace())
            exe.run(startup)
            if state is None:
                state = {n: np.asarray(scope[n])
                         for n in main.persistable_names() if n in scope}
            else:
                fl.load_numpy_state(main, state, scope=scope, device="cpu")
            fed = feed(fl) if callable(feed) else feed
            outs.append([np.asarray(o) for o in
                         exe.run(main, feed=fed, fetch_list=fetch)])
    return outs


def _close(got, want, tol=1e-5):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


#: conv2d cases: (C, num_filters, filter, stride, padding, dilation, groups)
CONV_CASES = {
    "plain": (3, 4, 3, 1, 0, 1, 1),
    "stride_padding": (3, 4, 3, 2, 1, 1, 1),
    "dilation": (3, 5, 3, 1, 2, 2, 1),
    "rect": (3, 4, [3, 2], [2, 1], [1, 0], 1, 1),
    "groups": (4, 6, 3, 1, 1, 1, 2),
    "depthwise": (4, 8, 3, 1, 1, 1, 4),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv2d_matches_jax(case):
    C, nf, fs, st, pad, dil, groups = CONV_CASES[case]
    x = np.random.RandomState(6).randn(2, C, 9, 8).astype("float32")

    def build(fl):
        xv = fl.layers.data(name="x", shape=[C, 9, 8], dtype="float32",
                            stop_gradient=False)
        y = fl.layers.conv2d(xv, num_filters=nf, filter_size=fs, stride=st,
                             padding=pad, dilation=dil, groups=groups,
                             bias_attr=False)
        loss = fl.layers.mean(fl.layers.square(y))
        w = fl.default_main_program().global_block().all_parameters()[0]
        return [y] + fl.backward.calc_gradient(loss, [xv, w])

    def depthwise(main):
        # the layer builds conv2d; the depthwise rule takes its groups
        # from the input's channels, whatever the attr says
        (op,) = [o for o in main.global_block().ops if o.type == "conv2d"]
        op.type = "depthwise_conv2d"
        op.attrs["groups"] = 1

    want, got = _pair(build, {"x": x},
                      edit=depthwise if case == "depthwise" else None)
    for g, w in zip(got, want):
        _close(g, w)


#: pool2d cases: (type, ksize, stride, padding, ceil_mode, exclusive,
#: global, H/W of the input)
POOL_CASES = {
    "max": ("max", 2, 2, 0, False, True, False, 8),
    "max_padded": ("max", 3, 2, 1, False, True, False, 7),
    "max_ceil": ("max", 3, 2, 0, True, True, False, 8),
    # the last window starts in the right padding: the reference keeps it
    # (-inf for max, 0/0 for the exclusive average); torch's ceil_mode
    # would drop it
    "max_ceil_window_in_padding": ("max", 2, 2, 1, True, True, False, 5),
    "avg": ("avg", 2, 2, 0, False, True, False, 8),
    "avg_padded_exclusive": ("avg", 3, 1, 1, False, True, False, 7),
    "avg_padded_inclusive": ("avg", 3, 1, 1, False, False, False, 7),
    "avg_ceil": ("avg", 3, 2, 0, True, True, False, 8),
    "avg_ceil_window_in_padding": ("avg", 2, 2, 1, True, True, False, 5),
    "global_max": ("max", 2, 1, 0, False, True, True, 7),
    "global_avg": ("avg", 2, 1, 0, False, True, True, 7),
}


@pytest.mark.parametrize("case", list(POOL_CASES))
def test_pool2d_matches_jax(case):
    ptype, k, st, pad, ceil, excl, glob, hw = POOL_CASES[case]
    x = np.random.RandomState(7).randn(2, 3, hw, hw).astype("float32")

    def build(fl):
        xv = fl.layers.data(name="x", shape=[3, hw, hw], dtype="float32",
                            stop_gradient=False)
        y = fl.layers.pool2d(xv, pool_size=k, pool_type=ptype, pool_stride=st,
                             pool_padding=pad, global_pooling=glob,
                             ceil_mode=ceil, exclusive=excl)
        fetch = [y]
        if "in_padding" not in case:  # -inf / NaN windows: no gradient
            fetch += fl.backward.calc_gradient(fl.layers.mean(y), [xv])
        return fetch

    want, got = _pair(build, {"x": x})
    for g, w in zip(got, want):
        _close(g, w)
    if "in_padding" in case:
        edge = got[0][..., -1, :]
        assert (np.isneginf(edge) if ptype == "max" else np.isnan(edge)).all()


def _probs(seed, rows, c):
    z = np.random.RandomState(seed).randn(rows, c).astype("float64") * 2
    p = np.exp(z - z.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)).astype("float32")


#: cross_entropy cases: (soft labels, label range [lo, hi), ignore_index
#: or None for the default -100, rows forced to the ignore index, with
#: probabilities at the clip's bounds, gradient checked)
CE_CASES = {
    "soft": (True, None, None, False, False, True),
    "hard": (False, (0, N_CLASSES), None, False, False, True),
    "hard_at_the_clip": (False, (0, N_CLASSES), None, False, True, True),
    "soft_at_the_clip": (True, None, None, False, True, True),
    "default_ignore": (False, (0, N_CLASSES), None, True, False, True),
    "custom_ignore": (False, (0, N_CLASSES), 2, True, False, True),
    "out_of_range": (False, (-2 * N_CLASSES, 2 * N_CLASSES), None, False,
                     False, False),
    "out_of_range_ignore": (False, (-2 * N_CLASSES, 2 * N_CLASSES), 30, True,
                            False, False),
}


@pytest.mark.parametrize("case", list(CE_CASES))
def test_cross_entropy_matches_jax(case):
    soft, rng_lab, ignore, force, at_clip, grad = CE_CASES[case]
    x = _probs(8, ROWS, N_CLASSES)
    if at_clip:
        # exact 1.0 and 0.0 (the top clip is hit exactly; 0 and 1e-30 are
        # raised to 1e-20), as a saturated softmax gives them
        x[0] = 0.0
        x[0, 1] = 1.0
        x[1, :3] = [1e-30, 0.0, 1e-20]
        x[2] = 0.0
        x[2, 0] = 1.0
    if soft:
        label = _probs(9, ROWS, N_CLASSES)
    else:
        label = _ids(10, *rng_lab)
        if at_clip:
            label[:3, 0] = [1, 1, 3]   # picks 1.0, 1e-30 and 0.0
        if force:
            label[::3] = -100 if ignore is None else ignore
    kw = {} if ignore is None else {"ignore_index": ignore}

    def build(fl):
        xv = fl.layers.data(name="x", shape=[N_CLASSES], dtype="float32",
                            stop_gradient=False)
        if soft:
            yv = fl.layers.data(name="y", shape=[N_CLASSES], dtype="float32")
        else:
            yv = fl.layers.data(name="y", shape=[1], dtype="int64")
        loss = fl.layers.cross_entropy(xv, yv, soft_label=soft, **kw)
        fetch = [loss]
        if grad:
            fetch += fl.backward.calc_gradient(fl.layers.mean(loss), [xv])
        return fetch

    want, got = _pair(build, {"x": x, "y": label})
    _assert_same(np.isnan(got[0]), np.isnan(want[0]))
    for g, w in zip(got, want):
        _close(g, w)
    if case.startswith("out_of_range"):
        assert np.isnan(got[0]).any() and np.isfinite(got[0]).any()
    if force:
        assert (got[0][::3] == 0).all()
    if at_clip and not soft:
        assert got[0][0, 0] == 0.0 and got[0].max() > 40   # -log(1e-20)


def test_mean_matches_jax():
    x = np.random.RandomState(11).randn(6, 5).astype("float32")

    def build(fl):
        xv = fl.layers.data(name="x", shape=[5], dtype="float32",
                            stop_gradient=False)
        y = fl.layers.mean(xv)
        return [y] + fl.backward.calc_gradient(y, [xv])

    want, got = _pair(build, {"x": x})
    assert got[0].shape == (1,)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("shape", [(4, 5), (3, 7), (6, 11), (9, 13)])
@pytest.mark.parametrize("dtype", ["int64", "int32"])
def test_mean_of_integers_matches_jax(dtype, shape):
    """ROADMAP F-8: an integer input is averaged as float32 and gives
    float32, the JAX package's bits exactly (XLA multiplies the float32
    sum by the float32 reciprocal of the count).  [4, 5] is the ROADMAP
    case, -0.9 up to float32's last bit."""
    x = np.random.RandomState(0).randint(-7, 8, size=shape).astype(dtype)

    def build(fl):
        xv = fl.layers.data(name="x", shape=list(shape), dtype=dtype,
                            append_batch_size=False)
        return [fl.layers.mean(xv)]

    (want,), (got,) = _pair(build, {"x": x})
    assert got.dtype == np.float32 and got.shape == (1,)
    assert got.tobytes() == want.tobytes(), (got, want)
    if shape == (4, 5):
        np.testing.assert_allclose(got, [-0.9], rtol=1e-7)


#: ROADMAP F-9: float32 values past every integer range, NaN and +-inf
CAST_IN = [-2.7, -0.5, 0.5, 2.7, 3e9, -3e9, np.nan, np.inf, -np.inf,
           300.0, -300.0, 127.9, -128.9]


@pytest.mark.parametrize("dtype", ["int32", "uint8", "int16", "int8"])
def test_cast_float_to_int_saturates_as_jax(dtype):
    x = np.array(CAST_IN, np.float32)

    def build(fl):
        xv = fl.layers.data(name="x", shape=[len(CAST_IN)], dtype="float32",
                            append_batch_size=False)
        return [fl.layers.cast(xv, dtype)]

    (want,), (got,) = _pair(build, {"x": x})
    _assert_same(got, want)
    if dtype == "int32":   # the ROADMAP case
        assert got[:8].tolist() == [-2, 0, 0, 2, 2147483647, -2147483648, 0,
                                    2147483647]
    if dtype == "uint8":
        assert got[:8].tolist() == [0, 0, 0, 2, 255, 0, 0, 255]


def test_cast_float_to_int64_saturates():
    """int64 (the JAX package, x64 off, gives int32 here): NaN to 0, each
    value past int64's range to its nearest end, the rest truncated."""
    x = np.array(CAST_IN + [1e19, -1e19, 2.0 ** 62], np.float32)

    def build(fl):
        xv = fl.layers.data(name="x", shape=[len(x)], dtype="float32",
                            append_batch_size=False)
        return [fl.layers.cast(xv, "int64")]

    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        (out,) = build(tfluid)
    (got,) = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed={"x": x}, fetch_list=[out], scope=tfluid.Scope())
    top, bottom = np.iinfo(np.int64).max, np.iinfo(np.int64).min
    assert got.dtype == np.int64
    assert got.tolist() == [-2, 0, 0, 2, 3000000000, -3000000000, 0, top,
                            bottom, 300, -300, 127, -128, top, bottom,
                            2 ** 62]


@pytest.mark.parametrize("k", [1, 3])
def test_top_k_and_accuracy_match_jax(k):
    rng = np.random.RandomState(12)
    # values from a small set, so rows hold ties: equal values come out in
    # index order (jax.lax.top_k's order)
    x = rng.randint(0, 4, size=(ROWS, N_CLASSES)).astype("float32")
    label = _ids(13, 0, N_CLASSES)

    def build(fl):
        xv = fl.layers.data(name="x", shape=[N_CLASSES], dtype="float32")
        yv = fl.layers.data(name="y", shape=[1], dtype="int64")
        vals, idx = fl.layers.topk(xv, k=k)
        correct = fl.layers.create_tensor(dtype="int32")
        total = fl.layers.create_tensor(dtype="int32")
        acc = fl.layers.accuracy(xv, yv, k=k, correct=correct, total=total)
        return [vals, idx, acc, correct, total]

    want, got = _pair(build, {"x": x, "y": label})
    vals, idx, acc, correct, total = got
    _assert_same(vals, want[0])
    assert idx.dtype == np.int64
    np.testing.assert_array_equal(idx, want[1])
    order = np.argsort(-x, axis=-1, kind="stable")[:, :k]
    np.testing.assert_array_equal(idx, order)
    _assert_same(acc, want[2])
    assert correct.dtype == total.dtype == np.int32
    np.testing.assert_array_equal(correct, want[3])
    np.testing.assert_array_equal(total, [ROWS])
    assert acc[0] == np.float32(correct[0] / ROWS)


def test_gaussian_random_distribution():
    """10^5 draws: the sample mean within 5 standard errors (std/sqrt(n))
    of ``mean`` and the sample std within 5 of its own (std/sqrt(2n));
    the batch-size-like op takes its batch from its input."""
    n, mean, std = 100_000, 0.5, 2.0
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = 4
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[3], dtype="float32")
        g = tfluid.layers.gaussian_random([n], mean=mean, std=std)
        like = tfluid.layers.gaussian_random_batch_size_like(
            x, shape=[-1, 4], mean=mean, std=std)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    out, lk = exe.run(main, feed={"x": np.zeros((7, 3), "float32")},
                      fetch_list=[g, like], scope=scope)
    assert out.shape == (n,) and out.dtype == np.float32
    assert abs(out.mean() - mean) < 5 * std / np.sqrt(n)
    assert abs(out.std() - std) < 5 * std / np.sqrt(2 * n)
    assert lk.shape == (7, 4)
    again = exe.run(main, feed={"x": np.zeros((7, 3), "float32")},
                    fetch_list=[g], scope=scope)[0]
    assert again.tobytes() != out.tobytes()   # the next run draws anew


#: F-12 (ROADMAP §C): reduce_sum of an integer or bool feed, dim 0.
#: (feed dtype, feed, the port's output dtype).  The JAX package sums in
#: its int32 (x64 off); the port sums int32 and int64 in their own type
#: and bool in int64, the values the JAX package's exactly.
REDUCE_SUM_CASES = {
    "int32_wraps": ("int32", np.full((4, 5), 2 ** 30, "int32"), "int32"),
    "int64": ("int64", np.random.RandomState(8).randint(
        -1000, 1000, size=(4, 5)).astype("int64"), "int64"),
    "bool": ("bool", np.random.RandomState(9).rand(4, 5) > 0.5, "int64"),
}


@pytest.mark.parametrize("case", list(REDUCE_SUM_CASES))
def test_reduce_sum_of_integers_matches_jax(case):
    dtype, x, port_dtype = REDUCE_SUM_CASES[case]

    def build(fl):
        v = fl.layers.data(name="x", shape=[5], dtype=dtype)
        return fl.layers.reduce_sum(v, dim=0)

    want = _run(jfluid, build, {"x": x}, jfluid.Scope())
    got = _run(tfluid, build, {"x": x}, tfluid.Scope())
    assert got.dtype == np.dtype(port_dtype)
    np.testing.assert_array_equal(got, want)
    if case == "int32_wraps":
        _assert_same(got, want)
        np.testing.assert_array_equal(got, np.zeros(5, "int32"))


@pytest.mark.parametrize("declared,fp16", [("float32", False),
                                           ("float32", True),
                                           ("int32", False)])
def test_load_matches_jax(tmp_path, declared, fp16):
    """``layers.load`` of an ``io.save_vars``-style ``.npy`` (float64 on
    disk): cast to the declared dtype, float16 with ``load_as_fp16``,
    exactly the JAX package's values; a Program that holds a ``load``
    reads the file at every run and is never bound."""
    w = np.random.RandomState(12).randn(2, 3) * 100
    path = str(tmp_path / "w")
    np.save(path + ".npy", w)

    def build(fl):
        out = fl.layers.create_tensor(dtype=declared, name="loaded_w")
        fl.layers.load(out, path, load_as_fp16=fp16)
        return out

    want = _run(jfluid, build, {}, jfluid.Scope())
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        out = build(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    got = [np.asarray(exe.run(main, fetch_list=[out], scope=scope)[0])
           for _ in range(2)]
    _assert_same(got[0], want)
    assert got[0].dtype == np.dtype("float16" if fp16 else declared)
    np.save(path + ".npy", w + 1)   # the next run reads the file again
    again = np.asarray(exe.run(main, fetch_list=[out], scope=scope)[0])
    _assert_same(again, (w + 1).astype(got[0].dtype))
    assert got[1].tobytes() == got[0].tobytes() and not exe._bound


def test_memory_optimize_returns_its_input(capsys):
    main = tfluid.Program()
    assert tfluid.memory_optimize(main) is main
    assert tfluid.transpiler.memory_optimize(main, print_log=True) is main
    assert "caching allocator" in capsys.readouterr().out
    assert tfluid.release_memory(main, skip_opt_set={"x"}) is main
