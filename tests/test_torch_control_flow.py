"""The port's control flow and the rules it brings, against the JAX
package's, on the CPU.

The cases of ``tests/unittests/test_control_flow_op.py`` (all but the
StaticRNN one) and the While, conditional, array-capacity and
serialisation cases of ``tests/unittests/test_control_flow_fixes.py``,
each built by both packages' layer functions (the same ``to_string()``
JSON) and run three ways: the JAX package's Program by the JAX package,
the same Program passed as JSON to the port, and the port's own Program
by the port.  The two port runs give the same bits; against the JAX
package, outputs are equal (integers and bools exactly, the JAX package's
int32 against the port's int64 by value) or, for sums of floats, within
1e-6.  Each case also keeps its reference test's own assertions.

The new rules the same way on seeded numpy feeds: ``cumsum`` with
``exclusive`` and ``reverse``, the compare and logical tables,
``expand``, ``fill_constant_batch_size_like``, ``assign`` with lengths,
and ``gather`` with negative and out-of-range indices (the JAX
package's ``jnp.take``: an index in [-n, 0) wraps, one outside [-n, n)
reads NaN, or the integer minimum, -2**31, as its int64 runs as int32).
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid

FLOAT_SUM_TOL = 1e-6


def _build(fl, build):
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        fetch = build(fl)
    return main, startup, [f if isinstance(f, str) else f.name
                           for f in fetch]


def _run_jax(main, startup, feed, fetch, return_numpy=True):
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jfluid.Scope()):
        exe.run(startup)
        return exe.run(main, feed=feed, fetch_list=fetch,
                       return_numpy=return_numpy)


def _run_port(main, startup, feed, fetch, return_numpy=True):
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    return exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                   return_numpy=return_numpy)


def _values(out):
    return [np.asarray(getattr(o, "data", o)) for o in out]


def _equal(a, b, tol=0.0):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if tol and a.dtype.kind == "f":
        np.testing.assert_allclose(b, a, rtol=tol, atol=tol)
    else:
        np.testing.assert_array_equal(b, a)


def both(build, feeds=(None,), tol=0.0, return_numpy=True):
    """Build ``build(fluid)`` with both packages (the same JSON), then run
    it on each feed of ``feeds``: the JAX package's Program by the JAX
    package, its JSON through the port, and the port's Program by the
    port.  Returns [(jax outputs, port outputs)] a feed."""
    jm, js, jfetch = _build(jfluid, build)
    tm, ts, tfetch = _build(tfluid, build)
    assert jm.to_string() == tm.to_string()
    assert js.to_string() == ts.to_string()
    assert jfetch == tfetch
    pm = tfluid.Program.parse_from_string(jm.to_string())
    ps = tfluid.Program.parse_from_string(js.to_string())
    out = []
    for feed in feeds:
        j = _run_jax(jm, js, feed or {}, jfetch, return_numpy)
        t = _run_port(pm, ps, feed or {}, jfetch, return_numpy)
        own = _run_port(tm, ts, feed or {}, tfetch, return_numpy)
        for a, b in zip(_values(t), _values(own)):
            _equal(a, b)
        for a, b in zip(_values(j), _values(t)):
            _equal(a, b, tol)
        out.append((j, t))
    return out


# ---------------------------------------------------------------------------
# test_control_flow_op.py
# ---------------------------------------------------------------------------


def test_while_accumulates():
    """while i < 10: s += i*i; i += 1  — pure in-graph loop."""

    def build(fl):
        L = fl.layers
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        s = L.fill_constant(shape=[1], dtype="int64", value=0)
        limit = L.fill_constant(shape=[1], dtype="int64", value=10)
        cond = L.less_than(x=i, y=limit)
        w = L.While(cond=cond)
        with w.block():
            sq = L.elementwise_mul(i, i)
            L.assign(L.elementwise_add(s, sq), s)
            L.increment(x=i, value=1, in_place=True)
            L.less_than(x=i, y=limit, cond=cond)
        return [s, i]

    [(_, (s, i))] = both(build)
    assert int(np.ravel(s)[0]) == sum(k * k for k in range(10))
    assert int(np.ravel(i)[0]) == 10
    assert s.dtype == np.int64


def test_ifelse_mask_merge():
    xv = np.array([[1.0], [-2.0], [3.0], [-4.0]], "float32")

    def build(fl):
        L = fl.layers
        x = L.data(name="x", shape=[1], dtype="float32")
        zero = L.fill_constant(shape=[1], dtype="float32", value=0.0)
        cond = L.less_than(x=x, y=zero)
        ie = L.IfElse(cond)
        with ie.true_block():
            xi = ie.input(x)
            ie.output(L.scale(xi, scale=-10.0))
        with ie.false_block():
            xi = ie.input(x)
            ie.output(L.scale(xi, scale=2.0))
        (out,) = ie()
        return [out]

    [(_, (out,))] = both(build, [{"x": xv}])
    want = np.where(xv < 0, -10 * xv, 2 * xv)
    np.testing.assert_allclose(np.asarray(out), want, rtol=1e-6)


def test_switch_selects_first_true_case():
    def build(fl):
        L = fl.layers
        lr = L.create_global_var(shape=[1], value=0.0, dtype="float32",
                                 persistable=True, name="sw_lr")
        step = L.fill_constant(shape=[1], dtype="float32", value=7.0)
        with L.Switch() as switch:
            with switch.case(L.less_than(step, L.fill_constant(shape=[1], dtype="float32", value=5.0))):
                L.assign(L.fill_constant(shape=[1], dtype="float32", value=0.1), lr)
            with switch.case(L.less_than(step, L.fill_constant(shape=[1], dtype="float32", value=10.0))):
                L.assign(L.fill_constant(shape=[1], dtype="float32", value=0.2), lr)
            with switch.default():
                L.assign(L.fill_constant(shape=[1], dtype="float32", value=0.3), lr)
        return [lr]

    [(_, (lr,))] = both(build)
    np.testing.assert_allclose(np.ravel(lr), [0.2], rtol=1e-6)


def test_tensor_array_write_read_length():
    def build(fl):
        L = fl.layers
        arr = L.create_array("float32")
        i0 = L.fill_constant(shape=[1], dtype="int64", value=0)
        i1 = L.fill_constant(shape=[1], dtype="int64", value=1)
        a = L.fill_constant(shape=[2], dtype="float32", value=3.0)
        b = L.fill_constant(shape=[2], dtype="float32", value=5.0)
        L.array_write(a, i0, array=arr)
        L.array_write(b, i1, array=arr)
        n = L.array_length(arr)
        back = L.array_read(array=arr, i=i1)
        return [n, back]

    [(_, (n, back))] = both(build)
    assert int(np.ravel(n)[0]) == 2
    np.testing.assert_allclose(np.asarray(back), [5.0, 5.0], rtol=1e-6)


# ---------------------------------------------------------------------------
# test_control_flow_fixes.py
# ---------------------------------------------------------------------------


def test_conditional_block_array_write_is_applied():
    """An array_write inside a ConditionalBlock mutates the array when
    the predicate is true, and leaves it (zeros) when it is false."""

    def build(fl):
        L = fl.layers
        x = L.data(name="x", shape=[2], dtype="float32")
        flag = L.data(name="flag", shape=[1], dtype="bool")
        arr = L.create_array("float32", capacity=4)
        zero = L.zeros(shape=[1], dtype="int64")
        cond = L.ConditionalBlock([flag])
        with cond.block():
            L.array_write(x, zero, arr)
        got = L.array_read(arr, zero)
        return [got, L.array_length(arr)]

    X = np.array([[3.0, 4.0]], "float32")
    (_, (true_out, n_true)), (_, (false_out, n_false)) = both(
        build, [{"x": X, "flag": np.array([True])},
                {"x": X, "flag": np.array([False])}])
    np.testing.assert_allclose(np.ravel(true_out), [3.0, 4.0])
    np.testing.assert_allclose(np.ravel(false_out), [0.0, 0.0])  # untouched
    assert int(n_true[0]) == 1 and int(n_false[0]) == 0


def test_while_with_nested_conditional_array_write():
    """array_write nested inside a ConditionalBlock inside a While runs
    and accumulates."""

    def build(fl):
        L = fl.layers
        x = L.data(name="x", shape=[2], dtype="float32")
        arr = L.create_array("float32", capacity=8)
        i = L.zeros(shape=[1], dtype="int64")
        limit = L.fill_constant(shape=[1], dtype="int64", value=3)
        cond = L.less_than(x=i, y=limit)
        w = L.While(cond=cond)
        with w.block():
            is_even = L.equal(
                L.elementwise_sub(
                    x=i, y=L.scale(L.scale(i, scale=0.5), scale=2.0)),
                L.zeros(shape=[1], dtype="int64"))
            cb = L.ConditionalBlock([is_even])
            with cb.block():
                L.array_write(x, i, arr)
            L.increment(x=i, value=1, in_place=True)
            L.less_than(x=i, y=limit, cond=cond)
        n = L.array_length(arr)
        return [n, L.array_read(arr, L.fill_constant(shape=[1], dtype="int64", value=2))]

    [(_, (length, row))] = both(build, [{"x": np.ones((1, 2), "float32")}])
    # the last write is at i=2: the array's length reaches 3
    assert int(np.ravel(length)[0]) == 3
    np.testing.assert_array_equal(row, np.ones((1, 2), "float32"))


def test_while_maxlen_raises_array_capacity():
    for fl in (jfluid, tfluid):
        L = fl.layers
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            x = L.data(name="x", shape=[2], dtype="float32")
            arr = L.create_array("float32")  # default capacity
            i = L.zeros(shape=[1], dtype="int64")
            limit = L.fill_constant(shape=[1], dtype="int64", value=2)
            cond = L.less_than(x=i, y=limit)
            w = L.While(cond=cond, maxlen=512)
            with w.block():
                L.array_write(x, i, arr)
                L.increment(x=i, value=1, in_place=True)
                L.less_than(x=i, y=limit, cond=cond)
        assert int(arr.capacity) == 512


def test_array_capacity_survives_serialization_and_keys_cache():
    def capacity_program(fl, capacity):
        main, startup = fl.Program(), fl.Program()
        with fl.unique_name.guard(), fl.program_guard(main, startup):
            arr = fl.layers.create_array("float32", capacity=capacity)
        return main, arr

    main, arr = capacity_program(tfluid, 64)
    clone = tfluid.Program.parse_from_string(main.to_string())
    assert int(getattr(clone.global_block().var(arr.name), "capacity", 0)) == 64
    assert main.to_string() == capacity_program(jfluid, 64)[0].to_string()
    # the fingerprint differs when only the capacity differs
    assert (capacity_program(tfluid, 8)[0].fingerprint()
            != capacity_program(tfluid, 16)[0].fingerprint())


def test_block_create_parameter_duplicate_checks_root():
    """Block.create_parameter from a sub-block sees root-block
    duplicates."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        root = main.global_block()
        root.create_parameter(name="w_dup", shape=[2, 2], dtype="float32")
        sub = main.create_block()
        with pytest.raises(ValueError, match="already exists"):
            sub.create_parameter(name="w_dup", shape=[4, 4], dtype="float32")
        main.rollback()


# ---------------------------------------------------------------------------
# the sub-block semantics the JAX package's lax.while_loop / lax.cond give
# ---------------------------------------------------------------------------


def test_while_that_never_runs_leaves_zero_arrays():
    """A loop whose condition is false at once: its carried values stay,
    and an array it would have written is the zeros buffer of the
    body's shape, length 0."""

    def build(fl):
        L = fl.layers
        x = L.data(name="x", shape=[3], dtype="float32")
        arr = L.create_array("float32", capacity=5)
        i = L.fill_constant(shape=[1], dtype="int64", value=4)
        limit = L.fill_constant(shape=[1], dtype="int64", value=2)
        cond = L.less_than(x=i, y=limit)
        w = L.While(cond=cond)
        with w.block():
            L.array_write(L.scale(x, scale=2.0), i, arr)
            L.increment(x=i, value=1, in_place=True)
            L.less_than(x=i, y=limit, cond=cond)
        return [i, L.array_length(arr), L.array_read(arr, i)]

    [(_, (i, n, row))] = both(build, [{"x": np.ones((2, 3), "float32")}])
    assert int(i[0]) == 4 and int(n[0]) == 0
    np.testing.assert_array_equal(row, np.zeros((2, 3), "float32"))


def test_while_body_locals_do_not_leak_and_writes_clamp():
    """The body's own variables stay in the body; a write past the
    capacity lands on the last row (XLA clamps the update index), while
    the length still counts the index written."""

    def build(fl):
        L = fl.layers
        x = L.data(name="x", shape=[2], dtype="float32")
        arr = L.create_array("float32", capacity=3)
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        acc = L.fill_constant(shape=[1], dtype="float32", value=0.0)
        limit = L.fill_constant(shape=[1], dtype="int64", value=5)
        cond = L.less_than(x=i, y=limit)
        w = L.While(cond=cond)
        with w.block():
            row = L.scale(x, scale=1.5, bias=1.0)
            L.array_write(L.elementwise_add(row, L.cast(i, "float32"), axis=0), i, arr)
            L.assign(L.elementwise_add(acc, L.reduce_sum(row)), acc)
            L.increment(x=i, value=1, in_place=True)
            L.less_than(x=i, y=limit, cond=cond)
        last = L.array_read(arr, L.fill_constant(shape=[1], dtype="int64", value=9))
        return [acc, L.array_length(arr), last, row.name]

    main, startup, fetch = _build(tfluid, build)
    x = np.arange(4, dtype="float32").reshape(2, 2)
    with pytest.raises(KeyError, match="fetch target"):
        _run_port(main, startup, {"x": x}, fetch)
    [(_, (acc, n, last))] = both(lambda fl: build(fl)[:3], [{"x": x}],
                                 tol=FLOAT_SUM_TOL)
    assert int(n[0]) == 5
    np.testing.assert_array_equal(last, x * 1.5 + 1.0 + 4.0)


def test_conditional_block_false_gives_zeros_of_the_body_shape():
    """An output the body would bind, unbound before, is zeros of the
    body's shape when the predicate is false; a bound one keeps its
    value."""

    def build(fl):
        L = fl.layers
        x = L.data(name="x", shape=[3], dtype="float32")
        flag = L.data(name="flag", shape=[1], dtype="bool")
        fresh = L.create_tensor("float32")
        kept = L.fill_constant(shape=[1], dtype="float32", value=7.0)
        cb = L.ConditionalBlock([flag])
        with cb.block():
            L.assign(L.scale(x, scale=3.0), fresh)
            L.assign(L.reshape(L.reduce_sum(x), shape=[1]), kept)
        return [fresh, kept]

    x = np.arange(6, dtype="float32").reshape(2, 3)
    (_, (f_true, k_true)), (_, (f_false, k_false)) = both(
        build, [{"x": x, "flag": np.array([True])},
                {"x": x, "flag": np.array([False])}], tol=FLOAT_SUM_TOL)
    np.testing.assert_array_equal(f_true, 3 * x)
    np.testing.assert_array_equal(f_false, np.zeros_like(x))
    np.testing.assert_allclose(k_true, [15.0])
    np.testing.assert_array_equal(k_false, [7.0])


def test_is_empty():
    def build(fl):
        L = fl.layers
        x = L.data(name="x", shape=[3], dtype="float32")
        return [L.is_empty(x)]

    (_, (full,)), (_, (empty,)) = both(
        build, [{"x": np.ones((2, 3), "float32")},
                {"x": np.ones((0, 3), "float32")}])
    assert not bool(full[0]) and bool(empty[0])


# ---------------------------------------------------------------------------
# the new rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "int64"])
@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("axis", [0, 1, -1])
def test_cumsum(dtype, exclusive, reverse, axis):
    rng = np.random.RandomState(3)
    x = (rng.randn(4, 5, 6) * 10).astype(dtype)

    def build(fl):
        L = fl.layers
        v = L.data(name="x", shape=[5, 6], dtype=dtype)
        return [L.cumsum(v, axis=axis, exclusive=exclusive, reverse=reverse)]

    [(_, (out,))] = both(build, [{"x": x}], tol=FLOAT_SUM_TOL)
    assert out.dtype == np.dtype(dtype)


CMP = {"less_than": np.less, "less_equal": np.less_equal,
       "greater_than": np.greater, "greater_equal": np.greater_equal,
       "equal": np.equal, "not_equal": np.not_equal}


@pytest.mark.parametrize("dtype", ["float32", "int64"])
def test_compare_table(dtype):
    rng = np.random.RandomState(4)
    x = rng.randint(-2, 3, size=(3, 4)).astype(dtype)
    y = rng.randint(-2, 3, size=(3, 4)).astype(dtype)

    def build(fl):
        L = fl.layers
        a = L.data(name="a", shape=[4], dtype=dtype)
        b = L.data(name="b", shape=[4], dtype=dtype)
        return [getattr(L, op)(a, b) for op in CMP]

    [(_, outs)] = both(build, [{"a": x, "b": y}])
    for (op, ref), out in zip(CMP.items(), outs):
        assert out.dtype == np.bool_, op
        np.testing.assert_array_equal(out, ref(x, y), op)


def test_logical_table():
    rng = np.random.RandomState(5)
    x = rng.rand(3, 4) > 0.5
    y = rng.rand(3, 4) > 0.5

    def build(fl):
        L = fl.layers
        a = L.data(name="a", shape=[4], dtype="bool")
        b = L.data(name="b", shape=[4], dtype="bool")
        return [L.logical_and(a, b), L.logical_or(a, b), L.logical_xor(a, b),
                L.logical_not(a)]

    [(_, (a_and, a_or, a_xor, a_not))] = both(build, [{"a": x, "b": y}])
    np.testing.assert_array_equal(a_and, x & y)
    np.testing.assert_array_equal(a_or, x | y)
    np.testing.assert_array_equal(a_xor, x ^ y)
    np.testing.assert_array_equal(a_not, ~x)


def test_elementwise_sub_and_log():
    rng = np.random.RandomState(6)
    x = rng.rand(3, 4).astype("float32") + 0.1
    y = rng.rand(4).astype("float32")

    def build(fl):
        L = fl.layers
        a = L.data(name="a", shape=[4], dtype="float32")
        b = L.data(name="b", shape=[4], dtype="float32",
                   append_batch_size=False)
        return [L.elementwise_sub(a, b), L.log(a)]

    [(_, (d, lg))] = both(build, [{"a": x, "b": y}], tol=FLOAT_SUM_TOL)
    np.testing.assert_array_equal(d, x - y)


@pytest.mark.parametrize("times", [[1, 3], [2, 1], [2, 2]])
def test_expand(times):
    x = np.arange(6, dtype="int64").reshape(2, 3)

    def build(fl):
        L = fl.layers
        v = L.data(name="x", shape=[3], dtype="int64")
        return [L.expand(v, times)]

    [(_, (out,))] = both(build, [{"x": x}])
    np.testing.assert_array_equal(out, np.tile(x, times))


def test_fill_constant_batch_size_like():
    x = np.zeros((5, 3), "float32")

    def build(fl):
        L = fl.layers
        v = L.data(name="x", shape=[3], dtype="float32")
        return [L.fill_constant_batch_size_like(v, [-1, 4], "int64", 7.0),
                L.fill_constant_batch_size_like(v, [2, -1], "float32", 0.5,
                                                input_dim_idx=1,
                                                output_dim_idx=1)]

    [(_, (a, b))] = both(build, [{"x": x}])
    np.testing.assert_array_equal(a, np.full((5, 4), 7))
    assert a.dtype == np.int64
    np.testing.assert_array_equal(b, np.full((2, 3), 0.5, "float32"))


def test_assign_copies_lengths():
    data = np.arange(12, dtype="float32").reshape(3, 4)
    lens = np.array([4, 1, 2], np.int32)

    def build(fl):
        L = fl.layers
        v = L.data(name="x", shape=[4], dtype="float32", lod_level=1)
        return [L.assign(v)]

    feeds = [{"x": jfluid.LoDArray(data, lens)}]
    jm, js, fetch = _build(jfluid, build)
    (j,) = _run_jax(jm, js, feeds[0], fetch, return_numpy=False)
    (t,) = _run_port(tfluid.Program.parse_from_string(jm.to_string()),
                     tfluid.Program.parse_from_string(js.to_string()),
                     {"x": tfluid.LoDArray(data, lens)}, fetch,
                     return_numpy=False)
    assert isinstance(t, tfluid.LoDArray)
    np.testing.assert_array_equal(t.data, np.asarray(j.data))
    np.testing.assert_array_equal(t.lengths, np.asarray(j.lengths))
    np.testing.assert_array_equal(t.lengths, lens)


@pytest.mark.parametrize("dtype", ["float32", "int64", "int32", "bool"])
def test_gather_wraps_negatives_and_fills_out_of_range(dtype):
    rng = np.random.RandomState(7)
    x = (rng.randn(5, 3) * 10).astype(dtype)
    idx = np.array([0, 4, -1, -5, -6, 5, 9, 2], "int64")

    def build(fl):
        L = fl.layers
        v = L.data(name="x", shape=[3], dtype=dtype)
        i = L.data(name="i", shape=[8], dtype="int64", append_batch_size=False)
        return [L.gather(v, i)]

    [(_, (out,))] = both(build, [{"x": x, "i": idx}])
    np.testing.assert_array_equal(out[:4], x[[0, 4, 4, 0]])
    fill = {"float32": np.nan, "int64": -2 ** 31, "int32": -2 ** 31,
            "bool": True}[dtype]
    np.testing.assert_array_equal(out[4:7], np.full((3, 3), fill, dtype))
    np.testing.assert_array_equal(out[7], x[2])


def test_while_body_drops_each_local_after_its_last_reader():
    """The loop frees the body's own variables as it goes: in the
    Transformer's beam-search body every local is dropped once, at the
    last op that reads it (or at its writer when none does), and no outer
    or carried variable is; the vocabulary-wide logits die at the
    product that selects their current row."""
    from paddle_tpu_torch.layers.control_flow import _array_keys, _dead_after
    from paddle_tpu_torch.models import transformer as TT

    with tfluid.unique_name.guard():
        inf = TT.get_inference_model(beam_size=2, max_out_len=4, seq_len=6,
                                     src_vocab_size=20, trg_vocab_size=20,
                                     max_length=8, n_layer=1, n_head=2,
                                     d_model=16, d_inner=32)
    (wop,) = [op for op in inf["infer"].global_block().ops
              if op.type == "while"]
    body = wop.sub_block
    keep = set(wop.outputs["Out"]) | set(_array_keys(body))
    dead = _dead_after(body, keep)
    dropped = [n for names in dead for n in names]
    assert len(dropped) == len(set(dropped))
    assert not set(dropped) & keep
    touched = {n for op in body.ops
               for n in op.all_input_names() + op.all_output_names()}
    assert set(dropped) == {n for n in touched if body.has_var(n)}
    for i, names in enumerate(dead):
        for n in names:
            op = body.ops[i]
            assert n in op.all_input_names() + op.all_output_names()
            assert all(n not in later.all_input_names()
                       for later in body.ops[i + 1:])
    writer = {n: op.type for op in body.ops for n in op.all_output_names()}
    (sel,) = [i for i, op in enumerate(body.ops)
              if op.type == "elementwise_mul"
              and writer.get(op.inputs["Y"][0], "").startswith("unsqueeze")]
    assert body.ops[sel].inputs["X"][0] in dead[sel]
