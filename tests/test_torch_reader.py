"""The port's reader runtime on the CPU, against the JAX package's.

The decorators (``paddle_tpu_torch.reader.decorator``), ``batch`` and the
creators give the same samples in the same order as the JAX package's
on the same seeded readers (``shuffle`` under the same ``random`` seed);
the threaded ones (``buffered``, ``multiprocess_reader``, ``xmap_readers``)
pass errors on and leave no producer thread behind when abandoned;
``retry_reader`` resumes a ``flaky_reader`` at the exact sample.  Then
``layers.py_reader``: a Program fed by a started reader when a run gets
no feed, ``core.EOFException`` at the end (sticky, not a StopIteration),
``reset``/``start``, the JAX package's values on the same batches, and
the executor's hook: batches pulled from every started reader, pushed
back when one is exhausted, a reader-fed run never bound (counted under
``executor.graph_refused{op=py_reader}``).  The recordio readers raise,
naming ROADMAP A12.
"""
from __future__ import annotations

import random
import threading
import time

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu import reader as jreader
from paddle_tpu.testing import faults as jfaults
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import reader
from paddle_tpu_torch.testing import faults

D = reader.decorator
JD = jreader.decorator
LOSS_RTOL = 1e-5


def _samples(seed, n=40):
    rng = np.random.RandomState(seed)
    return [(rng.randn(3).astype("float32"), int(rng.randint(10)))
            for _ in range(n)]


def _creator(seq):
    return lambda: iter(list(seq))


def _equal(x, y):
    """Two samples (arrays, scalars, tuples and lists of them) equal, an
    array's bits and dtype included."""
    if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        x, y = np.asarray(x), np.asarray(y)
        return (x.dtype == y.dtype and x.shape == y.shape
                and x.tobytes() == y.tobytes())
    if isinstance(x, (tuple, list)) or isinstance(y, (tuple, list)):
        return (type(x) is type(y) and len(x) == len(y)
                and all(_equal(a, b) for a, b in zip(x, y)))
    return x == y


def _same(a, b):
    """Two lists of samples equal, in order."""
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert _equal(x, y), i


#: name -> builder(decorator module, batch function, seeded creator)
CASES = {
    "cache": lambda d, b, c: d.cache(c),
    "map_readers": lambda d, b, c: d.map_readers(
        lambda s, t: (s[0] * 2, t[1]), c, c),
    "shuffle": lambda d, b, c: d.shuffle(c, 7),
    "chain": lambda d, b, c: d.chain(c, d.firstn(c, 5)),
    "compose": lambda d, b, c: d.compose(c, c),
    "buffered": lambda d, b, c: d.buffered(c, 4),
    "firstn": lambda d, b, c: d.firstn(c, 13),
    "xmap_ordered": lambda d, b, c: d.xmap_readers(
        lambda s: (s[0] + 1, s[1]), c, 3, 4, order=True),
    "batch": lambda d, b, c: b(c, 6),
    "batch_drop_last": lambda d, b, c: b(c, 6, drop_last=True),
    "shuffle_then_batch": lambda d, b, c: b(d.shuffle(c, 11), 8),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_decorator_matches_jax(case):
    samples = _samples(1)
    out = []
    for d, b in ((JD, jreader.batch), (D, reader.batch)):
        random.seed(7)   # shuffle draws from Python's random module
        out.append(list(CASES[case](d, b, _creator(samples))()))
    _same(out[1], out[0])


def test_multiprocess_reader_matches_jax_as_a_multiset():
    got = list(D.multiprocess_reader([_creator(range(10)),
                                      _creator(range(10, 25))])())
    want = list(JD.multiprocess_reader([_creator(range(10)),
                                        _creator(range(10, 25))])())
    assert sorted(got) == sorted(want) == list(range(25))
    with pytest.raises(ValueError):
        D.multiprocess_reader([])


def test_xmap_unordered_matches_jax_as_a_multiset():
    got = list(D.xmap_readers(lambda x: x * x, _creator(range(30)), 4, 8)())
    want = list(JD.xmap_readers(lambda x: x * x, _creator(range(30)), 4, 8)())
    assert sorted(got) == sorted(want)


def test_creators_match_jax(tmp_path):
    arr = np.random.RandomState(2).randn(5, 3).astype("float32")
    _same(list(reader.np_array(arr)()), list(jreader.np_array(arr)()))
    path = tmp_path / "lines.txt"
    path.write_text("a\nbb\n\nccc\n")
    assert list(reader.text_file(str(path))()) == list(
        jreader.text_file(str(path))())
    with pytest.raises(NotImplementedError, match="A12"):
        reader.recordio(str(path))


def test_retry_reader_resumes_at_the_failed_sample_like_jax():
    src = _creator(range(20))
    policy = lambda r: r.RetryPolicy(max_retries=3, base_delay=0.0,  # noqa: E731
                                     sleep=lambda s: None)
    got = list(D.retry_reader(faults.flaky_reader(src, fail_at=7, times=2),
                              policy=policy(fluid.resilience))())
    want = list(JD.retry_reader(jfaults.flaky_reader(src, fail_at=7, times=2),
                                policy=policy(jfluid.resilience))())
    assert got == want == list(range(20))
    # past the budget the error reaches the consumer
    with pytest.raises(faults.FaultInjected):
        list(D.retry_reader(faults.flaky_reader(src, fail_at=3, times=5),
                            policy=policy(fluid.resilience))())


def test_compose_checks_alignment():
    with pytest.raises(D.ComposeNotAligned):
        list(D.compose(_creator([1, 2, 3]), _creator([4]))())
    loose = D.compose(_creator([1, 2, 3]), _creator([4]), check_alignment=False)
    assert list(loose()) == [(1, 4)]


def test_threaded_decorators_pass_errors_on():
    def broken():
        yield 1
        raise IOError("corrupt shard")

    it = D.buffered(broken, size=2)()
    assert next(it) == 1
    with pytest.raises(IOError, match="corrupt shard"):
        list(it)

    def boom(x):
        if x == 3:
            raise ValueError("bad sample")
        return x

    with pytest.raises(ValueError, match="bad sample"):
        list(D.xmap_readers(boom, _creator(range(6)), 2, 2, order=True)())
    with pytest.raises(IOError, match="corrupt shard"):
        list(D.multiprocess_reader([_creator(range(3)), broken])())


def _pump_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(("paddle-tpu-buffered-pump",
                                  "paddle-tpu-interleave-pump"))]


def _wait_no_pump_threads(timeout=5.0):
    deadline = time.monotonic() + timeout
    while _pump_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not _pump_threads(), "leaked producer threads: %r" % _pump_threads()


def _endless(base=0, closed=None):
    def r():
        try:
            i = base
            while True:
                yield i
                i += 1
        finally:
            if closed is not None:
                closed.append(True)
    return r


def test_abandoned_threaded_decorators_leave_no_threads():
    closed = []
    it = D.buffered(_endless(closed=closed), size=2)()
    assert next(it) == 0
    it.close()
    _wait_no_pump_threads()
    assert closed, "underlying reader left open after abandonment"

    it = D.multiprocess_reader([_endless(0), _endless(1000)], queue_size=4)()
    for _ in range(5):
        next(it)
    it.close()
    _wait_no_pump_threads()

    def slow_after_first(x):
        if x > 0:
            time.sleep(5.0)
        return x

    it = D.xmap_readers(slow_after_first, _creator(range(64)), 4, 64,
                        order=True)()
    assert next(it) == 0
    started = time.monotonic()
    it.close()
    assert time.monotonic() - started < 4.0


# ---------------------------------------------------------------------------
# py_reader and the executor's reader hook
# ---------------------------------------------------------------------------

N, DIM = 24, 4


def _regression_batches(batch=4):
    rng = np.random.RandomState(0)
    w = np.array([[1.0], [-2.0], [0.5], [1.5]], "float32")
    out = []
    for _ in range(N // batch):
        x = rng.randn(batch, DIM).astype("float32")
        out.append((x, x @ w))
    return out


def _py_reader_program(fl):
    main, startup = fl.Program(), fl.Program()
    startup.random_seed = 7   # a fixed start: the loss falls the same way
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        r = fl.layers.py_reader(capacity=8, shapes=[(-1, DIM), (-1, 1)],
                                dtypes=["float32", "float32"])
        x, y = fl.layers.read_file(fl.layers.double_buffer(r))
        pred = fl.layers.fc(x, size=1)
        loss = fl.layers.mean(fl.layers.square_error_cost(pred, y))
        fl.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return main, startup, r, loss


def test_py_reader_trains_like_jax_without_feed():
    batches = _regression_batches()
    losses = {}
    state = None
    for name, fl in (("jax", jfluid), ("port", fluid)):
        main, startup, r, loss = _py_reader_program(fl)
        r.decorate_paddle_reader(lambda: iter(batches))
        exe = fl.Executor(fl.CPUPlace())
        scope = fl.Scope()
        with fl.scope_guard(scope):
            exe.run(startup)
            if state is None:
                state = {n: np.asarray(scope[n])
                         for n in main.persistable_names() if n in scope}
            else:
                fl.load_numpy_state(main, state, device="cpu")
            got = losses[name] = []
            for _ in range(2):
                r.start()
                while True:
                    try:
                        (lv,) = exe.run(main, fetch_list=[loss])
                    except fl.core.EOFException:
                        break
                    got.append(float(np.ravel(lv)[0]))
                r.reset()
        if name == "port":
            assert not exe._bound, "a reader-fed run was bound"
    assert len(losses["port"]) == 2 * len(batches)
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=LOSS_RTOL,
                               atol=0)
    assert losses["port"][-1] < 0.5 * losses["port"][0]


def test_reader_fed_runs_are_counted_as_refused_never_bound():
    main, startup, r, loss = _py_reader_program(fluid)
    r.decorate_paddle_reader(lambda: iter(_regression_batches()))
    refused = obs.counter("executor.graph_refused", {"op": "py_reader"})
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        before = refused.value
        r.start()
        for _ in range(4):
            exe.run(main, fetch_list=[loss])
        r.reset()
    assert refused.value - before == 4
    assert all(b.program is not main for b in exe._bound.values())


def test_exhausted_reader_pushes_the_others_batches_back():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ra = fluid.layers.py_reader(capacity=4, shapes=[(-1, 2)],
                                    dtypes=["float32"], name="ra")
        rb = fluid.layers.py_reader(capacity=4, shapes=[(-1, 2)],
                                    dtypes=["float32"], name="rb")
        (a,) = fluid.layers.read_file(ra)
        (b,) = fluid.layers.read_file(rb)
        out = fluid.layers.reduce_sum(a) + fluid.layers.reduce_sum(b)
    ra.decorate_paddle_reader(
        lambda: iter([(np.full((1, 2), i, "float32"),) for i in range(3)]))
    rb.decorate_paddle_reader(
        lambda: iter([(np.full((1, 2), 10 * i, "float32"),) for i in range(1)]))
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        ra.start()
        rb.start()
        (v,) = exe.run(main, fetch_list=[out])
        assert float(np.ravel(v)[0]) == 0.0
        with pytest.raises(fluid.core.EOFException):
            exe.run(main, fetch_list=[out])
        # ra's second batch went back: it is the next one ra hands out
        assert float(ra.next()[0][0, 0]) == 1.0
        rb.reset()
        ra.reset()


def test_py_reader_decorated_generator_matches_jax():
    got = {}
    for name, fl in (("jax", jfluid), ("port", fluid)):
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            r = fl.layers.py_reader(capacity=8, shapes=[(-1, 3)],
                                    dtypes=["float32"])
            (x,) = fl.layers.read_file(r)
            out = fl.layers.reduce_sum(x)
        r.decorate_paddle_reader(
            lambda: iter([(np.full((2, 3), i, "float32"),) for i in range(5)]))
        exe = fl.Executor(fl.CPUPlace())
        vals = got[name] = []
        with fl.scope_guard(fl.Scope()):
            exe.run(startup)
            r.start()
            while True:
                try:
                    (v,) = exe.run(main, fetch_list=[out])
                except fl.core.EOFException:
                    break
                vals.append(float(np.ravel(v)[0]))
    assert got["port"] == got["jax"] == [i * 6.0 for i in range(5)]


def test_py_reader_program_still_clones():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        r = fluid.layers.py_reader(capacity=4, shapes=[(-1, 2)],
                                   dtypes=["float32"])
        (x,) = fluid.layers.read_file(r)
        fluid.layers.reduce_sum(x)
    clone = main.clone(for_test=True)
    assert len(clone.global_block().ops) == len(main.global_block().ops)
    from paddle_tpu_torch.layers.io import program_readers
    assert program_readers(clone) == []  # clones start readerless
    assert program_readers(main) == [r]


def test_py_reader_eof_is_sticky_and_reset_requires_start():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        r = fluid.layers.py_reader(capacity=4, shapes=[(-1, 2)],
                                   dtypes=["float32"])
        (x,) = fluid.layers.read_file(r)
        out = fluid.layers.reduce_sum(x)
    r.decorate_paddle_reader(lambda: iter([(np.ones((1, 2), "float32"),)]))
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        r.start()
        exe.run(main, fetch_list=[out])
        for _ in range(3):
            with pytest.raises(fluid.core.EOFException):
                exe.run(main, fetch_list=[out])
        r.reset()
        with pytest.raises(fluid.core.EOFException, match="not started"):
            exe.run(main, fetch_list=[out])
        r.start()
        (v,) = exe.run(main, fetch_list=[out])
        assert float(np.ravel(v)[0]) == 2.0


def test_eof_exception_passes_through_generator_frames():
    assert not issubclass(fluid.core.EOFException, StopIteration)

    def gen():
        yield 1
        raise fluid.core.EOFException("done")

    g = gen()
    assert next(g) == 1
    with pytest.raises(fluid.core.EOFException):
        next(g)


def test_py_reader_explicit_feed_still_wins():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        r = fluid.layers.py_reader(capacity=4, shapes=[(-1, 2)],
                                   dtypes=["float32"])
        (x,) = fluid.layers.read_file(r)
        out = fluid.layers.reduce_sum(x)
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        (v,) = exe.run(main, feed={r.names[0]: np.ones((3, 2), "float32")},
                       fetch_list=[out])
    assert float(np.ravel(v)[0]) == 6.0


def test_layer_decorators_and_recordio_layers():
    samples = _samples(3, n=12)
    random.seed(1)
    got = list(fluid.layers.batch(fluid.layers.shuffle(_creator(samples), 5),
                                  4)())
    random.seed(1)
    want = list(jfluid.layers.batch(
        jfluid.layers.shuffle(_creator(samples), 5), 4)())
    _same(got, want)
    with pytest.raises(NotImplementedError, match="A12"):
        fluid.layers.open_recordio_file("f", [(-1, 2)], [0], ["float32"])
    with pytest.raises(NotImplementedError, match="A12"):
        fluid.layers.open_files(["f"], [(-1, 2)], [0], ["float32"])
