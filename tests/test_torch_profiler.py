"""The port's profiler and memory footprint on the CPU: the JAX
package's profiler-session cases (``tests/unittests/
test_observability.py``), its report cases and ``test_aux_tools.py``'s
memory, profiler and per-op report cases, against the port; a
``trace_dir`` session's Chrome trace; and the per-op rows of one real
step naming the JAX package's forward op types."""
import json
import os
import threading

import numpy as np
import pytest

import paddle_tpu_torch as fluid
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.program_fn import init_state


def _mlp_program():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=16, act="relu")
        p = fluid.layers.fc(input=h, size=4, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(input=p, label=y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _mlp_feed(rows=8):
    rng = np.random.RandomState(0)
    return {"x": rng.randn(rows, 8).astype("float32"),
            "y": rng.randint(0, 4, size=(rows, 1)).astype("int64")}


# -- sessions -----------------------------------------------------------------


def test_profiler_sessions_do_not_leak(tmp_path):
    p1 = str(tmp_path / "r1.txt")
    p2 = str(tmp_path / "r2.txt")
    with fluid.profiler.profiler("All", profile_path=p1):
        fluid.profiler.record("evt_one", 0.5)
    with fluid.profiler.profiler("All", profile_path=p2):
        fluid.profiler.record("evt_two", 0.25)
    r1, r2 = open(p1).read(), open(p2).read()
    assert "evt_one" in r1
    assert "evt_one" not in r2 and "evt_two" in r2


def test_stop_profiler_quiet_under_killswitch(capsys):
    tel = obs.get_telemetry()
    old = tel.enabled
    try:
        tel.configure(False)
        with fluid.profiler.profiler("All"):
            fluid.profiler.record("quiet_evt", 0.1)
        assert capsys.readouterr().out == ""
        tel.configure(True)
        with fluid.profiler.profiler("All"):
            fluid.profiler.record("loud_evt", 0.1)
        assert "loud_evt" in capsys.readouterr().out
    finally:
        tel.configure(old)


def test_profiler_record_thread_safe():
    fluid.profiler.reset_profiler()

    def worker():
        for _ in range(500):
            fluid.profiler.record("mt_evt", 0.001)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    tm = obs.get_telemetry().timer(fluid.profiler.TIMING_PREFIX + "mt_evt")
    assert tm.count == 2000
    fluid.profiler.reset_profiler()
    assert tm.stats() is None


def test_record_event_context():
    fluid.profiler.reset_profiler()
    with fluid.profiler.record_event("ctx_evt"):
        pass
    assert "ctx_evt" in fluid.profiler.format_report()
    fluid.profiler.reset_profiler()


# -- sessions over real steps -------------------------------------------------


def test_profiler_report(capsys):
    main, startup, loss = _mlp_program()
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    with fluid.profiler.profiler("All"):
        for _ in range(3):
            exe.run(main, feed=_mlp_feed(), fetch_list=[loss], scope=scope)
    out = capsys.readouterr().out
    assert "executor.run" in out and "Total(s)" in out
    row = next(ln for ln in out.splitlines() if "executor.run" in ln)
    assert int(row.split()[-5]) == 3   # every step ran op by op


def test_trace_dir_session_writes_op_ranges(tmp_path):
    """A bound entry steps op by op while profiled (its replay has no op
    ranges), each Program op in a record_function range of its type, and
    the session's Chrome trace holds them; the entry binds again after."""
    main, startup, loss = _mlp_program()
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    for _ in range(3):
        exe.run(main, feed=_mlp_feed(), fetch_list=[loss], scope=scope)
    with fluid.profiler.profiler("All", profile_path=str(tmp_path / "r"),
                                 trace_dir=str(tmp_path / "trace")):
        exe.run(main, feed=_mlp_feed(), fetch_list=[loss], scope=scope)
    trace = json.load(open(os.path.join(str(tmp_path / "trace"),
                                        fluid.profiler.TRACE_FILE)))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"mul", "relu", "softmax", "sgd", "backward"} <= names
    assert not fluid.executor._op_scopes
    exe.run(main, feed=_mlp_feed(), fetch_list=[loss], scope=scope)
    exe.run(main, feed=_mlp_feed(), fetch_list=[loss], scope=scope)
    (entry,) = exe._bound.values()
    assert entry.step is not None


# -- reports ------------------------------------------------------------------


def test_compiled_op_report_out_bytes_sort():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[6], dtype="float32")
        h = fluid.layers.fc(x, size=16, act="relu")
        fluid.layers.fc(h, size=2, act="softmax")
    state = init_state(startup, device="cpu")
    feed = {"x": np.random.RandomState(0).randn(4, 6).astype("float32")}
    report, rows = fluid.profiler.compiled_op_report(
        main, feed, state=state, sorted_key="out_bytes", device="cpu")
    byte_col = [int(ln.split()[-1]) for ln in report.splitlines()[1:]]
    assert byte_col == sorted(byte_col, reverse=True)
    assert sum(r["out_bytes"] for r in rows.values()) == sum(byte_col)


def test_profile_program_backward_whole_block_row():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(x, size=1)
        loss = fluid.layers.mean(fluid.layers.square(pred - y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    state = init_state(startup, device="cpu")
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(2, 4).astype("float32"),
            "y": rng.randn(2, 1).astype("float32")}
    report = fluid.profiler.profile_program(main, feed, state=state, iters=2,
                                            device="cpu")
    assert "backward(whole block)" in report
    assert report.splitlines()[0].split()[0] == "Op"


def test_per_op_profile_report():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[3, 8, 8], dtype="float32")
        y = fluid.layers.conv2d(x, num_filters=4, filter_size=3, act="relu")
        y = fluid.layers.pool2d(y, pool_size=2, pool_stride=2)
        fluid.layers.fc(y, size=5)
    state = init_state(startup, device="cpu")
    rng = np.random.RandomState(0)
    report = fluid.profiler.profile_program(
        main, {"x": rng.randn(2, 3, 8, 8).astype("float32")}, state=state,
        iters=3, device="cpu")
    lines = report.splitlines()
    assert lines[0].split()[:2] == ["Op", "Calls"]
    body = [ln.split()[0] for ln in lines[1:]]
    for op_type in ("conv2d", "pool2d", "relu", "mul"):
        assert op_type in body, (op_type, body)
    totals = [float(ln.split()[2]) for ln in lines[1:]]
    assert totals == sorted(totals, reverse=True)


def _report_rows(fl, state_fn, **kw):
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[6], dtype="float32")
        lbl = fl.layers.data(name="y", shape=[1], dtype="int64")
        h = fl.layers.fc(x, size=8, act="relu")
        p = fl.layers.fc(h, size=3, act="softmax")
        loss = fl.layers.mean(fl.layers.cross_entropy(input=p, label=lbl))
        fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(4, 6).astype("float32"),
            "y": rng.randint(0, 3, (4, 1)).astype("int64")}
    return fl.profiler.compiled_op_report(main, feed, state=state_fn(startup),
                                          fetch_list=[loss], **kw)


def test_compiled_op_report_real_step():
    """One row a Program op type from a real step's count, the backward
    one ``backward`` row, the sum of the rows the whole count."""
    report, rows = _report_rows(
        fluid, lambda s: init_state(s, device="cpu"), device="cpu")
    for op_type in ("mul", "relu", "softmax"):
        assert op_type in rows, (op_type, sorted(rows))
        assert rows[op_type]["instructions"] >= 1
    assert rows["backward"]["instructions"] >= 1
    assert report.splitlines()[0].split()[0] == "Op"


def test_compiled_op_report_forward_rows_match_the_jax_package():
    pytest.importorskip("jax")
    import paddle_tpu as jfluid
    from paddle_tpu.jax_bridge import init_state as jinit

    _, jrows = _report_rows(jfluid, jinit)
    _, trows = _report_rows(
        fluid, lambda s: init_state(s, device="cpu"), device="cpu")
    forward = {k for k in jrows if not k.endswith("_grad")}
    assert forward == set(trows) - {"backward", "(between ops)"}


def test_memory_usage():
    main, _, _ = _mlp_program()
    low, high, unit = fluid.contrib.memory_usage(main, batch_size=32,
                                                 device="cpu")
    assert low > 0 and high > low and unit in ("B", "KB", "MB", "GB")
    # measured on the CPU: inputs and outputs, no allocator to read
    low, high, unit = fluid.contrib.memory_usage(main, batch_size=32,
                                                 precise=True, device="cpu")
    m = fluid.contrib.memory_analysis(main, 32, device="cpu")
    assert m["temp_bytes"] == 0 and m["code_bytes"] == 0
    assert m["peak_hbm_bytes"] == m["arg_bytes"] + m["output_bytes"]
    assert m["flops"] > 0
    assert high == pytest.approx(low * 1.05)
