"""Step-time attribution of the port (``observability.StepAttribution``)
on the CPU: the JAX package's ``tests/unittests/test_attribution.py``
cases on synthetic streams and on a Trainer, against the port, without
its wall-clock verdict flip; and the device time a record's
``execute_s`` carries outweighing a short dispatch span (a replayed CUDA
graph's enqueue)."""
import time

import numpy as np
import pytest

import paddle_tpu_torch as fluid
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.observability import StepAttribution
from paddle_tpu_torch.observability.attribution import VERDICT_CODE


def test_classification_from_synthetic_streams():
    att = StepAttribution()
    for _ in range(4):
        att.emit_span("prefetch.wait", 0.0, 0.05, None, {})
        att.emit({"type": "step", "source": "executor",
                  "duration_s": 0.06, "execute_s": 0.005})
    v = att.verdict()
    assert v["verdict"] == "input-bound"
    assert v["steps"] == 4
    assert v["input_s"] == pytest.approx(0.2)

    att2 = StepAttribution()
    for _ in range(4):
        att2.emit_span("executor.dispatch", 0.0, 0.05, None, {})
        att2.emit({"type": "step", "source": "executor",
                   "duration_s": 0.055, "execute_s": 0.05})
    assert att2.verdict()["verdict"] == "compute-bound"


def test_device_time_outweighs_a_short_dispatch_span():
    """A graphed step: its dispatch span is the replay's enqueue (50 µs)
    and its device time (180 ms) arrives in ``execute_s``, while the host
    waits in the fetch.  The window is compute-bound on the device time,
    not input-bound on the spans."""
    att = StepAttribution()
    for _ in range(5):
        att.emit_span("prefetch.wait", 0.0, 0.02, None, {})
        att.emit_span("executor.dispatch", 0.0, 50e-6, None, {})
        att.emit_span("executor.fetch_materialize", 0.0, 0.18, None, {})
        att.emit({"type": "step", "source": "executor",
                  "duration_s": 0.2, "execute_s": 0.18})
    v = att.verdict()
    assert v["verdict"] == "compute-bound", v
    assert v["compute_s"] == pytest.approx(0.9)
    assert v["fetch_s"] == pytest.approx(0.9)
    assert v["wall_s"] >= 1.0 and v["compute_fraction"] <= 1.0
    # the same spans without the device time: the enqueue alone loses
    att2 = StepAttribution()
    for _ in range(5):
        att2.emit_span("prefetch.wait", 0.0, 0.02, None, {})
        att2.emit_span("executor.dispatch", 0.0, 50e-6, None, {})
        att2.emit({"type": "step", "source": "executor",
                   "duration_s": 0.2, "execute_s": None})
    assert att2.verdict()["verdict"] == "input-bound"


def test_trainer_records_not_double_counted_and_compile_excluded():
    att = StepAttribution()
    att.emit({"type": "step", "source": "trainer", "duration_s": 1.0})
    att.emit({"type": "step", "source": "executor", "duration_s": 0.01,
              "execute_s": 2.0, "compile": True})
    v = att.verdict()
    assert v["steps"] == 1
    assert v["compute_s"] == 0.0


def test_window_auto_close_and_report():
    att = StepAttribution(window_steps=2)
    for _ in range(5):
        att.emit_span("prefetch.wait", 0.0, 0.02, None, {})
        att.emit({"type": "step", "source": "executor",
                  "duration_s": 0.03, "execute_s": 0.001})
    assert len(att.windows()) == 2
    v = att.verdict()
    assert len(att.windows()) == 3
    assert v["steps"] == 1
    rep = att.report()
    assert "input-bound" in rep and "verdict" in rep
    assert obs.gauge("compute.step.input_bound").value == 1.0
    assert obs.gauge("compute.step.verdict").value == "input-bound"
    assert (obs.gauge("compute.step.verdict_code").value
            == VERDICT_CODE["input-bound"])
    assert obs.prometheus_name("compute.step.verdict_code") in \
        obs.parse_prometheus(obs.render_prometheus())


def test_occupancy_breaks_balanced_ties():
    att = StepAttribution()
    assert att._classify(1.0, 1.0, 0.1) == "input-bound"
    assert att._classify(1.0, 1.0, 0.9) == "compute-bound"
    assert att._classify(1.0, 1.0, 0.5) == "balanced"
    assert att._classify(0.0, 0.0, None) == "idle"


def test_detached_plane_is_free():
    """No sink attached: span() hands back the shared no-op context
    (the disabled-path budget, 10 µs)."""
    tel = obs.get_telemetry()
    assert not tel.span_active(), "a previous test leaked a span sink"
    n = 20000
    t0 = time.perf_counter()
    for _ in range(n):
        with tel.span("executor.dispatch"):
            pass
    per = (time.perf_counter() - t0) / n
    assert per < 10e-6, "detached span path costs %.2fus" % (per * 1e6)


def _optimizer_func():
    return fluid.optimizer.SGD(learning_rate=0.05)


def _tiny_train_func():
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    pred = fluid.layers.fc(input=x, size=1)
    return fluid.layers.mean(
        fluid.layers.square_error_cost(input=pred, label=y))


def _reader(batches=6):
    def reader():
        rng = np.random.RandomState(0)
        for _ in range(batches):
            x = rng.randn(8, 4).astype("float32")
            yield list(zip(x, x[:, :1]))
    return reader


def test_trainer_detaches_attribution_on_exit():
    att = StepAttribution()
    t = fluid.Trainer(_tiny_train_func, _optimizer_func,
                      place=fluid.CPUPlace())
    t.train(num_epochs=1, reader=_reader(batches=2), feed_order=["x", "y"],
            attribution=att)
    assert att not in obs.get_telemetry().sinks()
    assert not obs.get_telemetry().span_active()
    assert not obs.get_telemetry().device_timing


def test_trainer_detaches_attribution_when_a_step_raises():
    att = StepAttribution()
    t = fluid.Trainer(_tiny_train_func, _optimizer_func,
                      place=fluid.CPUPlace())

    def handler(e):
        if isinstance(e, fluid.EndStepEvent) and e.step == 1:
            raise RuntimeError("stop here")

    with pytest.raises(RuntimeError, match="stop here"):
        t.train(num_epochs=1, event_handler=handler, reader=_reader(),
                feed_order=["x", "y"], attribution=att)
    assert att not in obs.get_telemetry().sinks()


def test_trainer_windows_count_executor_steps():
    """A CPU Trainer under attribution: one step a batch (the trainer's
    own records are not counted again), every executor record carries
    ``execute_s``, and the capture run's is kept out of compute."""
    att = StepAttribution(window_steps=3)
    ring = obs.RingBufferSink()
    obs.add_sink(ring)
    try:
        t = fluid.Trainer(_tiny_train_func, _optimizer_func,
                          place=fluid.CPUPlace())
        t.train(num_epochs=1, reader=_reader(batches=6),
                feed_order=["x", "y"], attribution=att)
    finally:
        obs.remove_sink(ring)
    windows = att.windows()
    assert [w["steps"] for w in windows] == [3, 3]
    tag = "%x:v%d" % (id(t.train_program), t.train_program.version)
    execs = [r for r in ring.records
             if r.get("source") == "executor" and r["program"] == tag]
    assert len(execs) == 6 and all(r["execute_s"] > 0 for r in execs)
    assert [r["compile"] for r in execs] == [False, True] + [False] * 4
    assert sum(w["compute_s"] for w in windows) >= sum(
        r["execute_s"] for r in execs if not r["compile"])
    assert all(w["verdict"] in VERDICT_CODE for w in windows)
