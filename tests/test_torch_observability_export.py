"""The port's observability export plane against the JAX package's, on
the CPU: the sinks, the Prometheus export and the SLO monitor.

The modules are copies, so each case feeds both packages the same
inputs and holds the outputs equal, byte for byte where they are text:
``render_prometheus`` of the same registry contents (a fresh
``Telemetry`` in each package), ``parse_prometheus`` on that text and on
malformed lines, ``SLOMonitor`` fed the same observation sequence under
an injected clock (the same alerts and report), ``JsonlSink`` and
``ChromeTraceSink`` given the same records and spans (the same files).
Then the engine's endpoint: ``InferenceEngine.serve_metrics`` on a CPU
engine serves a strict-parsing ``/metrics`` with monotone bucket ladders
and ``/healthz`` 200 while ready; ``stop()`` stops it; called again after
the stop it opens a fresh endpoint whose ``/healthz`` answers 503; the
answers are the bits of an engine that never opened one.
"""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu.observability as jobs
import paddle_tpu.observability.slo as jslo
import paddle_tpu_torch as fluid
import paddle_tpu_torch.observability as tobs
import paddle_tpu_torch.observability.slo as tslo
from paddle_tpu_torch import serving

PACKAGES = {"jax": jobs, "port": tobs}


def _fill(obs):
    """A fresh registry of the package ``obs`` with every kind of cell:
    counters (one labeled), gauges (a None and a string one are left
    out of the exposition), a timer, a timer and a histogram on one
    name, histograms with observations across their buckets."""
    tel = obs.Telemetry(enabled=True)
    tel.counter("serving.requests").inc(41)
    tel.counter("serving.requests", {"model": "m", "tenant": "t"}).inc(7)
    tel.counter("executor.compile").inc(3)
    tel.gauge("serving.queue_depth").set(5)
    tel.gauge("serving.breaker_state").set(0.5)
    tel.gauge("serving.unset")
    tel.gauge("serving.state_name").set("ready")
    tel.timer("executor.dispatch").observe(0.25)
    tel.timer("executor.dispatch").observe(0.5)
    for v in (1e-4, 3e-3, 0.02, 0.02, 0.7, 4.0):
        tel.timer("serving.queue_wait").observe(v)
        tel.histogram("serving.queue_wait").observe(v)
        tel.histogram("serving.execute").observe(v * 2)
    return tel


def _render(obs):
    return obs.render_prometheus(_fill(obs))


def test_render_prometheus_is_the_jax_package_text():
    want, got = _render(jobs), _render(tobs)
    assert got == want
    assert 'paddle_tpu_serving_requests_total{model="m",tenant="t"} 7' in got
    assert "paddle_tpu_serving_state_name" not in got
    assert tobs.prometheus_name("serving.decode.ttft") == (
        jobs.prometheus_name("serving.decode.ttft"))


def test_parse_prometheus_matches_on_the_text_and_on_malformed_lines():
    text = _render(jobs)
    samples = tobs.parse_prometheus(text)
    assert samples == jobs.parse_prometheus(text)
    ladder = sorted(((k, v) for k, v in samples.items()
                     if k.startswith("paddle_tpu_serving_queue_wait_seconds"
                                     "_bucket")),
                    key=lambda kv: float(kv[0].split('le="')[1].split('"')[0]
                                         .replace("Inf", "inf")))
    counts = [v for _, v in ladder]
    assert counts == sorted(counts) and 'le="+Inf"' in ladder[-1][0]
    assert counts[-1] == samples["paddle_tpu_serving_queue_wait_seconds_count"]
    bad = {
        "comment": "# nonsense here\nx_total 1\n",
        "duplicate_type": "# TYPE a counter\n# TYPE a counter\na 1\n",
        "duplicate_sample": "a 1\na 2\n",
        "no_value": "a_total\n",
        "not_a_number": "a_total one\n",
        "timestamped": "a_total 1 1700000000000\n",
        "escaped_label": 'a{x="\\"q\\""} 1\nb 2\n',
    }
    for name, t in bad.items():
        out = {}
        for key, obs in PACKAGES.items():
            try:
                out[key] = ("ok", obs.parse_prometheus(t))
            except ValueError as e:
                out[key] = ("ValueError", str(e))
        assert out["port"] == out["jax"], name
        assert (tobs.parse_prometheus(t, strict=False)
                == jobs.parse_prometheus(t, strict=False)), name


class _Clock:
    """A stand-in for the ``time`` module of ``slo.py``: ``time()`` and
    ``perf_counter()`` advance only when the test says."""

    def __init__(self):
        self.t = 1000.0

    def time(self):
        return self.t

    def perf_counter(self):
        return self.t


def _slo_run(obs, slo_module, monkeypatch):
    """Windows of the same per-class outcomes and latencies into a fresh
    registry of ``obs``, evaluated by an SLOMonitor under an injected
    clock; returns each window's (alerts, report) as plain data."""
    clock = _Clock()
    monkeypatch.setattr(slo_module, "time", clock)
    tel = obs.Telemetry(enabled=True)
    backlog = {"interactive": 0, "batch": 0, "best_effort": 0}
    mon = obs.SLOMonitor(
        [obs.SLOTarget("interactive", goodput=0.95, p99_ms=50.0,
                       min_requests=3),
         obs.SLOTarget("batch", goodput=0.5, p95_ms=200.0, min_requests=3)],
        window_s=10.0, drain_target_s={"interactive": 0.5, "batch": 2.0},
        min_replicas=1, max_replicas=8, telemetry=tel,
        backlog_fn=lambda: backlog, service_rate_fn=lambda: 40.0)
    rng = np.random.RandomState(21)
    out = []
    for window in range(4):
        for cls, slow in (("interactive", window == 1),
                          ("batch", window == 2)):
            for _ in range(12):
                lat = float(rng.lognormal(-4.0 if not slow else -1.0, 0.3))
                tel.counter("serving.done_%s" % cls).inc()
                if lat < 0.1 or not slow:
                    tel.counter("serving.deadline_met_%s" % cls).inc()
                tel.histogram("serving.request_latency_%s" % cls).observe(lat)
            if slow:
                tel.counter("serving.rejected_%s" % cls).inc(3)
        backlog.update(interactive=4 * window, batch=30 * window)
        clock.t += 10.0
        rep = mon.evaluate()
        out.append({
            "alerts": [a.as_record() for a in rep["alerts"]],
            "desired": rep["desired_replicas"],
            "per_class": json.dumps(rep["per_class"], sort_keys=True,
                                    default=str)})
    monkeypatch.undo()
    return out


def test_slo_monitor_gives_the_jax_package_alerts(monkeypatch):
    want = _slo_run(jobs, jslo, monkeypatch)
    got = _slo_run(tobs, tslo, monkeypatch)
    assert got == want
    assert [len(w["alerts"]) > 0 for w in got] == [False, True, True, False]
    assert {a["priority"] for w in got for a in w["alerts"]} == {
        "interactive", "batch"}


def _sink_output(obs, tmp_path, tag):
    """The same records and spans through both file sinks of ``obs``;
    returns (the JSONL text, the Chrome trace JSON)."""
    jl = obs.JsonlSink(str(tmp_path / ("%s.jsonl" % tag)))
    tr = obs.ChromeTraceSink(str(tmp_path / ("%s.trace.json" % tag)))
    main = threading.current_thread()

    class Other:   # a second thread's identity, as a prefetch thread's
        ident, name = -7, "paddle-tpu-device-prefetch"

    for i in range(3):
        rec = {"type": "step", "ts": 1700000000.0 + i, "source": "trainer",
               "run_id": "r", "program": "p:v1", "step": i,
               "duration_s": 0.5, "steps_per_s": 2.0, "nan_ok": None,
               "feed_host_copies": i, "prefetch_transfers": 2 * i}
        jl.emit(rec)
        tr.emit(rec)
        tr.emit_span("executor.dispatch", 1700000000.0 + i, 0.25, main,
                     {"step": i})
        tr.emit_span("prefetch.convert_transfer", 1700000000.1 + i, 0.1,
                     Other, None)
    jl.emit({"type": "serve_batch", "ts": 1.5, "rows": 4})
    jl.close()
    tr.close()
    return ((tmp_path / ("%s.jsonl" % tag)).read_text(),
            (tmp_path / ("%s.trace.json" % tag)).read_text())


def test_file_sinks_write_the_jax_package_schema(tmp_path):
    want = _sink_output(jobs, tmp_path, "jax")
    got = _sink_output(tobs, tmp_path, "port")
    assert got == want
    lines = [json.loads(x) for x in got[0].splitlines()]
    assert all(set(tobs.STEP_SCHEMA["required"]) <= set(r) for r in lines
               if r["type"] == "step")
    events = json.loads(got[1])["traceEvents"]
    assert {e["args"]["name"] for e in events if e["ph"] == "M"} == {
        threading.current_thread().name, "paddle-tpu-device-prefetch"}
    assert tobs.STEP_SCHEMA == jobs.STEP_SCHEMA


def test_the_port_exports_what_the_jax_package_exports():
    from_modules = {n for n in jobs.__all__
                    if getattr(getattr(jobs, n), "__module__", "")
                    .split(".")[-1] in ("sinks", "export", "slo")}
    assert len(from_modules) == 13
    assert from_modules <= set(tobs.__all__)
    for n in from_modules:
        assert getattr(tobs, n).__module__.startswith("paddle_tpu_torch.")


def _save_model(dirname):
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        h = fluid.layers.fc(x, size=32, act="relu")
        out = fluid.layers.fc(h, size=6, act="softmax")
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.io.save_inference_model(dirname, ["x"], [out], exe,
                                      main_program=main)
    return dirname


def _get(url):
    """(status, body) of a GET, an HTTP error's included."""
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return _save_model(str(tmp_path_factory.mktemp("export") / "m"))


def test_serve_metrics_on_a_cpu_engine(model_dir):
    """``/metrics`` parses strictly with monotone ladders ending at
    ``_count``, ``/healthz`` is 200 while ready; ``stop()`` stops the
    endpoint; a second ``serve_metrics`` after the stop opens a fresh
    one that answers 503; the predictions are the bits of an engine
    without an endpoint."""
    rng = np.random.RandomState(11)
    xs = [rng.randn(1, 16).astype(np.float32) for _ in range(10)]
    eng = serving.InferenceEngine(model_dir, device="cpu",
                                  batch_buckets=(2, 4), supervise=False)
    try:
        srv = eng.serve_metrics()
        assert eng.serve_metrics() is srv and srv.running
        outs = [eng.predict({"x": x}, timeout=30)[0] for x in xs]
        status, body = _get(srv.url + "/metrics")
        assert status == 200
        samples = tobs.parse_prometheus(body, strict=True)
        for base in ("paddle_tpu_serving_queue_wait_seconds",
                     "paddle_tpu_serving_execute_seconds",
                     "paddle_tpu_serving_request_latency_batch_seconds"):
            # this engine's series (unlabelled); a process that ran the
            # router's tests first also holds series labelled by model
            ladder = sorted(
                ((k, v) for k, v in samples.items()
                 if k.startswith(base + '_bucket{le="')),
                key=lambda kv: float(kv[0].split('le="')[1].split('"')[0]
                                     .replace("Inf", "inf")))
            counts = [v for _, v in ladder]
            assert ladder and counts == sorted(counts), base
            assert 'le="+Inf"' in ladder[-1][0]
            assert counts[-1] == samples[base + "_count"], base
        status, body = _get(srv.url + "/healthz")
        assert status == 200 and json.loads(body)["ready"] is True
    finally:
        eng.stop()
    assert not srv.running
    again = eng.serve_metrics()
    try:
        assert again is not srv and again.running
        status, body = _get(again.url + "/healthz")
        assert status == 503 and json.loads(body)["ready"] is False
    finally:
        again.stop()
    plain = serving.InferenceEngine(model_dir, device="cpu",
                                    batch_buckets=(2, 4), supervise=False)
    try:
        want = [plain.predict({"x": x}, timeout=30)[0] for x in xs]
    finally:
        plain.stop()
    assert [o.tobytes() for o in outs] == [w.tobytes() for w in want]
