#!/usr/bin/env python
"""Gate for the port's observability export plane: histogram quantiles,
the /metrics + /healthz endpoint and request-scoped tracing, driven
against a real InferenceEngine on the CPU.  The port's counterpart of
``tools/check_obs_export.py``, scenarios 1-3.

Scenario 1 — histogram quantile accuracy:
  a log-bucketed Histogram fed a deterministic lognormal latency sample
  must estimate p50/p90/p95/p99 within the bucket-growth error bound
  (growth 1.25 -> <=25% relative error) of numpy's exact percentiles,
  snapshot merge (a + b) must equal the histogram of the concatenated
  sample, and windowed delta (after - before) must reproduce the
  window's own distribution exactly.

Scenario 2 — /metrics + /healthz export:
  ``InferenceEngine.serve_metrics`` must serve Prometheus text
  exposition that PARSES strictly, includes the serving histogram bucket
  ladders with monotone nondecreasing cumulative counts ending at
  ``le="+Inf"`` == ``_count``, and /healthz must serve the engine's
  health() JSON with 200 while ready; ``stop()`` takes the endpoint
  down, and a ``serve_metrics`` after the stop opens a fresh one that
  answers 503.

Scenario 3 — trace-context propagation under load with retries:
  requests served under overload with flaky_execute injected must each
  yield ONE trace tree: every request's trace id resolves to a root
  ``serving.request`` span whose tree contains queue-wait, batch, and
  execute spans, and the requests riding the faulted dispatches also
  carry retry spans — all attributed to that request's trace id, with
  parent links intact.

The JAX package's scenario 4 (SLO alerts and the autoscale signal) is
scenario 5 of ``tools/check_slo_torch.py``; its scenario 5, a per-call
time budget, depends on the host's load and is not part of this CPU
gate.

Runnable locally (the port only: no jax is imported):
    python tools/check_obs_export_torch.py
and run under pytest by tests/test_torch_obs_export_gate.py.

Exit code 0 = every scenario held.
"""
import json
import os
import sys
import tempfile
import urllib.error
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

BUCKETS = (2, 4, 8)

def save_model(dirname, seed):
    import paddle_tpu_torch as fluid

    main = fluid.Program()
    startup = fluid.Program()
    startup.random_seed = seed
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


def scenario_histogram_accuracy():
    from paddle_tpu_torch import observability as obs

    rng = np.random.RandomState(7)
    # lognormal latencies spanning ~0.5ms .. ~2s — a realistic tail
    sample = np.exp(rng.normal(loc=-4.0, scale=1.5, size=20000))
    h = obs.Histogram("gate.lat")
    for v in sample:
        h.observe(v)
    snap = h.snapshot()
    assert snap.count == len(sample)
    worst = 0.0
    for q in (0.50, 0.90, 0.95, 0.99):
        est = snap.quantile(q)
        exact = float(np.percentile(sample, q * 100))
        rel = abs(est - exact) / exact
        worst = max(worst, rel)
        # growth=1.25 bounds the estimate within one bucket of the true
        # quantile: <=25% relative error by construction
        assert rel <= 0.25, (
            "q%.2f estimate %.6g vs exact %.6g: rel err %.1f%% > 25%%"
            % (q, est, exact, rel * 100))
    # merge law: hist(a) + hist(b) == hist(a ++ b), bucket-exact
    a_s, b_s = sample[:12000], sample[12000:]
    ha, hb, hab = (obs.Histogram(n) for n in ("gate.a", "gate.b", "gate.ab"))
    for v in a_s:
        ha.observe(v)
    for v in b_s:
        hb.observe(v)
    for v in sample:
        hab.observe(v)
    merged = ha.snapshot() + hb.snapshot()
    want = hab.snapshot()
    assert merged.counts == want.counts and merged.count == want.count
    assert abs(merged.sum - want.sum) < 1e-6 * max(1.0, want.sum)
    # window law: (cumulative after) - (cumulative before) == the
    # window's own distribution, bucket-exact
    before = hab.snapshot()
    window = np.exp(rng.normal(loc=-2.0, scale=0.5, size=5000))
    hw = obs.Histogram("gate.w")
    for v in window:
        hab.observe(v)
        hw.observe(v)
    delta = hab.snapshot() - before
    assert delta.counts == hw.snapshot().counts
    assert delta.count == len(window)
    dq = delta.quantile(0.95)
    wq = float(np.percentile(window, 95))
    assert abs(dq - wq) / wq <= 0.25, (dq, wq)
    return ("histogram accuracy: worst rel err %.1f%% (<=25%% bound), "
            "merge + window laws bucket-exact OK" % (worst * 100))


def _parse_prometheus(text):
    """Strict exposition parse via the shared library parser (it moved to
    observability.export so the scrape-driven autoscaler uses the same
    code); re-raised as AssertionError so a malformed exposition is
    reported as a scenario failure like every other gate assert."""
    from paddle_tpu_torch.observability import parse_prometheus

    try:
        return parse_prometheus(text)
    except ValueError as e:
        raise AssertionError(str(e))


def scenario_metrics_export():
    from paddle_tpu_torch import serving

    rng = np.random.RandomState(11)
    payloads = [rng.randn(1, 16).astype(np.float32) for _ in range(12)]
    with tempfile.TemporaryDirectory() as td:
        save_model(os.path.join(td, "m"), seed=5)
        eng = serving.InferenceEngine(os.path.join(td, "m"),
                                      batch_buckets=BUCKETS,
                                      supervise=False, device="cpu")
        try:
            for p in payloads:
                eng.predict({"x": p}, timeout=30)
            srv = eng.serve_metrics()
            assert eng.serve_metrics() is srv   # idempotent
            body = urllib.request.urlopen(srv.url + "/metrics",
                                          timeout=10).read().decode()
            samples = _parse_prometheus(body)
            # the serving histograms must expose full bucket ladders
            for base in ("paddle_tpu_serving_queue_wait_seconds",
                         "paddle_tpu_serving_execute_seconds",
                         "paddle_tpu_serving_request_latency_batch_seconds"):
                ladder = [(k, v) for k, v in samples.items()
                          if k.startswith(base + "_bucket")]
                assert ladder, "no bucket ladder for %s" % base
                # cumulative counts, sorted by le, must be monotone and
                # end (le="+Inf") at _count
                def le_of(key):
                    return float(key.split('le="')[1].split('"')[0]
                                 .replace("Inf", "inf"))
                ladder.sort(key=lambda kv: le_of(kv[0]))
                counts = [v for _, v in ladder]
                assert counts == sorted(counts), base
                assert le_of(ladder[-1][0]) == float("inf")
                assert counts[-1] == samples[base + "_count"], base
            assert samples["paddle_tpu_serving_requests_total"] >= len(
                payloads)
            with urllib.request.urlopen(srv.url + "/healthz",
                                        timeout=10) as resp:
                assert resp.status == 200
                health = json.loads(resp.read().decode())
            assert health["ready"] is True
            assert health["state"] == "ready"
            assert health["model_version"] is not None
            assert srv.scrapes >= 1
        finally:
            eng.stop()
        # the engine tears its exporter down with it (port released)
        assert not srv.running
        # after the stop the engine's health says not ready: a fresh
        # endpoint over it answers 503, so the same endpoint doubles as
        # the load-balancer readiness probe
        again = eng.serve_metrics()
        try:
            assert again is not srv and again.running
            try:
                urllib.request.urlopen(again.url + "/healthz", timeout=10)
            except urllib.error.HTTPError as e:
                assert e.code == 503, e.code
                assert json.loads(e.read().decode())["ready"] is False
            else:
                raise AssertionError("a stopped engine answered 200")
        finally:
            again.stop()
        return ("metrics export: %d exposition samples parsed, bucket "
                "ladders monotone, healthz ready/503 probe OK"
                % len(samples))


def scenario_trace_propagation():
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.testing import faults

    tel = obs.get_telemetry()
    sink = obs.RingBufferSink(capacity=16384, record_spans=True)
    tel.add_sink(sink)
    rng = np.random.RandomState(3)
    payloads = [rng.randn(1, 16).astype(np.float32) for _ in range(16)]
    try:
        with tempfile.TemporaryDirectory() as td:
            save_model(os.path.join(td, "m"), seed=9)
            eng = serving.InferenceEngine(
                os.path.join(td, "m"), batch_buckets=BUCKETS,
                max_batch_size=8, autostart=False, supervise=False,
                breaker_threshold=50, device="cpu")
            try:
                # preload the queue so dispatches coalesce (overload),
                # then serve with transient faults on the first two
                # attempts: the co-batched requests ride the retries
                futs = [eng.predict_async({"x": p}) for p in payloads]
                with faults.flaky_execute(times=2) as fired:
                    eng.start()
                    for f in futs:
                        f.result(timeout=60)
                assert fired[0] == 2
            finally:
                eng.stop()
        spans = sink.spans
        traces = set()
        for f in futs:
            assert f.trace is not None, "admitted request lost its trace"
            traces.add(f.trace.trace_id)
        assert len(traces) == len(futs), "trace ids must be per-request"
        n_retry_trees = 0
        for f in futs:
            roots, nodes = obs.build_trace_tree(spans, f.trace.trace_id)
            # exactly one root: the serving.request span emitted at the
            # terminal outcome; every other event hangs under it
            assert len(roots) == 1, (
                "trace %s has %d roots" % (f.trace.trace_id, len(roots)))
            root = roots[0]
            assert root["span"]["name"] == "serving.request"
            assert root["span"]["tags"]["seq"] == f.seq
            names = {n["span"]["name"] for n in nodes.values()}
            for must in ("serving.request", "serving.queue_wait",
                         "serving.batch", "serving.execute"):
                assert must in names, (
                    "trace %s missing %s (has %s)"
                    % (f.trace.trace_id, must, sorted(names)))
            # parent links: every non-root node's parent is captured
            # and is part of the same trace
            for node in nodes.values():
                pid = node["span"]["tags"].get("parent_id")
                if pid is not None:
                    assert pid in nodes or pid == root["span"][
                        "tags"]["span_id"], pid
            if "serving.retry" in names:
                n_retry_trees += 1
        # the first coalesced dispatch carried the faults; each of its
        # requests must show the retry in ITS OWN tree
        assert n_retry_trees >= 2, (
            "expected >=2 requests attributed retry spans, got %d"
            % n_retry_trees)
    finally:
        tel.remove_sink(sink)
    return ("trace propagation: %d per-request trees, all with queue-wait"
            "/batch/execute under one root, %d carrying retry spans OK"
            % (len(futs), n_retry_trees))


def main():
    failures = []
    for scenario in (scenario_histogram_accuracy,
                     scenario_metrics_export,
                     scenario_trace_propagation):
        try:
            msg = scenario()
        except AssertionError as e:
            failures.append("%s FAILED: %s" % (scenario.__name__, e))
        else:
            print(msg)
    if failures:
        for f in failures:
            sys.stderr.write(f + "\n")
        sys.stderr.write("\nobservability export gate FAILED\n")
        return 1
    print("observability export gate OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
