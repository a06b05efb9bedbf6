#!/usr/bin/env python
"""Gate for the port's predict serving (``paddle_tpu_torch.serving``):
drive a real InferenceEngine on the CPU and fail loudly on any
correctness, behavior, or telemetry regression.  The port's counterpart
of ``tools/check_serving.py``, scenarios 1-4.

Scenario 1 — bitwise batched-vs-unbatched equality:
  concurrent mixed-size requests through a coalescing engine must come
  back bitwise-identical to the same requests served one at a time, on
  BOTH backends (the Program and the torch.export artifact), and
  coalescing must actually have happened.

Scenario 2 — deadlines and backpressure:
  a full bounded queue rejects with ServingQueueFull (and counts it), a
  request whose deadline expires in queue is shed with ServingTimeout
  (and counts), everything still live is answered, and a stopped engine
  rejects with ServingClosed.

Scenario 3 — hot swap with drain:
  swapping model versions under concurrent client load must answer every
  request (each bitwise-equal to exactly one version's output), serve
  the new version after the swap, keep the engine ready throughout, and
  reject a swap to an incompatible model without disturbing serving.

Scenario 4 — serving telemetry schema:
  a real serve run must populate the serving.* registry names
  (queue-depth gauge, request/batch/bucket counters, queue-wait/execute/
  model-load/warm-up timers), emit per-request and per-batch spans,
  stream serve_batch records to record sinks, and write a Chrome trace
  holding the request and execute spans.

The JAX package's scenario 5, a >= 2x requests/s timing smoke, depends
on the host's load and is not part of this CPU gate; ``chip_smoke.py``
measures batched against unbatched serving on the card instead.

Runnable locally (the port only: no jax is imported):
    python tools/check_serving_torch.py
and run under pytest by tests/test_torch_serving_gate.py.

Exit code 0 = every scenario held.
"""
import json
import os
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

BUCKETS = (2, 4, 8)
DEVICE = "cpu"


def save_model(dirname, seed, aot=False):
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
                                      main_program=main, aot=aot)
    return dirname


def engine(model_dir, **kw):
    from paddle_tpu_torch import serving

    kw.setdefault("batch_buckets", BUCKETS)
    return serving.InferenceEngine(model_dir, device=DEVICE, **kw)


def _requests(n, rng):
    """Mixed-size request payloads (1-3 rows each)."""
    return [rng.randn(rng.randint(1, 4), 16).astype(np.float32)
            for _ in range(n)]


def _serve_concurrent(eng, payloads, n_threads=4):
    results = [None] * len(payloads)
    errors = []

    def client(lo, hi):
        try:
            for i in range(lo, hi):
                results[i] = eng.predict({"x": payloads[i]}, timeout=60)[0]
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    per = (len(payloads) + n_threads - 1) // n_threads
    threads = [threading.Thread(target=client,
                                args=(t * per, min((t + 1) * per,
                                                   len(payloads))))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    if errors:
        raise errors[0]
    assert not any(t.is_alive() for t in threads), "a client hung"
    return results


def scenario_bitwise_batched_vs_unbatched():
    from paddle_tpu_torch import observability as obs

    rng = np.random.RandomState(0)
    payloads = _requests(48, rng)
    checked = []
    with tempfile.TemporaryDirectory() as td:
        save_model(os.path.join(td, "m"), seed=11, aot=True)
        for backend in ("program", "aot"):
            batched = engine(os.path.join(td, "m"), backend=backend,
                             queue_capacity=128)
            # the unbatched baseline: the same engine config driven
            # strictly sequentially — one request in flight means the
            # batcher has nothing to coalesce
            unbatched = engine(os.path.join(td, "m"), backend=backend)
            try:
                assert batched.health()["backend"] == backend
                b0 = obs.counter("serving.batches").value
                got = _serve_concurrent(batched, payloads)
                n_batches = obs.counter("serving.batches").value - b0
                assert n_batches < len(payloads), (
                    "%s: batcher never coalesced (%d batches for %d "
                    "requests)" % (backend, n_batches, len(payloads)))
                want = [unbatched.predict({"x": p})[0] for p in payloads]
                bad = [i for i in range(len(payloads))
                       if got[i].tobytes() != want[i].tobytes()]
                assert not bad, (
                    "%s: %d/%d requests differ batched vs unbatched "
                    "(first: %d)" % (backend, len(bad), len(payloads),
                                     bad[0]))
                checked.append("%s (%d batches/%d reqs)"
                               % (backend, n_batches, len(payloads)))
            finally:
                batched.stop()
                unbatched.stop()
    return "bitwise batched == unbatched: %s OK" % "; ".join(checked)


def scenario_deadline_backpressure():
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import serving

    rng = np.random.RandomState(1)
    x1 = rng.randn(1, 16).astype(np.float32)
    with tempfile.TemporaryDirectory() as td:
        save_model(os.path.join(td, "m"), seed=13)
        eng = engine(os.path.join(td, "m"), queue_capacity=4,
                     autostart=False)
        try:
            full0 = obs.counter("serving.queue_full").value
            exp0 = obs.counter("serving.expired").value
            live = [eng.predict_async({"x": x1}) for _ in range(3)]
            doomed = eng.predict_async({"x": x1}, deadline_ms=5)
            try:
                eng.predict_async({"x": x1})
            except serving.ServingQueueFull:
                pass
            else:
                raise AssertionError("5th request admitted past capacity 4")
            assert obs.counter("serving.queue_full").value == full0 + 1
            time.sleep(0.05)  # the doomed request's deadline passes in queue
            eng.start()
            for f in live:
                out = f.result(timeout=30)
                assert out[0].shape == (1, 6)
            try:
                doomed.result(timeout=30)
            except serving.ServingTimeout:
                pass
            else:
                raise AssertionError("expired request was still answered")
            assert obs.counter("serving.expired").value == exp0 + 1
            depth = obs.gauge("serving.queue_depth").value
            assert depth == 0, "queue depth gauge stuck at %r" % (depth,)
        finally:
            eng.stop()
        try:
            eng.predict({"x": x1})
        except serving.ServingClosed:
            pass
        else:
            raise AssertionError("stopped engine accepted a request")
    return ("deadlines/backpressure: queue-full rejected, expired shed, "
            "live answered, stopped closed OK")


def scenario_hot_swap():
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import serving

    rng = np.random.RandomState(2)
    payloads = _requests(60, rng)
    with tempfile.TemporaryDirectory() as td:
        d1 = save_model(os.path.join(td, "v1"), seed=21)
        d2 = save_model(os.path.join(td, "v2"), seed=22)
        # reference outputs per version, served sequentially (unbatched)
        ref = engine(d1)
        want_v1 = [ref.predict({"x": p})[0] for p in payloads]
        ref.stop()
        ref = engine(d2)
        want_v2 = [ref.predict({"x": p})[0] for p in payloads]
        ref.stop()

        eng = engine(d1)
        try:
            v1 = eng.model_version
            results = [None] * len(payloads)
            swap_states = []

            def client(lo, hi):
                for i in range(lo, hi):
                    results[i] = eng.predict({"x": payloads[i]},
                                             timeout=60)[0]

            threads = [threading.Thread(target=client,
                                        args=(t * 15, (t + 1) * 15))
                       for t in range(4)]
            for t in threads:
                t.start()
            new_version = eng.swap_model(d2)
            swap_states.append(eng.state)
            for t in threads:
                t.join(timeout=120)
            assert new_version > v1 and eng.model_version == new_version
            assert eng.ready() and swap_states == ["ready"]
            # every in-flight answer is exactly one version's output
            for i, r in enumerate(results):
                assert r is not None, "request %d dropped across swap" % i
                rb = r.tobytes()
                assert rb in (want_v1[i].tobytes(), want_v2[i].tobytes()), (
                    "request %d matches neither version's output" % i)
            # steady state after the swap: pure v2
            after = _serve_concurrent(eng, payloads)
            bad = [i for i in range(len(payloads))
                   if after[i].tobytes() != want_v2[i].tobytes()]
            assert not bad, ("post-swap request %d not served by v2"
                             % bad[0])
            # incompatible model: swap refused, serving undisturbed
            d3 = os.path.join(td, "bad")
            main, startup = fluid.Program(), fluid.Program()
            with fluid.unique_name.guard(), \
                    fluid.program_guard(main, startup):
                y = fluid.layers.data(name="other", shape=[4],
                                      dtype="float32")
                out = fluid.layers.fc(y, size=2)
            exe = fluid.Executor(fluid.CPUPlace())
            with fluid.scope_guard(fluid.Scope()):
                exe.run(startup)
                fluid.io.save_inference_model(d3, ["other"], [out], exe,
                                              main_program=main)
            try:
                eng.swap_model(d3)
            except serving.ServingError:
                pass
            else:
                raise AssertionError("swap to incompatible model accepted")
            assert eng.ready() and eng.model_version == new_version
            still = eng.predict({"x": payloads[0]})[0]
            assert still.tobytes() == want_v2[0].tobytes()
        finally:
            eng.stop()
    return ("hot swap: v1->v2 under load, no drops, post-swap pure v2, "
            "incompatible swap refused OK")


def scenario_telemetry_schema():
    from paddle_tpu_torch import observability as obs

    rng = np.random.RandomState(3)
    payloads = _requests(32, rng)
    sink = obs.RingBufferSink(record_spans=True)
    with tempfile.TemporaryDirectory() as td:
        save_model(os.path.join(td, "m"), seed=31)
        trace_path = os.path.join(td, "trace.json")
        trace = obs.ChromeTraceSink(trace_path)
        obs.add_sink(sink)
        obs.add_sink(trace)
        c0 = {n: obs.counter("serving.%s" % n).value
              for n in ("requests", "batches", "batched_rows",
                        "padded_rows")}
        b0 = {b: obs.counter("serving.batch_bucket_%d" % b).value
              for b in BUCKETS}
        try:
            eng = engine(os.path.join(td, "m"))
            try:
                _serve_concurrent(eng, payloads)
            finally:
                eng.stop()
        finally:
            obs.remove_sink(sink)
            obs.remove_sink(trace)
            trace.close()
        with open(trace_path) as f:
            trace_json = json.load(f)
    n_req = obs.counter("serving.requests").value - c0["requests"]
    n_batch = obs.counter("serving.batches").value - c0["batches"]
    n_rows = obs.counter("serving.batched_rows").value - c0["batched_rows"]
    assert n_req == len(payloads), (n_req, len(payloads))
    assert 0 < n_batch <= n_req
    assert n_rows == sum(p.shape[0] for p in payloads)
    bucket_counts = {
        b: obs.counter("serving.batch_bucket_%d" % b).value - b0[b]
        for b in BUCKETS}
    assert sum(bucket_counts.values()) == n_batch, (
        "bucket histogram %s does not sum to %d batches"
        % (bucket_counts, n_batch))
    for tname in ("serving.queue_wait", "serving.execute",
                  "serving.model_load", "serving.warmup"):
        stats = obs.timer(tname).stats()
        assert stats and stats[0] > 0, "timer %s never observed" % tname
    assert obs.gauge("serving.queue_depth").value == 0
    span_names = {s["name"] for s in sink.spans}
    assert {"serving.execute", "serving.request", "serving.queue_wait",
            "serving.batch"} <= span_names, span_names
    n_req_spans = sum(1 for s in sink.spans if s["name"] == "serving.request")
    assert n_req_spans == len(payloads), (n_req_spans, len(payloads))
    recs = [r for r in sink.records if r.get("type") == "serve_batch"]
    assert len(recs) == n_batch
    for r in recs:
        for k in ("ts", "bucket", "rows", "requests", "padded",
                  "model_version", "queue_depth"):
            assert k in r, "serve_batch record missing %r: %s" % (k, r)
    # the Chrome trace (loads in Perfetto): the request and execute spans
    tspans = [e for e in trace_json["traceEvents"] if e.get("ph") == "X"]
    assert any(e["name"] == "serving.request" for e in tspans)
    assert any(e["name"] == "serving.execute" for e in tspans)
    return ("serving telemetry: %d requests / %d batches, bucket histogram "
            "consistent, timers+spans+records+trace flowing OK"
            % (n_req, n_batch))


def main():
    failures = []
    for scenario in (scenario_bitwise_batched_vs_unbatched,
                     scenario_deadline_backpressure,
                     scenario_hot_swap,
                     scenario_telemetry_schema):
        try:
            msg = scenario()
        except AssertionError as e:
            failures.append("%s FAILED: %s" % (scenario.__name__, e))
        else:
            print(msg, flush=True)
    if "jax" in sys.modules:
        failures.append("the gate imported jax")
    if failures:
        for f in failures:
            sys.stderr.write(f + "\n")
        sys.stderr.write("\nserving gate FAILED\n")
        return 1
    print("serving gate OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
