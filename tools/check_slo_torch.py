#!/usr/bin/env python
"""Gate for the port's overload-resilient serving and its SLO monitor:
drive a real InferenceEngine through the chaos harness on the CPU and
fail loudly if any self-healing or SLO behavior regresses.  The port's
counterpart of ``tools/check_slo.py``, scenarios 1-4, with scenario 4
of ``tools/check_obs_export.py`` as its fifth.

Scenario 1 — self-healing under chaos (no hangs, bisection, retry,
  bitwise):
  preload a queue so one coalesced batch carries a POISON request among
  innocents, inject transient flaky_execute faults on top, then serve.
  Every admitted future must reach a terminal outcome (answer or typed
  error — never a hang), the poison request must fail alone while every
  innocent co-batched neighbor succeeds (serving.bisections > 0),
  transient faults must be retried to success (serving.retries > 0),
  and every successful answer must be bitwise-identical to the
  fault-free path.

Scenario 2 — circuit breaker:
  persistent fatal dispatch faults trip the breaker after N consecutive
  fatal batches: engine state reports "degraded", admission fast-fails
  with ServingDegraded (typed), and after the cooldown a half-open probe
  recovers the engine to "ready" with correct answers.

Scenario 3 — dead worker supervision:
  kill_worker murders the batcher thread mid-dispatch.  The in-flight
  request fails typed (not hangs), the supervisor restarts the worker
  (serving.worker_restarts > 0), queued requests admitted before the
  death are still answered, and the engine serves normally after.

Scenario 4 — deadline-aware admission shedding:
  with a warm service-rate estimate and a queued backlog, a request
  whose deadline cannot be met is rejected with ServingOverloaded
  BEFORE queueing (serving.shed_admission counts it), while the same
  request at interactive priority (empty higher lanes) is admitted.

Scenario 5 — SLO breach alerts + the autoscale signal:
  with declared per-class targets and an engine overloaded via a
  slow_execute shim, SLOMonitor.evaluate() must raise typed alert
  records (emitted to record sinks as type="slo_alert") and move
  serving.autoscale.desired_replicas above min_replicas; after the
  overload clears and a clean window passes, a fresh evaluation must
  report no new alerts and the signal must fall back.

Left out: the JAX package's scenario 5, ``benchmarks/bench_load.py
--smoke`` (the open-loop load harness is not ported), and the JAX
gate's limit on how fast a degraded engine fails (a time, which depends
on the host's load).

Runnable locally (the port only: no jax is imported):
    python tools/check_slo_torch.py
and run under pytest by tests/test_torch_slo_gate.py.

Exit code 0 = every scenario held.
"""
import os
import sys
import tempfile
import time

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


def engine(model_dir, **kw):
    from paddle_tpu_torch import serving

    kw.setdefault("batch_buckets", BUCKETS)
    return serving.InferenceEngine(model_dir, device="cpu", **kw)


def scenario_self_healing_chaos():
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.testing import faults

    rng = np.random.RandomState(0)
    payloads = [rng.randn(1, 16).astype(np.float32) for _ in range(24)]
    with tempfile.TemporaryDirectory() as td:
        save_model(os.path.join(td, "m"), seed=11)
        # fault-free reference, served sequentially
        ref = engine(os.path.join(td, "m"),
                                      batch_buckets=BUCKETS,
                                      supervise=False)
        want = [ref.predict({"x": p})[0] for p in payloads]
        ref.stop()

        eng = engine(
            os.path.join(td, "m"), batch_buckets=BUCKETS, max_batch_size=8,
            queue_capacity=64, autostart=False, supervise=False,
            breaker_threshold=50)  # breaker must not interfere here
        try:
            futs = [eng.predict_async({"x": p}) for p in payloads]
            poison_seq = futs[5].seq       # co-batched with 7 innocents
            r0 = obs.counter("serving.retries").value
            b0 = obs.counter("serving.bisections").value
            with faults.flaky_execute(times=2):
                with faults.poison_request(poison_seq):
                    eng.start()
                    results = {}
                    poison_error = None
                    for i, f in enumerate(futs):
                        # (a) no admitted request may hang: every future
                        # must resolve well inside the timeout
                        try:
                            results[i] = f.result(timeout=60)[0]
                        except Exception as e:  # noqa: BLE001 - typed below
                            if f.seq == poison_seq:
                                poison_error = e
                            else:
                                raise
            assert poison_error is not None, (
                "poison request was answered instead of failing")
            assert isinstance(poison_error, ValueError), poison_error
            # (b) innocents all answered, bitwise-equal to fault-free
            assert len(results) == len(payloads) - 1
            bad = [i for i, out in results.items()
                   if out.tobytes() != want[i].tobytes()]
            assert not bad, (
                "%d innocent answers differ from the fault-free path "
                "(first: %d)" % (len(bad), bad[0]))
            # (c) transient faults were retried to success
            n_retries = obs.counter("serving.retries").value - r0
            assert n_retries >= 2, "expected >=2 retries, saw %d" % n_retries
            # (d) the poison batch was bisected to isolate the poison
            n_bis = obs.counter("serving.bisections").value - b0
            assert n_bis > 0, "poison never triggered a bisection"
        finally:
            eng.stop()
    return ("self-healing chaos: %d/%d innocents bitwise-OK, poison "
            "isolated, %d retries, %d bisections OK"
            % (len(results), len(payloads), n_retries, n_bis))


def scenario_circuit_breaker():
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.testing import faults

    rng = np.random.RandomState(1)
    X = rng.randn(1, 16).astype(np.float32)
    with tempfile.TemporaryDirectory() as td:
        save_model(os.path.join(td, "m"), seed=13)
        with engine(
                os.path.join(td, "m"), batch_buckets=BUCKETS,
                supervise=False, breaker_threshold=3,
                breaker_cooldown_s=0.3) as eng:
            want = eng.predict({"x": X})[0]
            with faults.poison_request(lambda r: True):  # every batch fatal
                for _ in range(3):
                    try:
                        eng.predict({"x": X}, timeout=30)
                    except ValueError:
                        pass
                    else:
                        raise AssertionError("poisoned dispatch succeeded")
                assert eng.state == "degraded", eng.state
                assert not eng.ready()
                assert eng.health()["breaker"] == "open"
                try:
                    eng.predict_async({"x": X})
                except serving.ServingDegraded:
                    pass
                else:
                    raise AssertionError(
                        "degraded engine admitted a request")
            # faults removed; after the cooldown a half-open probe heals
            time.sleep(0.35)
            out = eng.predict({"x": X}, timeout=30)[0]
            assert out.tobytes() == want.tobytes()
            assert eng.state == "ready" and eng.ready()
            assert eng.health()["breaker"] == "closed"
    return ("circuit breaker: tripped to degraded after 3 fatal batches, "
            "typed fast-fail, half-open probe recovered OK")


def scenario_dead_worker_supervision():
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.testing import faults

    rng = np.random.RandomState(2)
    payloads = [rng.randn(1, 16).astype(np.float32) for _ in range(6)]
    with tempfile.TemporaryDirectory() as td:
        save_model(os.path.join(td, "m"), seed=21)
        with engine(
                os.path.join(td, "m"), batch_buckets=BUCKETS,
                max_batch_size=2, autostart=False,
                supervisor_interval_s=0.02) as eng:
            want = None
            r0 = obs.counter("serving.worker_restarts").value
            d0 = obs.counter("serving.worker_deaths").value
            with faults.kill_worker(at_dispatch=0):
                futs = [eng.predict_async({"x": p}) for p in payloads]
                eng.start()
                outcomes = []
                for f in futs:
                    # every future resolves: the first batch dies typed,
                    # the rest are answered after the supervisor restart
                    try:
                        outcomes.append(("ok", f.result(timeout=60)[0]))
                    except serving.ServingDegraded as e:
                        outcomes.append(("died", e))
            died = [o for o in outcomes if o[0] == "died"]
            ok = [o for o in outcomes if o[0] == "ok"]
            assert died, "no request saw the worker death"
            assert ok, "no request survived via the supervisor restart"
            assert obs.counter("serving.worker_deaths").value > d0
            # wait on the restart COUNTER: right after the futures
            # resolve, the dying thread can still be briefly alive, so
            # worker_alive alone can read True before the restart
            deadline = time.time() + 10
            while (time.time() < deadline
                   and obs.counter("serving.worker_restarts").value <= r0):
                time.sleep(0.02)
            assert obs.counter("serving.worker_restarts").value > r0, (
                "supervisor never restarted the worker")
            assert eng.health()["worker_alive"]
            # the restarted worker serves correctly
            want = eng.predict({"x": payloads[0]}, timeout=30)[0]
            assert want.shape == (1, 6)
    return ("dead worker: %d died typed, %d answered after restart, "
            "worker_alive recovered OK" % (len(died), len(ok)))


def scenario_admission_shedding():
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import serving

    rng = np.random.RandomState(3)
    X = rng.randn(1, 16).astype(np.float32)
    with tempfile.TemporaryDirectory() as td:
        save_model(os.path.join(td, "m"), seed=31)
        eng = engine(os.path.join(td, "m"),
                                      batch_buckets=BUCKETS,
                                      autostart=False, supervise=False)
        try:
            # warm the estimator to a known rate, then build a backlog
            eng._queue.note_service(rows=100, seconds=1.0)  # 100 rows/s
            backlog = [eng.predict_async({"x": X}) for _ in range(20)]
            # 20 rows ahead at 100 rows/s ~= 200ms; a 20ms deadline is
            # unmeetable -> shed at admission, BEFORE queueing
            s0 = obs.counter("serving.shed_admission").value
            try:
                eng.predict_async({"x": X}, deadline_ms=20)
            except serving.ServingOverloaded:
                pass
            else:
                raise AssertionError("doomed deadline was admitted")
            assert obs.counter("serving.shed_admission").value == s0 + 1
            # the SAME doomed 20ms deadline at interactive class: the
            # backlog sits in lower lanes, so the per-class estimate is
            # ~0 and the request is ADMITTED — this is the contract
            # under test (a regression that sums all lanes would shed
            # it).  It may still expire at pop time on a slow box;
            # admission, not completion, is the assertion.
            fast = eng.predict_async({"x": X}, deadline_ms=20,
                                     priority="interactive")
            assert obs.counter("serving.shed_admission").value == s0 + 1
            eng.start()
            try:
                assert fast.result(timeout=30)[0].shape == (1, 6)
            except serving.ServingTimeout:
                pass  # expired in queue on a slow box; admission held
            for f in backlog:
                f.result(timeout=30)
        finally:
            eng.stop()
    return ("admission shedding: doomed deadline rejected with "
            "ServingOverloaded pre-queue, interactive lane admitted OK")


def scenario_slo_monitor():
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.testing import faults

    tel = obs.get_telemetry()
    sink = obs.RingBufferSink(capacity=4096)
    tel.add_sink(sink)
    rng = np.random.RandomState(13)
    payloads = [rng.randn(1, 16).astype(np.float32) for _ in range(24)]
    try:
        with tempfile.TemporaryDirectory() as td:
            save_model(os.path.join(td, "m"), seed=17)
            eng = engine(
                os.path.join(td, "m"), batch_buckets=BUCKETS,
                max_batch_size=2, queue_capacity=256, autostart=False,
                supervise=False)
            monitor = obs.SLOMonitor(
                [obs.SLOTarget("batch", goodput=0.9, p99_ms=1.0,
                               min_requests=5)],
                engine=eng, window_s=60.0, drain_target_s=0.05,
                min_replicas=1, max_replicas=16)
            try:
                # overload: 20ms per 2-row dispatch, deadlines most
                # requests will miss -> goodput AND p99 breaches
                with faults.slow_execute(0.02):
                    futs = [eng.predict_async({"x": p}, deadline_ms=40)
                            for p in payloads]
                    eng.start()
                    done = 0
                    for f in futs:
                        try:
                            f.result(timeout=60)
                            done += 1
                        except serving.ServingTimeout:
                            pass
                    # a deadline lapsing DURING result() raises on the
                    # caller side while the request is still queued; the
                    # terminal outcome (the pop-time shed that feeds the
                    # per-class counters) lands when the worker reaches
                    # it — wait for every admitted request to terminate
                    # before reading the window
                    deadline = time.time() + 60
                    while (time.time() < deadline
                           and not all(f.done() for f in futs)):
                        time.sleep(0.01)
                    assert all(f.done() for f in futs), "requests hung"
                    report = monitor.evaluate()
            finally:
                eng.stop()
        entry = report["per_class"]["batch"]
        assert entry["attempts"] == len(payloads), entry
        assert report["alerts"], "overload raised no SLO alert"
        kinds = {a.kind for a in report["alerts"]}
        assert "goodput" in kinds or "p99_ms" in kinds, kinds
        a = report["alerts"][0]
        assert a.priority == "batch" and a.target is not None
        # the typed alert also lands on record sinks as a structured
        # slo_alert record
        recs = [r for r in sink.records if r.get("type") == "slo_alert"]
        assert recs and recs[0]["priority"] == "batch"
        assert obs.counter("serving.slo.alerts").value >= len(
            report["alerts"])
        # the autoscale signal moved: a breached window floors desired
        # replicas above min even once the backlog has drained
        desired = report["desired_replicas"]
        assert desired > 1, desired
        assert obs.gauge(
            "serving.autoscale.desired_replicas").value == desired
        # per-class gauges the export plane serves live
        assert obs.gauge("serving.slo.goodput_batch").value == entry[
            "goodput"]
        # a clean window (no new traffic, no breach) relaxes the signal
        clean = monitor.evaluate()
        assert not clean["alerts"]
        assert clean["desired_replicas"] == 1, clean["desired_replicas"]
    finally:
        tel.remove_sink(sink)
    return ("SLO monitor: %d alerts (%s) on overload, desired_replicas "
            "%d -> %d after clean window OK"
            % (len(report["alerts"]), "/".join(sorted(kinds)), desired,
               clean["desired_replicas"]))


def main():
    failures = []
    for scenario in (scenario_self_healing_chaos,
                     scenario_circuit_breaker,
                     scenario_dead_worker_supervision,
                     scenario_admission_shedding,
                     scenario_slo_monitor):
        try:
            msg = scenario()
        except AssertionError as e:
            failures.append("%s FAILED: %s" % (scenario.__name__, e))
        else:
            print(msg)
    if failures:
        for f in failures:
            sys.stderr.write(f + "\n")
        sys.stderr.write("\nSLO gate FAILED\n")
        return 1
    print("SLO gate OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
