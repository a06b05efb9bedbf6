#!/usr/bin/env python
"""Gate for the port's multi-replica serving (``paddle_tpu_torch.serving.
ReplicaPool``): drive a real pool of replicas on the CPU
(``devices=["cpu"]``: every replica on the one device, as every replica
shares ``cuda:0`` on one card) and fail loudly if bitwise identity,
scaling, the rolling swap or replica self-healing regresses.  The port's
counterpart of ``tools/check_replica_pool.py``, its scenarios 1-4.

Scenario 1 — bitwise identity:
  per-request outputs from a 4-replica pool are bitwise-identical to the
  single-replica InferenceEngine, whichever replica serves them, on BOTH
  model backends (program and AOT) and across mixed row counts.

Scenario 2 — throughput scaling:
  one warm pool, closed-loop clients, the slow_execute service-delay
  shim (dispatch cost = a sleep, which releases the GIL, so the number is
  machine-independent): rotation resized 1 -> 4 via set_active_replicas,
  aggregate requests/s at N=4 must be >= 2.5x N=1.

Scenario 3 — rolling hot swap under live traffic:
  open-loop submitters keep the pool busy while swap_model() flips every
  replica to v2 one at a time.  Every future resolves with a result
  (zero failed / zero hung), a sampler thread never observes
  ready_replicas() == 0, health() reports the new version on every
  replica, and post-swap answers are bitwise-identical to a reference
  engine serving v2.

Scenario 4 — replica kill / eject / revive:
  kill_worker murders one replica's batcher thread mid-dispatch.  The
  in-flight batch fails typed (never hangs), every OTHER queued request
  is absorbed by the surviving replicas, the supervisor restarts the
  dead worker (serving.worker_restarts advances), and the revived
  replica provably claims work again.

Left out: the JAX gate's scenario 5 drives
``benchmarks/bench_load.py --scaling --smoke`` (open-loop goodput at
rotation 1/2/4) in a subprocess; the benchmarks folder is not ported,
and ``chip_smoke.py``'s pool phase measures the pool on the card.

Runnable locally (the port only: no jax is imported):
    python tools/check_replica_pool_torch.py
and run under pytest by tests/test_torch_replica_gate.py.

Exit code 0 = every scenario held.
"""
import os
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

BUCKETS = (2, 4, 8)
WIDTH = 16
DEVICES = ["cpu"]


def save_model(dirname, seed, aot=False):
    import paddle_tpu_torch as fluid

    main = fluid.Program()
    startup = fluid.Program()
    startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[WIDTH], dtype="float32")
        h = fluid.layers.fc(x, size=32, act="relu")
        out = fluid.layers.fc(h, size=6, act="softmax")
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.io.save_inference_model(dirname, ["x"], [out], exe,
                                      main_program=main, aot=aot)
    return dirname


def _engine(d, **kw):
    from paddle_tpu_torch import serving

    return serving.InferenceEngine(d, batch_buckets=BUCKETS, device="cpu",
                                   supervise=False, **kw)


def _pool(d, replicas=4, **kw):
    from paddle_tpu_torch import serving

    kw.setdefault("batch_buckets", BUCKETS)
    return serving.ReplicaPool(d, replicas=replicas, devices=DEVICES, **kw)


def scenario_bitwise_vs_engine():
    rng = np.random.RandomState(0)
    # mixed row counts: exercises every bucket and the pad path
    payloads = [rng.randn(rng.randint(1, 6), WIDTH).astype(np.float32)
                for _ in range(32)]
    msgs = []
    with tempfile.TemporaryDirectory() as td:
        for backend, aot in (("program", False), ("aot", True)):
            d = save_model(os.path.join(td, backend), seed=11, aot=aot)
            ref = _engine(d, backend=backend)
            want = [ref.predict({"x": p})[0] for p in payloads]
            ref.stop()
            with _pool(d, backend=backend, batch_timeout_ms=1.0) as pool:
                futs = [pool.predict_async({"x": p}) for p in payloads]
                got = [f.result(timeout=60)[0] for f in futs]
                stats = pool.replica_stats()
            used = [s["index"] for s in stats if s["dispatches"] > 0]
            assert len(used) >= 2, (
                "pool never fanned out (%s): dispatches %s"
                % (backend, [(s["index"], s["dispatches"]) for s in stats]))
            bad = [i for i, (g, w) in enumerate(zip(got, want))
                   if g.tobytes() != w.tobytes()]
            assert not bad, (
                "%d pooled answers differ from the single-replica engine "
                "(%s backend; first: %d)" % (len(bad), backend, bad[0]))
            msgs.append("%s %d/%d bitwise over %d replicas"
                        % (backend, len(got), len(payloads), len(used)))
    return "bitwise vs engine: " + ", ".join(msgs) + " OK"


def _closed_loop_rate(pool, seconds, n_threads=4, depth=8):
    rng = np.random.RandomState(99)
    payloads = [rng.randn(1, WIDTH).astype(np.float32) for _ in range(64)]
    stop = time.perf_counter() + seconds
    counts = [0] * n_threads
    errors = []

    def client(t):
        try:
            while time.perf_counter() < stop:
                futs = [pool.predict_async({"x": payloads[(t + k) % 64]})
                        for k in range(depth)]
                for f in futs:
                    f.result(timeout=60)
                counts[t] += depth
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "a client hung"
    if errors:
        raise errors[0]
    return sum(counts) / (time.perf_counter() - t0)


def scenario_throughput_scaling():
    from paddle_tpu_torch.testing import faults

    with tempfile.TemporaryDirectory() as td:
        d = save_model(os.path.join(td, "m"), seed=13)
        with _pool(d, initial_replicas=1, max_batch_size=8,
                   batch_timeout_ms=0.0, queue_capacity=256) as pool:
            with faults.slow_execute(0.02):
                r1 = _closed_loop_rate(pool, seconds=1.0)
                assert pool.set_active_replicas(4) == 4
                r4 = _closed_loop_rate(pool, seconds=1.0)
    speedup = r4 / r1
    assert speedup >= 2.5, (
        "pooled throughput only %.2fx single-replica (%.0f vs %.0f "
        "req/s); floor is 2.5x" % (speedup, r4, r1))
    return ("throughput scaling: %.0f -> %.0f req/s at 1 -> 4 replicas "
            "(%.2fx >= 2.5x) OK" % (r1, r4, speedup))


def scenario_rolling_swap_live():
    from paddle_tpu_torch import serving

    rng = np.random.RandomState(2)
    payloads = [rng.randn(1, WIDTH).astype(np.float32) for _ in range(64)]
    with tempfile.TemporaryDirectory() as td:
        d1 = save_model(os.path.join(td, "v1"), seed=21)
        d2 = save_model(os.path.join(td, "v2"), seed=22)
        ref = _engine(d2)
        want_v2 = [ref.predict({"x": p})[0] for p in payloads]
        ref.stop()

        pool = _pool(d1, batch_timeout_ms=0.5, queue_capacity=512)
        stop_evt = threading.Event()
        min_ready = [pool.ready_replicas()]
        futs, submit_errors = [], []
        futs_lock = threading.Lock()

        def sampler():
            while not stop_evt.is_set():
                min_ready[0] = min(min_ready[0], pool.ready_replicas())
                time.sleep(0.002)

        def submitter(t):
            i = 0
            while not stop_evt.is_set():
                try:
                    f = pool.predict_async({"x": payloads[(t * 7 + i) % 64]})
                except serving.ServingQueueFull:
                    time.sleep(0.005)
                    continue
                except Exception as e:  # noqa: BLE001 - surfaced below
                    submit_errors.append(e)
                    return
                with futs_lock:
                    futs.append(f)
                i += 1
                time.sleep(0.001)

        threads = [threading.Thread(target=sampler)] + [
            threading.Thread(target=submitter, args=(t,)) for t in range(3)]
        try:
            for t in threads:
                t.start()
            time.sleep(0.2)              # traffic flowing on v1
            v = pool.swap_model(d2)      # ROLLING: one replica at a time
            time.sleep(0.2)              # traffic flowing on v2
        finally:
            stop_evt.set()
            for t in threads:
                t.join(timeout=60)
        try:
            assert not submit_errors, (
                "admission failed mid-swap: %r" % submit_errors[0])
            # the pool's store numbers each replica's loads: v1, then v2
            assert v == 2 and pool.model_version == 2, v
            h = pool.health()
            assert h["model_versions"] == [2], h["model_versions"]
            # zero failed / zero hung: every admitted future resolves
            # with a real result
            n_live = 0
            for f in futs:
                out = f.result(timeout=60)   # raises on a failed future
                assert out[0].shape[0] >= 1
                n_live += 1
            # capacity never reached zero mid-swap
            assert min_ready[0] >= 1, (
                "pool reported %d ready replicas during the rolling swap"
                % min_ready[0])
            # post-swap answers come from v2, bitwise
            for i in (0, 5, 11):
                got = pool.predict({"x": payloads[i]}, timeout=30)[0]
                assert got.tobytes() == want_v2[i].tobytes(), (
                    "post-swap answer differs from a v2 reference engine")
        finally:
            pool.stop()
    return ("rolling swap: %d live futures all answered, min ready "
            "replicas %d (never 0), pool on v2 bitwise OK"
            % (n_live, min_ready[0]))


def scenario_kill_eject_revive():
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.testing import faults

    rng = np.random.RandomState(3)
    payloads = [rng.randn(1, WIDTH).astype(np.float32) for _ in range(24)]
    with tempfile.TemporaryDirectory() as td:
        d = save_model(os.path.join(td, "m"), seed=31)
        pool = _pool(d, replicas=2, max_batch_size=2, batch_timeout_ms=0.0,
                     autostart=False, supervisor_interval_s=0.02)
        try:
            r0 = obs.counter("serving.worker_restarts").value
            d0 = obs.counter("serving.worker_deaths").value
            with faults.kill_worker(at_dispatch=0):
                futs = [pool.predict_async({"x": p}) for p in payloads]
                pool.start()
                died, ok = [], []
                for f in futs:
                    # every future resolves: the murdered replica's
                    # in-flight batch dies typed; everything else is
                    # absorbed by the surviving replica (and, after the
                    # restart, the revived one)
                    try:
                        ok.append(f.result(timeout=60)[0])
                    except serving.ServingDegraded as e:
                        died.append(e)
            assert died, "no request observed the replica kill"
            assert len(died) <= 2, (
                "only the in-flight batch may die typed; %d died"
                % len(died))
            assert len(ok) == len(payloads) - len(died), (
                "surviving replicas failed to absorb the queue: %d ok "
                "of %d" % (len(ok), len(payloads)))
            assert obs.counter("serving.worker_deaths").value > d0
            # the supervisor revives the dead worker back into rotation
            deadline = time.time() + 10
            while (time.time() < deadline
                   and (obs.counter("serving.worker_restarts").value <= r0
                        or pool.ready_replicas() < 2)):
                time.sleep(0.02)
            assert obs.counter("serving.worker_restarts").value > r0, (
                "supervisor never restarted the killed replica")
            assert pool.ready_replicas() == 2, pool.replica_stats()
            assert pool.state == "ready", pool.state
            # the revived replica provably claims work again: serve a
            # burst and require BOTH replicas to have dispatched since
            before = {s["index"]: s["dispatches"]
                      for s in pool.replica_stats()}
            deadline = time.time() + 20
            revived_claimed = False
            while time.time() < deadline and not revived_claimed:
                more = [pool.predict_async({"x": p}) for p in payloads]
                for f in more:
                    f.result(timeout=60)
                after = {s["index"]: s["dispatches"]
                         for s in pool.replica_stats()}
                revived_claimed = all(after[i] > before[i] for i in after)
            assert revived_claimed, (
                "revived replica never claimed work again: %s -> %s"
                % (before, after))
        finally:
            pool.stop()
    return ("kill/eject/revive: %d in-flight died typed, %d absorbed by "
            "survivors, supervisor revived the replica and it serves "
            "again OK" % (len(died), len(ok)))


def main():
    failures = []
    for scenario in (scenario_bitwise_vs_engine,
                     scenario_throughput_scaling,
                     scenario_rolling_swap_live,
                     scenario_kill_eject_revive):
        try:
            msg = scenario()
        except AssertionError as e:
            failures.append("%s FAILED: %s" % (scenario.__name__, e))
        else:
            print(msg)
    if "jax" in sys.modules:
        failures.append("the gate imported jax")
    if failures:
        for f in failures:
            sys.stderr.write(f + "\n")
        sys.stderr.write("\nreplica pool gate FAILED\n")
        return 1
    print("replica pool gate OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
