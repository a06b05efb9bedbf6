#!/usr/bin/env python
"""Gate for the port's multi-model serving plane
(``paddle_tpu_torch.serving.ModelRouter``), driven on replica pools on
the CPU (``devices=["cpu"]`` as a pool default: every replica on the one
device, as every replica shares ``cuda:0`` on one card).  The port's
counterpart of ``tools/check_router.py``, its four scenarios.

Scenario 1 — bitwise identity per model:
  a two-deployment router returns, for every request, outputs
  bitwise-identical to a dedicated single-model ReplicaPool serving the
  same artifact — routing picks WHICH pool admits a request, never how
  it executes.

Scenario 2 — typed tenant quota breach:
  a tenant with a tight token-bucket rate and a max-in-flight cap gets
  ServingQuotaExceeded (and nothing else) on breach, BEFORE any queue
  is touched; the same requests sail through for an unlimited tenant,
  and quota sheds land on the labeled quota_rejections counter.

Scenario 3 — deterministic canary split:
  route("m", {v1: 0.75, v2: 0.25}) over N requests puts exactly the
  expected count on each version within +/-1 (smooth weighted
  round-robin — no RNG tolerance band), per-version labeled counters
  agree, and one rollback() call restores the previous split.

Scenario 4 — cold activate / deactivate under live traffic:
  open-loop submitters hammer a warm deployment while a COLD deployment
  takes its first requests (park, activate, bind) and is then
  LRU-deactivated by a budget-constrained activation — every submitted
  future on both deployments resolves with a real result (zero dropped,
  zero hung), and the parked requests' answers are bitwise-correct.

Left out: nothing of the scenarios.  The JAX gate's forced host-device
mesh has no counterpart (the port's replicas share one device, as they
share the card), and what only the card has (streams leased to one live
holder, captures during another pool's traffic, the device memory a
deactivation gives back) is held by ``chip_smoke.py``'s router phase;
``tests/test_torch_router.py`` holds the stream lease's logic on
stand-in handles.

Runnable locally (the port only: no jax is imported):
    python tools/check_router_torch.py
and run under pytest by tests/test_torch_router_gate.py.

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

BUCKETS = (2, 4)
WIDTH = 12
POOL_KW = dict(batch_buckets=BUCKETS, batch_timeout_ms=0.5, warmup=False,
               supervisor_interval_s=0.05, devices=["cpu"])


def save_model(dirname, seed):
    import paddle_tpu_torch as fluid

    main = fluid.Program()
    startup = fluid.Program()
    startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[WIDTH], dtype="float32")
        h = fluid.layers.fc(x, size=16, act="relu")
        out = fluid.layers.fc(h, size=5, act="softmax")
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.io.save_inference_model(dirname, ["x"], [out], exe,
                                      main_program=main)
    return dirname


def scenario_bitwise_per_model():
    from paddle_tpu_torch import serving

    rng = np.random.RandomState(0)
    payloads = [rng.randn(rng.randint(1, 5), WIDTH).astype(np.float32)
                for _ in range(24)]
    with tempfile.TemporaryDirectory() as td:
        da = save_model(os.path.join(td, "a"), seed=11)
        db = save_model(os.path.join(td, "b"), seed=12)
        want = {}
        for name, d in (("alpha", da), ("beta", db)):
            with serving.ReplicaPool(d, replicas=1, **POOL_KW) as ref:
                want[name] = [ref.predict({"x": p}, timeout=60)[0]
                              for p in payloads]
        router = serving.ModelRouter(**POOL_KW)
        try:
            router.deploy("alpha", da, replicas=2)
            router.deploy("beta", db, replicas=2)
            futs = [(name, i, router.predict_async(name, {"x": payloads[i]}))
                    for i in range(len(payloads))
                    for name in ("alpha", "beta")]
            bad = 0
            for name, i, f in futs:
                got = f.result(timeout=60)[0]
                if got.tobytes() != want[name][i].tobytes():
                    bad += 1
            assert bad == 0, (
                "%d routed answers differ from a dedicated single-model "
                "pool" % bad)
        finally:
            router.stop()
    return ("bitwise per model: %d routed answers across 2 deployments "
            "all match dedicated pools OK" % len(futs))


def scenario_quota_typed():
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import serving

    rng = np.random.RandomState(1)
    x2 = rng.randn(2, WIDTH).astype(np.float32)
    with tempfile.TemporaryDirectory() as td:
        d = save_model(os.path.join(td, "m"), seed=21)
        router = serving.ModelRouter(**POOL_KW)
        try:
            router.deploy("m", d, replicas=1)
            # refill of 1 row/s is negligible across a few ms of sync
            # calls: the burst alone decides admission
            router.set_quota("tight", rows_per_s=1, burst_rows=4,
                             max_inflight=2, slo_class="best_effort")
            # burst_rows=4 admits exactly two 2-row requests back to back;
            # the third must breach the bucket TYPED, with no other error
            r0 = obs.counter("serving.router.quota_rejections",
                             {"model": "m", "tenant": "tight"}).value
            ok = [router.predict("m", {"x": x2}, tenant="tight", timeout=30)
                  for _ in range(2)]
            assert len(ok) == 2
            try:
                router.predict("m", {"x": x2}, tenant="tight", timeout=30)
            except serving.ServingQuotaExceeded:
                pass
            else:
                raise AssertionError(
                    "third burst request was admitted past a 4-row bucket")
            r1 = obs.counter("serving.router.quota_rejections",
                             {"model": "m", "tenant": "tight"}).value
            assert r1 == r0 + 1, (
                "labeled quota_rejections did not advance (%s -> %s)"
                % (r0, r1))
            # max-in-flight: hold 2 slots via never-completing proxies is
            # heavyweight; instead drain the bucket knowledge: a fresh
            # tenant capped at 1 in-flight rejects the second concurrent
            router.set_quota("narrow", max_inflight=1)
            q = router._quota_for("narrow")
            f1 = router.predict_async("m", {"x": x2}, tenant="narrow")
            breached = False
            if q.inflight >= 1:     # first still in flight
                try:
                    router.predict_async("m", {"x": x2}, tenant="narrow")
                except serving.ServingQuotaExceeded:
                    breached = True
            f1.result(timeout=30)
            if not breached:        # first completed too fast: force it
                q.inflight = q.max_inflight
                try:
                    router.predict_async("m", {"x": x2}, tenant="narrow")
                except serving.ServingQuotaExceeded:
                    breached = True
                finally:
                    q.inflight = 0
            assert breached, "max_inflight=1 never produced a typed breach"
            # an unlimited tenant (no quota installed) is never throttled
            for _ in range(4):
                router.predict("m", {"x": x2}, tenant="open", timeout=30)
        finally:
            router.stop()
    return ("tenant quota: rate + in-flight breaches typed "
            "ServingQuotaExceeded, labeled counter advanced, unlimited "
            "tenant unthrottled OK")


def scenario_canary_split():
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import serving

    rng = np.random.RandomState(2)
    x1 = rng.randn(1, WIDTH).astype(np.float32)
    n = 200
    with tempfile.TemporaryDirectory() as td:
        d1 = save_model(os.path.join(td, "v1"), seed=31)
        d2 = save_model(os.path.join(td, "v2"), seed=32)
        router = serving.ModelRouter(**POOL_KW)
        try:
            router.deploy("m", d1, version="v1", replicas=1)
            router.deploy("m", d2, version="v2", replicas=1, weight=0.0)
            router.route("m", {"v1": 0.75, "v2": 0.25})

            def counts():
                return tuple(
                    obs.counter("serving.router.requests",
                                {"model": "m", "version": v}).value
                    for v in ("v1", "v2"))

            c0 = counts()
            futs = [router.predict_async("m", {"x": x1}) for _ in range(n)]
            for f in futs:
                f.result(timeout=60)
            c1 = counts()
            got = (c1[0] - c0[0], c1[1] - c0[1])
            want = (int(n * 0.75), int(n * 0.25))
            assert abs(got[0] - want[0]) <= 1 and got[0] + got[1] == n, (
                "canary split %s over %d requests; wanted %s +/-1 (smooth "
                "WRR is deterministic)" % (got, n, want))
            # one-call rollback restores the pre-route split (100%% v1)
            router.rollback("m")
            c2 = counts()
            for _ in range(20):
                router.predict("m", {"x": x1}, timeout=30)
            c3 = counts()
            assert c3[0] - c2[0] == 20 and c3[1] == c2[1], (
                "rollback did not restore the previous all-v1 routing: "
                "%s -> %s" % (c2, c3))
        finally:
            router.stop()
    return ("canary split: %d/%d of %d requests at weights 0.75/0.25 "
            "(+/-1 exact), rollback restored all-v1 OK" % (got + (n,)))


def scenario_cold_tier_live():
    from paddle_tpu_torch import serving

    rng = np.random.RandomState(3)
    payloads = [rng.randn(1, WIDTH).astype(np.float32) for _ in range(32)]
    with tempfile.TemporaryDirectory() as td:
        dh = save_model(os.path.join(td, "hot"), seed=41)
        dc = save_model(os.path.join(td, "cold"), seed=42)
        with serving.ReplicaPool(dc, replicas=1, **POOL_KW) as ref:
            want_cold = [ref.predict({"x": p}, timeout=60)[0]
                         for p in payloads]
        # budget fits exactly ONE warm deployment: activating the cold
        # one must LRU-deactivate the hot one, and vice versa — all
        # under live traffic with zero dropped futures
        router = serving.ModelRouter(replica_budget=2, **POOL_KW)
        try:
            router.deploy("hot", dh, replicas=2)
            router.deploy("cold", dc, replicas=2, warm=False)
            stop_evt = threading.Event()
            futs, submit_errors = [], []
            futs_lock = threading.Lock()

            def submitter(t):
                i = 0
                while not stop_evt.is_set():
                    try:
                        f = router.predict_async(
                            "hot", {"x": payloads[(t * 7 + i) % 32]})
                    except (serving.ServingQueueFull,
                            serving.ServingOverloaded):
                        time.sleep(0.005)
                        continue
                    except Exception as e:  # noqa: BLE001 - surfaced below
                        submit_errors.append(e)
                        return
                    with futs_lock:
                        futs.append(f)
                    i += 1
                    time.sleep(0.002)

            threads = [threading.Thread(target=submitter, args=(t,))
                       for t in range(3)]
            for t in threads:
                t.start()
            time.sleep(0.15)        # traffic flowing on the hot model
            # first touch of the cold model: parks, activates (evicting
            # "hot" LRU under the budget), binds, answers
            cold_futs = [router.predict_async("cold", {"x": payloads[i]})
                         for i in range(8)]
            cold_out = [f.result(timeout=120)[0] for f in cold_futs]
            time.sleep(0.15)        # hot traffic keeps re-activating "hot"
            stop_evt.set()
            for t in threads:
                t.join()
            assert not submit_errors, (
                "hot-deployment admission failed during cold activation: "
                "%r" % submit_errors[0])
            # zero dropped futures: every submitted request resolves
            for f in futs:
                out = f.result(timeout=120)
                assert out[0].shape[0] == 1
            bad = sum(1 for got, w in zip(cold_out, want_cold)
                      if got.tobytes() != w.tobytes())
            assert bad == 0, (
                "%d parked-then-bound answers differ from a dedicated "
                "cold-model pool" % bad)
            h = router.health()
            tiers = {n: dd["versions"]["v1"]["tier"]
                     for n, dd in h["deployments"].items()}
            assert "warm" in tiers.values(), tiers
        finally:
            router.stop()
    return ("cold tier under traffic: %d hot futures + %d parked cold "
            "futures all resolved (zero dropped), parked answers bitwise, "
            "LRU eviction cycled within budget 2 OK"
            % (len(futs), len(cold_futs)))


def main():
    failures = []
    for scenario in (scenario_bitwise_per_model,
                     scenario_quota_typed,
                     scenario_canary_split,
                     scenario_cold_tier_live):
        try:
            msg = scenario()
        except AssertionError as e:
            failures.append("%s FAILED: %s" % (scenario.__name__, e))
        else:
            print(msg)
    if failures:
        for f in failures:
            sys.stderr.write(f + "\n")
        sys.stderr.write("\nmodel router gate FAILED\n")
        return 1
    print("model router gate OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
