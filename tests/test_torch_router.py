"""The port's model router (``paddle_tpu_torch.serving.ModelRouter``) on
the CPU, every pool on ``devices=["cpu"]`` (a pool default), with
``warmup=False``, the 8-wide MLP of ``tests/unittests/test_model_router.py``
and the tiny LM dims of ``tests/unittests/test_sessions.py``.

The ported unit tests of ``test_model_router.py`` (tenant quotas,
validation, the cold tier, the canary split, the cross-pool queue,
tracker and consumer-group cases, the labeled families, global
placement) and ``test_sessions.py``'s per-tenant session scoping.

Against the JAX package, on the same seeded numpy inputs: the version
sequence of ``_pick_locked`` over 200 picks through a ``route`` and a
``rollback`` (no pool built), ``TenantQuota``'s admit/reject sequence and
balances under one stubbed clock, ``autoscale_tick``'s grants over stub
pools, a two-deployment router's answers over the same saved MLPs
(within 1e-5 of the largest |value|, the tolerance of
``test_predict_pool_matches_the_jax_pool``), and greedy tokens through
each router from the same ``lm_params`` arrays (identical); and
``write_token_kv`` against the JAX function.

The repairs this slice made on the router's path: the stream lease over
stand-in handles (no handle leased twice, a stop gives it back, an
exhausted lease raises naming the count), and a stopped decode pool
holds no step graph and no KV pool.
"""
import gc
import os
import sys
import threading
import time
import types
import weakref

import numpy as np
import pytest
import torch
# the first call of a custom operator (the serving GEMM's) imports this,
# 2-3 s on a CPU, which the quota tests' rate clocks must not see
import torch._dynamo  # noqa: F401

import paddle_tpu_torch as fluid
from paddle_tpu import serving as jserving
from paddle_tpu.models import transformer as JT
from paddle_tpu.serving import router as jrouter
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import serving
from paddle_tpu_torch import streams
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.serving import router as trouter
from paddle_tpu_torch.serving.request_queue import Request
from paddle_tpu_torch.serving.sessions import scoped_session

WIDTH = 8
PREDICT_RTOL = 1e-5
DIMS = dict(vocab_size=60, n_layer=2, n_head=2, d_model=32, d_inner=64,
            max_length=128)
DCFG = dict(num_slots=2, page_size=8, max_seq_len=96, max_new_tokens=8,
            prefill_chunk_tokens=16, queue_capacity=64)


def _save_model(dirname, seed):
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[WIDTH], dtype="float32")
        out = fluid.layers.fc(x, size=4, act="softmax")
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.io.save_inference_model(dirname, ["x"], [out], exe,
                                      main_program=main)
    return dirname


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return _save_model(str(tmp_path_factory.mktemp("router_model") / "m"),
                       seed=5)


@pytest.fixture(scope="module")
def model_dir_b(tmp_path_factory):
    return _save_model(str(tmp_path_factory.mktemp("router_model_b")
                           / "m"), seed=9)


@pytest.fixture(scope="module")
def lm():
    return TT.lm_params(seed=31, **DIMS)


POOL_KW = dict(batch_buckets=(2, 4), batch_timeout_ms=0.5, warmup=False,
               supervisor_interval_s=0.05, devices=["cpu"])


def _router(**kw):
    base = dict(POOL_KW)
    base.update(kw)
    return serving.ModelRouter(**base)


def _x(rows=1, seed=0):
    return np.random.RandomState(seed).rand(rows, WIDTH).astype("float32")


# -- tenant quota ------------------------------------------------------------

class TestTenantQuota:
    def test_token_bucket_rate(self):
        q = serving.TenantQuota("t", rows_per_s=100, burst_rows=10)
        q.acquire(10)                      # bucket drained
        with pytest.raises(serving.ServingQuotaExceeded):
            q.acquire(10)                  # nothing refilled yet
        time.sleep(0.06)                   # ~6 rows refill
        q.acquire(4)
        with pytest.raises(serving.ServingQuotaExceeded):
            q.acquire(10)

    def test_max_inflight_and_release(self):
        q = serving.TenantQuota("t", max_inflight=2)
        q.acquire(1)
        q.acquire(5)                       # no rate limit: rows free
        with pytest.raises(serving.ServingQuotaExceeded):
            q.acquire(1)
        q.release()
        q.acquire(1)                       # slot freed

    def test_inflight_breach_refunds_rate_tokens(self):
        q = serving.TenantQuota("t", rows_per_s=1, burst_rows=10,
                                max_inflight=1)
        q.acquire(4)
        with pytest.raises(serving.ServingQuotaExceeded):
            q.acquire(4)                   # in-flight cap, NOT the bucket
        q.release()
        q.acquire(4)                       # those 4 rows were refunded
        q.release()
        with pytest.raises(serving.ServingQuotaExceeded):
            q.acquire(4)                   # now the bucket really is dry

    def test_cancel_refunds_everything(self):
        q = serving.TenantQuota("t", rows_per_s=1, burst_rows=4,
                                max_inflight=1)
        q.acquire(4)
        q.cancel(4)                        # downstream admission failed
        q.acquire(4)                       # full refund: rows AND slot

    def test_validation(self):
        with pytest.raises(serving.ServingError):
            serving.TenantQuota("t", rows_per_s=0)
        with pytest.raises(serving.ServingError):
            serving.TenantQuota("t", max_inflight=0)
        with pytest.raises(serving.ServingError):
            serving.TenantQuota("t", slo_class="platinum")


# -- router semantics --------------------------------------------------------

class TestRouterValidation:
    def test_unknown_deployment_and_version(self, model_dir):
        r = _router()
        try:
            r.deploy("m", model_dir, warm=False)
            with pytest.raises(serving.ServingError):
                r.predict_async("nope", {"x": _x()})
            with pytest.raises(serving.ServingError):
                r.route("m", {"ghost": 1.0})
            with pytest.raises(serving.ServingError):
                r.route("m", {"v1": 0.0})      # nothing routable
            with pytest.raises(serving.ServingError):
                r.deploy("m", model_dir)       # duplicate version
            with pytest.raises(serving.ServingError):
                r.deploy("bad name!", model_dir)
            with pytest.raises(serving.ServingError):
                r.rollback("m")                # no previous routing
        finally:
            r.stop()

    def test_stopped_router_rejects(self, model_dir):
        r = _router()
        r.deploy("m", model_dir, warm=False)
        r.stop()
        with pytest.raises(serving.ServingClosed):
            r.predict_async("m", {"x": _x()})
        with pytest.raises(serving.ServingClosed):
            r.deploy("m2", model_dir)

    def test_default_quota_applies_to_new_tenants(self, model_dir):
        r = _router(default_quota=dict(rows_per_s=1, burst_rows=1))
        try:
            r.deploy("m", model_dir, replicas=1)
            r.predict("m", {"x": _x()}, tenant="fresh", timeout=30)
            with pytest.raises(serving.ServingQuotaExceeded):
                r.predict("m", {"x": _x()}, tenant="fresh", timeout=30)
            # anonymous (tenant=None) traffic is never quota'd
            r.predict("m", {"x": _x()}, timeout=30)
        finally:
            r.stop()

    def test_slo_class_sets_default_priority(self, model_dir):
        r = _router()
        try:
            r.deploy("m", model_dir, replicas=1)
            r.set_quota("be", slo_class="best_effort")
            before = obs.counter("serving.done_best_effort",
                                 {"model": "m", "tenant": "be"}).value
            r.predict("m", {"x": _x()}, tenant="be", timeout=30)
            after = obs.counter("serving.done_best_effort",
                                {"model": "m", "tenant": "be"}).value
            assert after == before + 1
        finally:
            r.stop()


# -- warm/cold tier ----------------------------------------------------------

class TestColdTier:
    def test_cold_activation_parks_not_drops(self, model_dir):
        r = _router()
        try:
            r.deploy("m", model_dir, replicas=1, warm=False)
            h = r.health()
            assert h["deployments"]["m"]["versions"]["v1"]["tier"] == "cold"
            futs = [r.predict_async("m", {"x": _x(seed=i)})
                    for i in range(6)]
            assert all(isinstance(f, serving.RoutedRequest) for f in futs)
            outs = [f.result(timeout=60) for f in futs]
            assert all(o[0].shape == (1, 4) for o in outs)
            h = r.health()
            assert h["deployments"]["m"]["versions"]["v1"]["tier"] == "warm"
        finally:
            r.stop()

    def test_activation_failure_fails_parked_typed(self, tmp_path):
        r = _router()
        try:
            r.deploy("m", str(tmp_path / "no_such_model"), warm=False)
            fut = r.predict_async("m", {"x": _x()})
            with pytest.raises(serving.ServingError):
                fut.result(timeout=60)
            assert fut.done()
        finally:
            r.stop()

    def test_deactivate_then_reactivate(self, model_dir):
        r = _router()
        try:
            r.deploy("m", model_dir, replicas=1)
            r.predict("m", {"x": _x()}, timeout=30)
            r.deactivate("m")
            tier = r.health()["deployments"]["m"]["versions"]["v1"]["tier"]
            assert tier == "cold"
            # next request re-activates through the park path
            out = r.predict("m", {"x": _x()}, timeout=60)
            assert out[0].shape == (1, 4)
        finally:
            r.stop()

    def test_budget_lru_eviction(self, model_dir, model_dir_b):
        r = _router(replica_budget=1)
        try:
            r.deploy("a", model_dir, replicas=1)
            r.predict("a", {"x": _x()}, timeout=30)
            # activating b must evict a (the only other warm version)
            r.deploy("b", model_dir_b, replicas=1)
            tiers = {n: d["versions"]["v1"]["tier"]
                     for n, d in r.health()["deployments"].items()}
            assert tiers == {"a": "cold", "b": "warm"}
            # an oversized version can never fit: typed, immediately
            with pytest.raises(serving.ServingError):
                r.deploy("c", model_dir, replicas=2)
        finally:
            r.stop()

    def test_stop_fails_parked_typed(self, model_dir, tmp_path):
        r = _router()
        try:
            r.deploy("m", str(tmp_path / "missing"), warm=False)
            # park a request, then stop the router before/while the
            # (failing) activation settles: the future must resolve
            fut = r.predict_async("m", {"x": _x()})
        finally:
            r.stop()
        with pytest.raises(serving.ServingError):
            fut.result(timeout=10)


# -- canary routing ----------------------------------------------------------

class TestCanary:
    def test_smooth_wrr_exact_split(self, model_dir, model_dir_b):
        r = _router()
        try:
            r.deploy("m", model_dir, version="v1", replicas=1)
            r.deploy("m", model_dir_b, version="v2", replicas=1)
            # second version defaults DARK until route()
            assert r.health()["deployments"]["m"]["versions"]["v2"][
                "weight"] == 0.0
            r.route("m", {"v1": 0.9, "v2": 0.1})

            def count(v):
                return obs.counter("serving.router.requests",
                                   {"model": "m", "version": v}).value

            c0 = (count("v1"), count("v2"))
            futs = [r.predict_async("m", {"x": _x()}) for _ in range(50)]
            for f in futs:
                f.result(timeout=60)
            got = (count("v1") - c0[0], count("v2") - c0[1])
            assert got == (45, 5), got     # deterministic, not a band
        finally:
            r.stop()

    def test_rollback_roundtrip(self, model_dir, model_dir_b):
        r = _router()
        try:
            r.deploy("m", model_dir, version="v1", replicas=1)
            r.deploy("m", model_dir_b, version="v2", replicas=1, warm=False)
            r.route("m", {"v1": 0.5, "v2": 0.5})
            r.rollback("m")                # back to 100% v1
            w = r.health()["deployments"]["m"]["versions"]
            assert w["v1"]["weight"] == 1.0 and w["v2"]["weight"] == 0.0
            r.rollback("m")                # toggles forward again
            w = r.health()["deployments"]["m"]["versions"]
            assert w["v1"]["weight"] == 0.5 and w["v2"]["weight"] == 0.5
        finally:
            r.stop()


# -- cross-pool queue/tracker sharing ----------------------------------------

class TestCrossPoolSharing:
    """Two ReplicaPools drain ONE RequestQueue and share ONE
    CompletionTracker (the pool surface the JAX package's router unit
    tests exercise; the router itself gives each version its own)."""

    def _shared_pools(self, model_dir, model_dir_b=None):
        q = serving.RequestQueue(capacity=256)
        t = serving.CompletionTracker()
        p1 = serving.ReplicaPool(model_dir, replicas=1, queue=q, tracker=t,
                                 model_label="m", **POOL_KW)
        p2 = serving.ReplicaPool(model_dir_b or model_dir, replicas=1,
                                 queue=q, tracker=t, model_label="m",
                                 **POOL_KW)
        return q, t, p1, p2

    def test_watermark_exact_across_pools(self, model_dir):
        q, t, p1, p2 = self._shared_pools(model_dir)
        try:
            futs = []
            for i in range(40):
                req = Request({"x": _x(seed=i)}, rows=1)
                q.put(req)
                futs.append(req)
            for f in futs:
                f.result(timeout=60)
            # the shared watermark is EXACT: contiguous prefix == last
            # admitted seq once everything resolved, whichever pool
            # served each request
            assert t.completed_seq == q.last_seq()
        finally:
            q.close()
            p1.stop()
            p2.stop()

    def test_both_pools_participate(self, model_dir):
        q, t, p1, p2 = self._shared_pools(model_dir)
        try:
            futs = []
            for i in range(64):
                req = Request({"x": _x(seed=i)}, rows=1)
                q.put(req)
                futs.append(req)
            for f in futs:
                f.result(timeout=60)
            d1 = sum(s["dispatches"] for s in p1.replica_stats())
            d2 = sum(s["dispatches"] for s in p2.replica_stats())
            assert d1 > 0 and d2 > 0, (d1, d2)
        finally:
            q.close()
            p1.stop()
            p2.stop()

    def test_fifo_per_lane_two_pools(self, model_dir):
        """Wrap the shared queue's get() with a recording shim: per
        priority lane, pops happen in admission order even with two
        pools' batchers racing on the queue."""
        q, t, p1, p2 = self._shared_pools(model_dir)
        popped = []
        rec_lock = threading.Lock()
        real_get = q.get

        def recording_get(timeout=None, max_rows=None, **kw):
            with rec_lock:          # serialize: order is then exact
                req = real_get(timeout=timeout, max_rows=max_rows, **kw)
                if req is not None:
                    popped.append((req.priority, req.seq))
                return req

        q.get = recording_get
        try:
            futs = []
            for i in range(48):
                cls = ("interactive", "batch", "best_effort")[i % 3]
                req = Request({"x": _x(seed=i)}, rows=1, priority=cls)
                q.put(req)
                futs.append(req)
            for f in futs:
                f.result(timeout=60)
            by_lane = {}
            for cls, seq in popped:
                by_lane.setdefault(cls, []).append(seq)
            for cls, seqs in by_lane.items():
                assert seqs == sorted(seqs), (
                    "lane %r popped out of admission order: %s"
                    % (cls, seqs))
            assert set(by_lane) == {"interactive", "batch", "best_effort"}
        finally:
            q.close()
            p1.stop()
            p2.stop()

    def test_shared_pool_stop_leaves_queue_open(self, model_dir):
        """Stopping ONE pool of a shared queue neither closes nor
        drains it: the sibling keeps serving."""
        q, t, p1, p2 = self._shared_pools(model_dir)
        try:
            p1.stop()
            assert not q.closed
            req = Request({"x": _x()}, rows=1)
            q.put(req)
            assert req.result(timeout=60)[0].shape == (1, 4)
        finally:
            q.close()
            p2.stop()


# -- per-consumer-group drain-rate estimation --------------------------------

class TestConsumerGroupEstimator:
    def test_estimate_sums_per_group_rates(self):
        q = serving.RequestQueue(capacity=512)
        try:
            q.register_consumers("a", 2)
            q.register_consumers("b", 1)
            q.note_service(100, 1.0, key="a")   # 100 rows/s per a-consumer
            q.note_service(50, 1.0, key="b")    # 50 rows/s per b-consumer
            for i in range(10):
                q.put(Request({"x": None}, rows=25))
            # 250 rows ahead at 2*100 + 1*50 = 250 rows/s aggregate
            wait = q.estimated_wait_s()
            assert wait == pytest.approx(1.0, rel=0.05), wait
        finally:
            q.close()

    def test_unregister_falls_back_to_global(self):
        q = serving.RequestQueue(capacity=512)
        try:
            q.register_consumers("a", 4)
            q.note_service(100, 1.0, key="a")
            q.unregister_consumers("a")
            q.set_parallelism(1)
            for i in range(4):
                q.put(Request({"x": None}, rows=25))
            # global EMA (fed by the keyed note_service too) x 1 worker
            wait = q.estimated_wait_s()
            assert wait == pytest.approx(1.0, rel=0.05), wait
        finally:
            q.close()

    def test_group_without_rate_uses_global_ema(self):
        q = serving.RequestQueue(capacity=512)
        try:
            q.note_service(100, 1.0)            # only the global EMA
            q.register_consumers("cold", 2)     # keyed rate unknown
            for i in range(4):
                q.put(Request({"x": None}, rows=50))
            # 200 rows at 2 consumers x global 100 rows/s
            wait = q.estimated_wait_s()
            assert wait == pytest.approx(1.0, rel=0.05), wait
        finally:
            q.close()

    def test_admission_shed_uses_group_rates(self):
        q = serving.RequestQueue(capacity=512)
        try:
            q.register_consumers("slow", 1)
            q.note_service(10, 1.0, key="slow")  # 10 rows/s total
            q.put(Request({"x": None}, rows=100))
            # 100 rows ahead = 10s of backlog; a 100ms deadline is
            # provably unmeetable -> shed AT admission
            with pytest.raises(serving.ServingOverloaded):
                q.put(Request({"x": None}, rows=1,
                              deadline=time.perf_counter() + 0.1))
        finally:
            q.close()


# -- labeled telemetry families ----------------------------------------------

class TestLabeledFamilies:
    def test_labeled_and_unlabeled_cells_coexist(self):
        c_plain = obs.counter("serving.test_fam")
        c_lab = obs.counter("serving.test_fam",
                            {"model": "m1", "tenant": "t1"})
        assert c_plain is not c_lab
        assert c_lab is obs.counter("serving.test_fam",
                                    {"tenant": "t1", "model": "m1"})

    def test_labeled_name_sanitizes(self):
        n = obs.labeled_name("f", {"model": 'a"b\\c'})
        assert '"' not in n.split("{")[1].replace('="', "", 1) \
            .replace('"}', "")
        base, labels = obs.split_labels(n)
        assert base == "f" and labels.startswith("{")

    def test_prometheus_renders_labeled_families(self):
        obs.counter("serving.fam_done",
                    {"model": "ma", "tenant": "ta"}).inc(3)
        obs.counter("serving.fam_done",
                    {"model": "mb", "tenant": "tb"}).inc(4)
        obs.counter("serving.fam_done").inc(5)
        obs.histogram("serving.fam_lat",
                      {"model": "ma"}).observe(0.5)
        text = obs.render_prometheus(prefix="pt_")
        # ONE TYPE line per family, all labeled samples under it
        assert text.count("# TYPE pt_serving_fam_done_total counter") == 1
        assert 'pt_serving_fam_done_total{model="ma",tenant="ta"} 3' in text
        assert 'pt_serving_fam_done_total{model="mb",tenant="tb"} 4' in text
        assert "\npt_serving_fam_done_total 5" in text
        assert ('pt_serving_fam_lat_seconds_bucket{model="ma",le="+Inf"} 1'
                in text)
        assert 'pt_serving_fam_lat_seconds_count{model="ma"} 1' in text
        # the strict parser reads its own output back
        parsed = obs.parse_prometheus(text)
        assert parsed['pt_serving_fam_done_total{model="ma",tenant="ta"}'] \
            == 3.0

    def test_request_labels_tick_labeled_histogram(self, model_dir):
        r = _router()
        try:
            r.deploy("lbl", model_dir, replicas=1)
            h = obs.histogram("serving.request_latency_interactive",
                              {"model": "lbl", "tenant": "tz"})
            n0 = h.count
            r.predict("lbl", {"x": _x()}, tenant="tz",
                      priority="interactive", timeout=30)
            assert h.count == n0 + 1
        finally:
            r.stop()


# -- global placement --------------------------------------------------------

class TestGlobalPlacement:
    def test_autoscale_tick_respects_budget(self, model_dir, model_dir_b):
        r = _router(replica_budget=3)
        try:
            r.deploy("a", model_dir, replicas=2)
            r.deploy("b", model_dir_b, replicas=1)
            granted = r.autoscale_tick()
            assert set(granted) == {"a:v1", "b:v1"}
            assert sum(granted.values()) <= 3
            assert all(v >= 1 for v in granted.values())
        finally:
            r.stop()

    def test_router_health_shape(self, model_dir):
        r = _router(replica_budget=4)
        try:
            r.deploy("a", model_dir, replicas=1)
            r.set_quota("t1", rows_per_s=5, max_inflight=2)
            h = r.health()
            assert h["replica_budget"] == 4
            assert h["tenants"]["t1"]["max_inflight"] == 2
            v = h["deployments"]["a"]["versions"]["v1"]
            assert v["tier"] == "warm" and v["pool"]["ready"]
        finally:
            r.stop()


# -- sessions through the router ---------------------------------------------

def test_router_scopes_sessions_per_tenant(lm):
    # session= through ModelRouter.generate() is scoped per (deployment,
    # tenant): the same session id from two tenants parks two distinct
    # store records; end_session releases the right one
    params, meta = lm
    model = TT.build_decode_model(params, meta, device="cpu")
    cfg = serving.DecodeConfig(prefix_cache=True, **DCFG)
    r = serving.ModelRouter(devices=["cpu"])
    try:
        r.deploy("chat", None, replicas=1, decode_model=model,
                 decode_config=cfg)
        prompt = np.arange(1, 21, dtype=np.int32)
        for tenant in ("a", "b"):
            r.generate("chat", prompt, max_new_tokens=4,
                       temperature=0.0, tenant=tenant, session="conv",
                       timeout=120)
        dep = r._dep("chat")
        store = next(iter(dep.versions.values())).pool.sessions
        assert sorted(store.keys()) == sorted([
            scoped_session("chat", "a", "conv"),
            scoped_session("chat", "b", "conv")])
        assert r.end_session("chat", "conv", tenant="a") is True
        assert r.end_session("chat", "conv", tenant="a") is False
        assert store.keys() == [scoped_session("chat", "b", "conv")]
        assert r.end_session("chat", "conv", tenant="b") is True
    finally:
        r.stop()


# -- against the JAX package -------------------------------------------------

def test_pick_sequence_equals_the_jax_routers(tmp_path):
    seqs = []
    for mod in (jserving, serving):
        r = mod.ModelRouter()
        try:
            for v in ("v1", "v2", "v3"):
                r.deploy("m", str(tmp_path / v), version=v, warm=False)
            dep = r._dep("m")
            picks = []
            r.route("m", {"v1": 0.5, "v2": 0.3, "v3": 0.2})
            picks += [r._pick_locked(dep).version for _ in range(90)]
            r.route("m", {"v1": 0.75, "v2": 0.25})
            picks += [r._pick_locked(dep).version for _ in range(60)]
            r.rollback("m")
            picks += [r._pick_locked(dep).version for _ in range(50)]
            seqs.append(picks)
        finally:
            r.stop()
    assert len(seqs[1]) == 200 and seqs[0] == seqs[1]
    assert seqs[1][:90].count("v3") == 18        # 0.2 of 90, exactly


def test_tenant_quota_sequence_equals_the_jax_quotas(monkeypatch):
    rng = np.random.RandomState(3)
    ops = [(("acquire", "cancel", "release")[i], int(rows), float(dt))
           for i, rows, dt in zip(rng.choice(3, 120, p=[0.6, 0.15, 0.25]),
                                  rng.randint(1, 6, 120),
                                  rng.exponential(0.05, 120))]
    logs = []
    for mod in (jrouter, trouter):
        now = [100.0]
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            monotonic=lambda: now[0], perf_counter=time.perf_counter,
            sleep=time.sleep))
        q = mod.TenantQuota("t", rows_per_s=20, burst_rows=8,
                            max_inflight=3)
        log = []
        for op, rows, dt in ops:
            now[0] += dt
            if op == "acquire":
                try:
                    q.acquire(rows)
                    log.append(("ok", q.inflight, q._tokens))
                except Exception as exc:  # noqa: BLE001 - compared by type
                    log.append((type(exc).__name__, q.inflight, q._tokens))
            else:
                getattr(q, op)(*((rows,) if op == "cancel" else ()))
                log.append((op, q.inflight, q._tokens))
        logs.append(log)
    assert logs[0] == logs[1]
    outcomes = {e[0] for e in logs[1]}
    assert {"ok", "ServingQuotaExceeded"} <= outcomes


class _StubPool:
    def __init__(self, replicas, lo, hi):
        self.replicas, self.min_replicas, self.max_replicas = replicas, lo, hi
        self.active = replicas
        self.applied = []

    def active_replicas(self):
        return self.active

    def set_active_replicas(self, n, reason="manual"):
        self.active = max(self.min_replicas, min(int(n), self.max_replicas))
        self.applied.append(self.active)
        return self.active

    def stop(self, drain=True, timeout=None):
        pass


class _StubMonitor:
    def __init__(self):
        self.desired = 1

    def desired_replicas(self):
        return self.desired


def test_autoscale_grants_equal_the_jax_routers(tmp_path):
    shapes = {"a": (4, 1, 4), "b": (3, 1, 3), "c": (2, 2, 2)}
    wants = [{"a": 4, "b": 3, "c": 2}, {"a": 1, "b": 3, "c": 2},
             {"a": 4, "b": 1, "c": 2}, {"a": 3, "b": 2, "c": 2},
             {"a": 9, "b": 0, "c": 1}]
    grants = []
    for mod in (jserving, serving):
        r = mod.ModelRouter(replica_budget=7)
        monitors = {}
        try:
            for name, (n, lo, hi) in shapes.items():
                r.deploy(name, str(tmp_path / name), replicas=n, warm=False)
                ver = r._dep(name).versions["v1"]
                ver.pool, ver.monitor = _StubPool(n, lo, hi), _StubMonitor()
                monitors[name] = ver.monitor
            out = []
            for want in wants:
                for name, d in want.items():
                    monitors[name].desired = d
                out.append(r.autoscale_tick())
            grants.append(out)
        finally:
            for name in shapes:
                r._dep(name).versions["v1"].pool = None
            r.stop()
    assert grants[0] == grants[1]
    assert all(sum(g.values()) <= 7 for g in grants[1])


def test_two_deployment_router_matches_the_jax_router(model_dir,
                                                      model_dir_b):
    rng = np.random.RandomState(1)
    payloads = [rng.randn(rng.randint(1, 4), WIDTH).astype(np.float32)
                for _ in range(6)]
    outs = []
    for mod, kw in ((jserving, dict(backend="program")),
                    (serving, dict(devices=["cpu"]))):
        r = mod.ModelRouter(batch_buckets=(2, 4), batch_timeout_ms=0.5,
                            **kw)
        try:
            r.deploy("a", model_dir, replicas=2)
            r.deploy("b", model_dir_b, replicas=1)
            futs = [r.predict_async(n, {"x": p})
                    for p in payloads for n in ("a", "b")]
            outs.append([f.result(timeout=120)[0] for f in futs])
        finally:
            r.stop()
    for g, w in zip(outs[1], outs[0]):
        assert g.shape == w.shape
        scale = max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g - w).max()) <= PREDICT_RTOL * scale


def test_router_greedy_tokens_equal_the_jax_routers(lm):
    params, meta = lm
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, DIMS["vocab_size"], size=rng.randint(2, 24))
               .astype(np.int32) for _ in range(4)]
    outs = []
    for mod, model, kw in (
            (jserving, JT.build_decode_model(params, meta), {}),
            (serving, TT.build_decode_model(params, meta, device="cpu"),
             dict(devices=["cpu"]))):
        r = mod.ModelRouter(**kw)
        try:
            r.deploy("chat", None, replicas=2, decode_model=model,
                     decode_config=mod.DecodeConfig(**DCFG))
            futs = [r.generate_async("chat", p, temperature=0.0)
                    for p in prompts]
            outs.append([f.result(timeout=120) for f in futs])
        finally:
            r.stop()
    for g, w in zip(outs[1], outs[0]):
        assert g.dtype == np.int32 and g.tobytes() == np.asarray(
            w).tobytes()


def test_write_token_kv_matches_jax():
    import jax.numpy as jnp
    from paddle_tpu.serving import kv_cache as JK
    from paddle_tpu_torch.serving import kv_cache as TK

    rng = np.random.RandomState(9)
    L, P, ps, H, D, S = 2, 8, 4, 2, 16, 4
    kp = rng.randn(L, P, ps, H, D).astype(np.float32)
    vp = rng.randn(L, P, ps, H, D).astype(np.float32)
    k_tok = rng.randn(L, S, H, D).astype(np.float32)
    v_tok = rng.randn(L, S, H, D).astype(np.float32)
    pages = np.array([5, 2, 0, 0], np.int32)     # two live slots, two idle
    offsets = np.array([3, 0, 1, 2], np.int32)
    jk, jv = JK.write_token_kv(jnp.asarray(kp), jnp.asarray(vp),
                               jnp.asarray(k_tok), jnp.asarray(v_tok),
                               jnp.asarray(pages), jnp.asarray(offsets))
    kt, vt = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    out = TK.write_token_kv(kt, vt, torch.from_numpy(k_tok),
                            torch.from_numpy(v_tok), torch.from_numpy(pages),
                            torch.from_numpy(offsets))
    assert out[0] is kt and out[1] is vt              # in place
    np.testing.assert_array_equal(kt.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(kt.numpy()[:, 5, 3], k_tok[:, 0])


def test_serving_exports_every_name_of_the_jax_package():
    assert set(jserving.__all__) <= set(serving.__all__)
    for name in ("ModelRouter", "RoutedRequest", "TenantQuota",
                 "write_prompt_kv", "write_token_kv"):
        assert getattr(serving, name) is not None


def test_the_default_devices_are_the_card(model_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    r = serving.ModelRouter()
    try:
        with pytest.raises(serving.ServingDegraded) as info:
            r.deploy("m", model_dir, replicas=2)
        assert isinstance(info.value.__cause__, RuntimeError)
        assert "no CUDA device" in str(info.value.__cause__)
        assert r.health()["deployments"]["m"]["versions"]["v1"][
            "tier"] == "cold"
    finally:
        r.stop()


# -- the stream lease --------------------------------------------------------

class _Handle:
    def __init__(self, h):
        self.cuda_stream = h


def _fake_lease(limit, repeat=None):
    made = []

    def make(index):
        made.append(index)
        h = len(made) if repeat is None else 1 + (len(made) - 1) % repeat
        return _Handle(0x1000 * (index + 1) + h)

    return streams.StreamLease(make=make, limit=limit), made


def test_lease_never_hands_out_a_held_handle():
    base, made = _fake_lease(limit=6)
    a, b = streams.Lease("a", base), streams.Lease("b", base)
    got = [a.stream(0), b.stream(0), a.stream(0)]
    got.append(a.side(0, got[0]))
    assert a.side(0, got[0]) is got[-1]          # leased once
    handles = [s.cuda_stream for s in got]
    assert len(set(handles)) == len(handles) == 4
    assert set(base.held().values()) == {"a", "b"}
    assert streams.side_of(0, got[0], base) is got[-1]
    assert streams.leased(0, got[1], base) is b
    # a maker that repeats handles, as PyTorch's round-robin pool does
    rep, _ = _fake_lease(limit=6, repeat=2)
    c = streams.Lease("c", rep)
    c.stream(0)
    c.stream(0)
    with pytest.raises(RuntimeError, match="already held by c"):
        c.stream(0)


def test_lease_release_gives_the_handles_back():
    base, made = _fake_lease(limit=3)
    a = streams.Lease("a", base)
    s1, s2 = a.stream(0), a.stream(0)
    a.release()
    a.release()                                   # once only
    assert base.held() == {}
    b = streams.Lease("b", base)
    assert {b.stream(0).cuda_stream, b.stream(0).cuda_stream} == {
        s1.cuda_stream, s2.cuda_stream}
    assert len(made) == 2                         # reused, not made again
    assert streams.leased(0, s1, base) is b and base.created(0) == 2


def test_a_stream_marked_by_a_handle_comes_back_to_it():
    # PyTorch keeps a cuBLAS workspace for each (handle, stream) it ran
    # on: a free stream the asking thread's handle marked comes first,
    # then the one released first, then a new one; a stream leased but
    # never marked is no better than any other
    base, made = _fake_lease(limit=6)
    h1, h2 = streams.Lease("h1", base), streams.Lease("h2", base)
    w1, w2 = h1.stream(0, prefer="handle-1"), h2.stream(0)
    s1, s2 = h1.side(0, w1, prefer="handle-1"), h2.side(0, w2)
    assert h1.side(0, w1) is s1                   # leased once
    h1.mark(0, s1, "handle-1")
    h2.mark(0, s2, "handle-2")
    h1.release()
    h2.release()
    h3 = streams.Lease("h3", base)
    assert h3.stream(0, prefer="handle-2") is s2
    assert h3.stream(0, prefer="handle-1") is s1
    assert h3.stream(0, prefer="handle-9") is w1  # released first
    assert len(made) == 4
    h3.release()
    # past the free streams a new one is made
    c = streams.Lease("c", base)
    got = [c.stream(0) for _ in range(6)]
    assert len(made) == 6 and len({s.cuda_stream for s in got}) == 6


def test_the_lease_under_contending_threads():
    # more threads than cores lease and release at once, with a short
    # switch interval: no stream is ever held by two leases, and every
    # stream comes back
    n = min(64, 2 * len(os.sched_getaffinity(0)))
    base, made = _fake_lease(limit=2 * n)
    errors, interval = [], sys.getswitchinterval()

    def worker(t):
        try:
            for i in range(200):
                lease = streams.Lease("t%d" % t, base)
                a = lease.stream(0, prefer=t % 3)
                b = lease.side(0, a, prefer=t % 3)
                lease.mark(0, b, t % 3)
                if not (base.holder(0, a) is lease is base.holder(0, b)
                        and a is not b):
                    errors.append((t, i))
                lease.release()
        except Exception as exc:  # noqa: BLE001 - asserted below
            errors.append(repr(exc))

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:4]
    assert base.held() == {} and len(made) <= 2 * n


def test_an_exhausted_lease_raises_naming_the_count():
    base, made = _fake_lease(limit=2)
    a = streams.Lease("pool-a replica 0", base)
    a.stream(0)
    a.stream(0)
    with pytest.raises(RuntimeError, match=r"all 2 streams of cuda:0 .*"
                                           r"pool-a replica 0"):
        streams.Lease("pool-b replica 0", base).stream(0)
    assert len(made) == 2
    streams.Lease("other device", base).stream(1)   # a device's own set


# -- a stopped decode pool frees what it holds -------------------------------

def test_a_stopped_decode_pool_holds_no_graph_and_no_kv_pool(lm):
    params, meta = lm
    model = TT.build_decode_model(params, meta, device="cpu")
    pool = serving.ReplicaPool(
        None, replicas=2, devices=["cpu"], decode_model=model,
        decode_config=serving.DecodeConfig(**DCFG),
        supervisor_interval_s=0.05)
    out = pool.generate(np.arange(1, 12, dtype=np.int32), timeout=60)
    assert out.shape == (DCFG["max_new_tokens"],)
    decoders = [r.decoder for r in pool._replicas]
    assert all(len(d._jit) for d in decoders)
    refs = [weakref.ref(t) for d in decoders
            for t in (d._cache.k_pool, d._cache.v_pool)]
    pool.stop()
    assert all(len(d._jit) == 0 and d.step_stats() == {} for d in decoders)
    del pool, decoders
    gc.collect()
    assert all(ref() is None for ref in refs)
