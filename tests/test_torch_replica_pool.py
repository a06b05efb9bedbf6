"""The port's replica pool (``paddle_tpu_torch.serving.ReplicaPool``) on
the CPU, every replica on ``devices=["cpu"]``.

Cross-package, on the same seeded numpy inputs: a port pool of two
decode replicas and the JAX package's two-replica ``ReplicaPool`` (on the
conftest's forced CPU devices) serve the same prompts greedily from the
same ``lm_params`` arrays and must return identical tokens; two predict
replicas over one saved MLP agree with the JAX pool's within 1e-5 of the
largest |value| (float32, the packages sum in different orders; the
tolerance of ``tests/test_torch_io.py``'s predictions).

Port against port: a pool is bitwise the single engine (predict on both
backends, and decode); the least-loaded claim gate (ties claim, a freer
sibling wins), prefix-affinity hints (a fresh one holds the head for its
replica, a stale or unservable one is stripped, the per-pop claim check
agrees); the replay budget; rotation scaling and autoscale hysteresis;
the rolling swap (the old version's graphs are dropped); the JAX pool's
validation of ``sessions=`` and ``roles=`` (each a ``ServingError``); and
a decode replica off the model's device raises ``NotImplementedError``
naming ROADMAP A11.
"""
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu import serving as jserving
from paddle_tpu.models import transformer as JT
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import serving
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.testing import faults

WIDTH = 8
PREDICT_RTOL = 1e-5
DIMS = dict(vocab_size=50, n_layer=2, n_head=2, d_model=32, d_inner=64,
            max_length=128)
DCFG = dict(num_slots=2, page_size=8, max_seq_len=64, max_new_tokens=8)


def _save_model(pkg, dirname, seed, width=WIDTH, aot=False):
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = seed
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[width], dtype="float32")
        h = pkg.layers.fc(x, size=16, act="relu")
        out = pkg.layers.fc(h, size=4, act="softmax")
    exe = pkg.Executor(pkg.CPUPlace())
    with pkg.scope_guard(pkg.Scope()):
        exe.run(startup)
        kw = {"aot": True} if aot else {}
        pkg.io.save_inference_model(dirname, ["x"], [out], exe,
                                    main_program=main, **kw)
    return dirname


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("pool") / "m")
    return _save_model(fluid, d, seed=5, aot=True)


@pytest.fixture(scope="module")
def lm():
    return TT.lm_params(seed=7, **DIMS)


@pytest.fixture(scope="module")
def decode_model(lm):
    params, meta = lm
    return TT.build_decode_model(params, meta, device="cpu")


def _pool(model_dir, **kw):
    base = dict(replicas=2, devices=["cpu"], batch_buckets=(2, 4),
                batch_timeout_ms=0.5, warmup=False,
                supervisor_interval_s=0.05)
    base.update(kw)
    return serving.ReplicaPool(model_dir, **base)


def _decode_pool(model, replicas=2, **kw):
    cfg = dict(DCFG)
    cfg.update(kw.pop("cfg", {}))
    return serving.ReplicaPool(
        None, replicas=replicas, devices=["cpu"], decode_model=model,
        decode_config=serving.DecodeConfig(**cfg),
        supervisor_interval_s=0.05, **kw)


def _prompts(n, seed, lo=2, hi=24):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, DIMS["vocab_size"],
                        size=rng.randint(lo, hi)).astype(np.int32)
            for _ in range(n)]


# -- against the JAX package ------------------------------------------------

def test_decode_pool_greedy_tokens_equal_the_jax_pool(lm, decode_model):
    params, meta = lm
    prompts = _prompts(6, seed=0)
    jpool = jserving.ReplicaPool(
        None, replicas=2, decode_model=JT.build_decode_model(params, meta),
        decode_config=jserving.DecodeConfig(**DCFG))
    try:
        want = [f.result(timeout=120)
                for f in [jpool.generate_async(p) for p in prompts]]
    finally:
        jpool.stop()
    with _decode_pool(decode_model) as pool:
        got = [f.result(timeout=60)
               for f in [pool.generate_async(p) for p in prompts]]
        served = [s["decode"]["completed"] for s in pool.replica_stats()]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.int32 and g.tobytes() == w.tobytes(), (i, g, w)
    assert sum(served) == len(prompts)


def test_predict_pool_matches_the_jax_pool(tmp_path):
    d = _save_model(fluid, str(tmp_path / "m"), seed=9)
    rng = np.random.RandomState(1)
    payloads = [rng.randn(rng.randint(1, 4), WIDTH).astype(np.float32)
                for _ in range(8)]
    jpool = jserving.ReplicaPool(d, replicas=2, batch_buckets=(2, 4),
                                 backend="program")
    try:
        want = [f.result(timeout=120)[0]
                for f in [jpool.predict_async({"x": p}) for p in payloads]]
    finally:
        jpool.stop()
    with _pool(d, warmup=True, backend="program") as pool:
        got = [f.result(timeout=60)[0]
               for f in [pool.predict_async({"x": p}) for p in payloads]]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        scale = max(1.0, float(np.abs(w).max()))
        assert float(np.abs(g - w).max()) <= PREDICT_RTOL * scale


# -- port against port: bitwise the single engine ---------------------------

@pytest.mark.parametrize("backend", ["program", "aot"])
def test_predict_pool_bitwise_equals_the_engine(model_dir, backend):
    rng = np.random.RandomState(0)
    payloads = [rng.rand(rng.randint(1, 4), WIDTH).astype(np.float32)
                for _ in range(16)]
    eng = serving.InferenceEngine(model_dir, batch_buckets=(2, 4),
                                  backend=backend, supervise=False,
                                  device="cpu")
    want = [eng.predict({"x": p}) for p in payloads]
    eng.stop()
    with _pool(model_dir, warmup=True, backend=backend) as pool:
        got = [f.result(timeout=60)
               for f in [pool.predict_async({"x": p}) for p in payloads]]
        stats = pool.replica_stats()
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.tobytes() == b.tobytes()
    assert {s["device"] for s in stats} == {"cpu"}
    assert all(s["model_version"] == 1 for s in stats)


def test_decode_pool_bitwise_equals_the_scheduler(decode_model):
    prompts = _prompts(8, seed=3)
    kws = [dict(temperature=0.7, seed=10 + i) if i % 2 else {}
           for i in range(len(prompts))]
    sched = serving.DecodeScheduler(decode_model,
                                    serving.DecodeConfig(**DCFG))
    want = [sched.generate(p, **kw) for p, kw in zip(prompts, kws)]
    sched.stop()
    with _decode_pool(decode_model, replicas=3) as pool:
        got = [f.result(timeout=60) for f in [
            pool.generate_async(p, **kw) for p, kw in zip(prompts, kws)]]
        assert pool.drain_decode(timeout=30)
        used = [r.decoder.cache_stats()["used_pages"]
                for r in pool._replicas]
        served = [s["decode"]["completed"] for s in pool.replica_stats()]
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()
    assert used == [0, 0, 0]
    assert sum(1 for n in served if n) >= 2


def test_seedless_sampling_is_pinned_at_pool_admission(decode_model):
    prompts = _prompts(4, seed=4)
    outs = []
    for _ in range(2):
        with _decode_pool(decode_model) as pool:
            futs = [pool.generate_async(p, temperature=0.8)
                    for p in prompts]
            outs.append([f.result(timeout=60) for f in futs])
            assert [f.seed for f in futs] == [0, 1, 2, 3]
    for a, b in zip(*outs):
        assert a.tobytes() == b.tobytes()


# -- the claim gate and affinity hints --------------------------------------

@pytest.fixture
def gated(decode_model):
    """A 3-replica decode pool whose workers never run, every replica
    claim-ready: the gate is a function of the flags, free slots and the
    queue's head, driven by hand."""
    pool = _decode_pool(decode_model, replicas=3, autostart=False,
                        cfg={"warmup": False})
    pool._decode_ready = lambda rep: rep.active and not rep.draining
    yield pool
    for rep in pool._replicas:
        rep.decoder._slots = [None] * len(rep.decoder._slots)
    pool.stop(drain=False)


def _occupy(rep, n):
    for i in range(n):
        rep.decoder._slots[i] = object()


def _head(pool, affinity=None, age_s=0.0):
    req = serving.GenerateRequest(np.array([1, 2, 3], np.int32), 4)
    pool._decode_queue.put(req)
    if affinity is not None:
        req.affinity = affinity
        req.affinity_ts = time.perf_counter() - age_s
    return req


def test_gate_ties_claim(gated):
    assert all(gated._decode_gate(r) for r in gated._replicas)


def test_gate_defers_to_a_freer_sibling(gated):
    r0, r1, r2 = gated._replicas
    _occupy(r0, 1)
    assert not gated._decode_gate(r0)
    assert gated._decode_gate(r1) and gated._decode_gate(r2)
    # a parked sibling does not count
    r1.active = r2.active = False
    assert gated._decode_gate(r0)


def test_gate_honors_a_fresh_affinity_hint(gated):
    r0, r1, r2 = gated._replicas
    req = _head(gated, affinity=1)
    assert not gated._decode_gate(r0) and not gated._decode_gate(r2)
    assert gated._decode_gate(r1)
    assert req.affinity == 1
    # the per-pop check agrees, under the queue's lock
    assert not gated._may_claim(r0, req) and gated._may_claim(r1, req)


@pytest.mark.parametrize("why", ["stale", "unready", "out_of_range"])
def test_gate_strips_an_unservable_hint(gated, why):
    r0, r1, _ = gated._replicas
    aff, age = {"stale": (1, 5.0), "unready": (1, 0.0),
                "out_of_range": (7, 0.0)}[why]
    if why == "unready":
        r1.draining = True
    req = _head(gated, affinity=aff, age_s=age)
    f0 = obs.counter("serving.affinity.fallbacks").value
    assert gated._decode_gate(r0)       # least-loaded again: a tie
    assert req.affinity is None and req.affinity_ts is None
    assert obs.counter("serving.affinity.fallbacks").value == f0 + 1


def test_claim_refuses_once_parked_or_draining(gated):
    """A replica parked (or set draining) after its gate passed claims
    nothing from its pending pull."""
    r0, r1, _ = gated._replicas
    req = _head(gated)
    r0.active = False
    r1.draining = True
    assert not gated._may_claim(r0, req) and not gated._may_claim(r1, req)
    assert gated._may_claim(gated._replicas[2], req)


def test_claim_strips_a_stale_hint(gated):
    r0 = gated._replicas[0]
    req = _head(gated, affinity=2, age_s=5.0)
    assert gated._may_claim(r0, req)
    assert req.affinity is None


def test_prefix_affinity_stamps_the_warm_replica(decode_model):
    prefix = np.arange(1, 17, dtype=np.int32)        # two full pages
    with _decode_pool(decode_model, cfg={"prefix_cache": True}) as pool:
        pool.generate(prefix, timeout=60)            # registers the pages
        warm = next(r.index for r in pool._replicas
                    if r.decoder.cache_stats()["cached_pages"])
        p0 = obs.counter("serving.affinity.prefix").value
        h0 = obs.counter("serving.affinity.honored").value
        req = pool.generate_async(
            np.concatenate([prefix, np.array([5, 6], np.int32)]))
        assert req.affinity == warm
        req.result(timeout=60)
        assert obs.counter("serving.affinity.prefix").value == p0 + 1
        assert obs.counter("serving.affinity.honored").value == h0 + 1


# -- durable decode ----------------------------------------------------------

def _journaled(accepted, max_new=6, replays=0):
    req = serving.GenerateRequest(np.array([1, 2, 3], np.int32), max_new,
                                  seed=3)
    req.journal.accepted.extend(accepted)
    req.journal.replays = replays
    return req


def test_readmit_spends_the_replay_budget(gated):
    gated._decode_config.replay_budget = 1
    r0 = obs.counter("serving.decode.replays").value
    req = _journaled([7, 8])
    gated._readmit_decode(req)
    assert not req.done() and req.journal.replays == 1
    assert req.prompt.tolist() == [1, 2, 3, 7, 8]
    assert req.max_new_tokens == 4
    assert obs.counter("serving.decode.replays").value == r0 + 1
    assert gated._decode_queue.depth() == 1
    spent = _journaled([7], replays=1)
    gated._readmit_decode(spent)
    with pytest.raises(serving.ServingDegraded, match="replay budget"):
        spent.result(timeout=1)
    done = _journaled([4, 5, 6], max_new=3)
    gated._readmit_decode(done)
    assert done.result(timeout=1).tolist() == [4, 5, 6]


def test_replay_budget_zero_fails_the_killed_replicas_sequences(
        decode_model):
    prompts = _prompts(6, seed=5, lo=4, hi=16)
    with _decode_pool(decode_model) as pool:
        want = [f.result(timeout=60)
                for f in [pool.generate_async(p) for p in prompts]]
    with _decode_pool(decode_model, cfg={"replay_budget": 0}) as pool:
        with faults.kill_replica_mid_decode(1, min_tokens=2) as fired:
            futs = [pool.generate_async(p) for p in prompts]
            failed = []
            for i, f in enumerate(futs):
                try:
                    assert f.result(timeout=60).tobytes() == \
                        want[i].tobytes()
                except serving.ServingDegraded as e:
                    assert "replay budget (0)" in str(e)
                    failed.append(i)
        assert fired[0] == 1 and failed


def test_kill_replica_fires_only_on_its_thread():
    calls = []
    with faults.kill_replica_mid_decode(2) as fired:
        from paddle_tpu_torch import resilience

        req = _journaled([1])
        resilience._serve_fault([req])           # not a replica's thread
        out = []

        def on(name):
            try:
                resilience._serve_fault([req])
            except faults.WorkerKilled:
                out.append(name)

        for name in ("decode-replica1", "decode-replica2",
                     "decode-replica2"):
            t = threading.Thread(target=on, args=(name,), name=name)
            t.start()
            t.join(timeout=10)
            calls.append(t.is_alive())
    assert out == ["decode-replica2"] and fired == [1]
    assert not any(calls)


# -- scaling, autoscale, swap ------------------------------------------------

def test_health_surface(model_dir):
    with _pool(model_dir, replicas=3, initial_replicas=2) as pool:
        h = pool.health()
        assert (h["replicas"], h["active_replicas"],
                h["ready_replicas"]) == (3, 2, 2)
        assert h["model_versions"] == [1]
        states = [r["state"] for r in h["per_replica"]]
        assert states.count("serving") == 2 and states.count("parked") == 1
        assert h["state"] == "ready" and h["ready"]
        assert pool.feed_names == ["x"]
        assert obs.gauge("serving.replica.pool_size").value == 3
        assert obs.gauge("serving.replica.active").value == 2


def test_admission_contract(model_dir):
    X = np.zeros((1, WIDTH), np.float32)
    pool = _pool(model_dir, autostart=False, queue_capacity=4,
                 supervise=False)
    try:
        with pytest.raises(serving.ServingError):
            pool.predict_async({"x": X}, priority="nope")
        with pytest.raises(serving.ServingError):
            pool.predict_async({"y": X})
        for _ in range(4):
            pool.predict_async({"x": X})
        with pytest.raises(serving.ServingQueueFull):
            pool.predict_async({"x": X})
        for rep in pool._replicas:
            rep.failed = True
        assert not pool.ready()
        with pytest.raises(serving.ServingDegraded):
            pool.predict_async({"x": X})
    finally:
        pool.stop(drain=False)
    with pytest.raises(serving.ServingClosed):
        pool.predict_async({"x": X})


def test_breaker_open_ejects_from_rotation(model_dir):
    with _pool(model_dir, breaker_cooldown_s=60.0) as pool:
        rep = pool._replicas[0]
        since = time.perf_counter()
        for _ in range(pool._breaker_threshold):
            rep.breaker.record_fatal()
        assert rep.wait_quiescent(since, timeout=5)
        assert rep.state() == "ejected" and pool.ready_replicas() == 1
        assert pool.state == "degraded" and pool.ready()
        before = rep.dispatches
        X = np.zeros((1, WIDTH), np.float32)
        for _ in range(6):
            pool.predict({"x": X}, timeout=30)
        assert rep.dispatches == before
        rep.breaker.record_success()
        assert pool.ready_replicas() == 2 and pool.state == "ready"


def test_set_active_replicas_clamps_and_parks(model_dir):
    X = np.zeros((1, WIDTH), np.float32)
    with _pool(model_dir, replicas=4) as pool:
        assert pool.set_active_replicas(9) == 4
        since = time.perf_counter()
        assert pool.set_active_replicas(0) == 1
        parked = pool._replicas[1]
        assert parked.state() == "parked" and parked.batcher.alive
        # a worker that passed its gate before the park may still claim
        # once from its pending pop: wait until it is seen parked
        assert parked.wait_quiescent(since, timeout=5)
        before = parked.dispatches
        for _ in range(4):
            pool.predict({"x": X}, timeout=30)
        assert parked.dispatches == before
        s0 = obs.counter("serving.replica.scale_ups").value
        assert pool.set_active_replicas(4) == 4
        assert obs.counter("serving.replica.scale_ups").value == s0 + 1


@pytest.mark.parametrize("initial,ticks", [
    # scale-up at once, scale-down after the window
    (1, [(3, 0, 3), (1, 1, 3), (1, 4, 3), (1, 6.1, 1)]),
    # a recovered window restarts the hysteresis
    (3, [(1, 0, 3), (3, 2, 3), (1, 3, 3), (1, 6, 3), (1, 8.1, 1)]),
    # a scale-down lands on the window's highest desire
    (4, [(1, 0, 4), (3, 2, 4), (2, 5.5, 3)]),
])
def test_autoscale_tick_hysteresis(model_dir, initial, ticks):
    with _pool(model_dir, replicas=4, initial_replicas=initial,
               scale_down_after_s=5.0) as pool:
        for desired, dt, want in ticks:
            assert pool.autoscale_tick(desired, now=100.0 + dt) == want


def test_scrape_driven_autoscaler(model_dir):
    obs.gauge("serving.autoscale.desired_replicas").set(1)
    try:
        with _pool(model_dir, replicas=3, initial_replicas=1,
                   scale_down_after_s=60.0) as pool:
            with pytest.raises(ValueError):
                pool.start_autoscaler(monitor=object(),
                                      metrics_url="http://x/metrics")
            srv = pool.serve_metrics()
            pool.start_autoscaler(metrics_url=srv.url + "/metrics",
                                  interval_s=0.05)
            obs.gauge("serving.autoscale.desired_replicas").set(3)
            deadline = time.time() + 10
            while time.time() < deadline and pool.active_replicas() != 3:
                time.sleep(0.02)
            assert pool.active_replicas() == 3
            pool.stop_autoscaler()
        assert not srv.running
    finally:
        obs.gauge("serving.autoscale.desired_replicas")._reset()


def test_slo_monitor_drives_activate_and_quiesce(model_dir):
    backlog = {"interactive": 0}
    mon = obs.SLOMonitor([], backlog_fn=lambda: dict(backlog),
                         service_rate_fn=lambda: 25.0, max_replicas=4)
    with _pool(model_dir, replicas=4, initial_replicas=1,
               scale_down_after_s=4.0) as pool:
        backlog["interactive"] = 100   # 100 rows at 25 rows/s: 4 replicas
        assert pool.autoscale_tick(mon.desired_replicas(), now=10.0) == 4
        backlog["interactive"] = 0
        assert pool.autoscale_tick(mon.desired_replicas(), now=11.0) == 4
        assert pool.autoscale_tick(mon.desired_replicas(), now=15.5) == 1
        states = [r.state() for r in pool._replicas]
        assert states.count("parked") == 3


def test_impaired_replicas_park_first_and_are_backfilled(model_dir):
    with _pool(model_dir, replicas=3, initial_replicas=2,
               supervise=False) as pool:
        pool._replicas[0].failed = True
        assert pool.set_active_replicas(2) >= 2
        assert pool._replicas[2].active          # spare backfilled
        assert pool.set_active_replicas(2) == 2
        assert not pool._replicas[0].active      # failed parked first
        assert pool.ready_replicas() == 2


def test_rolling_swap_flips_every_replica_and_drops_old_graphs(
        model_dir, tmp_path):
    d2 = _save_model(fluid, str(tmp_path / "v2"), seed=9)
    X = np.random.RandomState(1).rand(1, WIDTH).astype(np.float32)
    ref = serving.InferenceEngine(d2, batch_buckets=(2, 4), supervise=False,
                                  device="cpu")
    want = ref.predict({"x": X})[0]
    ref.stop()
    s0 = obs.counter("serving.replica.swapped").value
    with _pool(model_dir, warmup=True, backend="program") as pool:
        old = [r.model for r in pool._replicas]
        assert all(m._exe._holds_graphs() for m in old)
        assert pool.swap_model(d2) == 2
        assert pool.health()["model_versions"] == [2]
        assert obs.counter("serving.replica.swapped").value == s0 + 2
        assert all(m.closed and not m._exe._holds_graphs() for m in old)
        assert pool.predict({"x": X}, timeout=30)[0].tobytes() == \
            want.tobytes()


def test_swap_feed_mismatch_rejected(model_dir, tmp_path):
    bad = _save_model(fluid, str(tmp_path / "bad"), seed=9,
                      width=WIDTH + 2)
    X = np.zeros((1, WIDTH), np.float32)
    with _pool(model_dir) as pool:
        with pytest.raises(serving.ServingError, match="swap rejected"):
            pool.swap_model(bad)
        assert pool.state == "ready"
        assert pool.health()["model_versions"] == [1]
        assert pool.predict({"x": X}, timeout=30)[0].shape == (1, 4)


def test_swap_covers_the_sole_ready_replica(model_dir, tmp_path):
    d2 = _save_model(fluid, str(tmp_path / "v2"), seed=9)
    X = np.zeros((1, WIDTH), np.float32)
    with _pool(model_dir, initial_replicas=1, queue_capacity=512) as pool:
        stop = threading.Event()
        min_ready = [pool.ready_replicas()]
        futs = []

        def sampler():
            while not stop.is_set():
                min_ready[0] = min(min_ready[0], pool.ready_replicas())
                time.sleep(0.001)

        def submitter():
            while not stop.is_set():
                try:
                    futs.append(pool.predict_async({"x": X}))
                except serving.ServingQueueFull:
                    pass
                time.sleep(0.002)

        ths = [threading.Thread(target=sampler),
               threading.Thread(target=submitter)]
        for t in ths:
            t.start()
        try:
            with faults.slow_execute(0.03):
                time.sleep(0.1)
                assert pool.swap_model(d2) == 2
        finally:
            stop.set()
            for t in ths:
                t.join(timeout=30)
        for f in futs:
            f.result(timeout=60)
        assert min_ready[0] >= 1
        assert pool.active_replicas() == 1   # the cover re-parked
        assert pool.health()["model_versions"] == [2]


# -- the JAX pool's sessions and roles validation ----------------------------

@pytest.mark.parametrize("case, match", [
    ("bad_role", "roles must be 'both'/'prefill'/'decode'"),
    ("wrong_length", r"roles needs one entry per replica \(2\), got 3"),
    ("no_prefill", "roles leave no prefill-capable replica"),
    ("no_decode", "roles leave no decode-capable replica"),
    ("no_decode_model", "roles= specializes DECODE replicas"),
    ("sessions_without_prefix_cache",
     r"sessions require DecodeConfig\(prefix_cache=True\)"),
])
def test_sessions_and_roles_validation(decode_model, model_dir, case,
                                       match):
    cfg = {"warmup": False}
    with pytest.raises(serving.ServingError, match=match):
        if case == "no_decode_model":
            _pool(model_dir, roles=["both", "both"])
        elif case == "sessions_without_prefix_cache":
            _decode_pool(decode_model, cfg=cfg,
                         sessions=serving.SessionStore())
        else:
            roles = {"bad_role": ["both", "encode"],
                     "wrong_length": ["both"] * 3,
                     "no_prefill": ["decode", "decode"],
                     "no_decode": ["prefill", "prefill"]}[case]
            _decode_pool(decode_model, cfg=cfg, roles=roles)


def test_decode_replica_off_the_models_device_raises_naming_a11(lm):
    params, meta = lm
    model = TT.build_decode_model(params, meta, device="cpu")
    model.device = torch.device("cuda", 1)
    with pytest.raises(NotImplementedError, match="A11"):
        _decode_pool(model)


def test_the_default_devices_are_the_card(model_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.ReplicaPool(model_dir, replicas=2)
