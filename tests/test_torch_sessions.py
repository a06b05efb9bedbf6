"""The port's conversational sessions and prefill/decode roles
(``paddle_tpu_torch.serving``: ``SessionStore``, ``scoped_session``, the
scheduler's session pins and ``HandoffPacket``, the pool's ``sessions=``
and ``roles=``), on the CPU at ``tools/check_sessions.py``'s width
(vocab 60, 2 layers, 2 heads, d_model 32, d_inner 64, max_length 128;
the same ``lm_params`` arrays for both packages).

Against the JAX package: the store and ``scoped_session`` given the same
sequence of calls (records, release calls, ``stats()`` and the counters'
deltas, exactly), and a 3-turn conversation through a 3-replica
sessions pool (greedy tokens exactly the JAX sessions pool's).

Port against port, bitwise: warm turns against a cold re-prefill of the
same histories (with fewer prefill tokens), roles against role-less (with
the handoff counters), two schedulers wired by hand through
``on_handoff``, and the session owner killed mid-turn.  No page leaks
after a cancelled turn, a turn shed at admission, TTL expiry,
``end_session`` and ``stop()``.  ROADMAP F-13's repair: a parked turn
pins exactly its prompt's full pages (the pages a prefill chunk wrote),
and the next turn prefills the rest again.
"""
import time

import numpy as np
import pytest
import torch

from paddle_tpu import observability as jobs
from paddle_tpu import serving as jserving
from paddle_tpu.models import transformer as JT
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import serving
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.testing import faults

DIMS = dict(vocab_size=60, n_layer=2, n_head=2, d_model=32, d_inner=64,
            max_length=128)
DCFG = dict(num_slots=2, page_size=8, max_seq_len=112, max_new_tokens=8,
            prefill_chunk_tokens=16, prefix_cache=True, queue_capacity=64)
NEW = 8
SESSION_COUNTERS = ("parked", "resumed", "expired", "evicted", "ended")
HANDOFF_COUNTERS = ("packets", "pages", "bytes", "injected", "failed")


@pytest.fixture(scope="module")
def lm():
    return TT.lm_params(seed=31, **DIMS)


@pytest.fixture(scope="module")
def model(lm):
    params, meta = lm
    return TT.build_decode_model(params, meta, device="cpu")


def _pool(model, replicas=3, pool_kw=None, **cfg):
    return serving.ReplicaPool(
        None, replicas=replicas, devices=["cpu"], decode_model=model,
        decode_config=serving.DecodeConfig(**dict(DCFG, **cfg)),
        supervisor_interval_s=0.05, **(pool_kw or {}))


def _conversations(n_users, n_turns, seed=3):
    rng = np.random.RandomState(seed)
    base = [rng.randint(1, 60, size=20).astype(np.int32)
            for _ in range(n_users)]
    utts = [[rng.randint(1, 60, size=12).astype(np.int32)
             for _ in range(n_turns - 1)] for _ in range(n_users)]
    return base, utts


def _run(pool, base, utts, sessions=True):
    """Every conversation's turns, users interleaved within a turn; the
    tokens by user and turn."""
    hists = [list(map(int, b)) for b in base]
    outs = [[] for _ in base]
    for t in range(len(utts[0]) + 1):
        if t:
            for u in range(len(base)):
                hists[u] += list(map(int, utts[u][t - 1]))
        futs = [pool.generate_async(
            np.asarray(hists[u], np.int32), max_new_tokens=NEW,
            **({"session": "u%d" % u} if sessions else {}))
            for u in range(len(base))]
        for u, f in enumerate(futs):
            out = list(map(int, f.result(timeout=120)))
            outs[u].append(out)
            hists[u] += out
    return outs


def _no_leaks(pool):
    """Every replica's allocator sweep after the pins drained: 0 used
    pages, no refcount report."""
    deadline = time.perf_counter() + 5
    while time.perf_counter() < deadline and any(
            r.decoder.cache_stats()["used_pages"] for r in pool._replicas):
        time.sleep(0.01)
    for r in pool._replicas:
        st = r.decoder.cache_stats()
        assert st["used_pages"] == 0 and not st["rc_errors"], st
        assert st["rc_sum_matches"], st


def _counters(pkg_obs, family, names):
    return {n: pkg_obs.counter("serving.%s.%s" % (family, n)).value
            for n in names}


def _delta(pkg_obs, family, names, before):
    after = _counters(pkg_obs, family, names)
    return {n: after[n] - before[n] for n in names}


# -- SessionStore and scoped_session against the JAX package ----------------

def _store_script(mod, case):
    """Drive ``mod``'s SessionStore through ``case``; the log of what it
    returned and released."""
    log = []

    def release(tag):
        def cb(pages):
            log.append(("release", tag, list(pages)))
            if tag == "bad":
                raise RuntimeError("a dead scheduler's release")
        return cb

    def rec(r):
        return None if r is None else (r.key, r.replica, r.history_len,
                                       list(r.pages), r.turns)

    store = mod.SessionStore(**({"capacity": 2} if case == "capacity"
                                else {}))
    if case == "park_get_end":
        log.append(rec(store.park("a", 0, 40, [1, 2], release("r0"))))
        log.append(rec(store.park("b", 1, 24, [3], release("r1"))))
        log.append(rec(store.get("a")))
        log.append(rec(store.get("a", touch=False)))
        log.append(rec(store.get("missing")))
        log.append(store.end_session("a"))
        log.append(store.end_session("a"))
    elif case == "repark":
        store.park("a", 0, 40, [1, 2], release("r0"))
        log.append(rec(store.park("a", 2, 60, [7, 8, 9], release("r2"))))
    elif case == "capacity":
        for i, k in enumerate("abc"):
            if k == "c":
                log.append(rec(store.get("a")))   # b is now the LRU
            log.append(rec(store.park(k, i, 8 * (i + 1), [i + 1],
                                      release("r%d" % i))))
    elif case == "ttl":
        store.ttl_s = 10.0
        store.park("a", 0, 40, [1, 2], release("r0"))
        store.park("b", 1, 24, [3], release("r1"))
        store.park("c", 2, 16, [4], release("r2"))
        store._records["a"].last_used -= 100.0
        log.append(rec(store.get("a")))           # expired on read
        log.append(store.expire(now=time.perf_counter() + 5.0))
        log.append(store.expire(now=time.perf_counter() + 100.0))
    elif case == "clear":
        store.park("a", 0, 40, [1, 2], release("r0"))
        store.park("b", 1, 24, [], release("r1"))
        log.append(store.clear())
    elif case == "failing_release":
        store.park("a", 0, 40, [1], release("bad"))
        store.park("b", 0, 40, [2], release("r0"))
        log.append(store.end_session("a"))
        log.append(store.clear())
    log.append(sorted(store.keys()))
    log.append(store.stats())
    return log


@pytest.mark.parametrize("case", ["park_get_end", "repark", "capacity",
                                  "ttl", "clear", "failing_release"])
def test_session_store_matches_the_jax_store(case):
    outs = []
    for mod, pkg_obs in ((jserving, jobs), (serving, obs)):
        before = _counters(pkg_obs, "session", SESSION_COUNTERS)
        log = _store_script(mod, case)
        gauges = [pkg_obs.gauge("serving.session.%s" % n).value
                  for n in ("active", "pinned_pages")]
        outs.append((log, _delta(pkg_obs, "session", SESSION_COUNTERS,
                                 before), gauges))
    assert outs[1] == outs[0]


@pytest.mark.parametrize("triple", [("dep", "tenant", "s1"),
                                    ("dep", None, "s1"),
                                    ("a/b", "", "c\x1fd"), (1, 2, 3)])
def test_scoped_session_matches_the_jax_key(triple):
    from paddle_tpu.serving.sessions import scoped_session as jscoped

    assert serving.scoped_session(*triple) == jscoped(*triple)
    assert serving.scoped_session(*triple).count("\x1f") >= 2


# -- the sessions pool against the JAX pool ---------------------------------

@pytest.fixture(scope="module")
def conversations():
    return _conversations(3, 3)


@pytest.fixture(scope="module")
def warm_run(model, conversations):
    """The port's 3-replica sessions pool over the conversations: tokens,
    prefill tokens, the store's stats and the hit pages."""
    prefill = obs.counter("serving.decode.prefill_tokens")
    hits = obs.counter("serving.decode.kv_hit_pages")
    with _pool(model) as pool:
        p0, h0 = prefill.value, hits.value
        outs = _run(pool, *conversations)
        res = {"outs": outs, "prefill": prefill.value - p0,
               "hits": hits.value - h0, "stats": pool.sessions.stats(),
               "health": pool.health()["decode"]}
        for u in range(3):
            assert pool.end_session("u%d" % u)
        _no_leaks(pool)
    return res


def test_sessions_pool_greedy_tokens_equal_the_jax_sessions_pool(
        lm, conversations, warm_run):
    params, meta = lm
    jpool = jserving.ReplicaPool(
        None, replicas=3, decode_model=JT.build_decode_model(params, meta),
        decode_config=jserving.DecodeConfig(**DCFG),
        supervisor_interval_s=0.05)
    try:
        assert jpool.sessions is not None
        want = _run(jpool, *conversations)
    finally:
        jpool.stop()
    assert warm_run["outs"] == want


def test_warm_turns_are_bitwise_cold_with_fewer_prefill_tokens(
        model, conversations, warm_run):
    prefill = obs.counter("serving.decode.prefill_tokens")
    with _pool(model, prefix_cache=False) as cold:
        assert cold.sessions is None
        p0 = prefill.value
        outs = _run(cold, *conversations, sessions=False)
        cold_prefill = prefill.value - p0
    assert warm_run["outs"] == outs
    assert warm_run["prefill"] < cold_prefill
    assert warm_run["hits"] > 0
    assert warm_run["stats"]["active"] == 3
    assert warm_run["stats"]["pinned_pages"] > 0
    assert warm_run["health"]["sessions"]["active"] == 3
    assert warm_run["health"]["roles"] == ["both"] * 3


def test_roles_are_bitwise_role_less_through_the_handoff(
        model, conversations, warm_run):
    before = _counters(obs, "handoff", HANDOFF_COUNTERS)
    with _pool(model, pool_kw=dict(roles=("prefill", "decode",
                                          "decode"))) as pool:
        outs = _run(pool, *conversations)
        moved = _delta(obs, "handoff", HANDOFF_COUNTERS, before)
        stats = [r.decoder.stats() for r in pool._replicas]
        roles = pool.health()["decode"]["roles"]
        for u in range(3):
            pool.end_session("u%d" % u)
        _no_leaks(pool)
    assert outs == warm_run["outs"]
    n = 3 * 3                        # every generation crossed
    assert moved["packets"] == moved["injected"] == n
    assert moved["failed"] == 0 and moved["pages"] >= n
    assert roles == ["prefill", "decode", "decode"]
    assert stats[0]["role"] == "prefill" and stats[0]["completed"] == 0
    assert stats[1]["completed"] + stats[2]["completed"] == n
    # the packets hold only their sequences' pages
    L, ps, H = DIMS["n_layer"], DCFG["page_size"], DIMS["n_head"]
    D = DIMS["d_model"] // H
    assert moved["bytes"] == 2 * moved["pages"] * L * ps * H * D * 4


# -- the scheduler's roles, wired by hand -----------------------------------

def _sched(model, **kw):
    cfg = serving.DecodeConfig(**dict(DCFG, **kw.pop("cfg", {})))
    return serving.DecodeScheduler(model, config=cfg, **kw)


def test_handoff_between_two_schedulers_is_bitwise_one(model):
    prompts = [np.arange(1, n, dtype=np.int32) % 59 + 1
               for n in (5, 17, 30)]
    solo = _sched(model)
    want = [solo.generate(p, max_new_tokens=NEW) for p in prompts]
    solo.stop()
    packets = []
    dec = _sched(model, role="decode", replica_index=1)

    def hand(packet):
        packets.append(packet)
        return dec.inject_handoff(packet)

    pre = _sched(model, role="prefill", on_handoff=hand)
    got = [pre.generate(p, max_new_tokens=NEW, timeout=60)
           for p in prompts]
    pre.stop()
    dec.stop()
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()
    L, H, D = DIMS["n_layer"], DIMS["n_head"], DIMS["d_model"] // 2
    for p, pk in zip(prompts, packets):
        n = -(-len(p) // DCFG["page_size"])
        assert pk.n_pages == n and pk.kv_len == len(p) and pk.origin == 0
        assert tuple(pk.k_host.shape) == (L, n, DCFG["page_size"], H, D)
        assert pk.k_host.dtype == torch.float32 == pk.v_host.dtype
        assert pk.req.handoff_origin == 0
    assert pre.stats()["completed"] == 0 and dec.stats()["completed"] == 3
    assert pre.stats()["role"] == "prefill"
    for s in (pre, dec):
        assert s.cache_stats()["used_pages"] == 0


def test_a_refused_handoff_fails_typed_and_frees_its_pages(model):
    failed = obs.counter("serving.handoff.failed")
    f0 = failed.value
    pre = _sched(model, role="prefill", on_handoff=lambda packet: False)
    req = pre.submit(np.arange(1, 20, dtype=np.int32), max_new_tokens=NEW)
    with pytest.raises(serving.ServingDegraded, match="handoff failed"):
        req.result(timeout=60)
    pre.stop()
    assert failed.value - f0 == 1
    assert pre.cache_stats()["used_pages"] == 0


def test_queued_packets_fail_with_the_scheduler(model):
    dec = _sched(model, role="decode", autostart=False)
    pre = _sched(model, role="prefill", autostart=False,
                 on_handoff=dec.inject_handoff)
    pre.start()
    req = pre.submit(np.arange(1, 20, dtype=np.int32), max_new_tokens=NEW)
    deadline = time.perf_counter() + 30
    while not dec._pending_handoffs and time.perf_counter() < deadline:
        time.sleep(0.005)
    assert not dec.idle()            # a packet waits to be seated
    dec.stop(drain=False)
    with pytest.raises(serving.ServingClosed):
        req.result(timeout=30)
    assert not dec.inject_handoff(object())
    pre.stop()


def test_role_and_sessions_validation(model):
    with pytest.raises(serving.ServingError, match="role must be"):
        _sched(model, role="encode", cfg={"warmup": False})
    with pytest.raises(serving.ServingError, match="sessions require"):
        _sched(model, sessions=serving.SessionStore(),
               cfg={"prefix_cache": False, "warmup": False})
    params, meta = TT.lm_params(seed=31, **DIMS)
    legacy = TT.build_decode_model(params, meta, device="cpu",
                                   chunked=False)
    with pytest.raises(serving.ServingError, match="role='prefill'"):
        serving.DecodeScheduler(legacy, role="prefill",
                                config=serving.DecodeConfig(warmup=False))


# -- F-13: a parked turn pins only the pages a prefill chunk wrote ----------

def test_a_parked_turn_pins_its_prompts_full_pages_only(model):
    ps = DCFG["page_size"]
    store = serving.SessionStore()
    sched = _sched(model, sessions=store)
    prefill = obs.counter("serving.decode.prefill_tokens")
    prompt = np.arange(1, 30, dtype=np.int32) % 59 + 1     # 29 tokens
    out = sched.generate(prompt, max_new_tokens=NEW, session="s",
                         timeout=60)
    rec = store.get("s", touch=False)
    cache = sched._cache
    n_prompt = len(prompt) // ps                            # 3 pages
    assert (len(prompt) + NEW - 1) // ps > n_prompt         # decode pages
    assert rec.replica == 0 and rec.history_len == len(prompt) + NEW
    assert rec.pages == cache._indexed_run(cache.prefix_hashes(prompt),
                                           n_prompt)
    assert len(rec.pages) == n_prompt
    # the next turn maps the prompt's pages and prefills the rest again
    turn2 = np.concatenate([prompt, out, [7, 8, 9]]).astype(np.int32)
    p0 = prefill.value
    sched.generate(turn2, max_new_tokens=NEW, session="s", timeout=60)
    assert prefill.value - p0 == len(turn2) - n_prompt * ps
    rec2 = store.get("s", touch=False)
    assert rec2.turns == 2 and len(rec2.pages) == len(turn2) // ps
    assert store.end_session("s")
    sched.stop()
    assert sched.cache_stats()["used_pages"] == 0


# -- early exits, expiry and the owner's death ------------------------------

def test_cancel_shed_ttl_and_end_session_leak_nothing(model,
                                                      conversations):
    base, utts = conversations
    store = serving.SessionStore(capacity=64, ttl_s=0.5)
    with _pool(model, pool_kw=dict(sessions=store)) as pool:
        _run(pool, base, [u[:1] for u in utts])
        assert store.stats()["active"] == 3
        hist = np.concatenate([base[0], [1, 2, 3]]).astype(np.int32)
        can = pool.generate_async(hist, max_new_tokens=NEW, session="u0")
        while not can.token_times and not can.done():
            time.sleep(0.002)
        can.cancel()
        queued = [pool.generate_async(hist, max_new_tokens=NEW,
                                      session="u1") for _ in range(6)]
        for q in queued:
            q.cancel()
        try:                         # shed at admission, or in queue
            late = [pool.generate_async(hist, max_new_tokens=NEW,
                                        session="u2", deadline_ms=0.001)]
        except serving.ServingOverloaded:
            late = []
        for req in [can] + late + queued:
            try:
                req.result(timeout=60)
            except (serving.ServingCancelled, serving.ServingTimeout):
                pass
        assert pool.end_session("u0") and not pool.end_session("nope")
        deadline = time.perf_counter() + 10
        while store.stats()["active"] and time.perf_counter() < deadline:
            time.sleep(0.05)
        assert store.stats() == {"active": 0, "capacity": 64,
                                 "ttl_s": 0.5, "pinned_pages": 0}
        _no_leaks(pool)


def test_stop_releases_every_pin(model, conversations):
    base, _ = conversations
    pool = _pool(model)
    _run(pool, base, [[]])
    assert pool.sessions.stats()["pinned_pages"] > 0
    pool.stop()
    assert pool.sessions.stats()["active"] == 0
    for r in pool._replicas:
        assert r.decoder.cache_stats()["used_pages"] == 0


def test_kill_session_owner_replays_bitwise(model, warm_run,
                                            conversations):
    base, utts = conversations
    with _pool(model) as pool:
        with pytest.raises(LookupError):
            with faults.kill_session_owner(pool, "u0"):
                pass
        hist = list(map(int, base[0]))
        outs = [list(map(int, pool.generate(
            np.asarray(hist, np.int32), max_new_tokens=NEW, session="u0",
            timeout=120)))]
        for t in (1, 2):
            hist += outs[-1] + list(map(int, utts[0][t - 1]))
            if t == 1:
                with faults.kill_session_owner(pool, "u0",
                                               min_tokens=2) as fired:
                    out = pool.generate(np.asarray(hist, np.int32),
                                        max_new_tokens=NEW, session="u0",
                                        timeout=120)
                assert fired[0] == 1
            else:
                out = pool.generate(np.asarray(hist, np.int32),
                                    max_new_tokens=NEW, session="u0",
                                    timeout=120)
            outs.append(list(map(int, out)))
        assert outs == warm_run["outs"][0]
        assert pool.end_session("u0")
        _no_leaks(pool)


def test_a_sticky_owner_that_cannot_claim_falls_back(model):
    fallbacks = obs.counter("serving.affinity.fallbacks")
    sticky = obs.counter("serving.affinity.sticky")
    with _pool(model, warmup=False, pool_kw=dict(
            autostart=False, supervise=False)) as pool:
        pool._sessions.park("s", 1, 10, [], None)
        req = serving.GenerateRequest(np.arange(1, 10, dtype=np.int32), 4,
                                      session="s")
        s0 = sticky.value
        pool._stamp_affinity(req)    # the workers never started: dead
        assert req.affinity != 1 and sticky.value == s0
        f0 = fallbacks.value
        pool._replicas[1].decoder.start()
        pool._replicas[1].draining = True
        pool._stamp_affinity(req)
        assert fallbacks.value - f0 == 1 and req.affinity != 1
        pool._replicas[1].draining = False
        pool._stamp_affinity(req)
        assert req.affinity == 1 and sticky.value - s0 == 1
