"""The rest of the port's decode runtime on the CPU: the compiled steps'
device scalars, the prefix cache, the KV guard, journals and the fault
choke point (paddle_tpu_torch.serving.decode_scheduler, kv_cache).

Cross-package: the LM steps with tensor ``start``/``valid``/``length``
against the JAX steps (logits within 1e-5: float32 end to end, but XLA's
and MKL's matmuls sum in different orders), B5's plain version with a
tensor start against the JAX kernel's reference (1e-5), the port's greedy
tokens against the JAX engine's token for token (prefix cache cold then
warm, the KV guard, chunked and monolithic), and ``PagedKVCache``'s
prefix index driven through the same operations as the JAX package's
(pages, refcounts and ``prefix_stats`` equal).  Port-vs-port, bitwise:
the ported ``TestPrefixCache`` cases, ``corrupt_kv_page`` failing exactly
one sequence, journal replay (greedy and seeded), and the step cache's
keys and compile count.
"""
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import serving as jserving
from paddle_tpu.models import transformer as JT
from paddle_tpu.parallel import flash_attention as jfa
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import serving
from paddle_tpu_torch.executor import compile_count
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.parallel import flash_attention as tfa
from paddle_tpu_torch.testing import faults

RTOL = ATOL = 1e-5
DIMS = dict(vocab_size=50, n_layer=2, n_head=2, d_model=32, d_inner=64,
            max_length=128)
PS, MP, P = 8, 8, 24   # page size, pages per sequence, pool pages


@pytest.fixture(scope="module")
def lm():
    return TT.lm_params(seed=7, **DIMS)


@pytest.fixture(scope="module")
def decode_model(lm):
    params, meta = lm
    return TT.build_decode_model(params, meta, device="cpu")


def _cfg(**kw):
    base = dict(num_slots=4, page_size=8, max_seq_len=64, max_new_tokens=8)
    base.update(kw)
    return serving.DecodeConfig(**base)


def _i32(v):
    return torch.tensor([v], dtype=torch.int32)


def _pools(seed):
    rng = np.random.RandomState(seed)
    shape = (DIMS["n_layer"], P, PS, DIMS["n_head"],
             DIMS["d_model"] // DIMS["n_head"])
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


# -- the steps take device scalars --------------------------------------------

# (start, valid, width): a first chunk, a resumed tail at a page boundary,
# a one-token tail
@pytest.mark.parametrize("start,valid,C", [(0, 13, 16), (16, 5, 8),
                                           (24, 1, 8)])
def test_lm_prefill_chunk_tensor_scalars_match_jax(lm, start, valid, C):
    params, meta = lm
    model = TT.params_from_numpy(params, "cpu", meta=meta)
    rng = np.random.RandomState(start + valid)
    tokens = np.zeros(C, np.int32)
    tokens[:valid] = rng.randint(1, DIMS["vocab_size"], size=valid)
    table = np.array([5, 2, 9, 11, 3, 0, 0, 0], np.int32)
    chunk = table[start // PS:start // PS + C // PS].copy()
    kp, vp = _pools(start)
    want, jk, jv = JT.lm_prefill_chunk(
        params, jnp.asarray(tokens), jnp.int32(start), jnp.int32(valid),
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(chunk),
        jnp.asarray(table), n_head=meta["n_head"])
    kt, vt = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    with torch.no_grad():
        got = TT.lm_prefill_chunk(
            model, torch.from_numpy(tokens), _i32(start), _i32(valid), kt,
            vt, torch.from_numpy(chunk), torch.from_numpy(table))
        # the int form (a direct caller's) gives the same bits
        again = TT.lm_prefill_chunk(
            model, torch.from_numpy(tokens), start, valid,
            torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy()),
            torch.from_numpy(chunk), torch.from_numpy(table))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(kt.numpy(), np.asarray(jk), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(jv), rtol=RTOL,
                               atol=ATOL)
    assert got.numpy().tobytes() == again.numpy().tobytes()


@pytest.mark.parametrize("n,T", [(13, 16), (1, 8)])
def test_lm_prefill_tensor_length_matches_jax(lm, n, T):
    params, meta = lm
    model = TT.params_from_numpy(params, "cpu", meta=meta)
    rng = np.random.RandomState(n)
    tokens = np.zeros(T, np.int32)
    tokens[:n] = rng.randint(1, DIMS["vocab_size"], size=n)
    want = JT.lm_prefill(params, jnp.asarray(tokens), jnp.int32(n),
                         n_head=meta["n_head"], use_flash=True)
    with torch.no_grad():
        got = TT.lm_prefill(model, torch.from_numpy(tokens), _i32(n),
                            use_flash=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("start,C", [(0, 16), (37, 5), (120, 8)])
def test_b5_plain_tensor_start_equals_int_and_jax(start, C):
    rng = np.random.RandomState(C)
    q = rng.randn(C, 2, 32).astype(np.float32)
    kp = rng.randn(P, PS, 2, 32).astype(np.float32)
    vp = rng.randn(P, PS, 2, 32).astype(np.float32)
    pages = rng.permutation(np.arange(1, P))[:16].astype(np.int32)
    args = [torch.from_numpy(a) for a in (q, kp, vp, pages)]
    by_int = tfa.paged_prefill_attention(*args, start)
    by_tensor = tfa.paged_prefill_attention(*args, _i32(start))
    plain = tfa._paged_prefill_reference(*args, _i32(start),
                                         1.0 / np.sqrt(32))
    assert by_int.numpy().tobytes() == by_tensor.numpy().tobytes() \
        == plain.numpy().tobytes()
    want = jfa.paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(pages), jnp.int32(start))
    np.testing.assert_allclose(by_tensor.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_b5_wrapper_passes_start_by_address(monkeypatch):
    """B5's wrapper hands the kernel the start tensor's address and reads
    no value of it on the host (a stand-in library records the call;
    nothing is launched), so a captured launch takes each replay's
    start."""
    from paddle_tpu_torch import cuda_kernels

    calls = []

    class Lib:
        def pt_paged_prefill(self, *args):
            calls.append(args)
            return 0

    def no_host_read(*args, **kwargs):
        raise AssertionError("the wrapper read a tensor on the host")

    monkeypatch.setattr(cuda_kernels, "load_library", Lib)
    monkeypatch.setattr(tfa, "_device_index", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {
                            "cuda_stream": 0})())
    monkeypatch.setitem(tfa.KERNEL_LAUNCHES, "paged_prefill_attention", 0)
    q = torch.randn(8, 2, 32)
    pool = torch.randn(P, PS, 2, 32)
    pages = torch.arange(1, 9, dtype=torch.int32)
    start = _i32(24)
    with monkeypatch.context() as m:
        for attr in ("item", "tolist", "cpu", "numpy", "__int__",
                     "__index__"):
            m.setattr(torch.Tensor, attr, no_host_read)
        out = tfa._paged_prefill_cuda(q, pool, pool, pages, start, 0.25)
    (args,) = calls
    assert args[3:6] == (pages.data_ptr(), start.data_ptr(), out.data_ptr())
    assert args[6:11] == (8, 2, 32, PS, 8)
    assert tfa.KERNEL_LAUNCHES["paged_prefill_attention"] == 1
    with pytest.raises(ValueError, match="start"):
        tfa._paged_prefill_cuda(q, pool, pool, pages,
                                torch.tensor([1, 2], dtype=torch.int32), 0.25)


def test_paged_kv_finite_matches_jax():
    rng = np.random.RandomState(4)
    k = rng.randn(2, 6, PS, 2, 8).astype(np.float32)
    v = rng.randn(2, 6, PS, 2, 8).astype(np.float32)
    k[1, 3, 2, 1, 0] = np.nan
    v[0, 5, 0, 0, 7] = np.inf
    pages = np.array([0, 3, 5, 2, 3], np.int32)
    want = np.asarray(jfa.paged_kv_finite(jnp.asarray(k), jnp.asarray(v),
                                          jnp.asarray(pages)))
    got = tfa.paged_kv_finite(torch.from_numpy(k), torch.from_numpy(v),
                              torch.from_numpy(pages)).numpy()
    assert got.dtype == np.bool_ and (got == want).all()
    assert got.tolist() == [True, False, False, True, False]


# -- greedy tokens against the JAX engine -------------------------------------

def _shared_prefix_prompts(seed, n=4, prefix=20, tail=(2, 9)):
    rng = np.random.RandomState(seed)
    head = rng.randint(1, DIMS["vocab_size"], size=prefix).astype(np.int32)
    return [np.concatenate([head, rng.randint(
        1, DIMS["vocab_size"], size=rng.randint(*tail)).astype(np.int32)])
        for _ in range(n)]


def _serve_twice(make, prompts, cfg):
    """Each prompt served twice in turn through one scheduler (the second
    pass warm when the prefix cache is on); the tokens and stats."""
    sched = make(cfg)
    try:
        outs = [sched.generate(p, timeout=120) for p in prompts + prompts]
        return outs, sched.stats()
    finally:
        sched.stop()


@pytest.mark.parametrize("knobs", [
    dict(prefix_cache=True),
    dict(prefix_cache=True, prefill_chunk_tokens=8),
    dict(kv_guard=True),
    dict(kv_guard=True, prefix_cache=True, prefill_chunk_tokens=16),
], ids=["prefix", "prefix-chunked", "guard", "guard-prefix-chunked"])
def test_greedy_tokens_identical_to_jax_engine(lm, decode_model, knobs):
    params, meta = lm
    prompts = _shared_prefix_prompts(sum(len(k) for k in knobs))
    base = dict(num_slots=4, page_size=8, max_seq_len=64, max_new_tokens=6,
                **knobs)
    jmodel = JT.build_decode_model(params, meta)
    want, jstats = _serve_twice(
        lambda c: jserving.DecodeScheduler(jmodel, c), prompts,
        jserving.DecodeConfig(**base))
    got, tstats = _serve_twice(
        lambda c: serving.DecodeScheduler(decode_model, c), prompts,
        serving.DecodeConfig(**base))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.int32 and g.tobytes() == w.tobytes(), (i, g, w)
    assert tstats["kv_pages_used"] == 0
    if knobs.get("prefix_cache"):
        assert tstats["prefix"] == jstats["prefix"]
        assert tstats["prefix"]["kv_hit_pages"] > 0


# -- PagedKVCache's prefix index ----------------------------------------------

def _cache_state(c):
    return {"rc": list(c._rc), "used": c.used_pages,
            "cached": c.cached_pages, "shared": c.shared_pages,
            "free": c.free_pages, "stats": c.prefix_stats()}


def test_kv_cache_prefix_unit_matches_jax():
    """TestPrefixCache.test_kv_cache_prefix_unit's operations on both
    packages' caches: the same pages, refcounts and prefix_stats after
    every step, and the same eviction count."""
    caches = (jserving.PagedKVCache(1, num_pages=9, page_size=4,
                                    num_heads=2, head_dim=8, max_seq_len=32),
              serving.PagedKVCache(1, num_pages=9, page_size=4, num_heads=2,
                                   head_dim=8, max_seq_len=32,
                                   device="cpu"))
    toks = np.arange(100, 113, dtype=np.int32)  # 13 tokens: 3 full pages
    toks3 = toks.copy()
    toks3[5] = 999
    ev = [obs.counter("serving.decode.kv_evictions")]
    from paddle_tpu import observability as jobs
    ev.append(jobs.counter("serving.decode.kv_evictions"))
    trace = []
    for c in caches:
        log = []
        pages, hashes = c.lookup_prefix(toks)
        log.append((pages, len(hashes)))
        owned = c.alloc(4)
        log.append([c.register_prefix(hashes, i, owned[i])
                    for i in range(3)])
        log.append(c.register_prefix(hashes, 0, owned[3]))
        c.free(owned)
        log.append(_cache_state(c))
        pages2, _ = c.lookup_prefix(toks)
        log.append((pages2, _cache_state(c)))
        log.append((c.peek_prefix(toks), c.peek_hashes(hashes)))
        c.free(pages2)
        pages3, _ = c.lookup_prefix(toks3)
        log.append((pages3, _cache_state(c)))
        c.free(pages3)
        pinned = c.pin_prefix(toks)
        log.append((pinned, _cache_state(c)))
        c.free(pinned)
        big = c.alloc(8)
        log.append((big, _cache_state(c)))
        log.append(c.lookup_prefix(toks)[0])
        c.free(big)
        st = c.stats()
        log.append((st["rc_errors"], st["rc_sum_matches"], st["used_pages"]))
        trace.append(log)
        assert c.prefix_hashes(toks) == hashes
    assert trace[0] == trace[1]
    assert trace[1][1] == [True, True, True] and trace[1][2] is False
    assert trace[1][-3][1]["stats"]["kv_evictions"] == 3
    assert trace[1][-2] == []


def test_reset_and_scrub_write_in_place(decode_model):
    sched = serving.DecodeScheduler(
        decode_model, _cfg(prefix_cache=True, max_active=1,
                           max_new_tokens=40, warmup=False))
    cache = sched._cache
    ptrs = (cache.k_pool.data_ptr(), cache.v_pool.data_ptr())
    try:
        req = sched.submit(np.arange(1, 9, dtype=np.int32))
        deadline = time.time() + 60
        while not req.token_times and time.time() < deadline:
            time.sleep(0.002)
        with pytest.raises(serving.ServingError, match="live sequence"):
            cache.reset_pools()
        req.cancel()
        with pytest.raises(serving.ServingCancelled):
            req.result(timeout=60)
        # the worker, idle, touches the cache no more
        while (not sched.idle() or cache.used_pages) \
                and time.time() < deadline:
            time.sleep(0.002)
        assert sched.idle() and cache.used_pages == 0
        # the first prompt's full page is indexed; a scrub zeroes it in
        # place and drops it from the index, and reset_pools zeroes
        # everything
        assert cache.prefix_stats()["indexed_pages"] == 1
        page = next(iter(cache._hash_of_page))
        cache.scrub_pages([page])
        assert not cache.k_pool[:, page].any() \
            and not cache.v_pool[:, page].any()
        assert cache.prefix_stats()["indexed_pages"] == 0
        cache.k_pool.fill_(1.0)
        cache.reset_pools()
        assert not cache.k_pool.any()
        assert (cache.k_pool.data_ptr(), cache.v_pool.data_ptr()) == ptrs
    finally:
        sched.stop()
    # a stopped scheduler holds its pools no more
    assert cache.k_pool is None and cache.v_pool is None


# -- the ported TestPrefixCache cases -----------------------------------------

def test_last_token_always_prefills(decode_model):
    pt = obs.counter("serving.decode.prefill_tokens")
    sched = serving.DecodeScheduler(decode_model, _cfg(prefix_cache=True))
    prompt = np.arange(1, 17, dtype=np.int32)  # exactly 2 pages
    try:
        sched.generate(prompt, max_new_tokens=2, timeout=120)
        p0 = pt.value
        out = sched.generate(prompt, max_new_tokens=2, timeout=120)
    finally:
        sched.stop()
    assert out.shape == (2,)
    # the reuse cap is len(prompt) - 1 tokens: the last page reruns
    assert pt.value - p0 == 8


def test_eviction_under_pressure_serves_correctly(decode_model):
    rng = np.random.RandomState(33)
    prompts = [rng.randint(1, 50, size=rng.randint(30, 40)).astype(np.int32)
               for _ in range(5)]
    ev = obs.counter("serving.decode.kv_evictions")
    e0 = ev.value
    sched = serving.DecodeScheduler(decode_model,
                                    _cfg(prefix_cache=True, num_pages=12))
    try:
        got = [sched.generate(p, timeout=120) for p in prompts]
        assert sched.stats()["kv_pages_used"] == 0
    finally:
        sched.stop()
    assert ev.value - e0 > 0, "undersized pool never evicted"
    ref = serving.DecodeScheduler(decode_model, _cfg())
    try:
        want = [ref.generate(p, timeout=120) for p in prompts]
    finally:
        ref.stop()
    for a, b in zip(got, want):
        assert a.tobytes() == b.tobytes()


def test_parked_hol_probes_once(decode_model):
    # a head-of-line request parked on pool exhaustion carries its probe
    # result (pages pinned): the miss counter moves once an admission
    miss = obs.counter("serving.decode.kv_miss_pages")
    sched = serving.DecodeScheduler(
        decode_model, _cfg(prefix_cache=True, num_pages=8, num_slots=2))
    m0 = miss.value
    try:
        a = sched.submit(np.arange(1, 17, dtype=np.int32), max_new_tokens=32)
        b = sched.submit(np.arange(30, 47, dtype=np.int32), max_new_tokens=8)
        a.result(timeout=120)
        b.result(timeout=120)
    finally:
        sched.stop()
    # one probe each: A misses (16-1)//8 = 1 page, B (17-1)//8 = 2
    assert miss.value - m0 == 3


# -- the KV guard and the fault choke point -----------------------------------

def test_corrupt_kv_page_fails_exactly_one_sequence(decode_model):
    prefix = np.arange(1, 17, dtype=np.int32)          # 2 full pages
    pa, pb, pc = (np.concatenate([prefix, np.asarray(t, np.int32)])
                  for t in ([21, 22, 23], [31, 32, 33], [41, 42, 43]))
    cfg = lambda: _cfg(num_slots=4, prefill_chunk_tokens=8,  # noqa: E731
                       prefix_cache=True, kv_guard=True, max_new_tokens=12)
    clean = serving.DecodeScheduler(decode_model, cfg())
    try:
        ca, cb, cc = (clean.generate(p, timeout=120) for p in (pa, pb, pc))
    finally:
        clean.stop()
    trips = obs.counter("serving.decode.kv_guard_trips")
    t0 = trips.value
    sched = serving.DecodeScheduler(decode_model, cfg())
    try:
        assert sched.generate(pa, timeout=120).tobytes() == ca.tobytes()
        fb, fc = sched.submit(pb), sched.submit(pc)
        with faults.corrupt_kv_page(sched, seq=fb.seq, after_tokens=1) \
                as fired:
            with pytest.raises(serving.KVCorruption, match="scrubbed"):
                fb.result(timeout=120)
            assert fc.result(timeout=120).tobytes() == cc.tobytes()
        assert fired[0] == 1 and trips.value - t0 == 1
        assert bool(torch.isfinite(sched._cache.k_pool).all())
        # the shared prefix survived: A warm and a fresh B match the clean
        assert sched.generate(pa, timeout=120).tobytes() == ca.tobytes()
        assert sched.generate(pb, timeout=120).tobytes() == cb.tobytes()
        assert sched.stats()["kv_pages_used"] == 0
    finally:
        sched.stop()


def test_flaky_decode_dispatch_fails_the_active_sequences_typed(
        decode_model):
    sched = serving.DecodeScheduler(decode_model, _cfg(), autostart=False)
    futs = [sched.submit(np.arange(1, 6, dtype=np.int32) + i)
            for i in range(2)]
    is_decode = lambda reqs: len(reqs) == 2  # noqa: E731 (both decoding)
    with faults.flaky_execute(times=1, match=is_decode) as fired:
        sched.start()
        for f in futs:
            with pytest.raises(faults.FaultInjected):
                f.result(timeout=60)
    sched.stop()
    assert fired[0] == 1 and sched.cache_stats()["used_pages"] == 0


# -- journals ------------------------------------------------------------------

@pytest.mark.parametrize("prefix_cache", [False, True])
def test_journal_replay_is_bitwise_the_fault_free_run(decode_model,
                                                      prefix_cache):
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 50, size=rng.randint(4, 20)).astype(np.int32)
               for _ in range(4)]
    kws = [{}, dict(temperature=0.8, seed=5), {},
           dict(temperature=1.3)]        # the last one seedless
    cfg = lambda: _cfg(max_new_tokens=12,  # noqa: E731
                       prefix_cache=prefix_cache)
    ref = serving.DecodeScheduler(decode_model, cfg(), autostart=False)
    refs = [ref.submit(p, **k) for p, k in zip(prompts, kws)]
    ref.start()
    want = [r.result(timeout=60) for r in refs]
    ref.stop()
    dead = serving.DecodeScheduler(decode_model, cfg(), autostart=False)
    reqs = [dead.submit(p, **k) for p, k in zip(prompts, kws)]
    # dispatches 0-7 are the 4 chunks and the decode steps between them:
    # 12 is a decode step with every sequence part-way
    with faults.kill_worker(at_dispatch=12):
        dead.start()
        deadline = time.time() + 30
        while dead.alive and time.time() < deadline:
            time.sleep(0.005)
    assert not dead.alive
    accepted = [len(r.journal.accepted) for r in reqs]
    assert all(0 < n < 12 for n in accepted), accepted
    assert dead.evict_if_dead() is not None
    assert dead.cache_stats()["used_pages"] == 0 and dead.idle()
    other = serving.DecodeScheduler(decode_model, cfg())
    try:
        # the harvest has them all; resubmitting twice is harmless
        for r in reqs:
            assert other.resubmit(r) is r
        got = [r.result(timeout=60) for r in reqs]
    finally:
        other.stop()
        dead.stop()
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.tobytes() == w.tobytes(), (i, g, w)
    assert all(r.journal.replays == 1 for r in reqs)
    assert all(len(r.token_times) == 12 for r in reqs)


def test_evict_inflight_needs_a_dead_worker_and_resume_fits(decode_model):
    sched = serving.DecodeScheduler(decode_model, _cfg(max_new_tokens=40,
                                                       max_seq_len=64))
    try:
        assert sched.evict_if_dead() is None      # alive: a no-op
        req = serving.GenerateRequest(np.arange(1, 30, dtype=np.int32), 40)
        req.journal.accepted.extend(range(1, 11))
        small = serving.DecodeScheduler(
            decode_model, _cfg(max_seq_len=32, warmup=False),
            autostart=False)
        with pytest.raises(serving.ServingError, match="does not fit"):
            small.resubmit(req)
        small.stop()
        assert req.prompt_len == 29 and req.journal.replays == 0
        done = serving.GenerateRequest(np.arange(1, 4, dtype=np.int32), 2)
        done.journal.accepted.extend([7, 8])
        assert sched.resubmit(done).result(timeout=5).tolist() == [7, 8]
    finally:
        sched.stop()


# -- the compiled steps ---------------------------------------------------------

@pytest.mark.parametrize("knobs,keys", [
    (dict(), {("decode",), ("chunk", 8), ("chunk", 16), ("chunk", 32),
              ("chunk", 64)}),
    (dict(prefill_chunk_tokens=16, kv_guard=True),
     {("decode",), ("chunk", 8), ("chunk", 16), ("kvguard", 1),
      ("kvguard", 2), ("kvguard", 4)}),
], ids=["monolithic", "chunked-guard"])
def test_step_cache_keys_after_warmup_and_no_builds_in_steady_state(
        decode_model, knobs, keys):
    c0 = compile_count()
    sched = serving.DecodeScheduler(decode_model, _cfg(**knobs))
    try:
        assert set(sched._jit.keys()) == keys
        assert compile_count() - c0 == len(keys)
        assert sched._jit._cap == 2 * len(sched.prefill_buckets) + 12
        c1 = compile_count()
        rng = np.random.RandomState(8)
        futs = [sched.submit(rng.randint(1, 50, size=rng.randint(2, 50))
                             .astype(np.int32)) for _ in range(8)]
        for f in futs:
            f.result(timeout=60)
        assert compile_count() == c1
        # on the CPU a step is its function, called (never captured)
        assert not any(st["captured"] for st in sched.step_stats().values())
    finally:
        sched.stop()


def test_legacy_model_builds_a_prefill_step_a_bucket(lm):
    params, meta = lm
    legacy = TT.build_decode_model(params, meta, device="cpu", chunked=False)
    sched = serving.DecodeScheduler(legacy, _cfg(kv_guard=True))
    try:
        assert set(sched._jit.keys()) == {
            ("decode",), ("prefill", 8), ("prefill", 16), ("prefill", 32),
            ("prefill", 64), ("kvguard", 1), ("kvguard", 2),
            ("kvguard", 4), ("kvguard", 8)}
        out = sched.generate(np.arange(1, 12, dtype=np.int32), timeout=60)
    finally:
        sched.stop()
    chunked = serving.DecodeScheduler(
        TT.build_decode_model(params, meta, device="cpu"), _cfg())
    try:
        want = chunked.generate(np.arange(1, 12, dtype=np.int32), timeout=60)
    finally:
        chunked.stop()
    assert out.tobytes() == want.tobytes()


def test_a_step_refuses_a_host_value_that_changes():
    """The graphed entries fix their arguments' shapes and non-tensor
    values at the first call, on the CPU too: a host int left in a step's
    inputs would freeze in a capture, and raises here instead."""
    from paddle_tpu_torch.executor import JitStepCache

    entry = JitStepCache(
        lambda key: (lambda ints, start: ints.sum() + start)).get("k")
    entry(torch.zeros(3, dtype=torch.int32), 0)
    with pytest.raises(ValueError, match="JitStepCache key"):
        entry(torch.zeros(3, dtype=torch.int32), 16)
