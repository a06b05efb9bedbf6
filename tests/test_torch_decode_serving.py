"""The port's decode serving runtime (paddle_tpu_torch.serving) on the CPU.

Cross-package: a port ``InferenceEngine(decode_model=..., device="cpu")``
and the JAX package's engine serve the same prompts greedily from the
same ``lm_params`` arrays and must return identical token arrays, through
the chunked prefill and through the legacy whole-prompt prefill (a model
without a chunk function).  Port-vs-port: the scheduler's own contracts —
continuous batching == ``max_active=1``, chunked == monolithic == legacy
prefill, sampling keyed on (seed, position), EOS, typed errors, page
accounting, thread hygiene, and the knobs whose machinery is not ported
yet.
"""
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu import serving as jserving
from paddle_tpu.models import transformer as JT
from paddle_tpu_torch import serving
from paddle_tpu_torch.models import transformer as TT

DIMS = dict(vocab_size=50, n_layer=2, n_head=2, d_model=32, d_inner=64,
            max_length=128)


@pytest.fixture(scope="module")
def lm():
    params, meta = TT.lm_params(seed=7, **DIMS)
    return params, meta


@pytest.fixture(scope="module")
def decode_model(lm):
    params, meta = lm
    return TT.build_decode_model(params, meta, device="cpu")


def _cfg(**kw):
    base = dict(num_slots=4, page_size=8, max_seq_len=64, max_new_tokens=8)
    base.update(kw)
    return serving.DecodeConfig(**base)


def _prompts(n, seed, lo=2, hi=24):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, DIMS["vocab_size"],
                        size=rng.randint(lo, hi)).astype(np.int32)
            for _ in range(n)]


def _serve(model, prompts, cfg=None, **kw):
    sched = serving.DecodeScheduler(model, cfg or _cfg())
    try:
        futs = [sched.submit(p, **kw) for p in prompts]
        return [f.result(timeout=60) for f in futs]
    finally:
        sched.stop()


def test_greedy_tokens_identical_to_jax_engine(lm, decode_model):
    params, meta = lm
    prompts = _prompts(6, seed=0)
    cfg = dict(num_slots=4, page_size=8, max_seq_len=64, max_new_tokens=8)
    jeng = jserving.InferenceEngine(
        decode_model=JT.build_decode_model(params, meta),
        decode_config=jserving.DecodeConfig(**cfg))
    try:
        want = [f.result(timeout=120)
                for f in [jeng.generate_async(p) for p in prompts]]
    finally:
        jeng.stop()
    teng = serving.InferenceEngine(decode_model=decode_model,
                                   decode_config=serving.DecodeConfig(**cfg),
                                   device="cpu")
    try:
        got = [f.result(timeout=60)
               for f in [teng.generate_async(p) for p in prompts]]
        health = teng.health()
    finally:
        teng.stop()
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.int32 and g.tobytes() == w.tobytes(), (i, g, w)
    assert health["ready"] and health["device"] == "cpu"
    assert health["decode"]["kv_pages_used"] == 0
    assert health["decode"]["completed"] == len(prompts)


@pytest.fixture(scope="module")
def legacy_model(lm):
    params, meta = lm
    return TT.build_decode_model(params, meta, device="cpu", chunked=False)


def test_legacy_greedy_tokens_identical_to_jax_engine(lm, legacy_model):
    # both engines prefill each prompt in one whole-prompt call: the JAX
    # package's DecodeModel with prefill_chunk_fn=None, the port's built
    # with chunked=False
    params, meta = lm
    prompts = _prompts(6, seed=10)
    cfg = dict(num_slots=4, page_size=8, max_seq_len=64, max_new_tokens=8)
    jm = JT.build_decode_model(params, meta)
    jm = jserving.DecodeModel(
        jm.prefill_fn, jm.decode_fn, num_layers=meta["n_layer"],
        num_heads=meta["n_head"], head_dim=meta["head_dim"],
        vocab_size=meta["vocab_size"])
    jeng = jserving.InferenceEngine(
        decode_model=jm, decode_config=jserving.DecodeConfig(**cfg))
    try:
        want = [f.result(timeout=120)
                for f in [jeng.generate_async(p) for p in prompts]]
    finally:
        jeng.stop()
    teng = serving.InferenceEngine(decode_model=legacy_model,
                                   decode_config=serving.DecodeConfig(**cfg),
                                   device="cpu")
    try:
        got = [f.result(timeout=60)
               for f in [teng.generate_async(p) for p in prompts]]
        health = teng.health()
    finally:
        teng.stop()
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.int32 and g.tobytes() == w.tobytes(), (i, g, w)
    assert health["decode"]["kv_pages_used"] == 0
    assert health["decode"]["completed"] == len(prompts)


def test_legacy_batching_equals_max_active_1_and_chunked(legacy_model,
                                                         decode_model):
    prompts = _prompts(9, seed=11, lo=2, hi=40)
    batched = _serve(legacy_model, prompts)
    naive = _serve(legacy_model, prompts, _cfg(max_active=1))
    chunked = _serve(decode_model, prompts, _cfg(prefill_chunk_tokens=16))
    for i, (b, n, c) in enumerate(zip(batched, naive, chunked)):
        assert b.tobytes() == n.tobytes(), i
        assert b.tobytes() == c.tobytes(), i


def test_decode_model_takes_the_reference_positional_order(lm):
    # DecodeModel(prefill_fn, decode_fn, prefill_chunk_fn=None, *, ...)
    # with only a whole-prompt function serves through generate
    params, meta = lm
    lmod = TT.params_from_numpy(params, "cpu", meta=meta)

    def prefill_fn(tokens, length):
        return TT.lm_prefill(lmod, tokens, length, use_flash=True)

    def decode_fn(tokens, positions, k_pool, v_pool, tables, kv_lens):
        return TT.lm_decode_step(lmod, tokens, positions, k_pool, v_pool,
                                 tables, kv_lens)

    dm = serving.DecodeModel(prefill_fn, decode_fn, num_layers=meta["n_layer"],
                             num_heads=meta["n_head"],
                             head_dim=meta["head_dim"],
                             vocab_size=meta["vocab_size"], device="cpu")
    assert dm.prefill_chunk_fn is None
    eng = serving.InferenceEngine(decode_model=dm, decode_config=_cfg(),
                                  device="cpu")
    try:
        prompt = _prompts(1, seed=12)[0]
        out = eng.generate(prompt, max_new_tokens=5, timeout=60)
    finally:
        eng.stop()
    want = _serve(TT.build_decode_model(params, meta, device="cpu"),
                  [prompt], max_new_tokens=5)[0]
    assert out.tobytes() == want.tobytes()
    with pytest.raises(serving.ServingError, match="prefill_fn"):
        serving.DecodeModel(None, decode_fn, None, num_layers=2, num_heads=2,
                            head_dim=16, vocab_size=50, device="cpu")


def test_legacy_model_refuses_chunk_only_knobs(legacy_model):
    with pytest.raises(serving.ServingError, match="prefill_chunk_fn"):
        serving.DecodeScheduler(legacy_model,
                                _cfg(prefill_chunk_tokens=8, warmup=False),
                                autostart=False)
    # DecodeConfig(prefix_cache=True) itself raises NotImplementedError
    # (the cache is not ported); the scheduler's own check comes first
    cfg = _cfg(warmup=False)
    cfg.prefix_cache = True
    with pytest.raises(serving.ServingError, match="prefix_cache"):
        serving.DecodeScheduler(legacy_model, cfg, autostart=False)
    with pytest.raises(serving.ServingError, match="role='prefill'"):
        serving.DecodeScheduler(legacy_model, _cfg(warmup=False),
                                autostart=False, role="prefill")
    with pytest.raises(serving.ServingError, match="role must be"):
        serving.DecodeScheduler(legacy_model, _cfg(warmup=False),
                                autostart=False, role="replica")


def test_continuous_batching_equals_max_active_1(decode_model):
    prompts = _prompts(9, seed=1)
    batched = _serve(decode_model, prompts)
    naive = _serve(decode_model, prompts, _cfg(max_active=1))
    for i, (b, n) in enumerate(zip(batched, naive)):
        assert b.tobytes() == n.tobytes(), i


@pytest.mark.parametrize("chunk", [8, 16])
def test_chunked_prefill_equals_monolithic(decode_model, chunk):
    prompts = _prompts(6, seed=2, lo=10, hi=40)
    mono = _serve(decode_model, prompts)
    chunked = _serve(decode_model, prompts,
                     _cfg(prefill_chunk_tokens=chunk))
    for i, (m, c) in enumerate(zip(mono, chunked)):
        assert m.tobytes() == c.tobytes(), i


def test_sampling_deterministic_and_batch_independent(decode_model):
    probe = _prompts(1, seed=3)[0]
    others = _prompts(5, seed=4)
    alone = _serve(decode_model, [probe], temperature=0.9, seed=11)[0]
    again = _serve(decode_model, [probe], temperature=0.9, seed=11)[0]
    sched = serving.DecodeScheduler(decode_model, _cfg())
    try:
        futs = [sched.submit(p, temperature=0.7, seed=5) for p in others[:2]]
        mixed = sched.submit(probe, temperature=0.9, seed=11)
        futs += [sched.submit(p) for p in others[2:]]
        in_batch = mixed.result(timeout=60)
        for f in futs:
            f.result(timeout=60)
    finally:
        sched.stop()
    assert alone.tobytes() == again.tobytes() == in_batch.tobytes()
    greedy = _serve(decode_model, [probe])[0]
    seeds = [_serve(decode_model, [probe], temperature=5.0, seed=s)[0]
             for s in (1, 2, 3)]
    assert any(s.tobytes() != greedy.tobytes() for s in seeds)
    assert len({s.tobytes() for s in seeds}) > 1


def test_top_k_one_is_greedy(decode_model):
    probe = _prompts(1, seed=5)[0]
    greedy = _serve(decode_model, [probe])[0]
    top1 = _serve(decode_model, [probe], _cfg(top_k=1), temperature=2.0,
                  seed=9)[0]
    assert greedy.tobytes() == top1.tobytes()


def test_eos_stops_a_sequence_early(lm):
    params, meta = lm
    prompt = np.arange(1, 6, dtype=np.int32)
    free = _serve(TT.build_decode_model(params, meta, device="cpu"),
                  [prompt], max_new_tokens=16)[0]
    eos = int(free[2])
    capped = _serve(TT.build_decode_model(params, meta, eos_id=eos,
                                          device="cpu"),
                    [prompt], max_new_tokens=16)[0]
    stop = list(free).index(eos)
    assert capped.tobytes() == free[:stop + 1].tobytes()
    assert len(capped) < 16 and int(capped[-1]) == eos


def test_queue_full_timeout_in_queue_and_closed(decode_model):
    sched = serving.DecodeScheduler(decode_model,
                                    _cfg(queue_capacity=2, warmup=False),
                                    autostart=False)
    live = sched.submit(np.array([1, 2, 3], np.int32), max_new_tokens=2)
    doomed = sched.submit(np.array([1, 2, 3], np.int32), max_new_tokens=2,
                          deadline_ms=5)
    with pytest.raises(serving.ServingQueueFull):
        sched.submit(np.array([1], np.int32))
    time.sleep(0.05)  # the doomed deadline passes in queue
    sched.start()
    assert live.result(timeout=60).shape == (2,)
    with pytest.raises(serving.ServingTimeout):
        doomed.result(timeout=60)
    sched.stop()
    with pytest.raises(serving.ServingClosed):
        sched.submit(np.array([1], np.int32))


def test_timeout_mid_decode(lm):
    params, meta = lm
    slow = TT.build_decode_model(params, meta, device="cpu")
    step = slow.decode_fn

    def slow_step(*args):
        time.sleep(0.02)
        return step(*args)

    slow.decode_fn = slow_step
    sched = serving.DecodeScheduler(slow, _cfg(max_seq_len=128,
                                               warmup=False))
    try:
        fut = sched.submit(np.array([1, 2, 3], np.int32),
                           max_new_tokens=100, deadline_ms=600)
        # the future's own wait can time out first: read the error the
        # worker stored once it has shed the sequence
        deadline = time.time() + 30
        while not fut.done() and time.time() < deadline:
            time.sleep(0.01)
        with pytest.raises(serving.ServingTimeout, match="mid-decode"):
            fut.result(timeout=0)
        deadline = time.time() + 10
        while sched.stats()["kv_pages_used"] and time.time() < deadline:
            time.sleep(0.01)
        assert sched.stats()["kv_pages_used"] == 0
    finally:
        sched.stop()


def test_cancel_frees_pages(decode_model):
    sched = serving.DecodeScheduler(decode_model, _cfg(max_seq_len=128),
                                    autostart=False)
    queued = sched.submit(np.array([4, 5], np.int32), max_new_tokens=100)
    assert queued.cancel()
    sched.start()
    with pytest.raises(serving.ServingCancelled):
        queued.result(timeout=60)
    sched.stop()
    assert sched.cache_stats()["used_pages"] == 0


def test_stop_without_drain_fails_pending(decode_model):
    sched = serving.DecodeScheduler(decode_model, _cfg(warmup=False),
                                    autostart=False)
    futs = [sched.submit(p) for p in _prompts(3, seed=6)]
    sched.stop(drain=False)
    for f in futs:
        with pytest.raises(serving.ServingClosed):
            f.result(timeout=10)


def test_pages_drain_and_no_thread_leaks(decode_model):
    eng = serving.InferenceEngine(decode_model=decode_model,
                                  decode_config=_cfg(num_slots=2),
                                  device="cpu")
    futs = [eng.generate_async(p, max_new_tokens=int(m)) for p, m in zip(
        _prompts(7, seed=7), np.random.RandomState(7).randint(1, 9, 7))]
    for f in futs:
        f.result(timeout=60)
    st = eng.health()["decode"]
    assert st["completed"] == 7 and st["active"] == 0
    assert st["kv_pages_used"] == 0
    cache = eng._decoder.cache_stats()
    assert cache["rc_errors"] == [] and cache["rc_sum_matches"]
    eng.stop()
    with pytest.raises(serving.ServingClosed):
        eng.generate(np.array([1], np.int32))
    name = "paddle-tpu-torch-decode-scheduler"
    deadline = time.time() + 5
    while time.time() < deadline and any(
            t.name == name for t in threading.enumerate()):
        time.sleep(0.02)
    assert not [t for t in threading.enumerate() if t.name == name]


def test_malformed_requests(decode_model):
    sched = serving.DecodeScheduler(decode_model, _cfg(warmup=False),
                                    autostart=False)
    with pytest.raises(serving.ServingError, match="non-empty"):
        sched.submit(np.zeros((0,), np.int32))
    with pytest.raises(serving.ServingError, match="max_seq_len"):
        sched.submit(np.ones(60, np.int32), max_new_tokens=8)
    with pytest.raises(serving.ServingError, match="temperature"):
        sched.submit(np.ones(3, np.int32), temperature=-1)
    sched.stop()


@pytest.mark.parametrize("knob", ["prefix_cache", "kv_guard"])
def test_unported_config_knobs_raise(knob):
    with pytest.raises(NotImplementedError, match=knob):
        serving.DecodeConfig(**{knob: True})


def test_unported_scheduler_and_engine_options_raise(decode_model):
    with pytest.raises(NotImplementedError, match="role"):
        serving.DecodeScheduler(decode_model, _cfg(warmup=False),
                                autostart=False, role="prefill")
    with pytest.raises(NotImplementedError, match="sessions"):
        serving.DecodeScheduler(decode_model, _cfg(warmup=False),
                                autostart=False, sessions=object())
    eng = serving.InferenceEngine(decode_model=decode_model, device="cpu",
                                  warmup=False, autostart=False)
    with pytest.raises(NotImplementedError, match="A6"):
        eng.serve_metrics()
    eng.stop()


def test_cancel_mid_decode_frees_pages(lm):
    params, meta = lm
    slow = TT.build_decode_model(params, meta, device="cpu")
    step = slow.decode_fn

    def slow_step(*args):
        time.sleep(0.01)
        return step(*args)

    slow.decode_fn = slow_step
    sched = serving.DecodeScheduler(slow, _cfg(max_seq_len=128,
                                               warmup=False))
    try:
        fut = sched.submit(np.array([1, 2, 3], np.int32), max_new_tokens=100)
        deadline = time.time() + 30
        while not sched.stats()["active"] and time.time() < deadline:
            time.sleep(0.005)
        assert fut.cancel()
        with pytest.raises(serving.ServingCancelled, match="after"):
            fut.result(timeout=30)
        while sched.stats()["kv_pages_used"] and time.time() < deadline:
            time.sleep(0.005)
        assert sched.stats()["kv_pages_used"] == 0
        assert not fut.cancel()      # already finished
    finally:
        sched.stop()


def test_engine_device_must_match_the_model(decode_model):
    meta_dev = torch.device("meta")
    with pytest.raises(ValueError, match="cuda' or 'cpu"):
        serving.InferenceEngine(decode_model=decode_model, device=meta_dev)
    with pytest.raises(ValueError, match="decode_model"):
        serving.InferenceEngine(device="cpu")
