#!/usr/bin/env python
"""Gate for the port's continuous-batching decode runtime
(``paddle_tpu_torch.serving.DecodeScheduler`` / ``InferenceEngine.
generate``): drive it on the CPU and fail loudly on any correctness,
scheduling or telemetry regression.  The port's counterpart of
``tools/check_decode.py``, its scenarios 1, 2, 3, 5 and 6.

Scenario 1 — bitwise continuous-vs-per-sequence equality, no builds:
  mixed-length prompts through a continuously batched scheduler come
  back bitwise equal to the same requests served one sequence at a time
  (max_active=1), with ZERO executor.compile_count() growth after
  warmup in either leg (every step is a JitStepCache entry built at
  warmup), and the KV pool fully returned at the end.

Scenario 2 — admission contracts on the generate path:
  a full decode queue rejects with ServingQueueFull (and counts it), a
  queued request whose deadline passes is shed with ServingTimeout (and
  counts), live requests still answer, a stopped engine rejects with
  ServingClosed, and an EOS-capped sequence stops early.

Scenario 3 — serving.decode.* telemetry schema:
  a generate run populates the registry names (queue-depth/active-slot/
  KV gauges, request/token/prefill/step counters, prefill/decode/queue-
  wait/warm-up timers), emits per-sequence spans, and streams
  decode_sequence records to record sinks.

Scenario 5 — chunked prefill:
  the same prompts through chunked (prefill_chunk_tokens) and monolithic
  prefill return bitwise-identical tokens with ZERO builds after warmup
  and the KV pool fully returned (the port's one CPU engine: the plain
  paged attention; the JAX package also runs its Pallas kernel in
  interpret mode); a deadline that passes mid-prefill sheds between
  chunks with ServingTimeout, counts serving.decode.expired_mid_prefill,
  and reports time-in-queue vs time-in-prefill.

Scenario 6 — prefix cache:
  a warm prefix cache returns bitwise-identical tokens to a cold one
  while prefilling >= 50% fewer prompt tokens on a shared-prefix
  workload (serving.decode.kv_hit_pages / prefill_tokens observable);
  refcounts return to zero after retirement (kv_pages_used == 0,
  kv_shared_pages == 0); and a pool too small for the working set still
  serves bitwise-correctly while evicting LRU refcount-zero pages
  (serving.decode.kv_evictions > 0).

Left out: the JAX gate's scenarios 4 and 7 drive
``benchmarks/bench_decode.py --smoke`` (a throughput and a
head-of-line timing smoke) in a subprocess; the benchmarks folder is
not ported, and ``chip_smoke.py`` measures decode on the card instead.

Runnable locally (the port only: no jax is imported):
    python tools/check_decode_torch.py
and run under pytest by tests/test_torch_decode_gate.py.

Exit code 0 = every scenario held.
"""
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

DEVICE = "cpu"


def _model(vocab=60, eos_id=None):
    from paddle_tpu_torch.models import transformer as T

    params, meta = T.lm_params(seed=31, vocab_size=vocab, n_layer=2,
                               n_head=2, d_model=32, d_inner=64,
                               max_length=128)
    return T.build_decode_model(params, meta, eos_id=eos_id, device=DEVICE)


def _cfg(**kw):
    from paddle_tpu_torch import serving

    base = dict(num_slots=4, page_size=8, max_seq_len=64,
                max_new_tokens=12)
    base.update(kw)
    return serving.DecodeConfig(**base)


def scenario_bitwise_and_no_recompile():
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.executor import compile_count

    model = _model()
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 60, size=rng.randint(2, 30)).astype(np.int32)
               for _ in range(14)]
    results = {}
    for name, active in (("continuous", 4), ("naive", 1)):
        sched = serving.DecodeScheduler(model, _cfg(max_active=active))
        c0 = compile_count()
        futs = [sched.submit(p) for p in prompts]
        results[name] = [f.result(timeout=300) for f in futs]
        d = compile_count() - c0
        assert d == 0, "%s leg built %d steps after warmup" % (name, d)
        st = sched.stats()
        assert st["kv_pages_used"] == 0, (
            "%s leg leaked %d KV pages" % (name, st["kv_pages_used"]))
        assert st["completed"] == len(prompts)
        sched.stop()
    bad = [i for i in range(len(prompts))
           if results["continuous"][i].tobytes()
           != results["naive"][i].tobytes()]
    assert not bad, (
        "%d/%d sequences differ continuous vs per-sequence (first: %d)"
        % (len(bad), len(prompts), bad[0]))
    return ("bitwise continuous == per-sequence: %d seqs, 0 builds, "
            "0 leaked pages OK" % len(prompts))


def scenario_admission_contracts():
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import serving

    model = _model()
    eng = serving.InferenceEngine(
        decode_model=model,
        decode_config=_cfg(queue_capacity=2, warmup=False),
        autostart=False, device=DEVICE)
    full0 = obs.counter("serving.decode.queue_full").value
    exp0 = obs.counter("serving.decode.expired").value
    live = eng.generate_async(np.array([3, 4, 5], np.int32),
                              max_new_tokens=2)
    doomed = eng.generate_async(np.array([3, 4, 5], np.int32),
                                max_new_tokens=2, deadline_ms=5)
    try:
        eng.generate_async(np.array([1], np.int32))
    except serving.ServingQueueFull:
        pass
    else:
        raise AssertionError("3rd request admitted past decode capacity 2")
    assert obs.counter("serving.decode.queue_full").value == full0 + 1
    time.sleep(0.05)  # the doomed request's deadline passes in queue
    eng.start()
    out = live.result(timeout=300)
    assert out.shape == (2,)
    try:
        doomed.result(timeout=300)
    except serving.ServingTimeout:
        pass
    else:
        raise AssertionError("expired generate request was still answered")
    assert obs.counter("serving.decode.expired").value == exp0 + 1
    eng.stop()
    try:
        eng.generate(np.array([1], np.int32))
    except serving.ServingClosed:
        pass
    else:
        raise AssertionError("stopped engine accepted a generate request")
    # EOS stops early: make the first greedily sampled token the EOS
    probe = serving.DecodeScheduler(_model(), _cfg())
    ref = probe.generate(np.array([5, 7], np.int32), max_new_tokens=8,
                         timeout=300)
    probe.stop()
    eos = int(ref[0])
    capped = serving.DecodeScheduler(_model(eos_id=eos), _cfg())
    out = capped.generate(np.array([5, 7], np.int32), max_new_tokens=8,
                          timeout=300)
    capped.stop()
    assert int(out[-1]) == eos and len(out) <= len(ref)
    return ("decode admission: queue-full rejected, expired shed, live "
            "answered, stopped closed, EOS stops early OK")


def scenario_telemetry_schema():
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import serving

    model = _model()
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, 60, size=rng.randint(2, 20)).astype(np.int32)
               for _ in range(8)]
    sink = obs.RingBufferSink(record_spans=True)
    obs.add_sink(sink)
    c0 = {n: obs.counter("serving.decode.%s" % n).value
          for n in ("requests", "tokens", "prefills", "steps", "retired")}
    try:
        sched = serving.DecodeScheduler(model, _cfg())
        futs = [sched.submit(p, max_new_tokens=6) for p in prompts]
        outs = [f.result(timeout=300) for f in futs]
        sched.stop()
    finally:
        obs.remove_sink(sink)
    d = {n: obs.counter("serving.decode.%s" % n).value - c0[n] for n in c0}
    assert d["requests"] == len(prompts) == d["prefills"] == d["retired"]
    n_tokens = sum(len(o) for o in outs)
    assert d["tokens"] == n_tokens, (d["tokens"], n_tokens)
    assert 0 < d["steps"] < n_tokens, (
        "steps %d not batched (tokens %d)" % (d["steps"], n_tokens))
    for tname in ("serving.decode.prefill_step", "serving.decode.decode_step",
                  "serving.decode.queue_wait", "serving.decode.warmup"):
        stats = obs.timer(tname).stats()
        assert stats and stats[0] > 0, "timer %s never observed" % tname
    for gname in ("serving.decode.queue_depth", "serving.decode.active_slots",
                  "serving.decode.kv_pages_used"):
        assert obs.gauge(gname).value == 0, "%s stuck nonzero" % gname
    assert obs.gauge("serving.decode.kv_pages_total").value > 0
    recs = [r for r in sink.records if r.get("type") == "decode_sequence"]
    assert len(recs) == len(prompts)
    for r in recs:
        for k in ("ts", "seq", "prompt_len", "generated", "shed",
                  "kv_pages_used", "queue_depth"):
            assert k in r, "decode_sequence record missing %r: %s" % (k, r)
    span_names = {s["name"] for s in sink.spans}
    assert {"serving.decode.sequence", "serving.decode.prefill",
            "serving.decode.step"} <= span_names, span_names
    return ("decode telemetry: %d seqs / %d tokens / %d steps, counters+"
            "timers+gauges+spans+records flowing OK"
            % (len(prompts), n_tokens, d["steps"]))


def scenario_chunked_prefill():
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.executor import compile_count
    from paddle_tpu_torch.testing import faults

    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, 60, size=rng.randint(2, 50)).astype(np.int32)
               for _ in range(10)]
    model = _model()
    results = {}
    for name, kw in (("monolithic", {}),
                     ("chunked", {"prefill_chunk_tokens": 8})):
        sched = serving.DecodeScheduler(model, _cfg(**kw))
        c0 = compile_count()
        futs = [sched.submit(p) for p in prompts]
        results[name] = [f.result(timeout=300) for f in futs]
        d = compile_count() - c0
        assert d == 0, "%s leg built %d steps after warmup" % (name, d)
        st = sched.stats()
        assert st["kv_pages_used"] == 0, (
            "%s leg leaked %d KV pages" % (name, st["kv_pages_used"]))
        sched.stop()
    bad = [i for i in range(len(prompts))
           if results["chunked"][i].tobytes()
           != results["monolithic"][i].tobytes()]
    assert not bad, ("%d/%d sequences differ chunked vs monolithic "
                     "(first: %d)" % (len(bad), len(prompts), bad[0]))
    # mid-prefill deadline shed: a doomed long prompt frees its budget
    # BETWEEN chunks, counts expired_mid_prefill, and its error reports
    # time-in-queue vs time-in-prefill
    sched = serving.DecodeScheduler(
        model, _cfg(prefill_chunk_tokens=8), autostart=False)
    mid0 = obs.counter("serving.decode.expired_mid_prefill").value
    with faults.slow_execute(0.01):  # each chunk >= 10ms: 7 chunks > 30ms
        doomed = sched.submit(
            np.arange(1, 50, dtype=np.int32).repeat(2)[:50],
            max_new_tokens=8, deadline_ms=30)
        sched.start()
        # wait for the WORKER's shed (the future's own deadline check
        # races it and would win with a generic "unanswered" timeout)
        deadline = time.perf_counter() + 30
        while (obs.counter("serving.decode.expired_mid_prefill").value
               <= mid0 and time.perf_counter() < deadline):
            time.sleep(0.01)
        try:
            doomed.result(timeout=300)
        except serving.ServingTimeout as e:
            assert "mid-prefill" in str(e) and "in queue" in str(e), e
        else:
            raise AssertionError("mid-prefill deadline was not shed")
    assert obs.counter("serving.decode.expired_mid_prefill").value \
        == mid0 + 1
    st = sched.stats()
    assert st["kv_pages_used"] == 0, "mid-prefill shed leaked pages"
    # the scheduler still serves after the shed
    out = sched.generate(np.array([3, 4, 5], np.int32), max_new_tokens=2,
                         timeout=300)
    sched.stop()
    assert out.shape == (2,)
    return ("chunked prefill: bitwise == monolithic, 0 builds, 0 leaks, "
            "mid-prefill shed counted OK")


def scenario_prefix_cache():
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import serving

    model = _model()
    rng = np.random.RandomState(11)
    prefix = rng.randint(1, 60, size=32).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.randint(1, 60, size=6)
                               .astype(np.int32)]) for _ in range(6)]
    prefill_tokens = obs.counter("serving.decode.prefill_tokens")
    hit_pages = obs.counter("serving.decode.kv_hit_pages")
    outs = {}
    for name, kw in (("cold", {}), ("warm", {"prefix_cache": True})):
        sched = serving.DecodeScheduler(model, _cfg(**kw))
        p0, h0 = prefill_tokens.value, hit_pages.value
        outs[name] = [sched.generate(p, timeout=300) for p in prompts]
        st = sched.stats()
        assert st["kv_pages_used"] == 0, (
            "%s leg left %d pages referenced after retirement"
            % (name, st["kv_pages_used"]))
        shared = obs.gauge("serving.decode.kv_shared_pages").value or 0
        assert shared == 0, (
            "%s leg left %d shared pages after retirement" % (name, shared))
        if name == "warm":
            warm_prefilled = prefill_tokens.value - p0
            warm_hits = hit_pages.value - h0
        else:
            cold_prefilled = prefill_tokens.value - p0
        sched.stop()
    bad = [i for i in range(len(prompts))
           if outs["warm"][i].tobytes() != outs["cold"][i].tobytes()]
    assert not bad, ("%d/%d sequences differ warm vs cold prefix cache"
                     % (len(bad), len(prompts)))
    assert warm_hits > 0, "shared-prefix workload produced no page hits"
    reduction = 1.0 - warm_prefilled / cold_prefilled
    assert reduction >= 0.5, (
        "prefix cache avoided only %.0f%% of prefill tokens (%d -> %d)"
        % (reduction * 100, cold_prefilled, warm_prefilled))
    # eviction under pressure: a pool too small for the distinct-prompt
    # working set must evict LRU refcount-zero pages and STILL serve
    # bitwise-correctly
    ev0 = obs.counter("serving.decode.kv_evictions").value
    distinct = [rng.randint(1, 60, size=40).astype(np.int32)
                for _ in range(6)]
    small = _cfg(prefix_cache=True, num_pages=13)  # 12 usable pages
    sched = serving.DecodeScheduler(model, small)
    got = [sched.generate(p, timeout=300) for p in distinct]
    assert sched.stats()["kv_pages_used"] == 0
    sched.stop()
    evictions = obs.counter("serving.decode.kv_evictions").value - ev0
    assert evictions > 0, (
        "undersized pool (12 pages, 6x6-page seqs) never evicted")
    ref = serving.DecodeScheduler(model, _cfg())
    want = [ref.generate(p, timeout=300) for p in distinct]
    ref.stop()
    bad = [i for i in range(len(distinct))
           if got[i].tobytes() != want[i].tobytes()]
    assert not bad, ("%d/%d sequences differ under eviction pressure"
                     % (len(bad), len(distinct)))
    return ("prefix cache: warm bitwise == cold with %.0f%% fewer "
            "prefill tokens (%d page hits), refcounts drained, %d "
            "evictions served correctly OK"
            % (reduction * 100, warm_hits, evictions))


def main():
    failures = []
    for scenario in (scenario_bitwise_and_no_recompile,
                     scenario_admission_contracts,
                     scenario_telemetry_schema,
                     scenario_chunked_prefill,
                     scenario_prefix_cache):
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
        sys.stderr.write("\ndecode gate FAILED\n")
        return 1
    print("decode gate OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
