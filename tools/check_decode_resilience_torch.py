#!/usr/bin/env python
"""Gate for the port's durable decode: pool-routed generation with
replay on a replica's death and the KV integrity guard, driven on a
4-replica ``ReplicaPool`` on the CPU (``devices=["cpu"]``).  The port's
counterpart of ``tools/check_decode_resilience.py``, its scenarios 1-6.

Scenario 1 — kill one replica of four mid-decode (the tentpole):
  a mixed greedy + seeded burst runs fault-free (baseline), then again
  with kill_replica_mid_decode murdering replica 1's decode worker once
  it provably holds in-flight KV.  EVERY sequence — in flight on the
  dead replica, in flight on siblings, still queued — completes with
  tokens bitwise-identical to the fault-free run (journal replay +
  sampling keyed on the absolute position), replays count on
  ``serving.decode.replays``, the supervisor revives the replica and it
  PROVABLY claims work again (exclusive-gate probe), zero step builds
  during the baseline's steady-state serve, zero leaked KV pages after
  drain in both runs.

Scenario 2 — KV corruption isolation:
  with ``kv_guard=True`` + prefix caching, corrupt_kv_page poisons a
  page one decoding sequence privately owns.  Exactly that sequence
  fails typed (``KVCorruption``), its pages are scrubbed (pools finite
  again), and co-resident + prefix-sharing sequences finish
  bitwise-identical to a clean run — the shared prefix pages survive.

Scenario 3 — a transient fault at a decode dispatch:
  flaky_execute fires one transient fault at a decode-step dispatch of a
  2-replica pool.  The port holds its own contract here, not the JAX
  package's: a decode step writes KV in place, so a failed step is not
  replayable and is never retried (the JAX gate's scenario 3 retries the
  step, whose pool updates there are functional; its pools are donated,
  and so unretried, on the TPU).  The sequences in that dispatch fail
  with the fault's type, all of them on the replica that ran it, and
  nothing else moves: every other sequence's tokens are bitwise the
  fault-free run's, no page leaks, and both replicas serve again.

Scenario 4 — cancellation:
  ``GenerateRequest.cancel()`` retires an active sequence at the next
  iteration boundary and drops a queued one at its admission touch —
  both fail ``ServingCancelled``, ``serving.decode.cancelled`` counts
  them, no pages leak.

Scenario 5 — replay budget:
  with ``replay_budget=0`` the killed replica's in-flight sequences
  fail typed (``ServingDegraded`` naming the budget) instead of
  replaying; everything else completes, bitwise the fault-free tokens.

Scenario 6 — reset_pools live-sequence guard:
  ``PagedKVCache.reset_pools()`` under live sequences raises a typed
  ``ServingError`` listing the active seq ids; ``force=True`` (the
  recovery path) zeroes anyway.

Runnable locally (the port only: no jax is imported):
    python tools/check_decode_resilience_torch.py
and run under pytest by tests/test_torch_decode_resilience_gate.py.

Exit code 0 = every scenario held.
"""
import os
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

KILLED = 1          # replica index scenarios 1 and 5 murder
DEVICE = "cpu"


def _model(eos_id=None):
    from paddle_tpu_torch.models import transformer as T

    params, meta = T.lm_params(seed=31, vocab_size=60, n_layer=2,
                               n_head=2, d_model=32, d_inner=64,
                               max_length=128)
    return T.build_decode_model(params, meta, eos_id=eos_id, device=DEVICE)


def _cfg(**kw):
    from paddle_tpu_torch import serving

    base = dict(num_slots=2, page_size=8, max_seq_len=64,
                max_new_tokens=16)
    base.update(kw)
    return serving.DecodeConfig(**base)


def _pool(model, replicas=4, **cfg_kw):
    from paddle_tpu_torch import serving

    return serving.ReplicaPool(
        None, replicas=replicas, devices=[DEVICE], decode_model=model,
        decode_config=_cfg(**cfg_kw), supervisor_interval_s=0.05)


def _prompts(seed, n, lo=4, hi=16):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 60, size=rng.randint(lo, hi)).astype(np.int32)
            for _ in range(n)]


def _submit_burst(pool, prompts):
    """Mixed legs, one submission order: even indices greedy, odd
    seeded-sampling with the seed left to the POOL's admission pinning
    (the replay-determinism path under test)."""
    futs = []
    for i, p in enumerate(prompts):
        temp = 0.0 if i % 2 == 0 else 0.7
        futs.append(pool.generate_async(p, temperature=temp))
    return futs


def _leaked(pool):
    return [r.decoder._cache.used_pages for r in pool._replicas]


def scenario_kill_replica_bitwise():
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.executor import compile_count
    from paddle_tpu_torch.testing import faults

    model = _model()
    prompts = _prompts(0, 12)   # 12 seqs > 8 pool slots: some queued
                                # behind the burst when the kill lands

    # fault-free baseline + the steady-state zero-build assert
    pool = _pool(model)
    try:
        for f in _submit_burst(pool, _prompts(7, 8)):   # warm claim paths
            f.result(timeout=300)
        c0 = compile_count()
        base = [np.asarray(f.result(timeout=300))
                for f in _submit_burst(pool, prompts)]
        d = compile_count() - c0
        assert d == 0, "steady-state serve built %d steps" % d
        assert pool.drain_decode(timeout=30)
        assert not any(_leaked(pool)), \
            "baseline leaked KV pages: %s" % _leaked(pool)
    finally:
        pool.stop()

    # the kill run: SAME warm-up + submission order (pool-level seed
    # pinning counts admissions, so the sequence of puts must match the
    # baseline for the seeded legs to compare), replica 1 dies mid-decode
    replays0 = obs.counter("serving.decode.replays").value or 0
    pool = _pool(model)
    try:
        for f in _submit_burst(pool, _prompts(7, 8)):
            f.result(timeout=300)
        with faults.kill_replica_mid_decode(KILLED, min_tokens=2) as fired:
            futs = _submit_burst(pool, prompts)
            outs = [np.asarray(f.result(timeout=300)) for f in futs]
        assert fired[0] == 1, "kill hook fired %d times" % fired[0]
        bad = [i for i in range(len(prompts))
               if base[i].tobytes() != outs[i].tobytes()]
        assert not bad, (
            "%d/%d sequences differ from the fault-free run after the "
            "replica kill (first: %d)" % (len(bad), len(prompts), bad[0]))
        replays = (obs.counter("serving.decode.replays").value or 0) \
            - replays0
        assert replays >= 1, "no replay counted on serving.decode.replays"

        # supervisor revival, provable re-claim: wait for the restart,
        # then open ONLY the revived replica's gate and make it serve
        rep = pool._replicas[KILLED]
        deadline = time.perf_counter() + 10
        while not rep.decoder.alive and time.perf_counter() < deadline:
            time.sleep(0.02)
        assert rep.decoder.alive, "supervisor never revived replica %d" \
            % KILLED
        before = rep.decoder.stats()["completed"]
        for r in pool._replicas:
            r.active = r.index == KILLED
        time.sleep(0.2)   # let siblings' in-flight queue.get()s (gate
        try:              # already passed) time out before probing
            probe = [pool.generate_async(p) for p in _prompts(9, 4)]
            for f in probe:
                f.result(timeout=300)
        finally:
            for r in pool._replicas:
                r.active = True
        claimed = rep.decoder.stats()["completed"] - before
        assert claimed == 4, (
            "revived replica completed %d/4 exclusive-gate probes"
            % claimed)
        assert pool.drain_decode(timeout=30)
        assert not any(_leaked(pool)), \
            "kill run leaked KV pages: %s" % _leaked(pool)
    finally:
        pool.stop()
    return ("kill 1-of-4 mid-decode: %d seqs bitwise (greedy+seeded), "
            "%d replay(s), revived replica claimed 4/4, 0 builds, "
            "0 leaked pages OK" % (len(prompts), replays))


def scenario_corrupt_kv_isolation():
    import torch

    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.testing import faults

    model = _model()
    prefix = np.arange(1, 17, dtype=np.int32)          # 2 full pages
    mk = lambda tail: np.concatenate(  # noqa: E731
        [prefix, np.asarray(tail, np.int32)])
    pa, pb, pc = mk([21, 22, 23]), mk([31, 32, 33]), mk([41, 42, 43])
    kw = dict(num_slots=4, prefill_chunk_tokens=8, prefix_cache=True,
              kv_guard=True)

    clean = serving.DecodeScheduler(model, _cfg(**kw))
    warm = clean.generate(pa)                # registers the prefix pages
    ca = clean.generate(pa)
    cb = clean.generate(pb)
    cc = clean.generate(pc)
    assert np.array_equal(warm, ca), "prefix-cache warm hit not bitwise"
    clean.stop()

    trips0 = obs.counter("serving.decode.kv_guard_trips").value or 0
    sched = serving.DecodeScheduler(model, _cfg(**kw))
    try:
        assert np.array_equal(np.asarray(sched.generate(pa)), ca)
        # B and C co-resident (and sharing A's registered prefix); B's
        # private tail page gets poisoned once it is decoding
        fb = sched.submit(pb)
        fc = sched.submit(pc)
        with faults.corrupt_kv_page(sched, seq=fb.seq, after_tokens=1) \
                as fired:
            try:
                fb.result(timeout=300)
                raise AssertionError(
                    "corrupted sequence completed instead of failing "
                    "KVCorruption")
            except serving.KVCorruption:
                pass
            out_c = np.asarray(fc.result(timeout=300))
        assert fired[0] == 1
        assert np.array_equal(out_c, cc), (
            "co-resident sequence's tokens changed under the neighbor's "
            "KV corruption")
        trips = (obs.counter("serving.decode.kv_guard_trips").value or 0) \
            - trips0
        assert trips == 1, "kv_guard_trips moved %d (want 1)" % trips
        # scrub proof: the pools are finite again, and the SHARED prefix
        # survived — a warm re-run of A and a fresh B both come back
        # bitwise against the clean scheduler
        assert bool(torch.isfinite(sched._cache.k_pool).all()), (
            "k_pool still holds non-finite values after the scrub")
        assert np.array_equal(np.asarray(sched.generate(pa)), ca)
        assert np.array_equal(np.asarray(sched.generate(pb)), cb)
        assert sched.stats()["kv_pages_used"] == 0
    finally:
        sched.stop()
    return ("corrupt_kv_page: owner failed KVCorruption, co-resident + "
            "prefix-sharing sequences bitwise-intact, pools scrubbed "
            "finite OK")


def scenario_decode_fault_fails_its_dispatch():
    from paddle_tpu_torch.testing import faults

    model = _model()
    prompts = _prompts(5, 4)
    pool = _pool(model, replicas=2)
    try:
        base = [np.asarray(f.result(timeout=300))
                for f in [pool.generate_async(p) for p in prompts]]
        hit = []

        def decoding(requests):
            # the DECODE step: every request in it accepted a token
            if all(len(r.journal.accepted) >= 1 for r in requests):
                hit.append((threading.current_thread().name,
                            [r.seq for r in requests]))
                return True
            return False

        with faults.flaky_execute(times=1, match=decoding) as fired:
            futs = [pool.generate_async(p) for p in prompts]
            failed, outs = [], {}
            for i, f in enumerate(futs):
                try:
                    outs[i] = np.asarray(f.result(timeout=300))
                except faults.FaultInjected:
                    failed.append(f.seq)
        assert fired[0] == 1, "fired %d faults (want 1)" % fired[0]
        thread, seqs = hit[0]
        assert sorted(failed) == sorted(seqs), (
            "failed %s, but the faulted dispatch held %s" % (failed, seqs))
        for i, out in outs.items():
            assert out.tobytes() == base[i].tobytes(), (
                "sequence %d moved under a sibling dispatch's fault" % i)
        assert pool.drain_decode(timeout=30)
        assert not any(_leaked(pool)), \
            "the fault leaked KV pages: %s" % _leaked(pool)
        # both replicas serve again: each one alone takes a request
        for rep in pool._replicas:
            for r in pool._replicas:
                r.active = r is rep
            time.sleep(0.1)
            out = np.asarray(pool.generate(prompts[0], timeout=300))
            assert out.tobytes() == base[0].tobytes()
        for r in pool._replicas:
            r.active = True
    finally:
        pool.stop()
    return ("decode-dispatch fault: its %d sequence(s) on %s failed typed, "
            "un-retried; %d others bitwise, 0 leaked pages, both replicas "
            "serve again OK" % (len(failed), thread, len(outs)))


def scenario_cancel():
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import serving

    model = _model()
    sched = serving.DecodeScheduler(
        model, _cfg(max_active=1, max_new_tokens=48))
    c0 = obs.counter("serving.decode.cancelled").value or 0
    try:
        prompt = np.arange(1, 9, dtype=np.int32)
        active = sched.submit(prompt)        # decoding (sole seat)
        queued = sched.submit(prompt)        # behind it in the queue
        while not active.token_times:
            time.sleep(0.002)
        assert active.cancel() and queued.cancel()
        for req, where in ((active, "active"), (queued, "queued")):
            try:
                req.result(timeout=60)
                raise AssertionError("%s request completed after "
                                     "cancel()" % where)
            except serving.ServingCancelled:
                pass
        assert not active.cancel(), "cancel() on a done request said True"
        # the runtime still serves, nothing leaked
        out = sched.generate(prompt, max_new_tokens=4)
        assert len(out) == 4
        assert sched.stats()["kv_pages_used"] == 0
        cancelled = (obs.counter("serving.decode.cancelled").value or 0) \
            - c0
        assert cancelled == 2, "cancelled counter moved %d (want 2)" \
            % cancelled
    finally:
        sched.stop()
    return ("cancel(): active seq retired at iteration boundary, queued "
            "dropped at admission, both ServingCancelled, 0 leaked "
            "pages OK")


def scenario_replay_budget():
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.testing import faults

    model = _model()
    prompts = _prompts(3, 8)
    # 2 replicas suffice here — the 4-wide topology is scenario 1's job
    sched = serving.DecodeScheduler(model, _cfg())
    want = [np.asarray(sched.generate(p)) for p in prompts]
    sched.stop()
    pool = _pool(model, replicas=2, replay_budget=0)
    try:
        with faults.kill_replica_mid_decode(KILLED, min_tokens=2):
            futs = [pool.generate_async(p) for p in prompts]
            budget_failures, completed = 0, 0
            for i, f in enumerate(futs):
                try:
                    out = np.asarray(f.result(timeout=300))
                except serving.ServingDegraded as e:
                    assert "replay budget" in str(e), e
                    budget_failures += 1
                    continue
                assert out.tobytes() == want[i].tobytes(), (
                    "sequence %d completed with other tokens" % i)
                completed += 1
        assert budget_failures >= 1, (
            "kill with replay_budget=0 failed nothing typed")
        assert budget_failures + completed == len(prompts)
        assert pool.drain_decode(timeout=30)
    finally:
        pool.stop()
    return ("replay_budget=0: %d in-flight sequence(s) failed typed "
            "ServingDegraded, %d completed bitwise OK"
            % (budget_failures, completed))


def scenario_reset_pools_guard():
    from paddle_tpu_torch import serving

    model = _model()
    sched = serving.DecodeScheduler(
        model, _cfg(max_active=1, max_new_tokens=48))
    try:
        req = sched.submit(np.arange(1, 9, dtype=np.int32))
        while not req.token_times:
            time.sleep(0.002)
        try:
            sched._cache.reset_pools()
            raise AssertionError(
                "reset_pools zeroed KV under a live sequence")
        except serving.ServingError as e:
            assert "live sequence" in str(e) and str(req.seq) in str(e), e
        req.cancel()
        try:
            req.result(timeout=60)
        except serving.ServingCancelled:
            pass
        sched._cache.reset_pools(force=True)   # recovery path still works
    finally:
        sched.stop()
    return ("reset_pools: refused typed under a live sequence (seq "
            "listed), force=True zeroed OK")


def main():
    failures = []
    for scenario in (scenario_kill_replica_bitwise,
                     scenario_corrupt_kv_isolation,
                     scenario_decode_fault_fails_its_dispatch,
                     scenario_cancel,
                     scenario_replay_budget,
                     scenario_reset_pools_guard):
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
        sys.stderr.write("\ndecode resilience gate FAILED\n")
        return 1
    print("decode resilience gate OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
