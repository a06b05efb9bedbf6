#!/usr/bin/env python
"""Gate for the port's conversational sessions and prefill/decode roles
(``paddle_tpu_torch.serving``: ``SessionStore``, session pins in the
decode scheduler, sticky affinity and the host-staged KV handoff),
driven on replica pools on the CPU (``devices=["cpu"]``: every replica
on the one device, as every replica shares ``cuda:0`` on one card).
The port's counterpart of ``tools/check_sessions.py``, its five
scenarios.

Scenario 1 — warm-vs-cold bitwise + the refcount sweep:
  a 3-turn conversation (each turn's prompt = the FULL history + one
  utterance) on a 3-replica sessions pool must produce tokens
  bitwise-identical to a session-less pool cold-re-prefilling the very
  same full-history prompts, while prefilling strictly fewer tokens.
  Early exits must not leak: a cancelled session turn and a deadline
  shed at admission release their pages, and after ``end_session()``
  and TTL expiry (the store swept from the pool's decode gate) every
  replica's ``PagedKVCache.stats()`` sweep shows zero used
  pages and an empty ``rc_errors`` report.  The expiry is driven, not
  raced: the store's window is long while the turns run (a window of
  a second or two can lapse between a session's turns on a loaded
  host), and is cut to zero once they are done, so the pool's next
  sweep expires them.

Scenario 2 — affinity beats least-loaded:
  the same repeated-prefix conversational traffic through an affinity
  pool vs a control pool with affinity disabled
  (``affinity_timeout_s=0``): the affinity pool must land MORE
  prefix-cache page hits, with both pools bitwise-equal.  The affinity
  pool's hints hold for AFFINITY_HOLD_S, far longer than a turn takes on
  a loaded host, so no hint lapses to least-loaded on the clock.  Each
  turn submits the users in another order (rotated by one a turn): the
  replicas pull the shared queue, and where they pull in the same order
  every turn (as they can on a loaded host) a control fed in a fixed
  order would give each user the same replica every turn and hit as
  often as affinity does; rotated, no fixed pull order can.

Scenario 3 — kill the session owner mid-conversation:
  after turn 1 parks, ``faults.kill_session_owner`` kills the owning
  replica's decode worker once turn 2 holds in-flight KV; the turn
  completes BITWISE on a sibling (journal replay re-prefills the full
  history) and turn 3 still rides the re-parked session.

Scenario 4 — affinity never overrides health:
  with the sticky replica draining (rolling-swap state) or quiesced
  (``active=False``, the autoscale state), the next turn falls back
  (``serving.affinity.fallbacks`` advances), completes bitwise, and the
  session re-parks on a healthy replica.

Scenario 5 — prefill/decode roles:
  a ``roles=("prefill","decode","decode")`` pool serves multi-turn
  session traffic bitwise-equal to a role-less pool; every generation
  crossed the pool as a host-staged handoff packet
  (``serving.handoff.packets``/``injected`` advance), and the
  prefill-role replica retired no decode work of its own.

Left out: nothing of the scenarios.  The JAX gate's forced host-device
mesh (one CPU device a replica) has no counterpart: the port's replicas
share one device, as they share the card.  The handoff's pinned host
memory and its event wait run on the card only (``chip_smoke.py``'s
sessions phase); here the packets are plain CPU tensors.

Runnable locally (the port only: no jax is imported):
    python tools/check_sessions_torch.py
and run under pytest by tests/test_torch_sessions_gate.py.

Exit code 0 = every scenario held.
"""
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

DEVICES = ["cpu"]
# a session store's window and an affinity hint's hold while the turns run:
# far longer than any turn, so neither lapses on a loaded host's clock
SESSION_TTL_S = 600.0
AFFINITY_HOLD_S = 60.0


def _model():
    from paddle_tpu_torch.models import transformer as T

    params, meta = T.lm_params(seed=31, vocab_size=60, n_layer=2,
                               n_head=2, d_model=32, d_inner=64,
                               max_length=128)
    return T.build_decode_model(params, meta, device="cpu")


def _cfg(**kw):
    from paddle_tpu_torch import serving

    base = dict(num_slots=2, page_size=8, max_seq_len=112,
                max_new_tokens=8, prefill_chunk_tokens=16,
                prefix_cache=True, queue_capacity=64)
    base.update(kw)
    return serving.DecodeConfig(**base)


def _pool(model, replicas=3, pool_kw=None, **cfg_kw):
    from paddle_tpu_torch import serving

    return serving.ReplicaPool(
        None, replicas=replicas, devices=DEVICES, decode_model=model,
        decode_config=_cfg(**cfg_kw), supervisor_interval_s=0.05,
        **(pool_kw or {}))


def _conversations(n_users, n_turns, seed=3):
    rng = np.random.RandomState(seed)
    base = [rng.randint(1, 60, size=20).astype(np.int32)
            for _ in range(n_users)]
    utts = [[rng.randint(1, 60, size=12).astype(np.int32)
             for _ in range(n_turns - 1)] for _ in range(n_users)]
    return base, utts


def _run_conversations(pool, base, utts, n_turns, session_fmt="u%d",
                       sessions=True, rotate=False):
    """Drive the conversations turn-synchronously (users interleaved
    within a turn; with ``rotate``, turn t submits them starting from
    user t); returns (per-user-per-turn outputs, histories)."""
    n_users = len(base)
    hists = [list(map(int, b)) for b in base]
    outs = [[] for _ in range(n_users)]
    for t in range(n_turns):
        if t > 0:
            for u in range(n_users):
                hists[u] = hists[u] + list(map(int, utts[u][t - 1]))
        order = [(u + (t if rotate else 0)) % n_users
                 for u in range(n_users)]
        futs = {}
        for u in order:
            kw = dict(session=session_fmt % u) if sessions else {}
            futs[u] = pool.generate_async(
                np.asarray(hists[u], np.int32), max_new_tokens=8,
                temperature=0.0, **kw)
        for u in range(n_users):
            out = list(map(int, futs[u].result(timeout=300)))
            outs[u].append(out)
            hists[u] = hists[u] + out
    return outs, hists


def _assert_no_leaks(pool, label):
    """Every replica's allocator sweep: no used pages, no refcount
    partition violations.  Pin releases land on worker loops, so poll
    briefly before judging."""
    deadline = time.perf_counter() + 5.0
    while time.perf_counter() < deadline:
        stats = [r.decoder.cache_stats() for r in pool._replicas]
        if all(s["used_pages"] == 0 for s in stats):
            break
        time.sleep(0.02)
    for i, s in enumerate(stats):
        assert s["used_pages"] == 0, (
            "%s: replica %d leaked %d pages: %r"
            % (label, i, s["used_pages"], s))
        assert not s["rc_errors"], (
            "%s: replica %d refcount sweep failed: %r"
            % (label, i, s["rc_errors"]))
        assert s["rc_sum_matches"], (
            "%s: replica %d rc-sum mismatch: %r" % (label, i, s))


def scenario_warm_vs_cold_bitwise():
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import serving

    model = _model()
    n_turns = 3
    base, utts = _conversations(3, n_turns)
    prefill = obs.counter("serving.decode.prefill_tokens")

    # a long window while the turns run; the expiry path is driven below
    # by cutting it, and the pool's decode gate sweeps the store
    store = serving.SessionStore(capacity=64, ttl_s=SESSION_TTL_S)
    pool = _pool(model, pool_kw=dict(sessions=store))
    try:
        p0 = prefill.value
        warm, hists = _run_conversations(pool, base, utts, n_turns)
        warm_prefill = prefill.value - p0
        st = pool.sessions.stats()
        assert st["active"] == 3 and st["pinned_pages"] > 0, st

        # satellite 3: early-exit paths of session-tagged turns release
        # everything — cancel one mid-decode, cancel a burst while still
        # queued, and shed one at admission on a hopeless deadline
        can = pool.generate_async(np.asarray(hists[0], np.int32),
                                  max_new_tokens=8, session="u0")
        while not can.token_times and not can.done():
            time.sleep(0.002)
        can.cancel()
        queued = [pool.generate_async(np.asarray(hists[1], np.int32),
                                      max_new_tokens=8, session="u1")
                  for _ in range(6)]
        for q in queued:
            q.cancel()
        try:
            pool.generate_async(np.asarray(hists[2], np.int32),
                                max_new_tokens=8, session="u2",
                                deadline_ms=0.001)
            shed_at_admission = False
        except serving.ServingOverloaded:
            shed_at_admission = True
        for req in [can] + queued:
            try:
                req.result(timeout=60)
            except serving.ServingCancelled:
                pass
            # a cancel that raced completion is fine — the sweep below
            # is the real judge
        assert shed_at_admission, (
            "hopeless-deadline request was admitted instead of shed")
        # end one session explicitly, let TTL expire the others: the
        # window cut to zero, every idle session is past it at the next
        # sweep
        assert pool.end_session("u0")
        assert not pool.end_session("nope")
        store.ttl_s = 0.0
        deadline = time.perf_counter() + 10
        while pool.sessions.stats()["active"] and \
                time.perf_counter() < deadline:
            time.sleep(0.05)
        assert pool.sessions.stats()["active"] == 0, pool.sessions.stats()
        _assert_no_leaks(pool, "warm pool after end/expiry")
    finally:
        pool.stop()

    # cold control: SAME full-history prompts, no sessions, no cache
    cold_pool = _pool(model, prefix_cache=False)
    try:
        p0 = prefill.value
        cold, _ = _run_conversations(cold_pool, base, utts, n_turns,
                                     sessions=False)
        cold_prefill = prefill.value - p0
    finally:
        cold_pool.stop()

    assert warm == cold, (
        "session-warm conversation tokens differ from cold full-history "
        "re-prefill")
    assert warm_prefill < cold_prefill, (
        "sessions prefilled %d tokens, cold %d — no reuse happened"
        % (warm_prefill, cold_prefill))
    return ("3-turn x3 conversations: warm == cold bitwise, prefill "
            "%d vs %d tokens, early exits + end/TTL-expiry left 0 "
            "used pages / 0 rc errors OK" % (warm_prefill, cold_prefill))


def scenario_affinity_beats_least_loaded():
    from paddle_tpu_torch import observability as obs

    model = _model()
    n_turns = 3
    base, utts = _conversations(4, n_turns, seed=11)
    hits = obs.counter("serving.decode.kv_hit_pages")

    pool = _pool(model, pool_kw=dict(affinity_timeout_s=AFFINITY_HOLD_S))
    try:
        h0 = hits.value
        warm, _ = _run_conversations(pool, base, utts, n_turns,
                                     rotate=True)
        warm_hits = hits.value - h0
    finally:
        pool.stop()

    control = _pool(model, pool_kw=dict(affinity_timeout_s=0))
    try:
        h0 = hits.value
        ctl, _ = _run_conversations(control, base, utts, n_turns,
                                    rotate=True)
        ctl_hits = hits.value - h0
    finally:
        control.stop()

    assert warm == ctl, "affinity routing changed tokens"
    assert warm_hits > ctl_hits, (
        "affinity pool hit %d cached pages, least-loaded control hit %d "
        "— affinity bought nothing" % (warm_hits, ctl_hits))
    return ("affinity hit %d cached pages vs %d least-loaded (bitwise "
            "equal) OK" % (warm_hits, ctl_hits))


def scenario_kill_session_owner():
    from paddle_tpu_torch.testing import faults

    model = _model()
    base, utts = _conversations(1, 3, seed=17)

    # fault-free reference
    ref_pool = _pool(model, prefix_cache=False)
    try:
        ref, _ = _run_conversations(ref_pool, base, utts, 3,
                                    sessions=False)
    finally:
        ref_pool.stop()

    pool = _pool(model)
    try:
        hist = list(map(int, base[0]))
        out1 = list(map(int, pool.generate(
            np.asarray(hist, np.int32), max_new_tokens=8,
            temperature=0.0, session="conv", timeout=300)))
        rec = pool.sessions.get("conv", touch=False)
        assert rec is not None and rec.pages, rec
        owner = rec.replica

        hist = hist + out1 + list(map(int, utts[0][0]))
        with faults.kill_session_owner(pool, "conv", min_tokens=2) \
                as fired:
            out2 = list(map(int, pool.generate(
                np.asarray(hist, np.int32), max_new_tokens=8,
                temperature=0.0, session="conv", timeout=300)))
        assert fired[0] == 1, "kill hook fired %d times" % fired[0]

        hist = hist + out2 + list(map(int, utts[0][1]))
        out3 = list(map(int, pool.generate(
            np.asarray(hist, np.int32), max_new_tokens=8,
            temperature=0.0, session="conv", timeout=300)))
        assert [out1, out2, out3] == ref[0], (
            "conversation tokens diverged after the owner kill")
        rec = pool.sessions.get("conv", touch=False)
        assert rec is not None, "session lost after the owner kill"
        assert pool.end_session("conv")
        _assert_no_leaks(pool, "kill-owner pool")
    finally:
        pool.stop()
    return ("owner (replica %d) killed mid-turn-2: conversation "
            "completed bitwise on a sibling, session survived, 0 "
            "leaks OK" % owner)


def scenario_affinity_vs_health():
    from paddle_tpu_torch import observability as obs

    model = _model()
    base, utts = _conversations(1, 4, seed=23)

    ref_pool = _pool(model, prefix_cache=False)
    try:
        ref, _ = _run_conversations(ref_pool, base, utts, 4,
                                    sessions=False)
    finally:
        ref_pool.stop()

    fallbacks = obs.counter("serving.affinity.fallbacks")
    pool = _pool(model)
    try:
        hist = list(map(int, base[0]))
        outs = []
        out = list(map(int, pool.generate(
            np.asarray(hist, np.int32), max_new_tokens=8,
            temperature=0.0, session="conv", timeout=300)))
        outs.append(out)
        degraded = []
        for turn, state in ((1, "draining"), (2, "active"), (3, None)):
            rec = pool.sessions.get("conv", touch=False)
            assert rec is not None
            rep = pool._replicas[rec.replica]
            f0 = fallbacks.value
            if state == "draining":       # rolling-swap drain
                rep.draining = True
            elif state == "active":       # autoscale quiesce
                rep.active = False
            hist = hist + outs[-1] + list(map(int, utts[0][turn - 1]))
            out = list(map(int, pool.generate(
                np.asarray(hist, np.int32), max_new_tokens=8,
                temperature=0.0, session="conv", timeout=300)))
            outs.append(out)
            if state is not None:
                assert fallbacks.value > f0, (
                    "turn under %s=%s sticky replica never fell back"
                    % (state, rec.replica))
                newrec = pool.sessions.get("conv", touch=False)
                assert newrec is not None \
                    and newrec.replica != rec.replica, (
                        "session still parked on the unhealthy replica")
                degraded.append(state)
            if state == "draining":
                rep.draining = False
            elif state == "active":
                rep.active = True
        assert outs == ref[0], (
            "conversation tokens diverged under degraded stickiness")
        assert pool.end_session("conv")
        _assert_no_leaks(pool, "health-degraded pool")
    finally:
        pool.stop()
    return ("sticky replica %s: each turn fell back, re-parked "
            "elsewhere, conversation bitwise, 0 leaks OK"
            % " then ".join(degraded))


def scenario_roles_handoff():
    from paddle_tpu_torch import observability as obs

    model = _model()
    n_turns = 2
    base, utts = _conversations(3, n_turns, seed=29)

    plain = _pool(model)
    try:
        ref, _ = _run_conversations(plain, base, utts, n_turns)
    finally:
        plain.stop()

    packets = obs.counter("serving.handoff.packets")
    injected = obs.counter("serving.handoff.injected")
    pool = _pool(model, pool_kw=dict(roles=("prefill", "decode",
                                            "decode")))
    try:
        k0, i0 = packets.value, injected.value
        outs, _ = _run_conversations(pool, base, utts, n_turns)
        moved = packets.value - k0
        landed = injected.value - i0
        n_gens = len(base) * n_turns
        assert outs == ref, (
            "role-specialized pool tokens differ from the role-less "
            "pool")
        assert moved >= n_gens and landed >= n_gens, (
            "only %d/%d packets staged, %d injected — generations "
            "bypassed the handoff path" % (moved, n_gens, landed))
        origin = pool._replicas[0].decoder.stats()
        assert origin["role"] == "prefill"
        assert origin["completed"] == 0, (
            "prefill-role replica retired %d decode sequences itself"
            % origin["completed"])
        for key in ("u%d" % u for u in range(len(base))):
            pool.end_session(key)
        _assert_no_leaks(pool, "roles pool")
    finally:
        pool.stop()
    return ("roles pool: %d handoff packets staged + injected, "
            "prefill replica retired nothing, bitwise vs role-less "
            "pool, 0 leaks OK" % moved)


def main():
    failures = []
    for scenario in (scenario_warm_vs_cold_bitwise,
                     scenario_affinity_beats_least_loaded,
                     scenario_kill_session_owner,
                     scenario_affinity_vs_health,
                     scenario_roles_handoff):
        try:
            msg = scenario()
        except AssertionError as e:
            failures.append("%s FAILED: %s" % (scenario.__name__, e))
        else:
            print(msg)
    if failures:
        for f in failures:
            sys.stderr.write(f + "\n")
        sys.stderr.write("\nsessions gate FAILED\n")
        return 1
    if "jax" in sys.modules:
        failures.append("the gate imported jax")
        sys.stderr.write(failures[-1] + "\n\nsessions gate FAILED\n")
        return 1
    print("sessions gate OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
