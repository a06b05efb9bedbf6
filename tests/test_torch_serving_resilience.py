"""Serving self-healing of the port, on the CPU: the circuit breaker,
the resilient dispatcher (retry, then bisection to the poisoned
request), batcher stop/death semantics, the worker supervisor (restart
budget, give-up, degraded admission), the serving chaos injectors, the
engine-level degraded state machine — the cases of the JAX package's
``tests/unittests/test_serving_resilience.py`` against the port — and
the port's own classification of CUDA errors: an out-of-memory error is
transient and retried, a refused kernel launch or a sticky fault (a
device-side assert, an illegal address) is not (the exceptions are built
here on the CPU, as the card raises them)."""
import functools
import threading
import time
from unittest import mock

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import resilience
from paddle_tpu_torch import serving
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.parallel import flash_attention as tfa
from paddle_tpu_torch.serving.batcher import DynamicBatcher
from paddle_tpu_torch.serving.request_queue import Request
from paddle_tpu_torch.serving.resilient import (
    CircuitBreaker,
    ResilientDispatcher,
    WorkerSupervisor,
)
from paddle_tpu_torch.testing import faults

_engine = functools.partial(serving.InferenceEngine, device="cpu")


def _save_model(dirname, seed=17):
    main = fluid.Program()
    startup = fluid.Program()
    startup.random_seed = seed
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        h = fluid.layers.fc(x, size=16, act="relu")
        out = fluid.layers.fc(h, size=4, act="softmax")
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.io.save_inference_model(dirname, ["x"], [out], exe,
                                      main_program=main)
    return dirname


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return _save_model(str(tmp_path_factory.mktemp("resil") / "model"))


def _req(rows=1, priority=None):
    return Request({"x": np.zeros((rows, 8), "float32")}, rows,
                   priority=priority)


BUCKETS = (2, 4)


# -- circuit breaker ---------------------------------------------------------

class TestCircuitBreaker:
    def test_trips_on_consecutive_fatal_and_half_open_recovers(self):
        clock = [0.0]
        b = CircuitBreaker(threshold=3, cooldown_s=1.0,
                           clock=lambda: clock[0])
        assert b.state == "closed" and b.allow()
        b.record_fatal()
        b.record_fatal()
        b.record_success()       # success resets the consecutive count
        b.record_fatal()
        b.record_fatal()
        assert b.state == "closed"
        b.record_fatal()         # third consecutive -> open
        assert b.state == "open" and not b.allow()
        clock[0] = 0.5
        assert not b.allow()     # cooldown not elapsed
        clock[0] = 1.1
        assert b.state == "half_open"
        assert b.allow()         # the probe
        assert not b.allow()     # only ONE probe in flight
        b.record_success()
        assert b.state == "closed" and b.allow()

    def test_half_open_fatal_reopens_with_fresh_cooldown(self):
        clock = [0.0]
        b = CircuitBreaker(threshold=1, cooldown_s=1.0,
                           clock=lambda: clock[0])
        b.record_fatal()
        assert b.state == "open"
        clock[0] = 1.5
        assert b.allow()         # half-open probe
        b.record_fatal()
        assert b.state == "open"
        clock[0] = 2.0           # only 0.5s into the NEW cooldown
        assert not b.allow()
        clock[0] = 2.6
        assert b.allow()

    def test_disabled_breaker_never_opens(self):
        b = CircuitBreaker(threshold=None)
        for _ in range(50):
            b.record_fatal()
            assert b.allow() and b.state == "closed"

    def test_state_gauge_published(self):
        g = obs.gauge("test.breaker_state_private")
        b = CircuitBreaker(threshold=1, cooldown_s=99.0, state_gauge=g)
        assert g.value == 0
        b.record_fatal()
        assert g.value == 1
        # the shared default cell is last-writer-wins across co-hosted
        # engines: constructing another breaker must NOT zero a live
        # breaker's open signal
        g2 = obs.gauge("test.breaker_state_private2")
        CircuitBreaker(threshold=1, state_gauge=g2).record_fatal()
        assert g2.value == 1
        CircuitBreaker(threshold=1, state_gauge=g2)
        assert g2.value == 1

    def test_probe_lease_expires_when_probe_never_dispatches(self):
        clock = [0.0]
        b = CircuitBreaker(threshold=1, cooldown_s=1.0,
                           clock=lambda: clock[0])
        b.record_fatal()
        clock[0] = 1.2
        assert b.allow()          # probe admitted...
        assert not b.allow()      # ...slot held...
        clock[0] = 2.3            # ...but the probe never dispatched
        assert b.allow()          # lease expired: a fresh probe may try
        b.record_success()
        assert b.state == "closed"


# -- resilient dispatcher ----------------------------------------------------

class _ScriptedExecute:
    """Completes every request, unless told to fail this attempt or a
    poison request is present (fails fatally)."""

    def __init__(self, transient_failures=0, poison=()):
        self.transient_failures = transient_failures
        self.poison = set(poison)
        self.calls = []

    def __call__(self, requests):
        self.calls.append([id(r) for r in requests])
        if self.transient_failures > 0:
            self.transient_failures -= 1
            raise faults.FaultInjected("flaky runtime")
        bad = [r for r in requests if id(r) in self.poison]
        if bad:
            raise ValueError("poison request")
        for r in requests:
            r.complete(["ok"])


class TestResilientDispatcher:
    def test_transient_retry_recovers_bitwise_and_counts(self):
        exe = _ScriptedExecute(transient_failures=2)
        d = ResilientDispatcher(exe, max_retries=2, sleep=lambda s: None)
        r0 = obs.counter("serving.retries").value
        reqs = [_req() for _ in range(3)]
        ok, failed = d(reqs)
        assert (ok, failed) == (3, 0)
        assert all(r.result(timeout=0) == ["ok"] for r in reqs)
        assert obs.counter("serving.retries").value == r0 + 2
        assert len(exe.calls) == 3  # 2 failed attempts + 1 success

    def test_poison_bisected_innocents_survive(self):
        reqs = [_req() for _ in range(8)]
        poison = reqs[5]
        exe = _ScriptedExecute(poison=[id(poison)])
        d = ResilientDispatcher(exe, max_retries=2, sleep=lambda s: None)
        b0 = obs.counter("serving.bisections").value
        ok, failed = d(reqs)
        assert (ok, failed) == (7, 1)
        for r in reqs:
            if r is poison:
                with pytest.raises(ValueError, match="poison"):
                    r.result(timeout=0)
            else:
                assert r.result(timeout=0) == ["ok"]
        assert obs.counter("serving.bisections").value > b0
        # fatal errors are NOT retried: no attempt list repeats itself
        assert len(exe.calls) == len({tuple(c) for c in exe.calls})

    def test_persistent_transient_exhausts_then_bisects_to_leaves(self):
        exe = _ScriptedExecute(transient_failures=10 ** 6)
        d = ResilientDispatcher(exe, max_retries=1, sleep=lambda s: None)
        reqs = [_req(), _req()]
        ok, failed = d(reqs)
        assert (ok, failed) == (0, 2)
        for r in reqs:
            with pytest.raises(faults.FaultInjected):
                r.result(timeout=0)

    def test_breaker_fed_fatal_only_when_no_request_survives(self):
        class FakeBreaker:
            def __init__(self):
                self.events = []

            def record_success(self):
                self.events.append("ok")

            def record_fatal(self):
                self.events.append("fatal")

        fb = FakeBreaker()
        reqs = [_req() for _ in range(4)]
        exe = _ScriptedExecute(poison=[id(reqs[0])])
        ResilientDispatcher(exe, breaker=fb, sleep=lambda s: None)(reqs)
        assert fb.events == ["ok"]  # 3 survivors -> success outcome
        reqs2 = [_req()]
        exe2 = _ScriptedExecute(poison=[id(reqs2[0])])
        ResilientDispatcher(exe2, breaker=fb, sleep=lambda s: None)(reqs2)
        assert fb.events == ["ok", "fatal"]


# -- batcher stop/death semantics (satellite fix) ----------------------------

class TestBatcherStop:
    def test_stop_with_never_started_worker_fails_leftovers(self):
        q = serving.RequestQueue(capacity=8)
        b = DynamicBatcher(q, lambda reqs: None, 4, 0.0)
        futs = [q.put(_req()) for _ in range(3)]
        q.close()
        assert b.stop(drain=True, timeout=1.0)
        for f in futs:
            with pytest.raises(serving.ServingClosed):
                f.result(timeout=0)  # failed fast, not hanging
        assert q.depth() == 0

    def test_stop_join_timeout_on_wedged_worker_fails_leftovers(self):
        q = serving.RequestQueue(capacity=8)
        release = threading.Event()

        def wedge(reqs):
            release.wait(10)
            for r in reqs:
                r.complete(["late"])

        b = DynamicBatcher(q, wedge, 1, 0.0).start()
        first = q.put(_req())   # wedges the worker
        time.sleep(0.05)
        leftovers = [q.put(_req()) for _ in range(3)]
        q.close()
        assert not b.stop(drain=True, timeout=0.1)  # join times out
        for f in leftovers:
            with pytest.raises(serving.ServingClosed):
                f.result(timeout=0)
        release.set()
        assert first.result(timeout=5) == ["late"]  # in-flight finishes
        # drained leftovers were marked done: the completion watermark
        # covers them, so a later swap/wait_for drain can't stall
        assert b.wait_for(leftovers[-1].seq, timeout=5)
        b.stop(timeout=5)

    def test_drain_remaining_on_fail_advances_watermark(self):
        # the supervisor's give-up fail_pending path: requests failed
        # via drain_remaining must advance the batcher watermark or a
        # revived engine's swap drain stalls on them forever
        q = serving.RequestQueue(capacity=8)
        b = DynamicBatcher(q, lambda reqs: None, 4, 0.0)
        futs = [q.put(_req()) for _ in range(5)]
        q.drain_remaining(lambda r: serving.ServingDegraded("gone"),
                          on_fail=lambda r: b._mark_done([r]))
        assert b.completed_seq == futs[-1].seq
        assert b.wait_for(futs[-1].seq, timeout=0)

    def test_worker_death_fails_inflight_batch(self):
        q = serving.RequestQueue(capacity=8)

        def die(reqs):
            raise faults.WorkerKilled("chaos")

        b = DynamicBatcher(q, die, 4, 0.0).start()
        d0 = obs.counter("serving.worker_deaths").value
        fut = q.put(_req())
        with pytest.raises(serving.ServingDegraded, match="died"):
            fut.result(timeout=5)
        for _ in range(100):
            if not b.alive:
                break
            time.sleep(0.01)
        assert not b.alive
        assert obs.counter("serving.worker_deaths").value == d0 + 1

    def test_restart_rearms_dead_worker_preserving_watermark(self):
        q = serving.RequestQueue(capacity=8)
        calls = [0]

        def exe(reqs):
            calls[0] += 1
            if calls[0] == 1:
                raise faults.WorkerKilled("chaos")
            for r in reqs:
                r.complete(["ok"])

        b = DynamicBatcher(q, exe, 4, 0.0).start()
        f1 = q.put(_req())
        with pytest.raises(serving.ServingDegraded):
            f1.result(timeout=5)
        for _ in range(100):
            if not b.alive:
                break
            time.sleep(0.01)
        assert b.restart()
        f2 = q.put(_req())
        assert f2.result(timeout=5) == ["ok"]
        # the death-failed seq was marked done: the watermark moved past it
        assert b.wait_for(f2.seq, timeout=5)
        b.stop(timeout=5)

    def test_stop_no_drain_exits_after_inflight_batch(self):
        q = serving.RequestQueue(capacity=64)
        started = threading.Event()
        release = threading.Event()
        served = [0]

        def exe(reqs):
            started.set()
            release.wait(10)
            served[0] += len(reqs)
            for r in reqs:
                r.complete(["ok"])

        b = DynamicBatcher(q, exe, 1, 0.0).start()
        first = q.put(_req())
        assert started.wait(5)
        backlog = [q.put(_req()) for _ in range(20)]
        q.close()
        stopper = threading.Thread(
            target=b.stop, kwargs={"drain": False, "timeout": 5.0})
        stopper.start()
        time.sleep(0.05)
        release.set()
        stopper.join(10)
        assert first.result(timeout=5) == ["ok"]  # in-flight finished
        for f in backlog:  # backlog FAILED fast, not served
            with pytest.raises(serving.ServingClosed):
                f.result(timeout=5)
        assert served[0] == 1

    def test_out_of_order_completion_watermark_exact(self):
        q = serving.RequestQueue(capacity=8)
        b = DynamicBatcher(q, lambda reqs: None, 4, 0.0)
        r1, r2, r3 = _req(), _req(), _req()
        for r, s in ((r1, 1), (r2, 2), (r3, 3)):
            r.seq = s
        b._mark_done([r3])           # priority lanes complete out of order
        assert b.completed_seq == 0  # seq 1 and 2 still outstanding
        assert not b.wait_for(3, timeout=0.01)
        b._mark_done([r1])
        assert b.completed_seq == 1
        b._mark_done([r2])
        assert b.completed_seq == 3  # contiguous prefix caught up
        assert b.wait_for(3, timeout=0.01)


# -- worker supervisor -------------------------------------------------------

class TestWorkerSupervisor:
    def test_restarts_dead_worker_and_counts(self):
        alive = [False]
        restarted = []
        sup = WorkerSupervisor(interval_s=0.01, max_restarts=3)
        sup.watch("w", should_run=lambda: True,
                  is_alive=lambda: alive[0],
                  restart=lambda: (restarted.append(1),
                                   alive.__setitem__(0, True))[0] or True,
                  fail_pending=lambda: None)
        c0 = obs.counter("serving.worker_restarts").value
        sup.start()
        try:
            for _ in range(200):
                if restarted:
                    break
                time.sleep(0.01)
            assert restarted and alive[0]
            assert obs.counter("serving.worker_restarts").value == c0 + 1
            assert sup.stats()["w"]["restarts"] == 1
        finally:
            sup.stop()
        assert not sup.alive

    def test_give_up_past_budget_fails_pending_and_notifies(self):
        failed, gave = [], []
        sup = WorkerSupervisor(interval_s=0.01, max_restarts=1,
                               on_give_up=lambda name: gave.append(name))
        sup.watch("w", should_run=lambda: True,
                  is_alive=lambda: False,       # restart never sticks
                  restart=lambda: True,
                  fail_pending=lambda: failed.append(1))
        sup.start()
        try:
            for _ in range(300):
                if gave:
                    break
                time.sleep(0.01)
            assert gave == ["w"]
            assert failed                      # pending failed fast
            assert sup.stats()["w"]["gave_up"]
        finally:
            sup.stop()


# -- chaos injectors ---------------------------------------------------------

class TestChaosInjectors:
    def test_flaky_execute_fires_and_restores(self):
        from paddle_tpu_torch import resilience

        assert resilience._serve_fault is None
        with faults.flaky_execute(times=2) as fired:
            hook = resilience._serve_fault
            with pytest.raises(faults.FaultInjected):
                hook([_req()])
            with pytest.raises(faults.FaultInjected):
                hook([_req()])
            hook([_req()])  # budget spent: passes
            assert fired[0] == 2
        assert resilience._serve_fault is None

    def test_injectors_compose_and_unwind(self):
        from paddle_tpu_torch import resilience

        poison = _req()
        poison.seq = 99
        clean = _req()
        clean.seq = 1
        with faults.flaky_execute(times=1):
            with faults.poison_request(99):
                hook = resilience._serve_fault
                with pytest.raises(faults.FaultInjected):
                    hook([clean])              # flaky fires first
                with pytest.raises(ValueError, match="poison"):
                    hook([clean, poison])      # then poison matches
                hook([clean])                  # innocents pass
            assert resilience._serve_fault is not None
        assert resilience._serve_fault is None

    def test_slow_execute_delays(self):
        from paddle_tpu_torch import resilience

        with faults.slow_execute(0.05, times=1) as fired:
            t0 = time.perf_counter()
            resilience._serve_fault([_req()])
            assert time.perf_counter() - t0 >= 0.05
            t0 = time.perf_counter()
            resilience._serve_fault([_req()])  # budget spent
            assert time.perf_counter() - t0 < 0.05
            assert fired[0] == 1


# -- engine integration ------------------------------------------------------

class TestEngineResilience:
    def test_flaky_execute_retries_to_success_bitwise(self, model_dir):
        X = np.random.RandomState(3).randn(2, 8).astype("float32")
        with _engine(model_dir, batch_buckets=BUCKETS,
                     supervise=False) as eng:
            want = eng.predict({"x": X})[0]
            r0 = obs.counter("serving.retries").value
            with faults.flaky_execute(times=2):
                got = eng.predict({"x": X}, timeout=30)[0]
            assert got.tobytes() == want.tobytes()
            assert obs.counter("serving.retries").value == r0 + 2

    def test_poison_bisection_on_engine(self, model_dir):
        rng = np.random.RandomState(4)
        payloads = [rng.randn(1, 8).astype("float32") for _ in range(6)]
        eng = _engine(model_dir, batch_buckets=BUCKETS,
                                      max_batch_size=4, autostart=False,
                                      supervise=False)
        try:
            want = []
            futs = [eng.predict_async({"x": p}) for p in payloads]
            poison_seq = futs[2].seq
            b0 = obs.counter("serving.bisections").value
            with faults.poison_request(poison_seq):
                eng.start()
                for i, f in enumerate(futs):
                    if f.seq == poison_seq:
                        with pytest.raises(ValueError, match="poison"):
                            f.result(timeout=30)
                    else:
                        out = f.result(timeout=30)[0]
                        want.append((i, out))
            assert obs.counter("serving.bisections").value > b0
            # innocents got REAL answers, bitwise equal to a clean engine
            with _engine(model_dir, batch_buckets=BUCKETS,
                                         supervise=False) as ref:
                for i, out in want:
                    clean = ref.predict({"x": payloads[i]})[0]
                    assert out.tobytes() == clean.tobytes()
        finally:
            eng.stop()

    def test_breaker_degrades_engine_and_half_open_recovers(self, model_dir):
        X = np.zeros((1, 8), "float32")
        with _engine(
                model_dir, batch_buckets=BUCKETS, supervise=False,
                breaker_threshold=2, breaker_cooldown_s=0.2) as eng:
            with faults.poison_request(lambda r: True):
                for _ in range(2):
                    with pytest.raises(ValueError):
                        eng.predict({"x": X}, timeout=30)
                assert eng.state == "degraded" and not eng.ready()
                assert eng.health()["breaker"] == "open"
                with pytest.raises(serving.ServingDegraded):
                    eng.predict({"x": X})
            time.sleep(0.25)  # cooldown -> half-open probe allowed
            out = eng.predict({"x": X}, timeout=30)
            assert out[0].shape == (1, 4)
            assert eng.state == "ready" and eng.ready()
            assert eng.health()["breaker"] == "closed"

    def test_kill_worker_supervisor_restarts_and_serves(self, model_dir):
        X = np.random.RandomState(5).randn(1, 8).astype("float32")
        with _engine(
                model_dir, batch_buckets=BUCKETS,
                supervisor_interval_s=0.02) as eng:
            want = eng.predict({"x": X})[0]
            r0 = obs.counter("serving.worker_restarts").value
            with faults.kill_worker(at_dispatch=0):
                doomed = eng.predict_async({"x": X})
                with pytest.raises(serving.ServingDegraded):
                    doomed.result(timeout=10)
            # supervisor notices the dead thread and re-arms it.  Wait
            # on the restart COUNTER: right after result() raises, the
            # dying thread can still be briefly alive, so worker_alive
            # alone can read True before the restart happened.
            deadline = time.time() + 10
            while (time.time() < deadline
                   and obs.counter("serving.worker_restarts").value == r0):
                time.sleep(0.02)
            assert obs.counter("serving.worker_restarts").value == r0 + 1
            assert eng.health()["worker_alive"]
            got = eng.predict({"x": X}, timeout=30)[0]
            assert got.tobytes() == want.tobytes()
            assert eng.health()["workers"]["batcher"]["restarts"] == 1

    def test_explicit_start_revives_given_up_worker(self, model_dir):
        X = np.random.RandomState(6).randn(1, 8).astype("float32")
        eng = _engine(model_dir, batch_buckets=BUCKETS,
                                      supervisor_interval_s=0.02,
                                      worker_max_restarts=0)
        try:
            want = eng.predict({"x": X})[0]
            with faults.kill_worker(at_dispatch=0):
                with pytest.raises(serving.ServingDegraded):
                    eng.predict({"x": X}, timeout=30)
            # zero restart budget: the supervisor gives up immediately
            # and admission fast-fails
            deadline = time.time() + 10
            while eng.state != "degraded" and time.time() < deadline:
                time.sleep(0.01)
            assert eng.state == "degraded"
            with pytest.raises(serving.ServingDegraded):
                eng.predict({"x": X})
            # an explicit operator start() grants a fresh budget: the
            # worker revives AND admissions stop fast-failing (a revive
            # that left _failed_workers set would serve nobody forever)
            eng.start()
            assert eng.health()["worker_alive"]
            assert eng.state == "ready"
            got = eng.predict({"x": X}, timeout=30)[0]
            assert got.tobytes() == want.tobytes()
            assert eng.health()["workers"]["batcher"]["gave_up"] is False
        finally:
            eng.stop()

    def test_priority_kwarg_flows_to_queue(self, model_dir):
        X = np.zeros((1, 8), "float32")
        eng = _engine(model_dir, batch_buckets=BUCKETS,
                                      autostart=False, supervise=False)
        try:
            f = eng.predict_async({"x": X}, priority="interactive")
            assert f.priority == "interactive"
            assert eng.health()["class_depths"]["interactive"] == 1
            with pytest.raises(serving.ServingError, match="priority"):
                eng.predict_async({"x": X}, priority="nope")
        finally:
            eng.stop()

    def test_admission_shed_after_estimator_warm(self, model_dir):
        X = np.zeros((1, 8), "float32")
        eng = _engine(model_dir, batch_buckets=BUCKETS,
                                      autostart=False, supervise=False)
        try:
            # no worker running: queue state is fully deterministic.
            # Warm the estimator to 10 rows/s, queue 5 rows ahead ->
            # ~500ms estimated wait for a batch-class arrival.
            eng._queue.note_service(rows=10, seconds=1.0)
            assert eng.health()["service_rate_rows_per_s"] == 10.0
            futs = [eng.predict_async({"x": X}) for _ in range(5)]
            s0 = obs.counter("serving.shed_admission").value
            with pytest.raises(serving.ServingOverloaded):
                eng.predict_async({"x": X}, deadline_ms=1)
            assert obs.counter("serving.shed_admission").value == s0 + 1
            # a deadline beyond the estimate is admitted fine
            ok = eng.predict_async({"x": X}, deadline_ms=5000)
            # and an INTERACTIVE request sees no same-or-higher backlog
            # (all 6 queued rows are batch-class), so even 1ms admits
            fast = eng.predict_async({"x": X}, deadline_ms=25,
                                     priority="interactive")
            eng.start()
            assert ok.result(timeout=30) and fast.result(timeout=30)
            for f in futs:
                f.result(timeout=30)
        finally:
            eng.stop()


# -- an engine serving predict and generate ----------------------------------

class TestDualPathEngine:
    def test_dual_path_engine_stays_ready_when_breaker_open(self, tmp_path):
        params, meta = TT.lm_params(seed=7, vocab_size=50, n_layer=2,
                                    n_head=2, d_model=32, d_inner=64,
                                    max_length=128)
        model_dir = _save_model(str(tmp_path / "m"))
        eng = _engine(
            model_dir, batch_buckets=BUCKETS,
            decode_model=TT.build_decode_model(params, meta,
                                               device="cpu"),
            decode_config=serving.DecodeConfig(
                num_slots=2, page_size=8, max_seq_len=64,
                max_new_tokens=4),
            supervise=False, breaker_threshold=1, breaker_cooldown_s=60.0)
        try:
            X = np.zeros((1, 8), "float32")
            with faults.poison_request(
                    lambda r: not isinstance(r,
                                             serving.GenerateRequest)):
                with pytest.raises(ValueError):
                    eng.predict({"x": X}, timeout=30)
            assert eng.state == "degraded"
            with pytest.raises(serving.ServingDegraded):
                eng.predict_async({"x": X})
            # ...but the DECODE path is healthy: engine stays ready and
            # generate() serves normally while predict is broken
            assert eng.ready()
            toks = eng.generate(np.arange(1, 9, dtype=np.int32),
                                timeout=30)
            assert len(toks) == 4
        finally:
            eng.stop()

    def test_decoder_supervision_hooks(self):
        """The decode scheduler's supervisor hooks: ``fail_pending`` fails
        queued work only while the worker is dead (never under a live
        worker), and ``started``/``stopping``/``restart`` report and
        re-arm its thread."""
        params, meta = TT.lm_params(seed=7, vocab_size=50, n_layer=2,
                                    n_head=2, d_model=32, d_inner=64,
                                    max_length=128)
        sched = serving.DecodeScheduler(
            TT.build_decode_model(params, meta, device="cpu"),
            serving.DecodeConfig(num_slots=2, page_size=8, max_seq_len=64,
                                 max_new_tokens=4, warmup=False),
            autostart=False)
        try:
            assert not sched.started and not sched.stopping
            doomed = sched.submit(np.arange(1, 6, dtype=np.int32))
            assert sched.fail_pending(serving.ServingDegraded("gone"))
            with pytest.raises(serving.ServingDegraded, match="gone"):
                doomed.result(timeout=0)
            sched.start()
            assert sched.started and sched.alive
            assert not sched.restart()      # alive: nothing to re-arm
            assert not sched.fail_pending(serving.ServingDegraded("no"))
            toks = sched.submit(np.arange(1, 6, dtype=np.int32)).result(
                timeout=30)
            assert len(toks) == 4
        finally:
            sched.stop(timeout=10)
        assert sched.stopping and not sched.alive


# -- CUDA error classification (the port's counterpart of XLA status codes)

def _launch_error():
    """The RuntimeError a kernel wrapper raises when its C entry returns a
    CUDA error (here: 1, cudaErrorInvalidValue; the card's name is
    stood in for, as there is none here)."""
    with mock.patch.object(torch.cuda, "get_device_name",
                           lambda *args: "NVIDIA H100 80GB HBM3"):
        try:
            tfa._raise_on(1, "flash_attention_fwd")
        except RuntimeError as exc:
            return exc
    raise AssertionError("_raise_on(1) did not raise")


class TestCudaErrorClassification:
    def test_out_of_memory_is_transient(self):
        oom = torch.cuda.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 2.00 GiB")
        assert resilience.is_transient_cuda_error(oom)
        assert resilience.is_transient_error(oom)

    @pytest.mark.parametrize("message", [
        "CUDA error: device-side assert triggered",
        "CUDA error: an illegal memory access was encountered",
        "CUDA error: an illegal address was encountered",
        "CUDA error: unspecified launch failure",
    ])
    def test_sticky_faults_are_not_transient(self, message):
        for exc in (RuntimeError(message), torch.AcceleratorError(message),
                    torch.cuda.OutOfMemoryError(
                        "CUDA out of memory after " + message)):
            assert not resilience.is_transient_cuda_error(exc)
            assert not resilience.is_transient_error(exc)

    def test_refused_kernel_launch_is_not_transient(self):
        exc = _launch_error()
        assert "launch failed" in str(exc)
        assert not resilience.is_transient_error(exc)

    def test_retry_takes_the_oom_and_stops_at_the_launch_error(self):
        calls = []

        def flaky(errors):
            calls.append(1)
            if errors:
                raise errors.pop(0)
            return "ok"

        policy = resilience.RetryPolicy(max_retries=3, sleep=lambda s: None)
        r0 = resilience.retry_count()
        assert resilience.call_with_retry(
            flaky, [torch.cuda.OutOfMemoryError("CUDA out of memory")],
            policy=policy) == "ok"
        assert len(calls) == 2 and resilience.retry_count() == r0 + 1
        calls.clear()
        with pytest.raises(RuntimeError, match="launch failed"):
            resilience.call_with_retry(flaky, [_launch_error()],
                                       policy=policy)
        assert len(calls) == 1

    def test_dispatcher_retries_oom_and_bisects_a_launch_error(self):
        """On the serving path: an OOM dispatch is retried to the same
        answer; a launch error is fatal, so the batch is bisected and
        never retried (no attempt list repeats)."""
        oom = [torch.cuda.OutOfMemoryError("CUDA out of memory")]
        calls = []

        def execute(requests):
            calls.append(tuple(id(r) for r in requests))
            if oom:
                raise oom.pop()
            if len(requests) > 1:
                raise _launch_error()
            for r in requests:
                r.complete(["ok"])

        d = ResilientDispatcher(execute, max_retries=2,
                                sleep=lambda s: None)
        reqs = [_req() for _ in range(4)]
        assert d(reqs) == (4, 0)
        assert calls[0] == calls[1]      # the OOM attempt, retried
        assert len(calls[1:]) == len(set(calls[1:]))
        assert all(r.result(timeout=0) == ["ok"] for r in reqs)

    def test_classifiers_leave_programming_errors_alone(self):
        for exc in (TypeError("x"), KeyError("x"), ValueError("x"),
                    FileNotFoundError("x"), KeyboardInterrupt()):
            assert not resilience.is_transient_error(exc)
        assert resilience.is_transient_error(faults.FaultInjected("flaky"))
        assert resilience.is_transient_error(OSError("EIO"))
