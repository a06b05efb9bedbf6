"""Serving-side self-healing: retry, poison bisection, breaker, supervisor.

Counterpart of ``paddle_tpu/serving/resilient.py``: the retry policies
and transient classification of ``paddle_tpu_torch.resilience`` applied
to the serving dispatch path, where one worker thread serves many
independent clients, so a single bad request, a transient runtime
hiccup, or a dead thread must never translate into "every caller hangs
or fails".

Three cooperating pieces, wired together by the engine:

- :class:`ResilientDispatcher` wraps the engine's batch execute.
  Transient failures (classified by ``resilience.is_transient_error`` —
  a CUDA out-of-memory error, a flaky IO path, injected
  ``faults.flaky_execute``; never a sticky CUDA fault or a refused
  kernel launch) are retried with bounded exponential
  backoff; results stay bitwise-identical because the dispatch is pure.
  A batch that still fails is BISECTED: split in half and each half
  dispatched independently (no fresh retry budget — the top-level
  dispatch already spent it), recursively, until the poison request(s)
  fail alone and every innocent co-batched neighbor gets its answer.  Cost is O(poison * log batch) extra
  dispatches, paid only on failure.
- :class:`CircuitBreaker` watches dispatch outcomes.  N CONSECUTIVE
  fatal batches (no request in the batch succeeded) trip it open: the
  engine reports ``degraded``, admission fast-fails with
  ``ServingDegraded`` (typed, instant — callers fail over instead of
  queueing into a black hole), and after a cooldown the breaker goes
  half-open, letting ONE probe request through; a successful probe
  closes it, a failed one re-opens it.
- :class:`WorkerSupervisor` is the liveness watchdog: a dead
  ``DynamicBatcher``/``DecodeScheduler`` thread (today's failure mode:
  admitted requests hang forever) is restarted in place, up to
  ``max_restarts``; past the budget the supervisor fails all pending
  requests fast and the engine degrades, so no future ever dangles.

Everything reports on the observability registry: ``serving.retries``,
``serving.bisections``, ``serving.breaker_state`` (0 closed / 1 open /
2 half-open), ``serving.worker_restarts``, ``serving.worker_deaths``.
"""
from __future__ import annotations

import threading
import time

from .. import observability as _obs
from .. import resilience as _resilience
from .worker import emit_lifecycle

__all__ = ["CircuitBreaker", "ResilientDispatcher", "WorkerSupervisor"]

_retries = _obs.counter("serving.retries")
_bisections = _obs.counter("serving.bisections")
_breaker_gauge = _obs.gauge("serving.breaker_state")
_worker_restarts = _obs.counter("serving.worker_restarts")

#: breaker states, with the gauge codes the registry publishes
BREAKER_STATES = {"closed": 0, "open": 1, "half_open": 2}


class CircuitBreaker:
    """Consecutive-fatal-batch circuit breaker with half-open probes.

    ``threshold`` consecutive fatal outcomes (``record_fatal``) trip the
    breaker open for ``cooldown_s``; after the cooldown :meth:`allow`
    admits exactly one probe at a time (half-open) until an outcome is
    recorded — success closes, failure re-opens with a fresh cooldown.
    ``threshold=None`` (or 0) disables the breaker entirely: ``allow``
    is always True and the state stays ``closed``.

    Thread-safe: admission threads call :meth:`allow` while the worker
    thread records outcomes.  ``clock`` is injectable for deterministic
    tests.
    """

    def __init__(self, threshold=5, cooldown_s=1.0, clock=None,
                 state_gauge=None):
        self.threshold = None if not threshold else int(threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock or time.perf_counter
        self._gauge = state_gauge if state_gauge is not None else _breaker_gauge
        self._lock = threading.Lock()
        self._state = "closed"
        self._consecutive = 0
        self._opened_at = None
        self._probe_inflight = False
        self._probe_started = None
        # the gauge cell is process-wide (last writer wins across
        # co-hosted engines, same policy as serving.queue_depth): only
        # claim it when nobody has published yet, so constructing a
        # second engine can't zero a live engine's open-breaker signal
        if self._gauge.value is None:
            self._gauge.set(BREAKER_STATES["closed"])

    def _transition_locked(self, to):
        if to == self._state:
            return
        frm, self._state = self._state, to
        self._gauge.set(BREAKER_STATES[to])
        tel = _obs.get_telemetry()
        if tel.recording:
            tel.emit({
                "type": "breaker_transition", "ts": time.time(),
                "source": "serving", "from": frm, "to": to,
                "consecutive_fatal": self._consecutive,
            })

    def _tick_locked(self):
        """Lazy open -> half_open transition once the cooldown elapsed
        (there is no timer thread; the next reader performs it).  A
        half-open probe holds its slot for at most ``cooldown_s``: a
        probe that never reaches dispatch (rejected after allow() by
        feed validation or queue admission, or shed expired at pop
        time) produces no outcome, and without the lease expiry the
        breaker would wedge rejecting everything forever."""
        if (self._state == "open"
                and self._clock() - self._opened_at >= self.cooldown_s):
            self._probe_inflight = False
            self._transition_locked("half_open")
        if (self._state == "half_open" and self._probe_inflight
                and self._probe_started is not None
                and self._clock() - self._probe_started >= self.cooldown_s):
            self._probe_inflight = False

    @property
    def state(self):
        """"closed" | "open" | "half_open" (cooldown expiry applied)."""
        with self._lock:
            self._tick_locked()
            return self._state

    def allow(self):
        """Admission check: True to admit.  Closed admits everything;
        open admits nothing until the cooldown; half-open admits one
        probe at a time."""
        if self.threshold is None:
            return True
        with self._lock:
            self._tick_locked()
            if self._state == "closed":
                return True
            if self._state == "half_open" and not self._probe_inflight:
                self._probe_inflight = True
                self._probe_started = self._clock()
                return True
            return False

    def record_success(self):
        """A dispatch answered at least one request: the path works."""
        if self.threshold is None:
            return
        with self._lock:
            self._consecutive = 0
            self._probe_inflight = False
            self._transition_locked("closed")

    def record_fatal(self):
        """A dispatch failed every request in the batch (after retries
        and bisection) — the unit the threshold counts."""
        if self.threshold is None:
            return
        with self._lock:
            self._tick_locked()
            self._consecutive += 1
            self._probe_inflight = False
            if self._state == "half_open" or (
                    self._state == "closed"
                    and self._consecutive >= self.threshold):
                self._opened_at = self._clock()
                self._transition_locked("open")
            elif self._state == "open":
                # still failing while open (queued leftovers): extend
                self._opened_at = self._clock()


class ResilientDispatcher:
    """Wrap a batch ``execute`` with transient retry and poison bisection.

    ``execute(requests)`` is the engine's padded-bucket dispatch: it
    either answers every request in the list or raises having answered
    none (request completion is all-at-the-end), so a failed attempt can
    be retried or split without double-completing anyone.  The wrapper
    itself never raises ``Exception`` — terminal failures land on the
    individual requests — so the batcher worker survives every fault;
    ``BaseException`` (chaos ``kill_worker``, interpreter teardown)
    propagates and kills the worker, which is the supervisor's job to
    notice.
    """

    def __init__(self, execute, classify=None, max_retries=2,
                 base_delay_s=0.02, max_delay_s=0.25, breaker=None,
                 sleep=None):
        self._execute = execute
        # reuse resilience's retry machinery (backoff + jitter +
        # classification) rather than growing a second, drifting one; the
        # serving-specific accounting rides the on_retry hook
        self._policy = _resilience.RetryPolicy(
            max_retries=max_retries, base_delay=base_delay_s,
            max_delay=max_delay_s,
            classify=classify or _resilience.is_transient_error,
            sleep=sleep)
        # bisected sub-batches get NO fresh retry budget: the top-level
        # dispatch already spent it, and re-retrying every node of the
        # bisection tree would turn a path-wide outage into O(batch *
        # retries) dispatches + backoff sleeps right when the breaker
        # should be tripping fast
        self._bisect_policy = _resilience.RetryPolicy(
            max_retries=0, classify=self._policy.classify, sleep=sleep)
        self._breaker = breaker

    def __call__(self, requests):
        ok, failed = self._dispatch(list(requests))
        if self._breaker is not None:
            if ok:
                self._breaker.record_success()
            elif failed:
                self._breaker.record_fatal()
        return ok, failed

    @staticmethod
    def _note_retry(exc, attempt, delay, requests=()):
        _retries.inc()
        tel = _obs.get_telemetry()
        if tel.recording:
            tel.emit({
                "type": "serving_retry", "ts": time.time(),
                "source": "serving", "error": repr(exc)[:200],
                "attempt": attempt, "delay_s": delay,
            })
        if tel.span_active():
            # a retry belongs to EVERY request in the failed attempt:
            # one instant per trace, so "why was this request slow"
            # shows the transient fault it rode through
            now = time.time()
            err = repr(exc)[:120]
            for r in requests:
                trace = getattr(r, "trace", None)
                if trace is not None:
                    tel.record_span(
                        "serving.retry", now, 0.0,
                        tags=trace.child().tags(attempt=attempt,
                                                delay_s=delay, error=err))

    @staticmethod
    def _note_bisect(requests):
        _bisections.inc()
        tel = _obs.get_telemetry()
        if tel.span_active():
            now = time.time()
            for r in requests:
                trace = getattr(r, "trace", None)
                if trace is not None:
                    tel.record_span(
                        "serving.bisect", now, 0.0,
                        tags=trace.child().tags(batch=len(requests)))

    def _dispatch(self, requests, policy=None):
        """Run ``requests`` to terminal outcomes; returns
        ``(n_succeeded, n_failed)``."""
        def note(exc, attempt, delay):
            self._note_retry(exc, attempt, delay, requests)

        try:
            _resilience.call_with_retry(self._execute, requests,
                                        policy=policy or self._policy,
                                        on_retry=note)
            return len(requests), 0
        except Exception as err:  # noqa: BLE001 — non-retryable/exhausted
            if len(requests) == 1:
                # the poison, isolated: fail it alone
                if not requests[0].done():
                    requests[0].fail(err)
                return 0, 1
        # a fatal (or persistently "transient") multi-request batch:
        # bisect so innocents don't share the poison's fate
        self._note_bisect(requests)
        mid = len(requests) // 2
        ok_lo, bad_lo = self._dispatch(requests[:mid], self._bisect_policy)
        ok_hi, bad_hi = self._dispatch(requests[mid:], self._bisect_policy)
        return ok_lo + ok_hi, bad_lo + bad_hi


class _Target:
    __slots__ = ("name", "should_run", "is_alive", "restart",
                 "fail_pending", "restarts", "gave_up")

    def __init__(self, name, should_run, is_alive, restart, fail_pending):
        self.name = name
        self.should_run = should_run
        self.is_alive = is_alive
        self.restart = restart
        self.fail_pending = fail_pending
        self.restarts = 0
        self.gave_up = False


class WorkerSupervisor:
    """Liveness watchdog for serving worker threads.

    Polls every ``interval_s``; a target whose ``should_run()`` is True
    but whose thread is dead gets ``restart()`` (counted on
    ``serving.worker_restarts``), up to ``max_restarts`` times.  Past
    the budget the target is marked given-up, ``fail_pending()`` runs on
    every subsequent tick (so admissions that raced the death still fail
    fast instead of hanging), and ``on_give_up`` (if provided) tells the
    engine to degrade.
    """

    def __init__(self, interval_s=0.1, max_restarts=3, on_give_up=None):
        self.interval_s = float(interval_s)
        self.max_restarts = int(max_restarts)
        self._on_give_up = on_give_up
        self._targets = []
        self._stop_evt = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="paddle-tpu-torch-serving-supervisor",
            daemon=True)

    def watch(self, name, should_run, is_alive, restart, fail_pending):
        """Register one worker (call before :meth:`start`)."""
        self._targets.append(
            _Target(name, should_run, is_alive, restart, fail_pending))
        return self

    def start(self):
        if not self._thread.is_alive() and not self._stop_evt.is_set():
            self._thread.start()
        return self

    @property
    def alive(self):
        return self._thread.is_alive()

    def stop(self, timeout=2.0):
        self._stop_evt.set()
        if self._thread.is_alive():
            self._thread.join(timeout)

    def reset(self, name=None):
        """Grant a fresh restart budget: clear ``gave_up`` and the
        restart count for ``name`` (or every target).  The engine calls
        this from an explicit operator ``start()`` — reviving a
        given-up worker without resetting would leave a live thread
        whose admissions are rejected forever."""
        for t in self._targets:
            if name is None or t.name == name:
                t.restarts = 0
                t.gave_up = False

    def stats(self):
        return {t.name: {"restarts": t.restarts, "gave_up": t.gave_up,
                         "alive": bool(t.is_alive())}
                for t in self._targets}

    def _run(self):
        while not self._stop_evt.wait(self.interval_s):
            for t in self._targets:
                try:
                    if not t.should_run() or t.is_alive():
                        continue
                    if t.gave_up or t.restarts >= self.max_restarts:
                        first = not t.gave_up
                        t.gave_up = True
                        # keep failing pending work every tick: requests
                        # admitted after the drain must not hang either
                        t.fail_pending()
                        if first:
                            emit_lifecycle("give_up", t.name,
                                           restarts=t.restarts)
                            if self._on_give_up is not None:
                                self._on_give_up(t.name)
                        continue
                    if t.restart():
                        t.restarts += 1
                        _worker_restarts.inc()
                        emit_lifecycle("restart", t.name,
                                       restarts=t.restarts)
                except Exception:
                    # the watchdog must outlive anything a probe raises
                    pass
