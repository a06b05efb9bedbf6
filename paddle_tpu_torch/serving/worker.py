"""Restartable serving worker: the shared start/restart/death choke point.

``DynamicBatcher`` and ``DecodeScheduler`` each grew the same delicate
thread-lifecycle machinery (PR 5 then PR 6/7): a single-use
``threading.Thread`` that must be re-armed after death, a life lock so a
supervisor restart tick and an operator ``start()`` never race a spawn
into two workers, and a ``BaseException`` choke so a chaos
``kill_worker`` or interpreter teardown dies *silently but observably*
— counted, recorded, and cleaned up, never a stack trace from a daemon
thread nor a hung future.  Twice-duplicated lifecycle code is exactly
where the two copies drift (the ROADMAP called this extraction out);
this module is the single implementation both wrap.

Every lifecycle transition is observable three ways: the
``serving.worker_deaths`` / ``serving.worker_restarts`` counters (PR 7
names, unchanged), a structured record (``type: "worker_death"`` /
``"worker_lifecycle"``), and — when a span sink is attached — an
instant trace event (``serving.worker.start`` / ``.death`` /
``.restart`` / ``.give_up``) on the worker's own track, so a Perfetto
timeline shows WHEN the worker died relative to the requests it was
holding.
"""
from __future__ import annotations

import threading
import time

from .. import observability as _obs

__all__ = ["RestartableWorker", "emit_lifecycle"]

_worker_deaths = _obs.counter("serving.worker_deaths")


def emit_lifecycle(event, worker, **details):
    """Emit one worker lifecycle transition (``start`` / ``death`` /
    ``restart`` / ``give_up``) as a structured record plus an instant
    trace event.  Death keeps the PR-7 record shape (``type:
    "worker_death"``) that tests and dashboards already consume."""
    tel = _obs.get_telemetry()
    if tel.recording:
        rec = {"type": {"death": "worker_death",
                        "restart": "worker_restart"}.get(
                            event, "worker_lifecycle"),
               "ts": time.time(), "source": "serving", "worker": worker}
        if event != "death":
            rec["event"] = event
        rec.update(details)
        tel.emit(rec)
    if tel.span_active():
        tags = {"worker": worker}
        tags.update({k: v for k, v in details.items()})
        tel.record_span("serving.worker.%s" % event, time.time(), 0.0,
                        tags=tags)


class RestartableWorker:
    """One restartable daemon thread running ``run`` until it returns.

    ``run`` is the owner's serve loop; any ``Exception`` discipline is
    the loop's own business (both owners catch per-batch faults
    inside).  ``BaseException`` escaping the loop is the DEATH path:
    counted on ``serving.worker_deaths``, reported via
    :func:`emit_lifecycle`, handed to ``on_death`` (the batcher fails
    its in-flight batch there; the decoder has nothing extra to clean),
    and then the thread ends — the supervisor's ``restart()`` re-arms a
    fresh thread with all owner state carried over.

    ``life_lock`` serializes every spawn decision (operator ``start``,
    supervisor ``restart``, and owner code that must see a stable
    aliveness — the decoder's ``fail_pending`` mutates worker-owned
    state only while provably dead).
    """

    def __init__(self, run, name, on_death=None, label=None):
        self._run_loop = run
        self.name = name
        # short logical name for lifecycle records/spans ("batcher",
        # "decoder") — matches the supervisor's target names so a
        # death and the restart that answers it correlate under one key
        self.label = label if label is not None else name
        self._on_death = on_death
        self._stop = False
        self.started = False
        self.deaths = 0
        self.life_lock = threading.Lock()
        self._thread = self._new_thread()

    def _new_thread(self):
        return threading.Thread(target=self._run, name=self.name,
                                daemon=True)

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        """Start the worker; on an already-ran-and-died worker this
        re-arms via the restart path (Thread objects are single-use)
        instead of raising.  No-op while alive or stopping."""
        with self.life_lock:
            if self._thread.is_alive() or self._stop:
                return self
            if self.started:
                self._restart_locked(supervised=False)
                return self
            self.started = True
            self._thread.start()
        emit_lifecycle("start", self.label)
        return self

    def restart(self, supervised=True):
        """Re-arm a DEAD worker with a fresh thread (owner state carries
        over).  Returns False (no-op) while stopping or still alive.
        ``supervised=True`` (the watchdog path) counts the restart on
        ``serving.worker_restarts``."""
        with self.life_lock:
            return self._restart_locked(supervised=supervised)

    def _restart_locked(self, supervised=True):
        if self._stop or self._thread.is_alive():
            return False
        self._thread = self._new_thread()
        self._thread.start()
        if not supervised:
            # an operator start() revival is a lifecycle event but not a
            # supervisor restart; the supervisor emits its own record
            # (with its restart budget) for the supervised path
            emit_lifecycle("restart", self.label, supervised=False)
        return True

    @property
    def alive(self):
        return self._thread.is_alive()

    @property
    def stopping(self):
        return self._stop

    def request_stop(self):
        """Mark the worker stopping: blocks future restarts (a stop must
        win over a concurrent supervisor tick) and lets the serve loop
        observe it via :attr:`stopping`."""
        self._stop = True

    def join(self, timeout=None):
        if self._thread.is_alive():
            self._thread.join(timeout)
        return not self._thread.is_alive()

    # -- the death choke point ----------------------------------------------
    def _run(self):
        try:
            self._run_loop()
        except BaseException:  # noqa: BLE001 — silent-but-observable death
            # The worker is dying (chaos kill_worker, interpreter
            # teardown, or a genuinely unexpected escape).  Count it,
            # give the owner its one cleanup shot (fail the in-flight
            # batch — those requests are in neither the queue nor a
            # terminal state), report, and let the thread end: the
            # supervisor restarts it or fails pending requests fast.
            _worker_deaths.inc()
            self.deaths += 1
            if self._on_death is not None:
                try:
                    self._on_death()
                except Exception:
                    pass   # cleanup must not mask the death itself
            emit_lifecycle("death", self.label)
