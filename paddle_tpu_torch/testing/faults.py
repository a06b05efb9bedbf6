"""Deterministic fault injection for model loads and serving dispatch.

Counterpart of ``paddle_tpu/testing/faults.py``, ported for what the
port's io and predict serving route through ``paddle_tpu_torch.
resilience``: model and parameter file reads and writes (``flaky_io``)
and the serving dispatch choke point (``resilience._serve_fault``,
consulted by the engine's batch execute per attempt, with the exact
request list)::

    with faults.flaky_io("__model__", times=2, op="read"):
        engine = serving.InferenceEngine(model_dir)   # 2 faults; retried

    with faults.flaky_execute(times=2):
        engine.predict(...)                  # 2 transient faults; retried

    with faults.poison_request(bad.seq):
        ...                                  # any batch with `bad` dies
                                             # fatally -> bisected

    with faults.slow_execute(0.05):
        ...                                  # every dispatch +50ms

    with faults.kill_worker():
        ...                                  # next dispatch KILLS the
                                             # worker thread (supervisor!)

No global monkeypatching: only code routed through the resilience
primitives sees the faults, and exiting the context always restores the
hooks.  The serving managers COMPOSE (flaky + poison nested is the
standard chaos scenario).  Torn writes, NaN feeds, flaky readers and the
decode-runtime hooks wait for the training and decode runtimes' ports.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np

from .. import resilience

__all__ = [
    "FaultInjected",
    "WorkerKilled",
    "flaky_io",
    "flaky_execute",
    "slow_execute",
    "poison_request",
    "kill_worker",
]


class FaultInjected(IOError):
    """Raised by injected faults; an OSError subclass so the default
    transient classifier treats it exactly like a real flaky-FS error."""


class WorkerKilled(BaseException):
    """Raised by :func:`kill_worker` — deliberately a ``BaseException``
    so the serving worker's fault handling (which survives every
    ``Exception``) cannot catch it: the worker THREAD dies, which is the
    failure mode the engine's supervisor exists to detect."""


def _match(path, substr):
    return substr in str(path)


@contextlib.contextmanager
def flaky_io(match, times=1, op=None, exc_factory=None):
    """Fail the first ``times`` resilience-routed IO operations touching a
    path that contains ``match`` (both reads and writes unless ``op`` is
    "read"/"write"), then let everything succeed — the transient-FS-error
    shape that retry policies exist for.  Yields a one-item list holding
    the number of faults fired so far."""
    if resilience._io_fault is not None:
        raise RuntimeError("a flaky_io fault is already installed")
    remaining = [int(times)]
    fired = [0]
    make_exc = exc_factory or (
        lambda path, o: FaultInjected("injected %s error on %r" % (o, path)))

    def hook(path, o):
        if op is not None and o != op:
            return
        if not _match(path, match) or remaining[0] <= 0:
            return
        remaining[0] -= 1
        fired[0] += 1
        raise make_exc(path, o)

    resilience._io_fault = hook
    try:
        yield fired
    finally:
        resilience._io_fault = None


# ---------------------------------------------------------------------------
# serving-dispatch chaos (resilience._serve_fault)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _serve_fault_installed(hook):
    """Install ``hook`` on the serving-dispatch choke point, CHAINED
    after any already-installed hook (both run; the first to raise
    wins) — so flaky + slow + poison compose into one chaos scenario.
    Exit restores exactly the previous hook."""
    prev = resilience._serve_fault
    if prev is None:
        combined = hook
    else:
        def combined(requests):
            prev(requests)
            hook(requests)
    resilience._serve_fault = combined
    try:
        yield
    finally:
        resilience._serve_fault = prev


@contextlib.contextmanager
def flaky_execute(times=1, exc_factory=None, match=None):
    """Fail the first ``times`` serving dispatch attempts (every attempt
    when ``times`` is None) with a TRANSIENT error (:class:`FaultInjected`
    by default — an OSError, so the serving retry policy classifies it
    retryable), optionally only for dispatches where ``match(requests)``
    is true.  Retries and bisected sub-batches count as fresh attempts,
    exactly like a real flaky device runtime.  Yields a one-item list
    holding the number of faults fired so far."""
    remaining = [None if times is None else int(times)]
    fired = [0]
    make_exc = exc_factory or (lambda requests: FaultInjected(
        "injected transient execute fault (%d requests)" % len(requests)))

    def hook(requests):
        if match is not None and not match(requests):
            return
        if remaining[0] is not None:
            if remaining[0] <= 0:
                return
            remaining[0] -= 1
        fired[0] += 1
        raise make_exc(requests)

    with _serve_fault_installed(hook):
        yield fired


@contextlib.contextmanager
def slow_execute(delay_s, times=None, match=None):
    """Add ``delay_s`` seconds to every serving dispatch (the first
    ``times`` when given) — the deterministic way to shrink an engine's
    service rate so open-loop load tests overload it on any machine.
    Yields a one-item list with the number of slowed dispatches."""
    remaining = [None if times is None else int(times)]
    fired = [0]
    delay = float(delay_s)

    def hook(requests):
        if match is not None and not match(requests):
            return
        if remaining[0] is not None:
            if remaining[0] <= 0:
                return
            remaining[0] -= 1
        fired[0] += 1
        time.sleep(delay)

    with _serve_fault_installed(hook):
        yield fired


@contextlib.contextmanager
def poison_request(is_poison, exc_factory=None):
    """Make specific request(s) POISON: every dispatch attempt whose
    batch contains a matching request fails FATALLY (``ValueError`` by
    default — not transient, so retries don't help and the engine must
    bisect to save the co-batched innocents).  ``is_poison`` is a
    ``seq`` int, an iterable of seqs, or a callable ``(request) ->
    bool``.  Yields a one-item list with the number of poisoned
    dispatches."""
    if callable(is_poison):
        matches = is_poison
    else:
        seqs = (frozenset([int(is_poison)]) if np.isscalar(is_poison)
                else frozenset(int(s) for s in is_poison))
        matches = lambda r: r.seq in seqs  # noqa: E731
    fired = [0]
    make_exc = exc_factory or (lambda bad: ValueError(
        "injected poison request (seq %s)"
        % ", ".join(str(r.seq) for r in bad)))

    def hook(requests):
        bad = [r for r in requests if matches(r)]
        if bad:
            fired[0] += 1
            raise make_exc(bad)

    with _serve_fault_installed(hook):
        yield fired


@contextlib.contextmanager
def kill_worker(at_dispatch=0):
    """KILL the serving worker thread at the ``at_dispatch``-th dispatch
    attempt (0-based, counted from context entry) by raising
    :class:`WorkerKilled` — a ``BaseException`` nothing in the dispatch
    path catches.  The thread dies silently (no stderr traceback; the
    death lands on ``serving.worker_deaths``) and admitted requests
    would hang forever — which is exactly what the engine's supervisor
    must detect and repair.  Yields a one-item list with the dispatch
    count so far."""
    count = [0]
    target = int(at_dispatch)

    def hook(requests):
        idx = count[0]
        count[0] += 1
        if idx == target:
            raise WorkerKilled(
                "injected worker kill at dispatch %d" % idx)

    with _serve_fault_installed(hook):
        yield count
