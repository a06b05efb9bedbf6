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

The training runtime's faults: a checkpoint write killed at an exact
byte (``torn_write``), NaN feeds on chosen ``Executor.run`` dispatches
(``nan_feeds``, through ``resilience._feed_fault``) and a reader that
raises at a chosen sample (``flaky_reader``)::

    with faults.torn_write("checkpoint_9", at_byte=64):
        save_checkpoint(...)                 # staging dir torn, raises

    with faults.nan_feeds(at_steps=[3, 4]):
        trainer.train(..., nan_guard=2)      # two bad steps -> rewind

No global monkeypatching: only code routed through the resilience
primitives sees the faults, and exiting the context always restores the
hooks.  The serving managers COMPOSE (flaky + poison nested is the
standard chaos scenario).  The decode scheduler consults the same choke
point before its legacy prefill, each prefill chunk and each decode
step, so ``flaky_execute`` at a decode dispatch fails the active
sequences typed (the port never retries a step that writes KV in
place), and :func:`corrupt_kv_page` writes NaN into a page a decoding
sequence owns (on the owning worker thread, before the dispatch), which
the opt-in ``kv_guard`` sweep must catch.  :func:`kill_replica_mid_decode`
kills one replica pool decode worker while it holds sequences in flight,
and :func:`kill_session_owner` kills the replica that holds a parked
conversation's pinned pages, mid-decode of its next turn::

    with faults.kill_session_owner(pool, "user-42", min_tokens=2):
        pool.generate(history, session="user-42")   # replayed on a sibling
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from .. import resilience

__all__ = [
    "FaultInjected",
    "WorkerKilled",
    "torn_write",
    "flaky_io",
    "nan_feeds",
    "flaky_reader",
    "flaky_execute",
    "slow_execute",
    "poison_request",
    "kill_worker",
    "kill_replica_mid_decode",
    "kill_session_owner",
    "corrupt_kv_page",
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
def torn_write(match, at_byte):
    """Kill the next write to a path containing ``match`` after exactly
    ``at_byte`` bytes have hit the file — simulating a preemption mid
    checkpoint write.  The partial bytes ARE written (and flushed), so the
    torn file is really on disk; the write then raises FaultInjected.
    Every subsequent matching write in the context is killed the same way
    (a retry of the same doomed write also dies, like a dying host)."""
    if resilience._write_fault is not None:
        raise RuntimeError("a torn_write fault is already installed")
    cut = int(at_byte)

    def hook(path, data, fileobj):
        if not _match(path, match):
            return False
        fileobj.write(data[:cut])
        fileobj.flush()
        raise FaultInjected(
            "injected torn write: %r killed at byte %d of %d"
            % (path, min(cut, len(data)), len(data)))

    resilience._write_fault = hook
    try:
        yield
    finally:
        resilience._write_fault = None


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


def _nan_like(val):
    """``val`` (a tensor or an array) with every float element NaN; other
    dtypes pass through."""
    if isinstance(val, torch.Tensor):
        if val.is_floating_point():
            return torch.full_like(val, float("nan"))
        return val
    arr = np.asarray(val)
    if np.issubdtype(arr.dtype, np.floating):
        return np.full_like(arr, np.nan)
    return arr


@contextlib.contextmanager
def nan_feeds(at_steps=(0,)):
    """Poison every float feed with NaN on the given ``Executor.run``
    dispatches (0-based, counted from context entry).  The NaN flows
    through the real step — loss and gradients go non-finite on the
    device — which is exactly what the nan_guard must catch.  Yields a
    one-item list with the dispatch count so far."""
    if resilience._feed_fault is not None:
        raise RuntimeError("a nan_feeds fault is already installed")
    steps = frozenset(int(s) for s in at_steps)
    count = [0]

    def hook(feeds):
        idx = count[0]
        count[0] += 1
        if idx not in steps:
            return feeds
        return {name: _nan_like(val) for name, val in feeds.items()}

    resilience._feed_fault = hook
    try:
        yield count
    finally:
        resilience._feed_fault = None


def flaky_reader(reader, fail_at, times=1, exc_factory=None):
    """Wrap a reader creator so iteration raises just before yielding the
    sample at absolute index ``fail_at`` — on the first ``times``
    traversals only.  The deterministic partner of
    ``reader.retry_reader``: recovery must resume at the exact sample
    where the failure hit, with no duplicates and no drops."""
    remaining = [int(times)]
    make_exc = exc_factory or (
        lambda i: FaultInjected("injected reader error at sample %d" % i))

    def faulty():
        for i, sample in enumerate(reader()):
            if i == fail_at and remaining[0] > 0:
                remaining[0] -= 1
                raise make_exc(i)
            yield sample

    return faulty


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


@contextlib.contextmanager
def kill_replica_mid_decode(index, min_tokens=1):
    """KILL one replica pool's DECODE worker mid-generation: the hook
    fires only on the thread named ``decode-replica<index>`` (each
    :class:`~..serving.replica_pool.ReplicaPool` decode worker carries
    that name), and only once some request in the dispatch has accepted
    ``min_tokens`` tokens, so the dying replica holds real in-flight KV:
    the state the pool's harvest-and-replay must recover on a sibling.
    Raises :class:`WorkerKilled` once; sibling replicas never see it
    fire.  Yields a one-item list with the kill count."""
    import threading

    name = "decode-replica%d" % int(index)
    need = int(min_tokens)
    fired = [0]

    def hook(requests):
        if fired[0] or threading.current_thread().name != name:
            return
        if not any(len(r.journal.accepted) >= need
                   for r in requests if hasattr(r, "journal")):
            return
        fired[0] += 1
        raise WorkerKilled("injected replica kill mid-decode (%s)" % name)

    with _serve_fault_installed(hook):
        yield fired


@contextlib.contextmanager
def kill_session_owner(pool, session, min_tokens=1):
    """KILL the replica that OWNS a parked conversation, mid-decode of
    its next turn: the session's sticky replica is read from the pool's
    :class:`~..serving.sessions.SessionStore` (without touching its LRU
    place) and :func:`kill_replica_mid_decode` armed on exactly that
    replica.  The dead owner's pinned pages go with it; the turn still
    completes bitwise on a sibling, because its prompt carries the whole
    history and the journal replays ``prompt + accepted``.  Raises
    ``LookupError`` when the session is not parked.  Yields the one-item
    kill-count list."""
    store = pool.sessions
    rec = None if store is None else store.get(session, touch=False)
    if rec is None:
        raise LookupError("session %r is not parked on this pool"
                          % (session,))
    with kill_replica_mid_decode(rec.replica,
                                 min_tokens=min_tokens) as fired:
        yield fired


@contextlib.contextmanager
def corrupt_kv_page(scheduler, seq=None, after_tokens=1):
    """Write NaN into a KV page OWNED by a decoding sequence on
    ``scheduler`` — the poison the opt-in ``DecodeConfig(kv_guard=True)``
    sweep exists to catch: the guard must fail exactly the owning
    sequence typed (:class:`~..serving.errors.KVCorruption`) and scrub
    the page, leaving co-resident and prefix-sharing sequences intact.
    The write lands IN PLACE (the tensors a captured step reads) on the
    scheduler's own worker thread, before a dispatch (the serve-fault
    choke point), at row 0 of the tail page the next decode step appends
    to — a privately held page, never a shared prefix page.  ``seq``
    targets one request's sequence (default: the first slot decoding
    with ``after_tokens`` accepted).  Fires once; yields a one-item list
    with the corruption count."""
    import threading

    fired = [0]
    need = int(after_tokens)

    def hook(requests):
        if fired[0] \
                or threading.current_thread().name != scheduler._worker.name:
            return
        ps = scheduler.config.page_size
        for slot in scheduler._slots:
            if slot is None or slot.prefilling:
                continue
            if seq is not None and slot.req.seq != seq:
                continue
            if len(slot.generated) < need:
                continue
            page = int(slot.pages[slot.kv_len // ps])
            if page == 0:
                continue
            with torch.no_grad():
                scheduler._cache.k_pool[:, page, 0, 0, 0] = float("nan")
            fired[0] += 1
            return

    with _serve_fault_installed(hook):
        yield fired
