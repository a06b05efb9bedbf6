"""Reader decorators (same surface as the reference's
python/paddle/reader/decorator.py, rebuilt on stdlib iterator tooling and
``concurrent.futures`` rather than hand-rolled worker/queue chains).

The port's copy of ``paddle_tpu/reader/decorator.py``: pure Python and
numpy, with ``retry_reader`` on the port's ``resilience`` module.

A *reader creator* is a zero-arg callable returning an iterator of samples.
Every decorator here takes creator(s) and returns a new creator, so they
compose: ``shuffle(batch(mnist.train(), 32), 500)``.
"""
from __future__ import annotations

import itertools
import random
import threading
import queue as _queue
from collections import deque
from concurrent.futures import ThreadPoolExecutor

__all__ = [
    "map_readers",
    "buffered",
    "compose",
    "chain",
    "shuffle",
    "firstn",
    "xmap_readers",
    "multiprocess_reader",
    "cache",
    "retry_reader",
]

_STOP = object()  # queue sentinel shared by the threaded decorators


class _Failure:
    """Carries a producer-side exception across the queue so consumers
    re-raise instead of hanging on a sentinel that never arrives."""

    def __init__(self, exc):
        self.exc = exc


def cache(reader):
    """Materialize the reader's samples on first traversal; replay after."""
    memo = []
    done = threading.Event()

    def cached():
        if not done.is_set():
            memo.extend(reader())
            done.set()
        return iter(memo)

    return cached


def map_readers(func, *readers):
    """Zip several readers and map ``func`` over the aligned samples."""

    def mapped():
        return itertools.starmap(func, zip(*(r() for r in readers)))

    return mapped


def shuffle(reader, buf_size):
    """Shuffle within a sliding window of ``buf_size`` samples.
    ``buf_size <= 1`` (including 0/negative) degenerates to pass-through."""

    def shuffled():
        it = reader()
        while True:
            window = list(itertools.islice(it, max(buf_size, 1)))
            if not window:
                return
            random.shuffle(window)
            yield from window

    return shuffled


def chain(*readers):
    """Concatenate readers end to end."""

    def chained():
        return itertools.chain.from_iterable(r() for r in readers)

    return chained


class ComposeNotAligned(ValueError):
    pass


def compose(*readers, **kwargs):
    """Run readers in lockstep and splice each row into one flat tuple."""
    check_alignment = kwargs.pop("check_alignment", True)

    def flatten(row):
        out = []
        for item in row:
            if item is None and check_alignment:
                raise ComposeNotAligned("outputs of readers are not aligned")
            out.extend(item if isinstance(item, tuple) else (item,))
        return tuple(out)

    def composed():
        zipper = itertools.zip_longest if check_alignment else zip
        return map(flatten, zipper(*(r() for r in readers)))

    return composed


def _cancellable_put(q, item, stop):
    """``q.put`` that a consumer-side ``stop`` event can abandon: the
    producer never wedges forever on a bounded queue whose consumer has
    walked away.  Returns False when the put was cancelled."""
    if stop is None:
        q.put(item)
        return True
    while not stop.is_set():
        try:
            q.put(item, timeout=0.05)
            return True
        except _queue.Full:
            continue
    return False


def _pump(iterator, q, stop=None):
    """Drain an iterator into a queue, then post the stop sentinel.  A
    producer-side exception is shipped as a _Failure so the consumer
    re-raises it instead of waiting forever.  ``stop`` cancels both the
    drain and any blocked put; the source iterator is always closed, so
    an abandoned pipeline releases the underlying reader (open files,
    sockets, nested producer threads) instead of leaking it."""
    try:
        try:
            for item in iterator:
                if not _cancellable_put(q, item, stop):
                    return
                if stop is not None and stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 — forwarded, not swallowed
            _cancellable_put(q, _Failure(e), stop)
        else:
            _cancellable_put(q, _STOP, stop)
    finally:
        close = getattr(iterator, "close", None)
        if close is not None:
            try:
                close()
            except Exception:
                pass


def _shutdown_pump(q, threads, stop, timeout=5.0):
    """Consumer-side teardown shared by every threaded decorator (and the
    device prefetcher): flag the stop event, then drain the queue until
    every producer thread exits — a producer blocked mid-``put`` is
    unblocked by the drain and sees the flag on its next attempt.  Bounded
    by ``timeout`` so a source wedged in un-interruptible IO degrades to
    the old leak instead of hanging the consumer."""
    import time

    stop.set()
    deadline = time.monotonic() + timeout
    threads = [t for t in threads if t.is_alive()]
    while threads and time.monotonic() < deadline:
        try:
            while True:
                q.get_nowait()
        except _queue.Empty:
            pass
        for t in threads:
            t.join(timeout=0.02)
        threads = [t for t in threads if t.is_alive()]
    return not threads


def buffered(reader, size):
    """Prefetch up to ``size`` samples on a background thread.

    The producer thread is shut down (and the underlying reader closed)
    when the consumer abandons the generator — break, exception, or
    GeneratorExit — not just at EOF, so no pump thread is ever left
    blocked on a full queue."""

    def prefetching():
        q = _queue.Queue(maxsize=size)
        stop = threading.Event()
        t = threading.Thread(target=_pump, args=(reader(), q, stop),
                             name="paddle-tpu-buffered-pump", daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _STOP:
                    return
                if isinstance(item, _Failure):
                    raise item.exc
                yield item
        finally:
            _shutdown_pump(q, [t], stop)

    return prefetching


def retry_reader(reader, max_retries=3, policy=None):
    """Recover from intermittent reader exceptions without duplicating or
    dropping samples.

    On a retryable error (``policy.classify``, default: transient IO or
    CUDA per ``paddle_tpu_torch.resilience``), the underlying reader is
    re-created and fast-forwarded past the samples already delivered, so the
    consumer's stream resumes at the exact sample where the failure hit.
    ``max_retries`` bounds CONSECUTIVE failures — any successfully
    delivered sample resets the budget; non-retryable errors propagate
    immediately.  Requires a reader whose traversal order is deterministic
    across re-creations (file/recordio/np_array readers are; put
    ``shuffle`` OUTSIDE the retry if its order must differ per pass).
    """
    from .. import resilience as _resilience

    pol = policy or _resilience.RetryPolicy(max_retries=max_retries)

    def resilient():
        delivered = 0
        schedule = pol.delays()
        while True:
            try:
                for sample in itertools.islice(reader(), delivered, None):
                    yield sample
                    delivered += 1
                    schedule = None  # a delivered sample resets the budget
                return
            except BaseException as exc:
                if not pol.classify(exc):
                    raise
                if schedule is None:
                    schedule = pol.delays()
                try:
                    delay = next(schedule)
                except StopIteration:
                    raise exc from None
                pol.sleep(delay)

    return resilient


def firstn(reader, n):
    """Truncate the reader to its first ``n`` samples."""

    def truncated():
        return itertools.islice(reader(), n)

    return truncated


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Map ``mapper`` over the reader on ``process_num`` threads, keeping at
    most ``buffer_size`` samples in flight.

    Same contract as the reference's xmap (decorator.py:283) with a
    different engine: a ThreadPoolExecutor and a bounded window of futures.
    ``order=True`` yields in submission order (the window is a FIFO of
    futures, so ordering costs nothing but head-of-line wait);
    ``order=False`` yields each sample as soon as its future completes
    (done-callbacks feed a result queue: O(1) per sample at any window).
    A mapper exception propagates to the consumer.  If the consumer
    abandons the generator early, the pool is shut down without waiting
    for (and cancelling) the in-flight window.
    """
    cap = max(buffer_size, 1)

    def xmapped():
        pool = ThreadPoolExecutor(max_workers=process_num)
        graceful = False
        try:
            if order:
                window = deque()
                for sample in reader():
                    window.append(pool.submit(mapper, sample))
                    # yield finished heads; block only when the window is full
                    while window and (len(window) >= cap or window[0].done()):
                        yield window.popleft().result()
                while window:
                    yield window.popleft().result()
            else:
                done_q = _queue.Queue()
                in_flight = 0
                for sample in reader():
                    fut = pool.submit(mapper, sample)
                    fut.add_done_callback(done_q.put)
                    in_flight += 1
                    while in_flight and (in_flight >= cap or not done_q.empty()):
                        yield done_q.get().result()
                        in_flight -= 1
                while in_flight:
                    yield done_q.get().result()
                    in_flight -= 1
            graceful = True
        finally:
            pool.shutdown(wait=graceful, cancel_futures=not graceful)

    return xmapped


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Interleave several readers, each drained on its own thread.

    Thread-backed on purpose: fork+pipes don't mix with a live CUDA
    context, and overlapping the host-side pipeline with device compute
    is what actually matters.  ``use_pipe`` is accepted for API parity.
    """
    if not readers:
        raise ValueError("multiprocess_reader needs at least one reader")

    def interleaved():
        q = _queue.Queue(maxsize=queue_size)
        stop = threading.Event()
        threads = []
        for r in readers:
            t = threading.Thread(target=_pump, args=(r(), q, stop),
                                 name="paddle-tpu-interleave-pump",
                                 daemon=True)
            t.start()
            threads.append(t)
        try:
            live = len(readers)
            while live:
                item = q.get()
                if item is _STOP:
                    live -= 1
                elif isinstance(item, _Failure):
                    raise item.exc
                else:
                    yield item
        finally:
            _shutdown_pump(q, threads, stop)

    return interleaved
