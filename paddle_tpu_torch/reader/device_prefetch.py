"""Asynchronous device-feed pipeline: overlap host->device transfer with
compute.

The port's copy of ``paddle_tpu/reader/device_prefetch.py``.  The
reference Fluid kept the accelerator fed with ``py_reader`` /
double-buffered ``data_feeder`` queues; here a background thread runs
DataFeeder's conversion AND the transfer into a bounded double/triple
buffer, so batch N+1 is converting and transferring while the step for
batch N runs on the card.  The executor then takes the feeds as tensors
already on its device: no host copy on the step loop (its bound replay
copies them into the graph's static buffers on the device).

The transfer (the JAX package's ``jax.device_put``) is, for each feed:

1. a cast to the declared dtype on the host, off the critical path;
2. a copy into a pinned host tensor (PyTorch's caching host allocator);
3. a ``non_blocking`` copy to the executor's device on the pipeline's
   own side stream, leased from the port's set (``streams.py``);
4. one ``torch.cuda.Event`` recorded on that stream after the batch's
   last copy.

The consumer's ``__next__`` makes its current stream wait on that event
and calls ``record_stream`` on each tensor, so the step never reads a
batch still in flight and the caching allocator never hands a feed's
memory to the next transfer while a step may still read it.  On the
CPU the place step is a plain ``torch.as_tensor(...).to(device)``.

Shutdown discipline is shared with ``reader.decorator``: abandoning the
generator (break / exception / GeneratorExit) cancels the producer
thread(s), drains the buffer, and closes the source reader — no pump
thread is ever left blocked on a full queue (see
``decorator._shutdown_pump``).

The pipeline only converts and transfers feeds — parameters never flow
through it — so nan_guard's rewind, ``retry_reader`` resume, and
FailureMonitor's checkpoint-then-stop all stay correct with batches in
flight.

Usage::

    feeder = fluid.DataFeeder(feed_list=[x, y], place=place)
    batches = fluid.reader.device_prefetch.decorate_device_feed(
        train_reader, feeder, exe, main_program)
    for feed in batches():            # feed values are tensors on the card
        exe.run(main_program, feed=feed, fetch_list=[loss])

``Trainer.train``/``Trainer.test`` route readers through this
automatically (opt out per call with ``prefetch=False``).
``shard_feed_list`` places ``ParallelExecutor.run``'s per-rank feed
lists: each entry on its rank's device, with no host concatenation.
"""
from __future__ import annotations

import queue as _queue
import threading
import time
import weakref

import numpy as np
import torch

from .. import observability as _obs
from .. import streams as _streams
from ..core import resolve_device, torch_dtype
from .decorator import _STOP, _Failure, _cancellable_put, _shutdown_pump

__all__ = [
    "DevicePrefetcher",
    "decorate_device_feed",
    "device_feed_reader",
    "put_feed_on_device",
    "shard_feed_list",
    "prefetch_enabled_default",
    "transfer_count",
]


# host->device feed transfers issued by this module: a telemetry-registry
# counter (its internal lock covers transfer_threads > 1), the same cell
# the trainer's step records report as ``prefetch_transfers``
_transfers = _obs.counter("prefetch.transfer")

# input-boundedness signals: how many ready batches sat in the buffer when
# the consumer arrived (0 = the step loop is about to starve) and the
# buffer's capacity to normalize against.  Last-created prefetcher wins
# the capacity gauge — one live feed pipeline per loop is the norm.
_occupancy = _obs.gauge("prefetch.buffer_occupancy")
_capacity = _obs.gauge("prefetch.buffer_capacity")


def transfer_count():
    """Total feed transfers this module has issued — the zero-copy
    contract's instrument (a training loop fed by the prefetcher must
    transfer each batch exactly once).  A view of the
    ``prefetch.transfer`` telemetry counter."""
    return _transfers.value


def prefetch_enabled_default():
    """Trainer's default for routing readers through the pipeline: on.
    A caller opts out per call with ``prefetch=False``."""
    return True


class _Staged:
    """One transferred feed dict and the event its transfers end at (None
    on the CPU).  ``handoff()`` hands it to the consuming stream."""

    __slots__ = ("feed", "event")

    def __init__(self, feed, event):
        self.feed = feed
        self.event = event

    def handoff(self):
        """The feed dict, made safe for the calling thread's current
        stream: it waits for the transfers, and each transferred tensor
        is marked as used on it (``record_stream``)."""
        if self.event is not None:
            tensors = [v for v in self.feed.values()
                       if isinstance(v, torch.Tensor) and v.is_cuda]
            if tensors:
                current = torch.cuda.current_stream(tensors[0].device)
                current.wait_event(self.event)
                for t in tensors:
                    t.record_stream(current)
        return self.feed


def _host_value(val):
    """``val`` as a host tensor when it is host data (a numpy array or
    scalar, a CPU tensor), else None (a CUDA tensor, a LoDArray, ...)."""
    if isinstance(val, torch.Tensor):
        return val if val.device.type == "cpu" else None
    if isinstance(val, (np.ndarray, np.generic)):
        arr = np.asarray(val)
        if not arr.flags.writeable:  # torch wraps only writable arrays
            arr = arr.copy()
        return torch.as_tensor(arr)
    return None


def _declared_dtype(block, name):
    if not block.has_var(name):
        return None
    want = block.var(name).dtype
    return torch_dtype(want) if want is not None else None


def _place_feed(feed, device, program, stream):
    """One host feed dict -> a :class:`_Staged` of tensors on ``device``.
    Non-host entries (LoDArray, tensors already on a card) pass through
    untouched — the executor's slow path owns their conversion.  On a
    card each host value is cast on the host, staged in pinned memory
    and copied on ``stream``; one event marks the end of the batch."""
    block = program.global_block()
    cuda = device.type == "cuda"
    out = {}
    moved = False
    for name, val in feed.items():
        host = _host_value(val)
        if host is None:
            out[name] = val
            continue
        want = _declared_dtype(block, name)
        if want is not None and host.dtype != want:
            # cast on the host while OFF the critical path, so the bound
            # feed plan sees the final dtype and the step-loop cast
            # disappears
            host = host.to(want)
        _transfers.inc()
        with _obs.span("prefetch.device_put"):
            if cuda:
                pinned = torch.empty(host.shape, dtype=host.dtype,
                                     pin_memory=True)
                pinned.copy_(host)
                with torch.cuda.stream(stream):
                    out[name] = pinned.to(device, non_blocking=True)
                moved = True
            else:
                out[name] = host.to(device)
    event = None
    if moved:
        event = torch.cuda.Event()
        event.record(stream)
    return _Staged(out, event)


def _executor_device(executor):
    return resolve_device(None) if executor is None else executor.device


def put_feed_on_device(feed, executor, program=None):
    """Convert one feed dict's host arrays into tensors on ``executor``'s
    device (its declared dtypes).  The one-shot form of the pipeline
    below — the same transfer, handed to the calling thread's stream, no
    background thread."""
    from ..framework import default_main_program

    program = program or default_main_program()
    device = _executor_device(executor)
    if device.type != "cuda":
        return _place_feed(feed, device, program, None).handoff()
    # a transfer stream of the port's lease for the one transfer: the
    # calling stream waits on its event before the stream goes back
    lease = _streams.Lease("put_feed_on_device")
    try:
        stream = lease.stream(_streams.device_index(device))
        return _place_feed(feed, device, program, stream).handoff()
    finally:
        lease.release()


def shard_feed_list(feed_list, mesh, data_names, program=None):
    """Per-rank feed dicts -> ONE global feed dict, with no full-batch
    concatenation on the host.

    Each declared data var whose entries are host arrays of one shape and
    dtype is cast to its declared dtype and copied, entry by entry, to
    the device where its rows belong (one transfer an entry, counted by
    ``transfer_count``):
    - on a 1-D ``("dp",)`` mesh of ``len(feed_list)`` ranks, entry ``i``
      onto rank ``i``'s device, the global batch a ``ShardedTensor``
      split on its rows over dp (the JAX package stitches its global
      array from the same shards);
    - on a one-rank mesh, each entry into its rows of one batch on that
      rank's device.
    Everything else (non-data vars, ragged or mixed entries, another
    mesh, no mesh) concatenates on the host, and a single-entry list keeps
    the caller's value."""
    from ..parallel.sharded import ShardedTensor

    per_key = {}
    for d in feed_list:
        for k, v in d.items():
            per_key.setdefault(k, []).append(v)
    one = mesh is not None and mesh.size == 1
    split = (mesh is not None and mesh.devices.ndim == 1
             and mesh.axis_names[0] == "dp" and mesh.size == len(feed_list)
             and mesh.size > 1)
    block = program.global_block() if program is not None else None
    out = {}
    for k, vals in per_key.items():
        shapes = {tuple(np.shape(v)) for v in vals}
        hosts = [_host_value(v) for v in vals]
        if ((one or split) and k in data_names and len(vals) > 1
                and len(shapes) == 1 and np.ndim(vals[0]) >= 1
                and all(isinstance(v, (np.ndarray, np.generic)) for v in vals)
                and len({h.dtype for h in hosts}) == 1):
            want = _declared_dtype(block, k) if block is not None else None
            want = want or hosts[0].dtype
            n = hosts[0].shape[0]
            rest = tuple(hosts[0].shape[1:])
            if split:
                parts = {}
                for i, h in enumerate(hosts):
                    _transfers.inc()
                    parts[(i,) + (0,) * len(rest)] = h.to(
                        device=mesh.device(i), dtype=want)
                out[k] = ShardedTensor(mesh, ("dp",), parts,
                                       (len(hosts) * n,) + rest)
                continue
            batch = torch.empty((len(hosts) * n,) + rest, dtype=want,
                                device=mesh.device(0))
            for i, h in enumerate(hosts):
                _transfers.inc()
                batch[i * n:(i + 1) * n].copy_(h.to(want))
            out[k] = batch
        elif len(vals) == 1:
            out[k] = vals[0]  # nothing to merge: keep the caller's array
        else:
            out[k] = np.concatenate([np.asarray(v) for v in vals], axis=0)
    return out


def _feed_pump(source, transform, src_lock, q, stop):
    """Worker loop shared by a DevicePrefetcher's transfer thread(s):
    pull the next item from the (lock-serialized) source, transform it —
    conversion + transfer, unlocked, so transfers pipeline — and post
    it.  Module-level on purpose: it must not close over the prefetcher
    instance (see DevicePrefetcher.__init__)."""
    try:
        while not stop.is_set():
            try:
                with src_lock:
                    item = next(source)
            except StopIteration:
                break
            if transform is not None:
                # the span makes conversion+transfer visible per batch on
                # the producer thread's trace track
                with _obs.span("prefetch.convert_transfer"):
                    item = transform(item)
            if not _cancellable_put(q, item, stop):
                return
    except BaseException as e:  # noqa: BLE001 — forwarded, not swallowed
        _cancellable_put(q, _Failure(e), stop)
        return
    _cancellable_put(q, _STOP, stop)


class DevicePrefetcher:
    """Bounded async queue of on-device feed dicts.

    ``source`` is an iterator (typically ``reader()``); ``transform`` maps
    each item to the queued value — for the standard pipeline that is
    DataFeeder conversion + the transfer — and runs on the background
    thread(s), off the step loop's critical path.  A transferred feed is
    handed to the consumer's current stream as it is taken
    (:meth:`_Staged.handoff`).

    ``buffer_size`` bounds device memory held by in-flight batches
    (2 = double buffer, 3 = triple).  ``transfer_threads > 1`` pipelines
    several transfers concurrently at the cost of DELIVERY ORDER:
    multi-threaded delivery is whichever transfer finishes first, so keep
    the default of 1 for training loops that need determinism.

    Iterate it, or use :func:`decorate_device_feed` for the
    reader-creator form.  ``close()`` (also called on exhaustion and by
    the creator's ``finally``) cancels the producers, drains the queue,
    and closes the source iterator via the shared
    ``decorator._shutdown_pump`` path.
    """

    def __init__(self, source, transform=None, buffer_size=2,
                 transfer_threads=1):
        self._source = source
        self._q = _queue.Queue(maxsize=max(int(buffer_size), 1))
        _capacity.set(self._q.maxsize)
        self._stop = threading.Event()
        self._live = max(int(transfer_threads), 1)
        self._closed = False
        # the workers must NOT hold a reference to self (a bound-method
        # target would pin the instance alive for as long as the thread
        # runs, so an abandoned-without-close() prefetcher could never be
        # collected); they get the shared pieces directly, and a GC
        # finalizer then covers the no-close() path — stop, drain, join,
        # exactly the teardown close() performs
        src_lock = threading.Lock()
        self._threads = [
            threading.Thread(
                target=_feed_pump,
                args=(source, transform, src_lock, self._q, self._stop),
                name="paddle-tpu-device-prefetch", daemon=True)
            for _ in range(self._live)
        ]
        self._finalizer = weakref.finalize(
            self, _shutdown_pump, self._q, self._threads, self._stop)
        for t in self._threads:
            t.start()

    # -- consumer ------------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        while True:
            # consumer-side starvation probe: occupancy BEFORE the get
            # (0 = the step loop is about to block on input) and the time
            # actually spent blocked (the ``prefetch.wait`` timer)
            _occupancy.set(self._q.qsize())
            wall0, t0 = time.time(), time.perf_counter()
            item = self._q.get()
            _obs.observe_span("prefetch.wait", wall0, t0)
            if item is _STOP:
                self._live -= 1
                if self._live > 0:
                    continue  # other transfer threads still draining
                self.close()
                raise StopIteration
            if isinstance(item, _Failure):
                self.close()
                raise item.exc
            if isinstance(item, _Staged):
                return item.handoff()
            return item

    def close(self):
        """Idempotent teardown: cancel producers, drain, join, and close
        the source iterator so the underlying reader is released."""
        if self._closed:
            return
        self._closed = True
        self._finalizer.detach()  # explicit close supersedes the GC hook
        _shutdown_pump(self._q, self._threads, self._stop)
        if not any(t.is_alive() for t in self._threads):
            close = getattr(self._source, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass


def device_feed_reader(feed_reader, executor, program=None, buffer_size=2,
                       transfer_threads=1):
    """Wrap a reader of HOST feed dicts into a creator of generators that
    yield ON-DEVICE feed dicts, transfers running on background thread(s)
    on the pipeline's own CUDA stream.  For raw sample-batch readers use
    :func:`decorate_device_feed`, which also moves DataFeeder conversion
    off the step loop."""
    from ..framework import default_main_program

    def prefetching():
        prog = program or default_main_program()
        device = _executor_device(executor)
        # the pipeline's transfer stream, leased from the port's set for
        # as long as the pipeline runs (streams.py)
        lease = _streams.Lease("device prefetch")
        stream = (lease.stream(_streams.device_index(device))
                  if device.type == "cuda" else None)

        def place(feed):
            return _place_feed(feed, device, prog, stream)

        pf = DevicePrefetcher(iter(feed_reader()), place,
                              buffer_size=buffer_size,
                              transfer_threads=transfer_threads)
        try:
            for item in pf:
                yield item
        finally:
            pf.close()
            # a transfer thread that outlived the close may still copy on
            # the stream: it stays leased then
            if not any(t.is_alive() for t in pf._threads):
                lease.release()

    return prefetching


def decorate_device_feed(reader, feeder, executor, program=None,
                         buffer_size=2, transfer_threads=1):
    """Raw sample-batch ``reader`` + ``DataFeeder`` -> creator of
    generators yielding on-device feed dicts.  Both the numpy conversion
    (the feeder's, to host arrays) and the transfer run on the
    background thread, double-buffered by default, so the step loop's
    only remaining feed cost is the executor fast path's shape/dtype
    check."""

    def feed_dicts():
        for batch in reader():
            yield feeder._feed_host(batch)

    return device_feed_reader(feed_dicts, executor, program=program,
                              buffer_size=buffer_size,
                              transfer_threads=transfer_threads)
