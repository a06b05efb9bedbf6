"""Long-lived CUDA streams, leased to one live holder at a time.

``torch.cuda.Stream(device)`` does not create a stream: it hands out one
of a pool of 32 a device and priority, round-robin, so its 33rd call
returns the stream of its first.  The port's long-lived streams (a
replica's worker and load streams, the capture side stream of each
stream captures are made from, a device prefetcher's transfer stream)
live as long as their holder, and drawn from that pool a replica pool
built after a few others had come and gone got the streams of a pool
still serving (ROADMAP F-14): its captures ran on a stream into which a
live replica launched, and two graph sets replayed at once kept one
cuBLAS workspace.

Here each such stream comes from :data:`LEASE`: a fixed set of at most
:data:`STREAMS_PER_DEVICE` streams a device that the port creates itself
(``cuStreamCreate`` with ``CU_STREAM_NON_BLOCKING``, the flag of
PyTorch's own pool streams), each at its first lease, and keeps for the
life of the process, so PyTorch's cuBLAS workspaces, one a (handle,
stream), stay bounded by the set.  A stream is held by one
:class:`Lease` at a time: a holder gives its streams back with
:meth:`Lease.release` (a pool's stop, a prefetcher's close, the
collection of the holder), and with every stream of a device held
:meth:`StreamLease.acquire` raises naming the count.  It never hands out
a stream that is held.

The capture side stream of a leased stream (``executor._capture``) is
leased with it, by the same holder, and goes back with it: a holder
releases only after the graphs captured on its side streams are gone.

PyTorch makes a cuBLAS workspace (32 MiB on an H100) for each pair of a
cuBLAS handle (one a thread, from a pool) and a stream at its first
cuBLAS call, and keeps it for the process.  So whoever runs cuBLAS on a
leased stream marks it with the thread's handle (:meth:`Lease.mark`: a
replica's warm-up on its worker and load streams, ``_capture`` on a side
stream), a stream is asked for with the handle of the thread that will
use it (``prefer``), and a free stream that this handle has marked is
handed out first: a pool built again (a router's cold activation) then
adds no device memory.

The lease itself is plain Python over stream handles (anything with a
``cuda_stream`` attribute), so it is tested on the CPU with a stand-in
``make``.
"""
from __future__ import annotations

import ctypes
import threading

__all__ = ["STREAMS_PER_DEVICE", "StreamLease", "Lease", "LEASE",
           "device_index", "leased", "side_of"]

#: Streams the lease creates at most for one device.  A two-replica
#: decode pool holds 4 (a worker stream and its capture side stream a
#: replica), a predict replica up to 6 (its worker and two load streams,
#: each with a side stream).
STREAMS_PER_DEVICE = 64

_CU_STREAM_NON_BLOCKING = 0x1


def _libcuda():
    """libcuda, with its functions' signatures declared."""
    lib = ctypes.CDLL("libcuda.so.1")
    ptr = ctypes.POINTER
    for name, args in (
            ("cuInit", [ctypes.c_uint]),
            ("cuDeviceGet", [ptr(ctypes.c_int), ctypes.c_int]),
            ("cuDevicePrimaryCtxRetain", [ptr(ctypes.c_void_p),
                                          ctypes.c_int]),
            ("cuCtxPushCurrent_v2", [ctypes.c_void_p]),
            ("cuCtxPopCurrent_v2", [ptr(ctypes.c_void_p)]),
            ("cuStreamCreate", [ptr(ctypes.c_void_p), ctypes.c_uint])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    return lib


def device_index(device):
    """The CUDA ordinal of ``device`` (a ``torch.device``)."""
    import torch

    return (device.index if device.index is not None
            else torch.cuda.current_device())


def _check(rc, what):
    if rc != 0:
        raise RuntimeError("%s failed with CUresult %d" % (what, rc))


def create_stream(index):
    """A new non-blocking CUDA stream on device ``index``, created in its
    primary context (the one PyTorch uses) and never destroyed, as a
    ``torch.cuda.ExternalStream``."""
    import torch

    torch.cuda.init()
    cu = _libcuda()
    _check(cu.cuInit(0), "cuInit")
    dev = ctypes.c_int()
    _check(cu.cuDeviceGet(ctypes.byref(dev), int(index)), "cuDeviceGet")
    ctx = ctypes.c_void_p()
    _check(cu.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
           "cuDevicePrimaryCtxRetain")
    _check(cu.cuCtxPushCurrent_v2(ctx), "cuCtxPushCurrent")
    try:
        handle = ctypes.c_void_p()
        _check(cu.cuStreamCreate(ctypes.byref(handle),
                                 _CU_STREAM_NON_BLOCKING), "cuStreamCreate")
    finally:
        popped = ctypes.c_void_p()
        cu.cuCtxPopCurrent_v2(ctypes.byref(popped))
    return torch.cuda.ExternalStream(
        handle.value, device=torch.device("cuda", int(index)))


class StreamLease:
    """The fixed set of streams and who holds each.  ``make(index)``
    creates a stream of device ``index`` (one with a ``cuda_stream``
    handle); ``limit`` is the set's size a device."""

    def __init__(self, make=create_stream, limit=STREAMS_PER_DEVICE):
        self._make = make
        self._limit = int(limit)
        self._lock = threading.Lock()
        self._free = {}      # device index -> streams no one holds
        self._made = {}      # device index -> streams created
        self._tags = {}      # (device index, handle) -> cuBLAS handles marked
        self._held = {}      # (device index, handle) -> (Lease, stream)

    def acquire(self, index, holder, prefer=None):
        """A stream of device ``index`` for ``holder`` (a :class:`Lease`):
        a free one marked with the cuBLAS handle ``prefer``, else the
        free one released first, else a new one; raises
        ``RuntimeError`` naming the count when every stream of the device
        is held."""
        index = int(index)
        with self._lock:
            free = self._free.setdefault(index, [])
            known = [i for i, f in enumerate(free) if prefer is not None
                     and prefer in self._tags.get((index, f.cuda_stream),
                                                  ())]
            if known:
                stream = free.pop(known[0])
            elif free:
                stream = free.pop(0)
            elif self._made.get(index, 0) < self._limit:
                stream = self._make(index)
                self._made[index] = self._made.get(index, 0) + 1
            else:
                raise RuntimeError(
                    "all %d streams of cuda:%d are leased (holders: %s); "
                    "stop a pool or close a prefetcher first"
                    % (self._limit, index, ", ".join(sorted(
                        {h.name for (i, _), (h, _) in self._held.items()
                         if i == index}))))
            key = (index, stream.cuda_stream)
            if key in self._held:
                # a maker that repeats handles (PyTorch's round-robin pool
                # does) must not hand out a stream that is in use
                raise RuntimeError(
                    "stream %#x of cuda:%d is already held by %s"
                    % (key[1], index, self._held[key][0].name))
            self._held[key] = (holder, stream)
            return stream

    def mark(self, index, stream, tag):
        """Record that cuBLAS ran on ``stream`` with the handle ``tag``
        (PyTorch now keeps a workspace for the pair)."""
        with self._lock:
            self._tags.setdefault((int(index), stream.cuda_stream),
                                  set()).add(tag)

    def release(self, index, stream):
        with self._lock:
            if self._held.pop((int(index), stream.cuda_stream),
                              None) is not None:
                self._free.setdefault(int(index), []).append(stream)

    def holder(self, index, stream):
        """The :class:`Lease` that holds ``stream`` on device ``index``,
        or None."""
        with self._lock:
            entry = self._held.get((int(index), stream.cuda_stream))
        return None if entry is None else entry[0]

    def held(self):
        """``{(device index, handle): holder name}`` of every held
        stream."""
        with self._lock:
            return {k: h.name for k, (h, _) in self._held.items()}

    def created(self, index):
        with self._lock:
            return self._made.get(int(index), 0)


class Lease:
    """The streams one holder has leased.  :meth:`stream` leases one
    more, :meth:`side` the capture side stream of one of them (leased
    once, with it), :meth:`release` gives them all back (once; later
    calls do nothing)."""

    def __init__(self, name, lease=None):
        self.name = name
        self._lease = lease if lease is not None else LEASE
        self._streams = []   # (device index, stream)
        self._sides = {}     # handle of a held stream -> its side stream
        self._lock = threading.Lock()

    def stream(self, index, prefer=None):
        """Lease one more stream of device ``index``, preferring one
        marked with the cuBLAS handle ``prefer``."""
        s = self._lease.acquire(index, self, prefer)
        with self._lock:
            self._streams.append((int(index), s))
        return s

    def side(self, index, stream, prefer=None):
        """The capture side stream of ``stream`` (held by this lease),
        leased at the first call, preferring one marked with the
        capturing thread's cuBLAS handle ``prefer``."""
        with self._lock:
            side = self._sides.get(stream.cuda_stream)
            if side is None:
                side = self._lease.acquire(index, self, prefer)
                self._streams.append((int(index), side))
                self._sides[stream.cuda_stream] = side
            return side

    def mark(self, index, stream, tag):
        self._lease.mark(index, stream, tag)

    def release(self):
        with self._lock:
            streams, self._streams = self._streams, []
            self._sides = {}
        for index, s in streams:
            self._lease.release(index, s)


#: The process's lease.
LEASE = StreamLease()


def leased(index, stream, lease=None):
    """The :class:`Lease` holding ``stream`` on device ``index``, or
    None for a stream the lease did not hand out (the default stream, a
    caller's own)."""
    return (lease or LEASE).holder(index, stream)


def side_of(index, stream, lease=None):
    """The capture side stream already leased for ``stream``, or None."""
    holder = leased(index, stream, lease)
    if holder is None:
        return None
    with holder._lock:
        return holder._sides.get(stream.cuda_stream)
