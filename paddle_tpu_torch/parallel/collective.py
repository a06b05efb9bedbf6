"""Collective communication over a mesh of ranks.

The port's counterpart of the JAX package's ``parallel/collective.py``.
The JAX package is single-controller SPMD: one process holds a list of
devices, lays them out on named mesh axes, and ``jax.lax`` collectives
run inside ``shard_map`` with an axis name.  The port keeps that model
with a list of *ranks*: a :class:`Mesh` is a grid of devices on named
axes, and the grid may name the same device more than once (the port's
counterpart of the JAX package's virtual CPU devices).  Ranks that share
a device share its memory; the numbers and the schedules are those of a
mesh of separate devices, the speed of links between cards is not.

Each collective takes one tensor for each rank of a mesh axis (a list in
rank order) and returns one for each rank, on that rank's device:

- :func:`psum` (``all_reduce``) and :func:`pmean`: the sum (mean) over
  the ranks, added in rank order on the first rank's device, so a
  collective gives the same bits on every run;
- :func:`all_gather`: the ranks' tensors concatenated on ``axis``
  (``tiled``) or stacked on a new leading axis;
- :func:`reduce_scatter`: the sum, rank ``i`` keeping block ``i`` of
  ``scatter_dimension`` (``jax.lax.psum_scatter(..., tiled=True)``);
- :func:`ppermute`: rank ``dst`` takes rank ``src``'s tensor for each
  ``(src, dst)`` pair, zeros where no pair names it;
- :func:`all_to_all`: every rank's tensor split in p blocks on
  ``split_axis``, rank ``j`` taking block ``j`` of each, concatenated on
  ``concat_axis`` in rank order.

They are built from differentiable torch operations (adds, slices,
concatenations, device copies), so autograd goes through every one of
them: the backward of ``psum`` is a ``psum``, the backward of
``all_gather`` a ``reduce_scatter`` and that of ``ppermute`` the
inverse permutation, as ``jax.grad`` gives them.

Across processes (:func:`init_distributed`: ``torch.distributed`` with
the reference's environment variables), :func:`psum` and :func:`pmean`
first reduce their ranks in the process, in rank order, then run one
``torch.distributed.all_reduce`` (gloo on the CPU).  A mesh step over
ranks in several processes waits for ROADMAP A11.4.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

__all__ = [
    "Mesh",
    "make_mesh",
    "all_reduce",
    "psum",
    "pmean",
    "all_gather",
    "reduce_scatter",
    "ppermute",
    "all_to_all",
    "axis_index",
    "axis_size",
    "device_count",
    "init_distributed",
    "shutdown_distributed",
    "ENGINE_RUNS",
    "reset_engine_counts",
    "axis_devices",
    "RankStreams",
]


class Mesh:
    """Ranks laid out on named axes: ``devices`` is a numpy object array
    of ``torch.device`` shaped by the axes (a device may appear more than
    once: ranks that share it), ``axis_names`` their names, and
    ``shape`` maps each name to its size (as a ``jax.sharding.Mesh``'s
    does).  Rank ``r`` is the ``r``-th device of ``devices.flat``."""

    def __init__(self, devices, axis_names):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    def axis_size(self, axis_name):
        """The size of ``axis_name``; 1 for an axis the mesh lacks."""
        return int(self.shape.get(axis_name, 1))

    def coords(self, rank):
        """Rank ``rank``'s position on each axis, in axis order."""
        return tuple(int(c) for c in np.unravel_index(rank, self.devices.shape))

    def rank(self, coords):
        return int(np.ravel_multi_index(tuple(coords), self.devices.shape))

    def device(self, rank):
        return self.devices.flat[rank]

    def groups(self, axis_name):
        """The ranks along ``axis_name``: one list for each position on the
        other axes, each list in the axis's order."""
        ax = self.axis_names.index(axis_name)
        ranks = np.arange(self.size).reshape(self.devices.shape)
        moved = np.moveaxis(ranks, ax, -1).reshape(-1, self.devices.shape[ax])
        return [[int(r) for r in row] for row in moved]

    def __repr__(self):
        return "Mesh(%s, devices=%s)" % (self.shape, [str(d) for d in self.devices.flat])


def _resolve(device):
    from ..core import resolve_device

    return resolve_device(device)


def make_mesh(axes, devices=None):
    """A :class:`Mesh` from ``{axis_name: size}`` (insertion ordered) over
    ``devices`` (a list of ranks' devices, repeats allowed; None: every
    card).  A -1 size absorbs the remaining ranks."""
    if devices is None:
        _resolve(None)
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_resolve(d) for d in devices]
    names = list(axes)
    sizes = [int(axes[n]) for n in names]
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = len(devices) // known
    total = int(np.prod(sizes))
    if total > len(devices):
        raise ValueError("mesh %r needs %d devices, have %d" % (axes, total, len(devices)))
    grid = np.empty(total, dtype=object)
    for i, d in enumerate(devices[:total]):
        grid[i] = d
    return Mesh(grid.reshape(sizes), tuple(names))


def _devices(xs, devices):
    return [x.device for x in xs] if devices is None else [torch.device(d) for d in devices]


def _on(t, device):
    return t if t.device == device else t.to(device)


def _local_sum(xs):
    total = xs[0]
    for x in xs[1:]:
        total = total + _on(x, total.device)
    return total


class _ProcessSum(torch.autograd.Function):
    """``torch.distributed.all_reduce`` of one tensor, whose backward is
    the same all-reduce of the gradient."""

    @staticmethod
    def forward(ctx, x):
        out = x.detach().clone()
        torch.distributed.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        torch.distributed.all_reduce(g)
        return g


def _across_processes():
    return (_DIST_STATE["initialized"] and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1)


def psum(xs, devices=None):
    """The sum over the ranks, one copy on each rank's device."""
    devs = _devices(xs, devices)
    total = _local_sum(xs)
    if _across_processes():
        total = _ProcessSum.apply(total)
    return [_on(total, d) for d in devs]


all_reduce = psum  # reference spelling


def pmean(xs, devices=None):
    n = len(xs)
    if _across_processes():
        n *= torch.distributed.get_world_size()
    return [s / n for s in psum(xs, devices)]


def all_gather(xs, axis=0, tiled=True, devices=None):
    """Every rank's tensor concatenated on ``axis`` (``tiled``) or stacked
    on a new axis ``axis``, one copy on each rank's device."""
    devs = _devices(xs, devices)
    home = xs[0].device
    parts = [_on(x, home) for x in xs]
    full = torch.cat(parts, axis) if tiled else torch.stack(parts, axis)
    return [_on(full, d) for d in devs]


def reduce_scatter(xs, scatter_dimension=0, devices=None):
    """The sum over the ranks, split in equal blocks on
    ``scatter_dimension``: rank ``i`` keeps block ``i``."""
    devs = _devices(xs, devices)
    p = len(xs)
    total = _local_sum(xs)
    if total.shape[scatter_dimension] % p:
        raise ValueError("reduce_scatter: dim %d of size %d does not split in %d"
                         % (scatter_dimension, total.shape[scatter_dimension], p))
    return [_on(b, d) for b, d in zip(total.chunk(p, scatter_dimension), devs)]


def ppermute(xs, perm, devices=None):
    """Rank ``dst`` takes rank ``src``'s tensor for each ``(src, dst)`` of
    ``perm``; a rank no pair sends to takes zeros."""
    devs = _devices(xs, devices)
    out = [None] * len(xs)
    for src, dst in perm:
        if out[dst] is not None:
            raise ValueError("ppermute: rank %d receives twice" % dst)
        out[dst] = _on(xs[src], devs[dst])
    return [o if o is not None else torch.zeros_like(xs[i], device=devs[i])
            for i, o in enumerate(out)]


def all_to_all(xs, split_axis, concat_axis, tiled=True, devices=None):
    """Rank ``j`` takes block ``j`` (of p on ``split_axis``) of every
    rank's tensor, concatenated on ``concat_axis`` in rank order
    (``tiled``), or stacked on a new axis ``concat_axis``."""
    devs = _devices(xs, devices)
    p = len(xs)
    for x in xs:
        if x.shape[split_axis] % p:
            raise ValueError("all_to_all: dim %d of size %d does not split in %d"
                             % (split_axis, x.shape[split_axis], p))
    blocks = [x.chunk(p, split_axis) for x in xs]
    out = []
    for j, d in enumerate(devs):
        parts = [_on(blocks[i][j], d) for i in range(p)]
        if tiled:
            out.append(torch.cat(parts, concat_axis))
        else:
            out.append(torch.stack(parts, concat_axis))
    return out


def axis_index(mesh, axis_name, rank):
    """Rank ``rank``'s position on ``axis_name``."""
    return mesh.coords(rank)[mesh.axis_names.index(axis_name)]


def axis_size(mesh, axis_name):
    return mesh.axis_size(axis_name)


def device_count():
    """Ranks of the whole job: the cards of this process (every process's
    once ``init_distributed`` has joined several)."""
    n = torch.cuda.device_count()
    if _across_processes():
        n *= torch.distributed.get_world_size()
    return n


# Whether THIS module initialized torch.distributed, so that repeat calls
# and teardown are decided by state, not by parsing exception text
_DIST_STATE = {"initialized": False}


def init_distributed(coordinator_address=None, num_processes=None, process_id=None):
    """Join this process to a multi-process job (``torch.distributed``,
    gloo): the reference's trainer wiring.  Arguments default from its
    environment variables — ``PADDLE_COORDINATOR`` (host:port of process
    0), ``PADDLE_TRAINERS_NUM`` and ``PADDLE_TRAINER_ID`` — so launcher
    scripts port unchanged.  One process without a coordinator is a
    no-op, and so is a repeat call."""
    coordinator_address = coordinator_address or os.environ.get("PADDLE_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
    if process_id is None:
        process_id = int(os.environ.get("PADDLE_TRAINER_ID", "0"))
    if not 0 <= process_id < num_processes:
        raise ValueError(
            "process_id %d out of range for %d processes" % (process_id, num_processes))
    if num_processes > 1 and not coordinator_address:
        raise ValueError(
            "multi-process init needs coordinator_address (or PADDLE_COORDINATOR)")
    if num_processes == 1 and not coordinator_address:
        return  # one process, no coordinator requested: nothing to wire up
    if _DIST_STATE["initialized"]:
        return  # repeat initialization is a documented no-op
    torch.distributed.init_process_group(
        "gloo", init_method="tcp://%s" % coordinator_address,
        world_size=int(num_processes), rank=int(process_id))
    _DIST_STATE["initialized"] = True


def shutdown_distributed():
    if not _DIST_STATE["initialized"]:
        return  # never initialized (by us): nothing to tear down
    torch.distributed.destroy_process_group()
    _DIST_STATE["initialized"] = False


#: Runs of each multi-rank engine, by name: ``ring`` and ``ulysses``
#: (sequence parallelism), ``sp_fallback`` (the ``flash_attention`` rule
#: on an ``sp`` mesh gathering the sequence for the one-shard kernels),
#: ``ep`` (``switch_moe``'s expert-parallel engine), ``gpipe`` and
#: ``circular`` (the pipeline schedules).  One count a call of the
#: engine, as the kernel wrappers count their launches.
ENGINE_RUNS = {"ring": 0, "ulysses": 0, "sp_fallback": 0, "ep": 0,
               "gpipe": 0, "circular": 0}


def count_engine(name):
    ENGINE_RUNS[name] += 1


def reset_engine_counts():
    for k in ENGINE_RUNS:
        ENGINE_RUNS[k] = 0


def add_engine_runs(runs):
    """Count ``runs`` ({engine: runs}, what a captured step recorded) once
    more: a CUDA graph replay of the step runs them again."""
    for k, v in (runs or {}).items():
        ENGINE_RUNS[k] += v


def axis_devices(mesh, axis_name):
    """The devices of the first group of ranks along ``axis_name``, in the
    axis's order."""
    return [mesh.device(r) for r in mesh.groups(axis_name)[0]]


class RankStreams:
    """One CUDA stream a rank on the card, leased from ``streams.py``
    (ranks that share a device each take a stream of their own): the
    pipeline schedules run a rank's work of one tick ``on`` its stream,
    after every stream ``fork``s from the calling stream, and ``join``
    the calling stream to every stream after it, so that the ranks' work
    between two joins can overlap on the card.  Inside a CUDA graph
    capture the forks and joins are the graph's edges.  ``use`` marks
    the tensors a rank's work reads as used on its stream
    (``record_stream``), so that the caching allocator hands out none of
    them again (a block freed on the calling stream while a rank's
    kernel, or the backward kernel that reads it as a saved tensor,
    still reads it) until that stream's work is done; ``join`` marks the
    tensors a rank's work made as used on the calling stream, which reads
    them after the join, for the same reason.  A capture defers such
    blocks until it ends.  Each stream's cuBLAS workspace is made outside
    any capture (the first, eager, step) and the stream marked with the
    thread's cuBLAS handle, so that the capture step's lease, which
    prefers marked streams, makes none inside the graph's pool.  Off the
    card everything runs on the calling stream.  ``release`` gives the
    streams back."""

    def __init__(self, devs, name):
        self._devs = list(devs)
        self._cuda = all(d.type == "cuda" for d in self._devs)
        self._lease = None
        self._streams = []
        if not self._cuda:
            return
        from .. import executor as _executor
        from .. import streams as _streams

        self._lease = _streams.Lease(name)
        handle = torch.cuda.current_blas_handle()
        capturing = torch.cuda.is_current_stream_capturing()
        for d in self._devs:
            index = _streams.device_index(d)
            s = self._lease.stream(index, prefer=handle)
            if not capturing:
                with torch.cuda.stream(s):
                    _executor._warm_blas(d)
                self._lease.mark(index, s, handle)
            self._streams.append(s)

    def fork(self):
        for s, d in zip(self._streams, self._devs):
            s.wait_stream(torch.cuda.current_stream(d))

    def on(self, i):
        if not self._cuda:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._streams[i])

    def use(self, i, tensors):
        if self._cuda:
            for t in tensors:
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    t.record_stream(self._streams[i])

    def join(self, made=()):
        for s, d in zip(self._streams, self._devs):
            torch.cuda.current_stream(d).wait_stream(s)
        if self._cuda:
            for t in made:
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    t.record_stream(torch.cuda.current_stream(t.device))

    def release(self):
        if self._lease is not None:
            self._lease.release()
            self._lease = None
