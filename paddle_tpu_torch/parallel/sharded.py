"""A value laid out over a mesh of ranks.

The port's counterpart of a ``jax.Array`` with a ``NamedSharding``: a
:class:`ShardedTensor` is a global tensor of ``shape`` split into blocks
by a *spec*, one entry a dimension, each an axis name of the mesh (that
dimension splits in equal blocks over the axis) or ``None`` (whole).  A
spec is the port's stand-in for a ``PartitionSpec``: ``("dp", None)``
is ``P("dp", None)``, and ``()`` (every entry None) is replication.

Each distinct block is kept once, on the device of the first rank that
holds it; ranks that hold the same block (replicated along an axis the
spec does not name) share it, as they share their device in a mesh whose
ranks share a card.  :meth:`ShardedTensor.rank_bytes` is what each rank
holds.  :meth:`ShardedTensor.full` concatenates the blocks (a
differentiable all-gather), and a block of a ``dp``-split activation is
a view of the batch it came from.
"""
from __future__ import annotations

import itertools

import torch

__all__ = ["ShardedTensor", "normalize_spec", "block_view", "gathered",
           "conform", "layout_spec", "tensors_of", "with_tensors"]


def normalize_spec(spec, ndim=None):
    """``spec`` as a tuple with its trailing ``None`` entries dropped
    (padded with None to ``ndim`` when given): the form specs compare
    in."""
    spec = tuple(spec or ())
    if ndim is not None:
        spec = spec + (None,) * (ndim - len(spec))
        return spec
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


class ShardedTensor:
    """A global tensor of ``shape`` held in blocks over ``mesh`` by
    ``spec`` (see the module docstring).  ``blocks`` maps a block index
    (one entry a dimension: the block's position on that dimension, 0
    for a dimension the spec leaves whole) to its tensor."""

    __slots__ = ("mesh", "spec", "blocks", "shape", "dtype", "_graph_state",
                 "__weakref__")

    def __init__(self, mesh, spec, blocks, shape):
        self.mesh = mesh
        self.spec = normalize_spec(spec, len(shape))
        self.blocks = blocks
        self.shape = torch.Size(shape)
        self.dtype = next(iter(blocks.values())).dtype
        self._graph_state = False

    # layout ---------------------------------------------------------------
    def splits(self):
        """Blocks along each dimension."""
        return tuple(self.mesh.axis_size(a) if a else 1 for a in self.spec)

    def block_of(self, rank):
        """The block index rank ``rank`` holds."""
        coords = dict(zip(self.mesh.axis_names, self.mesh.coords(rank)))
        return tuple(coords[a] if a else 0 for a in self.spec)

    def local(self, rank):
        return self.blocks[self.block_of(rank)]

    def rank_bytes(self):
        """Bytes each rank holds, in rank order."""
        return [self.local(r).nelement() * self.local(r).element_size()
                for r in range(self.mesh.size)]

    @classmethod
    def from_full(cls, full, mesh, spec, copy=True):
        """``full`` split by ``spec``: each block a contiguous copy on the
        device of the first rank holding it (``copy=False``: a view where
        that device is ``full``'s)."""
        spec = normalize_spec(spec, full.ndim)
        splits = tuple(mesh.axis_size(a) if a else 1 for a in spec)
        for d, (n, size) in enumerate(zip(splits, full.shape)):
            if size % n:
                raise ValueError("dim %d of size %d does not split in %d "
                                 "blocks (spec %s)" % (d, size, n, spec))
        homes = {}
        probe = cls.__new__(cls)
        probe.mesh, probe.spec = mesh, spec
        for r in range(mesh.size):
            homes.setdefault(probe.block_of(r), mesh.device(r))
        blocks = {}
        for idx in itertools.product(*(range(n) for n in splits)):
            b = block_view(full, idx, splits)
            home = homes[idx]
            if b.device != home:
                b = b.to(home)
            elif copy:
                b = b.clone()
            blocks[idx] = b
        return cls(mesh, spec, blocks, full.shape)

    def full(self):
        """The global tensor (the blocks concatenated, differentiable), on
        the device of block 0."""
        splits = self.splits()
        home = self.blocks[(0,) * len(splits)].device

        def cat(prefix, d):
            if d == len(splits):
                b = self.blocks[prefix]
                return b if b.device == home else b.to(home)
            parts = [cat(prefix + (i,), d + 1) for i in range(splits[d])]
            return parts[0] if len(parts) == 1 else torch.cat(parts, d)

        return cat((), 0)

    def map(self, fn):
        """A ShardedTensor of the same layout, ``fn`` applied to each block."""
        return ShardedTensor(self.mesh, self.spec,
                             {i: fn(b) for i, b in self.blocks.items()},
                             self.shape)

    def same_layout(self, other):
        return (isinstance(other, ShardedTensor) and other.mesh is self.mesh
                and other.spec == self.spec and other.shape == self.shape
                and other.dtype == self.dtype)

    # the tensor surface the executor's state handling reads ---------------
    @property
    def ndim(self):
        return len(self.shape)

    @property
    def device(self):
        return self.blocks[(0,) * self.ndim].device

    def is_floating_point(self):
        return self.dtype.is_floating_point

    def detach(self):
        return self.map(lambda b: b.detach())

    def clone(self):
        return self.map(lambda b: b.clone())

    def float(self):
        return self.full().float()

    def requires_grad_(self, flag=True):
        for b in self.blocks.values():
            b.requires_grad_(flag)
        return self

    def copy_(self, other):
        """Write ``other`` (a ShardedTensor of any layout, or a full
        tensor) into these blocks in place."""
        if isinstance(other, ShardedTensor) and other.spec == self.spec:
            for i, b in self.blocks.items():
                b.copy_(other.blocks[i])
            return self
        src = other.full() if isinstance(other, ShardedTensor) else other
        for i, b in self.blocks.items():
            b.copy_(block_view(src, i, self.splits()))
        return self

    def storage_ptrs(self):
        return {b.untyped_storage().data_ptr() for b in self.blocks.values()}

    def numpy(self):
        from ..executor import as_numpy

        return as_numpy(self.full())

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)

    def __repr__(self):
        return "ShardedTensor(shape=%s, spec=%s, dtype=%s, blocks=%d)" % (
            tuple(self.shape), self.spec, self.dtype, len(self.blocks))


def block_view(full, idx, splits):
    """The view of ``full`` that block ``idx`` covers when each dimension
    splits in ``splits`` equal blocks."""
    b = full
    for d, (i, n) in enumerate(zip(idx, splits)):
        if n > 1:
            step = full.shape[d] // n
            b = b.narrow(d, i * step, step)
    return b


def gathered(v):
    """``v`` as one tensor: a ShardedTensor's full value, anything else
    itself."""
    return v.full() if isinstance(v, ShardedTensor) else v


def layout_spec(v):
    """The spec ``v`` is laid out by, trailing Nones dropped: ``()`` for a
    plain tensor (replicated)."""
    return normalize_spec(v.spec) if isinstance(v, ShardedTensor) else ()


def conform(v, mesh, spec, copy=True):
    """``v`` (a tensor or a ShardedTensor) laid out by ``spec``: a plain
    tensor for a replicated spec, else a ShardedTensor."""
    # an axis of size 1 splits nothing
    spec = normalize_spec(tuple(
        a if a is not None and mesh is not None and mesh.axis_size(a) > 1
        else None for a in (spec or ())))
    if not spec:
        return gathered(v)
    if isinstance(v, ShardedTensor) and normalize_spec(v.spec) == spec:
        return v
    return ShardedTensor.from_full(gathered(v), mesh, spec, copy=copy)


def tensors_of(v):
    """The tensors that hold ``v``: a ShardedTensor's blocks, in block
    order, or ``[v]``."""
    return list(v.blocks.values()) if isinstance(v, ShardedTensor) else [v]


def with_tensors(like, tensors):
    """A value laid out as ``like`` from the tensors ``tensors_of`` would
    give for it."""
    if isinstance(like, ShardedTensor):
        return ShardedTensor(like.mesh, like.spec,
                             dict(zip(like.blocks, tensors)), like.shape)
    (t,) = tensors
    return t
