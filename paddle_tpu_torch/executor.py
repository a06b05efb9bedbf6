"""Executor: runs a Program block op by op with PyTorch.

The port's counterpart of the JAX package's ``paddle_tpu/executor.py``,
written for torch.  The JAX Executor traces a block into one XLA
computation; here ``Executor.run`` walks the block once per call and
calls each op's registered rule (``registry.get_rule``), which computes
the op with torch on the executor's device — the card unless the caller
asks for the CPU.  The flash attention op reaches the hand-written CUDA
kernels there.

Autodiff: the single ``backward`` meta-op that ``append_backward`` adds
runs the forward prefix with the trainable parameters as autograd leaf
tensors; ``torch.autograd.grad`` of the summed targets then binds every
``<param>@GRAD`` (zeros for a parameter the loss does not reach, as
``jax.value_and_grad`` gives), and the post-ops (clip, regularizer,
optimizer updates) run under ``torch.no_grad``.  ``calc_gradient``'s
meta-op does the same for arbitrary targets (weighted by
``TargetGradients`` where given) with respect to any variables: feeds,
parameters, or intermediates, where the graph is cut (the consumers of
an intermediate see a leaf holding its value).

State (parameters, optimizer accumulators, step counters) lives in a
``Scope`` as torch tensors on the device; persistables the step writes go
back to the scope that owns them, and fetches come back as numpy.

Fast path (the JAX package's bound programs and compiled-entry cache):
once a (program, scope, fetch list, feed shapes) run has gone through
the path above, ``run()`` binds it (``_BoundProgram``: the owner scope of
every persistable, the feed plan, the read set, the random ops).  The
entry's second run captures the whole step (forward,
``torch.autograd.grad``, clip, regularizer, updates) as one CUDA graph,
and every later run is one replay: feeds are copied into the graph's
static input buffers, the persistables it writes are copied, inside the
graph, into the scope's own tensors (the counterpart of donation), and
fetches are cloned out of the graph's pool.  On the CPU the captured
step runs as it is, each run, on the same buffers.  A Program with a
rule that waits on the host (``registry.reads_host``: ``while``,
``conditional_block``, ``beam_search_decode``, ``assign_value``, a
``bilinear_interp`` fed an ``OutSize``, a ``sequence_mask`` without
``maxlen``) or a LoD fetch is never bound:
each run takes the path above, and the op is counted (``executor.graph_refused{op=...}``).  Nor is
a run fed a ragged batch (a ``LoDArray``).  Invalidation: a
``program.version`` bump, any public mutation of a scope on the owner
chain (``Scope._version``), a feed whose shape, dtype or kind changed,
a state var gone or replaced.  ``return_numpy=True`` fetches of a bound
entry come back as ``LazyFetch`` values that copy to the host on first
access.  ``nan_guard=True`` gates the step's state update on one
device-side finiteness verdict (``last_step_ok()``).
``use_program_cache=False`` runs a step op by op.

Random ops draw from a ``torch.Generator`` on the device, seeded from
the scope's run seed (``program.random_seed``, or a random one when that
is 0, as the JAX package does), the run counter and the op's position
in its block (the JAX package's ``LoweringContext.op_key``); a nonzero
``seed`` attr pins an op's stream across runs.

Feeds are numpy arrays, tensors, or ``lod.LoDArray``s (a ragged feed:
its padded data under the var's name, its lengths as
``<name>@LENGTHS``, nested lengths as ``<name>@SUBLENGTHS``).  After
every rule, an output that keeps the ``[batch, time]`` leading dims of
an input with lengths inherits them (``_propagate_lengths``, the JAX
package's), unless the op is one of the sequence rules that set their
own.

Sub-blocks (``while``, ``conditional_block``; their rules are in
``layers/control_flow.py``) run their ops through ``interpret_ops`` on a
``LoweringContext.child`` over a copy of the outer environment: the
body's own variables stay there, and only the outer variables it writes
and its tensor arrays (``<name>@ARRAY``, ``<name>@ARRAYLEN``) come back.

Readers: a run given no feed takes one batch from each started
``layers.py_reader`` of the Program (``core.EOFException`` when one is
exhausted, the others' batches pushed back); such a run is never bound
(``executor.graph_refused{op=py_reader}``).

Recompute (``Program.enable_recompute(n)``): the backward's forward
prefix runs as ``n`` segments, all but the last checkpointed, with the
environment pruned at each boundary (``lower_block``); bound and
captured like any other step, with the same bits as the step without
it.

Introspection (``observability.xla_stats``, ``profiler``): while the
plane is armed, the first op-by-op run of a key runs under a count
(FLOPs, bytes, peak memory), which its bound entry keeps; an entry
bound before arming runs its captured step eagerly once under the count
instead of a replay.  Observed steps are timed on the device (CUDA
events, read without a synchronization) for MFU, and the step record's
``execute_s`` is that device time while the plane or a sink that asks
for it (``StepAttribution``) is on.  A capture emits the
``executor.compile`` span.  While a profiler session runs, a bound
entry runs op by op and each Program op sits in a ``record_function``
range (``op_scope``).

Meshes: ``attach_mesh`` takes a mesh of ranks (``parallel_executor.
build_mesh``).  On one rank a step is the step without a mesh; on more,
every op goes through ``mesh_step.MeshRun`` (the batch split over dp,
the state laid out by its specs, ``ShardedTensor`` values in the scope),
and the step binds and captures as any step does.  Not ported yet: the
persistent compile cache (a CUDA graph cannot be saved) and a mesh over
ranks in several processes (ROADMAP A11.4).

Parameter servers (``transpiler.DistributeTranspiler``): a Program
holding ``listen_and_serv`` serves (``transpiler.pserver_runtime.serve``:
its optimize block applied by this Executor, bound like any step), and
one holding ``send``/``recv`` runs its compute as a bound step, then
the round with its pservers (``run_trainer_step``); ``close`` tells the
pservers this trainer is done.
"""
from __future__ import annotations

import contextlib
import threading
import time
import weakref

import numpy as np
import torch

from . import observability as _obs
from . import profiler as _prof
from . import resilience
from . import streams as _streams
from .core import f32_bf16_reduction, resolve_device, torch_dtype
from .framework import Program, Variable, default_main_program, grad_var_name
from .lod import LoDArray
from .observability import xla_stats as _xla_stats
from .parallel import collective as _collective
from .parallel.sharded import (ShardedTensor, block_view, conform, gathered,
                               tensors_of, with_tensors)
from .registry import get_rule, reads_host

__all__ = ["Executor", "Scope", "global_scope", "scope_guard", "as_numpy",
           "load_numpy_state", "LoweringContext", "interpret_ops",
           "lower_block", "recompute_segments", "SERVING_BLOCK_ROWS",
           "LazyFetch",
           "feed_host_copy_count", "cache_eviction_count", "compile_count",
           "JitStepCache", "enable_compilation_cache"]


# ---------------------------------------------------------------------------
# Scope (a copy of the JAX package's, holding torch tensors)
# ---------------------------------------------------------------------------


class _TensorShim:
    """Minimal shim mimicking the reference's Tensor handle so code written
    against ``scope.find_var(n).get_tensor()`` works."""

    def __init__(self, scope, name):
        self._scope = scope
        self._name = name

    def __array__(self, dtype=None, copy=None):
        a = as_numpy(self._scope.vars[self._name])
        return a.astype(dtype) if dtype is not None else a

    def set(self, value, place=None):
        self._scope.vars[self._name] = np.asarray(value)
        self._scope._bump()

    def shape(self):
        return list(np.shape(self._scope.vars[self._name]))


class _VarShim:
    def __init__(self, scope, name):
        self._scope = scope
        self._name = name

    def get_tensor(self):
        return _TensorShim(self._scope, self._name)


class Scope:
    """Host-side variable store: name -> tensor (reference
    framework/scope.h, but flat — block locals never reach it).

    A tensor taken from the scope (``scope[name]``) is the live state
    buffer: once the Executor has captured a step that writes it as a
    CUDA graph, every later step updates that tensor in place, replayed
    or op by op.  Clone it to keep a value;
    ``find_var(name).get_tensor()`` read as numpy is a copy and never
    changes."""

    def __init__(self):
        self.vars: dict[str, object] = {}
        self.kids: list["Scope"] = []
        self._parent: "Scope | None" = None
        # mutation counter for the Executor's bound entries: every public
        # mutator bumps it, invalidating the entries whose owner
        # resolution walked through this scope.  The Executor's own
        # write-back of a step's results does not bump.
        self._version = 0

    def _bump(self):
        self._version += 1

    def new_scope(self) -> "Scope":
        """Child scope: lookups fall back to this scope (reference
        Scope::NewScope / FindVar ancestor search)."""
        kid = Scope()
        kid._parent = self
        self.kids.append(kid)
        return kid

    def drop_kids(self):
        kids, self.kids = self.kids, []
        self._bump()
        for kid in kids:
            kid._parent = None
            kid.drop()

    def _owner(self, name):
        scope = self
        while scope is not None:
            if name in scope.vars:
                return scope
            scope = scope._parent
        return None

    def find_var(self, name):
        owner = self._owner(name)
        return _VarShim(owner, name) if owner is not None else None

    def var(self, name):
        if name not in self.vars:
            self.vars[name] = None
            self._bump()  # a new local can shadow an ancestor's binding
        return _VarShim(self, name)

    def __contains__(self, name):
        return self._owner(name) is not None

    def __getitem__(self, name):
        owner = self._owner(name)
        if owner is None:
            raise KeyError(name)
        return owner.vars[name]

    def __setitem__(self, name, value):
        self.vars[name] = value
        self._bump()

    def keys(self):
        return self.vars.keys()

    def drop(self):
        """Release this scope's vars and its whole subtree."""
        self.vars.clear()
        self._bump()
        for kid in self.kids:
            kid._parent = None
            kid.drop()
        self.kids.clear()
        if self._parent is not None and self in self._parent.kids:
            self._parent.kids.remove(self)
        self._parent = None


_global_scope = Scope()
_scope_stack = [_global_scope]


def global_scope() -> Scope:
    return _scope_stack[-1]


@contextlib.contextmanager
def scope_guard(scope: Scope):
    _scope_stack.append(scope)
    try:
        yield
    finally:
        _scope_stack.pop()


def as_numpy(tensor):
    """A tensor (or a list of them) as numpy on the host; bfloat16 comes
    back as float32, since numpy has no bfloat16.  A tensor's array is a
    copy (:func:`_to_host`; a CUDA tensor's through pinned host memory),
    so a later step that updates the tensor in place never changes it."""
    if isinstance(tensor, (list, tuple)):
        return [as_numpy(t) for t in tensor]
    if isinstance(tensor, ShardedTensor):
        tensor = tensor.full()
    if isinstance(tensor, torch.Tensor):
        return _to_host(tensor)
    return np.asarray(tensor)


def _to_host(tensor, ready=None):
    """A copy of ``tensor``'s values as a numpy array in pageable memory,
    bit for bit (bfloat16 widened to float32); it never shares memory
    with the tensor.  A CUDA tensor is staged through a pinned host
    buffer (after ``ready``, the event of the stream that produced it,
    where given), waited for, and copied out of it.  The buffer goes back
    to PyTorch's caching host allocator at once, so the next fetch of its
    size reuses it, and the pinned memory in use is one buffer a fetch in
    flight, whatever the caller keeps."""
    t = tensor.detach()
    wide = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
    if t.device.type != "cuda":
        return t.to(wide, copy=True).numpy()
    stream = torch.cuda.current_stream(t.device)
    if ready is not None:
        stream.wait_event(ready)
    t = t.to(wide)
    staging = torch.empty(t.shape, dtype=wide, pin_memory=True)
    staging.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(stream)
    done.synchronize()
    out = torch.empty(t.shape, dtype=wide)
    out.copy_(staging)
    return out.numpy()


def _host_tensor(value):
    """``value`` (numpy or a scalar) as a CPU tensor, sharing its memory
    where torch can (an ml_dtypes bfloat16 array stays bfloat16)."""
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":
        # torch cannot wrap ml_dtypes arrays; their bits are torch's
        # bfloat16 bits, so reinterpret them rather than widen
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.uint16).copy()).view(
                torch.bfloat16)
    if not arr.flags.writeable:  # torch wraps only writable arrays
        arr = arr.copy()
    return torch.as_tensor(arr)


def _as_tensor(value, dtype, device):
    """``value`` (numpy, a scalar or a tensor) as a tensor of ``dtype``
    (None: its own; an ml_dtypes bfloat16 array stays bfloat16) on
    ``device``."""
    if not isinstance(value, torch.Tensor):
        value = _host_tensor(value)
    return value.to(device=device, dtype=dtype)


_NP_DTYPES = {}


def _numpy_dtype(dtype):
    """The numpy dtype :func:`_to_host` gives a tensor of ``dtype``."""
    np_dtype = _NP_DTYPES.get(dtype)
    if np_dtype is None:
        host = torch.float32 if dtype == torch.bfloat16 else dtype
        np_dtype = _NP_DTYPES[dtype] = torch.empty((), dtype=host).numpy().dtype
    return np_dtype


# ---------------------------------------------------------------------------
# Lazy fetches (a copy of the JAX package's LazyFetch, over torch tensors)
# ---------------------------------------------------------------------------


class LazyFetch:
    """A fetched value that stays on the device until first host access.

    The fast path hands these back for ``return_numpy=True``, so that
    the next step's dispatch does not wait for this step's copy to the
    host: the copy (:func:`_to_host`, through pinned memory) happens the
    first time the caller touches the value.  Any numpy-style access
    (``np.asarray``, indexing, arithmetic, attribute reads) materializes
    the host array and from then on behaves exactly like the eagerly
    converted result.  Shape and dtype come from the tensor's metadata,
    without a sync.  The tensor is the fetch's own (cloned out of a
    graph's pool, or a value no later step writes), so it reads the
    step's value whenever it is read."""

    __slots__ = ("_device_value", "_ready", "_np")

    def __init__(self, device_value):
        self._device_value = device_value
        # the producing stream's point, so that a read from another
        # thread (another current stream) copies the finished value
        self._ready = None
        if device_value.is_cuda:
            self._ready = torch.cuda.Event()
            self._ready.record(torch.cuda.current_stream(device_value.device))
        self._np = None

    def materialize(self):
        if self._np is None:
            with _obs.span("executor.fetch_materialize"):
                self._np = _to_host(self._device_value, self._ready)
            self._device_value = self._ready = None
        return self._np

    @property
    def shape(self):
        if self._np is not None:
            return self._np.shape
        return tuple(self._device_value.shape)

    @property
    def dtype(self):
        if self._np is not None:
            return self._np.dtype
        return _numpy_dtype(self._device_value.dtype)

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def size(self):
        return int(np.prod(self.shape)) if self.shape else 1

    def __array__(self, dtype=None, copy=None):
        a = self.materialize()
        if dtype is not None:
            a = a.astype(dtype)
        elif copy:
            a = a.copy()
        return a

    def __repr__(self):
        return repr(self.materialize())

    def __str__(self):
        return str(self.materialize())

    def __getattr__(self, name):
        if name in ("_np", "_device_value", "_ready"):  # copy/pickle recursion
            raise AttributeError(name)
        # anything not handled above delegates to the materialized array
        return getattr(self.materialize(), name)

    # like ndarray: __eq__ is elementwise, so not hashable
    __hash__ = None
    # numpy defers binary ops to us instead of broadcasting the wrapper
    __array_priority__ = 100.0


def _lazy_unary(name):
    def op(self):
        return getattr(self.materialize(), name)()

    op.__name__ = name
    return op


def _lazy_binary(name):
    def op(self, other):
        if isinstance(other, LazyFetch):  # ndarray would defer back to it
            other = other.materialize()
        return getattr(self.materialize(), name)(other)

    op.__name__ = name
    return op


for _name in ("__len__", "__iter__", "__float__", "__int__", "__bool__",
              "__index__", "__neg__", "__pos__", "__abs__", "__invert__",
              "__complex__"):
    setattr(LazyFetch, _name, _lazy_unary(_name))
for _name in ("__getitem__", "__eq__", "__ne__", "__lt__", "__le__",
              "__gt__", "__ge__", "__add__", "__radd__", "__sub__",
              "__rsub__", "__mul__", "__rmul__", "__truediv__",
              "__rtruediv__", "__floordiv__", "__rfloordiv__", "__mod__",
              "__rmod__", "__pow__", "__rpow__", "__matmul__",
              "__rmatmul__", "__and__", "__rand__", "__or__", "__ror__",
              "__xor__", "__rxor__", "__contains__"):
    setattr(LazyFetch, _name, _lazy_binary(_name))
del _name


def load_numpy_state(program, arrays, scope=None, device=None):
    """Put ``arrays`` (``{name: np.ndarray}``, as the JAX package's scope
    or ``paddle_tpu.jax_bridge.init_state`` gives them) into ``scope``
    (default: the global scope) as tensors on ``device`` (default: the
    card), each in its Program var's dtype.  Raises ``KeyError`` for a
    name the Program does not declare and ``ValueError`` for a shape that
    does not match the declared one (-1 matches any size)."""
    dev = resolve_device(device)
    scope = scope if scope is not None else global_scope()
    blk = program.global_block()
    staged = {}
    for name, value in arrays.items():
        if not blk.has_var(name):
            raise KeyError("load_numpy_state: %r is not a variable of the "
                           "program" % name)
        var = blk.var(name)
        shape = tuple(np.shape(value))
        declared = tuple(var.shape) if var.shape is not None else None
        if declared is not None and (len(declared) != len(shape) or any(
                d != -1 and int(d) != s for d, s in zip(declared, shape))):
            raise ValueError("load_numpy_state: %r has shape %s but the "
                             "program declares %s" % (name, shape, declared))
        staged[name] = _as_tensor(value, torch_dtype(var.dtype), dev)
    for name, t in staged.items():
        scope[name] = t


# ---------------------------------------------------------------------------
# Lowering context + block interpreter
# ---------------------------------------------------------------------------


#: Rows a block of the serving backends' blocked products (the ``mul``
#: rule, ``ops.math_ops.blocked_matmul``): each product's rows are padded
#: with zero rows to whole blocks of this many, at least two, and run as
#: one batched product, so that a request's rows meet the same product
#: shape at every bucket.  256 is one sample of Transformer-base scoring
#: (no padding there); samples of one row (an MLP or a classifier head)
#: fill two padded blocks up to a bucket of 512.  Blocks are counted in
#: rows, not samples, so any batch size has its blocks.
SERVING_BLOCK_ROWS = 256


def _mix64(*words):
    """splitmix64 over ``words``: one well-mixed 63-bit seed (the low 32
    bits are mixed as well as the high ones — a CPU generator keeps only
    those)."""
    x = 0x9E3779B97F4A7C15
    for w in words:
        x = (x ^ (int(w) & 0xFFFFFFFFFFFFFFFF)) & 0xFFFFFFFFFFFFFFFF
        x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        x ^= x >> 31
    return x >> 1


class LoweringContext:
    """The environment (var name -> tensor) of one run of a block, with
    the op-slot helpers the rules use."""

    def __init__(self, program, env, device, seed=0, step=0, is_test=False,
                 reads=None, block_rows=None, keep_names=(), mesh=None,
                 feed_names=()):
        self.program = program
        self.env = env
        self.device = device
        self.is_test = is_test
        # names the run hands back (its fetches): recompute keeps them
        # across the segment boundaries it prunes the environment at
        self.keep_names = tuple(keep_names)
        # rows a block of the ``mul`` rule's blocked product (None: one
        # product); the serving backends set SERVING_BLOCK_ROWS
        self.block_rows = block_rows
        # the Executor's mesh (``Executor.attach_mesh``; None: none
        # attached).  On a mesh of more than one rank every op goes
        # through the mesh step's dispatch (``mesh_step.MeshRun``), which
        # splits the feeds ``feed_names`` of ``env`` over the dp ranks
        self.mesh = mesh
        self.mesh_run = None
        if mesh is not None and mesh.size > 1:
            from .mesh_step import MeshRun

            self.mesh_run = MeshRun(mesh)
            self.mesh_run.split_feeds(env, program, feed_names)
        self._seed = int(seed)
        self._step = int(step)
        self._reads = reads  # names some op or fetch reads (None = all)
        self._op_pos = {}
        self.op = None  # the op whose rule runs (a failed capture names it)
        # the (seed attr, uid) key of every generator handed out, in order;
        # a bound entry keeps them to give a captured step its generators
        self.rng_keys = []
        # a captured step's generators by key (None: a fresh generator a
        # call), registered with the graph and seeded before each replay
        self.generators = None
        # draws a key made in this run: an op that runs more than once in
        # a step (a ``pipeline`` stage body) draws again under
        # ``key + ("again", n)``
        self._draws = {}
        # True while a checkpointed segment of recompute runs again in
        # the backward: its random ops then draw from generators of their
        # own, seeded as the forward's were (op_generator)
        self.recompute = False

    # RNG --------------------------------------------------------------------
    def op_generator(self, op, seed: int = 0):
        """A ``torch.Generator`` on the device for an op instance, seeded
        from its stable position in its block and the run (or, with a
        nonzero ``seed`` attr, from that seed alone, pinning the op's
        stream across runs).  In a captured step it is the entry's
        generator for the op, which the Executor seeds the same way
        before each replay: its draws start at offset 0 of that seed, as
        a fresh generator's do, so a replay draws an eager step's bits.

        The recompute pass of a checkpointed segment (``self.recompute``)
        draws from a second generator an op, keyed ``key + ("recompute",)``
        and seeded as the first: it repeats the forward's bits, in a
        captured step as well, where a second draw from one generator
        would continue its stream.  So does an op that runs again in the
        same step (a ``pipeline`` stage body runs once a stage and
        microbatch): its n-th repeat draws from a generator keyed
        ``key + ("again", n)``, seeded as the first, so every repeat
        draws the bits of the first, eager or captured."""
        key = (int(seed or 0), op.block.idx * 100003 + self._op_index(op))
        if self.recompute:
            key += ("recompute",)
        n = self._draws.get(key, 0)
        self._draws[key] = n + 1
        if n:
            key += ("again", n)
        if self.generators is not None:
            gen = self.generators.get(key)
            if gen is None:
                raise RuntimeError(
                    "op %r draws random numbers in a way the captured step "
                    "cannot repeat (a generator it did not have at bind "
                    "time)" % op.type)
            return gen
        if key not in self.rng_keys:
            self.rng_keys.append(key)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_mix64(*_rng_words(key, self._seed, self._step)))
        return gen

    def _op_index(self, op):
        pos = self._op_pos.get(id(op.block))
        if pos is None:
            pos = self._op_pos[id(op.block)] = {
                id(o): i for i, o in enumerate(op.block.ops)}
        return pos[id(op)]

    # env access -------------------------------------------------------------
    def get(self, name: str):
        try:
            return self.env[name]
        except KeyError:
            raise KeyError(
                "variable %r read before it was written — not in feed, scope, "
                "or produced by an earlier op" % name
            ) from None

    def var(self, name: str, block=None):
        block = block or self.program.global_block()
        try:
            return block.var_recursive(name)
        except KeyError:
            return None

    def reads(self, op, slot):
        """Whether any later op or fetch reads the ``slot`` output of
        ``op`` (a rule may skip computing an output nobody reads)."""
        names = op.outputs.get(slot) or []
        if self._reads is None:
            return bool(names)
        return any(n in self._reads for n in names)

    def has(self, name: str) -> bool:
        return name in self.env

    def set(self, name: str, value):
        self.env[name] = value

    # op-slot helpers --------------------------------------------------------
    def get_input(self, op, slot, default=None):
        names = op.inputs.get(slot) or []
        if not names:
            return default
        return self.get(names[0])

    def get_inputs(self, op, slot):
        return [self.get(n) for n in (op.inputs.get(slot) or [])]

    def set_output(self, op, slot, value):
        names = op.outputs.get(slot) or []
        if names:
            self._bind(names[0], value, op)

    def set_outputs(self, op, slot, values):
        for n, v in zip(op.outputs.get(slot) or [], values):
            self._bind(n, v, op)

    def _bind(self, name, value, op):
        var = self.var(name, op.block)
        if (var is not None and var.stop_gradient
                and isinstance(value, torch.Tensor)
                and value.is_floating_point()):
            value = value.detach()
        self.env[name] = value

    # lengths companions (ragged sequences) ----------------------------------
    def get_lengths(self, name: str, default=None):
        return self.env.get(name + "@LENGTHS", default)

    def set_lengths(self, name: str, lengths):
        self.env[name + "@LENGTHS"] = lengths

    def copy_lengths(self, src: str, dst: str):
        for suffix in ("@LENGTHS", "@SUBLENGTHS"):
            if src + suffix in self.env:
                self.env[dst + suffix] = self.env[src + suffix]

    # outer-level (lod level 0) companions of nested LoD: rows per outer
    # group (lod.py's nested convention)
    def get_sub_lengths(self, name: str, default=None):
        return self.env.get(name + "@SUBLENGTHS", default)

    def set_sub_lengths(self, name: str, sub_lengths):
        self.env[name + "@SUBLENGTHS"] = sub_lengths

    def child(self, env):
        """A context over ``env`` (a sub-block's environment) sharing this
        one's program, device, run seed and step, reads and block rows."""
        c = LoweringContext.__new__(LoweringContext)
        c.__dict__.update(self.__dict__)
        c.env = env
        return c


def _rng_words(key, seed, step):
    """The words :func:`_mix64` seeds an op's generator from: (seed attr,
    uid) for an op with a nonzero ``seed`` attr, else (run seed, step,
    uid).  A recompute generator's key seeds as its forward's."""
    attr, uid = key[:2]
    return (attr, uid) if attr else (seed, step, uid)


# (thread ident or None for every thread, scope) pairs: while any is
# registered, the Program op loops run each op inside ``scope(op.type)``
# (the profiler's ``record_function`` ranges, a count's op rows), and
# the autograd backward inside ``scope("backward")``
_op_scopes = []


@contextlib.contextmanager
def op_scope(scope, all_threads=False):
    """Run the Program ops of this thread (of every thread with
    ``all_threads``) inside ``scope(op_type)`` while the block lasts."""
    entry = (None if all_threads else threading.get_ident(), scope)
    _op_scopes.append(entry)
    try:
        yield
    finally:
        _op_scopes.remove(entry)


@contextlib.contextmanager
def _in_op_scopes(op_type):
    me = threading.get_ident()
    with contextlib.ExitStack() as stack:
        for thread, scope in list(_op_scopes):
            if thread is None or thread == me:
                stack.enter_context(scope(op_type))
        yield


# Ops whose rules manage the lengths companion themselves (set it, or
# deliberately drop it: sequence_pool collapses the time axis).  The
# generic propagation leaves them alone (the JAX package's set).
_LENGTH_AWARE_OPS = frozenset({
    "sequence_pool", "sequence_softmax", "sequence_conv", "sequence_expand",
    "sequence_expand_as", "sequence_concat", "sequence_reshape",
    "sequence_enumerate", "sequence_scatter", "sequence_slice",
    "sequence_pad", "sequence_unpad", "sequence_mask", "sequence_erase",
    "lod_reset", "row_conv", "lstm", "lstmp", "gru", "im2sequence"})


def _propagate_lengths(ctx, op):
    """The JAX package's generic ragged-metadata flow: when ``op`` set no
    lengths on an output, but an input carries them and the output keeps
    that input's ``[batch, time]`` leading dims, the output inherits the
    input's lengths (and nested lengths).  Reads shapes and the
    environment only: no device operation, no host read."""
    if op.type in _LENGTH_AWARE_OPS:
        return
    env = ctx.env
    for names in op.inputs.values():
        for n in names:
            lens = env.get(n + "@LENGTHS")
            v = env.get(n)
            if lens is not None and getattr(v, "ndim", 0) >= 2:
                lead, sub = tuple(v.shape[:2]), env.get(n + "@SUBLENGTHS")
                break
        else:
            continue
        break
    else:
        return
    for names in op.outputs.values():
        for n in names:
            v = env.get(n)
            if (n + "@LENGTHS" in env or getattr(v, "ndim", 0) < 2
                    or tuple(v.shape[:2]) != lead):
                continue
            env[n + "@LENGTHS"] = lens
            if sub is not None and n + "@SUBLENGTHS" not in env:
                env[n + "@SUBLENGTHS"] = sub


def _run_rule(ctx, op):
    """Run ``op``'s rule on ``ctx``, then carry lengths to its outputs
    (``_propagate_lengths``).  Every op list of the executor runs its ops
    through here: blocks, sub-blocks, recompute segments and captures.
    On a mesh of more than one rank the mesh step's dispatch decides how
    the rule runs (``mesh_step.MeshRun.run``)."""
    if ctx.mesh_run is not None:
        ctx.mesh_run.run(ctx, op, _apply_rule)
    else:
        _apply_rule(ctx, op)


def _apply_rule(ctx, op):
    if _op_scopes:
        with _in_op_scopes(op.type):
            get_rule(op.type)(ctx, op)
    else:
        get_rule(op.type)(ctx, op)
    _propagate_lengths(ctx, op)


def interpret_ops(ctx: LoweringContext, ops):
    """Run an op list in order (no backward meta-op)."""
    for op in ops:
        ctx.op = op
        _run_rule(ctx, op)


_COMPANION_SUFFIXES = ("@LENGTHS", "@SUBLENGTHS", "@ARRAY", "@ARRAYLEN")

# Ops whose rules read names spelled as their OUTPUTS: while and
# conditional_block carry variables listed only as outputs, the array
# writers extend ``<out>@ARRAY``.  Recompute keeps those names alive
# across the segment boundaries it prunes the environment at.
_READS_VIA_OUTPUTS = frozenset(
    {"while", "conditional_block", "array_write", "write_to_array",
     "array_read", "array_length", "increment", "assign"})


def _ops_read_names(ops):
    """Every environment name an op list may read: declared inputs
    (recursing into the sub-blocks of control flow, whose bodies read
    outer names the parent op does not list), the outputs of ops that
    read through their output names, and the lengths and array
    companions of all of them."""
    names = set()

    def walk(op):
        for ns in op.inputs.values():
            names.update(ns)
        sub = op.sub_block
        if op.type in _READS_VIA_OUTPUTS or sub is not None:
            for ns in op.outputs.values():
                names.update(ns)
        if sub is not None:
            for o in sub.ops:
                walk(o)

    for op in ops:
        walk(op)
    return names | {n + suf for n in names for suf in _COMPANION_SUFFIXES}


def recompute_segments(pre, n_segments):
    """The forward prefix ``pre`` cut into ``n_segments`` slices by op
    count, empty slices dropped: every slice but the last runs
    checkpointed under ``Program.enable_recompute``."""
    bounds = [len(pre) * i // n_segments for i in range(n_segments + 1)]
    return [s for s in (pre[bounds[i]:bounds[i + 1]]
                        for i in range(n_segments)) if s]


@contextlib.contextmanager
def _recompute_pass(ctx):
    """The recompute context of a checkpointed segment: the segment's
    random ops draw from their recompute generators."""
    saved, ctx.recompute = ctx.recompute, True
    try:
        yield
    finally:
        ctx.recompute = saved


def _run_recompute_segments(ctx, pre, n_segments, keep):
    """Run the forward prefix as ``n_segments`` segments
    (``Program.enable_recompute``) and return its environment, pruned.

    Each segment runs in a child context over a copy of the boundary
    environment, and only the names that later segments or ``keep``
    read come back: the boundary is what a segment's backward holds of
    it.  Every segment but the last runs under non-reentrant
    ``torch.utils.checkpoint``, which keeps no tensor the segment saves
    for its backward and runs the segment again when the backward needs
    them.  ``preserve_rng_state=False``: the random ops draw from their
    own generators, never the default ones, and the recompute pass hands
    each a generator seeded as its forward's (``op_generator``)."""
    from torch.utils.checkpoint import checkpoint

    keep = set(keep)
    keep |= {n + suf for n in keep for suf in _COMPANION_SUFFIXES}
    segments = recompute_segments(pre, n_segments)
    live_after, acc = [None] * len(segments), set(keep)
    for i in range(len(segments) - 1, -1, -1):
        live_after[i] = set(acc)
        acc |= _ops_read_names(segments[i])

    def contexts():
        return contextlib.nullcontext(), _recompute_pass(ctx)

    env = ctx.env
    for i, seg in enumerate(segments):
        def run(env_in, seg=seg):
            c2 = ctx.child(dict(env_in))
            for op in seg:
                ctx.op = c2.op = op
                _run_rule(c2, op)
            return c2.env

        if i < len(segments) - 1:
            out = checkpoint(run, env, use_reentrant=False,
                             preserve_rng_state=False, context_fn=contexts)
        else:
            out = run(env)
        env = {n: v for n, v in out.items() if n in live_after[i]}
    return env


def lower_block(ctx: LoweringContext, block):
    """Run a block, handling the single ``backward`` or ``calc_gradient``
    meta-op if present.

    The forward prefix runs once, with every variable to differentiate
    (the trainable parameters; for ``calc_gradient`` its ``Inputs``)
    bound to a leaf tensor that requires grad — an intermediate becomes
    a leaf where its op produces it, so its consumers see the leaf.
    ``torch.autograd.grad`` of the summed (float32) targets, each scaled
    by its constant ``TargetGradients`` entry where one is given, binds
    every ``<name>@GRAD`` that the clip, regularizer and optimizer ops
    read.  Those post-ops run under ``torch.no_grad``.

    Recompute (``Program.enable_recompute(n)``, ``backward`` only, when
    the prefix has at least ``n`` ops): the prefix runs as ``n``
    segments by op count (``recompute_segments``), each in a child
    context, with the environment pruned at each boundary to the names
    that later segments, the post-ops, the targets, the fetches
    (``ctx.keep_names``) and the persistables read, with their lengths
    and array companions.  Every segment but the last is checkpointed
    (non-reentrant ``torch.utils.checkpoint``): its activations are not
    kept, and ``torch.autograd.grad`` runs it again to rebuild them.
    The rerun draws the forward's random bits (each random op a second
    generator seeded as its first, ``op_generator``), and its kernels
    launch and count again (the flash forward once more for each
    attention call in those segments).  The gradients are the bits of
    the run without recompute."""
    bw_idx = None
    for i, op in enumerate(block.ops):
        if op.type in ("backward", "calc_gradient"):
            if bw_idx is not None:
                raise ValueError("multiple backward/calc_gradient ops in one block")
            bw_idx = i
    if bw_idx is None:
        with torch.no_grad():
            interpret_ops(ctx, block.ops)
        return
    pre, bop, post = block.ops[:bw_idx], block.ops[bw_idx], block.ops[bw_idx + 1:]
    no_grad = set(bop.attrs.get("no_grad_set") or ())
    tg_names = []
    if bop.type == "backward":
        target_names = [bop.inputs["Loss"][0]]
        wrt_names = [p for p in bop.attrs["parameter_list"] if p not in no_grad]
        missing = [p for p in wrt_names if p not in ctx.env]
        if missing:
            raise KeyError("parameters not initialized (run startup program first): %s" % missing)
    else:  # calc_gradient: arbitrary targets / wrt vars (feeds included)
        target_names = list(bop.inputs["Targets"])
        wrt_names = [w for w in bop.inputs["Inputs"] if w not in no_grad]
        produced = {n for o in pre for ns in o.outputs.values() for n in ns}
        missing = [w for w in wrt_names if w not in ctx.env and w not in produced]
        if missing:
            raise KeyError("calc_gradient inputs not available (feed or initialize them): %s" % missing)
        bad_targets = [t for t in target_names if t not in ctx.env and t not in produced]
        if bad_targets:
            raise KeyError("calc_gradient targets not produced by the program: %s" % bad_targets)
        tg_names = list(bop.inputs.get("TargetGradients") or [])

    # a parameter laid out over a mesh (a ShardedTensor) is a leaf a block
    leaves = {w: ctx.env[w].detach().requires_grad_(True)
              for w in wrt_names if w in ctx.env}
    cut = set(wrt_names) if bop.type == "calc_gradient" else set()
    n_segments = int(getattr(ctx.program, "_recompute_segments", 0) or 0)
    with torch.enable_grad():
        ctx.env.update(leaves)
        if not cut and n_segments > 1 and len(pre) >= n_segments:
            ctx.env = _run_recompute_segments(
                ctx, pre, n_segments,
                keep=set(target_names) | set(tg_names)
                | _ops_read_names(post) | set(ctx.keep_names)
                | ctx.program.persistable_names())
        elif not cut:
            interpret_ops(ctx, pre)
        else:
            for op in pre:
                ctx.op = op
                _run_rule(ctx, op)
                for nm in (n for ns in op.outputs.values() for n in ns):
                    if nm in cut:  # cut the graph at a wrt intermediate
                        if nm not in leaves:
                            leaves[nm] = ctx.env[nm].detach().requires_grad_(True)
                        ctx.env[nm] = leaves[nm]
        ctx.op = bop
        with (_in_op_scopes("backward") if _op_scopes
              else contextlib.nullcontext()):
            total = 0.0
            for i, t in enumerate(target_names):
                tv = ctx.env[t].float()
                if i < len(tg_names):  # a cotangent, constant w.r.t. the wrt vars
                    tv = tv * ctx.env[tg_names[i]].detach().float()
                total = total + tv.sum()
            wrt_leaves = [leaves[w] for w in wrt_names]
            flat = [t for leaf in wrt_leaves for t in tensors_of(leaf)]
            grads = iter(torch.autograd.grad(total, flat, allow_unused=True))
    for w, leaf in zip(wrt_names, wrt_leaves):
        gs = []
        for t in tensors_of(leaf):
            g = next(grads)
            if g is None:  # the targets do not reach this variable
                g = torch.zeros_like(t)
            elif g.dtype != t.dtype:
                g = g.to(t.dtype)
            gs.append(g)
        ctx.env[grad_var_name(w)] = with_tensors(leaf, gs)
        ctx.env[w] = leaf.detach()
    for i, t in enumerate(target_names):
        ctx.env[grad_var_name(t)] = (
            ctx.env[tg_names[i]].detach() if i < len(tg_names)
            else torch.ones_like(gathered(ctx.env[t])).detach())
    with torch.no_grad():
        interpret_ops(ctx, post)


# ---------------------------------------------------------------------------
# Fast-path support: counters, the guard, CUDA-graph capture
# ---------------------------------------------------------------------------


# Host-side feed conversions (a numpy array or a host tensor copied to the
# executor's device), across all executors: a feed already on the device
# never moves it.  Counters always count, telemetry on or off.
_feed_copies = _obs.counter("executor.feed_host_copy")
# LRU evictions from the graph cache (the JAX package's compiled-entry
# cache) and the bound-entry cache
_cache_evicts = _obs.counter("executor.cache_evict")
_bound_evicts = _obs.counter("executor.bound_evict")
# entry builds: a bound entry's capture, a JitStepCache miss
_compiles = _obs.counter("executor.compile")


def feed_host_copy_count():
    """Process-wide count of feeds the executors copied from the host (a
    view of the ``executor.feed_host_copy`` telemetry counter).  A feed
    that is already a tensor on the executor's device leaves it
    unchanged."""
    return _feed_copies.value


def cache_eviction_count():
    """(graph evictions, bound-entry evictions) across the process —
    views of the ``executor.cache_evict`` / ``executor.bound_evict``
    telemetry counters.  A value that keeps climbing in steady state means
    the working set of (program, feed shapes) exceeds the caps
    (``_GRAPH_CAP``, ``_BOUND_CAP``): fix the feed-shape churn (a serving
    batcher padding to its bucket ladder)."""
    return _cache_evicts.value, _bound_evicts.value


def enable_compilation_cache(cache_dir=None):
    """The JAX package's persistent XLA compilation cache has nothing to
    keep here, so this does nothing and returns False.  What the port
    compiles per process is a step's CUDA graph, which CUDA cannot save
    to disk and load in another process; the one thing it builds ahead,
    the CUDA kernels' library, is already cached across processes
    (``cuda_kernels``: the file name carries the sources' hash, and a
    finished build is reused)."""
    return False


def compile_count():
    """Entry builds across the process — a view of the
    ``executor.compile`` telemetry counter: the capture of a bound
    entry's step (a CUDA graph on the card; on the CPU the step the entry
    then runs as it is), a JitStepCache miss.  Replays do not count; a
    nonzero delta over a steady-state window means a shape escaped the
    warmed set."""
    return _compiles.value


def _nan_guard(env, old, written, persistable, fetches, device):
    """The JAX package's in-step guard (``paddle_tpu/executor.py``'s
    ``trace_step``): one verdict, ``isfinite`` of the sum of
    ``sum(g.float())`` over every floating persistable's gradient and
    every floating fetch, and each written persistable that has an old
    value of its shape and dtype gated through ``where(good, new, old)``.
    Returns (verdict, {name: gated value}), or (None, {}) when nothing is
    gated (a step that writes no state).  No host sync: the verdict stays
    a device tensor."""
    good, gated = None, {}
    with torch.no_grad():
        for n in written:
            before, after = old.get(n), env[n]
            if isinstance(before, (torch.Tensor, ShardedTensor)):
                after = _conform_like(after, before)
            if not (isinstance(before, (torch.Tensor, ShardedTensor))
                    and before.shape == after.shape
                    and before.dtype == after.dtype):
                continue
            if good is None:
                probes = [g.float().sum() for g in (
                    env.get(grad_var_name(p)) for p in persistable)
                    if isinstance(g, (torch.Tensor, ShardedTensor))
                    and g.is_floating_point()]
                probes += [f.float().sum() for f in fetches
                           if isinstance(f, torch.Tensor)
                           and f.is_floating_point()]
                good = (torch.isfinite(torch.stack(probes).sum()) if probes
                        else torch.ones((), dtype=torch.bool, device=device))
            if isinstance(before, ShardedTensor):
                gated[n] = with_tensors(before, [
                    torch.where(good.to(b.device), a, b) for a, b in zip(
                        tensors_of(after), tensors_of(before))])
            else:
                gated[n] = torch.where(good, after, before)
    return good, gated


def _conform_like(v, like):
    """``v`` laid out as the state value ``like`` is (a plain tensor, or a
    ShardedTensor of ``like``'s spec)."""
    if isinstance(like, ShardedTensor):
        return conform(v, like.mesh, like.spec)
    return gathered(v)


def _storage_ptrs(t):
    if isinstance(t, ShardedTensor):
        return t.storage_ptrs()
    return {t.untyped_storage().data_ptr()}


def _is_state_buffer(old, new):
    """Whether ``old`` is a captured step's state buffer (a tensor the
    graphs that read it update in place; the first capture that writes a
    persistable makes one and marks it) that ``new`` can be copied into."""
    if isinstance(old, ShardedTensor):
        return old._graph_state and old.same_layout(new)
    return (getattr(old, "_graph_state", False)
            and isinstance(new, torch.Tensor) and old.shape == new.shape
            and old.dtype == new.dtype and old.device == new.device)


def _is_view_of(a, b):
    """Whether tensor ``a`` reads exactly ``b``'s elements (a detached
    view of it)."""
    return (a.data_ptr() == b.data_ptr() and a.dtype == b.dtype
            and a.shape == b.shape and a.stride() == b.stride())


def _written(env, state, names):
    """The names among ``names`` whose value in ``env`` the step replaced
    (not the state tensor itself, nor a view of it)."""
    out = []
    for n in names:
        new, old = env.get(n), state.get(n)
        if (isinstance(new, (torch.Tensor, ShardedTensor)) and new is not old
                and not (isinstance(old, torch.Tensor)
                         and isinstance(new, torch.Tensor)
                         and _is_view_of(new, old))):
            out.append(n)
    return out


# PyTorch allows one capture at a time in a process
_CAPTURE_LOCK = threading.Lock()
# one capture stream for each stream that captures are made from (one a
# device on a thread that keeps the default stream, as torch.cuda.graph
# keeps): the free blocks of a private pool serve only allocations on the
# stream that freed them, so graphs that share a pool reuse its memory
# only when captured on one.  And a captured cuBLAS call keeps the
# workspace of its handle and capture stream, so graphs replayed at the
# same time on different streams (a replica pool's, each captured from
# its replica's own stream) must come from different capture streams.
# The side stream of a leased stream is leased by its holder and goes
# back with it (streams.Lease.side); this map keeps, for the life of the
# process, the side streams of the streams the lease did not hand out
# (the default stream, a caller's own)
_CAPTURE_STREAMS = {}
_UNLEASED_SIDES = _streams.Lease("capture side streams of unleased streams")


def _capture_stream(index, cur, handle):
    """The capture side stream of ``cur`` on device ``index`` for a thread
    whose cuBLAS handle is ``handle`` (the caller holds
    ``_CAPTURE_LOCK``)."""
    holder = _streams.leased(index, cur)
    if holder is not None:
        # a side stream this handle has a workspace on is preferred
        return holder.side(index, cur, handle)
    side = _CAPTURE_STREAMS.get((index, cur.cuda_stream))
    if side is None:
        side = _CAPTURE_STREAMS[index, cur.cuda_stream] = \
            _UNLEASED_SIDES.stream(index)
    return side


def _warm_blas(device):
    """Make the cuBLAS and cuBLASLt workspaces of the current stream now,
    outside any capture: PyTorch keeps one per (handle, stream) for the
    life of the process, and one first made inside a capture would come
    from, and pin, the graph's private pool."""
    a = torch.zeros((16, 16), device=device)
    torch.mm(a, a)
    torch.addmm(a[0], a, a)


def _capture(graph, device, body, current_op, pool=None):
    """Capture ``body()`` into ``graph`` on the capture stream of the
    current stream of ``device`` (``capture_error_mode="thread_local"``:
    other threads keep using the card), in the private memory pool
    ``pool`` where given (shared with the graphs captured into it
    before), and return (its result, the kernel launches its wrappers
    recorded, capture seconds, bytes the capture added to the pool).  A
    failure anywhere in ``body`` raises ``RuntimeError`` naming
    ``current_op()``: nothing falls back to eager."""
    from .parallel import flash_attention as fa

    cur = torch.cuda.current_stream(device)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    with _CAPTURE_LOCK:
        handle = torch.cuda.current_blas_handle()
        side = _capture_stream(index, cur, handle)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            _warm_blas(device)
        holder = _streams.leased(index, side)
        if holder is not None:
            holder.mark(index, side, handle)
        # the general pool's free blocks cannot serve the graph's private
        # pool; give them back so that the capture can take their memory
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        t0 = time.perf_counter()
        with torch.cuda.stream(side), fa.recording_launches(side) as launches:
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out = body()
            except BaseException as exc:
                op = current_op()
                try:
                    graph.capture_end()
                except RuntimeError:  # the failed capture's own error
                    pass
                raise RuntimeError(
                    "capturing the step as a CUDA graph failed at op %r; "
                    "a rule that waits on the host must be registered "
                    "with reads_host=True: %s"
                    % (getattr(op, "type", op), exc)) from exc
            graph.capture_end()
        seconds = time.perf_counter() - t0
        grown = torch.cuda.memory_reserved(device) - reserved
    cur.wait_stream(side)
    return out, dict(launches), seconds, grown


def _graph_refusal(program, fetch_env, fetch_names):
    """Why ``program`` cannot run as a CUDA graph, or None: the first op
    whose rule waits on the host (``registry.reads_host``), or a fetch
    that carries lengths (it is read back to build a LoDArray)."""
    for blk in program.blocks:
        for op in blk.ops:
            if reads_host(op):
                return op.type
    if any(f + "@LENGTHS" in fetch_env for f in fetch_names):
        return "lod_fetch"
    return None


def _arg_key(a):
    """What a graphed call fixes of an argument at capture: a tensor's
    shape, dtype and device, any other argument's value."""
    if isinstance(a, torch.Tensor):
        return ("tensor", tuple(a.shape), a.dtype, a.device)
    return ("value", a)


def _same_arg(key, a):
    new = _arg_key(a)
    if key[0] != new[0]:
        return False
    if key[0] == "tensor":
        return key == new
    if key[1] is a:
        return True
    try:
        return bool(key[1] == a)
    except Exception:  # an elementwise comparison (an array)
        return False


class _GraphedCall:
    """``fn`` over tensors, replayed as a CUDA graph when its arguments
    lie on the card (a JitStepCache entry).  The first call is an
    ordinary call (the warm-up), the second captures ``fn`` on static
    copies of the arguments and replays it, and every later call copies
    its arguments in, replays and returns clones of the outputs (a
    tensor, or a tuple or list of them).  Arguments on the CPU call
    ``fn`` itself.

    A graph replays the shapes and the non-tensor values it was captured
    with, so every call must pass what the first one did: tensors of the
    same shape, dtype and device, and equal other arguments.  Any other
    call raises ``ValueError``, on the CPU as well (the key of the cache
    entry is the place for what varies).

    Every tensor argument is copied into its static input at each call,
    and the graph writes the static copy, never the caller's tensor.
    So large state that ``fn`` updates in place (a KV cache's pools) must
    be closed over by ``fn`` — read from its owner inside ``fn`` — and
    never passed as an argument: as an argument it would be copied in
    full every call and the writes would land in the copy.  Nothing may
    rebind such state after the capture, which holds its address."""

    def __init__(self, fn):
        self.fn = fn
        self._graph = None
        self._warm = False
        self._keys = None
        self._static_in = self._static_out = self._launches = None
        # the capture's wall seconds and the bytes it added to the card's
        # reserved memory (its private pool), once captured
        self.capture_s = self.pool_bytes = None
        self._lock = threading.Lock()

    @property
    def captured(self):
        return self._graph is not None

    def _check(self, args):
        if self._keys is None:
            self._keys = [_arg_key(a) for a in args]
            return
        if len(args) != len(self._keys):
            raise ValueError("graphed call with %d arguments; its first "
                             "call had %d" % (len(args), len(self._keys)))
        for i, (key, a) in enumerate(zip(self._keys, args)):
            if not _same_arg(key, a):
                raise ValueError(
                    "argument %d of a graphed call is %r; its first call "
                    "fixed %r (a tensor's shape, dtype and device, any "
                    "other argument's value): put what varies in the "
                    "JitStepCache key" % (i, _arg_key(a), key))

    def __call__(self, *args):
        with self._lock:
            self._check(args)
        cuda = [a for a in args if isinstance(a, torch.Tensor) and a.is_cuda]
        if not cuda:
            return self.fn(*args)
        from .parallel import flash_attention as fa

        with self._lock:
            if not self._warm:
                self._warm = True
                return self.fn(*args)
            if self._graph is None:
                self._static_in = [a.clone() if isinstance(a, torch.Tensor)
                                   else a for a in args]
                self._graph = torch.cuda.CUDAGraph()
                (self._static_out, self._launches, self.capture_s,
                 self.pool_bytes) = _capture(
                    self._graph, cuda[0].device,
                    lambda: self.fn(*self._static_in), lambda: "callable")
            for s, a in zip(self._static_in, args):
                if isinstance(a, torch.Tensor):
                    s.copy_(a)
            self._graph.replay()
            fa.add_launches(self._launches)
            out = self._static_out
            if isinstance(out, torch.Tensor):
                return out.clone()
            return type(out)(o.clone() for o in out)


class JitStepCache:
    """Key-addressed cache of step callables outside a Program: the
    bound-program idiom (built once, replayed after) with the executor's
    counters — a key miss counts on ``executor.compile``, an LRU eviction
    on ``executor.bound_evict``.  ``build(key)`` gives the callable; on
    the card an entry replays it as a captured CUDA graph of static
    inputs (``_GraphedCall``: the first call is its warm-up, the second
    captures), on the CPU it is the callable itself.  "Zero misses after
    warm-up" is then "zero captures after warm-up"."""

    def __init__(self, build, cap=64, name="jit-step"):
        self._build = build
        self._entries = {}
        self._cap = int(cap)
        self.name = name
        self._lock = threading.Lock()

    def __len__(self):
        return len(self._entries)

    def keys(self):
        return list(self._entries)

    def items(self):
        """(key, entry) pairs, without building or LRU-touching any."""
        with self._lock:
            return list(self._entries.items())

    def clear(self):
        """Drop every entry; on the card their graphs go, and each graph's
        private pool with it.  The caller makes sure none is replaying."""
        with self._lock:
            self._entries.clear()

    def get(self, key):
        """The callable for ``key``, built (and counted as a compile) on
        first sight; hits are LRU-touched replays."""
        with self._lock:
            fn = self._entries.pop(key, None)
            if fn is None:
                _compiles.inc()
                fn = _GraphedCall(self._build(key))
                while len(self._entries) >= self._cap:
                    self._entries.pop(next(iter(self._entries)))
                    _bound_evicts.inc()
            self._entries[key] = fn  # LRU: re-insert young
            return fn


class _BoundProgram:
    """A (program, scope, fetch list, feed shapes) run resolved once and
    replayed after: the owner scope of every persistable, the run-key
    owner, a feed plan (shape, dtype and kind of each feed, and the
    dtype it becomes), the read set, the random ops' keys; from its
    second run the captured step with its static feed buffers, state
    buffers and generators, and on the card the graph with its fetch
    outputs and recorded launches.

    Scope references are WEAK: an entry never keeps a dropped scope's
    tensors alive; a dead reference is one more miss.  The program
    reference stays strong (host metadata; it keeps the id()-based key
    stable)."""

    __slots__ = ("program", "scope", "version", "chain", "feed_plan",
                 "state_owners", "key_owner", "fetch_names", "reads",
                 "persistable", "written", "rng_keys", "nan_guard", "step",
                 "graph", "static_feeds", "state", "fetch_out", "good_out",
                 "generators", "launches", "engines", "capture_s",
                 "pool_bytes", "xla")


def _scope_chain_token(scope):
    chain = []
    s = scope
    while s is not None:
        chain.append((s, s._version))
        s = s._parent
    return chain


_BOUND_MISS = object()  # sentinel: bound validation failed, take slow path


_RPC_KINDS = weakref.WeakKeyDictionary()


def _rpc_kind(program):
    """"serve" for a Program holding ``listen_and_serv``, "trainer" for
    one holding ``send`` or ``recv``, else None; kept a Program
    version."""
    kind = _RPC_KINDS.get(program)
    if kind is None or kind[0] != program.version:
        types = {op.type for op in program.global_block().ops}
        kind = (program.version,
                "serve" if "listen_and_serv" in types else
                "trainer" if types & {"send", "recv"} else None)
        _RPC_KINDS[program] = kind
    return kind[1]


def _program_tag(program):
    """The JAX package's program tag, ``<id-hex>:v<version>``."""
    return "%x:v%d" % (id(program), getattr(program, "version", 0))


def _feed_kind(val):
    """(shape, dtype, device) of a feed the fast path can take — a numpy
    array (device None), a tensor or a ShardedTensor — else None."""
    if isinstance(val, (torch.Tensor, ShardedTensor)):
        return tuple(val.shape), val.dtype, val.device
    if isinstance(val, (np.ndarray, np.generic)):
        return tuple(val.shape), val.dtype, None
    return None


def _graph_outputs(fetch_names, persistable, nan_guard, ctx, state):
    """Inside the capture: the step's fetches and guard verdict, and
    the copies of the written persistables into their state buffers.
    A fetch or new value that shares memory with a buffer about to be
    overwritten is cloned first (an ``assign`` of a parameter reads
    the parameter before its update)."""
    env = ctx.env
    fetches = [v for v, _, _ in Executor._gather_fetches(env, fetch_names)]
    written = _written(env, state, persistable)
    new = {n: _conform_like(env[n], state[n]) if n in state else env[n]
           for n in written}
    good = None
    if nan_guard:
        good, gated = _nan_guard(env, state, written, persistable, fetches,
                                 ctx.device)
        new.update(gated)
    with torch.no_grad():
        targets = set()
        for n in written:
            if n in state:
                targets |= _storage_ptrs(state[n])

        def own(t):
            if isinstance(t, ShardedTensor):
                return t.map(own)
            if t.untyped_storage().data_ptr() in targets:
                return t.clone()
            return t

        fetches = [own(v.detach()) for v in fetches]
        new = {n: own(v.detach()) for n, v in new.items()}
        for n, v in new.items():
            dst = state.get(n)
            if dst is None or dst.shape != v.shape or dst.dtype != v.dtype:
                raise RuntimeError(
                    "persistable %r changes shape or dtype in the step "
                    "(%s %s -> %s %s); a captured step updates its state "
                    "in place" % (n, None if dst is None else tuple(
                        dst.shape), None if dst is None else dst.dtype,
                                  tuple(v.shape), v.dtype))
            dst.copy_(v)
    return fetches, good


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------


#: Bound entries an Executor keeps (LRU), as the JAX package's cap.
_BOUND_CAP = 64
#: Captured entries an Executor keeps (LRU).  Its graphs share one pool,
#: so a graph beyond the first adds only its outputs and static feeds:
#: eight covers the predict ladder's four buckets, or a train/eval pair
#: with their last partial batches, with room to spare.
_GRAPH_CAP = 8


class Executor:
    """``exe = Executor(CUDAPlace(0)); exe.run(program, feed=..., fetch_list=...)``.

    ``place`` (a ``CUDAPlace``/``CPUPlace``) or ``device`` (a string or
    ``torch.device``) names where the program runs; with neither, it runs
    on the card, and raises when there is none.  ``block_rows`` (None:
    off) makes each ``mul`` run in blocks of that many rows, padded, as
    one batched product (``LoweringContext.block_rows``); the serving
    Program backend sets it (``SERVING_BLOCK_ROWS``), training never
    does.

    Memory on the card: every graph of an Executor is captured into one
    private pool, on one capture stream.  PyTorch lets graphs share a
    pool when they never run at once, and the Executor orders its
    replays on the device, one after another.  A capture reuses what the
    earlier ones freed, so the pool holds about the largest step's
    activations plus each graph's outputs: 25.6 GiB for Transformer-base
    training at 64 x 256 f32, and not a byte more for batches of 56, 48
    and 40 x 256 captured after it (chip_smoke.py's fast-path phase, on
    an H100 80GB).  The graphs of one state also share its buffers
    (``_capture``).  A new shape's first run is eager, beside the pool;
    if it runs out of memory there, the Executor drops its graphs and
    their pool and runs the step again.  Caps: ``_BOUND_CAP`` bound
    entries, ``_GRAPH_CAP`` captured ones, least recently used evicted
    first (counted by ``cache_eviction_count``).  Dropping the Executor
    frees its graphs and their pool."""

    block_rows = None

    def __init__(self, place=None, device=None):
        if place is not None and device is not None:
            raise ValueError("pass place or device, not both")
        self.device = resolve_device(place if place is not None else device)
        self._bound: dict = {}
        self._lock = threading.Lock()  # the bound-entry cache
        # captures and replays, one at a time: the graphs share one pool,
        # and each replay waits on the device for the one before it
        # (``_replayed``)
        self._graph_lock = threading.Lock()
        self._replayed = None
        # step records flow only when a sink takes them
        self._telemetry = _obs.get_telemetry()
        self._run_id = "exe-%08x" % (id(self) & 0xFFFFFFFF)
        self._run_seq = 0
        # the device-side verdict of the last nan_guard run (see
        # last_step_ok); None when the last run had none
        self._last_guard_flag = None
        # compute introspection (observability.xla_stats): the device
        # time of timed steps, and the count of each op-by-op run key
        self._clock = _xla_stats.DeviceClock()
        self._xla_cells = {}
        # bound-program dispatch: False runs every step op by op, as
        # ``use_program_cache=False`` does (ParallelExecutor.fast_path)
        self.fast_path = True
        # the mesh of attach_mesh (None: none attached), its tp rules and
        # ZeRO stage, and the state specs planned under it by program
        self._mesh = None
        self._sharding_rules = None
        self._zero_stage = 0
        self._state_plans = {}
        # the pserver connections of transpiled trainer Programs, by
        # endpoint, the times of a trainer's last send/recv round and of
        # a pserver's last apply
        self._ps_clients = {}
        self.last_pserver_round = None
        self.last_pserver_apply = None

    def attach_mesh(self, mesh_spec, sharding_rules=None, zero_stage=0,
                    devices=None):
        """Attach a device mesh (True = 1-D dp mesh over every device, or
        a (dp, tp[, sp]) tuple / {axis: size} dict —
        ``parallel_executor.build_mesh``); the single entry point used by
        ParallelExecutor, Trainer, and Inferencer.  ``devices=None`` is
        every card for an Executor on a card, the Executor's device on
        the CPU.

        ``devices`` may name one device more than once: ranks that share
        it (``["cuda:0"] * 4`` on one card, ``["cpu"] * 8`` on the CPU).
        The mesh's first rank must be on the Executor's device.  On a mesh
        of one rank the steps, their bound entries and CUDA graphs are
        those of ``run`` without a mesh, and ``sharding_rules`` and
        ``zero_stage`` change no number, as in the JAX package.  On more
        ranks a step is the mesh step (``mesh_step``): the feeds split
        over dp, the state laid out by tp, pp and ZeRO, bound and captured
        as one CUDA graph as any step is.  The bound entries (their
        graphs) and the count cells are dropped, as the JAX package drops
        what it compiled under the previous mesh."""
        from .parallel_executor import _card_devices, build_mesh

        if devices is None:
            devices = (_card_devices() if self.device.type == "cuda"
                       else [self.device])
        mesh = build_mesh(mesh_spec, devices)
        if mesh.device(0) != self.device:
            raise ValueError(
                "the mesh's first device %s is not this Executor's (%s)"
                % (mesh.device(0), self.device))
        self.close()
        self._mesh = mesh
        self._sharding_rules = sharding_rules
        self._zero_stage = int(zero_stage or 0)
        self._state_plans = {}
        return mesh

    def run(
        self,
        program: Program | None = None,
        feed: dict | None = None,
        fetch_list=None,
        feed_var_name="feed",
        fetch_var_name="fetch",
        scope: Scope | None = None,
        return_numpy: bool = True,
        use_program_cache: bool = True,
        nan_guard: bool = False,
    ):
        """Run ``program`` once: feeds cast to their declared dtypes,
        state gathered from ``scope`` (default: the global scope), the
        block run, the persistables it wrote put back, and the fetches
        returned (numpy with ``return_numpy``, else tensors on the
        device; a fetch that carries lengths, as ``beam_search_decode``'s
        do, as a ``lod.LoDArray`` on the host).

        ``use_program_cache`` lets a run bind and replay a bound entry —
        on the card, a CUDA graph from its second run — and hand back
        ``LazyFetch`` values for ``return_numpy``;
        ``use_program_cache=False`` runs the step op by op.  Both give
        the same bits.  ``nan_guard=True`` gates the step's whole state
        update on one finiteness verdict over the gradients and the
        floating fetches, computed on the device: a non-finite step
        leaves every persistable bitwise unchanged.  ``last_step_ok()``
        reads the verdict; a step that writes no state has none."""
        program = program or default_main_program()
        scope = scope or global_scope()
        feed = feed or {}
        nan_guard = bool(nan_guard)
        recording = self._telemetry.recording
        t_run0 = time.perf_counter() if recording else 0.0
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in (fetch_list or [])]

        # started py_reader pipelines feed the step when the caller passes
        # no feed (the reference's in-graph reader semantics); an exhausted
        # pipeline raises core.EOFException out of run().  Items are pulled
        # from EVERY reader before any is consumed, so one reader hitting
        # EOF pushes the others' items back instead of desynchronizing.
        # A reader-fed run is never bound: each takes the path below
        reader_fed = False
        if not feed:
            from .layers.io import program_readers

            # every registered reader is consulted: an unstarted one raises
            # the diagnostic EOF instead of the step failing on missing vars
            started = program_readers(program)
            if started:
                self._last_guard_flag = None  # an EOF reports no verdict
                pulled = []
                try:
                    for reader in started:
                        pulled.append((reader, reader.feed_dict()))
                except Exception:
                    for reader, item_feed in reversed(pulled):
                        reader._pushback.appendleft(
                            tuple(item_feed[n] for n in reader.names))
                    raise
                feed = {}
                for _, item_feed in pulled:
                    feed.update(item_feed)
                reader_fed = True

        # distributed programs: listen_and_serv blocks serving; send/recv
        # trainer programs run their compute as a bound step, then the
        # round with their pservers on the host
        rpc = _rpc_kind(program)
        if rpc is not None:
            from .transpiler import pserver_runtime

            if rpc == "serve":
                return pserver_runtime.serve(self, program, scope)
            return pserver_runtime.run_trainer_step(
                self, program, feed, fetch_list, scope,
                self._pserver_clients(program), return_numpy)

        bound_key = None
        if use_program_cache and self.fast_path and not reader_fed:
            # each feed's shape is in the key, so a batcher cycling its
            # bucket ladder keeps one entry per shape; sorted, so feed
            # dicts built in different orders share one
            bound_key = (id(program), id(scope), tuple(fetch_names),
                         nan_guard,
                         tuple(sorted((n, tuple(getattr(v, "shape", ())))
                                      for n, v in feed.items())))
            with self._lock:
                bound = self._bound.get(bound_key)
            if bound is not None:
                out = self._run_bound(bound, program, scope, feed,
                                      return_numpy, recording, t_run0)
                with self._lock:
                    self._bound.pop(bound_key, None)
                    if out is not _BOUND_MISS:
                        self._bound[bound_key] = bound  # LRU touch
                if out is not _BOUND_MISS:
                    return out

        # last_step_ok never reports an earlier run's verdict
        self._last_guard_flag = None
        with self._telemetry.span("executor.prepare_feed"):
            feeds = self._prepare_feed(program, feed)
        if resilience._feed_fault is not None:  # fault-injection harness
            feeds = resilience._feed_fault(feeds)
        state_in = self._collect_state(program, scope)
        seed, step = self._rng_state(program, scope)
        persistable = program.persistable_names()
        reads = {n for blk in program.blocks for op in blk.ops
                 for ns in op.inputs.values() for n in ns}
        reads.update(fetch_names)
        reads.update(persistable)
        # compute introspection: the first run of a key is counted (and
        # kept out of MFU), later ones are observed on its count
        xs = _xla_stats._plane.active
        timing = xs or (recording and self._telemetry.device_timing)
        cell = count_key = None
        if xs:
            count_key = (id(program), program.version, id(scope),
                         tuple(fetch_names), nan_guard,
                         tuple(sorted((n, tuple(v.shape))
                                      for n, v in feeds.items())))
            cell = self._xla_cells.get(count_key)
        counts = []

        def lower():
            ctx = LoweringContext(
                program, {**state_in, **feeds}, self.device, seed, step,
                reads=reads, block_rows=self.block_rows,
                keep_names=fetch_names, mesh=self._mesh, feed_names=feeds)
            with self._telemetry.span("executor.dispatch"):
                with f32_bf16_reduction(self.device):
                    if xs and cell is None:
                        with _xla_stats.counting(self.device) as count:
                            lower_block(ctx, program.global_block())
                        counts.append(count)
                    else:
                        lower_block(ctx, program.global_block())
            return ctx

        cuda = self.device.type == "cuda"
        profiling = _prof._active["on"]
        t_exec = (time.perf_counter() if (recording or timing or profiling)
                  else 0.0)
        window = (self._clock.start(torch.cuda.current_stream(self.device))
                  if timing and cuda else None)

        try:
            ctx = lower()
        except torch.cuda.OutOfMemoryError:
            if not self._holds_graphs():
                raise
            ctx = None
        if ctx is None:
            # this shape's eager step did not fit beside the graphs' pool:
            # give the pool back (outside the handler, whose traceback
            # holds the failed step's tensors) and run the step again
            self._drop_graphs()
            ctx = lower()
        fetches = self._gather_fetches(ctx.env, fetch_names)
        new_state = {n: ctx.env[n] for n in persistable
                     if isinstance(ctx.env.get(n), (torch.Tensor, ShardedTensor))}
        if self._multi_rank():
            # each written value laid out by its state spec again (a ZeRO
            # update's slices gathered into the parameter)
            new_state = {n: v if v is state_in.get(n) else
                         self._state_layout(program, n, v)
                         for n, v in new_state.items()}
        written = _written(ctx.env, state_in, new_state)
        if counts:
            st = counts[-1].finish(
                _program_tag(program),
                _xla_stats.tensor_bytes([*state_in.values(),
                                         *feeds.values()]),
                _xla_stats.tensor_bytes([v for v, _, _ in fetches]
                                        + [new_state[n] for n in written]))
            cell = None  # a fresh count: this run enters no MFU
            self._xla_cells.pop(count_key, None)
            while len(self._xla_cells) >= _BOUND_CAP:
                self._xla_cells.pop(next(iter(self._xla_cells)))
            self._xla_cells[count_key] = {"stats": st}
        if nan_guard:
            good, gated = _nan_guard(ctx.env, state_in, written, persistable,
                                     [v for v, _, _ in fetches], self.device)
            new_state.update(gated)
            self._last_guard_flag = good
        # the fetches first: a fetch may share memory with a state buffer
        # that the write-back below updates in place
        out = self._finalize_fetches(fetches, return_numpy,
                                     state=(state_in, new_state))
        # each persistable goes back to the scope that owns it (updates
        # through a child scope mutate the parent's var, as in the
        # reference); new names land in the local scope.  A captured
        # step's state buffer is written in place, so that the graphs
        # reading it stay bound
        for name, val in new_state.items():
            if name in written or name not in state_in:
                owner = scope._owner(name) or scope
                old = owner.vars.get(name)
                if _is_state_buffer(old, val):
                    old.copy_(val)
                else:
                    owner.vars[name] = val.detach()
        key_owner = scope._owner("__rng_key__") or scope
        key_owner.vars["__rng_key__"] = (seed, step + 1)
        execute_s = self._step_time(
            window, t_exec, cell["stats"] if cell else None, xs, timing,
            recording)
        if profiling:
            # the profiler's row: the step to the end of its device work
            if cuda:
                torch.cuda.synchronize(self.device)
            _prof.record("executor.run[prog@%x v%d]" % (
                id(program), program.version), time.perf_counter() - t_exec)

        if reader_fed:
            # not a rule that reads the host: the feed itself comes from a
            # reader queue each run
            _obs.counter("executor.graph_refused", {"op": "py_reader"}).inc()
        elif bound_key is not None:
            refused = _graph_refusal(program, ctx.env, fetch_names)
            if refused is not None:
                # a rule waits on the host: every run takes this path
                _obs.counter("executor.graph_refused", {"op": refused}).inc()
            else:
                self._bind(bound_key, program, scope, feed, feeds, state_in,
                           new_state, written, key_owner, ctx, fetch_names,
                           nan_guard, self._xla_cells.get(count_key))
        if recording:
            self._emit_step(program, time.perf_counter() - t_run0,
                            execute_s, fast_path=False, compiled=False,
                            nan_guard=nan_guard)
        return out

    def _step_time(self, window, t0, stats, xs, timing, recording):
        """The record's ``execute_s`` for a step that began at ``t0``
        (host clock) and, on the card, at the event ``window``: with
        device timing on, the device time of this executor's steps that
        completed since the last record (the step's own once the host
        has waited for it; ``sync_timing`` waits here), each observed on
        its count (``stats`` None: no MFU); else the host's wall around
        the dispatch."""
        if window is not None:
            self._clock.stop(window, torch.cuda.current_stream(self.device),
                             stats, wait=xs and _xla_stats._plane.sync)
            return self._clock.drain()
        if not (recording or timing):
            return None
        seconds = time.perf_counter() - t0
        if timing and stats is not None:
            _xla_stats.observe_stats(stats, seconds)
        return seconds

    def last_step_ok(self):
        """After a ``nan_guard=True`` run: the device-side verdict of the
        last step (True: gradients and fetches finite, update applied;
        False: non-finite, every persistable left as it was).  Reading it
        is the caller's one host sync; None when the last run had no
        guard, or wrote no state."""
        flag = self._last_guard_flag
        if flag is None:
            return None
        return bool(flag.item())

    def _emit_step(self, program, duration_s, execute_s, fast_path,
                   compiled, nan_guard):
        """One structured step record to the telemetry sinks (the caller
        gates on ``self._telemetry.recording``).  ``nan_ok`` is None by
        design: reading the device verdict would sync every step.
        ``execute_s`` is :meth:`_step_time`'s."""
        seq = self._run_seq
        self._run_seq = seq + 1
        self._telemetry.emit({
            "type": "step",
            "ts": time.time(),
            "source": "executor",
            "run_id": self._run_id,
            "program": _program_tag(program),
            "step": seq,
            "duration_s": duration_s,
            "steps_per_s": (1.0 / duration_s) if duration_s > 0 else None,
            "feed_host_copies": _feed_copies.value,
            "nan_ok": None,
            "nan_guard": nan_guard,
            "fast_path": fast_path,
            "compile": compiled,
            "execute_s": execute_s,
        })

    @staticmethod
    def _gather_fetches(env, fetch_names):
        """(value, lengths, sub lengths) of each fetch from a step's
        environment."""
        out = []
        for f in fetch_names:
            if f not in env:
                raise KeyError("fetch target %r was not produced by the "
                               "program" % f)
            out.append((gathered(env[f]), env.get(f + "@LENGTHS"),
                        env.get(f + "@SUBLENGTHS")))
        return out

    @staticmethod
    def _finalize_fetches(fetches, return_numpy, lazy=False, state=()):
        """The fetches as the caller gets them.  ``return_numpy``: numpy,
        or ``LazyFetch`` values with ``lazy``.  Else a fetch with lengths
        as a host ``LoDArray`` and the others as tensors on the device,
        each cloned where it shares memory with a tensor of the dicts in
        ``state`` (a later captured step may update that tensor in
        place)."""
        if return_numpy:
            return [LazyFetch(v) if lazy else as_numpy(v)
                    for v, _ln, _sln in fetches]
        state_mem = None
        out = []
        for v, ln, sln in fetches:
            if ln is not None:
                out.append(LoDArray(as_numpy(v), as_numpy(ln),
                                    None if sln is None else as_numpy(sln)))
                continue
            if isinstance(v, torch.Tensor):
                v = v.detach()
                if state_mem is None:
                    state_mem = {
                        t.untyped_storage().data_ptr()
                        for d in state for t in d.values()
                        if isinstance(t, torch.Tensor)}
                if v.untyped_storage().data_ptr() in state_mem:
                    v = v.clone()
            out.append(v)
        return out

    # -- fast path -----------------------------------------------------------
    def _bind(self, bound_key, program, scope, feed, feeds, state_in,
              new_state, written, key_owner, ctx, fetch_names, nan_guard,
              xla=None):
        """Create or refresh the bound entry after a run of the slow path.

        Only a settled run binds: a step that created a persistable (its
        state set differs next time), a feed that is not a plain array or
        tensor, or a ragged feed stays on the slow path."""
        if not set(new_state) <= set(state_in):
            return
        plan = {}
        for name, val in feed.items():
            kind = None if isinstance(val, LoDArray) else _feed_kind(val)
            prepared = feeds.get(name)
            if kind is None or prepared is None:
                return
            plan[name] = kind + (prepared.dtype,)
        if len(plan) != len(feeds):  # lengths companions present
            return
        b = _BoundProgram()
        b.program = program
        b.scope = weakref.ref(scope)
        b.version = program.version
        b.chain = [(weakref.ref(s), v) for s, v in _scope_chain_token(scope)]
        b.feed_plan = plan
        b.state_owners = [(n, weakref.ref(scope._owner(n))) for n in state_in]
        b.key_owner = weakref.ref(key_owner)
        b.fetch_names = tuple(fetch_names)
        b.persistable = program.persistable_names()
        b.reads = ctx._reads
        b.written = frozenset(written)
        b.rng_keys = tuple(ctx.rng_keys)
        b.nan_guard = nan_guard
        b.step = b.graph = b.state = None
        b.capture_s = b.pool_bytes = None
        b.xla = xla  # the entry's count cell ({"stats": ...}), once counted
        with self._lock:
            self._bound.pop(bound_key, None)
            while len(self._bound) >= _BOUND_CAP:
                self._bound.pop(next(iter(self._bound)))  # oldest entry
                _bound_evicts.inc()
            self._bound[bound_key] = b

    def _run_bound(self, bound, program, scope, feed, return_numpy,
                   recording=False, t_run0=0.0):
        """One step through a bound entry, or _BOUND_MISS when anything it
        rests on drifted (program edited, scope mutated or dropped, a feed
        of another shape, dtype or kind, a state var gone or replaced):
        the caller drops the entry and takes the slow path, which
        re-derives the step and binds again."""
        if bound.version != program.version or bound.scope() is not scope:
            return _BOUND_MISS
        if _prof._active["on"]:
            return _BOUND_MISS  # profiled steps run op by op, in op ranges
        xs = _xla_stats._plane.active
        count = xs and bound.xla is None
        if count and bound.step is None:
            return _BOUND_MISS  # the op-by-op run counts, then binds again
        for sref, v in bound.chain:
            s = sref()
            if s is None or s._version != v:
                return _BOUND_MISS
        plan = bound.feed_plan
        if len(feed) != len(plan):
            return _BOUND_MISS
        for name, val in feed.items():
            p = plan.get(name)
            if p is None or isinstance(val, LoDArray) or _feed_kind(val) != p[:3]:
                return _BOUND_MISS
        state_in = {}
        for name, oref in bound.state_owners:
            owner = oref()
            v = None if owner is None else owner.vars.get(name)
            if v is None or (bound.state is not None
                             and v is not bound.state[name]):
                return _BOUND_MISS
            state_in[name] = v
        key_owner = bound.key_owner()
        key = None if key_owner is None else key_owner.vars.get("__rng_key__")
        if key is None:
            return _BOUND_MISS
        seed, step = key

        if resilience._feed_fault is not None:  # fault-injection harness
            feed = resilience._feed_fault(feed)
        self._last_guard_flag = None
        compiled = bound.step is None
        timing = xs or (recording and self._telemetry.device_timing)
        # the count and the capture enter no MFU
        stats = (bound.xla["stats"] if timing and bound.xla and not count
                 and not compiled else None)
        t0 = time.perf_counter() if (recording or timing) else 0.0
        with self._telemetry.span("executor.compile" if compiled
                                  else "executor.dispatch"):
            fetches, flag, window = self._replay(
                bound, program, feed, state_in, seed, step, count, timing)
        execute_s = self._step_time(window, t0, stats, xs, timing, recording)
        self._last_guard_flag = flag
        key_owner.vars["__rng_key__"] = (seed, step + 1)
        if recording:
            self._emit_step(program, time.perf_counter() - t_run0,
                            execute_s, fast_path=True, compiled=compiled,
                            nan_guard=bound.nan_guard)
        return self._finalize_fetches([(v, None, None) for v in fetches],
                                      return_numpy, lazy=True)

    def _replay(self, bound, program, feed, state_in, seed, step,
                count=False, timing=False):
        """One step of the entry's captured step, capturing it first if
        this is the entry's second run: the feeds copied into its static
        buffers, its generators seeded for this run, then one replay of
        the graph on the card (the step itself on the CPU).  ``count``
        runs the captured step eagerly instead, under a count
        (``observability.xla_stats``), which becomes the entry's.
        Returns (the fetches, cloned out, the guard verdict or None, the
        step's start event on the card with ``timing``, else None)."""
        from .parallel import flash_attention as fa

        cuda = self.device.type == "cuda"
        window = None
        with self._graph_lock:
            if bound.step is None:
                self._capture(bound, program, state_in, seed, step)
            stream = torch.cuda.current_stream(self.device) if cuda else None
            if self._replayed is not None:
                stream.wait_event(self._replayed)
            if timing and cuda:
                window = self._clock.start(stream)
            for name, val in feed.items():
                static = bound.static_feeds[name]
                if isinstance(val, ShardedTensor):
                    # a per-rank feed list's rows, each block into its rows
                    for idx, b in val.blocks.items():
                        block_view(static, idx, val.splits()).copy_(b)
                    continue
                if (isinstance(val, torch.Tensor)
                        and val.device.type == self.device.type):
                    static.copy_(val)
                    if val.device != self.device:
                        _feed_copies.inc()
                    continue
                src = val if isinstance(val, torch.Tensor) else _host_tensor(val)
                if cuda:
                    pinned = torch.empty(static.shape, dtype=static.dtype,
                                         pin_memory=True)
                    pinned.copy_(src)
                    src = pinned
                static.copy_(src, non_blocking=cuda)
                _feed_copies.inc()
            for key, gen in bound.generators.items():
                gen.manual_seed(_mix64(*_rng_words(key, seed, step)))
            if count:
                with _xla_stats.counting(self.device) as counted:
                    outs, good = bound.step()
                st = counted.finish(
                    _program_tag(program),
                    _xla_stats.tensor_bytes([*bound.state.values(),
                                             *bound.static_feeds.values()]),
                    _xla_stats.tensor_bytes(
                        list(outs) + [bound.state[n] for n in bound.written
                                      if n in bound.state]))
                bound.xla = {"stats": st}
            elif bound.graph is not None:
                bound.graph.replay()
                fa.add_launches(bound.launches)
                _collective.add_engine_runs(bound.engines)
                outs, good = bound.fetch_out, bound.good_out
            else:
                outs, good = bound.step()
            fetches = [v.clone() for v in outs]
            flag = None if good is None else good.clone()
            if cuda:
                self._replayed = torch.cuda.Event()
                self._replayed.record(stream)
        return fetches, flag, window

    def _capture(self, bound, program, state_in, seed, step):
        """Build the entry's step and, on the card, capture it as a CUDA
        graph into the Executor's pool.  The written persistables get
        their own state buffers first (a clone each, put in the owner
        scope: a tensor handed out before never changes), unless they are
        one already (another capture's: the graphs of one state share
        its buffers), feeds get
        static buffers, each random op a generator (registered with the
        graph); the step's fetches, verdict and the copies into the state
        buffers are part of the step.  Evicts the least recently used
        captured entries beyond ``_GRAPH_CAP``."""
        dev = self.device
        with self._lock:
            captured = [k for k, b in self._bound.items()
                        if b is not bound and b.step is not None]
            evicted = captured[:max(0, len(captured) - _GRAPH_CAP + 1)]
            for k in evicted:
                del self._bound[k]
                _cache_evicts.inc()
        if evicted and self._replayed is not None:
            self._replayed.synchronize()  # no evicted graph still runs
        state = {}
        for name, oref in bound.state_owners:
            t = state_in[name]
            if name in bound.written and not _is_state_buffer(t, t):
                t = t.clone()
                t._graph_state = True
                oref().vars[name] = t
            state[name] = t
        static_feeds = {name: torch.empty(p[0], dtype=p[3], device=dev)
                        for name, p in bound.feed_plan.items()}
        generators = {key: torch.Generator(device=dev)
                      for key in bound.rng_keys}
        # the running step's context, so that a failed capture names its
        # op; cleared when the step ends, since its environment holds
        # every intermediate tensor (those of a captured step are blocks
        # of the pool that the next capture reuses)
        current = [None]
        # the step refers to neither the entry nor the Executor: the entry
        # holds it, and a cycle would keep a dropped Executor's graphs and
        # pool until the cycle collector ran
        reads, block_rows, mesh = bound.reads, self.block_rows, self._mesh
        outputs = (bound.fetch_names, bound.persistable, bound.nan_guard)

        def body():
            env = dict(state)
            env.update(static_feeds)
            ctx = current[0] = LoweringContext(
                program, env, dev, seed, step, reads=reads,
                block_rows=block_rows, keep_names=outputs[0], mesh=mesh,
                feed_names=static_feeds)
            ctx.generators = generators
            with f32_bf16_reduction(dev):
                lower_block(ctx, program.global_block())
            out = _graph_outputs(*outputs, ctx, state)
            current[0] = None
            return out

        if dev.type == "cuda":
            graph = torch.cuda.CUDAGraph()
            for key, gen in generators.items():
                graph.register_generator_state(gen)
                gen.manual_seed(_mix64(*_rng_words(key, seed, step)))
            # the pool of a graph the Executor holds; with none held, the
            # pool went with the last of them, and the capture makes one
            with self._lock:
                pool = next((b.graph.pool() for b in self._bound.values()
                             if b.graph is not None), None)
            engines = dict(_collective.ENGINE_RUNS)
            (fetch_out, good_out), launches, seconds, grown = _capture(
                graph, dev, body, lambda: getattr(current[0], "op", None),
                pool=pool)
            # the multi-rank engines the capture recorded: each replay, the
            # one that follows the capture included, counts them, as the
            # kernel wrappers' recorded launches count
            bound.engines = {k: v - engines[k]
                             for k, v in _collective.ENGINE_RUNS.items()}
            _collective.ENGINE_RUNS.update(engines)
            bound.graph, bound.fetch_out, bound.good_out = (
                graph, fetch_out, good_out)
            bound.launches, bound.capture_s, bound.pool_bytes = (
                launches, seconds, grown)
        bound.state, bound.static_feeds = state, static_feeds
        bound.generators, bound.step = generators, body
        _compiles.inc()

    def close(self):
        """Drop every bound entry (on the card their CUDA graphs, and with
        the last of them the pool they share) and the count cells of
        ``observability.xla_stats``; the next run of a Program binds and
        captures again.  Then tell the parameter servers of the trainer
        Programs this Executor ran that this trainer is done (they shut
        down, as in the reference) and close their connections."""
        clients, self._ps_clients = self._ps_clients, {}
        for c in clients.values():
            c.shutdown_server()
            c.close()
        with self._graph_lock:
            with self._lock:
                self._bound.clear()
                self._xla_cells.clear()
            if self._replayed is not None:
                self._replayed.synchronize()
                self._replayed = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _holds_graphs(self):
        with self._lock:
            return any(b.step is not None for b in self._bound.values())

    def _drop_graphs(self):
        """Drop every captured entry; on the card their graphs go, and
        with the last of them the pool they share."""
        with self._graph_lock:
            with self._lock:
                keys = [k for k, b in self._bound.items()
                        if b.step is not None]
                for k in keys:
                    del self._bound[k]
                    _cache_evicts.inc()
            if self._replayed is not None:
                self._replayed.synchronize()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- internals -----------------------------------------------------------
    def _pserver_clients(self, program):
        """This Executor's connection to each endpoint of ``program``'s
        send and recv ops, made at first use."""
        from .transpiler.pserver_runtime import PSClient

        for op in program.global_block().ops:
            if op.type in ("send", "recv"):
                for ep in op.attrs.get("endpoints", []):
                    if ep not in self._ps_clients:
                        self._ps_clients[ep] = PSClient(ep)
        return self._ps_clients

    def _prepare_feed(self, program, feed):
        out = {}
        blk = program.global_block()
        for name, val in feed.items():
            if isinstance(val, LoDArray):
                out[name + "@LENGTHS"] = _as_tensor(val.lengths, torch.int32,
                                                    self.device)
                if val.sub_lengths is not None:
                    out[name + "@SUBLENGTHS"] = _as_tensor(
                        val.sub_lengths, torch.int32, self.device)
                val = val.data
            if isinstance(val, ShardedTensor):
                # per-rank rows already on their ranks' devices
                want = (torch_dtype(blk.var(name).dtype)
                        if blk.has_var(name) and blk.var(name).dtype else None)
                out[name] = val if want in (None, val.dtype) else val.map(
                    lambda b, want=want: b.to(want))
                continue
            if not isinstance(val, torch.Tensor):
                val = np.asarray(val)
            if not (isinstance(val, torch.Tensor)
                    and val.device == self.device):
                _feed_copies.inc()
            dtype = None
            if blk.has_var(name):
                var = blk.var(name)
                self._check_feed_shape(name, var, val)
                if var.dtype is not None:
                    dtype = torch_dtype(var.dtype)
            out[name] = _as_tensor(val, dtype, self.device)
        return out

    @staticmethod
    def _check_feed_shape(name, var, arr):
        """Match the feed against the declared var shape (dynamic dims are
        -1), right-aligned, as the JAX package's executor does: leading
        dynamic dims may be omitted, a declared trailing unit dim may be
        squeezed, but the feed may never have MORE dims than declared and
        every static dim must agree."""
        declared = var.shape
        if not declared:
            return
        shape = tuple(arr.shape)

        def matches(decl):
            if len(shape) > len(decl):
                return False
            for d, a in zip(reversed(decl), reversed(shape)):
                if d != -1 and int(d) != int(a):
                    return False
            return all(d == -1 for d in decl[: len(decl) - len(shape)])

        ok = matches(declared)
        if not ok and declared[-1] == 1:
            ok = matches(declared[:-1])
        if not ok:
            raise ValueError(
                "feed %r has shape %s but the program declares %s "
                "(-1 = any); check the data layer's shape"
                % (name, shape, tuple(declared)))

    def _collect_state(self, program, scope):
        """Persistable vars resolved through the scope's ancestor chain
        (reference Scope::FindVar), as tensors on this executor's device
        in their declared dtypes."""
        state = {}
        blk = program.global_block()
        for name in program.persistable_names():
            owner = scope._owner(name)
            if owner is None or owner.vars[name] is None:
                continue
            val = owner.vars[name]
            var = blk.var(name) if blk.has_var(name) else None
            dtype = (torch_dtype(var.dtype) if var is not None and var.dtype
                     else None)
            if isinstance(val, ShardedTensor) and (
                    not self._multi_rank() or val.mesh is not self._mesh
                    or (dtype is not None and val.dtype != dtype)):
                val = val.full()  # laid out over another mesh, or none
            if (not isinstance(val, (torch.Tensor, ShardedTensor))
                    or (isinstance(val, torch.Tensor)
                        and val.device != self.device)
                    or (dtype is not None and val.dtype != dtype)):
                val = _as_tensor(val, dtype, self.device)
                owner.vars[name] = val
            state[name] = val
        if self._multi_rank():
            # the state lives laid out by its specs: each rank its block
            specs = self._plan_state(program, state)
            for name, val in state.items():
                laid = conform(val, self._mesh, specs.get(name, ()))
                if laid is not val:
                    scope._owner(name).vars[name] = state[name] = laid
        return state

    # -- meshes of more than one rank ----------------------------------------
    def _multi_rank(self):
        return self._mesh is not None and self._mesh.size > 1

    def _plan_state(self, program, state):
        """Each state value's spec under the attached mesh
        (``mesh_step.plan_state_specs``), kept for the program version."""
        from .mesh_step import plan_state_specs

        key = (id(program), program.version)
        plan = self._state_plans.get(key)
        if plan is None or not set(state) <= set(plan):
            plan = plan_state_specs(program, state, self._mesh,
                                    self._sharding_rules, self._zero_stage)
            self._state_plans[key] = plan
        return plan

    def _state_layout(self, program, name, value):
        plan = self._state_plans.get((id(program), program.version), {})
        return conform(value, self._mesh, plan.get(name, ()))

    def plan_feed_shardings(self, program, feeds):
        """The spec each feed takes under the attached mesh — ``("dp",)``
        for a declared data var whose batch divides the dp axis,
        replicated (``()``) otherwise; None without a mesh.  The JAX
        package returns ``NamedSharding``s of these specs."""
        if self._mesh is None:
            return None
        from .mesh_step import plan_feed_specs

        return plan_feed_specs(program, feeds, self._mesh)

    def state_specs(self, scope=None, program=None):
        """Each persistable's layout, as the reference's spec tuple
        (trailing Nones dropped; ``()`` replicated): of ``program``'s
        persistables where given, else of every value in ``scope``."""
        from .parallel.sharded import layout_spec

        scope = scope or global_scope()
        names = (program.persistable_names() if program is not None
                 else list(scope.vars))
        out = {}
        for n in names:
            owner = scope._owner(n)
            v = owner.vars.get(n) if owner is not None else None
            if isinstance(v, (torch.Tensor, ShardedTensor)):
                out[n] = layout_spec(v)
        return out

    def rank_state_bytes(self, scope=None, program=None):
        """Bytes of state each rank of the attached mesh holds, in rank
        order (a replicated value counts in full on every rank)."""
        scope = scope or global_scope()
        names = (program.persistable_names() if program is not None
                 else list(scope.vars))
        n_ranks = self._mesh.size if self._mesh is not None else 1
        total = [0] * n_ranks
        for n in names:
            owner = scope._owner(n)
            v = owner.vars.get(n) if owner is not None else None
            if isinstance(v, ShardedTensor):
                per = v.rank_bytes()
            elif isinstance(v, torch.Tensor):
                per = [v.nelement() * v.element_size()] * n_ranks
            else:
                continue
            total = [a + b for a, b in zip(total, per)]
        return total

    @staticmethod
    def _rng_state(program, scope):
        """(seed, run counter) for this run's random ops, kept in the
        scope as ``__rng_key__``; the seed is ``program.random_seed``, or
        a random one when that is 0, fixed at the scope's first run."""
        owner = scope._owner("__rng_key__")
        key = owner.vars["__rng_key__"] if owner is not None else None
        if key is None:
            seed = program.random_seed or np.random.randint(1, 2**31 - 1)
            return int(seed), 0
        return key
