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
optimizer updates) run under ``torch.no_grad``.

State (parameters, optimizer accumulators, step counters) lives in a
``Scope`` as torch tensors on the device; persistables the step writes go
back to the scope that owns them, and fetches come back as numpy.

Random ops draw from a ``torch.Generator`` on the device, seeded from
the scope's run seed (``program.random_seed``, or a random one when that
is 0, as the JAX package does), the run counter and the op's position
in its block (the JAX package's ``LoweringContext.op_key``); a nonzero
``seed`` attr pins an op's stream across runs.

Not ported yet: the fast path (bound programs, lazy fetches, the jit step
cache), the compile cache, readers, the parameter-server runtime,
recompute, ``calc_gradient``, meshes and the telemetry hooks.  Asking
for them (``nan_guard=True``, ``Program.enable_recompute``) raises
``NotImplementedError``.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from .core import resolve_device, torch_dtype
from .framework import Program, Variable, default_main_program, grad_var_name
from .registry import get_rule

__all__ = ["Executor", "Scope", "global_scope", "scope_guard", "as_numpy",
           "load_numpy_state", "LoweringContext", "interpret_ops",
           "lower_block"]


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
    framework/scope.h, but flat — block locals never reach it)."""

    def __init__(self):
        self.vars: dict[str, object] = {}
        self.kids: list["Scope"] = []
        self._parent: "Scope | None" = None

    def new_scope(self) -> "Scope":
        """Child scope: lookups fall back to this scope (reference
        Scope::NewScope / FindVar ancestor search)."""
        kid = Scope()
        kid._parent = self
        self.kids.append(kid)
        return kid

    def drop_kids(self):
        kids, self.kids = self.kids, []
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

    def keys(self):
        return self.vars.keys()

    def drop(self):
        """Release this scope's vars and its whole subtree."""
        self.vars.clear()
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
    back as float32, since numpy has no bfloat16."""
    if isinstance(tensor, (list, tuple)):
        return [as_numpy(t) for t in tensor]
    if isinstance(tensor, torch.Tensor):
        t = tensor.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(tensor)


def _as_tensor(value, dtype, device):
    """``value`` (numpy, a scalar or a tensor) as a tensor of ``dtype``
    (None: its own) on ``device``."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=dtype)
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":  # ml_dtypes arrays: torch cannot wrap them
        arr = arr.astype(np.float32)
    elif not arr.flags.writeable:  # torch wraps only writable arrays
        arr = arr.copy()
    return torch.as_tensor(arr).to(device=device, dtype=dtype)


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
                 reads=None):
        self.program = program
        self.env = env
        self.device = device
        self.is_test = is_test
        self.mesh = None  # the port's Executor takes no mesh yet
        self._seed = int(seed)
        self._step = int(step)
        self._reads = reads  # names some op or fetch reads (None = all)
        self._op_pos = {}

    # RNG --------------------------------------------------------------------
    def op_generator(self, op, seed: int = 0):
        """A ``torch.Generator`` on the device for an op instance, seeded
        from its stable position in its block and the run (or, with a
        nonzero ``seed`` attr, from that seed alone, pinning the op's
        stream across runs)."""
        uid = op.block.idx * 100003 + self._op_index(op)
        words = (seed, uid) if seed else (self._seed, self._step, uid)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_mix64(*words))
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

    # op-slot helpers --------------------------------------------------------
    def get_input(self, op, slot, default=None):
        names = op.inputs.get(slot) or []
        if not names:
            return default
        return self.get(names[0])

    def set_output(self, op, slot, value):
        names = op.outputs.get(slot) or []
        if names:
            self._bind(names[0], value, op)

    def _bind(self, name, value, op):
        var = self.var(name, op.block)
        if (var is not None and var.stop_gradient
                and isinstance(value, torch.Tensor)
                and value.is_floating_point()):
            value = value.detach()
        self.env[name] = value


def interpret_ops(ctx: LoweringContext, ops):
    """Run an op list in order (no backward meta-op)."""
    for op in ops:
        get_rule(op.type)(ctx, op)


def lower_block(ctx: LoweringContext, block):
    """Run a block, handling the single ``backward`` meta-op if present.

    The forward prefix runs once, with every trainable parameter bound
    to a fresh leaf tensor that requires grad; ``torch.autograd.grad``
    of the summed (float32) targets gives the parameter gradients, bound
    to the ``<param>@GRAD`` names that the clip, regularizer and
    optimizer ops read.  Those post-ops run under ``torch.no_grad``."""
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
    if bop.type != "backward":
        raise NotImplementedError("calc_gradient is not ported yet")
    if int(getattr(ctx.program, "_recompute_segments", 0) or 0) > 1:
        raise NotImplementedError("recompute segments are not ported yet")
    no_grad = set(bop.attrs.get("no_grad_set") or ())
    target_names = [bop.inputs["Loss"][0]]
    wrt_names = [p for p in bop.attrs["parameter_list"] if p not in no_grad]
    missing = [p for p in wrt_names if p not in ctx.env]
    if missing:
        raise KeyError("parameters not initialized (run startup program first): %s" % missing)

    leaves = [ctx.env[p].detach().requires_grad_(True) for p in wrt_names]
    with torch.enable_grad():
        ctx.env.update(zip(wrt_names, leaves))
        interpret_ops(ctx, pre)
        total = sum(ctx.env[t].float().sum() for t in target_names)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    for p, leaf, g in zip(wrt_names, leaves, grads):
        if g is None:  # the loss does not reach this parameter
            g = torch.zeros_like(leaf)
        elif g.dtype != leaf.dtype:
            g = g.to(leaf.dtype)
        ctx.env[grad_var_name(p)] = g
        ctx.env[p] = leaf.detach()
    for t in target_names:
        ctx.env[grad_var_name(t)] = torch.ones_like(ctx.env[t]).detach()
    with torch.no_grad():
        interpret_ops(ctx, post)


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------


class Executor:
    """``exe = Executor(CUDAPlace(0)); exe.run(program, feed=..., fetch_list=...)``.

    ``place`` (a ``CUDAPlace``/``CPUPlace``) or ``device`` (a string or
    ``torch.device``) names where the program runs; with neither, it runs
    on the card, and raises when there is none."""

    def __init__(self, place=None, device=None):
        if place is not None and device is not None:
            raise ValueError("pass place or device, not both")
        self.device = resolve_device(place if place is not None else device)

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
        block run op by op, the persistables it wrote put back, and the
        fetches returned (numpy with ``return_numpy``, else tensors on the
        device).  ``use_program_cache`` is accepted for the reference's
        signature; nothing is compiled, so there is nothing to cache."""
        if nan_guard:
            raise NotImplementedError(
                "nan_guard needs the executor's fast path, which is not "
                "ported yet")
        program = program or default_main_program()
        scope = scope or global_scope()
        fetch_names = [f.name if isinstance(f, Variable) else str(f)
                       for f in (fetch_list or [])]
        feeds = self._prepare_feed(program, feed or {})
        env = self._collect_state(program, scope)
        env.update(feeds)
        seed, step = self._rng_state(program, scope)
        persistable = program.persistable_names()
        reads = {n for blk in program.blocks for op in blk.ops
                 for ns in op.inputs.values() for n in ns}
        reads.update(fetch_names)
        reads.update(persistable)
        ctx = LoweringContext(program, env, self.device, seed, step,
                              reads=reads)
        lower_block(ctx, program.global_block())
        fetches = []
        for f in fetch_names:
            if f not in ctx.env:
                raise KeyError("fetch target %r was not produced by the program" % f)
            fetches.append(ctx.env[f])
        # write each persistable back to the scope that owns it (param
        # updates through a child scope mutate the parent's param, as in
        # the reference); new names land in the local scope
        for name in persistable:
            val = ctx.env.get(name)
            if isinstance(val, torch.Tensor):
                owner = scope._owner(name) or scope
                owner.vars[name] = val.detach()
        key_owner = scope._owner("__rng_key__") or scope
        key_owner.vars["__rng_key__"] = (seed, step + 1)
        if return_numpy:
            return [as_numpy(v) for v in fetches]
        return [v.detach() if isinstance(v, torch.Tensor) else v for v in fetches]

    # -- internals -----------------------------------------------------------
    def _prepare_feed(self, program, feed):
        out = {}
        blk = program.global_block()
        for name, val in feed.items():
            if not isinstance(val, torch.Tensor):
                val = np.asarray(val)
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
            if (not isinstance(val, torch.Tensor) or val.device != self.device
                    or (dtype is not None and val.dtype != dtype)):
                val = _as_tensor(val, dtype, self.device)
                owner.vars[name] = val
            state[name] = val
        return state

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
