"""Graph IR: Program / Block / Operator / Variable / Parameter.

The port's copy of the JAX package's ``paddle_tpu/framework.py`` (only
its imports differ), so a Program built here is the same graph, and
``Program.to_string()`` the same JSON, as one built there.  Semantics
match the reference Fluid program model (python/paddle/fluid/framework.py):
a Program is a list of Blocks, a Block holds Variables and a
topologically ordered list of Operators.  The port's Executor runs a
block op by op with PyTorch (see executor.py).
"""
from __future__ import annotations

import contextlib
import copy
import json
from collections import OrderedDict

import numpy as np

from . import core, unique_name

__all__ = [
    "Variable",
    "Parameter",
    "Operator",
    "Block",
    "Program",
    "default_main_program",
    "default_startup_program",
    "switch_main_program",
    "switch_startup_program",
    "program_guard",
    "name_scope",
    "grad_var_name",
    "GRAD_SUFFIX",
]

GRAD_SUFFIX = "@GRAD"
LENGTHS_SUFFIX = "@LENGTHS"


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


# Op roles, mirroring the reference's OpRole attr (framework/op_proto_maker.h)
class OpRole:
    Forward = "forward"
    Backward = "backward"
    Optimize = "optimize"
    Loss = "loss"
    RPC = "rpc"
    LRSched = "lr_sched"


class Variable:
    """A named tensor slot in a Block.

    type is one of:
      'lod_tensor'        dense (possibly padded-ragged) tensor
      'lod_tensor_array'  stacked tensor array (control flow)
      'reader'            data pipeline endpoint
      'raw'               opaque host object
    """

    def __init__(
        self,
        block: "Block",
        name: str | None = None,
        shape=None,
        dtype="float32",
        lod_level: int = 0,
        persistable: bool = False,
        stop_gradient: bool = False,
        is_data: bool = False,
        type: str = "lod_tensor",
        **kwargs,
    ):
        self.block = block
        if name is None:
            name = unique_name.generate("_generated_var")
        self.name = name
        self.shape = tuple(int(s) for s in shape) if shape is not None else None
        self.dtype = core.canonical_dtype(dtype) if dtype is not None else None
        self.lod_level = lod_level
        self._persistable = bool(persistable)
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.type = type
        self.op = None  # producing op, set by append_op

    @property
    def persistable(self):
        return self._persistable

    @persistable.setter
    def persistable(self, value):
        """Flag flips must invalidate Program.persistable_names()'s
        version-keyed cache (and with it the executor's state collection),
        so `var.persistable = True` after a first run is not silently
        ignored."""
        value = bool(value)
        if value != getattr(self, "_persistable", None):
            self._persistable = value
            prog = getattr(getattr(self, "block", None), "program", None)
            if prog is not None:
                prog._bump()

    # -- numpy-ish sugar so layers compose naturally (math_op_patch.py) ------
    def __add__(self, other):
        from .layers import math_op_patch

        return math_op_patch.binary(self, other, "elementwise_add")

    def __radd__(self, other):
        from .layers import math_op_patch

        return math_op_patch.binary(other, self, "elementwise_add")

    def __sub__(self, other):
        from .layers import math_op_patch

        return math_op_patch.binary(self, other, "elementwise_sub")

    def __rsub__(self, other):
        from .layers import math_op_patch

        return math_op_patch.binary(other, self, "elementwise_sub")

    def __mul__(self, other):
        from .layers import math_op_patch

        return math_op_patch.binary(self, other, "elementwise_mul")

    def __rmul__(self, other):
        from .layers import math_op_patch

        return math_op_patch.binary(other, self, "elementwise_mul")

    def __truediv__(self, other):
        from .layers import math_op_patch

        return math_op_patch.binary(self, other, "elementwise_div")

    def __rtruediv__(self, other):
        from .layers import math_op_patch

        return math_op_patch.binary(other, self, "elementwise_div")

    def __neg__(self):
        from .layers import math_op_patch

        return math_op_patch.scale(self, -1.0)

    def __pow__(self, other):
        from .layers import math_op_patch

        return math_op_patch.binary(self, other, "elementwise_pow")

    def __rpow__(self, other):
        from .layers import math_op_patch

        return math_op_patch.binary(other, self, "elementwise_pow")

    def __lt__(self, other):
        from .layers import math_op_patch

        return math_op_patch.compare(self, other, "less_than")

    def __le__(self, other):
        from .layers import math_op_patch

        return math_op_patch.compare(self, other, "less_equal")

    def __gt__(self, other):
        from .layers import math_op_patch

        return math_op_patch.compare(self, other, "greater_than")

    def __ge__(self, other):
        from .layers import math_op_patch

        return math_op_patch.compare(self, other, "greater_equal")

    @property
    def grad_name(self) -> str:
        return grad_var_name(self.name)

    @property
    def lengths_name(self) -> str:
        return self.name + LENGTHS_SUFFIX

    def astype(self, dtype):
        from .layers import tensor as tensor_layers

        return tensor_layers.cast(self, dtype)

    def __repr__(self):
        return "Variable(name=%s, shape=%s, dtype=%s%s%s)" % (
            self.name,
            self.shape,
            self.dtype,
            ", persistable" if self.persistable else "",
            ", lod=%d" % self.lod_level if self.lod_level else "",
        )

    __str__ = __repr__

    def to_dict(self):
        d = {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": self.dtype,
            "lod_level": self.lod_level,
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "is_data": self.is_data,
            "type": self.type,
            "is_parameter": isinstance(self, Parameter),
            "trainable": getattr(self, "trainable", None),
        }
        # tensor-array capacity changes compiled buffer sizes: it must ride
        # serialization AND the fingerprint (the executor cache key), or two
        # programs differing only in capacity share an executable
        cap = getattr(self, "capacity", None)
        if cap is not None:
            d["capacity"] = int(cap)
        # pipeline-stacked parameters carry their leading stage axis through
        # serialization (the executor's pp sharding keys off this flag)
        if getattr(self, "pp_stacked", False):
            d["pp_stacked"] = True
        # optimizer accumulators carry their tag through serialization (the
        # executor's ZeRO dp-sharding keys off this flag)
        if getattr(self, "is_optimizer_state", False):
            d["is_optimizer_state"] = True
        return d


class Parameter(Variable):
    """A persistable, trainable Variable (reference framework.py Parameter)."""

    def __init__(self, block, shape, dtype, **kwargs):
        if shape is None or any(int(s) <= 0 for s in shape):
            raise ValueError("parameter shape must be fully static and positive, got %s" % (shape,))
        kwargs.setdefault("persistable", True)
        self.trainable = kwargs.pop("trainable", True)
        self.optimize_attr = kwargs.pop("optimize_attr", {"learning_rate": 1.0})
        self.regularizer = kwargs.pop("regularizer", None)
        self.gradient_clip_attr = kwargs.pop("gradient_clip_attr", None)
        self.do_model_average = kwargs.pop("do_model_average", None)
        super().__init__(block, shape=shape, dtype=dtype, **kwargs)


class Operator:
    """One node of the graph: op type + named input/output variable lists +
    attrs.  Sub-blocks for control flow are referenced through the
    ``sub_block`` attr (a block index), as in the reference's OpDesc."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        # store variable *names*; resolve through the block on demand
        self.inputs = {k: [v.name if isinstance(v, Variable) else v for v in _as_list(vs)] for k, vs in (inputs or {}).items()}
        self.outputs = {k: [v.name if isinstance(v, Variable) else v for v in _as_list(vs)] for k, vs in (outputs or {}).items()}
        # op_role is NOT defaulted here: Block.append_op stamps the active
        # role guard's role (optimize/backward/...); absent means Forward.
        self.attrs = dict(attrs or {})

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    def input_vars(self, slot):
        return [self.block.var(n) for n in self.inputs.get(slot, [])]

    def output_vars(self, slot):
        return [self.block.var(n) for n in self.outputs.get(slot, [])]

    def all_input_names(self):
        return [n for vs in self.inputs.values() for n in vs]

    def all_output_names(self):
        return [n for vs in self.outputs.values() for n in vs]

    @property
    def sub_block(self):
        idx = self.attrs.get("sub_block")
        return None if idx is None else self.block.program.block(idx)

    def __repr__(self):
        ins = ", ".join("%s=%s" % (k, v) for k, v in self.inputs.items())
        outs = ", ".join("%s=%s" % (k, v) for k, v in self.outputs.items())
        return "{%s} = %s(%s)" % (outs, self.type, ins)

    def to_dict(self):
        attrs = {}
        for k, v in self.attrs.items():
            if isinstance(v, np.ndarray):
                attrs[k] = {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
            elif isinstance(v, (list, tuple, dict, str, int, float, bool, type(None))):
                attrs[k] = v
            else:
                attrs[k] = repr(v)
        return {"type": self.type, "inputs": self.inputs, "outputs": self.outputs, "attrs": attrs}


class Block:
    def __init__(self, program, idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: OrderedDict[str, Variable] = OrderedDict()
        self.ops: list[Operator] = []

    @property
    def parent_block(self):
        return None if self.parent_idx < 0 else self.program.block(self.parent_idx)

    # -- variables -----------------------------------------------------------
    def create_var(self, **kwargs) -> Variable:
        name = kwargs.get("name")
        if name is not None and name in self.vars:
            return self.vars[name]
        v = Variable(self, **kwargs)
        self.vars[v.name] = v
        self.program._bump()
        return v

    def create_parameter(self, **kwargs) -> Parameter:
        p = Parameter(self, **kwargs)
        # parameters always live in the root block, so the duplicate check
        # must look THERE — creating from inside a sub-block would
        # otherwise silently replace a same-named root parameter
        root = self.program.block(0)
        if p.name in self.vars or p.name in root.vars:
            raise ValueError("parameter %s already exists" % p.name)
        p.block = root
        root.vars[p.name] = p
        self.program._bump()
        return p

    def has_var(self, name: str) -> bool:
        return name in self.vars

    def has_var_recursive(self, name: str) -> bool:
        b = self
        while b is not None:
            if name in b.vars:
                return True
            b = b.parent_block
        return False

    def var(self, name: str) -> Variable:
        if name in self.vars:
            return self.vars[name]
        raise KeyError("variable %r not in block %d" % (name, self.idx))

    def var_recursive(self, name: str) -> Variable:
        b = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent_block
        raise KeyError("variable %r not found (block %d or ancestors)" % (name, self.idx))

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    # -- ops -----------------------------------------------------------------
    def append_op(self, type, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        if _role_ctx.role is not None:
            op.attrs.setdefault("op_role", _role_ctx.role)
        self.ops.append(op)
        for outs in op.outputs.values():
            for name in outs:
                if self.has_var_recursive(name):
                    self.var_recursive(name).op = op
        self.program._bump()
        return op

    def prepend_op(self, type, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.insert(0, op)
        self.program._bump()
        return op

    def remove_op(self, index: int):
        del self.ops[index]
        self.program._bump()

    def __repr__(self):
        lines = ["Block[%d] parent=%d" % (self.idx, self.parent_idx)]
        for v in self.vars.values():
            lines.append("  " + repr(v))
        for op in self.ops:
            lines.append("  " + repr(op))
        return "\n".join(lines)


class Program:
    """A full computation description: list of blocks; block 0 is global.

    Reference: framework.py Program / ProgramDesc.  ``clone(for_test=True)``
    produces the inference twin (is_test=True, backward/optimize ops pruned).
    """

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self._version = 0
        self._seed = 0
        self.random_seed = 0
        # activation recompute: >1 splits the forward prefix into that
        # many checkpointed segments (see Program.enable_recompute)
        self._recompute_segments = 0

    def enable_recompute(self, segments=4):
        """Trade FLOPs for device memory: the backward recomputes
        activations a segment at a time instead of keeping them all
        (gradient checkpointing; no reference API — Fluid v0.15 kept every
        activation).  The Executor cuts the forward prefix of a
        ``backward`` into ``segments`` slices by op count and runs every
        slice but the last under non-reentrant
        ``torch.utils.checkpoint``, keeping only the names later ops
        read at each boundary (``executor.lower_block``): the activations
        of those slices are freed after the forward and rebuilt in the
        backward, at the cost of running them twice.  The step's bits are
        those of the step without recompute, dropout included.  ``0`` or
        ``1`` switches it off; the version bump makes a bound step bind
        again."""
        self._recompute_segments = int(segments)
        self._bump()
        return self

    # executor cache invalidation
    def _bump(self):
        self._version += 1

    @property
    def version(self):
        return self._version

    def fingerprint(self):
        """Stable content hash of the program structure.  Used as the
        executor cache key — ``id(program)`` is recycled by the GC, so two
        different programs could otherwise collide in the compile cache.
        Recomputed only when the version bumps."""
        import hashlib

        cached = getattr(self, "_fingerprint_cache", None)
        if cached is not None and cached[0] == self._version:
            return cached[1]
        fp = hashlib.sha256(
            json.dumps(self.to_dict(), sort_keys=True).encode()).hexdigest()
        self._fingerprint_cache = (self._version, fp)
        return fp

    def persistable_names(self):
        """Names of every persistable var, cached until the version bumps.
        The executor reads this on every ``run()`` (state collection and
        the compiled step's new-state filter); without the cache each call
        re-walks ``list_vars()`` over all blocks."""
        cached = getattr(self, "_persistable_cache", None)
        if cached is not None and cached[0] == self._version:
            return cached[1]
        names = frozenset(v.name for v in self.list_vars() if v.persistable)
        self._persistable_cache = (self._version, names)
        return names

    def block(self, idx: int) -> Block:
        return self.blocks[idx]

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def create_block(self, parent_idx=None) -> Block:
        parent = self.current_block_idx if parent_idx is None else parent_idx
        b = Block(self, len(self.blocks), parent)
        self.blocks.append(b)
        self.current_block_idx = b.idx
        self._bump()
        return b

    def rollback(self):
        self.current_block_idx = self.current_block().parent_idx

    def list_vars(self):
        for blk in self.blocks:
            for v in blk.vars.values():
                yield v

    def all_parameters(self):
        return self.global_block().all_parameters()

    def num_ops(self):
        return sum(len(b.ops) for b in self.blocks)

    # -- transforms ----------------------------------------------------------
    def clone(self, for_test: bool = False) -> "Program":
        p = copy.deepcopy(self)
        if for_test:
            for blk in p.blocks:
                keep = []
                for op in blk.ops:
                    if op.attrs.get("op_role") in (OpRole.Backward, OpRole.Optimize, OpRole.LRSched):
                        continue
                    if op.type == "backward":
                        continue
                    if "is_test" in op.attrs:
                        op.attrs["is_test"] = True
                    if op.type in ("dropout", "batch_norm"):
                        op.attrs["is_test"] = True
                    keep.append(op)
                blk.ops = keep
        p._bump()
        return p

    def prune(self, targets) -> "Program":
        """Backward-slice block 0 to the ops needed for ``targets``
        (reference: Program.prune / framework/prune.cc). Used by
        save_inference_model."""
        target_names = set()
        for t in targets:
            target_names.add(t.name if isinstance(t, Variable) else t)
        p = self.clone(for_test=True)
        blk = p.global_block()
        needed = set(target_names)
        kept = []
        for op in reversed(blk.ops):
            produced = set(op.all_output_names())
            if produced & needed:
                kept.append(op)
                needed |= set(op.all_input_names())
                if op.sub_block is not None:
                    for sop in op.sub_block.ops:
                        needed |= set(sop.all_input_names())
        kept.reverse()
        blk.ops = kept
        used = set()

        def _collect(op):
            used.update(op.all_input_names())
            used.update(op.all_output_names())
            # a While/StaticRNN body reads outer params its parent op never
            # lists; dropping them from block 0 would strip the weights
            if op.sub_block is not None:
                for sop in op.sub_block.ops:
                    _collect(sop)

        for op in kept:
            _collect(op)
        used |= target_names
        blk.vars = OrderedDict((n, v) for n, v in blk.vars.items() if n in used)
        p._bump()
        return p

    # -- serialization -------------------------------------------------------
    def to_dict(self):
        return {
            "blocks": [
                {
                    "idx": b.idx,
                    "parent_idx": b.parent_idx,
                    "vars": [v.to_dict() for v in b.vars.values()],
                    "ops": [op.to_dict() for op in b.ops],
                }
                for b in self.blocks
            ],
        }

    def to_string(self, throw_on_error=False):
        return json.dumps(self.to_dict(), indent=1)

    @staticmethod
    def parse_from_string(s: str) -> "Program":
        """Inverse of to_string (reference Program.parse_from_string, which
        round-trips the protobuf desc; here the JSON form)."""
        return Program.from_dict(json.loads(s))

    @staticmethod
    def from_dict(d) -> "Program":
        p = Program()
        p.blocks = []
        for bd in d["blocks"]:
            b = Block(p, bd["idx"], bd["parent_idx"])
            for vd in bd["vars"]:
                vd = dict(vd)
                is_param = vd.pop("is_parameter", False)
                trainable = vd.pop("trainable", None)
                if is_param:
                    v = Parameter(b, vd.pop("shape"), vd.pop("dtype"), name=vd.pop("name"), **{k: v2 for k, v2 in vd.items() if k in ("persistable", "stop_gradient", "lod_level")})
                    if trainable is not None:
                        v.trainable = trainable
                else:
                    v = Variable(b, **{k: v2 for k, v2 in vd.items() if k in ("name", "shape", "dtype", "lod_level", "persistable", "stop_gradient", "is_data", "type")})
                if vd.get("capacity") is not None:
                    v.capacity = int(vd["capacity"])
                if vd.get("pp_stacked"):
                    v.pp_stacked = True
                if vd.get("is_optimizer_state"):
                    v.is_optimizer_state = True
                b.vars[v.name] = v
            for od in bd["ops"]:
                attrs = {}
                for k, v2 in od["attrs"].items():
                    if isinstance(v2, dict) and "__ndarray__" in v2:
                        attrs[k] = np.array(v2["__ndarray__"], dtype=v2["dtype"])
                    else:
                        attrs[k] = v2
                op = Operator(b, od["type"], {}, {}, attrs)
                op.inputs = {k: list(v2) for k, v2 in od["inputs"].items()}
                op.outputs = {k: list(v2) for k, v2 in od["outputs"].items()}
                b.ops.append(op)
            p.blocks.append(b)
        p._bump()
        return p

    def __repr__(self):
        return "\n".join(repr(b) for b in self.blocks)

    __str__ = __repr__


def _as_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


# ---------------------------------------------------------------------------
# default programs & guards (reference framework.py bottom section)
# ---------------------------------------------------------------------------

_main_program_ = Program()
_startup_program_ = Program()


def default_main_program() -> Program:
    return _main_program_


def default_startup_program() -> Program:
    return _startup_program_


def switch_main_program(p: Program) -> Program:
    global _main_program_
    old, _main_program_ = _main_program_, p
    return old


def switch_startup_program(p: Program) -> Program:
    global _startup_program_
    old, _startup_program_ = _startup_program_, p
    return old


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)


class _NameScope:
    def __init__(self):
        self.stack: list[str] = []

    def prefix(self):
        return "/".join(self.stack) + "/" if self.stack else ""


_name_scope = _NameScope()


@contextlib.contextmanager
def name_scope(prefix: str):
    _name_scope.stack.append(prefix)
    try:
        yield
    finally:
        _name_scope.stack.pop()


class _RoleCtx:
    role = None


_role_ctx = _RoleCtx()


@contextlib.contextmanager
def op_role_guard(role):
    old = _role_ctx.role
    _role_ctx.role = role
    try:
        yield
    finally:
        _role_ctx.role = old
