"""The executor's step over a mesh of more than one rank.

The port's counterpart of the JAX package's SPMD step
(``paddle_tpu/executor.py``: ``plan_feed_shardings`` and the mesh
runner, which ``jax.jit`` partitions by ``NamedSharding``s and whose
collectives XLA inserts).  The port runs the same Program op by op with
the layouts made explicit (``parallel.sharded.ShardedTensor``):

- **Feeds.** A declared data var whose batch divides the ``dp`` axis is
  split on its rows over the dp ranks (:func:`plan_feed_specs`);
  anything else is replicated.
- **State.** :func:`plan_state_specs` gives each persistable its spec, as
  the JAX package's runner does: tp by ``parallel.tp.
  make_param_shardings`` (column, then row split of 2-D values over
  ``tp``; explicit rules first), ``pp_stacked`` values (and their
  accumulators) on their leading stage axis over ``pp``, and ZeRO:
  ``zero_stage`` 1 splits the tagged optimizer accumulators over ``dp``,
  3 the parameters too, each on its largest free dim that divides.  The
  scope holds each split value as a ``ShardedTensor``: each rank keeps
  its block.
- **Row-local ops run once a dp rank.**  An op whose rule is in
  :data:`ROW_LOCAL` (and whose predicate holds for its attributes and
  inputs), whose inputs derived from the batch are all split on their
  rows, runs once for each dp rank on that rank's rows (on its device);
  its outputs stay split.  Every other op sees the whole batch: its split
  inputs are gathered (a differentiable concatenation) and its rule runs
  once.  A missing entry in the table costs speed, never numbers.
- **A dp group computes its step once.**  A value split over ``tp`` (or
  by ZeRO 3 over ``dp``) is gathered where an op reads it, once a step;
  Megatron's split of the compute over the tp ranks is open speed
  (ROADMAP R-10).
- **One gradient.**  The backward meta-op takes one
  ``torch.autograd.grad`` of the global loss with respect to every
  parameter block; each rank's use of a parameter is a differentiable
  copy of it, so the gradient is the global batch's by construction.
- **Updates.**  An optimizer rule in :data:`UPDATE_OPS` whose inputs are
  split runs once a block of the finest split among its inputs of the
  parameter's shape (under ZeRO each dp rank updates its own slice), and
  the written state is then laid out by its own spec again (the
  parameters gathered).

A row-local rule that draws random numbers (:data:`DRAWS`) runs once on
the gathered batch, so that it draws ``Executor.run``'s numbers (once a
dp rank, every rank would draw rank 0's numbers: its generator is keyed
by the op's place in the Program, not by the rank), and its outputs are
split on their rows again.

The dp ranks' rows run one rank after another on the calling stream.
"""
from __future__ import annotations

import numpy as np
import torch

from .parallel.sharded import ShardedTensor, conform, gathered, normalize_spec

__all__ = ["ROW_LOCAL", "DRAWS", "UPDATE_OPS", "MeshRun", "plan_feed_specs",
           "plan_state_specs"]


def _axis(a, nd):
    a = int(a)
    return a + nd if a < 0 else a


def _ndim(v):
    return len(v.shape) if hasattr(v, "shape") else 0


def _in(op, vals, slot):
    names = op.inputs.get(slot) or []
    return vals.get(names[0]) if names else None


def _attr_free_of_rows(attr, default=None):
    """The op keeps rows apart when none of the dims its ``attr`` names is
    dim 0 of its ``X`` (a missing or empty attr: never)."""
    def pred(op, vals, split):
        dims = op.attrs.get(attr, default)
        if dims is None:
            return False
        if isinstance(dims, (int, np.integer)):
            dims = [dims]
        dims = list(dims)
        nd = _ndim(_in(op, vals, "X"))
        return bool(dims) and all(_axis(d, nd) != 0 for d in dims)
    return pred


def _softmax(op, vals, split):
    nd = _ndim(_in(op, vals, "X"))
    return _axis(op.attrs.get("axis", -1), nd) != 0


def _layer_norm(op, vals, split):
    return int(op.attrs.get("begin_norm_axis", 1)) >= 1


def _transpose(op, vals, split):
    perm = list(op.attrs.get("axis") or op.attrs.get("perm") or [])
    return bool(perm) and int(perm[0]) == 0


def _reshape(op, vals, split):
    if op.inputs.get("Shape") or op.inputs.get("ShapeTensor"):
        return False
    shape = list(op.attrs.get("shape") or [])
    return bool(shape) and int(shape[0]) in (0, -1)


def _reduce(op, vals, split):
    if op.attrs.get("reduce_all", False):
        return False
    return _attr_free_of_rows("dim")(op, vals, split)


def _concat(op, vals, split):
    nd = _ndim(_in(op, vals, "X"))
    return _axis(op.attrs.get("axis", 0), nd) != 0


def _stack(op, vals, split):
    nd = _ndim(_in(op, vals, "X")) + 1
    return _axis(op.attrs.get("axis", 0), nd) != 0


def _elementwise(op, vals, split):
    """X split on its rows, and Y split too or broadcast over them."""
    xn, yn = op.inputs["X"][0], op.inputs["Y"][0]
    if xn not in split:
        return False
    if yn in split:
        return True
    x, y = vals[xn], vals[yn]
    nx, ny = _ndim(x), _ndim(y)
    axis = int(op.attrs.get("axis", -1))
    start = nx - ny if axis == -1 else axis
    return not (start == 0 and ny > 0 and int(y.shape[0]) != 1)


def _matmul(op, vals, split):
    xn, yn = op.inputs["X"][0], op.inputs["Y"][0]
    x, y = vals[xn], vals[yn]
    if xn not in split:
        return False
    if yn in split:
        return _ndim(x) >= 3 and _ndim(y) >= 3
    if _ndim(x) >= 3:
        return _ndim(y) == 2
    return not op.attrs.get("transpose_X", False)


def _rows_only_x(op, vals, split):
    """Only X (or Ids) carries the batch: the weight must not."""
    for slot in ("Y", "W"):
        for n in op.inputs.get(slot) or []:
            if n in split:
                return False
    return True


_ELEMENTWISE = ("elementwise_add", "elementwise_sub", "elementwise_mul",
                "elementwise_div", "elementwise_max", "elementwise_min",
                "elementwise_pow", "equal", "not_equal", "less_than",
                "less_equal", "greater_than", "greater_equal", "logical_and",
                "logical_or", "logical_xor")

#: The rules that keep the rows of their batch apart, by op type: None
#: when always, else a predicate ``(op, input values, split input names)``
#: on its attributes and inputs.  An op not listed sees the whole batch.
ROW_LOCAL = {
    **{t: None for t in (
        "relu", "sigmoid", "tanh", "gelu", "exp", "log", "sqrt", "rsqrt",
        "square", "abs", "scale", "cast", "softsign", "softplus",
        "leaky_relu", "elu", "relu6", "swish", "hard_sigmoid", "logical_not",
        "sign", "floor", "ceil", "round", "reciprocal", "pow", "clip",
        "dropout", "flash_attention", "one_hot", "label_smooth",
        "softmax_with_cross_entropy", "cross_entropy",
        "sigmoid_cross_entropy_with_logits", "sum")},
    "softmax": _softmax,
    "log_softmax": _softmax,
    "layer_norm": _layer_norm,
    "transpose": _transpose,
    "transpose2": _transpose,
    "reshape": _reshape,
    "reshape2": _reshape,
    "unsqueeze": _attr_free_of_rows("axes"),
    "unsqueeze2": _attr_free_of_rows("axes"),
    "squeeze": _attr_free_of_rows("axes"),
    "squeeze2": _attr_free_of_rows("axes"),
    "slice": _attr_free_of_rows("axes"),
    "split": _concat,
    "concat": _concat,
    "stack": _stack,
    "reduce_sum": _reduce,
    "reduce_mean": _reduce,
    "reduce_max": _reduce,
    "reduce_min": _reduce,
    "reduce_prod": _reduce,
    "mul": _rows_only_x,
    "lookup_table": _rows_only_x,
    "matmul": _matmul,
    **{t: _elementwise for t in _ELEMENTWISE},
}

#: The rules of :data:`ROW_LOCAL` that draw random numbers: each runs
#: once on the gathered batch and its outputs are split on their rows.
DRAWS = frozenset({"dropout"})

#: Optimizer rules that update each element of a parameter from the same
#: element of its gradient and accumulators: they run once a block.
UPDATE_OPS = frozenset({"sgd", "momentum", "adam", "adagrad",
                        "decayed_adagrad", "adadelta", "adamax", "rmsprop",
                        "ftrl"})

_COMPANIONS = ("@LENGTHS", "@SUBLENGTHS", "@ARRAYLEN", "@ARRAY")

#: Input slots a rule reads in their layout, block by block, instead of
#: gathered: the ``pipeline`` rule hands each ``pp`` rank its own block of
#: the stacked parameters.
KEEPS_LAYOUT = {"pipeline": ("Params",)}
_ABSENT = object()


def plan_feed_specs(program, feeds, mesh):
    """Each feed's spec under ``mesh``: ``("dp",)`` for a declared data
    var whose batch divides the dp axis, replicated (``()``) otherwise —
    a coincidentally divisible non-data feed stays replicated."""
    dp = mesh.axis_size("dp")
    has_dp = "dp" in mesh.axis_names and dp > 1
    data_names = {v.name for v in program.list_vars()
                  if getattr(v, "is_data", False)}
    return {
        n: ("dp",) if (has_dp and n in data_names and _ndim(v) >= 1
                       and int(v.shape[0]) % dp == 0) else ()
        for n, v in feeds.items()}


def plan_state_specs(program, state, mesh, rules=None, zero_stage=0):
    """Each state value's spec under ``mesh``, the JAX package's runner's
    decision (see the module docstring)."""
    from .framework import Parameter
    from .parallel.tp import make_param_shardings

    shape = {n: tuple(v.shape) for n, v in state.items()}
    dp = mesh.axis_size("dp")
    if mesh.axis_size("tp") > 1:
        specs = make_param_shardings(state, mesh, rules=rules)
    else:
        specs = {n: () for n in state}
    pp = mesh.axis_size("pp")
    if pp > 1:
        stacked = {v.name for v in program.list_vars()
                   if getattr(v, "pp_stacked", False)}
        for n, s in shape.items():
            if not s or s[0] < pp or s[0] % pp:
                continue
            if n in stacked or any(n.startswith(p + "_") for p in stacked):
                specs[n] = ("pp",)
    zero = int(zero_stage or 0)
    if zero >= 1 and "dp" in mesh.axis_names and dp > 1:
        tagged = {v.name for v in program.list_vars()
                  if getattr(v, "is_optimizer_state", False)}
        if zero >= 3:
            tagged |= {v.name for v in program.list_vars()
                       if isinstance(v, Parameter)}
        for n, s in shape.items():
            if n not in tagged:
                continue
            cur = normalize_spec(specs.get(n, ()), len(s))
            for i in sorted(range(len(s)), key=lambda i: -s[i]):
                if s[i] >= dp and s[i] % dp == 0 and cur[i] is None:
                    spec = list(cur)
                    spec[i] = "dp"
                    specs[n] = tuple(spec)
                    break
    return {n: normalize_spec(s) for n, s in specs.items()}


def _batch_split(v):
    """Whether ``v`` is split on its rows over dp and whole otherwise."""
    return (isinstance(v, ShardedTensor) and v.spec[:1] == ("dp",)
            and all(a is None for a in v.spec[1:]))


class MeshRun:
    """One step's dispatch over ``mesh`` (see the module docstring):
    ``LoweringContext`` holds one while a Program runs on a mesh of more
    than one rank, and the executor's ``_run_rule`` hands it every op."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.dp = mesh.axis_size("dp")
        # the device of dp rank i: that of the first rank at dp position i
        ax = mesh.axis_names.index("dp") if "dp" in mesh.axis_names else None
        self.dp_devices = []
        for i in range(self.dp):
            r = next(r for r in range(mesh.size)
                     if ax is None or mesh.coords(r)[ax] == i)
            self.dp_devices.append(mesh.device(r))
        self.batch = set()   # names whose values derive from the batch
        self._full = {}      # name -> (value, its gathered tensor)

    def split_feeds(self, env, program, names):
        """Split the feeds ``names`` of ``env`` by :func:`plan_feed_specs`
        (a split's blocks are views of the feed) and mark every data
        feed as derived from the batch."""
        feeds = {n: env[n] for n in names if isinstance(env.get(n), torch.Tensor)}
        specs = plan_feed_specs(program, feeds, self.mesh)
        data = {v.name for v in program.list_vars() if getattr(v, "is_data", False)}
        for n in names:   # fed split already (``shard_feed_list``)
            if isinstance(env.get(n), ShardedTensor) and n in data:
                self.batch.add(n)
        for n, spec in specs.items():
            if spec:
                env[n] = ShardedTensor.from_full(feeds[n], self.mesh, spec,
                                                 copy=False)
            if n in data:
                self.batch.add(n)

    def full(self, name, v):
        """``v``'s whole value, gathered once for as long as ``name`` holds
        it."""
        hit = self._full.get(name)
        if hit is not None and hit[0] is v:
            return hit[1]
        f = v.full()
        self._full[name] = (v, f)
        return f

    def run(self, ctx, op, apply):
        """Run ``op`` on ``ctx`` by the path its inputs take; ``apply(ctx,
        op)`` runs its rule on a context."""
        env = ctx.env
        ins = [n for ns in op.inputs.values() for n in ns]
        outs = [n for ns in op.outputs.values() for n in ns]
        from_batch = any(n in self.batch for n in ins)
        if not any(isinstance(env.get(n), ShardedTensor) for n in ins):
            apply(ctx, op)
        elif op.type in UPDATE_OPS:
            self._blocks(ctx, op, apply)
        elif not self._rows(ctx, op, ins, outs, apply):
            self._whole(ctx, op, ins, outs, apply)
        if from_batch:
            self.batch.update(outs)

    # -- the three paths --------------------------------------------------
    def _rows(self, ctx, op, ins, outs, apply):
        env = ctx.env
        if op.type not in ROW_LOCAL or self.dp < 2:
            return False
        vals = {n: env.get(n) for n in ins}
        split = {n for n, v in vals.items()
                 if n in self.batch and _batch_split(v)}
        if not split:
            return False
        for n in ins:
            if n in self.batch and n not in split:
                return False   # a batch-derived value that is whole
            if any(n + c in env for c in _COMPANIONS):
                return False
        pred = ROW_LOCAL[op.type]
        if pred is not None and not pred(op, vals, split):
            return False
        if op.type in DRAWS:
            rows = int(vals[next(iter(split))].shape[0])
            self._whole(ctx, op, ins, outs, apply)
            for n in outs:
                v = env.get(n)
                if (isinstance(v, torch.Tensor) and v.ndim
                        and int(v.shape[0]) == rows):
                    env[n] = ShardedTensor.from_full(v, self.mesh, ("dp",),
                                                     copy=False)
            return True
        envs = []
        for i, dev in enumerate(self.dp_devices):
            sub = {}
            for n, v in vals.items():
                if n in split:
                    sub[n] = v.blocks[(i,) + (0,) * (v.ndim - 1)]
                elif isinstance(v, ShardedTensor):
                    f = self.full(n, v)
                    sub[n] = f if f.device == dev else f.to(dev)
                elif isinstance(v, torch.Tensor) and v.device != dev:
                    sub[n] = v.to(dev)
                else:
                    sub[n] = v
            c = ctx.child(sub)
            c.device = dev
            apply(c, op)
            envs.append(sub)
        for n in outs:
            parts = [e.get(n) for e in envs]
            if any(p is None for p in parts):
                continue
            nd = parts[0].ndim
            rows = sum(int(p.shape[0]) for p in parts)
            env[n] = ShardedTensor(
                self.mesh, ("dp",),
                {(i,) + (0,) * (nd - 1): p for i, p in enumerate(parts)},
                (rows,) + tuple(parts[0].shape[1:]))
        return True

    def _whole(self, ctx, op, ins, outs, apply):
        """The rule once, every split input gathered."""
        env = ctx.env
        if op.sub_block is not None:
            sub = dict(env)
        else:
            sub = {}
            for n in ins + outs:
                for name in (n,) + tuple(n + c for c in _COMPANIONS):
                    if name in env:
                        sub[name] = env[name]
        before = dict(sub)
        kept = {n for slot in KEEPS_LAYOUT.get(op.type, ())
                for n in op.inputs.get(slot) or []}
        for n in ins:
            v = sub.get(n)
            if isinstance(v, ShardedTensor) and n not in kept:
                sub[n] = before[n] = self.full(n, v)
        c = ctx.child(sub)
        apply(c, op)
        for n, v in sub.items():
            if before.get(n, _ABSENT) is not v:
                env[n] = v

    def _blocks(self, ctx, op, apply):
        """An update rule once a block: the inputs of the parameter's shape
        laid out by the finest split among them, the rest whole."""
        env = ctx.env
        pnames = op.inputs.get("Param") or []
        pshape = tuple(env[pnames[0]].shape) if pnames else None
        aligned = {s: ns[0] for s, ns in op.inputs.items()
                   if ns and tuple(getattr(env.get(ns[0]), "shape", ())) == pshape}
        ref = max((env[n] for n in aligned.values()
                   if isinstance(env[n], ShardedTensor)),
                  key=lambda v: len(v.blocks))
        laid = {n: conform(env[n], ref.mesh, ref.spec, copy=False)
                for n in aligned.values()}
        results = {}
        for idx, blk in ref.blocks.items():
            dev = blk.device
            sub = {}
            for ns in op.inputs.values():
                for n in ns:
                    if n in laid:
                        sub[n] = laid[n].blocks[idx]
                    else:
                        v = gathered(env[n]) if isinstance(env.get(n), ShardedTensor) else env.get(n)
                        if isinstance(v, torch.Tensor) and v.device != dev:
                            v = v.to(dev)
                        sub[n] = v
            c = ctx.child(sub)
            c.device = dev
            apply(c, op)
            results[idx] = sub
        first = next(iter(results.values()))
        for slot, ns in op.outputs.items():
            for n in ns:
                if slot.endswith("Out") and slot[:-3] in aligned:
                    env[n] = ShardedTensor(
                        ref.mesh, ref.spec,
                        {i: r[n] for i, r in results.items()}, pshape)
                elif n in first:
                    env[n] = first[n]
