"""Control-flow layers (reference: python/paddle/fluid/layers/control_flow.py).

The port's copy of the JAX package's ``paddle_tpu/layers/control_flow.py``:
the same layer functions and classes build the same Programs (``While``,
``ConditionalBlock``, ``Switch``, ``IfElse``, the comparisons,
``increment`` and the tensor arrays), and the rules of the sub-block ops
run them eagerly with torch:

* ``while`` is a Python loop.  Each iteration runs the body's ops on a
  child context over a copy of the outer environment with the carried
  values laid over it, so the body's own variables do not leak out; the
  outer variables the body writes (the op's ``Out``), the condition and
  the tensor arrays carry from one iteration to the next.  The condition
  is read on the host once an iteration (one device sync).  There is no
  cap on the iterations, as in the JAX package.
* ``conditional_block`` reads its predicate on the host and runs its body
  on a child context when it holds.  When it does not, an output the body
  would have bound and that was unbound before gets zeros of the body's
  shape, as the JAX package's ``lax.cond`` gives it (the body is run on a
  copy to learn the shape).  An array written in the body is carried out.
* A tensor array is a ``<name>@ARRAY`` buffer of ``capacity`` rows,
  allocated with zeros at its first write, and an int32 ``<name>@ARRAYLEN``
  (one past the highest index written).  A write or read past the
  capacity lands on the last row, as XLA clamps ``dynamic_update_index``.

``IfElse`` merges its two branches by mask, as the JAX package's does.
``StaticRNN``, ``DynamicRNN`` and the LoD rank-table layers wait for the
sequence ops and are not ported yet.
"""
from __future__ import annotations

import torch

from ..executor import interpret_ops
from ..framework import Variable
from ..layer_helper import LayerHelper
from ..registry import register
from . import tensor as tensor_layers

__all__ = [
    "While",
    "Switch",
    "increment",
    "array_write",
    "create_array",
    "less_than",
    "equal",
    "not_equal",
    "greater_than",
    "greater_equal",
    "less_equal",
    "array_read",
    "array_length",
    "IfElse",
    "ConditionalBlock",
    "is_empty",
]

# default capacity for tensor arrays written inside While loops; override per
# array via create_array(capacity=...) or the While(maxlen=...) attr.
DEFAULT_ARRAY_CAPACITY = 256


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(dtype=x.dtype, shape=x.shape)
    helper.append_op(type="increment", inputs={"X": [x]}, outputs={"Out": [out]}, attrs={"step": float(value)})
    return out


def less_than(x, y, force_cpu=None, cond=None, **ignored):
    helper = LayerHelper("less_than")
    if cond is None:
        cond = helper.create_variable_for_type_inference(dtype="bool", shape=x.shape)
        cond.stop_gradient = True
    helper.append_op(type="less_than", inputs={"X": [x], "Y": [y]}, outputs={"Out": [cond]})
    return cond


def equal(x, y, cond=None, **ignored):
    helper = LayerHelper("equal")
    if cond is None:
        cond = helper.create_variable_for_type_inference(dtype="bool", shape=x.shape)
        cond.stop_gradient = True
    helper.append_op(type="equal", inputs={"X": [x], "Y": [y]}, outputs={"Out": [cond]})
    return cond


def _compare(op_type, x, y, cond=None):
    helper = LayerHelper(op_type)
    if cond is None:
        cond = helper.create_variable_for_type_inference(dtype="bool", shape=x.shape)
        cond.stop_gradient = True
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]}, outputs={"Out": [cond]})
    return cond


def not_equal(x, y, cond=None, **ignored):
    return _compare("not_equal", x, y, cond)


def greater_than(x, y, cond=None, **ignored):
    return _compare("greater_than", x, y, cond)


def greater_equal(x, y, cond=None, **ignored):
    return _compare("greater_equal", x, y, cond)


def less_equal(x, y, cond=None, **ignored):
    return _compare("less_equal", x, y, cond)


def is_empty(x, cond=None, **ignored):
    helper = LayerHelper("is_empty")
    if cond is None:
        cond = helper.create_variable_for_type_inference(dtype="bool")
        cond.stop_gradient = True
    helper.append_op(type="is_empty", inputs={"X": [x]}, outputs={"Out": [cond]})
    return cond


# ---------------------------------------------------------------------------
# tensor arrays: fixed-capacity stacked buffers + an int32 length scalar
# ---------------------------------------------------------------------------


def create_array(dtype, capacity=None):
    """LoDTensorArray analog: variable of type lod_tensor_array, run as a
    (buffer[capacity, ...], length) pair allocated at its first write."""
    helper = LayerHelper("array")
    arr = helper.block.create_var(
        name=helper.name, dtype=dtype, type="lod_tensor_array"
    )
    arr.capacity = capacity or DEFAULT_ARRAY_CAPACITY
    return arr


def array_write(x, i, array=None):
    helper = LayerHelper("array_write")
    if array is None:
        array = create_array(x.dtype)
    helper.append_op(
        type="write_to_array", inputs={"X": [x], "I": [i]}, outputs={"Out": [array]}
    )
    return array


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference(dtype=array.dtype)
    helper.append_op(type="read_from_array", inputs={"X": [array], "I": [i]}, outputs={"Out": [out]})
    return out


def array_length(array):
    helper = LayerHelper("array_length")
    out = helper.create_variable_for_type_inference(dtype="int64", shape=[1], stop_gradient=True)
    helper.append_op(type="lod_array_length", inputs={"X": [array]}, outputs={"Out": [out]})
    return out


# ---------------------------------------------------------------------------
# While
# ---------------------------------------------------------------------------


class BlockGuard:
    def __init__(self, main_program):
        self.main_program = main_program

    def __enter__(self):
        self.main_program.create_block()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.main_program.rollback()
        return exc_type is None


class WhileGuard(BlockGuard):
    def __init__(self, while_op):
        super().__init__(while_op.helper.main_program)
        self.while_op = while_op

    def __enter__(self):
        self.while_op.status = While.IN_WHILE_BLOCK
        return super().__enter__()

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            return False
        self.while_op.status = While.AFTER_WHILE_BLOCK
        self.while_op._complete()
        return super().__exit__(exc_type, exc_val, exc_tb)


class While:
    """while (cond) { sub-block }.

    The carried state is every outer-block variable written inside the
    sub-block (plus tensor arrays).  Reference: control_flow.py:652 While.
    """

    BEFORE_WHILE_BLOCK = 0
    IN_WHILE_BLOCK = 1
    AFTER_WHILE_BLOCK = 2

    def __init__(self, cond, is_test=False, name=None, maxlen=None):
        self.helper = LayerHelper("while", name=name)
        self.status = While.BEFORE_WHILE_BLOCK
        if cond.dtype != "bool":
            raise TypeError("condition must be a bool variable")
        self.cond_var = cond
        self.is_test = is_test
        self.maxlen = maxlen

    def block(self):
        return WhileGuard(self)

    def _complete(self):
        main_program = self.helper.main_program
        while_block = main_program.current_block()
        parent_block = main_program.block(while_block.parent_idx)

        # maxlen: raise the capacity of every tensor array written in the
        # body (incl. nested conditionals) so long decodes don't silently
        # clamp-overwrite the last slot
        if self.maxlen:
            for an in _array_write_targets(while_block):
                blk = while_block if while_block.has_var_recursive(an) else parent_block
                if blk.has_var_recursive(an):
                    var = blk.var_recursive(an)
                    var.capacity = max(int(getattr(var, "capacity", 0) or 0),
                                       int(self.maxlen))

        # variables read from outer scope, and outer vars written inside
        inner_written = set()
        read = set()
        for op in while_block.ops:
            for name in op.all_input_names():
                read.add(name)
            for name in op.all_output_names():
                inner_written.add(name)
        x_names = sorted(
            n for n in read
            if not while_block.has_var(n) and parent_block.has_var_recursive(n)
        )
        carried = sorted(
            n for n in inner_written
            if not while_block.has_var(n) and parent_block.has_var_recursive(n)
        )
        parent_block.append_op(
            type="while",
            inputs={"X": x_names, "Condition": [self.cond_var]},
            outputs={"Out": carried},
            attrs={
                "sub_block": while_block.idx,
                "is_test": self.is_test,
                "maxlen": self.maxlen,
            },
        )


def _array_write_targets(block):
    """Tensor arrays written anywhere under ``block`` — including inside
    nested conditional/while sub-blocks (a conditional array_write one
    level down is still this loop's carried state)."""
    out = []

    def walk(blk):
        for sop in blk.ops:
            if sop.type == "write_to_array":
                an = sop.outputs["Out"][0]
                if an not in out:
                    out.append(an)
            sb = getattr(sop, "sub_block", None)
            if sb is not None:
                walk(sb)

    walk(block)
    return out


def _array_keys(block):
    """The ``@ARRAY`` and ``@ARRAYLEN`` names of every array written under
    ``block``."""
    return [an + suffix for an in _array_write_targets(block)
            for suffix in ("@ARRAY", "@ARRAYLEN")]


def _dead_after(block, keep):
    """For each op of ``block``, the block's own variables (not in
    ``keep``) that no later op of the block reads: each dies at its last
    reader, or at its writer when nothing reads it.  A nested sub-block's
    op lists what its body reads as its inputs, so it counts as a
    reader.  The loop drops them as it goes, as XLA frees dead buffers in
    the JAX package's loop body."""
    last = {}
    for i, op in enumerate(block.ops):
        for n in op.all_input_names() + op.all_output_names():
            if block.has_var(n) and n not in keep:
                last[n] = i
    dead = [[] for _ in block.ops]
    for n, i in last.items():
        dead[i].append(n)
    return dead


def _run_body(ctx, block):
    """Run ``block``'s ops on a child of ``ctx`` over a copy of its
    environment; returns that environment."""
    env = dict(ctx.env)
    interpret_ops(ctx.child(env), block.ops)
    return env


@register("while", reads_host=True)
def _while(ctx, op):
    """Run the body while the condition holds (read on the host before
    each iteration).  The carried names are the condition, the op's
    ``Out`` and the arrays the body writes; each must be bound before the
    loop, as the JAX package's ``lax.while_loop`` carry must, except an
    array's buffer, which its first write allocates.  The body's own
    variables are dropped after their last reader (``_dead_after``), so
    an iteration holds only its live values.  An array the loop
    never wrote gets the zeros buffer of the body's shape (the body run
    once on a copy), as the JAX package allocates it up front."""
    sub_block = op.sub_block
    cond_name = op.inputs["Condition"][0]
    array_names = _array_write_targets(sub_block)
    carried = [cond_name] + [n for n in op.outputs.get("Out", [])
                             if n != cond_name and n not in array_names]
    for an in array_names:
        if not ctx.has(an + "@ARRAY"):
            ctx.set(an + "@ARRAYLEN",
                    torch.zeros((), dtype=torch.int32, device=ctx.device))
    keys = carried + _array_keys(sub_block)
    state = {n: ctx.get(n) for n in carried}
    state.update({k: ctx.env[k] for k in keys[len(carried):]
                  if k in ctx.env})
    dead = _dead_after(sub_block, set(keys))
    while bool(state[cond_name].reshape(())):
        env = dict(ctx.env)
        env.update(state)
        child = ctx.child(env)
        for body_op, names in zip(sub_block.ops, dead):
            interpret_ops(child, (body_op,))
            for n in names:
                for key in (n, n + "@LENGTHS", n + "@SUBLENGTHS"):
                    env.pop(key, None)
        state = {k: env[k] for k in keys if k in env}
    ctx.env.update(state)
    unwritten = [an for an in array_names if not ctx.has(an + "@ARRAY")]
    if unwritten:
        probe = _run_body(ctx, sub_block)
        for an in unwritten:
            if an + "@ARRAY" in probe:
                ctx.set(an + "@ARRAY", torch.zeros_like(probe[an + "@ARRAY"]))


@register("write_to_array")
def _write_to_array(ctx, op):
    x = ctx.get_input(op, "X")
    i = ctx.get_input(op, "I").reshape(()).to(torch.int32)
    arr_name = op.outputs["Out"][0]
    buf_key = arr_name + "@ARRAY"
    len_key = arr_name + "@ARRAYLEN"
    if ctx.has(buf_key):
        buf = ctx.get(buf_key)
    else:
        var = ctx.var(arr_name, op.block)
        capacity = getattr(var, "capacity", None) or DEFAULT_ARRAY_CAPACITY
        buf = torch.zeros((capacity,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
    # out of place: an earlier environment (a loop's carry, a probe's
    # copy) may hold the same buffer
    row = i.clamp(0, buf.shape[0] - 1).long().reshape(1)
    ctx.set(buf_key, buf.index_copy(0, row, x.to(buf.dtype)[None]))
    cur = (ctx.get(len_key) if ctx.has(len_key)
           else torch.zeros((), dtype=torch.int32, device=x.device))
    ctx.set(len_key, torch.maximum(cur, i + 1))


@register("read_from_array")
def _read_from_array(ctx, op):
    buf = ctx.get(op.inputs["X"][0] + "@ARRAY")
    i = ctx.get_input(op, "I").reshape(())
    row = i.clamp(0, buf.shape[0] - 1).long().reshape(1)
    ctx.set_output(op, "Out", torch.index_select(buf, 0, row)[0])


@register("lod_array_length")
def _lod_array_length(ctx, op):
    ln = ctx.get(op.inputs["X"][0] + "@ARRAYLEN")
    ctx.set_output(op, "Out", ln.to(torch.int64).reshape(1))


@register("is_empty")
def _is_empty(ctx, op):
    x = ctx.get_input(op, "X")
    ctx.set_output(op, "Out", torch.full((1,), x.numel() == 0,
                                         dtype=torch.bool, device=ctx.device))


# ---------------------------------------------------------------------------
# ConditionalBlock / Switch / IfElse
# ---------------------------------------------------------------------------


class ConditionalBlockGuard(BlockGuard):
    def __init__(self, cblock):
        super().__init__(cblock.helper.main_program)
        self.cblock = cblock

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            return False
        self.cblock._complete()
        return super().__exit__(exc_type, exc_val, exc_tb)


class ConditionalBlock:
    """Run sub-block iff all inputs are true (reference
    control_flow.py:1163)."""

    def __init__(self, inputs, is_scalar_condition=False, name=None):
        for e in inputs:
            if not isinstance(e, Variable):
                raise TypeError("inputs must be Variables")
        self.inputs = inputs
        self.is_scalar_condition = is_scalar_condition
        self.helper = LayerHelper("conditional_block", name=name)

    def block(self):
        return ConditionalBlockGuard(self)

    def _complete(self):
        main_program = self.helper.main_program
        inside_block = main_program.current_block()
        parent_block = main_program.block(inside_block.parent_idx)

        inner_written = set()
        read = set()
        for op in inside_block.ops:
            read |= set(op.all_input_names())
            inner_written |= set(op.all_output_names())
        param_list = sorted(
            n for n in read if not inside_block.has_var(n) and parent_block.has_var_recursive(n)
        )
        out_list = sorted(
            n for n in inner_written if not inside_block.has_var(n) and parent_block.has_var_recursive(n)
        )
        parent_block.append_op(
            type="conditional_block",
            inputs={"Cond": self.inputs, "Input": param_list},
            outputs={"Out": out_list},
            attrs={"sub_block": inside_block.idx, "is_scalar_condition": self.is_scalar_condition},
        )


@register("conditional_block", reads_host=True)
def _conditional_block(ctx, op):
    """Run the body when every element of every ``Cond`` holds (read on
    the host) and bind its ``Out`` and arrays.  Otherwise leave the bound
    ones as they are, and give each unbound one zeros of the shape the
    body gives it."""
    conds = ctx.get_inputs(op, "Cond")
    pred = bool(torch.stack([c.reshape(-1).all() for c in conds]).all())
    keys = list(op.outputs.get("Out", []))
    keys += [k for k in _array_keys(op.sub_block) if k not in keys]
    unbound = [k for k in keys if not ctx.has(k)]
    if not pred and not unbound:
        return
    env = _run_body(ctx, op.sub_block)
    for k in keys:
        if k in env:
            if pred:
                ctx.set(k, env[k])
            elif k in unbound:
                ctx.set(k, torch.zeros_like(env[k]))


class Switch:
    """switch { case(cond): ... default: ... }
    (reference control_flow.py:1277).  Each case appends a ConditionalBlock
    on (cond & not any-previous-cond)."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self.inside_scope = False
        self.pre_not_conditions = []

    def case(self, condition):
        if not self.inside_scope:
            raise ValueError("case should be called inside with")
        from . import nn

        if len(self.pre_not_conditions) == 0:
            cond_block = ConditionalBlock([condition], is_scalar_condition=True)
            not_cond = nn.logical_not(x=condition)
            self.pre_not_conditions.append(not_cond)
        else:
            pre_cond_num = len(self.pre_not_conditions)
            pre_not_cond = self.pre_not_conditions[pre_cond_num - 1]
            new_not_cond = nn.logical_and(x=pre_not_cond, y=nn.logical_not(x=condition))
            self.pre_not_conditions.append(new_not_cond)
            cond_block = ConditionalBlock(
                [nn.logical_and(x=pre_not_cond, y=condition)], is_scalar_condition=True
            )
        return ConditionalBlockGuard(cond_block)

    def default(self):
        pre_cond_num = len(self.pre_not_conditions)
        if pre_cond_num == 0:
            raise ValueError("there should be at least one condition")
        cond_block = ConditionalBlock(
            [self.pre_not_conditions[pre_cond_num - 1]], is_scalar_condition=True
        )
        return ConditionalBlockGuard(cond_block)

    def __enter__(self):
        self.inside_scope = True
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.inside_scope = False
        return exc_type is None


class IfElse:
    """Batch-level two-way branch (reference control_flow.py:1420).

    As in the JAX package, both branches run on the full batch and their
    results merge by mask, instead of splitting the batch by the bool
    mask: the same values, static shapes."""

    OUT_IF_ELSE_BLOCKS = 0
    IN_IF_ELSE_TRUE_BLOCKS = 1
    IN_IF_ELSE_FALSE_BLOCKS = 2

    def __init__(self, cond, name=None):
        self.helper = LayerHelper("ifelse", name=name)
        self.cond = cond
        self.input_table = {}
        self.status = IfElse.OUT_IF_ELSE_BLOCKS
        self.conditional_true_block = None
        self.output_table = [[], []]  # [false_outs, true_outs]

    def input(self, x):
        if self.status == IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("input must be inside true/false blocks")
        # mask-select: x where cond matches this branch, else zeros
        from . import nn

        branch = self.status == IfElse.IN_IF_ELSE_TRUE_BLOCKS
        mask = self.cond if branch else nn.logical_not(self.cond)
        maskf = tensor_layers.cast(mask, x.dtype)
        return nn.elementwise_mul(x, maskf, axis=0)

    class _Guard:
        def __init__(self, ie, branch):
            self.ie = ie
            self.branch = branch

        def __enter__(self):
            self.ie.status = (
                IfElse.IN_IF_ELSE_TRUE_BLOCKS if self.branch else IfElse.IN_IF_ELSE_FALSE_BLOCKS
            )

        def __exit__(self, *a):
            self.ie.status = IfElse.OUT_IF_ELSE_BLOCKS
            return a[0] is None

    def true_block(self):
        return IfElse._Guard(self, True)

    def false_block(self):
        return IfElse._Guard(self, False)

    def output(self, *outs):
        if self.status == IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("output must be inside true/false blocks")
        idx = 1 if self.status == IfElse.IN_IF_ELSE_TRUE_BLOCKS else 0
        self.output_table[idx].extend(outs)

    def __call__(self):
        from . import nn

        false_outs, true_outs = self.output_table
        if len(false_outs) != len(true_outs):
            if not false_outs:
                return list(true_outs)
            if not true_outs:
                return list(false_outs)
            raise ValueError("true/false blocks must output the same arity")
        rets = []
        for f, t in zip(false_outs, true_outs):
            maskf = tensor_layers.cast(self.cond, t.dtype)
            rets.append(
                nn.elementwise_add(
                    nn.elementwise_mul(t, maskf, axis=0),
                    nn.elementwise_mul(f, nn.elementwise_sub(tensor_layers.fill_constant([1], t.dtype, 1.0), maskf), axis=0),
                )
            )
        return rets
