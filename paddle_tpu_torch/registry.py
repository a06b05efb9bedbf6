"""Op rule registry.

The port's counterpart of the JAX package's ``paddle_tpu/registry.py``:
each op type registers ONE rule that computes the op with PyTorch when
the Executor runs a block.  Rule signature::

    @register("relu")
    def _relu(ctx, op):
        x = ctx.get_input(op, "X")
        ctx.set_output(op, "Out", torch.relu(x))

``ctx`` is an ``executor.LoweringContext``; rules read inputs from the
environment and bind outputs.  Gradients are NOT registered per op:
autograd differentiates the forward prefix (see executor.lower_block).
An op with no rule raises ``NotImplementedError`` naming the op.
"""
from __future__ import annotations

RULES: dict = {}


def register(*op_types):
    def deco(fn):
        for t in op_types:
            if t in RULES:
                raise ValueError("duplicate lowering rule for op %r" % t)
            RULES[t] = fn
        return fn

    return deco


def get_rule(op_type: str):
    try:
        return RULES[op_type]
    except KeyError:
        raise NotImplementedError(
            "no lowering rule registered for op %r (registered: %d ops)" % (op_type, len(RULES))
        ) from None


def registered_ops():
    return sorted(RULES)
