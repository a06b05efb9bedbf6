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

``register(..., reads_host=True)`` marks a rule that waits on the host
during a step: it reads a device value back (``bool()``, ``int()``,
``.item()``, ``.tolist()``, ``.cpu()``) to steer its control flow, or
copies host data to the card with a synchronous copy.  A CUDA graph
cannot hold such a rule, so the Executor runs a Program that has one op
by op at every run and never binds or captures it
(``executor._graph_refusal``).  ``reads_host`` may instead be a
predicate on the op, for a rule that waits on the host only in some of
its uses (``bilinear_interp`` reads an ``OutSize`` input back, and only
when the op has one): a Program is then refused only for an op the
predicate holds for.  ``tests/test_torch_fast_path.py`` scans the rules'
sources so that an unmarked one cannot reach a capture.
"""
from __future__ import annotations

RULES: dict = {}
#: op types whose rule may wait on the host (``register(reads_host=...)``)
READS_HOST: set = set()
#: op type -> the predicate on the op, for a rule marked with one
_READS_HOST_IF: dict = {}


def register(*op_types, reads_host=False):
    def deco(fn):
        for t in op_types:
            if t in RULES:
                raise ValueError("duplicate lowering rule for op %r" % t)
            RULES[t] = fn
            if reads_host:
                READS_HOST.add(t)
            if callable(reads_host):
                _READS_HOST_IF[t] = reads_host
        return fn

    return deco


def reads_host(op) -> bool:
    """Whether the rule of ``op`` (an Operator) waits on the host during
    a step.  Given an op type, whether its rule may wait on the host in
    any use."""
    if isinstance(op, str):
        return op in READS_HOST
    pred = _READS_HOST_IF.get(op.type)
    if pred is not None:
        return bool(pred(op))
    return op.type in READS_HOST


def get_rule(op_type: str):
    try:
        return RULES[op_type]
    except KeyError:
        raise NotImplementedError(
            "no lowering rule registered for op %r (registered: %d ops)" % (op_type, len(RULES))
        ) from None


def registered_ops():
    return sorted(RULES)
