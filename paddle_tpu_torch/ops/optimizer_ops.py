"""Optimizer update-op rules (reference: paddle/fluid/operators/adam_op.*).

Translated from the JAX package's ``paddle_tpu/ops/optimizer_ops.py``;
only Adam's rule is ported so far (the other optimizers still build
their ops, which raise ``NotImplementedError`` when run).
The Executor runs update ops under ``torch.no_grad``; each rule binds
the updated values to the *same* variable names (ParamOut aliases
Param, as in the reference), and the Executor writes them back to the
scope.

Dtype discipline (master-weight math, as in the JAX package): all update
arithmetic runs in f32 — half-precision params/grads are upcast on read,
the new param is cast back to the param's stored dtype on write, and
accumulators are always written f32.
"""
from __future__ import annotations

import torch

from ..registry import register


def _f32(x):
    if x.dtype in (torch.bfloat16, torch.float16):
        return x.float()
    return x


def _read(ctx, op, *slots):
    """Fetch inputs upcast to f32 for the update math."""
    return [_f32(ctx.get_input(op, s)) for s in slots]


def _write_param(ctx, op, new_value, slot="ParamOut"):
    """Store the updated param in its original dtype."""
    orig = ctx.get_input(op, "Param")
    ctx.set_output(op, slot, new_value.to(orig.dtype))


def _lr(ctx, op):
    return _f32(ctx.get_input(op, "LearningRate")).reshape(())


@register("adam")
def _adam(ctx, op):
    p, g, m, v, b1p, b2p = _read(
        ctx, op, "Param", "Grad", "Moment1", "Moment2", "Beta1Pow", "Beta2Pow"
    )
    b1 = op.attrs.get("beta1", 0.9)
    b2 = op.attrs.get("beta2", 0.999)
    eps = op.attrs.get("epsilon", 1e-8)
    lr = _lr(ctx, op)
    m_new = b1 * m + (1 - b1) * g
    v_new = b2 * v + (1 - b2) * g * g
    lr_t = lr * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
    p_new = p - lr_t * m_new / (torch.sqrt(v_new) + eps)
    _write_param(ctx, op, p_new)
    ctx.set_output(op, "Moment1Out", m_new)
    ctx.set_output(op, "Moment2Out", v_new)
    ctx.set_output(op, "Beta1PowOut", b1p * b1)
    ctx.set_output(op, "Beta2PowOut", b2p * b2)
