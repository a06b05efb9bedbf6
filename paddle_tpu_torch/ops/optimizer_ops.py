"""Optimizer update-op rules (reference: paddle/fluid/operators/
{sgd,momentum,adam,adagrad,adamax,adadelta,rmsprop,ftrl,decayed_adagrad}_op.*
and average_accumulates_op).

Translated from the JAX package's ``paddle_tpu/ops/optimizer_ops.py``,
all ten update rules.  The Executor runs update ops under
``torch.no_grad``; each rule binds
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
from .common import at_least_f32 as _f32


def _read(ctx, op, *slots):
    """Fetch inputs upcast to f32 for the update math."""
    return [_f32(ctx.get_input(op, s)) for s in slots]


def _write_param(ctx, op, new_value, slot="ParamOut"):
    """Store the updated param in its original dtype."""
    orig = ctx.get_input(op, "Param")
    ctx.set_output(op, slot, new_value.to(orig.dtype))


def _lr(ctx, op):
    return _f32(ctx.get_input(op, "LearningRate")).reshape(())


@register("sgd")
def _sgd(ctx, op):
    p, g = _read(ctx, op, "Param", "Grad")
    _write_param(ctx, op, p - _lr(ctx, op) * g)


@register("momentum")
def _momentum(ctx, op):
    p, g, v = _read(ctx, op, "Param", "Grad", "Velocity")
    mu = op.attrs["mu"]
    lr = _lr(ctx, op)
    v_new = mu * v + g
    if op.attrs.get("use_nesterov", False):
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    _write_param(ctx, op, p_new)
    ctx.set_output(op, "VelocityOut", v_new)


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


@register("adagrad")
def _adagrad(ctx, op):
    p, g, mom = _read(ctx, op, "Param", "Grad", "Moment")
    eps = op.attrs.get("epsilon", 1e-6)
    m_new = mom + g * g
    p_new = p - _lr(ctx, op) * g / (torch.sqrt(m_new) + eps)
    _write_param(ctx, op, p_new)
    ctx.set_output(op, "MomentOut", m_new)


@register("decayed_adagrad")
def _decayed_adagrad(ctx, op):
    p, g, mom = _read(ctx, op, "Param", "Grad", "Moment")
    decay = op.attrs.get("decay", 0.95)
    eps = op.attrs.get("epsilon", 1e-6)
    m_new = decay * mom + (1 - decay) * g * g
    p_new = p - _lr(ctx, op) * g / (torch.sqrt(m_new) + eps)
    _write_param(ctx, op, p_new)
    ctx.set_output(op, "MomentOut", m_new)


@register("adadelta")
def _adadelta(ctx, op):
    p, g, avg_sq_g, avg_sq_u = _read(
        ctx, op, "Param", "Grad", "AvgSquaredGrad", "AvgSquaredUpdate"
    )
    rho = op.attrs.get("rho", 0.95)
    eps = op.attrs.get("epsilon", 1e-6)
    g2 = rho * avg_sq_g + (1 - rho) * g * g
    upd = torch.sqrt(avg_sq_u + eps) / torch.sqrt(g2 + eps) * g
    u2 = rho * avg_sq_u + (1 - rho) * upd * upd
    _write_param(ctx, op, p - upd)
    ctx.set_output(op, "AvgSquaredGradOut", g2)
    ctx.set_output(op, "AvgSquaredUpdateOut", u2)


@register("adamax")
def _adamax(ctx, op):
    p, g, m, inf_norm, b1p = _read(
        ctx, op, "Param", "Grad", "Moment", "InfNorm", "Beta1Pow"
    )
    b1 = op.attrs.get("beta1", 0.9)
    b2 = op.attrs.get("beta2", 0.999)
    eps = op.attrs.get("epsilon", 1e-8)
    lr = _lr(ctx, op)
    m_new = b1 * m + (1 - b1) * g
    n_new = torch.maximum(b2 * inf_norm, torch.abs(g))
    p_new = p - (lr / (1 - b1p.reshape(()))) * m_new / (n_new + eps)
    _write_param(ctx, op, p_new)
    ctx.set_output(op, "MomentOut", m_new)
    ctx.set_output(op, "InfNormOut", n_new)


@register("rmsprop")
def _rmsprop(ctx, op):
    p, g, ms, mom = _read(ctx, op, "Param", "Grad", "MeanSquare", "Moment")
    rho = op.attrs.get("decay", 0.95)
    eps = op.attrs.get("epsilon", 1e-6)
    momentum = op.attrs.get("momentum", 0.0)
    lr = _lr(ctx, op)
    ms_new = rho * ms + (1 - rho) * g * g
    if op.attrs.get("centered", False):
        (mg,) = _read(ctx, op, "MeanGrad")
        mg_new = rho * mg + (1 - rho) * g
        mom_new = momentum * mom + lr * g / torch.sqrt(ms_new - mg_new * mg_new + eps)
        ctx.set_output(op, "MeanGradOut", mg_new)
    else:
        mom_new = momentum * mom + lr * g / torch.sqrt(ms_new + eps)
    _write_param(ctx, op, p - mom_new)
    ctx.set_output(op, "MeanSquareOut", ms_new)
    ctx.set_output(op, "MomentOut", mom_new)


@register("ftrl")
def _ftrl(ctx, op):
    p, g, sq, lin = _read(
        ctx, op, "Param", "Grad", "SquaredAccumulator", "LinearAccumulator"
    )
    l1 = op.attrs.get("l1", 0.0)
    l2 = op.attrs.get("l2", 0.0)
    power = op.attrs.get("lr_power", -0.5)
    lr = _lr(ctx, op)
    new_sq = sq + g * g
    if power == -0.5:
        sigma = (torch.sqrt(new_sq) - torch.sqrt(sq)) / lr
    else:
        sigma = (new_sq ** (-power) - sq ** (-power)) / lr
    new_lin = lin + g - sigma * p
    if power == -0.5:
        denom = torch.sqrt(new_sq) / lr + 2 * l2
    else:
        denom = new_sq ** (-power) / lr + 2 * l2
    pre = torch.clamp(new_lin, -l1, l1) - new_lin
    p_new = torch.where(torch.abs(new_lin) > l1, pre / denom, torch.zeros_like(p))
    _write_param(ctx, op, p_new)
    ctx.set_output(op, "SquaredAccumOut", new_sq)
    ctx.set_output(op, "LinearAccumOut", new_lin)


@register("average_accumulate")
def _average_accumulate(ctx, op):
    """ModelAverage accumulator (reference operators/average_accumulates_op)."""
    p, s = _read(ctx, op, "Param", "Sum")
    n = ctx.get_input(op, "Num")
    ctx.set_output(op, "SumOut", s + p)
    ctx.set_output(op, "NumOut", n + 1)
