"""append_backward (reference: python/paddle/fluid/backward.py).

The port's copy of the JAX package's ``paddle_tpu/backward.py``.  It adds
ONE ``backward`` meta-op and the ``<param>@GRAD`` variables; the port's
Executor (executor.lower_block) runs the forward prefix with the
trainable parameters as autograd leaves and binds every ``@GRAD`` name
from ``torch.autograd.grad``, so every op's gradient comes from PyTorch's
autograd (and the flash attention op's from its own backward kernel).
"""
from __future__ import annotations

from .framework import (
    Parameter,
    Program,
    Variable,
    default_main_program,
    grad_var_name,
    OpRole,
)

__all__ = ["append_backward", "calc_gradient"]


def _collect_parameters(program: Program, parameter_list, no_grad_set):
    block = program.global_block()
    if parameter_list:
        names = [p.name if isinstance(p, Variable) else str(p) for p in parameter_list]
    else:
        names = [p.name for p in block.all_parameters() if p.trainable]
    ngs = set()
    for x in no_grad_set or ():
        ngs.add(x.name if isinstance(x, Variable) else str(x))
    return [n for n in names if n not in ngs], ngs


def append_backward(loss, parameter_list=None, no_grad_set=None, callbacks=None):
    """Returns list of (param, grad) Variable pairs, as the reference does
    (backward.py:391 append_backward)."""
    program = loss.block.program
    block = program.global_block()
    param_names, ngs = _collect_parameters(program, parameter_list, no_grad_set)

    grad_vars = []
    for pname in param_names:
        p = block.var(pname)
        g = block.create_var(
            name=grad_var_name(pname), shape=p.shape, dtype=p.dtype, persistable=False
        )
        grad_vars.append((p, g))
    loss_grad = block.create_var(
        name=grad_var_name(loss.name), shape=loss.shape, dtype=loss.dtype
    )
    del loss_grad

    block.append_op(
        type="backward",
        inputs={"Loss": [loss]},
        outputs={"ParamGrads": [g for _, g in grad_vars]},
        attrs={
            "parameter_list": list(param_names),
            "no_grad_set": sorted(ngs),
            "op_role": OpRole.Backward,
        },
    )
    return grad_vars


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """Gradient of ``targets`` w.r.t. arbitrary ``inputs`` (leaf or
    intermediate variables).  Reference: backward.py calc_gradient."""
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    tg = target_gradients if isinstance(target_gradients, (list, tuple)) else ([target_gradients] if target_gradients is not None else [])
    program = targets[0].block.program
    block = program.global_block()

    grad_out = []
    for v in inputs:
        g = block.create_var(name=grad_var_name(v.name), shape=v.shape, dtype=v.dtype)
        grad_out.append(g)

    block.append_op(
        type="calc_gradient",
        inputs={"Targets": list(targets), "Inputs": list(inputs), "TargetGradients": list(tg)},
        outputs={"InputGrads": grad_out},
        attrs={
            "no_grad_set": sorted(x.name if isinstance(x, Variable) else str(x) for x in (no_grad_set or ())),
            "op_role": OpRole.Backward,
        },
    )
    return grad_out
