"""Mixed precision: bf16 compute with f32 master weights (+ loss scaling).

The port's copy of ``paddle_tpu/contrib/mixed_precision.py``: the same
Program rewrite (a rewritten Program serializes with ``to_string()`` as
the JAX package's does) and the same optimizer wrapper.

- ``rewrite_program_bf16(program)``: insert casts so every matmul/conv-class
  op computes in bf16 (inputs cast down, result cast back to f32).  Params
  stay f32 — they ARE the master weights — and gradients come out f32,
  because the backward differentiates through the casts.  On the card the
  bf16 ``mul``/``matmul`` run on cuBLAS's bf16 tensor-core GEMMs and the
  convolutions on cuDNN's, with float32 accumulation (the Executor keeps
  cuBLAS's reduced-precision bf16 reduction off while it runs).
- ``decorate(optimizer, init_loss_scaling)``: loss-scaling wrapper with the
  reference-style API.  bf16 shares f32's exponent range, so scaling is a
  no-op safety default (1.0); a nontrivial static scale is honored for
  fp16-style experiments (grads are unscaled before the update).
"""
from __future__ import annotations

from .. import unique_name
from ..framework import OpRole, default_startup_program, op_role_guard, program_guard

__all__ = ["decorate", "rewrite_program_bf16", "BF16_COMPUTE_OPS"]

BF16_COMPUTE_OPS = {
    "mul": ("X", "Y"),
    "matmul": ("X", "Y"),
    "conv2d": ("Input", "Filter"),
    "depthwise_conv2d": ("Input", "Filter"),
    "conv2d_transpose": ("Input", "Filter"),
    "conv3d": ("Input", "Filter"),
    "conv3d_transpose": ("Input", "Filter"),
}


def rewrite_program_bf16(program, amp_lists=None):
    """Insert bf16 casts around the GEMM- and convolution-bound ops of
    block 0 (see module docstring).  Only f32 forward ops are rewritten;
    backward comes from autodiff of the rewritten forward."""
    ops_table = dict(BF16_COMPUTE_OPS)
    if amp_lists:
        ops_table.update(amp_lists)
    blk = program.global_block()
    new_ops = []
    casted = {}  # f32 var name -> bf16 cast name

    def cast_in(op, name, dtype, new_ops):
        key = (name, dtype)
        if key not in casted:
            out = unique_name.generate(name + ".cast_" + dtype)
            src = blk.vars.get(name)
            blk.create_var(name=out, shape=src.shape if src is not None else None, dtype=dtype)
            cop = type(op)(
                blk, "cast", {"X": [name]}, {"Out": [out]},
                {"in_dtype": "float32", "out_dtype": dtype},
            )
            if op.attrs.get("op_role") is not None:
                cop.attrs["op_role"] = op.attrs["op_role"]
            new_ops.append(cop)
            casted[key] = out
        return casted[key]

    for op in blk.ops:
        slots = ops_table.get(op.type)
        role = op.attrs.get("op_role")
        if slots and role not in (OpRole.Backward, OpRole.Optimize):
            for slot in slots:
                names = op.inputs.get(slot) or []
                if names:
                    var = blk.vars.get(names[0])
                    if var is None or str(var.dtype) not in ("float32", None):
                        continue
                    op.inputs[slot] = [cast_in(op, names[0], "bfloat16", new_ops)]
            # compute in bf16, cast the result back to f32 for the rest of
            # the graph
            out_slot = "Out" if "Out" in op.outputs else ("Output" if "Output" in op.outputs else None)
            if out_slot:
                orig = op.outputs[out_slot][0]
                raw = unique_name.generate(orig + ".bf16")
                ovar = blk.vars.get(orig)
                blk.create_var(name=raw, shape=ovar.shape if ovar is not None else None, dtype="bfloat16")
                op.outputs[out_slot] = [raw]
                new_ops.append(op)
                bop = type(op)(
                    blk, "cast", {"X": [raw]}, {"Out": [orig]},
                    {"in_dtype": "bfloat16", "out_dtype": "float32"},
                )
                if role is not None:
                    bop.attrs["op_role"] = role
                new_ops.append(bop)
                continue
        new_ops.append(op)
    blk.ops = new_ops
    program._bump()
    return program


class OptimizerWithMixedPrecision:
    def __init__(self, optimizer, init_loss_scaling=1.0, use_bf16=True):
        self._optimizer = optimizer
        self._loss_scaling = float(init_loss_scaling)
        self._use_bf16 = use_bf16

    def get_loss_scaling(self):
        return self._loss_scaling

    def backward(self, loss, startup_program=None, parameter_list=None, no_grad_set=None):
        from .. import layers
        from ..backward import append_backward

        prog = loss.block.program
        if self._use_bf16:
            rewrite_program_bf16(prog)
        with program_guard(prog, startup_program or default_startup_program()):
            if self._loss_scaling != 1.0:
                scaled = layers.scale(x=loss, scale=self._loss_scaling)
            else:
                scaled = loss
            params_grads = append_backward(scaled, parameter_list, no_grad_set)
            if self._loss_scaling != 1.0:
                with op_role_guard(OpRole.Backward):
                    params_grads = [
                        (p, layers.scale(x=g, scale=1.0 / self._loss_scaling))
                        for p, g in params_grads
                    ]
        return params_grads

    def apply_gradients(self, params_grads, loss, startup_program=None):
        return self._optimizer._create_optimization_pass(params_grads, loss, startup_program)

    def minimize(self, loss, startup_program=None, parameter_list=None, no_grad_set=None):
        params_grads = self.backward(loss, startup_program, parameter_list, no_grad_set)
        params_grads = sorted(params_grads, key=lambda x: x[0].name)
        optimize_ops = self.apply_gradients(params_grads, loss, startup_program)
        return optimize_ops, params_grads


def decorate(optimizer, init_loss_scaling=1.0, use_dynamic_loss_scaling=False, use_bf16=True):
    """Wrap an optimizer for mixed-precision training (reference-style API).
    Dynamic loss scaling is unnecessary on bf16 and not implemented —
    requesting it raises so fp16-ported configs fail loudly."""
    if use_dynamic_loss_scaling:
        raise NotImplementedError(
            "dynamic loss scaling is an fp16 workaround; bf16 does not need "
            "it — use a static init_loss_scaling if required"
        )
    return OptimizerWithMixedPrecision(optimizer, init_loss_scaling, use_bf16)
