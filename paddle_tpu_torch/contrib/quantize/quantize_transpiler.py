"""Quantization transpiler (reference:
python/paddle/fluid/contrib/quantize/quantize_transpiler.py).

The port's counterpart of the JAX package's
``contrib/quantize/quantize_transpiler.py``:
- host-side int8 weight quant/dequant helpers (abs-max, per-tensor or
  per-output-channel) in numpy, copied, so that the scales are the JAX
  package's bits;
- ``QuantizeTranspiler.training_transpile``: rewrites every conv2d /
  depthwise_conv2d / mul in a Program to read its weight through a
  ``fake_quantize_abs_max`` op (``ops/quant_ops.py``) — quantize-aware
  training with a straight-through estimator, differentiated by
  autograd with the rest of the step;
- ``freeze_program`` and ``convert_to_int8``, which write the scope.

``freeze_program`` writes the dequantized weights into the scope's
tensors in place (``copy_``): a step bound to those tensors then stays
bound, where a new tensor in their place would make it bind and capture
again.
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.executor import as_numpy
from paddle_tpu_torch.framework import OpRole

__all__ = ["QuantizeTranspiler", "quantize_weight_abs_max", "dequantize_weight_abs_max"]


def quantize_weight_abs_max(w, bits=8, per_channel_axis=None):
    """float weights -> (int8 array, float scale(s)).  abs-max symmetric."""
    w = np.asarray(w)
    qmax = float(2 ** (bits - 1) - 1)
    if per_channel_axis is None:
        scale = np.maximum(np.abs(w).max(), 1e-8)
        q = np.clip(np.round(w / scale * qmax), -qmax, qmax).astype(np.int8)
        return q, np.float32(scale)
    axes = tuple(i for i in range(w.ndim) if i != per_channel_axis)
    scale = np.maximum(np.abs(w).max(axis=axes, keepdims=True), 1e-8)
    q = np.clip(np.round(w / scale * qmax), -qmax, qmax).astype(np.int8)
    return q, scale.astype(np.float32)


def dequantize_weight_abs_max(q, scale, bits=8):
    qmax = float(2 ** (bits - 1) - 1)
    return (np.asarray(q, np.float32) / qmax) * scale


def placed_like(value, arr):
    """``arr`` (numpy) as a tensor on ``value``'s device where ``value``
    is a tensor, else as it is (the Executor moves a numpy value to its
    device at its first run)."""
    if isinstance(value, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(value.device)
    return arr


class QuantizeTranspiler:
    def __init__(self, weight_bits=8, activation_bits=8,
                 activation_quantize_type="abs_max", weight_quantize_type="abs_max"):
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits

    QUANTIZABLE = {"conv2d": "Filter", "depthwise_conv2d": "Filter", "mul": "Y"}

    def training_transpile(self, program, startup_program=None):
        """Insert fake-quant on the weight input of every quantizable op."""
        blk = program.global_block()
        new_ops = []
        quantized = {}  # weight name -> fake-quant output var name
        from paddle_tpu_torch import unique_name

        for op in blk.ops:
            slot = self.QUANTIZABLE.get(op.type)
            if slot and op.attrs.get("op_role") not in (OpRole.Backward, OpRole.Optimize):
                wname = op.inputs[slot][0]
                if wname not in quantized:
                    wvar = blk.vars[wname]
                    qname = unique_name.generate(wname + ".quantized")
                    blk.create_var(name=qname, shape=wvar.shape, dtype=wvar.dtype)
                    sname = unique_name.generate(wname + ".scale")
                    blk.create_var(name=sname, shape=[1], dtype="float32")
                    attrs = {"bit_length": self.weight_bits}
                    if op.attrs.get("op_role") is not None:
                        attrs["op_role"] = op.attrs["op_role"]
                    qop = type(op)(
                        blk,
                        "fake_quantize_abs_max",
                        {"X": [wname]},
                        {"Out": [qname], "OutScale": [sname]},
                        attrs,
                    )
                    new_ops.append(qop)
                    quantized[wname] = qname
                op.inputs[slot] = [quantized[wname]]
            new_ops.append(op)
        blk.ops = new_ops
        program._bump()
        return program

    def _weights(self, program, scope):
        """(name, the scope holding it, its value) of every fake-quantized
        weight, in op order."""
        for op in program.global_block().ops:
            if op.type == "fake_quantize_abs_max":
                wname = op.inputs["X"][0]
                owner = scope._owner(wname)
                if owner is None:
                    raise KeyError("QuantizeTranspiler: %r is not in the "
                                   "scope (run the startup program first)"
                                   % wname)
                yield wname, owner, owner.vars[wname]

    def freeze_program(self, program, scope, place=None):
        """Post-training: bake quantized weights back into the scope (the
        int8 pair is what save_inference_model would export).  A tensor
        is overwritten in place."""
        for wname, owner, value in self._weights(program, scope):
            w = as_numpy(value)
            q, s = quantize_weight_abs_max(w, self.weight_bits)
            deq = dequantize_weight_abs_max(q, s, self.weight_bits).astype(w.dtype)
            if isinstance(value, torch.Tensor):
                value.copy_(torch.from_numpy(deq))
            else:
                owner.vars[wname] = deq
        return program

    def convert_to_int8(self, program, scope, place=None):
        """Store each quantized weight as its int8 tensor + f32 scale in the
        scope, on the weight's device (reference
        QuantizeTranspiler.convert_to_int8: the deploy-side
        representation; freeze_program keeps the dequantized f32 view)."""
        for wname, _, value in self._weights(program, scope):
            q, s = quantize_weight_abs_max(as_numpy(value), self.weight_bits)
            scope.vars[wname + ".int8"] = placed_like(value, q)
            scope.vars[wname + ".scale"] = placed_like(
                value, np.asarray(s, np.float32))
        return program
