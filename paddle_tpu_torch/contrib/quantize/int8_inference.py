"""Int8 execution for inference (reference: the JAX package's
``contrib/quantize/int8_inference.py``).

The reference's int8 story stops at representation
(QuantizeTranspiler.convert_to_int8 stores int8 weights + scales;
inference dequantizes to float).  This module goes the rest of the way:

- ``quantized_mul`` / ``quantized_conv2d`` op rules
  (``paddle_tpu_torch/ops/quant_ops.py``): dynamic per-tensor abs-max
  quantization of the activation on the device, an int8 x int8 product
  with int32 accumulation (cuBLASLt's int8 GEMM on the card, the float64
  product on the CPU: the same bits), then one rescale
  ``acc * (sx / 127) * (sw / 127)`` with per-output-channel weight
  scales, plus the op's ``Bias``;
- ``Int8InferenceTranspiler``: rewrites an inference Program in place —
  each mul/conv2d weight is pre-quantized per output channel (numpy, on
  the host: the JAX package's bits) into ``<w>.int8`` + ``<w>.scale``
  persistable vars on the weight's device, and the op is switched to
  its quantized spelling.

Where the port departs from the reference (ROADMAP R-16): the rewritten
op keeps its ``Bias`` input.  The port's conv+BN fold puts the
batch_norm's shift there, and the reference's transpiler, which keeps
only the input, ``QWeight`` and ``WScale``, would drop it.

Accuracy: symmetric per-channel weights + dynamic per-tensor activations
is the standard post-training recipe.
"""
from __future__ import annotations

import numpy as np

from paddle_tpu_torch.executor import as_numpy
from .quantize_transpiler import placed_like, quantize_weight_abs_max

__all__ = ["Int8InferenceTranspiler"]


class Int8InferenceTranspiler:
    """Rewrite an inference Program to execute int8.

    ``transpile(program, scope)`` pre-quantizes each mul/conv2d weight
    from ``scope`` (per output channel: axis 1 for mul's [K, N], axis 0
    for OIHW filters) into persistable ``<w>.int8`` / ``<w>.scale`` vars
    and switches the ops to quantized spellings.  Grouped/depthwise convs
    and ops whose weight is not a persistable parameter are left in
    float."""

    def __init__(self, weight_bits=8):
        if weight_bits != 8:
            raise ValueError("int8 execution supports weight_bits=8")

    def transpile(self, program, scope, quantize_ops=("mul", "conv2d")):
        blk = program.global_block()
        converted = {}
        for op in blk.ops:
            if op.type not in quantize_ops:
                continue
            slot = "Y" if op.type == "mul" else "Filter"
            in_slot = "X" if op.type == "mul" else "Input"
            wname = op.inputs[slot][0]
            wvar = blk.vars.get(wname)
            if wvar is None or not wvar.persistable:
                continue
            if op.type == "conv2d" and (op.attrs.get("groups", 1) or 1) != 1:
                continue
            if op.type == "mul" and op.attrs.get("y_num_col_dims", 1) != 1:
                continue
            if wname not in converted:
                value = scope[wname]
                axis = 1 if op.type == "mul" else 0
                q, s = quantize_weight_abs_max(as_numpy(value), 8,
                                               per_channel_axis=axis)
                qname, sname = wname + ".int8", wname + ".scale"
                scope[qname] = placed_like(value, q)
                scope[sname] = placed_like(
                    value, np.asarray(s, np.float32).reshape(-1))
                blk.create_var(name=qname, shape=list(q.shape), dtype="int8",
                               persistable=True)
                blk.create_var(name=sname, shape=[int(np.asarray(s).size)],
                               dtype="float32", persistable=True)
                converted[wname] = (qname, sname)
            qname, sname = converted[wname]
            op.type = "quantized_mul" if op.type == "mul" else "quantized_conv2d"
            inputs = {in_slot: list(op.inputs[in_slot]),
                      "QWeight": [qname], "WScale": [sname]}
            if op.inputs.get("Bias"):
                inputs["Bias"] = list(op.inputs["Bias"])   # R-16
            op.inputs = inputs
        program._bump()
        return program
