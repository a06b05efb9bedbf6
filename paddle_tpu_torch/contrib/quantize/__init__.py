"""Quantization (reference: python/paddle/fluid/contrib/quantize/).

The port's counterpart of ``paddle_tpu/contrib/quantize/``: quantize-aware
training (``QuantizeTranspiler``) and int8 inference
(``Int8InferenceTranspiler``); the op rules are
``paddle_tpu_torch/ops/quant_ops.py``."""
from .int8_inference import Int8InferenceTranspiler  # noqa: F401
from .quantize_transpiler import (  # noqa: F401
    QuantizeTranspiler,
    quantize_weight_abs_max,
    dequantize_weight_abs_max,
)

__all__ = [
    "QuantizeTranspiler",
    "Int8InferenceTranspiler",
    "quantize_weight_abs_max",
    "dequantize_weight_abs_max",
]
