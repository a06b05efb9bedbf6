"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

A second package beside the JAX one, which stays the reference it is
held against.  It imports torch and numpy, never jax and nothing of
``paddle_tpu``.  The port goes slice by slice; this one serves the
Transformer LM through ``serving.InferenceEngine(decode_model=...)``,
with the paged decode and paged prefill attention as hand-written CUDA
kernels for Hopper (``csrc/paged_attention.cu``).

Entry points run on the card: ``device=None`` resolves to ``cuda`` and
raises when no GPU is present.  Pass ``device="cpu"`` to run the plain
PyTorch versions instead (the tests do).
"""
from __future__ import annotations

from . import core, models, observability, parallel, serving
from .core import resolve_device

__all__ = ["core", "models", "observability", "parallel", "serving",
           "resolve_device"]
