"""Contrib utilities (reference: python/paddle/fluid/contrib/).

The port's counterpart of ``paddle_tpu/contrib/``: ``mixed_precision``,
``memory_usage_calc`` (``memory_usage``, ``memory_analysis``) and
``decoder`` (``InitState``, ``StateCell``, ``TrainingDecoder``,
``BeamSearchDecoder``).  Not ported yet: ``quantize`` and
``op_frequence`` (ROADMAP A12).
"""
from . import memory_usage_calc, mixed_precision  # noqa: F401
from .memory_usage_calc import memory_analysis, memory_usage  # noqa: F401
from . import decoder  # noqa: F401
from .decoder import (BeamSearchDecoder, InitState, StateCell,  # noqa: F401
                      TrainingDecoder)

__all__ = ["mixed_precision", "memory_usage_calc", "memory_usage",
           "memory_analysis", "decoder", "InitState", "StateCell",
           "TrainingDecoder", "BeamSearchDecoder"]
