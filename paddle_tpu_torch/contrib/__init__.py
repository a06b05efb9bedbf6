"""Contrib utilities (reference: python/paddle/fluid/contrib/).

The port's counterpart of ``paddle_tpu/contrib/``, every module of it:
``mixed_precision``, ``memory_usage_calc`` (``memory_usage``,
``memory_analysis``), ``quantize`` (``QuantizeTranspiler``,
``Int8InferenceTranspiler``), ``op_frequence`` (``op_freq_statistic``)
and ``decoder`` (``InitState``, ``StateCell``, ``TrainingDecoder``,
``BeamSearchDecoder``).
"""
from . import memory_usage_calc, mixed_precision  # noqa: F401
from .memory_usage_calc import memory_analysis, memory_usage  # noqa: F401
from . import quantize  # noqa: F401
from .op_frequence import op_freq_statistic  # noqa: F401
from . import decoder  # noqa: F401
from .decoder import (BeamSearchDecoder, InitState, StateCell,  # noqa: F401
                      TrainingDecoder)
from .quantize import QuantizeTranspiler  # noqa: F401

__all__ = [
    "memory_usage",
    "memory_analysis",
    "quantize",
    "mixed_precision",
    "op_freq_statistic",
    "decoder",
    "QuantizeTranspiler",
    "InitState",
    "StateCell",
    "TrainingDecoder",
    "BeamSearchDecoder",
]
