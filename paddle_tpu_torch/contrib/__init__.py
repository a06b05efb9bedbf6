"""Contrib utilities (reference: python/paddle/fluid/contrib/).

The port's counterpart of ``paddle_tpu/contrib/``: ``mixed_precision``
and ``memory_usage_calc`` (``memory_usage``, ``memory_analysis``).  Not
ported yet: ``decoder`` (it needs the ``While`` op, ROADMAP A10) and
``quantize`` (A12).
"""
from . import memory_usage_calc, mixed_precision  # noqa: F401
from .memory_usage_calc import memory_analysis, memory_usage  # noqa: F401

__all__ = ["mixed_precision", "memory_usage_calc", "memory_usage",
           "memory_analysis"]
