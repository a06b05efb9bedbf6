"""Contrib utilities (reference: python/paddle/fluid/contrib/).

The port's counterpart of ``paddle_tpu/contrib/``, so far with
``mixed_precision`` only.  Not ported yet: ``decoder`` (it needs the
``While`` op, ROADMAP A10), ``quantize`` (A12) and ``memory_usage_calc``
(it stands on the profiler, A9).
"""
from . import mixed_precision  # noqa: F401

__all__ = ["mixed_precision"]
