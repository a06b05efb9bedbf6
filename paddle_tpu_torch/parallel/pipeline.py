"""Pipeline parallelism: the stacked-parameter layout.

The port's counterpart of the JAX package's ``parallel/pipeline.py``.
It holds the one helper the single-device ``pipeline`` rule needs
(``ops/pipeline_ops.py``): the storage row of a virtual stage under the
circular layout.  The multi-device engines (``pipeline_apply``, the
GPipe fill-drain schedule over a ``pp`` mesh axis, and
``pipeline_apply_circular``) wait for ROADMAP A11.2.
"""
from __future__ import annotations

__all__ = ["circular_stage_index"]


def circular_stage_index(v, n_devices, repeats):
    """Storage row of virtual stage ``v`` in the device-major stacked layout
    used by the circular schedule: device ``v % S`` holds its ``repeats``
    slices contiguously, so a plain split of the leading dim over the
    ``pp`` devices hands each device exactly its rows.  The sequential
    path reads the same rows, so both paths see identical weights."""
    return (v % n_devices) * repeats + v // n_devices
