"""Data-side layers (reference: python/paddle/fluid/layers/io.py).

The port keeps ``data`` only, a copy of the JAX package's: it declares a
feed slot.  Readers and recordio files are not ported yet.
"""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["data"]


def data(name, shape, append_batch_size=True, dtype="float32", lod_level=0, type=None, stop_gradient=True):
    """Declare an input slot. With append_batch_size (default, as reference
    layers/io.py:24) a leading -1 batch dim is added."""
    helper = LayerHelper("data")
    shape = list(shape)
    if lod_level >= 1:
        # padded-ragged layout: [batch, max_len] + per-timestep shape (the
        # reference's flat [sum_len]+lod becomes dense batch-major here)
        shape = [-1, -1] + shape
    elif append_batch_size:
        shape = [-1] + shape
    return helper.block.program.global_block().create_var(
        name=name,
        shape=shape,
        dtype=dtype,
        lod_level=lod_level,
        is_data=True,
        stop_gradient=stop_gradient,
    )
