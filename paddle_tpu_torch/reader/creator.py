"""Reader creators (reference surface: python/paddle/reader/creator.py):
turn an array or a text file into a sample reader.

The port's copy of ``paddle_tpu/reader/creator.py``.  ``recordio``
waits for the port of the recordio files (ROADMAP A12) and raises.
"""
from __future__ import annotations

__all__ = ["np_array", "text_file", "recordio"]


def np_array(x):
    """Yield the rows of an ndarray (batch dim 0) as samples."""
    import numpy as np

    arr = np.asarray(x)

    def reader():
        for row in arr:
            yield row

    return reader


def text_file(path):
    """Yield stripped lines of a text file."""

    def reader():
        with open(path, "r") as f:
            for line in f:
                yield line.rstrip("\n")

    return reader


def recordio(paths, buf_size=100):
    raise NotImplementedError(
        "reader.creator.recordio is not ported to paddle_tpu_torch yet: it "
        "waits for the recordio files (ROADMAP A12)")
