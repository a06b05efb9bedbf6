"""Device util layers (reference: python/paddle/fluid/layers/device.py).

The port's copy of the JAX package's ``layers/device.py``.  The
reference's ``get_places`` fed the deprecated ParallelDo; here the
multi-device path is ParallelExecutor over a mesh, so this is a
host-side shim returning the device list — enough for ported scripts
that only count devices or iterate them.
"""
from __future__ import annotations

import torch

from ..core import resolve_device

__all__ = ["get_places"]


def get_places(device_count=None, device_type=None):
    """The visible cards (``torch.device("cuda", i)``), or the CPU's device
    when ``device_type`` is "cpu", optionally truncated to
    ``device_count``.  ``device_type`` None, "gpu" or "cuda" names the
    cards, and raises without one (``core.resolve_device``); "tpu" names
    no device of the port and gives an empty list (no silent
    substitution: scripts branch on this list's length)."""
    want = "gpu" if device_type is None else str(device_type).lower()
    if want == "tpu":
        devices = []
    elif want in ("gpu", "cuda"):
        resolve_device(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    elif want == "cpu":
        devices = [torch.device("cpu")]
    else:
        raise ValueError("unknown device_type %r" % device_type)
    if device_count is not None:
        if device_count <= 0:
            raise ValueError("device_count must be positive, got %d" % device_count)
        devices = devices[: int(device_count)]
    return devices
