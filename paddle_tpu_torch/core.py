"""Device resolution, places and dtype helpers for the port.

The JAX package selects a backend through ``Place`` objects; the port
keeps ``CPUPlace`` and ``CUDAPlace`` for the Fluid entry points
(``Executor(fluid.CUDAPlace(0))``), each naming a ``torch.device``, and
its other entry points take a ``device`` that is resolved here.  The
port runs on the card: ``device=None`` means ``cuda``, and when no GPU
is present that is an error — an entry point never carries on quietly
on the CPU.  Callers that want the CPU (the tests) ask for it by name.

The dtype helpers are the JAX package's (``paddle_tpu/core.py``): dtypes
are canonical strings, mapped here to numpy and torch dtypes.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

__all__ = ["resolve_device", "Place", "CPUPlace", "CUDAPlace",
           "canonical_dtype", "np_dtype", "torch_dtype", "is_float_dtype",
           "f32_bf16_reduction", "EOFException"]

_reduction_lock = threading.Lock()
_reduction_runs = 0
_reduction_saved = None


@contextlib.contextmanager
def f32_bf16_reduction(device):
    """Within the block, cuBLAS reduces bfloat16 products on ``device`` (a
    card) in float32, as the JAX package's reference does: PyTorch lets
    cuBLAS reduce them in reduced precision by default
    (``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``).
    The global switch is turned off at the first of the runs that overlap
    (the serving workers run from their own threads) and restored to the
    caller's value when the last of them ends, so no setting is left
    changed behind the caller's back."""
    global _reduction_runs, _reduction_saved
    if torch.device(device).type != "cuda":
        yield
        return
    matmul = torch.backends.cuda.matmul
    with _reduction_lock:
        if _reduction_runs == 0:
            _reduction_saved = matmul.allow_bf16_reduced_precision_reduction
            matmul.allow_bf16_reduced_precision_reduction = False
        _reduction_runs += 1
    try:
        yield
    finally:
        with _reduction_lock:
            _reduction_runs -= 1
            if _reduction_runs == 0:
                matmul.allow_bf16_reduced_precision_reduction = \
                    _reduction_saved


def resolve_device(device=None):
    """``device`` (None, a string, a ``torch.device`` or a ``Place``) as a
    concrete ``torch.device``.  None resolves to ``cuda``; a CUDA device
    raises ``RuntimeError`` when ``torch.cuda.is_available()`` is
    false."""
    if isinstance(device, Place):
        device = device.torch_device_name()
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError("device must be 'cuda' or 'cpu', got %r" % (device,))
    return dev


class Place:
    """Base device place: a device type and an ordinal."""

    _type = "cpu"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def __repr__(self):
        return "%s(%d)" % (type(self).__name__, self.device_id)

    def __eq__(self, other):
        return type(self) is type(other) and self.device_id == other.device_id

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    def torch_device_name(self):
        return self._type if self._type == "cpu" else "%s:%d" % (
            self._type, self.device_id)


class CPUPlace(Place):
    _type = "cpu"


class CUDAPlace(Place):
    """One CUDA card, by ordinal.  Raises ``RuntimeError`` when no GPU is
    present: the port never carries on quietly on the CPU."""

    _type = "cuda"

    def __init__(self, device_id: int = 0):
        super().__init__(device_id)
        resolve_device(self.torch_device_name())


class EOFException(Exception):
    """Raised when a started py_reader pipeline is exhausted (reference:
    fluid.core.EOFException).  Deliberately NOT a StopIteration subclass:
    PEP 479 would mutate that into RuntimeError inside generator frames
    and silently end iterator-driven for-loops."""


# ---------------------------------------------------------------------------
# dtypes
# ---------------------------------------------------------------------------

_DTYPE_ALIASES = {
    "float32": "float32",
    "fp32": "float32",
    "float": "float32",
    "float64": "float64",
    "fp64": "float64",
    "double": "float64",
    "float16": "float16",
    "fp16": "float16",
    "bfloat16": "bfloat16",
    "bf16": "bfloat16",
    "int8": "int8",
    "uint8": "uint8",
    "int16": "int16",
    "int32": "int32",
    "int": "int32",
    "int64": "int64",
    "long": "int64",
    "bool": "bool",
}

_TORCH = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}


def canonical_dtype(dtype) -> str:
    """Normalize a user dtype (str / np.dtype / torch.dtype) to a
    canonical string name."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).replace("torch.", "")
    elif isinstance(dtype, str):
        name = dtype
    else:
        name = np.dtype(dtype).name if not hasattr(dtype, "name") else dtype.name
    name = str(name)
    if name not in _DTYPE_ALIASES:
        # np.dtype round trip for things like '<f4'
        name = np.dtype(name).name
    if name not in _DTYPE_ALIASES:
        raise ValueError("unsupported dtype: %r" % (dtype,))
    return _DTYPE_ALIASES[name]


def np_dtype(dtype):
    """The numpy dtype of a canonical dtype.  numpy has no bfloat16, so
    that one raises; tensors use :func:`torch_dtype`."""
    name = canonical_dtype(dtype)
    if name == "bfloat16":
        raise TypeError("numpy has no bfloat16; use torch_dtype()")
    return np.dtype(name)


def torch_dtype(dtype):
    """The ``torch.dtype`` of a canonical dtype."""
    return _TORCH[canonical_dtype(dtype)]


def is_float_dtype(dtype) -> bool:
    return canonical_dtype(dtype) in ("float16", "bfloat16", "float32", "float64")
