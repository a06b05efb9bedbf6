"""Binary compatibility with the reference's saved-parameter files.

Reference writers: paddle/fluid/framework/lod_tensor.cc
``SerializeToStream`` (one LoDTensor per file, the save_op /
save_persistables layout) and operators/save_combine_op.cc (LoDTensor
streams concatenated in input order).  Byte layout per tensor:

    u32   lod-tensor version (0)
    u64   lod_level
    per level: u64 byte-size | size_t[] offsets
    u32   tensor version (0)
    i32   TensorDesc protobuf size
    bytes TensorDesc {required Type data_type = 1; repeated int64 dims = 2}
    raw   numel * sizeof(dtype) little-endian data

This module reads AND writes that exact format with a hand-rolled
protobuf codec (the enum values come from framework.proto VarType.Type),
so a reference user can bring trained weights over —
``load_fluid_persistables(dirname)`` — or export back.

The port's copy of the JAX package's ``fluid_format.py``: the same bytes
read and written.  ``load_fluid_persistables`` puts each tensor into a
port ``Scope`` as a tensor in the file's dtype, on the device of the
scope's tensors; ``save_fluid_persistables`` takes tensors too.
"""
from __future__ import annotations

import os
import struct

import numpy as np
import torch

from .core import resolve_device
from .executor import as_numpy

__all__ = [
    "read_fluid_tensor",
    "write_fluid_tensor",
    "read_fluid_var_file",
    "write_fluid_var_file",
    "read_fluid_combined",
    "load_fluid_persistables",
    "save_fluid_persistables",
]

# framework.proto VarType.Type values
_DTYPES = {0: np.bool_, 1: np.int16, 2: np.int32, 3: np.int64,
           4: np.float16, 5: np.float32, 6: np.float64,
           20: np.uint8, 21: np.int8}
_DTYPE_IDS = {np.dtype(v): k for k, v in _DTYPES.items()}


def _read_varint(buf, pos):
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _write_varint(n):
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _parse_tensor_desc(buf):
    """TensorDesc: field 1 = data_type varint, field 2 = dims (repeated
    int64 — proto2 default unpacked, but accept packed too)."""
    pos = 0
    dtype_id = None
    dims = []
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 0:
            dtype_id, pos = _read_varint(buf, pos)
        elif field == 2 and wire == 0:
            d, pos = _read_varint(buf, pos)
            dims.append(d)
        elif field == 2 and wire == 2:  # packed
            ln, pos = _read_varint(buf, pos)
            end = pos + ln
            while pos < end:
                d, pos = _read_varint(buf, pos)
                dims.append(d)
        elif wire == 2:  # unknown length-delimited field
            ln, pos = _read_varint(buf, pos)
            pos += ln
        elif wire == 0:
            _, pos = _read_varint(buf, pos)
        else:
            raise ValueError("unsupported wire type %d in TensorDesc" % wire)
    if dtype_id is None:
        raise ValueError("TensorDesc missing data_type")
    return dtype_id, dims


def _build_tensor_desc(arr):
    out = bytearray()
    out += _write_varint((1 << 3) | 0)
    out += _write_varint(_DTYPE_IDS[arr.dtype])
    for d in arr.shape:
        out += _write_varint((2 << 3) | 0)
        out += _write_varint(int(d))
    return bytes(out)


def read_fluid_tensor(f):
    """One serialized LoDTensor from a binary stream -> (array, lod)."""
    (version,) = struct.unpack("<I", f.read(4))
    if version != 0:
        raise ValueError("unsupported LoDTensor version %d" % version)
    (lod_level,) = struct.unpack("<Q", f.read(8))
    lod = []
    for _ in range(lod_level):
        (nbytes,) = struct.unpack("<Q", f.read(8))
        lod.append(np.frombuffer(f.read(nbytes), "<u8").tolist())
    (tversion,) = struct.unpack("<I", f.read(4))
    if tversion != 0:
        raise ValueError("unsupported tensor version %d" % tversion)
    (desc_size,) = struct.unpack("<i", f.read(4))
    dtype_id, dims = _parse_tensor_desc(f.read(desc_size))
    dtype = np.dtype(_DTYPES[dtype_id])
    numel = int(np.prod(dims)) if dims else 1
    data = f.read(numel * dtype.itemsize)
    arr = np.frombuffer(data, dtype).reshape(dims).copy()
    return arr, lod


def write_fluid_tensor(f, arr, lod=None):
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in _DTYPE_IDS:
        # bf16 (a bfloat16 model's state) has no reference VarType id —
        # export the f32 view; other unmapped dtypes fail loudly.  (Name
        # check: ml_dtypes' bfloat16 is not an np.floating subdtype.)
        if arr.dtype.name == "bfloat16" or np.issubdtype(arr.dtype, np.floating):
            arr = np.ascontiguousarray(arr.astype(np.float32))
        else:
            raise ValueError(
                "dtype %s has no reference VarType id (supported: %s)"
                % (arr.dtype, sorted(str(d) for d in _DTYPE_IDS)))
    f.write(struct.pack("<I", 0))
    lod = lod or []
    f.write(struct.pack("<Q", len(lod)))
    for level in lod:
        offs = np.asarray(level, "<u8")
        f.write(struct.pack("<Q", offs.nbytes))
        f.write(offs.tobytes())
    f.write(struct.pack("<I", 0))
    desc = _build_tensor_desc(arr)
    f.write(struct.pack("<i", len(desc)))
    f.write(desc)
    f.write(arr.tobytes())


def read_fluid_var_file(path):
    with open(path, "rb") as f:
        return read_fluid_tensor(f)


def write_fluid_var_file(path, arr, lod=None):
    with open(path, "wb") as f:
        write_fluid_tensor(f, arr, lod)


def read_fluid_combined(path, names):
    """A save_combine file: LoDTensor streams concatenated in the order of
    ``names`` (the reference stores no names — order comes from the
    program's save list)."""
    out = {}
    with open(path, "rb") as f:
        for name in names:
            arr, _ = read_fluid_tensor(f)
            out[name] = arr
        if f.read(1):
            raise ValueError("trailing bytes: name list shorter than file")
    return out


def _looks_like_fluid_tensor(path):
    """Cheap sniff: the first 4 bytes are the u32 version and must be 0.
    Distinguishes 'not a tensor file at all' (skip) from 'a tensor file
    that fails mid-read' (raise — silent skips would hand back a
    partially loaded model)."""
    try:
        with open(path, "rb") as f:
            head = f.read(4)
    except OSError:
        return False
    return len(head) == 4 and struct.unpack("<I", head)[0] == 0


def _scope_device(scope, name, device):
    """Where a loaded ``name`` goes: ``device`` if given, else the device
    of the tensor ``scope`` holds under that name, else of the first
    tensor it holds, else the card (:func:`resolve_device`)."""
    if device is not None:
        return resolve_device(device)
    held = scope[name] if name in scope else None
    if not isinstance(held, torch.Tensor):
        held = next((v for v in scope.vars.values()
                     if isinstance(v, torch.Tensor)), None)
    return held.device if held is not None else resolve_device(None)


def load_fluid_persistables(dirname, scope=None, names=None, device=None):
    """Load a reference ``save_persistables`` directory (one binary file
    per variable) into ``scope`` (or a returned dict of numpy arrays).
    Raises IOError on a truncated/corrupt tensor file instead of silently
    dropping the parameter.  In ``scope`` each value is a tensor in the
    file's dtype, on ``device`` (default: the device of the scope's
    tensors, see :func:`_scope_device`)."""
    out = {}
    for name in (names if names is not None else sorted(os.listdir(dirname))):
        path = os.path.join(dirname, name)
        if not os.path.isfile(path) or not _looks_like_fluid_tensor(path):
            continue
        try:
            arr, _lod = read_fluid_var_file(path)
        except (ValueError, struct.error) as e:
            raise IOError("corrupt fluid tensor file %r: %s" % (path, e))
        out[name] = arr
        if scope is not None:
            scope[name] = torch.from_numpy(arr).to(
                _scope_device(scope, name, device))
    return out


def save_fluid_persistables(dirname, state):
    """Write {name: array or tensor} in the reference's one-file-per-var
    layout, so the exported weights load back into the reference
    framework."""
    os.makedirs(dirname, exist_ok=True)
    for name, arr in state.items():
        write_fluid_var_file(os.path.join(dirname, name), as_numpy(arr))
