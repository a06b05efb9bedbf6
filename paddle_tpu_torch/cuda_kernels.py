"""Build and load the port's hand-written CUDA kernels.

The kernels live in ``paddle_tpu_torch/csrc/*.cu`` with a plain C
interface.  At first use they are compiled with ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``), one ``nvcc`` process per
source, all started together, and linked into one shared library under
``paddle_tpu_torch/_build/`` and loaded with ``ctypes``.  The library's
file name carries a hash of the sources and flags, so an edited source
rebuilds and a finished build is reused by later processes.  Nothing is
compiled or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["load_library", "build_info", "nvcc_path"]

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = (os.path.join(_HERE, "csrc", "paged_attention.cu"),
           os.path.join(_HERE, "csrc", "flash_attention.cu"))
# included by the sources; part of the build's hash
HEADERS = (os.path.join(_HERE, "csrc", "async_copy.cuh"),)
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# (name, argtypes): every pointer and the stream as c_void_p, strides as
# c_longlong
_SIGNATURES = (
    ("pt_paged_decode",
     [_P] * 7 + [_I] * 6 + [_F, _I, _I, _P]),
    ("pt_paged_prefill",
     [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P]),
    ("pt_flash_fwd",
     [_P] * 6 + [_I] * 5 + [_L] * 9 + [_I, _F, _I, _I, _P]),
    ("pt_flash_bwd",
     [_P] * 12 + [_I] * 5 + [_L] * 15 + [_I, _F, _I, _I, _P]),
    ("pt_flash_bwd_pair",
     [_P] * 11 + [_I] * 5 + [_L] * 15 + [_I, _F, _I, _I, _P]),
)

_lock = threading.Lock()
_lib = None
_info = {}


def nvcc_path():
    """The ``nvcc`` to build with: ``$CUDA_HOME/bin/nvcc``, then
    ``/usr/local/cuda/bin/nvcc``, then the one on ``PATH``; None if none
    exists."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cand = os.path.join(root, "bin", "nvcc")
            if os.path.exists(cand):
                return cand
    return shutil.which("nvcc")


def _digest():
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        with open(src, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _build(target):
    """One ``nvcc -c`` per source, all started together, then one link
    into ``target``."""
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (target, os.getpid())
    objs = ["%s.%d.%d.o" % (target, os.getpid(), i)
            for i in range(len(SOURCES))]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
            for src, obj in zip(SOURCES, objs)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    log = "".join(err for _, err in outs)
    for cmd, proc, (_, err) in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed (exit %d):\n%s\n%s"
                               % (proc.returncode, " ".join(cmd),
                                  err[-8000:]))
    link = [nvcc, "-shared", "-o", tmp, *objs]
    proc = subprocess.run(link, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc link failed (exit %d):\n%s\n%s"
                           % (proc.returncode, " ".join(link),
                              proc.stderr[-8000:]))
    seconds = time.perf_counter() - t0
    for obj in objs:
        os.remove(obj)
    os.replace(tmp, target)  # atomic: a concurrent build sees all or none
    return {"built": True, "seconds": seconds,
            "command": "; ".join(" ".join(c) for c in cmds + [link]),
            "log": log + proc.stderr}


def load_library():
    """The loaded kernel library (built first if needed).  Raises
    ``RuntimeError`` when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        target = os.path.join(BUILD_DIR, "kernels-%s.so" % _digest())
        info = {"built": False, "seconds": 0.0, "command": None, "log": ""}
        if not os.path.exists(target):
            info = _build(target)
        lib = ctypes.CDLL(target)
        for name, argtypes in _SIGNATURES:
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        info["path"] = target
        _info.update(info)
        _lib = lib
        return lib


def build_info():
    """What the last :func:`load_library` did: ``built`` (False when an
    earlier build was reused), ``seconds``, the nvcc ``command``, its
    ``log`` (``-Xptxas -v`` register and spill report) and the library
    ``path``.  Empty before the first load."""
    return dict(_info)
