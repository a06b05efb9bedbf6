"""The ctypes table of paddle_tpu_torch.cuda_kernels against the C
interface of the CUDA sources it loads.

Every ``extern "C" int pt_*(...)`` in ``paddle_tpu_torch/csrc/*.cu`` must
have an entry in ``cuda_kernels._SIGNATURES`` with the same number of
arguments, each of the matching ctypes kind: a pointer passed as a 32-bit
``c_int`` would be cut and crash the card far from the cause.  Runs on
the CPU: the sources are parsed, nothing is compiled.
"""
import ctypes
import glob
import os
import re

import pytest

from paddle_tpu_torch import cuda_kernels

CSRC = os.path.join(os.path.dirname(cuda_kernels.__file__), "csrc")
KINDS = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
         "float": ctypes.c_float, "long long": ctypes.c_longlong}


def _c_functions():
    """{name: [C type of each argument]} of every exported pt_* function."""
    found = {}
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu"))):
        text = open(path).read()
        for m in re.finditer(r'extern\s+"C"\s+int\s+(pt_\w+)\s*\(([^)]*)\)',
                             text):
            kinds = []
            for arg in m.group(2).split(","):
                words = arg.replace("*", " * ").split()
                words = [w for w in words if w != "const"][:-1]  # drop the name
                kind = " ".join(words).replace(" *", "*")
                kinds.append(kind)
            found[m.group(1)] = kinds
    return found


def test_every_exported_function_is_in_the_table_and_no_other():
    table = {name for name, _ in cuda_kernels._SIGNATURES}
    assert set(_c_functions()) == table
    assert len(table) == len(cuda_kernels._SIGNATURES)


@pytest.mark.parametrize("name", sorted(n for n, _ in cuda_kernels._SIGNATURES))
def test_argument_kinds_match(name):
    argtypes = dict(cuda_kernels._SIGNATURES)[name]
    kinds = _c_functions()[name]
    assert len(argtypes) == len(kinds)
    for i, (kind, argtype) in enumerate(zip(kinds, argtypes)):
        assert kind in KINDS, (name, i, kind)
        assert argtype is KINDS[kind], (name, i, kind, argtype)


def test_parser_reads_pointer_and_wide_kinds():
    kinds = _c_functions()["pt_flash_bwd_pair"]
    assert kinds[:11] == ["void*"] * 11
    assert kinds.count("long long") == 15 and kinds[-1] == "void*"
