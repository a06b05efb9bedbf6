"""paddle_tpu_torch stands alone: no jax, nothing of paddle_tpu.

The import check runs in a subprocess with ``jax`` blocked, because this
test process (tests/conftest.py) has already imported jax and
paddle_tpu.  The same subprocess checks that the entry points (the
serving engine and model, ``Executor``, ``CUDAPlace``,
``load_numpy_state``) default to the card and raise when there is none.
"""
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "paddle_tpu_torch")

_CHILD = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises
import torch
import paddle_tpu_torch
names = ["paddle_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                          "paddle_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "paddle_tpu" or m.startswith("paddle_tpu."))
assert not leaked, leaked
assert not torch.cuda.is_available()
from paddle_tpu_torch import serving
from paddle_tpu_torch.models import transformer as T
params, meta = T.lm_params(vocab_size=11, n_layer=1, n_head=1, d_model=32,
                           d_inner=8, max_length=16)
for call in (lambda: T.build_decode_model(params, meta),
             lambda: T.params_from_numpy(params, meta=meta),
             lambda: serving.InferenceEngine(
                 decode_model=T.build_decode_model(params, meta,
                                                   device="cpu"))):
    try:
        call()
    except RuntimeError as exc:
        assert "CUDA" in str(exc), exc
    else:
        raise AssertionError("an entry point ran without a GPU")
import paddle_tpu_torch as fluid
main = fluid.Program()
for call in (lambda: fluid.Executor(), lambda: fluid.Executor(place=None),
             lambda: fluid.Executor(device=None),
             lambda: fluid.CUDAPlace(0),
             lambda: fluid.load_numpy_state(main, {})):
    try:
        call()
    except RuntimeError as exc:
        assert "CUDA" in str(exc), exc
    else:
        raise AssertionError("a Fluid entry point ran without a GPU")
assert fluid.Executor(fluid.CPUPlace()).device.type == "cpu"
print("OK", len(names))
"""


def test_imports_without_jax_or_paddle_tpu():
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("OK")
    assert int(proc.stdout.split()[1]) >= 30   # every module was walked


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+paddle_tpu\b(?!_torch)"
    r"|from\s+paddle_tpu\b(?!_torch)|from\s+\.\.\.)", re.M)


@pytest.mark.parametrize("path", sorted(
    os.path.join(root, f) for root, _, files in os.walk(PKG)
    for f in files if f.endswith(".py")))
def test_source_imports_neither_jax_nor_paddle_tpu(path):
    with open(path) as f:
        src = f.read()
    assert not _FORBIDDEN.search(src), os.path.relpath(path, REPO)
