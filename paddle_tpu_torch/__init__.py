"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

A second package beside the JAX one, which stays the reference it is
held against.  It imports torch and numpy, never jax and nothing of
``paddle_tpu``.  The port goes slice by slice:

* training — the Fluid surface (``Program``, ``layers``, ``optimizer``,
  ``Executor``): ``models.transformer.get_model(use_flash=True)`` trains
  through ``Executor.run``, with the flash attention forward and fused
  backward as hand-written CUDA kernels for Hopper
  (``csrc/flash_attention.cu``);
* decode serving — ``serving.InferenceEngine(decode_model=...)``, with
  the paged decode and paged prefill attention as CUDA kernels
  (``csrc/paged_attention.cu``).

Use it like the JAX package::

    import paddle_tpu_torch as fluid
    exe = fluid.Executor(fluid.CUDAPlace(0))

Entry points run on the card: ``Executor()``, ``CUDAPlace`` and every
``device=None`` resolve to ``cuda`` and raise when no GPU is present.
Pass ``fluid.CPUPlace()`` / ``device="cpu"`` to run the plain PyTorch
versions instead (the tests do).
"""
from __future__ import annotations

from . import ops as _ops  # registers the op rules  # noqa: F401

from . import core
from . import unique_name
from . import framework
from . import initializer
from . import layers
from . import optimizer
from . import regularizer
from . import clip
from . import backward
from . import executor
from . import models, observability, parallel, serving
from .core import CPUPlace, CUDAPlace, resolve_device
from .executor import (Executor, Scope, global_scope, load_numpy_state,
                       scope_guard)
from .framework import (
    Program,
    Variable,
    default_main_program,
    default_startup_program,
    name_scope,
    program_guard,
)
from .param_attr import ParamAttr, WeightNormParamAttr

__all__ = [
    "core", "unique_name", "framework", "initializer", "layers",
    "optimizer", "regularizer", "clip", "backward", "executor", "models",
    "observability", "parallel", "serving", "CPUPlace", "CUDAPlace",
    "resolve_device", "Executor", "Scope", "global_scope",
    "load_numpy_state", "scope_guard", "Program", "Variable",
    "default_main_program", "default_startup_program", "name_scope",
    "program_guard", "ParamAttr", "WeightNormParamAttr",
]
