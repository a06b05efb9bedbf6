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
  (``csrc/paged_attention.cu``), or the legacy whole-prompt prefill on
  the flash forward kernel
  (``models.transformer.build_decode_model(..., chunked=False)``);
* the core IR — conv/pool/loss/metric ops, every update rule,
  ``backward.calc_gradient``, ``lod`` and ``DataFeeder``:
  ``models.mnist.get_model()`` (LeNet) trains through ``Executor.run``.
* predict serving — ``io.save_inference_model`` (the JAX package's
  on-disk format, plus a ``torch.export`` artifact with ``aot=True``)
  and ``serving.InferenceEngine(model_dir=...)``: dynamic batching over
  the Program or the exported graph, with retry, bisection, a circuit
  breaker, a worker supervisor and hot swap; Transformer-base scoring
  runs the flash forward kernel in both.
* ResNet — ``models.resnet.get_model()`` (ResNet-50 by default: conv2d,
  batch_norm, pool2d, momentum) trains through ``Executor.run``, and
  ``InferenceTranspiler`` folds each batch_norm of its test Program into
  the conv before it.
* the runtime around the step — ``Trainer`` (atomic checkpoints, bitwise
  resume, ``nan_guard`` rewind, ``FailureMonitor``), ``Inferencer``, the
  ``reader`` decorators, ``layers.py_reader`` and the device prefetch
  pipeline (``reader.device_prefetch``, a side CUDA stream).
* the one-card parallel surface — ``ParallelExecutor``,
  ``Trainer(parallel=...)`` and ``Executor.attach_mesh`` on a mesh of
  one device, ``layers.Pipeline`` (stages in sequence over
  microbatches), ``layers.switch_moe`` (dense top-1) and
  ``parallel.microbatch``; and ``contrib``'s decoder API
  (``TrainingDecoder``, ``BeamSearchDecoder``).
* the multi-rank engines over ranks that share the card (dp x tp, ZeRO,
  sp, ``ep``, ``pp``), and parameter servers: ``DistributeTranspiler``
  splits a Program into trainer and pserver Programs, and
  ``Executor.run`` serves the one (the optimize block applied on the
  pserver's device) and trains the other over TCP, with ``discovery``'s
  registry and ``reader.master``'s task queue beside them.

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
from . import nets
from . import optimizer
from . import regularizer
from . import clip
from . import backward
from . import profiler
from . import executor
from . import lod
from . import data_feeder
from . import program_fn
from . import resilience
from . import io
from . import contrib, models, observability, parallel, serving, transpiler
from . import reader
from . import trainer
from . import trainer as trainer_mod
from .reader import batch
from .trainer import (BeginEpochEvent, BeginStepEvent, CheckpointConfig,
                      EndEpochEvent, EndStepEvent, FailureMonitor,
                      Inferencer, Trainer, load_checkpoint, save_checkpoint)
from .core import CPUPlace, CUDAPlace, resolve_device
from .data_feeder import DataFeeder
from .executor import (Executor, Scope, global_scope, load_numpy_state,
                       scope_guard)
from . import parallel_executor
from .parallel_executor import (BuildStrategy, ExecutionStrategy,
                                ParallelExecutor)
from .framework import (
    Program,
    Variable,
    default_main_program,
    default_startup_program,
    name_scope,
    program_guard,
)
from .lod import (LoDArray, LoDTensorArray, create_lod_array,
                  create_lod_tensor, create_random_int_lodtensor)
from .param_attr import ParamAttr, WeightNormParamAttr
from .transpiler import (DistributeTranspiler, DistributeTranspilerConfig,
                         InferenceTranspiler, memory_optimize, release_memory)

# the reference's top-level spelling takes the lengths as optional
create_lod_tensor = create_lod_array

__all__ = [
    "core", "unique_name", "framework", "initializer", "layers", "nets",
    "optimizer", "regularizer", "clip", "backward", "executor", "lod",
    "data_feeder", "program_fn", "resilience", "io", "models", "profiler",
    "observability", "parallel", "serving", "transpiler", "CPUPlace",
    "CUDAPlace", "DistributeTranspiler", "DistributeTranspilerConfig",
    "InferenceTranspiler", "memory_optimize", "release_memory",
    "resolve_device", "Executor", "ParallelExecutor", "ExecutionStrategy",
    "BuildStrategy", "Scope", "global_scope",
    "load_numpy_state", "scope_guard", "Program", "Variable",
    "default_main_program", "default_startup_program", "name_scope",
    "program_guard", "ParamAttr", "WeightNormParamAttr", "DataFeeder",
    "LoDArray", "LoDTensorArray", "create_lod_array", "create_lod_tensor",
    "create_random_int_lodtensor", "reader", "batch", "trainer",
    "trainer_mod", "Trainer", "Inferencer", "CheckpointConfig",
    "BeginEpochEvent", "EndEpochEvent", "BeginStepEvent", "EndStepEvent",
    "save_checkpoint", "load_checkpoint", "FailureMonitor",
]
