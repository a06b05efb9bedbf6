"""Serving runtime of the port: predict serving and continuous-batching
generation.

Counterpart of ``paddle_tpu/serving``.  Predict serving over a saved
inference model (the Program backend, or the ``torch.export`` AOT
backend)::

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import serving

    fluid.io.save_inference_model(model_dir, ["x"], [out], exe,
                                  main_program=test, aot=True)
    engine = serving.InferenceEngine(model_dir)          # on the card
    (probs,) = engine.predict({"x": batch})
    engine.stop()

and generation on the decode path::

    from paddle_tpu_torch.models import transformer as T

    params, meta = T.lm_params(vocab_size=32000, n_layer=12, n_head=8,
                               d_model=512, d_inner=2048, max_length=2048)
    engine = serving.InferenceEngine(
        decode_model=T.build_decode_model(params, meta),   # on the card
        decode_config=serving.DecodeConfig(num_slots=8, page_size=16,
                                           max_seq_len=2048,
                                           max_new_tokens=256))
    tokens = engine.generate(prompt_ids)                  # greedy
    engine.stop()

One engine may serve both (``model_dir`` and ``decode_model``).  The
engine and the model run on the card unless ``device="cpu"`` is passed
(to both, for a decode model); without a GPU the default raises.
Admission keeps the JAX package's contracts (priority lanes, bounded
queue, deadlines, typed errors, retry and bisection, the circuit breaker
and the worker supervisor); the replica pool, router, sessions and
prefix cache are not ported yet.
"""
from __future__ import annotations

from .batcher import CompletionTracker, DynamicBatcher
from .decode_scheduler import (
    DecodeConfig,
    DecodeModel,
    DecodeScheduler,
    GenerateRequest,
)
from .engine import BatchExecutor, InferenceEngine
from .errors import (
    KVCorruption,
    ServingCancelled,
    ServingClosed,
    ServingDegraded,
    ServingError,
    ServingOverloaded,
    ServingQueueFull,
    ServingQuotaExceeded,
    ServingTimeout,
)
from .kv_cache import PagedKVCache
from .model_store import LoadedModel, ModelStore
from .request_queue import PRIORITY_CLASSES, Request, RequestQueue
from .resilient import CircuitBreaker, ResilientDispatcher, WorkerSupervisor
from .worker import RestartableWorker

__all__ = [
    "InferenceEngine",
    "BatchExecutor",
    "DynamicBatcher",
    "CompletionTracker",
    "ModelStore",
    "LoadedModel",
    "CircuitBreaker",
    "ResilientDispatcher",
    "WorkerSupervisor",
    "DecodeScheduler",
    "DecodeModel",
    "DecodeConfig",
    "GenerateRequest",
    "PagedKVCache",
    "Request",
    "RequestQueue",
    "PRIORITY_CLASSES",
    "RestartableWorker",
    "ServingError",
    "ServingTimeout",
    "ServingQueueFull",
    "ServingOverloaded",
    "ServingQuotaExceeded",
    "ServingDegraded",
    "ServingClosed",
    "ServingCancelled",
    "KVCorruption",
]
