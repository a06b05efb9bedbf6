"""Serving runtime of the port: continuous-batching generation.

Counterpart of ``paddle_tpu/serving``.  This slice carries the decode
path::

    from paddle_tpu_torch import serving
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

The engine and the model run on the card unless ``device="cpu"`` is
passed to both; without a GPU the default raises.  Admission keeps the
JAX package's contracts (priority lanes, bounded queue, deadlines, typed
errors); the predict path, replica pool, router, sessions and prefix
cache are not ported yet.
"""
from __future__ import annotations

from .decode_scheduler import (
    DecodeConfig,
    DecodeModel,
    DecodeScheduler,
    GenerateRequest,
)
from .engine import InferenceEngine
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
from .request_queue import PRIORITY_CLASSES, Request, RequestQueue
from .worker import RestartableWorker

__all__ = [
    "InferenceEngine",
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
