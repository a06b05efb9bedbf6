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
and the worker supervisor).  :class:`ReplicaPool` serves either path from
N replicas over one shared queue (on one card, N replicas on ``cuda:0``,
each on its own CUDA stream)::

    pool = serving.ReplicaPool(model_dir, replicas=2,
                               decode_model=model, decode_config=cfg)
    tokens = pool.generate(prompt_ids)
    pool.swap_model(new_model_dir)                      # rolling
    pool.stop()

With ``DecodeConfig(prefix_cache=True)`` the pool keeps conversations
(:class:`SessionStore`): ``pool.generate(history, session="user-42")``
parks the turn's KV pages pinned on the replica that served it and
routes the next turn there; ``roles=("prefill", "decode", ...)`` splits
the replicas into prefill and decode roles, the KV crossing between them
as a host-staged ``HandoffPacket``.

:class:`ModelRouter` fronts N named deployments, each version served by
a pool of its own, with tenant quotas (:class:`TenantQuota`), weighted
canary routing with one-call rollback, and warm and cold tiers under a
global replica budget: a request to a cold version parks on a
:class:`RoutedRequest` while its pool is built, and the least-recently
used warm version is deactivated to make room (its pool stops and gives
back its graphs, KV pools and streams)::

    router = serving.ModelRouter(replica_budget=4)      # pools on the card
    router.deploy("scorer", v1_dir, version="v1", replicas=1)
    router.deploy("scorer", v2_dir, version="v2", replicas=1)
    router.route("scorer", {"v1": 0.75, "v2": 0.25})
    router.deploy("chat", None, replicas=2, warm=False,
                  decode_model=model, decode_config=cfg)
    router.set_quota("tenant-a", rows_per_s=100, max_inflight=8)
    tokens = router.generate("chat", prompt_ids, tenant="tenant-a")
    router.stop()
"""
from __future__ import annotations

from .batcher import CompletionTracker, DynamicBatcher
from .decode_scheduler import (
    DecodeConfig,
    DecodeJournal,
    DecodeModel,
    DecodeScheduler,
    GenerateRequest,
    HandoffPacket,
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
from .kv_cache import PagedKVCache, write_prompt_kv, write_token_kv
from .model_store import LoadedModel, ModelStore
from .replica_pool import ReplicaPool
from .request_queue import PRIORITY_CLASSES, Request, RequestQueue
from .resilient import CircuitBreaker, ResilientDispatcher, WorkerSupervisor
from .router import ModelRouter, RoutedRequest, TenantQuota
from .sessions import SessionRecord, SessionStore, scoped_session
from .worker import RestartableWorker

__all__ = [
    "InferenceEngine",
    "ReplicaPool",
    "ModelRouter",
    "TenantQuota",
    "RoutedRequest",
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
    "DecodeJournal",
    "GenerateRequest",
    "HandoffPacket",
    "SessionStore",
    "SessionRecord",
    "scoped_session",
    "PagedKVCache",
    "write_prompt_kv",
    "write_token_kv",
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
