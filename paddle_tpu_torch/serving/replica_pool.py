"""Multi-replica serving: N model replicas over one shared queue.

Counterpart of ``paddle_tpu/serving/replica_pool.py`` (the Clipper,
NSDI'17, layered answer scaled across replicas).  N *replicas* — each a
model copy with its own warmed bucket ladder on its own device — are fed
from ONE shared priority :class:`~.request_queue.RequestQueue`, so the
serving policies stay global:

* **admission** (typed backpressure, per-class capacity, deadline-aware
  shedding) happens once, at the shared queue, and the shed estimator
  knows the rotation width (``RequestQueue.set_parallelism``);
* **dispatch is pull-based least-loaded**: every replica runs its own
  :class:`~.batcher.DynamicBatcher` worker against the shared queue and
  claims a batch only when its previous dispatch finished.  A *gate*
  checked before every claim is how a replica leaves the rotation
  without losing its thread, model or graphs: breaker open (ejected),
  rolling-swap drain, or autoscale quiesce (parked warm);
* **health is per replica**: a :class:`~.resilient.CircuitBreaker` each
  (consecutive fatal dispatches eject exactly that replica; its
  half-open probe re-admits it) and a supervised worker (a killed
  replica thread is restarted in place, its in-flight batch failed
  typed, while the siblings absorb the queue);
* **rolling hot swap**: :meth:`ReplicaPool.swap_model` drains and flips
  ONE replica at a time under live traffic, so serving capacity never
  reaches zero; the old version's graphs and their pool are freed at
  each flip (``LoadedModel.close``);
* **autoscale**: :meth:`ReplicaPool.autoscale_tick` applies
  ``serving.autoscale.desired_replicas`` (the ``SLOMonitor`` signal)
  within ``[min_replicas, max_replicas]``: scale-up at once, scale-down
  only after ``scale_down_after_s`` of lower desire.
  :meth:`ReplicaPool.start_autoscaler` loops it from an in-process
  monitor, the published gauge, or a ``/metrics`` scrape.

**Devices.**  ``devices=None`` means every CUDA device and raises
without one; replica ``i`` runs on ``devices[i % len(devices)]``, so on
one card every replica shares ``cuda:0`` (the JAX pool puts one replica
on each chip).  Each replica on the card holds a stream of its own,
leased from the port's fixed set (:mod:`paddle_tpu_torch.streams`) and
given back, with its capture side streams, when the pool stops: its
predict dispatches and its decode worker's loop run on it, so one
replica's read of its results waits for its own work only and the
replicas' kernels overlap while another replica's host code runs.
Warm-up and every capture run on the constructing thread (under the
executor's capture lock), from a stream of the replica's own: captures
are made on a capture stream for each stream they are made from, and a
captured cuBLAS call keeps its capture stream's workspace, so two
replicas' graphs replayed at once never share one.  A decode replica
warms from its worker's stream; a predict version is loaded, warmed and
captured from one of its replica's two load streams, in turn, so that a
rolling swap frees the old version's allocator segments whole.  The
device is synchronized once after the last replica warms (and after
each swapped version warms), before a worker uses it.  Tests pass
``devices=["cpu"]``.

Bitwise contract: every replica runs the same graphs at the same shapes
and a request's rows are computed independently of their neighbours, so
each answer is bitwise the single engine's, whichever replica serves it.

**Pool-routed decode**: with ``decode_model=`` every replica runs its
own :class:`~.decode_scheduler.DecodeScheduler` (own ``PagedKVCache``,
own step graphs and their pools, own breaker
``serving.replica.decode_breaker_<i>``) over the ONE shared
``DecodeModel``, whose weights are read-only on ``model.device``;
replicas on another device raise (placement on other cards is ROADMAP
A11.4).
A shared decode queue is claimed least-loaded by free slots (ties claim)
with prefix affinity: a head whose prompt's warm pages live on one
replica waits there while the hint is fresh.  Generation is durable: when
a replica's decode worker dies, the supervisor's restart wrapper harvests
its in-flight sequences (``evict_if_dead``) and re-admits them; a sibling
re-prefills ``prompt + accepted`` and continues the same tokens (a
seedless request's seed is pinned at pool admission).  Re-admissions
count on ``serving.decode.replays`` against
``DecodeConfig.replay_budget``, past which the sequence fails with
``ServingDegraded``.

**Sessions** (:mod:`~.sessions`): with ``DecodeConfig(prefix_cache=
True)`` the pool keeps a :class:`~.sessions.SessionStore` (``sessions=
None``; ``False`` turns it off, a store is used as given).  A turn
generated with ``session=`` parks on the replica that served it (its
prefill-written full pages registered and pinned there), and the next
turn's admission stamps that replica as its affinity
(``serving.affinity.sticky``) unless it is draining, parked,
breaker-open or dead (``serving.affinity.fallbacks``): then the prefix
peek and least-loaded decide, and the sibling prefills the history
cold.  The store's TTL sweep runs from the decode gate at most once a
second; ``end_session`` and ``stop()`` release the pins on each owner's
worker.

**Roles** (``roles=``, one of ``"both"``/``"prefill"``/``"decode"`` a
replica): a decode-role replica never claims from the queue; a
prefill-role replica prefills, stages the sequence's KV pages in pinned
host memory as a :class:`~.decode_scheduler.HandoffPacket` and
:meth:`ReplicaPool._dispatch_handoff` gives it to the decode-capable
replica with the most free slots (ready ones first; a quiesced or
draining replica still takes packets), which writes it into its own
pages and decodes on.  The KV crosses through the host even on one card,
so a waiting packet holds no pool pages.

Telemetry, as the JAX package's: ``serving.replica.pool_size`` /
``.active`` / ``.ready``; per replica ``serving.replica.state_<i>`` (0
parked / 1 serving / 2 draining / 3 ejected / 4 dead),
``.inflight_rows_<i>``, ``.breaker_<i>``, ``.dispatches_<i>``,
``.rows_<i>``; ``serving.replica.scale_ups`` / ``.scale_downs`` with a
``replica_scale`` record; ``serving.replica.swapped`` with
``replica_swap`` records; every execute span a replica emits carries its
``replica`` index.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
import weakref

import numpy as np
import torch

from .. import observability as _obs
from .. import streams as _streams
from ..core import resolve_device
from ..executor import SERVING_BLOCK_ROWS
from .batcher import CompletionTracker, DynamicBatcher
from .decode_scheduler import DecodeConfig, DecodeScheduler, GenerateRequest
from .engine import BatchExecutor, normalize_feed
from .errors import ServingClosed, ServingDegraded, ServingError
from .model_store import ModelStore
from .request_queue import PRIORITY_CLASSES, Request, RequestQueue
from .resilient import CircuitBreaker, ResilientDispatcher, WorkerSupervisor
from .sessions import SessionStore

__all__ = ["ReplicaPool"]

_requests = _obs.counter("serving.requests")
_swaps = _obs.counter("serving.swaps")
_pool_size_gauge = _obs.gauge("serving.replica.pool_size")
_active_gauge = _obs.gauge("serving.replica.active")
_ready_gauge = _obs.gauge("serving.replica.ready")
_scale_ups = _obs.counter("serving.replica.scale_ups")
_scale_downs = _obs.counter("serving.replica.scale_downs")
_replica_swapped = _obs.counter("serving.replica.swapped")
# shared by name with decode_scheduler.py
_decode_requests = _obs.counter("serving.decode.requests")
_decode_replays = _obs.counter("serving.decode.replays")
# prefix-affinity dispatch: how each admission was routed (the warm
# replica of its prompt's prefix, or no hint) and how often a stamped
# hint was stripped because its replica could not take the work in time
_affinity_sticky = _obs.counter("serving.affinity.sticky")
_affinity_prefix = _obs.counter("serving.affinity.prefix")
_affinity_none = _obs.counter("serving.affinity.none")
_affinity_fallbacks = _obs.counter("serving.affinity.fallbacks")

#: serving.replica.state_<i> gauge codes
REPLICA_STATES = {"parked": 0, "serving": 1, "draining": 2, "ejected": 3,
                  "dead": 4}

# consumer-group keys of pools sharing one RequestQueue
_POOL_IDS = itertools.count()


def _pool_devices(devices):
    """The replicas' devices: ``devices`` resolved, or every CUDA device
    (raising through ``resolve_device`` without one)."""
    if devices is None:
        resolve_device(None)
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [resolve_device(d) for d in devices]


def _on(stream):
    """Run on ``stream`` (a replica's CUDA stream), or on the current
    stream where it is None (the CPU)."""
    return (contextlib.nullcontext() if stream is None
            else torch.cuda.stream(stream))


def _blas_handle(device):
    """This thread's cuBLAS handle on ``device``: the warm-up runs it
    makes on a replica's streams use it (``streams.py``)."""
    with torch.cuda.device(device):
        return torch.cuda.current_blas_handle()


def _synchronize(devices):
    """Wait for the work queued so far on every CUDA device in
    ``devices``: the loads, warm-ups and captures made on the
    constructing thread, before a worker on a replica's stream uses what
    they made."""
    for dev in {d for d in devices if d.type == "cuda"}:
        torch.cuda.synchronize(dev)


def _release_all(leases):
    for lease in leases:
        lease.release()


class _Replica:
    """One model copy on one device, with its own worker, breaker,
    dispatch pipeline, accounting and, on the card, its own stream.  The
    scheduling flags (``active``/``draining``/``failed``) are written by
    the pool and read by the worker at its gate, without a lock."""

    def __init__(self, pool, index, device):
        self.index = index
        self.device = device
        # the replica's streams and their capture side streams, leased
        # from the port's fixed set while the replica lives: no other
        # live holder has one of them (streams.py)
        self.lease = _streams.Lease("%s replica %d" % (pool._consumer_key,
                                                       index))
        # the constructing thread's cuBLAS handle: its warm-up runs on
        # these streams (streams.py prefers streams it has marked)
        self.blas = _blas_handle(device) if device.type == "cuda" else None
        self.stream = (self.lease.stream(_streams.device_index(device),
                                         self.blas)
                       if device.type == "cuda" else None)
        # the streams a predict version is loaded, warmed and captured on,
        # in turn, leased at the first load: the caching allocator keeps a
        # stream's free blocks for that stream, so a version's weights
        # (uploaded at its first run) share no segment with its
        # predecessor's or with the worker's transient blocks, and the
        # predecessor's segments come back whole when it closes (a
        # rolling swap does not fragment them)
        self._load_streams = (None, None)
        self._loads = 0
        self.store = ModelStore(place=device, feed_shapes=pool._feed_shapes,
                                block_rows=SERVING_BLOCK_ROWS)
        self.model = None
        self.model_lock = threading.Lock()
        self.active = True          # in the rotation (autoscale flag)
        self.draining = False       # rolling-swap pause
        self.failed = False         # worker dead past its restart budget
        self.force_serve = False    # pool stop-drain: bypass the breaker
        self.decoder = None         # DecodeScheduler (decode_model= pools)
        self.role = "both"          # decode role (ReplicaPool roles=)
        self.decode_breaker = None
        self.decode_failed = False  # decode worker dead past its budget
        self.inflight_rows = 0      # rows the worker is dispatching now
        self.dispatches = 0
        self.rows_served = 0
        # the last instant the worker was seen PARKED at the gate: the
        # drain handshake (a single-threaded worker parked after the
        # drain began has no dispatch in flight)
        self.parked_ts = 0.0
        self.breaker = CircuitBreaker(
            threshold=pool._breaker_threshold,
            cooldown_s=pool._breaker_cooldown_s,
            state_gauge=_obs.gauge("serving.replica.breaker_%d" % index))
        self._core = BatchExecutor(
            self._current_model, pool.batch_buckets,
            queue_depth=pool._queue.depth, tags={"replica": index})
        self.dispatcher = ResilientDispatcher(
            self._execute, max_retries=pool._execute_retries,
            breaker=self.breaker)
        self.batcher = DynamicBatcher(
            pool._queue, self.dispatcher, pool.max_batch_size,
            pool.batch_timeout_ms / 1e3,
            name="paddle-tpu-torch-serving-replica%d" % index,
            tracker=pool._tracker, gate=self._gate,
            label="replica%d" % index,
            service_key=pool._consumer_key,
            owns_queue=pool._owns_queue)
        self._inflight_gauge = _obs.gauge(
            "serving.replica.inflight_rows_%d" % index)
        self._state_gauge = _obs.gauge("serving.replica.state_%d" % index)
        self._dispatch_counter = _obs.counter(
            "serving.replica.dispatches_%d" % index)
        self._rows_counter = _obs.counter("serving.replica.rows_%d" % index)

    # -- model ---------------------------------------------------------------
    def mark_warm(self, stream):
        """This thread ran cuBLAS on ``stream`` (a warm-up)."""
        if stream is not None:
            self.lease.mark(_streams.device_index(self.device), stream,
                            _blas_handle(self.device))

    def _current_model(self):
        with self.model_lock:
            return self.model

    def next_load_stream(self):
        """The load stream of this replica's next version (None on the
        CPU): its loads, warm-up runs and captures run from it, so its
        graphs also get a capture stream, and a cuBLAS workspace, that
        no other replica's graphs use."""
        if self.stream is not None and self._load_streams[0] is None:
            index = _streams.device_index(self.device)
            self._load_streams = (self.lease.stream(index, self.blas),
                                  self.lease.stream(index, self.blas))
        stream = self._load_streams[self._loads % 2]
        self._loads += 1
        return stream

    # -- worker hot path -----------------------------------------------------
    def _gate(self):
        """Checked by the worker before every queue claim; False parks it
        (the request stays in the shared queue for the other replicas)."""
        if self.force_serve and self.model is not None and not self.failed:
            # pool stop-drain: every queued request must reach a terminal
            # outcome now; the dispatcher fails them typed if the path is
            # truly dead
            return True
        if (not self.active or self.draining or self.failed
                or self.model is None or not self.breaker.allow()):
            self.parked_ts = time.perf_counter()
            return False
        return True

    def _execute(self, requests):
        """One dispatch ATTEMPT (retries and bisected sub-batches re-enter
        here), on this replica's stream, with in-flight accounting."""
        rows = sum(r.rows for r in requests)
        self.inflight_rows += rows
        self._inflight_gauge.set(self.inflight_rows)
        try:
            if self.stream is None:
                self._core(requests)
            else:
                with torch.cuda.stream(self.stream):
                    self._core(requests)
            self.rows_served += rows
            self._rows_counter.inc(rows)
        finally:
            # runs for BaseException too (kill_worker): the accounting
            # holds even as the worker thread dies
            self.inflight_rows -= rows
            self._inflight_gauge.set(self.inflight_rows)
            self.dispatches += 1
            self._dispatch_counter.inc()

    # -- health --------------------------------------------------------------
    def wait_quiescent(self, since, timeout):
        """Block until this replica provably has no dispatch in flight:
        its worker was seen parked at the (now closed) gate after
        ``since``, or the worker is dead with nothing in flight.  False on
        timeout."""
        deadline = time.perf_counter() + timeout
        while True:
            if self.parked_ts > since:
                return True
            if not self.batcher.alive and self.inflight_rows == 0:
                return True
            if time.perf_counter() >= deadline:
                return False
            time.sleep(0.002)

    def state(self):
        if self.model is not None:
            alive, failed, breaker = (self.batcher.alive, self.failed,
                                      self.breaker)
        else:   # a decode-only replica starts no predict worker
            alive, failed, breaker = (self.decoder.alive,
                                      self.decode_failed,
                                      self.decode_breaker)
        if not alive or failed:
            return "dead"
        if breaker.state == "open":
            return "ejected"
        if self.draining:
            return "draining"
        if not self.active:
            return "parked"
        return "serving"

    def ready(self):
        """In the rotation and able to claim work right now."""
        return (self.active and not self.draining and not self.failed
                and self.model is not None and self.batcher.alive
                and self.breaker.state != "open")

    def admissible(self):
        """Could serve an admitted request soon: not failed past its
        budget and not breaker-open (a parked, draining or restarting
        replica counts)."""
        return (not self.failed and self.model is not None
                and self.breaker.state != "open")

    def publish(self):
        self._state_gauge.set(REPLICA_STATES[self.state()])

    def stats(self):
        st = {
            "index": self.index,
            "device": str(self.device),
            "state": self.state(),
            "ready": self.ready(),
            "model_version": None if self.model is None
            else self.model.version,
            "worker_alive": self.batcher.alive,
            "breaker": self.breaker.state,
            "inflight_rows": self.inflight_rows,
            "dispatches": self.dispatches,
            "rows_served": self.rows_served,
            "batches": self.batcher.batches,
        }
        if self.decoder is not None:
            d = self.decoder.stats()
            d.update(alive=self.decoder.alive, failed=self.decode_failed,
                     breaker=self.decode_breaker.state,
                     free_slots=self.decoder.free_slots())
            st["decode"] = d
        return st


class ReplicaPool:
    """Serve a saved inference model, a decode model, or both, from N
    replicas.

    The surface mirrors :class:`~.engine.InferenceEngine` (``predict`` /
    ``predict_async`` / ``generate`` / ``generate_async`` /
    ``swap_model`` / ``health`` / ``ready`` / ``stop`` /
    ``serve_metrics``), so code written against the engine (the SLO
    monitor, a client) scales to a pool by swapping the constructor.

    Parameters beyond the engine's, which keep their meaning:

    replicas: pool size (default one a device).  Replica ``i`` runs on
        ``devices[i % len(devices)]``.
    devices: device list (strings, ``torch.device`` or Places); None is
        every CUDA device and raises without a GPU.
    min_replicas / max_replicas: autoscale clamp on the ACTIVE rotation
        (the pool's size is fixed; a quiesced replica parks warm).
        Defaults 1 / ``replicas``.
    initial_replicas: rotation size at start (default: all).
    scale_down_after_s: desired must stay below the active count this
        long before a scale-down applies (scale-up is immediate).
    decode_model / decode_config: pool-routed generation (see the module
        docstring); ``model_dir=None`` builds a decode-only pool.
    queue / tracker: share one admission ``RequestQueue`` and
        ``CompletionTracker`` with other pools; the pool then never
        closes or drains the queue.
    model_label: deployment label stamped on every admitted request.
    sessions: None builds a :class:`~.sessions.SessionStore` when the
        decode config has ``prefix_cache``; False disables sessions; a
        store is used as given (it requires ``prefix_cache``).
    roles: one decode role a replica (``"both"``, ``"prefill"``,
        ``"decode"``), at least one prefill-capable and one
        decode-capable; requires ``decode_model``.
    affinity_timeout_s: how long a prefix-affinity hint holds a queue
        head for its replica (0 disables hints).
    """

    def __init__(self, model_dir, replicas=None, devices=None,
                 min_replicas=1, max_replicas=None, initial_replicas=None,
                 batch_buckets=(2, 4, 8, 16), max_batch_size=None,
                 batch_timeout_ms=0.0, queue_capacity=256,
                 class_capacity=None, default_deadline_ms=None,
                 backend="auto", feed_shapes=None, warmup=True,
                 autostart=True, execute_retries=2, breaker_threshold=5,
                 breaker_cooldown_s=1.0, supervise=True,
                 worker_max_restarts=3, supervisor_interval_s=0.1,
                 scale_down_after_s=5.0, decode_model=None,
                 decode_config=None, queue=None, tracker=None,
                 model_label=None, sessions=None, roles=None,
                 affinity_timeout_s=1.0):
        if model_dir is None and decode_model is None:
            raise ServingError(
                "pass model_dir= (predict), decode_model= (generate), "
                "or both — an empty pool serves nothing")
        buckets = sorted(set(int(b) for b in batch_buckets))
        if not buckets or buckets[0] < 1:
            raise ValueError("batch_buckets must be positive ints, got %r"
                             % (batch_buckets,))
        self.batch_buckets = tuple(buckets)
        self.max_batch_size = int(max_batch_size or buckets[-1])
        self.batch_timeout_ms = float(batch_timeout_ms)
        self.default_deadline_ms = default_deadline_ms
        self._warmup = bool(warmup)
        self._feed_shapes = feed_shapes
        self._execute_retries = int(execute_retries)
        self._breaker_threshold = breaker_threshold
        self._breaker_cooldown_s = float(breaker_cooldown_s)
        devices = _pool_devices(devices)
        if not devices:
            raise ServingError("no devices available for a replica pool")
        n = int(replicas) if replicas is not None else len(devices)
        if n < 1:
            raise ValueError("replicas must be >= 1")
        placement = [devices[i % len(devices)] for i in range(n)]
        if decode_model is not None:
            away = sorted({str(d) for d in placement
                           if d != decode_model.device})
            if away:
                raise NotImplementedError(
                    "decode replicas on %s, but the decode model lives on "
                    "%s: placing a decode model's replicas on other "
                    "devices is not ported yet (ROADMAP A11.4)"
                    % (", ".join(away), decode_model.device))
        self.min_replicas = max(1, int(min_replicas))
        self.max_replicas = min(n, int(max_replicas)) if max_replicas \
            else n
        if self.min_replicas > self.max_replicas:
            raise ValueError("min_replicas %d > max_replicas %d"
                             % (self.min_replicas, self.max_replicas))
        self.scale_down_after_s = float(scale_down_after_s)
        self._state = "loading"
        self.model_label = model_label
        self._owns_queue = queue is None
        self._queue = queue if queue is not None else RequestQueue(
            queue_capacity, class_capacity=class_capacity)
        self._tracker = tracker if tracker is not None \
            else CompletionTracker()
        self._consumer_key = "%s#%d" % (model_label or "pool",
                                        next(_POOL_IDS))
        self._swap_lock = threading.Lock()
        self._scale_lock = threading.Lock()
        self._below_since = None      # scale-down hysteresis window start
        self._below_peak = 0          # max desired seen inside the window
        self._telemetry = _obs.get_telemetry()
        self._metrics_server = None
        self._replicas = []
        # a pool collected without stop() gives its streams back too (the
        # callback holds the leases, not the pool)
        leases = []
        weakref.finalize(self, _release_all, leases)
        try:
            for i, d in enumerate(placement):
                self._replicas.append(_Replica(self, i, d))
                leases.append(self._replicas[-1].lease)
            if model_dir is not None:
                # each replica's own version: its own executor, bucket graphs
                # and graph pool, or its own exported graph
                for rep in self._replicas:
                    load_stream = rep.next_load_stream()
                    with _on(load_stream):
                        rep.model = rep.store.load(model_dir, backend=backend)
                        if self._warmup:
                            rep.model.warmup(self.batch_buckets)
                            rep.mark_warm(load_stream)
            active0 = self.max_replicas if initial_replicas is None else max(
                self.min_replicas, min(int(initial_replicas),
                                       self.max_replicas))
            for rep in self._replicas:
                rep.active = rep.index < active0
            # the live consumer count for the shed estimator, as a consumer
            # group keyed by this pool (a shared queue sums the groups)
            self._queue.register_consumers(self._consumer_key,
                                           lambda: len(self._ready()))
            if self._owns_queue:
                self._queue.set_parallelism(lambda: max(1, len(self._ready())))
            self._decode_enabled = decode_model is not None
            self._decode_config = None
            self._decode_queue = None
            self._sessions = None
            self._affinity_timeout_s = float(affinity_timeout_s)
            self._session_sweep_ts = time.perf_counter()
            self._roles = None
            if roles is not None and decode_model is None:
                raise ServingError(
                    "roles= specializes DECODE replicas; pass decode_model=")
            if self._decode_enabled:
                dcfg = self._decode_config = decode_config or DecodeConfig()
                if roles is not None:
                    role_list = [str(r) for r in roles]
                    if len(role_list) != n:
                        raise ServingError(
                            "roles needs one entry per replica (%d), got %d"
                            % (n, len(role_list)))
                    bad = [r for r in role_list
                           if r not in ("both", "prefill", "decode")]
                    if bad:
                        raise ServingError(
                            "roles must be 'both'/'prefill'/'decode', got %s"
                            % bad)
                    if not any(r in ("both", "prefill") for r in role_list):
                        raise ServingError(
                            "roles leave no prefill-capable replica")
                    if not any(r in ("both", "decode") for r in role_list):
                        raise ServingError(
                            "roles leave no decode-capable replica")
                    self._roles = tuple(role_list)
                # a pin is an extra refcount on the prefix index's chain, so
                # there is nothing to park without the prefix cache
                if sessions is None:
                    if dcfg.prefix_cache:
                        self._sessions = SessionStore()
                elif sessions is not False:
                    if not dcfg.prefix_cache:
                        raise ServingError(
                            "sessions require DecodeConfig(prefix_cache=True)")
                    self._sessions = sessions
                # admission-order seed pinning: a replay re-enqueues the
                # request (a new queue seq), so a seedless request gets a
                # POOL-pinned seed, the same across replays and between a
                # fault-free and a faulted run admitting in the same order
                self._decode_seed_lock = threading.Lock()
                self._decode_admissions = 0
                self._decode_queue = RequestQueue(
                    dcfg.queue_capacity,
                    depth_gauge=_obs.gauge("serving.decode.queue_depth"),
                    full_counter=_obs.counter("serving.decode.queue_full"),
                    shed_counter=_obs.counter("serving.decode.shed_admission"),
                    gauge_prefix="serving.decode.queue_depth")
                self._decode_queue.set_parallelism(
                    lambda: max(1, sum(1 for r in self._replicas
                                       if self._decode_claimable(r))))
                for rep in self._replicas:
                    if self._roles is not None:
                        rep.role = self._roles[rep.index]
                    rep.decode_breaker = CircuitBreaker(
                        threshold=self._breaker_threshold,
                        cooldown_s=self._breaker_cooldown_s,
                        state_gauge=_obs.gauge(
                            "serving.replica.decode_breaker_%d" % rep.index))
                    # its KV pools made and its steps warmed and captured on
                    # this thread, from the replica's stream; its worker runs
                    # on that stream
                    with _on(rep.stream):
                        rep.decoder = DecodeScheduler(
                            decode_model, config=dcfg, autostart=False,
                            queue=self._decode_queue,
                            gate=(lambda r=rep: self._decode_gate(r)),
                            name="decode-replica%d" % rep.index,
                            evict_on_death=True, breaker=rep.decode_breaker,
                            sessions=self._sessions, replica_index=rep.index,
                            role=rep.role,
                            on_handoff=(
                                (lambda packet, r=rep:
                                    self._dispatch_handoff(r, packet))
                                if rep.role == "prefill" else None),
                            claim=(lambda req, r=rep: self._may_claim(r, req)),
                            stream=rep.stream)
                    if dcfg.warmup:
                        rep.mark_warm(rep.stream)
                if self._roles is not None and dcfg.warmup:
                    # each replica's captures handed the cached free blocks
                    # back to the device, the earlier replicas' handoff
                    # blocks with them: make them again, last
                    for rep in self._replicas:
                        with _on(rep.stream):
                            rep.decoder.warm_handoff()
            # what the constructing thread queued (weights, KV pools, warm-up
            # runs, captures) is done before any replica's stream uses it
            _synchronize(placement)
        except BaseException:
            self._abandon()
            raise
        self._supervisor = None
        if supervise:
            sup = WorkerSupervisor(interval_s=supervisor_interval_s,
                                   max_restarts=worker_max_restarts,
                                   on_give_up=self._on_worker_give_up)
            for rep in self._replicas:
                sup.watch(
                    "replica%d" % rep.index,
                    should_run=lambda r=rep: (r.batcher.started
                                              and not r.batcher.stopping),
                    is_alive=lambda r=rep: r.batcher.alive,
                    restart=rep.batcher.restart,
                    fail_pending=self._fail_pending_if_all_dead)
                if rep.decoder is not None:
                    sup.watch(
                        "decode-replica%d" % rep.index,
                        should_run=lambda r=rep: (
                            r.decoder.started and not r.decoder.stopping),
                        is_alive=lambda r=rep: r.decoder.alive,
                        restart=lambda r=rep: self._revive_decoder(r),
                        fail_pending=lambda r=rep:
                            self._decode_fail_pending(r))
            self._supervisor = sup
        self._autoscaler_stop = threading.Event()
        self._autoscaler = None
        _pool_size_gauge.set(n)
        self._state = "ready"
        self._publish()
        if autostart:
            self.start()

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        """Start (or revive) every replica worker; an operator call grants
        a fresh restart budget to any replica that comes back alive.  A
        decode-only pool starts no predict worker."""
        for rep in self._replicas:
            if rep.model is not None and not rep.batcher.alive:
                rep.batcher.start()
                if rep.batcher.alive:
                    rep.failed = False
                    if self._supervisor is not None:
                        self._supervisor.reset("replica%d" % rep.index)
            if rep.decoder is not None and not rep.decoder.alive:
                rep.decoder.start()
                if rep.decoder.alive:
                    rep.decode_failed = False
                    if self._supervisor is not None:
                        self._supervisor.reset(
                            "decode-replica%d" % rep.index)
        if self._supervisor is not None:
            self._supervisor.start()
        self._publish()
        return self

    def stop(self, drain=True, timeout=None):
        """Stop the pool.  ``drain=True`` answers everything queued first
        (every replica's gate opens, parked ones included); new requests
        are rejected with ``ServingClosed`` from the moment the stop
        begins.  Serializes with a rolling swap on the swap lock.  A pool
        on a SHARED queue stops only its own consumers."""
        with self._swap_lock:
            if self._state == "stopped":
                return
            self._state = "stopped"
            self.stop_autoscaler()
            if self._owns_queue:
                self._queue.close()
            if self._decode_queue is not None:
                self._decode_queue.close()
            for rep in self._replicas:
                # the drain wants every warm replica, and a parked worker
                # must see `stopping` and exit
                rep.active = True
                rep.draining = False
                rep.force_serve = True
            if drain and self._owns_queue \
                    and (self._supervisor is not None
                         or any(r.batcher.alive
                                for r in self._replicas)):
                # drain pool-wide first, against the shared watermark: a
                # batcher's own stop fails the leftovers once ITS worker
                # is gone, which would shed requests its siblings were
                # about to answer
                self._tracker.wait_for(self._queue.last_seq(), timeout)
            # replicas with a worker that outlived its join (wedged): they
            # keep their streams, which that worker may still launch into
            wedged = set()
            for rep in self._replicas:
                stopped = rep.batcher.stop(drain=drain, timeout=timeout)
                if stopped and rep.model is not None:
                    # never close a version under a running batch; closing
                    # drops its graphs
                    rep.model.close()
                if not stopped:
                    wedged.add(rep.index)
            if self._decode_enabled:
                # the schedulers never close or drain the shared queue:
                # stop them (each drops its step graphs and KV pools once
                # its worker is gone), then fail whatever no worker
                # claimed
                for rep in self._replicas:
                    if not rep.decoder.stop(drain=drain, timeout=timeout):
                        wedged.add(rep.index)
                self._decode_queue.drain_remaining(
                    lambda r: ServingClosed("replica pool is stopped"))
                if self._sessions is not None:
                    # a stopped pool holds no sessions: every pin
                    # released, the dead workers' queues drained here
                    self._sessions.clear()
                    for rep in self._replicas:
                        rep.decoder.drain_pending_releases()
            if self._supervisor is not None:
                self._supervisor.stop()
            if self._metrics_server is not None:
                self._metrics_server.stop()
                self._metrics_server = None
            self._queue.unregister_consumers(self._consumer_key)
            # the graphs captured on the replicas' side streams are gone:
            # their streams go back to the lease
            for rep in self._replicas:
                if rep.index not in wedged:
                    rep.lease.release()
            self._publish()

    def _abandon(self):
        """After a constructor failed: stop what it built (no worker has
        started), so its graphs and KV pools go, and give the replicas'
        streams back."""
        for rep in self._replicas:
            if rep.decoder is not None:
                rep.decoder.stop(drain=False)
            if rep.model is not None:
                rep.model.close()
            rep.lease.release()
        self._queue.unregister_consumers(self._consumer_key)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- worker failure ------------------------------------------------------
    def _on_worker_give_up(self, worker_name):
        if worker_name.startswith("decode-replica"):
            rep = self._replicas[int(worker_name[len("decode-replica"):])]
            rep.decode_failed = True
            self._publish()
            return
        rep = self._replicas[int(worker_name[len("replica"):])]
        rep.failed = True
        # replace the lost capacity with a parked warm replica when one
        # exists (this substitutes; it does not grow the rotation)
        if rep.active:
            for cand in self._replicas:
                if not cand.active and not cand.failed \
                        and cand.batcher.alive:
                    cand.active = True
                    self._emit_scale(len(self._active()), "replace_failed")
                    break
        self._publish()

    def _fail_pending_if_all_dead(self):
        """Supervisor give-up tick: drain the SHARED queue only once no
        replica can ever serve it."""
        if any(r.batcher.alive and not r.failed for r in self._replicas):
            return
        if not self._owns_queue:
            # a sibling pool may still drain the shared queue
            return
        self._queue.drain_remaining(
            lambda r: ServingDegraded(
                "every pool replica is dead past its restart budget"),
            on_fail=lambda r: self._tracker.mark_done([r]))

    # -- durable decode (pool-routed generation) -----------------------------
    def _decode_ready(self, rep):
        """This replica's decoder can claim shared-queue work right now:
        the sibling side of the least-loaded comparison, so state only,
        never ``allow()`` (a sibling's peek must not spend a half-open
        breaker's probe)."""
        return (rep.active and not rep.draining and not rep.decode_failed
                and rep.decoder.alive
                and rep.decode_breaker.state != "open")

    def _decode_admissible(self, rep):
        """Could serve an admitted generation soon: not given up and not
        breaker-open (a dead worker inside its restart budget counts)."""
        return (rep.decoder is not None and not rep.decode_failed
                and rep.decode_breaker.state != "open")

    def _decode_claimable(self, rep):
        """:meth:`_decode_ready` and allowed to claim fresh queue work: a
        decode-role replica takes handoff packets only."""
        return rep.role != "decode" and self._decode_ready(rep)

    def _decode_gate(self, rep):
        """Claim gate of one replica's scheduler, consulted before every
        shared-queue pull.  A queue head stamped with an affinity hint
        goes to its preferred replica: the others defer while the hint is
        fresh (within ``affinity_timeout_s``) and the target could claim
        it; a stale or unservable hint is stripped
        (``serving.affinity.fallbacks``), so a head never waits on a
        dead, draining, breaker-open or full preference.  Otherwise
        least-loaded by free slots: claim only when no claim-ready
        sibling has MORE free slots (ties claim, so equal replicas race
        the queue and FIFO decides).  A decode-role replica never claims;
        the session store's TTL sweep runs from here."""
        if rep.force_serve and not rep.decode_failed:
            return True                 # pool stop-drain
        self._session_sweep()
        if (not rep.active or rep.draining or rep.decode_failed
                or not rep.decode_breaker.allow()):
            return False
        if rep.role == "decode":
            return False
        head = self._decode_queue.peek()
        aff = getattr(head, "affinity", None) if head is not None else None
        if aff is not None:
            if aff == rep.index:
                return True
            target = (self._replicas[aff]
                      if 0 <= aff < len(self._replicas) else None)
            fresh = (head.affinity_ts is not None
                     and (time.perf_counter() - head.affinity_ts
                          <= self._affinity_timeout_s))
            if (fresh and target is not None
                    and self._decode_claimable(target)):
                return False            # the warm replica claims it soon
            head.affinity = None
            head.affinity_ts = None
            _affinity_fallbacks.inc()
        mine = rep.decoder.free_slots()
        others = [r.decoder.free_slots() for r in self._replicas
                  if r is not rep and self._decode_claimable(r)]
        return not others or mine >= max(others)

    def _may_claim(self, rep, req):
        """Per-pop claim check, run by the shared queue UNDER ITS LOCK on
        the request ``rep`` is about to pop: closes the window in which
        two replicas approve their own momentary heads and pop each
        other's affinity-tagged request.  Refuses everything once the
        replica was parked or began draining after its gate passed (its
        pending pull must not claim work), strips a stale hint (the
        gate's bound) and refuses a fresh one aimed elsewhere."""
        if not rep.active or rep.draining:
            return False
        aff = getattr(req, "affinity", None)
        if aff is None or aff == rep.index:
            return True
        if (req.affinity_ts is not None
                and (time.perf_counter() - req.affinity_ts
                     <= self._affinity_timeout_s)):
            return False
        req.affinity = None
        req.affinity_ts = None
        _affinity_fallbacks.inc()
        return True

    def _session_sweep(self):
        """The store's TTL sweep, at most once a second, on whichever
        worker reaches its gate: expired sessions release their pins
        through the owners' release queues."""
        if self._sessions is None:
            return
        now = time.perf_counter()
        if now - self._session_sweep_ts < 1.0:
            return
        self._session_sweep_ts = now
        self._sessions.expire(now)

    def _dispatch_handoff(self, origin, packet):
        """Give one staged packet to the decode-capable replica with the
        most free slots, ready replicas first; called on the origin's
        worker thread by its scheduler's ``on_handoff``.  A quiesced or
        draining replica still takes it (its worker seats packets while
        it claims nothing), so a park never strands a conversation.  True
        once a replica took the packet."""
        cands = [r for r in self._replicas
                 if r.role != "prefill" and r.decoder is not None
                 and not r.decode_failed]
        cands.sort(key=lambda r: (self._decode_ready(r),
                                  r.decoder.free_slots()), reverse=True)
        for r in cands:
            if r.decoder.inject_handoff(packet):
                if self._telemetry.recording:
                    self._telemetry.emit({
                        "type": "decode_handoff", "ts": time.time(),
                        "source": "serving", "seq": packet.req.seq,
                        "leg": "dispatch", "origin": origin.index,
                        "dest": r.index, "pages": packet.n_pages,
                    })
                return True
        return False

    def _revive_decoder(self, rep):
        """The supervisor's restart for one replica's decode worker:
        harvest its in-flight sequences first (under the dead-worker
        proof: pages freed, journals intact), re-admit them so siblings
        take them at once, then re-arm the thread with empty slots."""
        for req in rep.decoder.evict_if_dead() or ():
            self._readmit_decode(req)
        return rep.decoder.restart()

    def _decode_fail_pending(self, rep):
        """Give-up tick for a decode worker dead past its budget: its
        in-flight sequences replay on siblings, and the shared queue
        fails typed only once no decoder could ever serve it."""
        for req in rep.decoder.evict_if_dead() or ():
            self._readmit_decode(req)
        if any(r.decoder.alive and not r.decode_failed
               for r in self._replicas):
            return
        self._decode_queue.drain_remaining(
            lambda r: ServingDegraded(
                "every pool decode replica is dead past its restart "
                "budget"))

    def _readmit_decode(self, req):
        """Re-admit one harvested generation: it resumes from its journal
        (``prompt + accepted`` re-prefilled, the remaining cap as its
        budget; sampling keyed on the absolute position continues the
        same tokens) through the shared queue, counting against
        ``DecodeConfig.replay_budget``."""
        if req.done():
            return
        j = req.journal
        if j.remaining() <= 0:
            req.complete(j.tokens())    # the journal is the answer
            return
        budget = self._decode_config.replay_budget
        if j.replays >= budget:
            req.fail(ServingDegraded(
                "replica died mid-decode and the replay budget (%d) is "
                "spent after %d/%d tokens"
                % (budget, len(j.accepted), j.max_new0)))
            return
        j.replays += 1
        _decode_replays.inc()
        req.prompt = j.resume_prompt()
        req.max_new_tokens = j.remaining()
        # the old hint likely names the replica that just died
        req.affinity = None
        req.affinity_ts = None
        if self._affinity_timeout_s > 0:
            self._stamp_affinity(req)
        if self._telemetry.recording:
            self._telemetry.emit({
                "type": "decode_replay", "ts": time.time(),
                "source": "serving", "seq": req.seq,
                "accepted": len(j.accepted), "remaining": j.remaining(),
                "replays": j.replays,
            })
        try:
            # re-admission (a fresh seq; the deadline stays absolute)
            self._decode_queue.put(req)
        except ServingError as exc:
            req.fail(exc)

    # -- introspection -------------------------------------------------------
    def _active(self):
        return [r for r in self._replicas if r.active]

    def _ready(self):
        return [r for r in self._replicas if r.ready()]

    def active_replicas(self):
        """Rotation size (autoscale's unit): replicas allowed to claim
        work (impaired ones still count: they are not descaled)."""
        return len(self._active())

    def ready_replicas(self):
        """Predict replicas able to claim work right now; a rolling swap
        of a pool of two or more never brings this to 0."""
        return len(self._ready())

    @property
    def replicas(self):
        return len(self._replicas)

    @property
    def state(self):
        """"ready" | "degraded" | "swapping" | "stopped"; ``degraded``
        while an in-rotation replica is failed or breaker-open."""
        if self._state == "ready":
            if any(r.failed or r.breaker.state == "open"
                   for r in self._active()):
                return "degraded"
        return self._state

    def ready(self):
        """Load-balancer truth: at least one replica serves (or will,
        within the supervisor's restart budget)."""
        if self._state not in ("ready", "swapping"):
            return False
        if any(r.admissible() for r in self._replicas):
            return True
        return self._decode_enabled and any(
            self._decode_admissible(r) for r in self._replicas)

    def replica_stats(self):
        return [r.stats() for r in self._replicas]

    def health(self):
        self._publish()
        versions = sorted({r.model.version for r in self._replicas
                           if r.model is not None})
        h = {
            "state": self.state,
            "ready": self.ready(),
            "replicas": len(self._replicas),
            "active_replicas": self.active_replicas(),
            "ready_replicas": self.ready_replicas(),
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            # two versions mid-swap, or after a swap that timed out
            "model_versions": versions,
            "model_version": versions[-1] if versions else None,
            "batch_buckets": list(self.batch_buckets),
            "max_batch_size": self.max_batch_size,
            "queue_depth": self._queue.depth(),
            "queue_capacity": self._queue.capacity,
            "class_depths": self._queue.class_depths(),
            "class_rows": self._queue.class_rows(),
            "service_rate_rows_per_s": self._queue.service_rate,
            "requests": self._queue.last_seq(),
            "batches": sum(r.batcher.batches for r in self._replicas),
            "per_replica": self.replica_stats(),
        }
        if self._decode_enabled:
            h["decode"] = {
                "queue_depth": self._decode_queue.depth(),
                "admitted": self._decode_queue.last_seq(),
                "ready_replicas": sum(1 for r in self._replicas
                                      if self._decode_ready(r)),
                "roles": [r.role for r in self._replicas],
            }
            if self._sessions is not None:
                h["decode"]["sessions"] = self._sessions.stats()
        if self._supervisor is not None:
            h["workers"] = self._supervisor.stats()
        return h

    def serve_metrics(self, host="127.0.0.1", port=0):
        """The live ``/metrics`` + ``/healthz`` endpoint for the POOL (the
        engine's contract): healthz serves :meth:`health` and answers 503
        while :meth:`ready` is False.  Stops with the pool."""
        srv = self._metrics_server
        if srv is not None and srv.running:
            return srv
        self._metrics_server = _obs.MetricsServer(
            host=host, port=port, health_fn=self.health).start()
        return self._metrics_server

    @property
    def feed_names(self):
        m = self._spec_model()
        return [] if m is None else list(m.feed_names)

    @property
    def fetch_names(self):
        m = self._spec_model()
        return [] if m is None else list(m.fetch_names)

    @property
    def model_version(self):
        versions = [r.model.version for r in self._replicas
                    if r.model is not None]
        return max(versions) if versions else None

    def _spec_model(self):
        for rep in self._replicas:
            m = rep._current_model()
            if m is not None:
                return m
        return None

    def _publish(self):
        _active_gauge.set(len(self._active()))
        _ready_gauge.set(len(self._ready()))
        for rep in self._replicas:
            rep.publish()

    # -- request admission ---------------------------------------------------
    def predict_async(self, feed, deadline_ms=None, priority=None,
                      tenant=None):
        """Admit one request into the SHARED queue; whichever ready
        replica claims it serves it.  The engine's error contract;
        ``ServingDegraded`` only when no replica could ever serve it."""
        if self._state == "stopped":
            raise ServingClosed("replica pool is stopped")
        if self._state == "loading":
            raise ServingClosed("replica pool is still loading")
        spec_model = self._spec_model()
        if spec_model is None:
            raise ServingError("replica pool has no loaded model")
        if not any(r.admissible() for r in self._replicas):
            raise ServingDegraded(
                "no replica can serve: all dead past restart budget or "
                "circuit-broken; pool degraded")
        arrays, rows = normalize_feed(spec_model, feed, self.max_batch_size)
        if priority is not None and priority not in PRIORITY_CLASSES:
            raise ServingError("unknown priority class %r (know %s)"
                               % (priority, PRIORITY_CLASSES))
        ms = deadline_ms if deadline_ms is not None \
            else self.default_deadline_ms
        deadline = None if ms is None else time.perf_counter() + ms / 1e3
        req = self._queue.put(
            Request(arrays, rows, deadline=deadline, priority=priority,
                    tenant=tenant, model=self.model_label))
        _requests.inc()
        return req

    def predict(self, feed, deadline_ms=None, priority=None, timeout=None,
                tenant=None):
        return self.predict_async(
            feed, deadline_ms=deadline_ms, priority=priority,
            tenant=tenant).result(timeout=timeout)

    def generate_async(self, prompt, max_new_tokens=None, deadline_ms=None,
                       priority=None, temperature=None, seed=None,
                       tenant=None, session=None):
        """Admit one generation into the SHARED decode queue; the
        least-loaded claim-ready replica serves it, and if that replica
        dies mid-decode a sibling continues it from its journal.  The
        scheduler's per-request knobs; a seedless request gets a
        pool-pinned admission-order seed.  ``session`` makes the request
        a turn of that conversation: routed to the replica holding its
        pinned pages, and parked there in turn."""
        if not self._decode_enabled:
            raise ServingError(
                "pool has no decode model (pass decode_model= at "
                "construction)")
        if self._state == "stopped":
            raise ServingClosed("replica pool is stopped")
        if self._state == "loading":
            raise ServingClosed("replica pool is still loading")
        if not any(self._decode_admissible(r) for r in self._replicas):
            raise ServingDegraded(
                "no replica can decode: all dead past restart budget or "
                "circuit-broken; pool degraded")
        dcfg = self._decode_config
        tokens = np.asarray(prompt)
        if tokens.ndim != 1 or tokens.shape[0] < 1:
            raise ServingError(
                "prompt must be a non-empty 1-D token array, got shape %s"
                % (tokens.shape,))
        tokens = tokens.astype(np.int32, copy=False)
        n_new = int(dcfg.max_new_tokens if max_new_tokens is None
                    else max_new_tokens)
        if n_new < 1:
            raise ServingError("max_new_tokens must be >= 1")
        buckets = self._replicas[0].decoder.prefill_buckets
        plen = int(tokens.shape[0])
        if plen > buckets[-1]:
            raise ServingError(
                "prompt length %d exceeds the largest prefill bucket %d"
                % (plen, buckets[-1]))
        if plen + n_new > dcfg.max_seq_len:
            raise ServingError(
                "prompt %d + max_new_tokens %d exceeds max_seq_len %d"
                % (plen, n_new, dcfg.max_seq_len))
        if temperature is not None and float(temperature) < 0:
            raise ServingError("temperature must be >= 0, got %r"
                               % (temperature,))
        if priority is not None and priority not in PRIORITY_CLASSES:
            raise ServingError("unknown priority class %r (know %s)"
                               % (priority, PRIORITY_CLASSES))
        if seed is None:
            with self._decode_seed_lock:
                seed = self._decode_admissions
                self._decode_admissions += 1
        ms = deadline_ms if deadline_ms is not None \
            else dcfg.default_deadline_ms
        deadline = None if ms is None else time.perf_counter() + ms / 1e3
        greq = GenerateRequest(tokens, n_new, deadline=deadline,
                               priority=priority, temperature=temperature,
                               seed=seed, session=session)
        # the labels before put: admission's rejection counters read them
        greq.tenant = tenant
        greq.model = self.model_label
        if self._affinity_timeout_s > 0:
            self._stamp_affinity(greq)
        req = self._decode_queue.put(greq)
        _decode_requests.inc()
        return req

    def _stamp_affinity(self, req):
        """Stamp the admission-time placement hint: the session's sticky
        replica first (where its pinned pages live), then the claimable
        replica holding the LONGEST warm prefix of this prompt (a
        read-only chain-hash peek a replica, the hashes computed once),
        else no hint.  A sticky replica that is draining, parked,
        breaker-open or dead counts a fallback: health overrides
        affinity.  Best-effort: the peek races the workers' cache
        updates, and a wrong hint costs only placement."""
        pref = None
        if self._sessions is not None and req.session is not None:
            rec = self._sessions.get(req.session)
            if rec is not None:
                target = (self._replicas[rec.replica]
                          if 0 <= rec.replica < len(self._replicas)
                          else None)
                if target is not None and self._decode_claimable(target):
                    pref = rec.replica
                    _affinity_sticky.inc()
                elif target is not None:
                    _affinity_fallbacks.inc()
        if pref is None and self._decode_config.prefix_cache:
            hashes = self._replicas[0].decoder._cache.prefix_hashes(
                req.prompt)
            if hashes:
                best_n = 0
                for r in self._replicas:
                    if not self._decode_claimable(r):
                        continue
                    n = r.decoder._cache.peek_hashes(hashes)
                    if n > best_n:
                        pref, best_n = r.index, n
                if pref is not None:
                    _affinity_prefix.inc()
        if pref is None:
            _affinity_none.inc()
            return
        req.affinity = pref
        req.affinity_ts = time.perf_counter()

    def end_session(self, session):
        """Finish a conversation: drop its store record and release its
        pinned pages (freed on the owning replica's worker at its next
        iteration).  True when the session existed."""
        if self._sessions is None:
            return False
        return self._sessions.end_session(session)

    @property
    def sessions(self):
        """The pool's :class:`~.sessions.SessionStore` (None when
        sessions are off)."""
        return self._sessions

    def generate(self, prompt, max_new_tokens=None, deadline_ms=None,
                 timeout=None, priority=None, temperature=None, seed=None,
                 tenant=None, session=None):
        """Synchronous generate: the generated int32 token ids."""
        return self.generate_async(
            prompt, max_new_tokens=max_new_tokens, deadline_ms=deadline_ms,
            priority=priority, temperature=temperature, seed=seed,
            tenant=tenant, session=session).result(timeout=timeout)

    def drain_decode(self, timeout=None):
        """Block until no generation is queued, parked or decoding
        anywhere in the pool.  False on timeout."""
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        while True:
            if self._decode_queue is None or (
                    self._decode_queue.depth() == 0
                    and all(r.decoder.idle() for r in self._replicas)):
                return True
            if deadline is not None and time.perf_counter() >= deadline:
                return False
            time.sleep(0.005)

    def drain(self, timeout=None):
        """Block until everything admitted so far reached a terminal
        outcome (the pool-wide watermark).  False on timeout."""
        return self._tracker.wait_for(self._queue.last_seq(), timeout)

    # -- rolling hot swap ----------------------------------------------------
    def swap_model(self, model_dir, backend="auto", drain_timeout_s=60.0):
        """ROLLING hot swap: for each replica in turn, load and warm the
        new version on its device while every other replica serves,
        close its gate, wait until it provably has no dispatch in flight,
        flip, reopen, and close the old version (its graphs and their
        pool are freed).  Exactly one replica is ever out; in a partial
        rotation a parked warm sibling covers the sole ready replica's
        drain.  A request finishes on the version of the replica that
        claimed it.  A drain that times out raises, leaving the pool on
        two versions (``health()["model_versions"]``); a second swap
        completes the rollout.  Returns the new version number."""
        if self._state == "stopped":
            raise ServingClosed("replica pool is stopped")
        if self._spec_model() is None:
            raise ServingError(
                "this pool has no predict model to swap (constructed "
                "with model_dir=None)")
        with self._swap_lock:
            if self._state == "stopped":   # stop() won the lock first
                raise ServingClosed("replica pool is stopped")
            prev_state, self._state = self._state, "swapping"
            new_version = None
            try:
                for rep in self._replicas:
                    load_stream = rep.next_load_stream()
                    with _on(load_stream):
                        new = rep.store.load(model_dir, backend=backend)
                    ref = self._spec_model()
                    # requests in flight were normalized against the
                    # serving specs: the new version must take the same
                    if (new.feed_names != ref.feed_names
                            or new.feed_specs != ref.feed_specs):
                        new.close()
                        raise ServingError(
                            "swap rejected: new model feeds %s %s != "
                            "serving feeds %s %s"
                            % (new.feed_names, new.feed_specs,
                               ref.feed_names, ref.feed_specs))
                    if self._warmup:
                        with _on(load_stream):
                            new.warmup(self.batch_buckets)
                        rep.mark_warm(load_stream)
                    # warmed on this thread, served by the worker
                    _synchronize([rep.device])
                    cover = None
                    if rep.ready() and not any(
                            o.ready() for o in self._replicas
                            if o is not rep):
                        for cand in self._replicas:
                            if (cand is not rep and not cand.active
                                    and cand.admissible()
                                    and cand.batcher.alive):
                                cand.active = True
                                cover = cand
                                break
                    # close the gate FIRST, then stamp: a park seen after
                    # `since` was at a closed gate
                    rep.draining = True
                    since = time.perf_counter()
                    self._publish()
                    try:
                        if not rep.wait_quiescent(since, drain_timeout_s):
                            new.close()
                            raise ServingError(
                                "rolling swap: replica %d drain timed out "
                                "after %.1fs (%d rows in flight)"
                                % (rep.index, drain_timeout_s,
                                   rep.inflight_rows))
                        with rep.model_lock:
                            old, rep.model = rep.model, new
                    finally:
                        rep.draining = False
                        if cover is not None:
                            cover.active = False
                        self._publish()
                    # parked at a closed gate when flipped: the old
                    # version is idle
                    old.close()
                    new_version = new.version
                    _replica_swapped.inc()
                    if self._telemetry.recording:
                        self._telemetry.emit({
                            "type": "replica_swap", "ts": time.time(),
                            "source": "serving", "replica": rep.index,
                            "from_version": old.version,
                            "to_version": new.version,
                            "ready_replicas": self.ready_replicas(),
                        })
                    del old
            finally:
                self._state = prev_state
        _swaps.inc()
        if self._telemetry.recording:
            self._telemetry.emit({
                "type": "model_swap", "ts": time.time(), "source": "serving",
                "rolling": True, "replicas": len(self._replicas),
                "to_version": new_version, "model_dir": model_dir,
            })
        return new_version

    # -- autoscale -----------------------------------------------------------
    def set_active_replicas(self, n, reason="manual"):
        """Resize the rotation to ``n`` (clamped to ``[min_replicas,
        max_replicas]``): activate parked replicas in index order, or
        quiesce active ones (stop claiming, finish in-flight work, park
        warm).  Scale-up counts only healthy actives toward the target;
        scale-down parks impaired actives first (failed, breaker-open,
        draining), then the highest-index healthy.  Returns the applied
        rotation size."""
        with self._scale_lock:
            n = max(self.min_replicas, min(int(n), self.max_replicas))
            before = len(self._active())
            healthy = sum(1 for r in self._active() if not r.failed)
            if n > healthy:
                want = n - healthy
                grew = False
                for rep in self._replicas:
                    if want == 0:
                        break
                    if not rep.active and not rep.failed:
                        rep.active = True
                        grew = True
                        want -= 1
                if grew:
                    _scale_ups.inc()
            active = self._active()
            if n < len(active):
                excess = len(active) - n
                impaired = [r for r in active
                            if r.failed or r.breaker.state == "open"
                            or r.draining]
                victims = impaired + [r for r in reversed(active)
                                      if r not in impaired]
                for rep in victims[:excess]:
                    rep.active = False
                _scale_downs.inc()
            now_active = len(self._active())
            self._publish()
            if now_active != before:
                self._emit_scale(now_active, reason, before=before)
            return now_active

    def _emit_scale(self, to_n, reason, before=None):
        if self._telemetry.recording:
            self._telemetry.emit({
                "type": "replica_scale", "ts": time.time(),
                "source": "serving", "from": before, "to": to_n,
                "reason": reason, "ready_replicas": self.ready_replicas(),
            })

    def autoscale_tick(self, desired=None, now=None):
        """Apply one autoscale decision.  ``desired`` defaults to the
        live ``serving.autoscale.desired_replicas`` gauge (published by
        ``SLOMonitor.evaluate``).  Scale-UP applies at once; scale-DOWN
        only once desired stayed below the active count for
        ``scale_down_after_s``, and then to the HIGHEST desired seen in
        that window.  Returns the rotation size after the tick."""
        if desired is None:
            v = _obs.gauge("serving.autoscale.desired_replicas").value
            if v is None:
                return self.active_replicas()
            desired = v
        desired = max(self.min_replicas,
                      min(int(desired), self.max_replicas))
        now = time.perf_counter() if now is None else now
        active = self.active_replicas()
        if desired > active:
            self._below_since = None
            return self.set_active_replicas(desired, reason="autoscale_up")
        if desired < active:
            if self._below_since is None:
                self._below_since = now
                self._below_peak = desired
            else:
                self._below_peak = max(self._below_peak, desired)
            if now - self._below_since >= self.scale_down_after_s:
                target = self._below_peak
                self._below_since = None
                return self.set_active_replicas(
                    target, reason="autoscale_down")
            return active
        self._below_since = None
        return active

    def start_autoscaler(self, monitor=None, interval_s=None,
                         metrics_url=None, metric=None, prefix="paddle_tpu_",
                         scrape_timeout_s=2.0):
        """Run the autoscale loop on a daemon thread: each tick evaluates
        ``monitor`` (an ``SLOMonitor``, typically built with
        ``engine=pool``), scrapes ``metrics_url`` (any Prometheus-text
        ``/metrics``, parsed leniently, its
        ``<prefix>serving_autoscale_desired_replicas`` sample or
        ``metric``), or with neither reads the published gauge.  A
        failing scrape or monitor skips the tick and counts on
        ``serving.autoscale.tick_errors``; an absent sample counts on
        ``serving.autoscale.scrape_misses``."""
        if monitor is not None and metrics_url is not None:
            raise ValueError("pass monitor= or metrics_url=, not both")
        if self._autoscaler is not None and self._autoscaler.is_alive():
            return self
        period = float(interval_s) if interval_s is not None else (
            monitor.window_s if monitor is not None else 1.0)
        scrape_name = None
        if metrics_url is not None:
            from ..observability.export import parse_prometheus, \
                prometheus_name

            scrape_name = metric or prometheus_name(
                "serving.autoscale.desired_replicas", prefix)

            def scrape_desired():
                import urllib.request

                with urllib.request.urlopen(
                        metrics_url, timeout=scrape_timeout_s) as resp:
                    body = resp.read().decode("utf-8", "replace")
                v = parse_prometheus(body, strict=False).get(scrape_name)
                return None if v is None else int(round(v))

        self._autoscaler_stop.clear()

        def loop():
            while not self._autoscaler_stop.wait(period):
                try:
                    desired = None
                    if monitor is not None:
                        desired = monitor.evaluate()["desired_replicas"]
                    elif scrape_name is not None:
                        desired = scrape_desired()
                        if desired is None:
                            _obs.inc("serving.autoscale.scrape_misses")
                            continue
                    self.autoscale_tick(desired)
                except Exception:  # noqa: BLE001 — counted, loop survives
                    _obs.inc("serving.autoscale.tick_errors")

        self._autoscaler = threading.Thread(
            target=loop, name="paddle-tpu-torch-replica-autoscaler",
            daemon=True)
        self._autoscaler.start()
        return self

    def stop_autoscaler(self, timeout=2.0):
        self._autoscaler_stop.set()
        t = self._autoscaler
        if t is not None and t.is_alive():
            t.join(timeout)
        self._autoscaler = None
