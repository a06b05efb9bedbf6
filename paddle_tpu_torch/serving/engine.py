"""InferenceEngine: the serving entry point of the port.

Counterpart of ``paddle_tpu/serving/engine.py``.  One engine serves two
paths, alone or together:

* predict — a saved inference model (``model_dir``, written by
  ``io.save_inference_model``, with or without ``aot=True``) served
  through ``predict()``/``predict_async()``: a bounded queue, a dynamic
  batcher and a fixed ladder of batch-size buckets warmed at load, so
  many concurrent clients ride one device dispatch.  The model runs as
  its Program (the port's ``Executor``) or as its ``torch.export`` graph
  (the AOT backend); see :mod:`.model_store`.
* generate — autoregressive decode (``decode_model=``, see
  ``models.transformer.build_decode_model``) through
  ``generate()``/``generate_async()``: continuous batching over a paged
  KV cache (decode_scheduler.py, kv_cache.py).

Bucket discipline: every batch is padded (edge-replicating the last row)
to the smallest covering bucket, and per-request slices come back out
identical to serving each request alone wherever the model computes its
rows independently of their batch neighbours.  The default ladder starts
at 2, as in the JAX package (whose CPU backend lowers a single-row
matmul to a gemv whose sums differ from its gemm rows).  On the card,
cuBLAS picks its GEMM algorithm per shape, so whether a row's bits are
the same at every bucket is a measured fact of the card, not a contract
of the engine (``chip_smoke.py`` measures it at Transformer-base's
width; PERF.md records the reading).

Integration contracts, as in the JAX package: model (re)load rides
``io``'s resilience-routed, fault-injectable artifact reads; hot swap
(:meth:`swap_model`) loads+warms the new version while the old serves,
drains everything admitted before the swap, then flips; health/readiness
is a state machine (``loading -> ready <-> swapping -> stopped``, with
``degraded`` reported while the dispatch circuit breaker is open or a
worker is dead past its restart budget); and the runtime reports as
``serving.*`` telemetry — queue-depth gauge, batch-size bucket counters,
queue-wait/execute timers, and per-request spans.  Predict dispatch
faults are retried (transient), bisected (poison) and breaker-counted
(persistent); a dead worker thread is restarted by the supervisor, or
its pending requests fail fast.  ``serve_metrics`` opens the live
``/metrics`` + ``/healthz`` endpoint (off until called; it stops with
the engine).

The engine runs on the card unless asked otherwise: ``device=None`` and
``place=None`` resolve to ``cuda`` and raise when there is no GPU.  The
decode model must live on the engine's device.
"""
from __future__ import annotations

import copy
import threading
import time

import numpy as np

from .. import observability as _obs
from .. import resilience as _resilience
from ..core import resolve_device
from ..executor import SERVING_BLOCK_ROWS
from .batcher import DynamicBatcher
from .decode_scheduler import DecodeConfig, DecodeScheduler
from .errors import ServingClosed, ServingDegraded, ServingError
from .model_store import ModelStore
from .request_queue import PRIORITY_CLASSES, Request, RequestQueue
from .resilient import CircuitBreaker, ResilientDispatcher, WorkerSupervisor

__all__ = ["BatchExecutor", "InferenceEngine", "normalize_feed"]

_requests = _obs.counter("serving.requests")
_batches = _obs.counter("serving.batches")
_batched_rows = _obs.counter("serving.batched_rows")
_padded_rows = _obs.counter("serving.padded_rows")
_swaps = _obs.counter("serving.swaps")
_execute_hist = _obs.histogram("serving.execute")


def normalize_feed(model, feed, max_batch_size):
    """Validate + canonicalize one request's feed against ``model``'s
    specs; returns ``({name: np.ndarray}, rows)``."""
    missing = [n for n in model.feed_names if n not in feed]
    unknown = [n for n in feed if n not in model.feed_names]
    if missing or unknown:
        raise ServingError(
            "feed names mismatch: missing %s, unknown %s (model feeds "
            "%s)" % (missing, unknown, model.feed_names))
    out = {}
    rows = None
    for name in model.feed_names:
        shape, dtype = model.feed_specs[name]
        arr = np.asarray(feed[name])
        if arr.dtype != dtype:
            arr = arr.astype(dtype, copy=False)
        rest = len(shape) - 1
        if arr.ndim == rest:         # single sample: add the batch dim
            arr = arr[None]
        elif arr.ndim != rest + 1:
            raise ServingError(
                "feed %r has %d dims; expected %d (%s with a leading "
                "batch dim) or %d (one sample)"
                % (name, arr.ndim, rest + 1, shape, rest))
        for want, got in zip(shape[1:], arr.shape[1:]):
            if want is not None and int(want) != int(got):
                raise ServingError(
                    "feed %r has shape %s but the model expects %s "
                    "(None = batch)" % (name, arr.shape, shape))
        n = arr.shape[0]
        if rows is None:
            rows = n
        elif n != rows:
            raise ServingError(
                "inconsistent request rows: feed %r has %d, others %d"
                % (name, n, rows))
        out[name] = arr
    if rows is None or rows < 1:
        raise ServingError("empty request (zero rows)")
    if rows > max_batch_size:
        raise ServingError(
            "request carries %d rows > max_batch_size %d; split it "
            "client-side" % (rows, max_batch_size))
    return out, rows


class BatchExecutor:
    """The padded-bucket batch dispatch: concat → bucket-pad → chunk →
    slice → complete, with its telemetry.

    ``get_model`` returns the CURRENT model for this dispatch (the
    engine reads it under its model lock) — resolved once per call, so a
    hot swap mid-queue never mixes versions inside one batch.
    ``queue_depth`` feeds the serve_batch record; ``tags`` ride every
    execute span and record.  The callable either completes every
    request in the list or raises having completed none — the
    all-at-the-end contract retry/bisection (``ResilientDispatcher``)
    depends on.
    """

    def __init__(self, get_model, batch_buckets, queue_depth=None,
                 tags=None):
        buckets = sorted(set(int(b) for b in batch_buckets))
        self._get_model = get_model
        self.batch_buckets = tuple(buckets)
        self._queue_depth = queue_depth or (lambda: 0)
        self._tags = dict(tags or {})
        self._telemetry = _obs.get_telemetry()
        # bucket-histogram counter cells resolved once: the dispatch path
        # must not pay a locked registry lookup + string format per batch
        self._bucket_counters = {
            b: _obs.counter("serving.batch_bucket_%d" % b)
            for b in self.batch_buckets}

    def _bucket_for(self, rows):
        for b in self.batch_buckets:
            if b >= rows:
                return b
        return self.batch_buckets[-1]

    def _dispatch_chunk(self, model, feed_full, lo, hi, chunk_requests):
        """Run rows [lo, hi) of the concatenated batch as one padded
        bucket dispatch; returns ``(outs, batched_flags)``.
        ``chunk_requests`` are the requests with rows in [lo, hi) — the
        traces this dispatch is attributed to."""
        n = hi - lo
        n_requests = len(chunk_requests)
        bucket = self._bucket_for(n)
        pad = bucket - n
        feed = {}
        for name, arr in feed_full.items():
            chunk = arr[lo:hi]
            if pad:
                # edge-replicate the last row: always a valid sample, and
                # padding never changes other rows' results (rows are
                # computed independently)
                chunk = np.concatenate(
                    [chunk, np.broadcast_to(chunk[-1:],
                                            (pad,) + chunk.shape[1:])],
                    axis=0)
            feed[name] = chunk
        tel = self._telemetry
        wall0, t0 = time.time(), time.perf_counter()
        with tel.timed("serving.execute", bucket=bucket, rows=n,
                       requests=n_requests, version=model.version,
                       **self._tags):
            outs = model.predict_batch(feed)
        exec_s = time.perf_counter() - t0
        _execute_hist.observe(exec_s)
        if tel.span_active():
            # attribute THIS dispatch to every trace riding in it: the
            # "execute" leaf of each request's tree (a retried dispatch
            # emits one leaf per attempt that reached the model)
            for r in chunk_requests:
                if r.trace is not None:
                    tel.record_span(
                        "serving.execute", wall0, exec_s,
                        tags=r.trace.child().tags(bucket=bucket, rows=n,
                                                  version=model.version,
                                                  **self._tags))
        _batches.inc()
        _batched_rows.inc(n)
        _padded_rows.inc(pad)
        self._bucket_counters[bucket].inc()
        # which outputs carry the batch dim: warmup's observed ground
        # truth when available (a non-batched fetch whose leading dim
        # coincidentally equals one bucket must NOT be sliced), else the
        # shape heuristic
        known = model.batched_fetch
        outs = [np.asarray(o) for o in outs]
        flags = [(a.ndim >= 1 and a.shape[0] == bucket
                  if known is None or j >= len(known) else known[j])
                 for j, a in enumerate(outs)]
        if tel.recording:
            rec = {
                "type": "serve_batch", "ts": time.time(),
                "source": "serving", "bucket": bucket, "rows": n,
                "requests": n_requests, "padded": pad,
                "model_version": model.version,
                "queue_depth": self._queue_depth(),
            }
            rec.update(self._tags)
            tel.emit(rec)
        return outs, flags

    def __call__(self, requests):
        # the serving-dispatch fault choke point: the chaos harness
        # (testing.faults.flaky_execute / slow_execute / poison_request /
        # kill_worker) hooks here, per dispatch ATTEMPT, with the exact
        # request list — so retries and bisected sub-batches each consult
        # it, exactly like a real per-dispatch runtime fault would hit
        serve_fault = _resilience._serve_fault
        if serve_fault is not None:
            serve_fault(requests)
        model = self._get_model()
        rows = sum(r.rows for r in requests)
        feed_full = {}
        for name in model.feed_names:
            parts = [r.feed[name] for r in requests]
            feed_full[name] = (parts[0] if len(parts) == 1
                               else np.concatenate(parts, axis=0))
        cap = self.batch_buckets[-1]
        if rows <= cap:
            outs, flags = self._dispatch_chunk(model, feed_full, 0, rows,
                                               requests)
        else:
            # an oversized coalesced batch (max_batch_size above the
            # largest bucket) is CHUNKED across several bucket dispatches
            # in row order — bucket padding never goes negative,
            # per-request slices are reassembled below exactly as in the
            # single-dispatch case
            bounds = [(lo, min(lo + cap, rows))
                      for lo in range(0, rows, cap)]
            spans_by_req = self._request_spans(requests)
            per_chunk = []
            flags = None
            for lo, hi in bounds:
                chunk_reqs = [r for r, (r_lo, r_hi)
                              in zip(requests, spans_by_req)
                              if r_lo < hi and r_hi > lo]
                outs_c, flags_c = self._dispatch_chunk(model, feed_full,
                                                       lo, hi, chunk_reqs)
                per_chunk.append((outs_c, flags_c, hi - lo))
                flags = flags_c if flags is None else flags
            outs = []
            for j in range(len(per_chunk[0][0])):
                if flags[j]:
                    outs.append(np.concatenate(
                        [c_outs[j][:n] for c_outs, _, n in per_chunk],
                        axis=0))
                else:
                    # batch-dim-less fetch (scalar metric): each chunk
                    # computes its own; share the first chunk's verbatim
                    outs.append(per_chunk[0][0][j])
        offset = 0
        for r in requests:
            result = []
            for j, a in enumerate(outs):
                if flags[j]:
                    # copy: a view would pin the whole batch (and every
                    # other request's rows) in memory via its base
                    result.append(np.ascontiguousarray(
                        a[offset:offset + r.rows]))
                else:
                    result.append(a)
            offset += r.rows
            # complete() emits the request's ROOT trace span and the
            # per-class latency/goodput accounting (request_queue)
            r.complete(result)

    @staticmethod
    def _request_spans(requests):
        spans, lo = [], 0
        for r in requests:
            spans.append((lo, lo + r.rows))
            lo += r.rows
        return spans


class InferenceEngine:
    """Serve a saved inference model with dynamic request batching, a
    decode model with continuous batching, or both.

    Parameters
    ----------
    model_dir: directory written by ``io.save_inference_model`` (with or
        without ``aot=True``) for :meth:`predict`; None for a
        generate-only engine.
    batch_buckets: ladder of warmed batch sizes; every dispatch is
        padded to the smallest covering bucket.  Default ``(2, 4, 8, 16)``.
    max_batch_size: coalescing cap (rows per dispatch); defaults to the
        largest bucket.  It MAY exceed the largest bucket: a coalesced
        batch bigger than every bucket is chunked across multiple
        bucket dispatches (per-request slice order preserved).
    decode_model: a :class:`~.decode_scheduler.DecodeModel` enables
        :meth:`generate`/:meth:`generate_async` alongside ``predict``.
    decode_config: :class:`~.decode_scheduler.DecodeConfig` for the
        decode runtime (slots, KV paging geometry, prefill buckets,
        chunked prefill via ``prefill_chunk_tokens``).
    batch_timeout_ms: extra time the batcher may wait, measured from the
        head request's ARRIVAL, to fill a batch.  The default 0 is eager
        (dispatch whatever is queued); raise it only to trade latency for
        fuller batches on sparse-bursty traffic.
    queue_capacity: bounded admission queue; a full queue raises
        ``ServingQueueFull`` (backpressure, not blocking).
    class_capacity: per-priority-class queue caps, e.g.
        ``{"best_effort": 16}``.
    default_deadline_ms: deadline applied to requests that don't carry
        their own; None = no deadline.
    execute_retries: transient dispatch failures are retried this many
        times (exponential backoff) before the batch is bisected; 0
        disables retry (bisection still isolates poison requests).
    breaker_threshold: consecutive fatal batches that trip the dispatch
        circuit breaker (engine degrades, admission fast-fails with
        ``ServingDegraded``); None disables the breaker.
    breaker_cooldown_s: open -> half-open cooldown; a successful probe
        re-closes the breaker.
    supervise: run the worker supervisor (restart a dead batcher/decode
        thread, or fail pending requests fast once the restart budget
        ``worker_max_restarts`` is spent).
    backend: "auto" | "aot" | "program" (ModelStore).
    feed_shapes: ``{name: full_shape}`` overrides for feeds with dynamic
        non-batch dims (same convention as ``aot_feed_shapes``).
    warmup: run the bucket ladder (and the decode widths) at
        construction, and the ladder again at swap.
    autostart: start the worker threads immediately; tests pass False to
        exercise queue semantics deterministically, then call
        :meth:`start`.
    place, device: where the engine serves (a Place, or a device string
        or ``torch.device``; pass one of them, or neither for the card,
        which raises without a GPU); the decode model must live there.
    """

    def __init__(self, model_dir=None, batch_buckets=(2, 4, 8, 16),
                 max_batch_size=None, batch_timeout_ms=0.0,
                 queue_capacity=128, class_capacity=None,
                 default_deadline_ms=None, place=None,
                 backend="auto", feed_shapes=None, warmup=True,
                 autostart=True, decode_model=None, decode_config=None,
                 execute_retries=2, breaker_threshold=5,
                 breaker_cooldown_s=1.0, supervise=True,
                 worker_max_restarts=3, supervisor_interval_s=0.1,
                 device=None):
        buckets = sorted(set(int(b) for b in batch_buckets))
        if not buckets or buckets[0] < 1:
            raise ValueError("batch_buckets must be positive ints, got %r"
                             % (batch_buckets,))
        if model_dir is None and decode_model is None:
            raise ValueError(
                "InferenceEngine needs a model_dir (predict), a "
                "decode_model (generate), or both")
        if place is not None and device is not None:
            raise ValueError("pass place or device, not both")
        self.device = resolve_device(place if place is not None else device)
        if decode_model is not None and decode_model.device != self.device:
            raise ValueError(
                "decode_model lives on %s but the engine serves on %s; "
                "build it with build_decode_model(..., device=%r)"
                % (decode_model.device, self.device, str(self.device)))
        self.batch_buckets = tuple(buckets)
        self.max_batch_size = int(max_batch_size or buckets[-1])
        self.batch_timeout_ms = float(batch_timeout_ms)
        self.default_deadline_ms = default_deadline_ms
        self._warmup = bool(warmup)
        self._state = "loading"
        self._store = ModelStore(place=self.device, feed_shapes=feed_shapes,
                                 block_rows=SERVING_BLOCK_ROWS)
        self._model_lock = threading.Lock()   # guards the active-model flip
        self._swap_lock = threading.Lock()    # serializes swap_model calls
        self._model = (None if model_dir is None
                       else self._store.load(model_dir, backend=backend))
        if self._warmup and self._model is not None:
            self._model.warmup(self.batch_buckets)
        self._queue = RequestQueue(queue_capacity,
                                   class_capacity=class_capacity)
        self._batch_core = BatchExecutor(
            self._current_model, self.batch_buckets,
            queue_depth=self._queue.depth)
        self._breaker = CircuitBreaker(threshold=breaker_threshold,
                                       cooldown_s=breaker_cooldown_s)
        self._dispatcher = ResilientDispatcher(
            self._execute_batch, max_retries=execute_retries,
            breaker=self._breaker)
        self._batcher = DynamicBatcher(
            self._queue, self._dispatcher, self.max_batch_size,
            self.batch_timeout_ms / 1e3)
        # workers dead past their restart budget, by supervisor target
        # name ("batcher"/"decoder"): predict admission gates on the
        # batcher, generate admission on the decoder — a dead decode
        # worker must not fast-fail the healthy predict path
        self._failed_workers = set()
        self._decoder = None
        if decode_model is not None:
            # shallow-copy: the engine's warmup override must not mutate
            # a caller-owned config reused for other engines
            cfg = (copy.copy(decode_config) if decode_config is not None
                   else DecodeConfig(default_deadline_ms=default_deadline_ms))
            if not self._warmup:
                cfg.warmup = False
            self._decoder = DecodeScheduler(decode_model, cfg,
                                            autostart=False)
        self._supervisor = None
        if supervise:
            sup = WorkerSupervisor(interval_s=supervisor_interval_s,
                                   max_restarts=worker_max_restarts,
                                   on_give_up=self._on_worker_give_up)
            sup.watch(
                "batcher",
                should_run=lambda: (self._batcher.started
                                    and not self._batcher.stopping),
                is_alive=lambda: self._batcher.alive,
                restart=self._batcher.restart,
                fail_pending=lambda: self._queue.drain_remaining(
                    lambda r: ServingDegraded(
                        "serving worker died and its restart budget is "
                        "exhausted"),
                    # advance the watermark past drained seqs, or a
                    # revived engine's swap drain stalls on them forever
                    on_fail=lambda r: self._batcher._mark_done([r])))
            if self._decoder is not None:
                dec = self._decoder
                sup.watch(
                    "decoder",
                    should_run=lambda: (dec.started and not dec.stopping),
                    is_alive=lambda: dec.alive,
                    restart=dec.restart,
                    fail_pending=lambda: dec.fail_pending(
                        ServingDegraded(
                            "decode worker died and its restart budget "
                            "is exhausted")))
            self._supervisor = sup
        self._telemetry = _obs.get_telemetry()
        self._metrics_server = None   # started only by serve_metrics()
        self._state = "ready"
        if autostart:
            self.start()

    # -- lifecycle -----------------------------------------------------------
    def _on_worker_give_up(self, worker_name):
        """Supervisor callback: a worker died past its restart budget —
        degrade so admissions to THAT worker's path fast-fail instead
        of queueing into a black hole."""
        self._failed_workers.add(worker_name)

    def start(self):
        """Start (or explicitly revive) the serving workers.  An
        operator calling start() on an engine whose worker died — even
        past the supervisor's restart budget — grants a fresh budget:
        the give-up state is cleared for every worker that comes back
        alive, so its admissions stop fast-failing ``ServingDegraded``."""
        if not self._batcher.alive:
            self._batcher.start()
            if self._batcher.alive:
                self._failed_workers.discard("batcher")
                if self._supervisor is not None:
                    self._supervisor.reset("batcher")
        if self._decoder is not None and not self._decoder.alive:
            self._decoder.start()
            if self._decoder.alive:
                self._failed_workers.discard("decoder")
                if self._supervisor is not None:
                    self._supervisor.reset("decoder")
        if self._supervisor is not None:
            self._supervisor.start()
        return self

    def stop(self, drain=True, timeout=None):
        """Stop serving.  ``drain=True`` answers everything already queued
        first; either way, new requests are rejected with
        ``ServingClosed`` from the moment the stop begins, and no queued
        request is left hanging — requests a dead/wedged worker will
        never pop are failed via ``drain_remaining``.  An in-flight
        :meth:`swap_model` finishes first (both serialize on the swap
        lock)."""
        with self._swap_lock:
            if self._state == "stopped":
                return
            self._state = "stopped"
            if self._supervisor is not None:
                self._supervisor.stop()
            self._queue.close()
            # batcher.stop fails any leftovers a gone worker can't serve
            worker_done = self._batcher.stop(drain=drain, timeout=timeout)
            if self._decoder is not None:
                self._decoder.stop(drain=drain, timeout=timeout)
            # if the join timed out the worker may still be mid-dispatch:
            # leave the model open (a leak at a forced-shutdown edge)
            # rather than closing it under a running batch
            if worker_done and self._model is not None:
                self._model.close()
            if self._metrics_server is not None:
                self._metrics_server.stop()
                self._metrics_server = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- health / introspection ----------------------------------------------
    def _predict_path_healthy(self):
        return (self._model is not None
                and "batcher" not in self._failed_workers
                and self._breaker.state != "open")

    def _decode_path_healthy(self):
        return (self._decoder is not None
                and "decoder" not in self._failed_workers)

    @property
    def state(self):
        """"loading" | "ready" | "degraded" | "swapping" | "stopped".
        ``degraded`` is DERIVED: the lifecycle state is ``ready`` but at
        least one serving path is impaired — the predict dispatch
        circuit breaker is open, or a worker died past its restart
        budget.  Admission to the impaired path fast-fails with
        ``ServingDegraded``; the other path keeps serving."""
        if self._state == "ready":
            if self._failed_workers:
                return "degraded"
            if self._breaker.state == "open":
                return "degraded"
        return self._state

    def ready(self):
        """Readiness-probe truth: the engine admits and serves requests
        on AT LEAST ONE path ("swapping" still serves — on the outgoing
        version until the drain completes)."""
        if self._state not in ("ready", "swapping"):
            return False
        return self._predict_path_healthy() or self._decode_path_healthy()

    def health(self):
        h = {
            "state": self.state,
            "ready": self.ready(),
            "device": str(self.device),
            "model_version": None if self._model is None
            else self._model.version,
            "model_dir": None if self._model is None
            else self._model.dirname,
            "backend": None if self._model is None else self._model.kind,
            "batch_buckets": list(self.batch_buckets),
            "max_batch_size": self.max_batch_size,
            "queue_depth": self._queue.depth(),
            "queue_capacity": self._queue.capacity,
            "class_depths": self._queue.class_depths(),
            "class_rows": self._queue.class_rows(),
            "service_rate_rows_per_s": self._queue.service_rate,
            # worker liveness: False means admitted requests would hang
            # without the supervisor
            "worker_alive": self._batcher.alive,
            "breaker": self._breaker.state,
            # per-ENGINE totals (the serving.* registry counters are
            # process-wide): admitted = the queue's seq watermark,
            # batches = the worker's own dispatch count
            "requests": self._queue.last_seq(),
            "batches": self._batcher.batches,
        }
        if self._supervisor is not None:
            h["workers"] = self._supervisor.stats()
        if self._decoder is not None:
            h["decode"] = self._decoder.stats()
        return h

    def serve_metrics(self, host="127.0.0.1", port=0):
        """Start (or return the already-running) live export endpoint for
        THIS engine: ``GET /metrics`` is the Prometheus text exposition
        of every registry cell (histogram bucket ladders included) and
        ``GET /healthz`` is :meth:`health` as JSON, answering 503 while
        :meth:`ready` is False — one endpoint doubles as scrape target
        and load-balancer readiness probe.  OFF by default: nothing in
        the engine opens a port unless an operator calls this.  Stops
        with the engine (:meth:`stop`) or explicitly via the returned
        :class:`~paddle_tpu_torch.observability.MetricsServer`'s
        ``stop()``; calling this again after a stop opens a fresh
        endpoint at the newly requested host/port.  Scrapes run on the
        server's own threads and read host-side counters only: they add
        no work to a dispatch."""
        srv = self._metrics_server
        if srv is not None and srv.running:
            return srv
        self._metrics_server = _obs.MetricsServer(
            host=host, port=port, health_fn=self.health).start()
        return self._metrics_server

    @property
    def model_version(self):
        return None if self._model is None else self._model.version

    @property
    def feed_names(self):
        return [] if self._model is None else list(self._model.feed_names)

    @property
    def fetch_names(self):
        return [] if self._model is None else list(self._model.fetch_names)

    # -- request admission ---------------------------------------------------
    def _normalize_feed(self, feed):
        return normalize_feed(self._model, feed, self.max_batch_size)

    def predict_async(self, feed, deadline_ms=None, priority=None):
        """Admit one request; returns its :class:`Request` future
        (``.result(timeout)`` / ``.done()``).  ``priority`` is one of
        ``"interactive"`` / ``"batch"`` (default) / ``"best_effort"``.
        Raises ``ServingClosed`` when stopped, ``ServingQueueFull``
        under backpressure, ``ServingOverloaded`` when the deadline is
        already unmeetable (shed at admission), ``ServingDegraded``
        while the circuit breaker is open or the worker is dead, and
        ``ServingError`` for malformed requests."""
        if self._state == "stopped":
            raise ServingClosed("engine is stopped")
        if self._state == "loading":
            raise ServingClosed("engine is still loading")
        if self._model is None:
            raise ServingError(
                "this engine has no predict model (constructed with "
                "model_dir=None); only generate() is available")
        if "batcher" in self._failed_workers:
            raise ServingDegraded(
                "serving worker is dead past its restart budget; "
                "engine degraded")
        arrays, rows = self._normalize_feed(feed)
        if priority is not None and priority not in PRIORITY_CLASSES:
            raise ServingError("unknown priority class %r (know %s)"
                               % (priority, PRIORITY_CLASSES))
        # breaker AFTER validation: a malformed request must not consume
        # the half-open probe slot
        if not self._breaker.allow():
            raise ServingDegraded(
                "circuit breaker open (consecutive fatal batches); "
                "retry after the cooldown")
        ms = deadline_ms if deadline_ms is not None else self.default_deadline_ms
        deadline = None if ms is None else time.perf_counter() + ms / 1e3
        req = self._queue.put(
            Request(arrays, rows, deadline=deadline, priority=priority))
        _requests.inc()
        return req

    def predict(self, feed, deadline_ms=None, priority=None, timeout=None):
        """Synchronous predict: returns ``[array per fetch]`` for this
        request's rows (the leading batch dim is preserved; a sample fed
        without a batch dim still comes back with rows=1 leading)."""
        return self.predict_async(
            feed, deadline_ms=deadline_ms, priority=priority).result(
            timeout=timeout)

    # -- request admission: autoregressive decode ----------------------------
    def generate_async(self, prompt, max_new_tokens=None, deadline_ms=None,
                       priority=None, temperature=None, seed=None,
                       session=None):
        """Admit one generation prompt (1-D token ids); returns its
        :class:`~.decode_scheduler.GenerateRequest` future whose
        ``result(timeout)`` is the generated int32 token ids.  Requires
        the engine to have been constructed with ``decode_model=``.
        Raises ``ServingClosed`` when stopped, ``ServingQueueFull`` under
        backpressure, ``ServingOverloaded`` when the deadline is already
        unmeetable, ``ServingDegraded`` while the decode worker is dead
        past its restart budget, and ``ServingError`` for malformed
        requests.  ``session`` continues a conversation on the decode
        scheduler (:meth:`~.decode_scheduler.DecodeScheduler.submit`)."""
        if self._state == "stopped":
            raise ServingClosed("engine is stopped")
        if self._decoder is None:
            raise ServingError(
                "this engine has no decode model; construct it with "
                "decode_model= to use generate()")
        if "decoder" in self._failed_workers:
            raise ServingDegraded(
                "decode worker is dead past its restart budget; "
                "engine degraded")
        return self._decoder.submit(prompt, max_new_tokens=max_new_tokens,
                                    deadline_ms=deadline_ms,
                                    priority=priority,
                                    temperature=temperature, seed=seed,
                                    session=session)

    def generate(self, prompt, max_new_tokens=None, deadline_ms=None,
                 priority=None, timeout=None, temperature=None, seed=None,
                 session=None):
        """Synchronous generate: int32 token ids (greedy by default;
        ``temperature``/``seed`` for sampling; stops at the decode
        model's ``eos_id`` or ``max_new_tokens``)."""
        return self.generate_async(
            prompt, max_new_tokens=max_new_tokens, deadline_ms=deadline_ms,
            priority=priority, temperature=temperature,
            seed=seed, session=session).result(timeout=timeout)

    # -- batch execution (batcher thread) ------------------------------------
    def _current_model(self):
        with self._model_lock:
            return self._model

    def _bucket_for(self, rows):
        return self._batch_core._bucket_for(rows)

    def _execute_batch(self, requests):
        # the shared padded-bucket dispatch pipeline (chaos choke point,
        # bucket pad, oversized-batch chunking, per-request slicing,
        # completion) — see BatchExecutor
        self._batch_core(requests)

    # -- hot swap ------------------------------------------------------------
    def swap_model(self, model_dir, backend="auto", drain_timeout_s=60.0):
        """Hot-swap to the model saved in ``model_dir``: load + warm the
        new version while the old keeps serving, drain every request
        admitted before this call, then flip atomically.  Requests
        admitted DURING the swap may be answered by either version (each
        answer is a complete output of exactly one version).  Returns
        the new version number."""
        if self._state == "stopped":
            raise ServingClosed("engine is stopped")
        if self._model is None:
            raise ServingError(
                "this engine has no predict model to swap (constructed "
                "with model_dir=None)")
        with self._swap_lock:
            if self._state == "stopped":  # stop() won the lock first
                raise ServingClosed("engine is stopped")
            new = self._store.load(model_dir, backend=backend)
            # a request normalized against the outgoing model's specs may
            # execute after the flip: the new model must accept exactly
            # the same feeds, or in-flight batches could poison on it
            if (new.feed_names != self._model.feed_names
                    or new.feed_specs != self._model.feed_specs):
                new.close()
                raise ServingError(
                    "swap rejected: new model feeds %s %s != serving "
                    "feeds %s %s"
                    % (new.feed_names, new.feed_specs,
                       self._model.feed_names, self._model.feed_specs))
            if self._warmup:
                new.warmup(self.batch_buckets)
            prev_state, self._state = self._state, "swapping"
            try:
                watermark = self._queue.last_seq()
                if self._batcher.alive and not self._batcher.wait_for(
                        watermark, timeout=drain_timeout_s):
                    raise ServingError(
                        "drain timed out after %.1fs (watermark seq %d, "
                        "completed %d)" % (drain_timeout_s, watermark,
                                           self._batcher.completed_seq))
            except BaseException:
                new.close()
                self._state = prev_state
                raise
            with self._model_lock:
                old, self._model = self._model, new
            # a batch popped BEFORE the flip may still be executing on
            # (or about to call) the old model; every such batch only
            # contains requests admitted before the flip, so draining to
            # the post-flip watermark guarantees the old version is idle
            # before it is closed.  If even that drain times out, leave
            # the old version open (a leak at a pathological edge)
            # rather than closing it under a running batch.
            old_idle = True
            if self._batcher.alive:
                old_idle = self._batcher.wait_for(self._queue.last_seq(),
                                                  timeout=drain_timeout_s)
            self._state = "ready"
        if old_idle:
            old.close()
        _swaps.inc()
        if self._telemetry.recording:
            self._telemetry.emit({
                "type": "model_swap", "ts": time.time(), "source": "serving",
                "from_version": old.version, "to_version": new.version,
                "model_dir": model_dir,
            })
        return new.version
