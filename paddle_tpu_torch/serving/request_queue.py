"""Bounded priority request queue + the request/future handle.

The admission edge of the serving runtime: ``put`` either admits a
request (assigning its monotonically increasing ``seq`` — the hot-swap
drain watermark) or raises a typed rejection immediately.  No blocking
puts: under overload the RIGHT behavior for a serving frontend is an
instant, typed rejection the caller can turn into load shedding, not an
unbounded line of threads parked inside the engine.  Three distinct
rejections, because the caller's correct reaction differs:

- :class:`~.errors.ServingQueueFull` — the queue (or the request's
  priority class) is at capacity: backpressure, retry elsewhere/later.
- :class:`~.errors.ServingOverloaded` — deadline-aware shed AT
  ADMISSION (Clipper, NSDI'17): the request carries a deadline that the
  current backlog divided by the measured service rate already makes
  unmeetable, so it is rejected *before* queueing instead of being
  discovered expired at pop time — the caller learns while it still has
  time to fail over.
- :class:`~.errors.ServingClosed` — the engine is stopped.

Priority classes (``interactive`` > ``batch`` > ``best_effort``) are
three FIFO lanes under one capacity: ``get`` pops the highest-priority
nonempty lane, FIFO within a lane, and each lane can carry its own
capacity cap so a flood of best-effort traffic cannot starve
interactive admission.  Strict priority is tempered by anti-starvation
aging (``starvation_s``): a lower-lane head that has waited past the
threshold pops ahead of fresher high-priority arrivals, so a
deadline-less best-effort request — and the hot-swap drain watermark
behind it — is delayed, never parked forever.  ``seq`` stays globally monotone in
ADMISSION order across lanes — the drain watermark's contract — while
completion order may now reorder across lanes (the batcher tracks
completed seqs exactly, not as a high-water mark).

The queue publishes its total depth to the ``serving.queue_depth``
gauge and per-class depths to ``serving.queue_depth_<class>`` on every
put/pop (gauges always count — reading them never requires a sink).
"""
from __future__ import annotations

import collections
import threading
import time

from .. import observability as _obs
from ..observability import tracing as _tracing
from .errors import (
    ServingClosed,
    ServingError,
    ServingOverloaded,
    ServingQueueFull,
    ServingTimeout,
)

__all__ = ["Request", "RequestQueue", "PRIORITY_CLASSES"]

#: Priority lanes, highest first.  ``get`` pops the first nonempty lane.
PRIORITY_CLASSES = ("interactive", "batch", "best_effort")

DEFAULT_PRIORITY = "batch"

_queue_depth = _obs.gauge("serving.queue_depth")
_queue_full = _obs.counter("serving.queue_full")
_shed_admission = _obs.counter("serving.shed_admission")

# Per-class completion accounting: the cells the SLO monitor windows
# over (counter deltas + histogram snapshot subtraction) and the export
# plane serves.  They live at the Request.complete/fail choke point —
# the one funnel EVERY admitted request's terminal outcome passes
# through (engine completion, batcher shed, dispatcher bisection,
# decode retire, drain_remaining) — so goodput accounting can't miss a
# path.  Like every counter, they always count (reading an SLO must not
# require a sink).
_done_counters = {}
_done_ok_counters = {}
_met_counters = {}
_rejected_counters = {}
_latency_hists = {}
for _cls in ("interactive", "batch", "best_effort"):
    _done_counters[_cls] = _obs.counter("serving.done_%s" % _cls)
    _done_ok_counters[_cls] = _obs.counter("serving.done_ok_%s" % _cls)
    _met_counters[_cls] = _obs.counter("serving.deadline_met_%s" % _cls)
    _rejected_counters[_cls] = _obs.counter("serving.rejected_%s" % _cls)
    _latency_hists[_cls] = _obs.histogram("serving.request_latency_%s" % _cls)
del _cls

# Labeled siblings of the per-class cells above, keyed (kind, name,
# model, tenant): requests stamped with a tenant and/or model (the
# router / a labeled pool) ALSO tick ``serving.done_<cls>{model=,
# tenant=}`` etc., so co-hosted deployments stop cross-contaminating
# one process-wide cell.  The unlabeled aggregates keep counting — the
# SLO monitor windows those.  Cached here because the terminal-outcome
# funnel is hot (one dict probe vs a registry lock + key build).
_labeled_cells = {}


def _labeled_cell(kind, name, model, tenant):
    key = (kind, name, model, tenant)
    cell = _labeled_cells.get(key)
    if cell is None:
        labels = {}
        if model is not None:
            labels["model"] = model
        if tenant is not None:
            labels["tenant"] = tenant
        make = _obs.histogram if kind == "h" else _obs.counter
        cell = _labeled_cells[key] = make(name, labels=labels)
    return cell


def note_rejected(cls, model=None, tenant=None):
    """Tick the per-class rejection counter (plus its tenant/model
    labeled sibling when either label is present).  Shared by the
    queue's admission raise paths and the router's quota gate, so
    every shed — capacity, deadline, or quota — lands on ONE family."""
    if cls not in _rejected_counters:
        cls = DEFAULT_PRIORITY
    _rejected_counters[cls].inc()
    if model is not None or tenant is not None:
        _labeled_cell("c", "serving.rejected_%s" % cls, model, tenant).inc()


class Request:
    """One admitted prediction request; doubles as the caller's future.

    ``feed`` maps feed name -> numpy array with the rows on axis 0;
    ``rows`` is that leading dim (shared by every feed).  ``priority``
    is one of :data:`PRIORITY_CLASSES` (default ``"batch"``).  The
    batcher fills ``_result`` (a list of per-fetch arrays, sliced back
    out of the batch) or ``_error`` and fires the event; :meth:`result`
    is the blocking accessor with deadline semantics.  ``done_ts`` is
    the ``time.perf_counter()`` instant of completion (answer OR typed
    failure) — the open-loop SLO harness reads it to measure latency
    without polling.
    """

    __slots__ = ("feed", "rows", "seq", "deadline", "priority", "trace",
                 "tenant", "model", "enqueue_wall", "enqueue_ts",
                 "dispatch_ts", "done_ts", "_event", "_result", "_error",
                 "_term_lock", "_done_cbs")

    def __init__(self, feed, rows, deadline=None, priority=None, trace=None,
                 tenant=None, model=None):
        self.feed = feed
        self.rows = int(rows)
        self.seq = None              # assigned by RequestQueue.put
        self.deadline = deadline     # absolute time.perf_counter() instant
        self.priority = priority or DEFAULT_PRIORITY
        self.trace = trace           # TraceContext root; minted at admission
        self.tenant = tenant         # multi-tenant accounting label
        self.model = model           # owning deployment's label
        self.enqueue_wall = None     # wall clock, for trace spans
        self.enqueue_ts = None       # perf_counter, for queue-wait timing
        self.dispatch_ts = None
        self.done_ts = None
        self._event = threading.Event()
        self._result = None
        self._error = None
        # serializes the terminal-outcome claim: complete() racing
        # fail() (a revived worker finishing a request the same instant
        # stop()'s drain fails it) must account exactly one outcome
        self._term_lock = threading.Lock()
        self._done_cbs = None        # add_done_callback list (lazy)

    # -- batcher side --------------------------------------------------------
    def expired(self, now=None):
        return (self.deadline is not None
                and (now if now is not None else time.perf_counter())
                > self.deadline)

    def complete(self, result):
        with self._term_lock:
            if self._event.is_set():
                return           # first terminal outcome wins
            self._result = result
            self.done_ts = time.perf_counter()
            self._note_done(ok=True)
            self._event.set()
            cbs, self._done_cbs = self._done_cbs, None
        self._run_done_cbs(cbs)

    def fail(self, exc):
        with self._term_lock:
            if self._event.is_set():
                return           # first terminal outcome wins
            self._error = exc
            self.done_ts = time.perf_counter()
            self._note_done(ok=False)
            self._event.set()
            cbs, self._done_cbs = self._done_cbs, None
        self._run_done_cbs(cbs)

    def add_done_callback(self, fn):
        """Run ``fn(self)`` once this request reaches its terminal
        outcome (answered OR failed), from the completing thread —
        immediately if it already has.  The router's per-tenant
        in-flight accounting hangs off this; callbacks run OUTSIDE the
        terminal lock and their exceptions are swallowed (a broken
        observer must not lose the completion)."""
        with self._term_lock:
            if not self._event.is_set():
                if self._done_cbs is None:
                    self._done_cbs = []
                self._done_cbs.append(fn)
                return
        self._run_done_cbs((fn,))

    def _run_done_cbs(self, cbs):
        for fn in cbs or ():
            try:
                fn(self)
            except Exception:  # noqa: BLE001 — observer must not break
                pass           # the completion path

    def _note_done(self, ok):
        """Terminal-outcome accounting: per-class done/ok/deadline-met
        counters, the end-to-end latency histogram (answered requests),
        and — when a span sink is attached — the request's ROOT trace
        span, covering admission to terminal outcome."""
        cls = self.priority if self.priority in _done_counters \
            else DEFAULT_PRIORITY
        _done_counters[cls].inc()
        labeled = self.model is not None or self.tenant is not None
        if labeled:
            _labeled_cell("c", "serving.done_%s" % cls, self.model,
                          self.tenant).inc()
        latency = (self.done_ts - self.enqueue_ts
                   if self.enqueue_ts is not None else None)
        if ok:
            _done_ok_counters[cls].inc()
            if labeled:
                _labeled_cell("c", "serving.done_ok_%s" % cls, self.model,
                              self.tenant).inc()
            if latency is not None:
                _latency_hists[cls].observe(latency)
                if labeled:
                    _labeled_cell("h", "serving.request_latency_%s" % cls,
                                  self.model, self.tenant).observe(latency)
            if self.deadline is None or self.done_ts <= self.deadline:
                _met_counters[cls].inc()
                if labeled:
                    _labeled_cell("c", "serving.deadline_met_%s" % cls,
                                  self.model, self.tenant).inc()
        tel = _obs.get_telemetry()
        if (tel.span_active() and self.trace is not None
                and self.enqueue_wall is not None):
            tel.record_span(
                "serving.request", self.enqueue_wall,
                latency if latency is not None else 0.0,
                tags=self.trace.tags(seq=self.seq, rows=self.rows,
                                     priority=cls, ok=ok))

    # -- caller side ---------------------------------------------------------
    def done(self):
        return self._event.is_set()

    def result(self, timeout=None):
        """Block until the batcher answers; returns the list of per-fetch
        arrays for this request's rows.  Raises the request's failure
        (``ServingTimeout`` when its deadline expired in queue), or
        ``ServingTimeout`` if ``timeout``/the remaining deadline elapses
        while waiting — the request itself may still complete later."""
        wait = timeout
        if self.deadline is not None:
            remaining = self.deadline - time.perf_counter()
            wait = remaining if wait is None else min(wait, remaining)
        if wait is not None:
            # an already-passed deadline means a NEGATIVE remaining wait:
            # clamp so Event.wait gets a sane value and the error below
            # reports the request's actual age, not "-0.003s"
            wait = max(0.0, wait)
        if not self._event.wait(wait):
            now = time.perf_counter()
            age = (now - self.enqueue_ts if self.enqueue_ts is not None
                   else 0.0)
            raise ServingTimeout(
                "request (seq %s, %d rows, %s) unanswered %.3fs after "
                "admission (result() waited %.3fs%s)"
                % (self.seq, self.rows, self.priority, max(0.0, age), wait,
                   "; deadline already expired" if self.expired(now) else ""))
        if self._error is not None:
            raise self._error
        return self._result


class RequestQueue:
    """Bounded multi-lane FIFO of :class:`Request` with typed admission.

    ``class_capacity`` maps priority class -> max queued requests of
    that class (absent classes default to the total ``capacity``), so
    e.g. ``{"best_effort": 16}`` keeps a best-effort flood from filling
    the whole queue.  ``depth_gauge``/``full_counter``/``shed_counter``
    let a co-hosted queue publish to its own telemetry cells (the decode
    runtime's ``serving.decode.*`` names) instead of the predict path's
    defaults.

    Deadline-aware admission needs a service-rate estimate: the batcher
    calls :meth:`note_service` after every dispatch and the queue keeps
    an EMA of rows/second.  Until the first sample arrives the estimator
    is cold and admission never sheds on deadline (a cold engine must
    not reject its warmup traffic).
    """

    def __init__(self, capacity=128, class_capacity=None, depth_gauge=None,
                 full_counter=None, shed_counter=None, gauge_prefix=None,
                 starvation_s=2.0):
        if capacity < 1:
            raise ValueError("queue capacity must be >= 1")
        self.capacity = int(capacity)
        # anti-starvation aging: a lower-lane head older than this pops
        # ahead of fresher higher-priority arrivals.  Bounds how long a
        # deadline-less low-priority request (and the hot-swap drain
        # watermark behind it) can starve under sustained interactive
        # load.  None disables aging (pure strict priority).
        self.starvation_s = None if starvation_s is None else float(
            starvation_s)
        self.class_capacity = {cls: self.capacity for cls in PRIORITY_CLASSES}
        for cls, cap in (class_capacity or {}).items():
            if cls not in self.class_capacity:
                raise ValueError("unknown priority class %r (know %s)"
                                 % (cls, PRIORITY_CLASSES))
            self.class_capacity[cls] = int(cap)
        self._lanes = {cls: collections.deque() for cls in PRIORITY_CLASSES}
        self._lane_rows = {cls: 0 for cls in PRIORITY_CLASSES}
        self._depth = 0
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._seq = 0
        self._closed = False
        self._service_rate = None    # EMA rows/second, None until warm
        self._parallelism = 1        # concurrent consumers (replica pool)
        self._service_rates = {}     # per consumer-group EMAs (keyed)
        self._consumer_groups = {}   # group key -> live count (int/callable)
        self._depth_gauge = depth_gauge if depth_gauge is not None else _queue_depth
        self._full_counter = (full_counter if full_counter is not None
                              else _queue_full)
        self._shed_counter = (shed_counter if shed_counter is not None
                              else _shed_admission)
        prefix = gauge_prefix or "serving.queue_depth"
        self._lane_gauges = {cls: _obs.gauge("%s_%s" % (prefix, cls))
                             for cls in PRIORITY_CLASSES}
        # NOTE: the serving.queue_depth gauge is process-wide (last
        # writer wins across co-hosted engines) — deliberately NOT reset
        # here, so constructing a second engine can't zero it while the
        # first has queued work.  Per-engine depth: RequestQueue.depth()
        # via engine.health().

    # -- service-rate estimate (deadline-aware admission) --------------------
    def note_service(self, rows, seconds, key=None):
        """Record one dispatch (``rows`` served in ``seconds`` of worker
        time) into the service-rate EMA the admission check divides by.
        Failed dispatches count too: they occupied the worker, which is
        what a queued request actually waits on.  ``key`` (a consumer
        GROUP — one pool among several sharing this queue) additionally
        feeds that group's own EMA, so the admission estimate can weight
        each group by its own measured speed instead of smearing a busy
        neighbor's rate across everyone (see :meth:`register_consumers`)."""
        if seconds <= 0 or rows <= 0:
            return
        rate = rows / seconds
        with self._lock:
            self._service_rate = (
                rate if self._service_rate is None
                else 0.75 * self._service_rate + 0.25 * rate)
            if key is not None:
                prev = self._service_rates.get(key)
                self._service_rates[key] = (
                    rate if prev is None else 0.75 * prev + 0.25 * rate)

    @property
    def service_rate(self):
        """EMA rows/second of ONE consumer's dispatches, or None while
        cold.  (Per-replica by construction: each dispatch is timed
        individually, so a pool of N replicas feeding this EMA still
        measures single-replica speed — which is exactly what the
        autoscale formula wants.  The ADMISSION estimate multiplies by
        :meth:`set_parallelism`'s count instead.)"""
        return self._service_rate

    def set_parallelism(self, n):
        """How many consumers drain this queue concurrently (a replica
        pool's ready-replica count; 1 for a single engine).  The
        deadline-shed admission estimate divides backlog by
        ``service_rate * parallelism`` — without this, a pool's
        admission would overestimate queue wait N-fold and shed
        deadline-carrying requests the rotation could easily serve.
        Accepts an int or a CALLABLE returning the live count, so a
        dynamic consumer set (breaker ejects, autoscale parks, worker
        deaths and revivals) is read at each estimate instead of
        maintained at every state flip."""
        with self._lock:
            self._parallelism = n if callable(n) else max(1, int(n))

    def _parallelism_locked(self):
        p = self._parallelism
        if callable(p):
            try:
                p = p()
            except Exception:  # noqa: BLE001 — estimator must not shed on
                p = 1          # a health-probe fault; fall conservative
        return max(1, int(p))

    def register_consumers(self, key, count):
        """Register one consumer GROUP draining this queue — a replica
        pool among several sharing it.  ``count`` is an int or a
        callable returning the group's LIVE consumer count (its ready
        replicas).  With groups registered, the deadline-shed admission
        estimate drains at ``sum_k(count_k * rate_k)`` — each group
        weighted by its OWN per-key EMA (:meth:`note_service` with
        ``key=``) — instead of one process-wide ``rate * parallelism``
        product.  That is the multi-pool fix: a busy neighbor pool's
        slower (or faster) dispatches no longer inflate or mask another
        deployment's shed decisions, and a group that parks all its
        consumers stops counting toward the drain rate entirely.  A
        cold group (no keyed sample yet) borrows the aggregate EMA."""
        with self._lock:
            self._consumer_groups[key] = count

    def unregister_consumers(self, key):
        """Remove a consumer group (pool stopped) and its rate EMA."""
        with self._lock:
            self._consumer_groups.pop(key, None)
            self._service_rates.pop(key, None)

    def _drain_rate_locked(self):
        """Rows/second the live consumer set drains this queue at, or
        None while the estimator is cold (admission never sheds on no
        data).  Group-aware when groups are registered; otherwise the
        legacy single-rotation product ``service_rate * parallelism``."""
        if self._consumer_groups:
            total = 0.0
            for key, count in self._consumer_groups.items():
                n = count
                if callable(n):
                    try:
                        n = n()
                    except Exception:  # noqa: BLE001 — a health-probe
                        n = 0          # fault must not distort the sum
                n = max(0, int(n))
                if not n:
                    continue
                rate = self._service_rates.get(key) or self._service_rate
                if rate:
                    total += n * rate
            if total > 0:
                return total
            # every group cold or parked: fall through to the legacy
            # estimate (conservative — better one stale aggregate than
            # "infinite wait" failing every deadline request)
        if not self._service_rate:
            return None
        return self._service_rate * self._parallelism_locked()

    def estimated_wait_s(self, priority=DEFAULT_PRIORITY):
        """Expected queue wait for a request admitted NOW at ``priority``:
        rows queued at the same or higher priority over the measured
        aggregate drain rate.  None while the estimator is cold."""
        with self._lock:
            return self._estimated_wait_locked(priority)

    def _estimated_wait_locked(self, priority):
        rate = self._drain_rate_locked()
        if not rate:
            return None
        ahead = 0
        for cls in PRIORITY_CLASSES:
            ahead += self._lane_rows[cls]
            if cls == priority:
                break
        return ahead / rate

    # -- admission -----------------------------------------------------------
    def put(self, request):
        """Admit ``request`` (assigning its ``seq``) or raise
        ``ServingQueueFull`` / ``ServingOverloaded`` / ``ServingClosed``.
        Never blocks."""
        cls = request.priority
        if cls not in self._lanes:
            raise ServingError("unknown priority class %r (know %s)"
                               % (cls, PRIORITY_CLASSES))
        with self._lock:
            if self._closed:
                raise ServingClosed("engine is stopped; request rejected")
            lane = self._lanes[cls]
            if self._depth >= self.capacity:
                self._full_counter.inc()
                note_rejected(cls, request.model, request.tenant)
                raise ServingQueueFull(
                    "request queue at capacity (%d); shed load or retry"
                    % self.capacity)
            if len(lane) >= self.class_capacity[cls]:
                self._full_counter.inc()
                note_rejected(cls, request.model, request.tenant)
                raise ServingQueueFull(
                    "priority class %r at capacity (%d); shed load or "
                    "retry" % (cls, self.class_capacity[cls]))
            if request.deadline is not None:
                est = self._estimated_wait_locked(cls)
                now = time.perf_counter()
                if est is not None and now + est > request.deadline:
                    self._shed_counter.inc()
                    note_rejected(cls, request.model, request.tenant)
                    rate = self._drain_rate_locked() or 0.0
                    raise ServingOverloaded(
                        "deadline %.0fms away but estimated %s-class "
                        "queue wait is %.0fms (%d rows ahead at %.0f "
                        "rows/s aggregate drain rate); shed at admission"
                        % (max(0.0, (request.deadline - now)) * 1e3, cls,
                           est * 1e3, int(round(est * rate)), rate))
            self._seq += 1
            request.seq = self._seq
            if request.trace is None:
                # mint the trace root HERE, at admission: every later
                # event (queue wait, batch, retries, execute, terminal
                # outcome) hangs under this id — ids are cheap enough
                # to stamp unconditionally, emission stays sink-gated
                request.trace = _tracing.new_trace()
            request.enqueue_wall = time.time()
            request.enqueue_ts = time.perf_counter()
            lane.append(request)
            self._lane_rows[cls] += request.rows
            self._depth += 1
            self._publish_locked(cls)
            self._not_empty.notify()
        return request

    def get(self, timeout=None, max_rows=None, accept=None):
        """Pop the highest-priority head request, waiting up to
        ``timeout`` seconds; None on timeout or when closed-and-empty.
        With ``max_rows``, only pops a lane head that FITS (head.rows <=
        max_rows) — the batcher's coalesce loop stays FIFO per lane
        instead of searching the queue for a filler (a lower-priority
        head that fits may ride along as filler behind a too-big
        higher-priority head).  With ``accept``, only pops a lane head
        the predicate approves — evaluated UNDER the queue lock against
        the head actually popped, so two consumers racing on the same
        queue can never claim each other's affinity-tagged head (a
        peek-then-pop gate alone cannot close that window).  The
        predicate must be fast and lock-free (it runs under the queue
        lock); a refused head stays queued for the consumer it is
        tagged for."""
        with self._lock:
            if not self._depth:
                if self._closed:
                    return None
                self._not_empty.wait(timeout)
            return self._pop_locked(max_rows, accept)

    def peek(self):
        """The head request :meth:`get` would pop right now, WITHOUT
        popping it — the replica pool's affinity-aware claim gates read
        the head's preferred-replica tag before deciding whether to
        pull.  Best-effort by design: between the peek and the pull
        another consumer may pop a different head (aging can flip the
        lane) — affinity is a placement hint, never a correctness
        dependency, so a stale answer only skews one claim decision."""
        with self._lock:
            pick = self._select_locked(None, None)
            return self._lanes[pick][0] if pick is not None else None

    def _select_locked(self, max_rows, accept=None):
        """The lane :meth:`get` pops from (aging-aware), or None."""
        pick = None
        if self.starvation_s is not None and self._depth:
            # aging: the OLDEST head that has starved past the threshold
            # wins over strict priority — sustained interactive load
            # must not park a best_effort request (and the swap drain
            # watermark behind it) forever
            cutoff = time.perf_counter() - self.starvation_s
            oldest = None
            for cls in PRIORITY_CLASSES:
                lane = self._lanes[cls]
                if (lane and lane[0].enqueue_ts <= cutoff
                        and (max_rows is None or lane[0].rows <= max_rows)
                        and (accept is None or accept(lane[0]))
                        and (oldest is None
                             or lane[0].enqueue_ts < oldest)):
                    oldest = lane[0].enqueue_ts
                    pick = cls
        if pick is None:
            for cls in PRIORITY_CLASSES:
                lane = self._lanes[cls]
                if (lane and (max_rows is None or lane[0].rows <= max_rows)
                        and (accept is None or accept(lane[0]))):
                    pick = cls
                    break
        return pick

    def _pop_locked(self, max_rows=None, accept=None):
        pick = self._select_locked(max_rows, accept)
        if pick is None:
            return None
        req = self._lanes[pick].popleft()
        self._lane_rows[pick] -= req.rows
        self._depth -= 1
        self._publish_locked(pick)
        return req

    def _publish_locked(self, cls=None):
        self._depth_gauge.set(self._depth)
        if cls is None:
            for c in PRIORITY_CLASSES:
                self._lane_gauges[c].set(len(self._lanes[c]))
        else:
            self._lane_gauges[cls].set(len(self._lanes[cls]))

    def depth(self):
        with self._lock:
            return self._depth

    def class_depths(self):
        """{priority class: queued requests} snapshot."""
        with self._lock:
            return {cls: len(self._lanes[cls]) for cls in PRIORITY_CLASSES}

    def class_rows(self):
        """{priority class: queued ROWS} snapshot — the backlog unit the
        autoscale signal divides by the service rate (a class may queue
        few requests that carry many rows each)."""
        with self._lock:
            return dict(self._lane_rows)

    def last_seq(self):
        """Seq of the newest ADMITTED request — the drain watermark."""
        with self._lock:
            return self._seq

    def close(self):
        """Reject all future puts and wake any blocked getters.  Queued
        requests stay poppable (the batcher drains them on stop)."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()

    @property
    def closed(self):
        return self._closed

    def drain_remaining(self, exc_factory=None, on_fail=None):
        """Pop everything left and fail each request (non-drain shutdown);
        returns how many were failed.  ``on_fail`` (if given) sees each
        failed request — the batcher uses it to advance its completion
        watermark past drained seqs, or ``wait_for``/swap drains would
        stall forever on requests nobody will ever serve."""
        make = exc_factory or (
            lambda r: ServingClosed("engine stopped before request ran"))
        failed = 0
        while True:
            with self._lock:
                req = self._pop_locked()
                if req is None:
                    self._publish_locked()
                    return failed
            req.fail(make(req))
            if on_fail is not None:
                on_fail(req)
            failed += 1
