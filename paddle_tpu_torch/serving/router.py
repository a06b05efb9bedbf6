"""Multi-model, multi-tenant serving plane: a router over replica pools.

Counterpart of ``paddle_tpu/serving/router.py``.  Everything below this
module serves exactly one model: one :class:`~.replica_pool.ReplicaPool`,
one queue, one SLO view.  :class:`ModelRouter` is the fleet layer, in
Clipper's model-abstraction shape (NSDI'17: one predict API in front of
heterogeneous model containers, each with its own bounded queue and
adaptive batching), with iteration-level admission intact in each pool
underneath:

* **N named deployments**, each one or more *versions*; each warm version
  is served by a ``ReplicaPool`` of its own (its own queue, batching,
  breakers, supervisor and rolling swap).  An answer is bitwise a
  dedicated single-model pool's: the router picks WHICH pool admits a
  request, never how it executes (``tools/check_router_torch.py``).
* **Warm and cold tiers.**  A cold version is its ``ModelStore``
  directory (or its decode model in ``pool_kwargs``).  The first request,
  or :meth:`ModelRouter.activate`, builds its pool (load, warm-up and, on
  the card, the captures) while the request PARKS on a
  :class:`RoutedRequest` proxy future: when the pool is up the proxy
  binds to a real admitted request, and if the activation fails every
  parked proxy fails typed.  A global ``replica_budget`` caps the warm
  fleet: activating past it first deactivates the least-recently-used
  warm version (drain-stop: its queued work is answered, then its pool
  stops, and a stopped pool gives back its graphs, KV pools and streams).
* **Tenant admission.**  :meth:`ModelRouter.set_quota` gives a tenant a
  token bucket (rows/s with a burst), a max-in-flight cap and an SLO
  class, its default priority lane.  A breach raises
  :class:`~.errors.ServingQuotaExceeded` BEFORE any queue is touched.
* **Weighted version routing.**  ``route("m", {"v1": 0.95, "v2":
  0.05})`` splits traffic by smooth weighted round-robin (deterministic:
  over any window the counts a version track its weight within one
  request), with labeled metrics a version and one-call
  :meth:`ModelRouter.rollback`.
* **Global placement.**  :meth:`ModelRouter.autoscale_tick` asks one
  ``SLOMonitor`` view a warm pool for its desired replica count, then
  shares the ``replica_budget`` out (floors first, the rest in
  proportion to the excess demand, largest remainder first).

Pools are built where the pool defaults say: ``ModelRouter()`` builds
them on the card (every CUDA device) and an activation fails typed
without one; tests pass ``devices=["cpu"]`` as a pool default.  On one
card every warm version's replicas share ``cuda:0``, each replica on a
stream of its own that no other live holder has (``streams.py``).

Telemetry, as the JAX package's: every request stamped with
``tenant``/``model`` ticks the labeled families of its class
(``serving.done_<cls>{model=,tenant=}``,
``serving.request_latency_<cls>{...}``), and the router adds
``serving.router.requests`` / ``parked`` / ``activations`` /
``deactivations`` / ``activation_failures`` (``{model,version}``),
``quota_rejections`` (``{model,tenant}``), ``rollbacks`` (``{model}``),
the gauges ``warm_models`` / ``replicas_in_use`` / ``replica_budget``,
and ``weight`` / ``desired_replicas`` / ``active_replicas`` a version.
``/metrics`` (:meth:`ModelRouter.serve_metrics`) renders them as labeled
Prometheus families.
"""
from __future__ import annotations

import re
import threading
import time

import numpy as np
import torch

from .. import observability as _obs
from .engine import normalize_feed
from .errors import (
    ServingClosed,
    ServingDegraded,
    ServingError,
    ServingQueueFull,
    ServingQuotaExceeded,
    ServingTimeout,
)
from .replica_pool import ReplicaPool
from .sessions import scoped_session
from .request_queue import DEFAULT_PRIORITY, PRIORITY_CLASSES, note_rejected

__all__ = ["ModelRouter", "TenantQuota", "RoutedRequest"]

# deployment / version / tenant ids land inside Prometheus label values
# and registry keys — keep them to characters the strict exposition
# parser reads back verbatim
_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9_.\-]*$")

_warm_gauge = _obs.gauge("serving.router.warm_models")
_in_use_gauge = _obs.gauge("serving.router.replicas_in_use")
_budget_gauge = _obs.gauge("serving.router.replica_budget")


def _check_name(kind, name):
    if not isinstance(name, str) or not _NAME_RE.match(name):
        raise ServingError(
            "%s id %r must match %s (it becomes a metric label)"
            % (kind, name, _NAME_RE.pattern))
    return name


class TenantQuota:
    """One tenant's admission budget: a token-bucket rate limit
    (``rows_per_s`` refill, ``burst_rows`` capacity — defaults to one
    second of refill), a ``max_inflight`` cap on concurrently admitted
    requests, and an ``slo_class`` that becomes the tenant's default
    priority lane.  Any knob may be None (unlimited).  Thread-safe;
    rows are reserved atomically at admission and the in-flight slot is
    released when the request reaches its terminal outcome."""

    __slots__ = ("tenant", "rows_per_s", "burst_rows", "max_inflight",
                 "slo_class", "_tokens", "_last", "inflight", "_lock")

    def __init__(self, tenant, rows_per_s=None, burst_rows=None,
                 max_inflight=None, slo_class=None):
        self.tenant = tenant
        self.rows_per_s = None if rows_per_s is None else float(rows_per_s)
        if self.rows_per_s is not None and self.rows_per_s <= 0:
            raise ServingError("rows_per_s must be > 0, got %r"
                               % rows_per_s)
        if burst_rows is None:
            burst_rows = None if self.rows_per_s is None \
                else max(1.0, self.rows_per_s)
        self.burst_rows = None if burst_rows is None else float(burst_rows)
        if self.burst_rows is not None and self.burst_rows < 1:
            raise ServingError("burst_rows must be >= 1, got %r"
                               % burst_rows)
        self.max_inflight = None if max_inflight is None \
            else int(max_inflight)
        if self.max_inflight is not None and self.max_inflight < 1:
            raise ServingError("max_inflight must be >= 1, got %r"
                               % max_inflight)
        if slo_class is not None and slo_class not in PRIORITY_CLASSES:
            raise ServingError("unknown slo_class %r (know %s)"
                               % (slo_class, PRIORITY_CLASSES))
        self.slo_class = slo_class
        self._tokens = self.burst_rows    # bucket starts full
        self._last = time.monotonic()
        self.inflight = 0
        self._lock = threading.Lock()

    def acquire(self, rows):
        """Reserve ``rows`` of rate budget and one in-flight slot, or
        raise :class:`ServingQuotaExceeded` with nothing consumed."""
        with self._lock:
            if self.rows_per_s is not None:
                now = time.monotonic()
                self._tokens = min(
                    self.burst_rows,
                    self._tokens + (now - self._last) * self.rows_per_s)
                self._last = now
                if rows > self._tokens:
                    raise ServingQuotaExceeded(
                        "tenant %r over rate quota: %d rows requested, "
                        "%.1f tokens available (%.1f rows/s, burst %.0f); "
                        "retry in ~%.0fms"
                        % (self.tenant, rows, self._tokens,
                           self.rows_per_s, self.burst_rows,
                           max(0.0, (rows - self._tokens)
                               / self.rows_per_s) * 1e3))
                self._tokens -= rows
            if self.max_inflight is not None:
                if self.inflight >= self.max_inflight:
                    if self.rows_per_s is not None:
                        # the request was NOT admitted: give the rate
                        # tokens back so the cap rejection is free
                        self._tokens = min(self.burst_rows,
                                           self._tokens + rows)
                    raise ServingQuotaExceeded(
                        "tenant %r at max in-flight (%d); wait for a "
                        "completion" % (self.tenant, self.max_inflight))
            self.inflight += 1

    def cancel(self, rows):
        """Undo a reservation whose request never got admitted
        downstream (queue full / overloaded / closed): refund the rate
        tokens and the in-flight slot."""
        with self._lock:
            if self.rows_per_s is not None:
                self._tokens = min(self.burst_rows, self._tokens + rows)
            if self.inflight > 0:
                self.inflight -= 1

    def release(self):
        """Free the in-flight slot (terminal outcome; rate tokens stay
        spent — the work happened)."""
        with self._lock:
            if self.inflight > 0:
                self.inflight -= 1

    def describe(self):
        return {
            "rows_per_s": self.rows_per_s,
            "burst_rows": self.burst_rows,
            "max_inflight": self.max_inflight,
            "slo_class": self.slo_class,
            "inflight": self.inflight,
        }


class RoutedRequest:
    """The future handed back while a COLD deployment activates: the
    request is parked (never dropped) until the pool is up, then bound
    to the real admitted :class:`~.request_queue.Request` — callers
    see one future either way.  ``result()`` waits through both legs
    under the request's own deadline; activation failure fails every
    parked proxy typed."""

    __slots__ = ("kind", "payload", "deadline", "priority", "tenant",
                 "model", "_lock", "_bound", "_inner", "_error", "_cbs")

    def __init__(self, kind, payload, deadline, priority, tenant, model):
        self.kind = kind             # "predict" | "generate"
        self.payload = payload
        self.deadline = deadline     # absolute perf_counter instant
        self.priority = priority
        self.tenant = tenant
        self.model = model
        self._lock = threading.Lock()
        self._bound = threading.Event()
        self._inner = None
        self._error = None
        self._cbs = []

    # -- router side ---------------------------------------------------------
    def _bind(self, inner):
        with self._lock:
            self._inner = inner
            self.payload = None      # free the parked feed
            cbs, self._cbs = self._cbs, None
        for fn in cbs or ():
            inner.add_done_callback(fn)
        self._bound.set()

    def _fail(self, exc):
        with self._lock:
            if self._inner is not None or self._error is not None:
                return
            self._error = exc
            self.payload = None
            cbs, self._cbs = self._cbs, None
        self._bound.set()
        for fn in cbs or ():
            try:
                fn(self)
            except Exception:  # noqa: BLE001 — observer must not break
                pass           # the failure path

    # -- caller side ---------------------------------------------------------
    def add_done_callback(self, fn):
        with self._lock:
            if self._inner is None and self._error is None:
                self._cbs.append(fn)
                return
            inner = self._inner
        if inner is not None:
            inner.add_done_callback(fn)
        else:
            try:
                fn(self)
            except Exception:  # noqa: BLE001
                pass

    def done(self):
        inner = self._inner
        if inner is not None:
            return inner.done()
        return self._error is not None

    @property
    def done_ts(self):
        """Terminal-outcome instant of the BOUND request (None while
        parked or when activation failed) — same field Request carries,
        so latency accounting treats both futures alike."""
        inner = self._inner
        return getattr(inner, "done_ts", None) if inner is not None \
            else None

    def result(self, timeout=None):
        """Block through the park-for-activation leg AND the serving
        leg; same deadline/timeout semantics as ``Request.result``."""
        t0 = time.perf_counter()
        wait = timeout
        if self.deadline is not None:
            remaining = self.deadline - t0
            wait = remaining if wait is None else min(wait, remaining)
        if wait is not None:
            wait = max(0.0, wait)
        if not self._bound.wait(wait):
            raise ServingTimeout(
                "request still parked for cold activation of %r after "
                "waiting %.3fs" % (self.model, wait))
        if self._error is not None:
            raise self._error
        left = None if timeout is None \
            else max(0.0, timeout - (time.perf_counter() - t0))
        return self._inner.result(timeout=left)


class _Version:
    """One (deployment, version): artifact location + desired shape,
    and — while warm — the live pool serving it."""

    def __init__(self, version, model_dir, replicas, pool_kwargs):
        self.version = version
        self.model_dir = model_dir
        self.replicas = int(replicas)
        self.pool_kwargs = dict(pool_kwargs)
        self.pool = None             # ReplicaPool while warm
        self.monitor = None          # per-pool SLOMonitor view (lazy)
        self.lock = threading.Lock()  # pool flip + parked list
        self.parked = []             # RoutedRequest proxies awaiting pool
        self.activating = False
        self.activation_thread = None
        self.wrr = 0.0               # smooth weighted-round-robin state
        self.last_used = 0.0         # monotonic instant of last routing
        self.error = None            # the last activation's failure

    def tier(self):
        if self.pool is not None:
            return "warm"
        return "activating" if self.activating else "cold"


class _Deployment:
    def __init__(self, name):
        self.name = name
        self.versions = {}           # version -> _Version (insertion order)
        self.weights = {}            # version -> float
        self.prev_weights = None     # last routing, for one-call rollback


class ModelRouter:
    """Route ``predict``/``generate`` across N named model deployments.

    Parameters
    ----------
    replica_budget: global cap on warm replicas across every
        deployment (None = unbounded).  Cold activation past the budget
        deactivates idle warm versions LRU-first; the autoscaler trades
        replicas across deployments inside the same cap.
    default_deadline_ms: deadline applied when a request carries none.
    default_quota: a :class:`TenantQuota`-kwargs dict applied to
        tenants with no explicit :meth:`set_quota` entry (None =
        unknown tenants are unlimited).
    pool_defaults: kwargs forwarded to every deployment's
        ``ReplicaPool`` (per-deployment ``deploy(..., **pool_kwargs)``
        entries win).
    """

    def __init__(self, replica_budget=None, default_deadline_ms=None,
                 default_quota=None, **pool_defaults):
        self.replica_budget = None if replica_budget is None \
            else int(replica_budget)
        if self.replica_budget is not None and self.replica_budget < 1:
            raise ServingError("replica_budget must be >= 1, got %r"
                               % replica_budget)
        self.default_deadline_ms = default_deadline_ms
        self._default_quota = default_quota
        self._pool_defaults = dict(pool_defaults)
        self._deps = {}
        self._quotas = {}
        self._route_lock = threading.Lock()
        # serializes tier transitions (activation + budget reclaim +
        # deactivation): two concurrent activations under a tight
        # budget would otherwise livelock deactivating each other's
        # half-built pools.  Held across the pool build AND the parked
        # submissions, so a reclaim can never stop a pool before its
        # parked requests are admitted (drain-stop then answers them).
        self._tier_lock = threading.Lock()
        self._state = "ready"
        self._metrics_server = None
        self._autoscaler_stop = threading.Event()
        self._autoscaler = None
        self._telemetry = _obs.get_telemetry()
        _budget_gauge.set(self.replica_budget if self.replica_budget
                          is not None else -1)
        self._publish()

    # -- deployment lifecycle ------------------------------------------------
    def deploy(self, name, model_dir, version="v1", replicas=1,
               warm=True, weight=None, **pool_kwargs):
        """Register one model version under deployment ``name``.

        ``warm=True`` activates it now (builds its pool, reclaiming
        budget LRU-style if needed); ``warm=False`` leaves it cold —
        the first routed request activates it on demand.  ``weight``:
        routing weight; defaults to 1.0 for a deployment's FIRST
        version and 0.0 (dark — no traffic until :meth:`route`) for
        later ones.  ``pool_kwargs`` forward to this version's
        ``ReplicaPool`` on top of the router-wide ``pool_defaults``."""
        if self._state == "stopped":
            raise ServingClosed("model router is stopped")
        _check_name("deployment", name)
        _check_name("version", version)
        if int(replicas) < 1:
            raise ServingError("replicas must be >= 1")
        with self._route_lock:
            dep = self._deps.get(name)
            if dep is None:
                dep = self._deps[name] = _Deployment(name)
            if version in dep.versions:
                raise ServingError(
                    "deployment %r already has version %r" % (name, version))
            ver = _Version(version, model_dir, replicas, pool_kwargs)
            dep.versions[version] = ver
            if weight is None:
                weight = 1.0 if len(dep.versions) == 1 else 0.0
            dep.weights[version] = float(weight)
            self._weight_gauge(dep, ver).set(dep.weights[version])
        if warm:
            self.activate(name, version)
        self._publish()
        return self

    def _dep(self, name):
        dep = self._deps.get(name)
        if dep is None:
            raise ServingError(
                "unknown deployment %r (know %s)"
                % (name, sorted(self._deps)))
        return dep

    def _ver(self, name, version):
        dep = self._dep(name)
        if version is None:
            if len(dep.versions) != 1:
                raise ServingError(
                    "deployment %r has versions %s; pass version="
                    % (name, sorted(dep.versions)))
            return dep, next(iter(dep.versions.values()))
        ver = dep.versions.get(version)
        if ver is None:
            raise ServingError(
                "deployment %r has no version %r (know %s)"
                % (name, version, sorted(dep.versions)))
        return dep, ver

    def activate(self, name, version=None, timeout=None):
        """Ensure ``name``:``version`` is warm, blocking until its pool
        is up (or raising what the activation raised).  Idempotent."""
        dep, ver = self._ver(name, version)
        with ver.lock:
            if ver.pool is not None:
                return self
            if not ver.activating:
                ver.activating = True
                self._spawn_activation(dep, ver)
            t = ver.activation_thread
        if t is not None:
            t.join(timeout)
        if ver.pool is None:
            raise ServingDegraded(
                "activation of %s:%s did not produce a pool (parked "
                "requests failed typed; see "
                "serving.router.activation_failures)"
                % (name, ver.version)) from ver.error
        return self

    def deactivate(self, name, version=None, timeout=30.0):
        """Demote a warm version to cold: drain-stop its pool (queued
        work is answered first) and drop the model.  The artifacts
        stay registered, so the next routed request re-activates it."""
        dep, ver = self._ver(name, version)
        with self._tier_lock:
            self._deactivate_version(dep, ver, reason="manual",
                                     timeout=timeout)
        return self

    def _deactivate_version(self, dep, ver, reason, timeout=30.0):
        with ver.lock:
            pool, ver.pool = ver.pool, None
            ver.monitor = None
        if pool is None:
            return
        pool.stop(drain=True, timeout=timeout)
        self._router_counter("serving.router.deactivations", dep, ver).inc()
        if self._telemetry.recording:
            self._telemetry.emit({
                "type": "router_deactivate", "ts": time.time(),
                "source": "serving", "model": dep.name,
                "version": ver.version, "reason": reason,
            })
        self._publish()

    def _spawn_activation(self, dep, ver):
        """Start the activation thread (caller holds ``ver.lock`` and
        has set ``ver.activating``)."""
        t = threading.Thread(
            target=self._activate_version, args=(dep, ver),
            name="paddle-tpu-torch-router-activate-%s-%s"
            % (dep.name, ver.version), daemon=True)
        ver.activation_thread = t
        t.start()

    def _activate_version(self, dep, ver):
        with self._tier_lock:
            try:
                self._reclaim_budget(ver)
                kw = dict(self._pool_defaults)
                kw.update(ver.pool_kwargs)
                pool = ReplicaPool(ver.model_dir, replicas=ver.replicas,
                                   model_label=dep.name, **kw)
            except Exception as exc:  # noqa: BLE001 — activation faults
                # fail the parked requests typed, never hang or kill the
                # router
                with ver.lock:
                    parked, ver.parked = ver.parked, []
                    ver.activating = False
                    ver.activation_thread = None
                    ver.error = exc
                self._router_counter("serving.router.activation_failures",
                                     dep, ver).inc()
                err = exc if isinstance(exc, ServingError) \
                    else ServingDegraded(
                        "cold activation of %s:%s failed: %r"
                        % (dep.name, ver.version, exc))
                for proxy in parked:
                    proxy._fail(err)
                return
            with ver.lock:
                ver.pool = pool
                parked, ver.parked = ver.parked, []
                ver.activating = False
                ver.activation_thread = None
                ver.error = None
            self._router_counter("serving.router.activations",
                                 dep, ver).inc()
            if self._telemetry.recording:
                self._telemetry.emit({
                    "type": "router_activate", "ts": time.time(),
                    "source": "serving", "model": dep.name,
                    "version": ver.version, "replicas": pool.replicas,
                    "parked": len(parked),
                })
            self._publish()
            # still under the tier lock: a concurrent reclaim must not
            # stop this pool before the parked requests are ADMITTED —
            # once they are, a drain-stop answers them
            for proxy in parked:
                self._submit_parked(ver, proxy)

    def _reclaim_budget(self, ver):
        """Make room for ``ver.replicas`` under the global budget by
        deactivating idle warm versions least-recently-USED first.
        Raises when the budget simply cannot fit the activation."""
        if self.replica_budget is None:
            return
        if ver.replicas > self.replica_budget:
            raise ServingError(
                "version needs %d replicas but the global budget is %d"
                % (ver.replicas, self.replica_budget))
        while True:
            with self._route_lock:
                warm = [v for d in self._deps.values()
                        for v in d.versions.values()
                        if v.pool is not None and v is not ver]
                used = sum(v.pool.replicas for v in warm)
                if used + ver.replicas <= self.replica_budget:
                    return
                victims = sorted(warm, key=lambda v: v.last_used)
                if not victims:
                    raise ServingError(
                        "replica budget %d exhausted and no warm "
                        "version to deactivate" % self.replica_budget)
                victim = victims[0]
                vdep = next(d for d in self._deps.values()
                            if victim in d.versions.values())
            self._deactivate_version(vdep, victim, reason="lru_budget")

    # -- tenancy -------------------------------------------------------------
    def set_quota(self, tenant, rows_per_s=None, burst_rows=None,
                  max_inflight=None, slo_class=None):
        """Install (or replace) ``tenant``'s admission quota.  See
        :class:`TenantQuota`; pass all-None knobs to make the tenant
        explicitly unlimited."""
        _check_name("tenant", tenant)
        q = TenantQuota(tenant, rows_per_s=rows_per_s,
                        burst_rows=burst_rows, max_inflight=max_inflight,
                        slo_class=slo_class)
        self._quotas[tenant] = q
        return q

    def _quota_for(self, tenant):
        if tenant is None:
            return None
        q = self._quotas.get(tenant)
        if q is None and self._default_quota is not None:
            q = self.set_quota(tenant, **self._default_quota)
        return q

    def _charge(self, quota, dep, rows, priority):
        if quota is None:
            return
        try:
            quota.acquire(rows)
        except ServingQuotaExceeded:
            _obs.counter("serving.router.quota_rejections",
                         {"model": dep.name,
                          "tenant": quota.tenant}).inc()
            # quota sheds land on the same per-class rejected family as
            # queue sheds — goodput accounting must see every shed
            note_rejected(priority or DEFAULT_PRIORITY, dep.name,
                          quota.tenant)
            raise

    # -- routing -------------------------------------------------------------
    def route(self, name, weights):
        """Set the steady-state version split for ``name`` —
        ``route("m", {"v1": 0.95, "v2": 0.05})``.  Versions absent from
        ``weights`` go dark (weight 0); at least one weight must be
        positive.  The previous split is kept for :meth:`rollback`."""
        dep = self._dep(name)
        with self._route_lock:
            unknown = set(weights) - set(dep.versions)
            if unknown:
                raise ServingError(
                    "route(%r): unknown versions %s (know %s)"
                    % (name, sorted(unknown), sorted(dep.versions)))
            for v, w in weights.items():
                if float(w) < 0:
                    raise ServingError(
                        "route(%r): weight for %r must be >= 0, got %r"
                        % (name, v, w))
            if not any(float(w) > 0 for w in weights.values()):
                raise ServingError(
                    "route(%r): at least one version needs weight > 0"
                    % name)
            dep.prev_weights = dict(dep.weights)
            dep.weights = {v: float(weights.get(v, 0.0))
                           for v in dep.versions}
            for ver in dep.versions.values():
                ver.wrr = 0.0
                self._weight_gauge(dep, ver).set(dep.weights[ver.version])
        return self

    def rollback(self, name):
        """One-call canary rollback: swap the deployment's routing back
        to the split in place before the last :meth:`route` (calling it
        twice toggles).  Raises if no previous split exists."""
        dep = self._dep(name)
        with self._route_lock:
            if dep.prev_weights is None:
                raise ServingError(
                    "rollback(%r): no previous routing recorded" % name)
            dep.weights, dep.prev_weights = (dict(dep.prev_weights),
                                             dict(dep.weights))
            for ver in dep.versions.values():
                ver.wrr = 0.0
                self._weight_gauge(dep, ver).set(dep.weights[ver.version])
        _obs.counter("serving.router.rollbacks", {"model": name}).inc()
        return self

    def _pick_locked(self, dep):
        """Smooth weighted round-robin (the deterministic nginx shape):
        every pick adds each version's weight to its running score,
        serves the max, then subtracts the weight total from the
        winner.  Over any window the per-version counts track the
        weights within one request — exact enough to gate in CI."""
        best, total = None, 0.0
        for ver in dep.versions.values():
            w = dep.weights.get(ver.version, 0.0)
            if w <= 0:
                continue
            ver.wrr += w
            total += w
            if best is None or ver.wrr > best.wrr:
                best = ver
        if best is None:
            raise ServingError(
                "deployment %r has no routable version (all weights 0)"
                % dep.name)
        best.wrr -= total
        best.last_used = time.monotonic()
        return best

    # -- request admission ---------------------------------------------------
    def _request_rows(self, pool, feed):
        """Rows this request will occupy, for the token bucket.  Exact
        via the pool's feed specs when the version is warm; for a COLD
        version a best-effort estimate (leading dim of any feed array
        that carries a batch dim, else 1), exact again the moment the
        pool is up.  The estimate reads numpy arrays and torch tensors
        (on any device) without copying them."""
        if pool is not None:
            m = pool._spec_model()
            if m is not None:
                _, rows = normalize_feed(m, feed, pool.max_batch_size)
                return rows
        rows = 1
        for v in feed.values():
            shape = (tuple(v.shape) if isinstance(v, torch.Tensor)
                     else np.shape(v))
            if len(shape) >= 2:
                rows = max(rows, int(shape[0]))
        return rows

    def predict_async(self, name, feed, deadline_ms=None, priority=None,
                      tenant=None):
        """Route one prediction to deployment ``name``: pick a version
        by weight, enforce the tenant's quota, and either admit into
        the warm pool (returns its ``Request``) or park on a
        :class:`RoutedRequest` while the cold version activates."""
        if self._state == "stopped":
            raise ServingClosed("model router is stopped")
        dep = self._dep(name)
        with self._route_lock:
            ver = self._pick_locked(dep)
        pool = ver.pool
        quota = self._quota_for(tenant)
        if priority is None and quota is not None:
            priority = quota.slo_class
        rows = self._request_rows(pool, feed)
        self._charge(quota, dep, rows, priority)
        self._router_counter("serving.router.requests", dep, ver).inc()
        ms = deadline_ms if deadline_ms is not None \
            else self.default_deadline_ms
        try:
            if pool is not None:
                try:
                    inner = pool.predict_async(
                        feed, deadline_ms=ms, priority=priority,
                        tenant=tenant)
                except ServingClosed:
                    # lost the race with an LRU deactivation: the
                    # version is logically available, just cold again —
                    # park and re-activate instead of bouncing the
                    # caller off a stopping pool
                    inner = self._park(dep, ver, "predict", feed, ms,
                                       priority, tenant)
            else:
                inner = self._park(dep, ver, "predict", feed, ms,
                                   priority, tenant)
        except ServingError:
            if quota is not None:
                quota.cancel(rows)
            raise
        if quota is not None:
            inner.add_done_callback(lambda _r: quota.release())
        return inner

    def predict(self, name, feed, deadline_ms=None, priority=None,
                tenant=None, timeout=None):
        return self.predict_async(
            name, feed, deadline_ms=deadline_ms, priority=priority,
            tenant=tenant).result(timeout=timeout)

    def generate_async(self, name, prompt, max_new_tokens=None,
                       deadline_ms=None, priority=None, temperature=None,
                       seed=None, tenant=None, session=None):
        """Route one generation (deployment's pools must be built with
        ``decode_model=`` in their pool kwargs).  Quota charges one row
        per generation; parking and activation work as for predict.

        ``session=`` tags the turn of a conversation; the id is scoped
        per (deployment, tenant) before it reaches the pool, so two
        tenants reusing the same session string can never share KV."""
        if self._state == "stopped":
            raise ServingClosed("model router is stopped")
        dep = self._dep(name)
        with self._route_lock:
            ver = self._pick_locked(dep)
        pool = ver.pool
        quota = self._quota_for(tenant)
        if priority is None and quota is not None:
            priority = quota.slo_class
        self._charge(quota, dep, 1, priority)
        self._router_counter("serving.router.requests", dep, ver).inc()
        ms = deadline_ms if deadline_ms is not None \
            else self.default_deadline_ms
        scoped = None if session is None \
            else scoped_session(dep.name, tenant, session)
        payload = {"prompt": prompt, "max_new_tokens": max_new_tokens,
                   "temperature": temperature, "seed": seed,
                   "session": scoped}
        try:
            if pool is not None:
                try:
                    inner = pool.generate_async(
                        prompt, max_new_tokens=max_new_tokens,
                        deadline_ms=ms, priority=priority,
                        temperature=temperature, seed=seed, tenant=tenant,
                        session=scoped)
                except ServingClosed:
                    inner = self._park(dep, ver, "generate", payload, ms,
                                       priority, tenant)
            else:
                inner = self._park(dep, ver, "generate", payload, ms,
                                   priority, tenant)
        except ServingError:
            if quota is not None:
                quota.cancel(1)
            raise
        if quota is not None:
            inner.add_done_callback(lambda _r: quota.release())
        return inner

    def generate(self, name, prompt, max_new_tokens=None, deadline_ms=None,
                 priority=None, temperature=None, seed=None, tenant=None,
                 session=None, timeout=None):
        return self.generate_async(
            name, prompt, max_new_tokens=max_new_tokens,
            deadline_ms=deadline_ms, priority=priority,
            temperature=temperature, seed=seed,
            tenant=tenant, session=session).result(timeout=timeout)

    def end_session(self, name, session, tenant=None):
        """Explicitly finish a conversation on ``name``'s ACTIVE
        version: releases the session's pinned KV pages and drops the
        record.  Returns True when the session existed.  (A cold-tier
        demotion drops a deployment's sessions wholesale — the pool's
        stop path clears its store — so ending them is only needed to
        reclaim pins early.)"""
        if self._state == "stopped":
            raise ServingClosed("model router is stopped")
        dep = self._dep(name)
        with self._route_lock:
            ver = self._pick_locked(dep)
        pool = ver.pool
        if pool is None or getattr(pool, "sessions", None) is None:
            return False
        return pool.end_session(
            scoped_session(dep.name, tenant, session))

    def _park(self, dep, ver, kind, payload, deadline_ms, priority,
              tenant):
        """Park one request while ``ver`` activates.  Parked requests
        submit in park order once the pool is up; requests admitted
        AFTER the flip go straight to the pool (they may overtake the
        parked tail — admission order restarts at activation)."""
        deadline = None if deadline_ms is None \
            else time.perf_counter() + deadline_ms / 1e3
        proxy = RoutedRequest(kind, payload, deadline, priority, tenant,
                              dep.name)
        submit_now = False
        with ver.lock:
            if ver.pool is not None:
                submit_now = True    # activation finished under our feet
            else:
                ver.parked.append(proxy)
                if not ver.activating:
                    ver.activating = True
                    self._spawn_activation(dep, ver)
        if submit_now:
            self._submit_parked(ver, proxy)
        else:
            self._router_counter("serving.router.parked", dep, ver).inc()
        return proxy

    # a parked request rebinding into live traffic retries queue-full
    # backpressure this long (its own deadline still wins if shorter) —
    # parked means parked, not "dropped because the herd woke up first"
    _REBIND_RETRY_S = 60.0

    def _submit_parked(self, ver, proxy):
        """Bind one parked proxy to a real admitted request on the now-
        warm pool.  Queue-full backpressure is retried with a short
        backoff (the freshly woken pool is draining the same herd this
        proxy parked with); every other typed admission failure — and
        the proxy's own expired deadline — fails the proxy."""
        pool = ver.pool
        give_up = time.perf_counter() + self._REBIND_RETRY_S
        try:
            if pool is None:
                raise ServingDegraded(
                    "pool for %r vanished before the parked request "
                    "could be admitted" % proxy.model)
            while True:
                remaining_ms = None
                if proxy.deadline is not None:
                    remaining = proxy.deadline - time.perf_counter()
                    if remaining <= 0:
                        raise ServingTimeout(
                            "deadline expired while parked for cold "
                            "activation of %r" % proxy.model)
                    remaining_ms = remaining * 1e3
                try:
                    if proxy.kind == "predict":
                        inner = pool.predict_async(
                            proxy.payload, deadline_ms=remaining_ms,
                            priority=proxy.priority, tenant=proxy.tenant)
                    else:
                        p = proxy.payload
                        inner = pool.generate_async(
                            p["prompt"],
                            max_new_tokens=p["max_new_tokens"],
                            deadline_ms=remaining_ms,
                            priority=proxy.priority,
                            temperature=p["temperature"], seed=p["seed"],
                            tenant=proxy.tenant,
                            session=p.get("session"))
                    break
                except ServingQueueFull:
                    if (self._state == "stopped"
                            or time.perf_counter() >= give_up):
                        raise
                    time.sleep(0.005)
        except ServingError as exc:
            proxy._fail(exc)
            return
        except Exception as exc:  # noqa: BLE001 — a malformed parked
            # feed must fail ITS request, not strand the rest
            proxy._fail(ServingError(
                "parked request submission failed: %r" % (exc,)))
            return
        proxy._bind(inner)

    # -- global placement ----------------------------------------------------
    def _monitor_for(self, ver, pool):
        if ver.monitor is None:
            from ..observability import SLOMonitor

            ver.monitor = SLOMonitor(
                (), engine=pool, min_replicas=pool.min_replicas,
                max_replicas=pool.max_replicas)
        return ver.monitor

    def autoscale_tick(self):
        """One cross-pool placement decision: each warm pool's OWN
        backlog/service-rate view (a per-pool ``SLOMonitor``, reading
        that pool's health — not the process-wide gauge) proposes a
        desired replica count; the router arbitrates the global
        ``replica_budget`` across them — every pool keeps its floor
        (``min_replicas``), the leftover splits proportionally to
        excess demand (largest remainder) — and applies the grants via
        ``set_active_replicas``.  Returns ``{"model:version":
        granted}``."""
        with self._route_lock:
            entries = [(dep, ver, ver.pool)
                       for dep in self._deps.values()
                       for ver in dep.versions.values()
                       if ver.pool is not None]
        desired, granted = {}, {}
        for dep, ver, pool in entries:
            key = "%s:%s" % (dep.name, ver.version)
            try:
                d = self._monitor_for(ver, pool).desired_replicas()
            except Exception:  # noqa: BLE001 — a sick health probe must
                d = pool.active_replicas()  # not wedge global placement
            desired[key] = max(pool.min_replicas,
                               min(int(d), pool.max_replicas))
            self._tick_gauge("desired_replicas", dep, ver).set(
                desired[key])
        budget = self.replica_budget
        if budget is not None and sum(desired.values()) > budget:
            floors = {}
            for dep, ver, pool in entries:
                key = "%s:%s" % (dep.name, ver.version)
                floors[key] = min(pool.min_replicas, desired[key])
            leftover = budget - sum(floors.values())
            excess = {k: desired[k] - floors[k] for k in desired}
            total_excess = sum(excess.values())
            granted = dict(floors)
            if leftover > 0 and total_excess > 0:
                shares = {k: leftover * excess[k] / total_excess
                          for k in excess}
                for k in granted:
                    granted[k] += int(shares[k])
                rem = budget - sum(granted.values())
                for k in sorted(shares,
                                key=lambda k: shares[k] - int(shares[k]),
                                reverse=True):
                    if rem <= 0:
                        break
                    if granted[k] < desired[k]:
                        granted[k] += 1
                        rem -= 1
        else:
            granted = dict(desired)
        for dep, ver, pool in entries:
            key = "%s:%s" % (dep.name, ver.version)
            pool.set_active_replicas(granted[key],
                                     reason="router_autoscale")
            self._tick_gauge("active_replicas", dep, ver).set(
                pool.active_replicas())
        self._publish()
        return granted

    def start_autoscaler(self, interval_s=1.0):
        """Run :meth:`autoscale_tick` on a daemon thread."""
        if self._autoscaler is not None and self._autoscaler.is_alive():
            return self
        self._autoscaler_stop.clear()

        def loop():
            while not self._autoscaler_stop.wait(float(interval_s)):
                try:
                    self.autoscale_tick()
                except Exception:  # noqa: BLE001 — placement must
                    # outlive a flaky pool health probe
                    _obs.inc("serving.router.tick_errors")

        self._autoscaler = threading.Thread(
            target=loop, name="paddle-tpu-torch-router-autoscaler",
            daemon=True)
        self._autoscaler.start()
        return self

    def stop_autoscaler(self, timeout=2.0):
        self._autoscaler_stop.set()
        t = self._autoscaler
        if t is not None and t.is_alive():
            t.join(timeout)
        self._autoscaler = None

    # -- telemetry helpers ---------------------------------------------------
    def _router_counter(self, name, dep, ver):
        return _obs.counter(name, {"model": dep.name,
                                   "version": ver.version})

    def _weight_gauge(self, dep, ver):
        return _obs.gauge("serving.router.weight",
                          {"model": dep.name, "version": ver.version})

    def _tick_gauge(self, which, dep, ver):
        return _obs.gauge("serving.router.%s" % which,
                          {"model": dep.name, "version": ver.version})

    def _publish(self):
        warm = in_use = 0
        for dep in self._deps.values():
            for ver in dep.versions.values():
                if ver.pool is not None:
                    warm += 1
                    in_use += ver.pool.replicas
        _warm_gauge.set(warm)
        _in_use_gauge.set(in_use)

    # -- introspection -------------------------------------------------------
    def ready(self):
        """Load-balancer truth: something can (or will, after an
        on-demand activation) serve."""
        if self._state != "ready":
            return False
        any_version = False
        for dep in self._deps.values():
            for ver in dep.versions.values():
                any_version = True
                if ver.pool is not None and ver.pool.ready():
                    return True
        # no warm pool: cold versions still activate on demand
        return any_version

    def health(self):
        self._publish()
        deployments = {}
        for dep in self._deps.values():
            versions = {}
            for ver in dep.versions.values():
                entry = {
                    "tier": ver.tier(),
                    "weight": dep.weights.get(ver.version, 0.0),
                    "replicas": ver.replicas,
                    "parked": len(ver.parked),
                    "model_dir": ver.model_dir,
                }
                if ver.pool is not None:
                    ph = ver.pool.health()
                    entry["pool"] = {
                        "state": ph["state"],
                        "ready": ph["ready"],
                        "active_replicas": ph["active_replicas"],
                        "ready_replicas": ph["ready_replicas"],
                        "queue_depth": ph["queue_depth"],
                        "requests": ph["requests"],
                        "model_version": ph["model_version"],
                    }
                versions[ver.version] = entry
            deployments[dep.name] = {
                "versions": versions,
                "previous_routing": dep.prev_weights,
            }
        return {
            "state": self._state,
            "ready": self.ready(),
            "replica_budget": self.replica_budget,
            "deployments": deployments,
            "tenants": {t: q.describe()
                        for t, q in sorted(self._quotas.items())},
        }

    def serve_metrics(self, host="127.0.0.1", port=0):
        """Live ``/metrics`` + ``/healthz`` endpoint for the whole
        router (labeled ``serving.router.*`` families included)."""
        srv = self._metrics_server
        if srv is not None and srv.running:
            return srv
        self._metrics_server = _obs.MetricsServer(
            host=host, port=port, health_fn=self.health).start()
        return self._metrics_server

    # -- lifecycle -----------------------------------------------------------
    def stop(self, drain=True, timeout=None):
        """Stop the router: end placement, settle in-flight
        activations, fail anything still parked typed, then stop every
        warm pool (``drain=True`` answers queued work first)."""
        if self._state == "stopped":
            return
        self._state = "stopped"
        self.stop_autoscaler()
        for dep in list(self._deps.values()):
            for ver in dep.versions.values():
                t = ver.activation_thread
                if t is not None:
                    t.join(timeout if timeout is not None else 30.0)
                with ver.lock:
                    parked, ver.parked = ver.parked, []
                    ver.activating = False
                for proxy in parked:
                    proxy._fail(ServingClosed(
                        "model router stopped while the request was "
                        "parked"))
        for dep in list(self._deps.values()):
            for ver in dep.versions.values():
                pool = ver.pool
                if pool is not None:
                    pool.stop(drain=drain, timeout=timeout)
        if self._metrics_server is not None:
            self._metrics_server.stop()
            self._metrics_server = None
        self._publish()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
