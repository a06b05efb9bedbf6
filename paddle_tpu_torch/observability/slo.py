"""SLO monitoring: windowed goodput/tail-latency targets + autoscale signal.

A copy of the JAX package's monitor for the port: it reads the same
registry cells, which the port's serving runtime fills under the same
names.

Clipper's (NSDI'17) operating thesis is that a serving system must be
driven by CONTINUOUSLY MEASURED per-class tail latency, not by averages
or offline benchmarks.  The serving stack already records everything
that needs (per-class completion counters + latency histograms, queue
depth and per-class backlog gauges, the admission queue's service-rate
EMA); this module closes the loop:

- :class:`SLOTarget` declares what "meeting the SLO" means for one
  priority class: minimum goodput-under-deadline (within-deadline
  answers over attempts, sheds counting against — the Clipper metric)
  and/or p95/p99 latency ceilings.
- :class:`SLOMonitor` evaluates the targets over sliding windows by
  DIFFING cumulative cells (counter deltas, histogram snapshot
  subtraction — no per-request bookkeeping of its own), emits a typed
  :class:`SLOAlert` per breach (also as a ``type: "slo_alert"``
  telemetry record and through ``on_alert``), publishes per-class
  ``serving.slo.goodput_<class>`` / ``serving.slo.p99_ms_<class>``
  gauges the export plane serves live, and
- computes ``serving.autoscale.desired_replicas`` — the replica count a
  pool would need to drain the current per-class backlog within its
  drain target at the measured per-replica service rate.  This gauge is
  the concrete hook the ROADMAP's replica pool consumes; until that
  lands it is the operator's scale-up/down dashboard number.

The monitor is pull-based and passive: ``evaluate()`` costs a handful
of dict reads per window and runs either on demand or on its own daemon
thread (``start()``); it never touches the serving hot path.
"""
from __future__ import annotations

import collections
import math
import threading
import time

from . import registry as _reg

__all__ = ["SLOTarget", "SLOAlert", "SLOMonitor"]

#: mirrors serving.request_queue.PRIORITY_CLASSES without importing the
#: serving package (observability must stay importable standalone)
_CLASSES = ("interactive", "batch", "best_effort")



class SLOTarget:
    """Declared service objective for one priority class.

    Any of the three thresholds may be None (not enforced):
    ``goodput`` — minimum fraction of ATTEMPTED requests (admitted +
    typed-rejected) answered within their deadline over the window;
    ``p95_ms`` / ``p99_ms`` — latency ceilings over answered requests.
    ``min_requests`` guards against deciding a breach from a
    statistically meaningless window (fewer attempts than this →
    the class is skipped this window).
    """

    __slots__ = ("priority", "goodput", "p95_ms", "p99_ms", "min_requests")

    def __init__(self, priority, goodput=None, p95_ms=None, p99_ms=None,
                 min_requests=10):
        if priority not in _CLASSES:
            raise ValueError("unknown priority class %r (know %s)"
                             % (priority, _CLASSES))
        self.priority = priority
        self.goodput = goodput
        self.p95_ms = p95_ms
        self.p99_ms = p99_ms
        self.min_requests = int(min_requests)

    def __repr__(self):
        return ("SLOTarget(%s, goodput=%s, p95_ms=%s, p99_ms=%s)"
                % (self.priority, self.goodput, self.p95_ms, self.p99_ms))


class SLOAlert:
    """One typed breach record: ``kind`` is ``"goodput"`` / ``"p95_ms"``
    / ``"p99_ms"``, ``observed`` the measured value, ``target`` the
    declared threshold, over ``window_s`` seconds ending at ``ts``."""

    __slots__ = ("ts", "priority", "kind", "observed", "target",
                 "window_s", "attempts")

    def __init__(self, ts, priority, kind, observed, target, window_s,
                 attempts):
        self.ts = ts
        self.priority = priority
        self.kind = kind
        self.observed = observed
        self.target = target
        self.window_s = window_s
        self.attempts = attempts

    def as_record(self):
        return {
            "type": "slo_alert", "ts": self.ts, "source": "slo",
            "priority": self.priority, "kind": self.kind,
            "observed": self.observed, "target": self.target,
            "window_s": self.window_s, "attempts": self.attempts,
        }

    def __repr__(self):
        return ("SLOAlert(%s %s observed=%.4g target=%.4g over %.1fs)"
                % (self.priority, self.kind, self.observed, self.target,
                   self.window_s))


class _ClassBaseline:
    __slots__ = ("done", "met", "rejected", "hist")

    def __init__(self, done, met, rejected, hist):
        self.done = done
        self.met = met
        self.rejected = rejected
        self.hist = hist


class SLOMonitor:
    """Evaluate declared :class:`SLOTarget` s against live telemetry.

    Parameters
    ----------
    targets: iterable of :class:`SLOTarget` (at most one per class).
    engine: an :class:`~paddle_tpu_torch.serving.InferenceEngine`; wires
        queue depth, per-class backlog, and the service-rate EMA from
        ``engine.health()``.  Pass explicit ``backlog_fn`` /
        ``service_rate_fn`` instead to monitor anything else (tests, a
        future replica pool).
    window_s: evaluation window; also the background thread's period.
    drain_target_s: per-class seconds within which the backlog AT OR
        ABOVE that class should be drainable — the autoscale formula's
        denominator.  A dict ``{class: seconds}`` or one float for all;
        default 1.0s.
    min_replicas / max_replicas: clamp for the desired-replica signal.
    on_alert: callable receiving each :class:`SLOAlert` (the telemetry
        ``slo_alert`` record is emitted regardless, when recording).
    telemetry: registry to read/publish (default process-wide).

    ``evaluate()`` returns a report dict and rolls the window baseline;
    ``start()`` runs it on a daemon thread every ``window_s``.  Alerts
    are kept on a bounded deque (:attr:`alerts`).
    """

    def __init__(self, targets, engine=None, window_s=5.0,
                 drain_target_s=1.0, min_replicas=1, max_replicas=64,
                 on_alert=None, backlog_fn=None, service_rate_fn=None,
                 telemetry=None):
        self.targets = {}
        for t in targets:
            if t.priority in self.targets:
                raise ValueError("duplicate SLOTarget for %r" % t.priority)
            self.targets[t.priority] = t
        self.window_s = float(window_s)
        if isinstance(drain_target_s, dict):
            self.drain_target_s = {c: float(drain_target_s.get(c, 1.0))
                                   for c in _CLASSES}
        else:
            self.drain_target_s = {c: float(drain_target_s) for c in _CLASSES}
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self._on_alert = on_alert
        self._tel = telemetry if telemetry is not None else _reg.get_telemetry()
        self._engine = engine
        self._backlog_fn = backlog_fn
        self._service_rate_fn = service_rate_fn
        self.alerts = collections.deque(maxlen=256)
        self.evaluations = 0
        self._lock = threading.Lock()
        self._baselines = {c: self._read_class(c)
                           for c in _CLASSES}
        self._last_eval = time.perf_counter()
        self._stop_evt = threading.Event()
        self._thread = None

    # -- cell access ---------------------------------------------------------
    def _cells(self, cls):
        t = self._tel
        return (t.counter("serving.done_%s" % cls),
                t.counter("serving.deadline_met_%s" % cls),
                t.counter("serving.rejected_%s" % cls),
                t.histogram("serving.request_latency_%s" % cls))

    def _read_class(self, cls):
        done, met, rej, hist = self._cells(cls)
        return _ClassBaseline(done.value, met.value, rej.value,
                              hist.snapshot())

    def _backlog(self):
        """(queue_depth, {class: backlog_rows}, service_rate).  Each
        signal independently prefers its injected callable and falls
        back to the engine's health surface — injecting only one of
        ``backlog_fn``/``service_rate_fn`` alongside ``engine=`` must
        not silently blind the other signal."""
        backlog = dict(self._backlog_fn()) if self._backlog_fn else None
        rate = self._service_rate_fn() if self._service_rate_fn else None
        depth = None if backlog is None else sum(backlog.values())
        if ((backlog is None or rate is None)
                and self._engine is not None):
            h = self._engine.health()
            if backlog is None:
                backlog = dict(h.get("class_rows")
                               or h.get("class_depths") or {})
                depth = h.get("queue_depth", 0)
            if rate is None:
                rate = h.get("service_rate_rows_per_s")
        return depth or 0, backlog or {}, rate

    # -- evaluation ----------------------------------------------------------
    def desired_replicas(self, depth=None, backlog=None, rate=None,
                         breached=False):
        """The autoscale signal: smallest replica count that drains the
        backlog at or above every class within that class's drain
        target, at the measured per-replica service rate.  Strictly
        higher-priority backlog counts against each class (it is served
        first).  A breached window floors the answer at
        ``min_replicas + 1`` — tail pain with a deceptively short queue
        still asks for help.  Cold estimator → ``min_replicas`` (never
        scale on no data)."""
        if depth is None or backlog is None or rate is None:
            d, b, r = self._backlog()
            depth = d if depth is None else depth
            backlog = b if backlog is None else backlog
            rate = r if rate is None else rate
        n = self.min_replicas
        if rate:
            need, ahead = 0.0, 0
            for cls in _CLASSES:
                ahead += int(backlog.get(cls, 0))
                need = max(need,
                           ahead / (rate * self.drain_target_s[cls]))
            if depth:
                # total queue depth floors the per-class sum: work the
                # class gauges haven't attributed (a race between the
                # two reads, a foreign priority label) still needs
                # draining, within the loosest class target.  depth is
                # in REQUESTS (engine health) vs rate in rows/s — each
                # request is >= 1 row, so this floor is conservative
                # (never over-asks, may under-ask for multi-row
                # requests); the per-class rows term is the tight one.
                slowest = max(self.drain_target_s[c] for c in _CLASSES)
                need = max(need, depth / (rate * slowest))
            n = max(n, int(math.ceil(need)))
        if breached:
            n = max(n, self.min_replicas + 1)
        return min(n, self.max_replicas)

    def evaluate(self):
        """One window: per-class goodput + tail quantiles vs targets,
        alert on breach, publish gauges, roll the baseline.  Returns
        ``{"window_s", "per_class", "alerts", "desired_replicas"}``."""
        with self._lock:
            now = time.time()
            window_s = max(1e-9, time.perf_counter() - self._last_eval)
            self._last_eval = time.perf_counter()
            per_class, new_alerts = {}, []
            for cls in _CLASSES:
                cur = self._read_class(cls)
                base = self._baselines[cls]
                self._baselines[cls] = cur
                done = cur.done - base.done
                met = cur.met - base.met
                rejected = cur.rejected - base.rejected
                attempts = done + rejected
                delta = cur.hist - base.hist
                p50, p95, p99 = delta.quantiles((0.5, 0.95, 0.99))
                entry = {
                    "attempts": attempts, "done": done,
                    "deadline_met": met, "rejected": rejected,
                    "goodput": (met / attempts) if attempts else None,
                    "p50_ms": None if p50 is None else p50 * 1e3,
                    "p95_ms": None if p95 is None else p95 * 1e3,
                    "p99_ms": None if p99 is None else p99 * 1e3,
                }
                per_class[cls] = entry
                if entry["goodput"] is not None:
                    self._tel.gauge("serving.slo.goodput_%s" % cls).set(
                        entry["goodput"])
                if entry["p99_ms"] is not None:
                    self._tel.gauge("serving.slo.p99_ms_%s" % cls).set(
                        entry["p99_ms"])
                target = self.targets.get(cls)
                if target is None or attempts < target.min_requests:
                    continue
                checks = (("goodput", entry["goodput"], target.goodput,
                           lambda obs, lim: obs < lim),
                          ("p95_ms", entry["p95_ms"], target.p95_ms,
                           lambda obs, lim: obs > lim),
                          ("p99_ms", entry["p99_ms"], target.p99_ms,
                           lambda obs, lim: obs > lim))
                for kind, observed, limit, breach in checks:
                    if limit is None or observed is None:
                        continue
                    if breach(observed, limit):
                        new_alerts.append(SLOAlert(
                            now, cls, kind, observed, limit, window_s,
                            attempts))
            depth, backlog, rate = self._backlog()
            desired = self.desired_replicas(depth, backlog, rate,
                                            breached=bool(new_alerts))
            self._tel.gauge(
                "serving.autoscale.desired_replicas").set(desired)
            self.evaluations += 1
        for alert in new_alerts:
            self.alerts.append(alert)
            self._tel.counter("serving.slo.alerts").inc()
            if self._tel.recording:
                self._tel.emit(alert.as_record())
            if self._on_alert is not None:
                try:
                    self._on_alert(alert)
                except Exception:
                    pass   # a broken alert hook must not stop monitoring
        return {"window_s": window_s, "per_class": per_class,
                "alerts": new_alerts, "desired_replicas": desired,
                "queue_depth": depth, "service_rate": rate}

    # -- background loop -----------------------------------------------------
    def start(self, interval_s=None):
        """Evaluate every ``interval_s`` (default: ``window_s``) on a
        daemon thread until :meth:`stop`."""
        if self._thread is not None and self._thread.is_alive():
            return self
        period = self.window_s if interval_s is None else float(interval_s)
        self._stop_evt.clear()

        def loop():
            while not self._stop_evt.wait(period):
                try:
                    self.evaluate()
                except Exception:
                    pass   # monitoring must outlive a flaky health probe

        self._thread = threading.Thread(
            target=loop, name="paddle-tpu-slo-monitor", daemon=True)
        self._thread.start()
        return self

    @property
    def running(self):
        return self._thread is not None and self._thread.is_alive()

    def stop(self, timeout=2.0):
        self._stop_evt.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout)
        self._thread = None
