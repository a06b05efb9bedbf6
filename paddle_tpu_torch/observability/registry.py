"""Telemetry registry: named counters / gauges / timers + span/record fanout.

Design constraints (see docs/observability.md for the measured numbers):

- **Counters always count.**  They back load-bearing public accessors
  (``feed_host_copy_count``, ``transfer_count``) whose values are part of
  tested contracts — toggling telemetry must never change them.  An
  increment is one lock acquire + int add (~100ns), paid identically on
  and off.
- **Everything else is gated.**  Spans and step records cost one
  attribute read when disabled or sink-less: the hot paths check
  ``telemetry.recording`` / call ``span()`` which returns a shared no-op
  context manager.  ``PADDLE_TPU_TELEMETRY=0`` forces the quiet path.
- **Thread-safe.**  The async device-feed pipeline publishes counters
  and spans from its transfer thread(s); every mutable structure here is
  lock-protected.  Metric objects are created once and mutated in place,
  so a module that cached ``counter("x")`` and the registry's own lookup
  always observe the same cell — ``reset()`` zeroes in place instead of
  replacing objects.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time

from .histogram import Histogram

__all__ = [
    "Counter",
    "Gauge",
    "Timer",
    "Histogram",
    "histogram",
    "labeled_name",
    "split_labels",
    "Telemetry",
    "get_telemetry",
    "enabled",
    "counter",
    "gauge",
    "timer",
    "inc",
    "observe",
    "span",
    "record_span",
    "timed",
    "observe_span",
    "emit",
    "reset",
    "add_sink",
    "remove_sink",
]


def _env_enabled():
    return os.environ.get("PADDLE_TPU_TELEMETRY", "1") != "0"


def _safe_label_value(value):
    """Label values land verbatim inside ``name{k="v"}`` registry keys
    (and from there in the Prometheus exposition), so characters that
    would break the sample grammar — quotes, backslashes, newlines —
    are replaced instead of escaped: the strict parser we gate the
    exposition with reads no escape sequences."""
    s = str(value)
    return "".join(c if (c.isalnum() or c in "_.:/-@ ") else "_" for c in s)


def labeled_name(name, labels=None):
    """Canonical registry key for a labeled metric cell:
    ``name{k="v",...}`` with keys sorted, or ``name`` unchanged when
    ``labels`` is empty/None.  The same (name, labels) pair always maps
    to the same key, so cached handles and registry lookups agree."""
    if not labels:
        return name
    parts = ['%s="%s"' % (k, _safe_label_value(labels[k]))
             for k in sorted(labels)]
    return "%s{%s}" % (name, ",".join(parts))


def split_labels(key):
    """Inverse of :func:`labeled_name` as far as rendering needs:
    ``(base_name, label_suffix)`` where the suffix is ``""`` or the
    verbatim ``{k="v",...}`` part.  The exporter groups cells into one
    Prometheus family per base name with this."""
    i = key.find("{")
    if i < 0:
        return key, ""
    return key[:i], key[i:]


class Counter:
    """Monotonic named count; ``inc`` is safe from any thread."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n=1):
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def _reset(self):
        with self._lock:
            self._value = 0

    def __repr__(self):
        return "Counter(%r, %d)" % (self.name, self._value)


class Gauge:
    """Last-written named value (e.g. queue depth, steps/s)."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name):
        self.name = name
        self._value = None
        self._lock = threading.Lock()

    def set(self, value):
        with self._lock:
            self._value = value

    @property
    def value(self):
        return self._value

    def _reset(self):
        with self._lock:
            self._value = None

    def __repr__(self):
        return "Gauge(%r, %r)" % (self.name, self._value)


class Timer:
    """Named duration aggregate with the reference profiler's report
    stats (calls / total / avg / min / max).  Running aggregates, not a
    sample list: a timer on an always-on path (checkpoint IO) must hold
    O(1) memory over an arbitrarily long training job.  Updates happen
    under a lock so report formatting never races a recording thread."""

    __slots__ = ("name", "_count", "_total", "_min", "_max", "_lock")

    def __init__(self, name):
        self.name = name
        self._count = 0
        self._total = 0.0
        self._min = None
        self._max = None
        self._lock = threading.Lock()

    def observe(self, seconds):
        s = float(seconds)
        with self._lock:
            self._count += 1
            self._total += s
            if self._min is None or s < self._min:
                self._min = s
            if self._max is None or s > self._max:
                self._max = s

    @contextlib.contextmanager
    def time(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(time.perf_counter() - t0)

    @property
    def count(self):
        return self._count

    @property
    def total(self):
        return self._total

    def stats(self):
        """(calls, total, avg, min, max) or None when empty."""
        with self._lock:
            if not self._count:
                return None
            return (self._count, self._total, self._total / self._count,
                    self._min, self._max)

    def _reset(self):
        with self._lock:
            self._count = 0
            self._total = 0.0
            self._min = None
            self._max = None

    def __repr__(self):
        return "Timer(%r, n=%d)" % (self.name, self._count)


class _NullContext:
    """Shared no-op context manager: the disabled span path allocates
    nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CONTEXT = _NullContext()


class _Span:
    __slots__ = ("_telemetry", "_name", "_tags", "_t0", "_wall0")

    def __init__(self, telemetry, name, tags):
        self._telemetry = telemetry
        self._name = name
        self._tags = tags

    def __enter__(self):
        self._wall0 = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        self._telemetry._emit_span(
            self._name, self._wall0, dur, threading.current_thread(),
            self._tags)
        return False


class Telemetry:
    """Registry + sink fanout.  One process-wide instance
    (:func:`get_telemetry`) serves the whole runtime; tests may build
    private instances."""

    def __init__(self, enabled=None):
        self._enabled = _env_enabled() if enabled is None else bool(enabled)
        self._lock = threading.Lock()       # registry structure
        self._sink_lock = threading.Lock()  # sink list + fanout
        self._counters = {}
        self._gauges = {}
        self._timers = {}
        self._histograms = {}
        self._sinks = []
        # precomputed fast-path flags: one attribute read on the hot path
        self.recording = False      # enabled and >=1 sink takes records
        # a record sink wants the device time of steps in their records
        # (``execute_s``): StepAttribution
        self.device_timing = False
        self._span_sinks = ()       # sinks that take spans
        self._record_sinks = ()     # sinks that take records

    # -- enablement ----------------------------------------------------------
    @property
    def enabled(self):
        return self._enabled

    def configure(self, enabled=None):
        """Override the env-derived enablement (None = re-read the env)."""
        with self._sink_lock:  # _refresh_flags races add/remove otherwise
            self._enabled = _env_enabled() if enabled is None else bool(enabled)
            self._refresh_flags()
        return self._enabled

    def _refresh_flags(self):
        sinks = tuple(self._sinks) if self._enabled else ()
        self._span_sinks = tuple(
            s for s in sinks if getattr(s, "wants_spans", False))
        self._record_sinks = tuple(
            s for s in sinks if getattr(s, "wants_records", True))
        self.recording = bool(self._record_sinks)
        self.device_timing = any(getattr(s, "wants_device_time", False)
                                 for s in self._record_sinks)

    # -- metrics -------------------------------------------------------------
    # ``labels`` (a {key: value} dict) keys a DISTINCT cell per label
    # combination under one logical family: the registry key is
    # ``labeled_name(name, labels)``, reset(prefix=name) still matches
    # every labeled cell (the key starts with the base name), and the
    # exporter regroups the cells into one Prometheus family with
    # per-sample label suffixes.  Unlabeled and labeled cells of the
    # same name coexist (the unlabeled one is the cross-label
    # aggregate the SLO monitor windows over).
    def counter(self, name, labels=None) -> Counter:
        name = labeled_name(name, labels)
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name, labels=None) -> Gauge:
        name = labeled_name(name, labels)
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def timer(self, name, labels=None) -> Timer:
        name = labeled_name(name, labels)
        t = self._timers.get(name)
        if t is None:
            with self._lock:
                t = self._timers.setdefault(name, Timer(name))
        return t

    def histogram(self, name, labels=None) -> Histogram:
        name = labeled_name(name, labels)
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name, Histogram(name))
        return h

    def inc(self, name, n=1):
        self.counter(name).inc(n)

    def observe(self, name, seconds):
        self.timer(name).observe(seconds)

    def counters(self):
        with self._lock:
            return dict(self._counters)

    def gauges(self):
        with self._lock:
            return dict(self._gauges)

    def timers(self):
        with self._lock:
            return dict(self._timers)

    def histograms(self):
        with self._lock:
            return dict(self._histograms)

    def reset(self, prefix=None):
        """Zero metrics IN PLACE (cached handles stay valid).  With a
        ``prefix``, only matching names reset — ``reset_profiler`` clears
        the profiler namespace without touching e.g. the executor's
        feed-copy contract counter."""
        with self._lock:
            groups = (self._counters, self._gauges, self._timers,
                      self._histograms)
        for group in groups:
            for name, metric in list(group.items()):
                if prefix is None or name.startswith(prefix):
                    metric._reset()

    # -- sinks ---------------------------------------------------------------
    def add_sink(self, sink):
        with self._sink_lock:
            if sink not in self._sinks:
                self._sinks.append(sink)
            self._refresh_flags()
        return sink

    def remove_sink(self, sink):
        with self._sink_lock:
            if sink in self._sinks:
                self._sinks.remove(sink)
            self._refresh_flags()

    def sinks(self):
        with self._sink_lock:
            return list(self._sinks)

    # -- records / spans -----------------------------------------------------
    def emit(self, record):
        """Fan a structured record out to every record sink.  Callers gate
        on ``self.recording`` so the disabled path never builds the dict;
        the sink tuple is precomputed by add/remove_sink so the hot path
        takes no lock."""
        for s in self._record_sinks:
            try:
                s.emit(record)
            except Exception:
                # a broken sink (full disk, closed file) must never
                # take the training loop down with it
                pass

    def span(self, name, **tags):
        """Context manager recording a (ts, duration, thread) trace span.
        Returns a shared no-op when no span sink is attached — the
        disabled path is one tuple truthiness check."""
        if not self._span_sinks:
            return _NULL_CONTEXT
        return _Span(self, name, tags)

    def span_active(self):
        return bool(self._span_sinks)

    def record_span(self, name, ts, dur, tags=None, thread=None):
        """Emit an already-measured span (``ts`` = wall-clock start
        seconds, ``dur`` seconds) — for call sites that time themselves
        and only want the trace event, without a context manager."""
        if not self._span_sinks:
            return
        self._emit_span(name, ts, dur,
                        thread or threading.current_thread(), tags or {})

    @contextlib.contextmanager
    def timed(self, name, **tags):
        """Time a block onto the ``name`` timer AND (when a trace sink is
        attached) emit the matching span — the one primitive behind the
        instrumented IO paths, so timer and span names can't drift."""
        wall0 = time.time()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe_span(name, wall0, t0, tags)

    def observe_span(self, name, wall0, t0, tags=None):
        """The tail half of :meth:`timed` for hand-timed sites whose
        control flow doesn't fit a with-block (multi-exit loops):
        observe ``perf_counter() - t0`` on the ``name`` timer and emit
        the span starting at wall-clock ``wall0``.  Returns the
        duration."""
        dur = time.perf_counter() - t0
        self.timer(name).observe(dur)
        if self._span_sinks:
            self._emit_span(name, wall0, dur,
                            threading.current_thread(), tags or {})
        return dur

    def _emit_span(self, name, ts, dur, thread, tags):
        for s in self._span_sinks:
            try:
                s.emit_span(name, ts, dur, thread, tags)
            except Exception:
                pass


_global = Telemetry()


def get_telemetry() -> Telemetry:
    return _global


def enabled():
    return _global.enabled


def counter(name, labels=None) -> Counter:
    return _global.counter(name, labels)


def gauge(name, labels=None) -> Gauge:
    return _global.gauge(name, labels)


def timer(name, labels=None) -> Timer:
    return _global.timer(name, labels)


def histogram(name, labels=None) -> Histogram:
    return _global.histogram(name, labels)


def inc(name, n=1):
    _global.inc(name, n)


def observe(name, seconds):
    _global.observe(name, seconds)


def span(name, **tags):
    return _global.span(name, **tags)


def record_span(name, ts, dur, tags=None, thread=None):
    _global.record_span(name, ts, dur, tags, thread)


def timed(name, **tags):
    return _global.timed(name, **tags)


def observe_span(name, wall0, t0, tags=None):
    return _global.observe_span(name, wall0, t0, tags)


def emit(record):
    _global.emit(record)


def reset(prefix=None):
    _global.reset(prefix)


def add_sink(sink):
    return _global.add_sink(sink)


def remove_sink(sink):
    _global.remove_sink(sink)
