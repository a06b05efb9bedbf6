"""Telemetry for the port: counters, gauges, timers, histograms, spans.

A copy of the framework-agnostic core of the JAX package's
observability plane — the registry (:mod:`.registry`), log-bucketed
latency histograms (:mod:`.histogram`) and request trace contexts
(:mod:`.tracing`) — so the port's serving runtime reports under the
same ``serving.decode.*`` names.  Sinks, the Prometheus export, the SLO
monitor and the compiler-statistics capture are not ported yet.

``PADDLE_TPU_TELEMETRY=0`` is the killswitch for records and spans;
counters always count.
"""
from __future__ import annotations

from .histogram import Histogram, HistogramSnapshot, default_bounds
from .registry import (
    Counter,
    Gauge,
    Telemetry,
    Timer,
    add_sink,
    counter,
    emit,
    enabled,
    gauge,
    get_telemetry,
    histogram,
    inc,
    labeled_name,
    observe,
    observe_span,
    record_span,
    remove_sink,
    reset,
    span,
    split_labels,
    timed,
    timer,
)
from .tracing import TraceContext, build_trace_tree, new_trace

__all__ = [
    "Telemetry",
    "Counter",
    "Gauge",
    "Timer",
    "Histogram",
    "HistogramSnapshot",
    "default_bounds",
    "get_telemetry",
    "enabled",
    "counter",
    "gauge",
    "timer",
    "histogram",
    "labeled_name",
    "split_labels",
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
    "TraceContext",
    "new_trace",
    "build_trace_tree",
]
