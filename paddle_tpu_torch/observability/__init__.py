"""Telemetry for the port: counters, gauges, timers, histograms, spans,
sinks, the Prometheus export and the SLO monitor.

A copy of the framework-agnostic part of the JAX package's
observability plane — the registry (:mod:`.registry`), log-bucketed
latency histograms (:mod:`.histogram`), request trace contexts
(:mod:`.tracing`), the sinks (:mod:`.sinks`: JSONL, ring buffer, stdout
summary, Chrome trace), the live ``/metrics`` + ``/healthz`` endpoint
(:mod:`.export`) and the SLO monitor (:mod:`.slo`) — so the port's
runtime reports under the same names and a scrape of either package
parses the same way.  Compute introspection: :mod:`.xla_stats` counts a
step's FLOPs, bytes and memory in one eager run under a dispatch mode
(the port has no compiler's cost analysis to read) and publishes the
``compute.*`` gauges, MFU among them, from the step's device time;
:class:`StepAttribution` (:mod:`.attribution`) is a sink that splits
step wall into input, compute, compile and fetch and calls each window
input-bound or compute-bound.

``PADDLE_TPU_TELEMETRY=0`` is the killswitch for records and spans;
counters always count.

Usage::

    from paddle_tpu_torch import observability as obs

    sink = obs.JsonlSink("telemetry.jsonl")
    obs.add_sink(sink)
    trainer.train(...)          # step records stream to the file
    sink.close()
"""
from __future__ import annotations

from .export import (
    MetricsServer,
    parse_prometheus,
    prometheus_name,
    render_prometheus,
)
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
from .sinks import (
    ChromeTraceSink,
    JsonlSink,
    RingBufferSink,
    Sink,
    StdoutSummarySink,
    print_report,
)
from .slo import SLOAlert, SLOMonitor, SLOTarget
from . import xla_stats
from .attribution import PHASE_OF_SPAN, VERDICT_CODE, StepAttribution
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
    "Sink",
    "JsonlSink",
    "RingBufferSink",
    "StdoutSummarySink",
    "ChromeTraceSink",
    "print_report",
    "STEP_SCHEMA",
    "TraceContext",
    "new_trace",
    "build_trace_tree",
    "MetricsServer",
    "render_prometheus",
    "prometheus_name",
    "parse_prometheus",
    "SLOMonitor",
    "SLOTarget",
    "SLOAlert",
    "xla_stats",
    "StepAttribution",
    "PHASE_OF_SPAN",
    "VERDICT_CODE",
]

# The JAX package's step-record schema, which the port's records follow.
# ``tools/check_observability_torch.py`` validates JSONL sink output
# against it; keys marked required are in every trainer step record.
STEP_SCHEMA = {
    "required": [
        "type",            # "step"
        "ts",              # wall-clock seconds (time.time)
        "source",          # "trainer" | "executor"
        "run_id",          # opaque id tying one loop's records together
        "program",         # program tag ("<id-hex>:v<version>")
        "step",            # 0-based step index within the source's run
        "duration_s",      # wall seconds of this step
        "steps_per_s",     # 1 / duration_s
        "feed_host_copies",    # cumulative executor.feed_host_copy counter
        "prefetch_transfers",  # cumulative prefetch.transfer counter
        "nan_ok",          # True/False guard verdict, None when unguarded
    ],
    "optional": [
        "phase",           # trainer records: "train" | "test"
        "epoch",           # trainer records only
        "compile",         # True when this run built+compiled a fresh entry
        "fast_path",       # executor records: bound fast path replayed
        "nan_guard",       # guard armed for this step
        "retries",         # cumulative resilience.retry counter
        "rewinds",         # cumulative trainer nan_rewinds
        "checkpoint_save_s",  # duration, present on checkpoint steps
        "checkpoint_load_s",  # duration, present after a rewind/resume
        "metrics",         # fetched scalar metrics when cheaply available
        "mfu",             # model flops utilization when xla_stats is armed
    ],
}
