"""Pluggable telemetry sinks (a copy of the JAX package's, for the port).

A sink receives structured step records (``emit``) and, if it declares
``wants_spans``, host-side trace spans (``emit_span``).  All sinks are
thread-safe: the async device-feed pipeline publishes spans from its
transfer thread(s) while the step loop emits records.

- :class:`JsonlSink` — one JSON object per line, the machine-readable
  training log (schema: ``observability.STEP_SCHEMA``).
- :class:`RingBufferSink` — bounded in-memory record/span buffer for
  tests and interactive inspection.
- :class:`StdoutSummarySink` — periodic one-line progress summary
  (steps/s, counters) instead of per-step spam.
- :class:`ChromeTraceSink` — Chrome ``trace_event`` JSON: host spans laid
  out per thread, loadable in Perfetto (or chrome://tracing), so
  feed/compute overlap is visible.
"""
from __future__ import annotations

import atexit
import collections
import json
import os
import sys
import threading
import time
import weakref

__all__ = [
    "Sink",
    "JsonlSink",
    "RingBufferSink",
    "StdoutSummarySink",
    "ChromeTraceSink",
    "print_report",
]


def print_report(text, stream=None):
    """Write a human-readable report to stdout UNLESS telemetry is
    disabled (``PADDLE_TPU_TELEMETRY=0``) — the quiet path the profiler's
    implicit ``stop_profiler()`` report goes through, so a pytest run or
    a batch job can silence it without plumbing a flag."""
    from .registry import get_telemetry

    if not get_telemetry().enabled:
        return False
    (stream or sys.stdout).write(text if text.endswith("\n") else text + "\n")
    return True


class Sink:
    """Base sink: override ``emit`` (records) and/or ``emit_span``."""

    wants_records = True
    wants_spans = False

    def emit(self, record):
        raise NotImplementedError

    def emit_span(self, name, ts, dur, thread, tags):  # pragma: no cover
        pass

    def flush(self):
        pass

    def close(self):
        self.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# Every open JsonlSink, weakly held: an interpreter exiting mid-run
# (batch job killed by its scheduler, notebook restart) must not lose
# the buffered tail of a long serving log.  atexit flushes — it does
# not close, because teardown-ordered emitters may still be writing.
_LIVE_JSONL = weakref.WeakSet()


@atexit.register
def _flush_jsonl_sinks_at_exit():
    for sink in list(_LIVE_JSONL):
        try:
            sink.flush()
        except Exception:
            pass


class JsonlSink(Sink):
    """Append one JSON object per record to ``path``.

    Values that are not JSON-native (numpy scalars, device arrays handed
    in as metrics) are coerced via ``float``/``str`` fallback — a record
    must never raise out of the training loop.  Writes ride Python's
    buffered file object; ``flush()``/``close()`` make them durable, and
    every live sink is flushed once more at interpreter exit.

    ``max_bytes`` enables size-based rotation: when the current file
    grows past it, it is renamed to ``path.1`` (shifting ``path.1`` ->
    ``path.2`` ... up to ``max_files`` rotated files, oldest dropped)
    and a fresh file is opened — a long serving run keeps a bounded
    window of telemetry instead of one unbounded file.  Rotation happens
    at a record boundary, so every file is independently parseable.

    ``spans=True`` additionally subscribes the sink to trace spans,
    written as ``{"type": "span", name, ts, dur, thread, tags}`` lines —
    the offline half of request-scoped tracing
    (:mod:`~paddle_tpu_torch.observability.tracing`)."""

    def __init__(self, path, max_bytes=None, max_files=5, spans=False):
        self.path = path
        self.max_bytes = None if max_bytes is None else int(max_bytes)
        self.max_files = max(1, int(max_files))
        self.wants_spans = bool(spans)
        self._lock = threading.Lock()
        self._f = open(path, "a", buffering=1024 * 64)
        self._written = self._f.tell()   # "a" mode: position == size
        self._next_rotate_at = self.max_bytes
        self.emitted = 0
        self.rotations = 0
        _LIVE_JSONL.add(self)

    @staticmethod
    def _default(obj):
        try:
            return float(obj)
        except (TypeError, ValueError):
            return str(obj)

    def _write_locked(self, line):
        if self._f is None:
            return
        self._f.write(line + "\n")
        self._written += len(line) + 1
        self.emitted += 1
        if self.max_bytes is not None and self._written >= self._next_rotate_at:
            self._rotate_locked()

    def _rotate_locked(self):
        self._f.flush()
        self._f.close()
        try:
            for i in range(self.max_files - 1, 0, -1):
                src = "%s.%d" % (self.path, i)
                if os.path.exists(src):
                    os.replace(src, "%s.%d" % (self.path, i + 1))
            os.replace(self.path, self.path + ".1")
            rotated = True
        except OSError:
            # rotation is best-effort (read-only dir race, NFS quirks):
            # keep appending to the current file rather than losing data
            rotated = False
        self._f = open(self.path, "a", buffering=1024 * 64)
        self._written = self._f.tell()
        if rotated:
            self.rotations += 1
            self._next_rotate_at = self.max_bytes
        else:
            # back off: retry after ANOTHER max_bytes accumulates, not
            # on every record — a denied rename must not turn the
            # logging path into per-record close/rename/reopen churn
            self._next_rotate_at = self._written + self.max_bytes

    def emit(self, record):
        line = json.dumps(record, default=self._default,
                          separators=(",", ":"))
        with self._lock:
            self._write_locked(line)

    def emit_span(self, name, ts, dur, thread, tags):
        line = json.dumps(
            {"type": "span", "name": name, "ts": ts, "dur": dur,
             "thread": thread.name, "tags": tags},
            default=self._default, separators=(",", ":"))
        with self._lock:
            self._write_locked(line)

    def flush(self):
        with self._lock:
            if self._f is not None:
                self._f.flush()

    def close(self):
        with self._lock:
            if self._f is not None:
                self._f.flush()
                self._f.close()
                self._f = None


class RingBufferSink(Sink):
    """Keep the newest ``capacity`` records (and spans, when asked) in
    memory — the test/debug sink."""

    def __init__(self, capacity=4096, record_spans=False):
        self._records = collections.deque(maxlen=capacity)
        self._spans = collections.deque(maxlen=capacity)
        self._record_spans = bool(record_spans)
        # only a record_spans=True instance opts the hot-path span sites
        # out of their no-op context; a default sink must not make every
        # span allocate+timestamp just to be dropped at emit_span
        self.wants_spans = self._record_spans
        self._lock = threading.Lock()

    def emit(self, record):
        with self._lock:
            self._records.append(record)

    def emit_span(self, name, ts, dur, thread, tags):
        with self._lock:
            self._spans.append(
                {"name": name, "ts": ts, "dur": dur,
                 "thread": thread.name, "tags": tags})

    @property
    def records(self):
        with self._lock:
            return list(self._records)

    @property
    def spans(self):
        with self._lock:
            return list(self._spans)

    def clear(self):
        with self._lock:
            self._records.clear()
            self._spans.clear()


class StdoutSummarySink(Sink):
    """One summary line every ``interval`` seconds (or every ``every_n``
    records): mean steps/s over the window plus the newest cumulative
    counters.  Quiet under ``PADDLE_TPU_TELEMETRY=0`` like everything
    else (the sink only ever sees records when telemetry is enabled)."""

    def __init__(self, interval=10.0, every_n=None, stream=None):
        self.interval = float(interval)
        self.every_n = every_n
        self.stream = stream or sys.stdout
        self._lock = threading.Lock()
        self._window = []
        self._last_flush = time.time()

    def emit(self, record):
        if record.get("type") != "step":
            return
        with self._lock:
            self._window.append(record)
            due = (len(self._window) >= self.every_n if self.every_n
                   else time.time() - self._last_flush >= self.interval)
            if due:
                self._flush_window()

    def _flush_window(self):
        # caller holds the lock
        window, self._window = self._window, []
        self._last_flush = time.time()
        if not window:
            return
        last = window[-1]
        rates = [r["steps_per_s"] for r in window
                 if isinstance(r.get("steps_per_s"), (int, float))]
        mean = sum(rates) / len(rates) if rates else float("nan")
        parts = [
            "[telemetry] %s step %s" % (last.get("source", "?"),
                                        last.get("step", "?")),
            "%.1f steps/s (n=%d)" % (mean, len(window)),
            "feed_copies=%s" % last.get("feed_host_copies"),
            "transfers=%s" % last.get("prefetch_transfers"),
        ]
        if last.get("nan_ok") is not None:
            parts.append("nan_ok=%s" % last["nan_ok"])
        if last.get("rewinds"):
            parts.append("rewinds=%s" % last["rewinds"])
        self.stream.write("  ".join(parts) + "\n")

    def flush(self):
        with self._lock:
            self._flush_window()


class ChromeTraceSink(Sink):
    """Collect host spans (and step instants) as Chrome ``trace_event``
    JSON.  ``close()`` writes ``{"traceEvents": [...]}`` to ``path`` —
    load it in https://ui.perfetto.dev (or chrome://tracing).

    Each Python thread gets its own trace ``tid`` with a ``thread_name``
    metadata event, so the device-feed pipeline's conversion/transfer
    spans (``paddle-tpu-device-prefetch`` threads) sit on separate tracks
    from the main thread's dispatch/fetch spans — overlap is the gap you
    can SEE.  Timestamps are microseconds of wall-clock time
    (``time.time``)."""

    wants_spans = True

    def __init__(self, path, pid=0, record_steps=True):
        self.path = path
        self.pid = pid
        self.record_steps = record_steps
        self._lock = threading.Lock()
        self._events = []
        self._tids = {}          # ident -> (thread object, tid)
        self._n_tids = 0
        self._closed = False

    def _tid(self, thread):
        entry = self._tids.get(thread.ident)
        if entry is not None and entry[0] is thread:
            return entry[1]
        # first sighting — or an IDENT REUSE: the OS recycles thread ids
        # once a thread exits, so a fresh thread (say a restarted serving
        # worker) can reappear under a dead thread's ident.  It must get
        # its own track and name, not inherit the dead thread's slices.
        self._n_tids += 1
        tid = self._n_tids
        self._tids[thread.ident] = (thread, tid)
        self._events.append({
            "name": "thread_name", "ph": "M", "pid": self.pid,
            "tid": tid, "args": {"name": thread.name},
        })
        return tid

    def emit_span(self, name, ts, dur, thread, tags):
        with self._lock:
            if self._closed:
                return
            ev = {
                "name": name, "ph": "X", "pid": self.pid,
                "tid": self._tid(thread),
                "ts": ts * 1e6, "dur": max(dur, 1e-7) * 1e6,
            }
            if tags:
                ev["args"] = {k: str(v) for k, v in tags.items()}
            self._events.append(ev)

    def emit(self, record):
        if not self.record_steps or record.get("type") != "step":
            return
        with self._lock:
            if self._closed:
                return
            self._events.append({
                "name": "%s step %s" % (record.get("source", "step"),
                                        record.get("step", "?")),
                "ph": "i", "s": "t", "pid": self.pid,
                "tid": self._tid(threading.current_thread()),
                "ts": record.get("ts", time.time()) * 1e6,
                "args": {"steps_per_s": record.get("steps_per_s")},
            })

    @property
    def events(self):
        with self._lock:
            return list(self._events)

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
            events = self._events
        with open(self.path, "w") as f:
            json.dump({"traceEvents": events,
                       "displayTimeUnit": "ms"}, f)
