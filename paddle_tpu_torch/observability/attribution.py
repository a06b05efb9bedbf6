"""Step-time attribution: where did each training or serving step's wall
go?  The port's copy of the JAX package's ``StepAttribution``.

The executor and the input pipeline already emit what this needs: the
prepare-feed / dispatch / compile / fetch spans, step records with
``execute_s``, the prefetcher's consumer-wait span and its
buffer-occupancy gauge.  :class:`StepAttribution` is a telemetry SINK
that folds those streams into a decomposition a window:

    wall = input (prefetch wait + feed conversion)
         + compute (dispatch/execute)
         + compile + fetch + other

and calls each window **input-bound** (the loop starves waiting for
batches) or **compute-bound** (the buffer stays full, execution
dominates).

On the card a bound step is a CUDA graph replay: its dispatch span
covers the enqueue, not the step, and the host's wait for the device
lands later (in ``executor.fetch_materialize``, or wherever the loop
reads a value).  So this sink asks for device time
(``wants_device_time``): while it is attached, the executor's step
records carry in ``execute_s`` the device time of the steps that
finished since the previous record, read from CUDA events without a
synchronization, and ``compute_s`` is the larger of that sum and the
dispatch spans', as in the JAX package.  The verdict compares input
with compute only, so a graphed loop whose device is the bottleneck is
compute-bound even though its host waits in a fetch.  A loop that never
waits for its device (no value read a step) finishes its windows before
the device finishes their steps; their device time then lands in later
windows.
A window's ``wall_s`` is the time from its open to its close (the sum
of its records' durations where that is larger, as for records fed by
hand), not the records' sum alone, which on the card is the host's
enqueue of replays.

Being a sink keeps the cost honest: attaching one arms the span
machinery as a ChromeTraceSink would; detached, the hot paths pay
nothing.  All accumulation happens on the emitting thread under one
lock: spans arrive from the step loop and the prefetcher's producer
thread.

Usage::

    att = obs.StepAttribution(window_steps=50)
    trainer.train(..., attribution=att)   # or att.attach() ... detach()
    print(att.report())
    att.verdict()["verdict"]      # "input-bound" | "compute-bound" | ...

Windows close every ``window_steps`` step records (and at ``verdict()``
/ ``detach()`` for the trailing partial window); each close publishes
``compute.step.*`` gauges and, when a record sink is attached, emits
one ``{"type": "attribution", ...}`` record.
"""
from __future__ import annotations

import threading
import time

from . import registry as _reg

__all__ = ["StepAttribution", "PHASE_OF_SPAN", "VERDICT_CODE"]

# span name -> attribution phase.  "input" is time the STEP LOOP spent
# producing/waiting on feed data; "compute" is the dispatch+execute leg;
# producer-thread spans (prefetch.convert_transfer) are tracked separately
# because they overlap compute and must not be double-counted into wall.
PHASE_OF_SPAN = {
    "prefetch.wait": "input",
    "executor.prepare_feed": "input",
    "executor.dispatch": "compute",
    "executor.compile": "compile",
    "executor.fetch_materialize": "fetch",
    "prefetch.convert_transfer": "producer",
}

_PHASES = ("input", "compute", "compile", "fetch", "producer")

# numeric spelling of the verdict for the exposition plane (string
# gauges are skipped by render_prometheus; the repo convention is a
# numeric code gauge next to the string, as with serving.breaker_state)
VERDICT_CODE = {"idle": 0, "balanced": 1, "input-bound": 2,
                "compute-bound": 3}


class StepAttribution:
    """Telemetry sink decomposing step wall time into phases and issuing
    an input-bound / compute-bound verdict per window.

    Parameters
    ----------
    window_steps: close a window every N step records (None = only on
        explicit :meth:`verdict` / :meth:`detach`).
    telemetry: registry to attach to (default: the process-wide one).
    bound_ratio: how lopsided input vs compute must be before the window
        is called bound one way (default 1.2: input > 1.2x compute =>
        input-bound, compute > 1.2x input => compute-bound, else
        "balanced").  Occupancy breaks balanced ties when the buffer is
        decisively empty (<25% full => input-bound) or full (>75% =>
        compute-bound).
    """

    wants_spans = True
    wants_records = True
    wants_device_time = True

    def __init__(self, window_steps=None, telemetry=None, bound_ratio=1.2):
        self.window_steps = int(window_steps) if window_steps else None
        self.bound_ratio = float(bound_ratio)
        self._tel = telemetry
        self._lock = threading.Lock()
        self._windows = []          # closed-window verdict dicts
        self._reset_window_locked()

    def _reset_window_locked(self):
        self._phase_s = dict.fromkeys(_PHASES, 0.0)
        self._phase_n = dict.fromkeys(_PHASES, 0)
        self._steps = 0
        self._wall_s = 0.0
        self._execute_s = 0.0       # from step records (subset of compute)
        self._occ_sum = 0.0
        self._occ_n = 0
        self._t_open = time.time()

    # -- wiring --------------------------------------------------------------
    def _telemetry(self):
        if self._tel is not None:
            return self._tel
        return _reg.get_telemetry()

    def attach(self):
        with self._lock:
            self._t_open = time.time()
        self._telemetry().add_sink(self)
        return self

    def detach(self):
        """Remove the sink and close the trailing partial window."""
        self._telemetry().remove_sink(self)
        with self._lock:
            if self._steps:
                self._close_window_locked()
        return self

    def __enter__(self):
        return self.attach()

    def __exit__(self, *exc):
        self.detach()
        return False

    # -- sink protocol -------------------------------------------------------
    def emit_span(self, name, ts, dur, thread, tags):
        phase = PHASE_OF_SPAN.get(name)
        if phase is None:
            return
        with self._lock:
            self._phase_s[phase] += dur
            self._phase_n[phase] += 1

    def emit(self, record):
        if record.get("type") != "step":
            return
        if record.get("source") == "trainer":
            # a Trainer loop emits BOTH trainer and executor records per
            # step; counting both would double every step.  The executor
            # record is the one that exists in every loop shape (bare
            # executor, trainer, serving), so it is the unit of count.
            return
        occ = self._telemetry().gauge("prefetch.buffer_occupancy").value
        with self._lock:
            self._steps += 1
            self._wall_s += record.get("duration_s") or 0.0
            ex = record.get("execute_s")
            if ex and not record.get("compile"):
                # a capture's "execute" is the capture; the compile span
                # already accounts for it
                self._execute_s += ex
            if isinstance(occ, (int, float)):
                self._occ_sum += occ
                self._occ_n += 1
            if self.window_steps and self._steps >= self.window_steps:
                self._close_window_locked()

    # -- verdicts ------------------------------------------------------------
    def _classify(self, input_s, compute_s, occ_frac):
        if input_s <= 0 and compute_s <= 0:
            return "idle"
        if input_s > self.bound_ratio * compute_s:
            return "input-bound"
        if compute_s > self.bound_ratio * input_s:
            return "compute-bound"
        if occ_frac is not None:
            if occ_frac < 0.25:
                return "input-bound"
            if occ_frac > 0.75:
                return "compute-bound"
        return "balanced"

    def _close_window_locked(self):
        tel = self._telemetry()
        cap = tel.gauge("prefetch.buffer_capacity").value
        occ_mean = (self._occ_sum / self._occ_n) if self._occ_n else None
        occ_frac = None
        if occ_mean is not None and isinstance(cap, (int, float)) and cap > 0:
            occ_frac = occ_mean / cap
        input_s = self._phase_s["input"]
        compute_s = max(self._phase_s["compute"], self._execute_s)
        verdict = self._classify(input_s, compute_s, occ_frac)
        # the window's wall: the time from its open (attach, or the last
        # close) to now, or its records' durations where they add up to
        # more (records fed without a clock).  Their sum alone would be
        # the host's dispatch of replays that the device runs later
        now = time.time()
        wall = max(self._wall_s, now - self._t_open)
        w = {
            "type": "attribution",
            "ts": now,
            "window_start_ts": self._t_open,
            "steps": self._steps,
            "wall_s": wall,
            "input_s": input_s,
            "compute_s": compute_s,
            "compile_s": self._phase_s["compile"],
            "fetch_s": self._phase_s["fetch"],
            "producer_s": self._phase_s["producer"],
            "input_fraction": (input_s / wall) if wall > 0 else None,
            "compute_fraction": (compute_s / wall) if wall > 0 else None,
            "occupancy_mean": occ_mean,
            "occupancy_fraction": occ_frac,
            "verdict": verdict,
        }
        self._windows.append(w)
        self._reset_window_locked()
        # published under compute.* so the verdict rides the same
        # /metrics scrape as the xla_stats gauges (gauge writes do not
        # re-enter the lock)
        if wall > 0:
            tel.gauge("compute.step.input_fraction").set(w["input_fraction"])
            tel.gauge("compute.step.compute_fraction").set(
                w["compute_fraction"])
        tel.gauge("compute.step.input_bound").set(
            1.0 if verdict == "input-bound" else 0.0)
        # the string gauge serves in-process readers; the code gauge is
        # the one that survives a /metrics scrape
        tel.gauge("compute.step.verdict").set(verdict)
        tel.gauge("compute.step.verdict_code").set(
            float(VERDICT_CODE.get(verdict, -1)))
        if tel.recording:
            tel.emit(dict(w))
        return w

    def verdict(self):
        """Close the current window (if it saw any steps) and return the
        newest window dict — or a synthetic "idle" one when nothing was
        ever observed."""
        with self._lock:
            if self._steps:
                self._close_window_locked()
            if self._windows:
                return dict(self._windows[-1])
        return {"type": "attribution", "steps": 0, "verdict": "idle"}

    def windows(self):
        with self._lock:
            return [dict(w) for w in self._windows]

    def report(self):
        """Formatted per-window table."""
        rows = self.windows()
        lines = ["%-6s %6s %9s %9s %9s %9s %9s %6s  %s" % (
            "window", "steps", "wall_s", "input_s", "compute_s",
            "compile_s", "fetch_s", "occ", "verdict")]
        for i, w in enumerate(rows):
            occ = w.get("occupancy_fraction")
            lines.append("%-6d %6d %9.4f %9.4f %9.4f %9.4f %9.4f %6s  %s" % (
                i, w["steps"], w["wall_s"], w["input_s"], w["compute_s"],
                w["compile_s"], w["fetch_s"],
                "%.0f%%" % (100 * occ) if occ is not None else "-",
                w["verdict"]))
        return "\n".join(lines)
