"""Profiler (reference: python/paddle/fluid/profiler.py), for the port.

The JAX package's profiler wraps ``jax.profiler`` and reads per-op rows
out of the compiled step's HLO.  The port's step is PyTorch operators,
run op by op or replayed as a CUDA graph, so:

- a session (``profiler()`` / ``start_profiler``) runs every bound step
  op by op (a replay has no op ranges), with each Program op inside a
  ``torch.profiler.record_function(op.type)`` range; with ``trace_dir``
  it also records a ``torch.profiler.profile`` (CPU activity, and CUDA
  activity on the card) and writes its Chrome trace there as
  ``trace.json`` (Perfetto or chrome://tracing open it);
- host timings (``record``, ``record_event``, the executor's
  ``executor.run[...]`` rows, each timed to the end of its device work)
  live on the observability registry under ``profiler.``, one clean
  window a session; ``stop_profiler()`` prints the report through the
  observability quiet path (``PADDLE_TPU_TELEMETRY=0`` silences it);
- :func:`compile_step` is the port's counted eager run of a Program
  (``observability.xla_stats``), :func:`compiled_op_report` its rows by
  Program op type, and :func:`profile_program` an eager per-op timing.

Entry points that run a Program run it on the card unless given a CPU
``device`` (a place or a device string).
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict

import torch

from . import observability as _obs

__all__ = ["cuda_profiler", "reset_profiler", "profiler", "start_profiler",
           "stop_profiler", "record_event", "is_profiling", "record",
           "format_report", "profile_program", "compiled_op_report",
           "compile_step"]

# every host-side profiler timing is a registry timer under this prefix;
# the report and reset touch only this namespace
TIMING_PREFIX = "profiler."

#: the file a session with ``trace_dir`` writes its Chrome trace to
TRACE_FILE = "trace.json"

_active = {"on": False, "dir": None, "t0": None, "torch": None,
           "scopes": None}
_active_lock = threading.Lock()


@contextlib.contextmanager
def cuda_profiler(output_file, output_mode=None, config=None):
    """Compatibility alias: a session whose report goes to
    ``output_file``."""
    with profiler("All", profile_path=output_file):
        yield


def reset_profiler():
    """Zero every ``profiler.*`` timer in place (other telemetry is
    untouched)."""
    _obs.reset(TIMING_PREFIX)


def start_profiler(state="All", trace_dir=None):
    """Open a session: a clean timing window, Program ops in
    ``record_function`` ranges, and with ``trace_dir`` a
    ``torch.profiler`` trace."""
    from . import executor

    with _active_lock:
        if _active["on"]:
            return
        _active["on"] = True
        _active["t0"] = time.time()
        _active["dir"] = trace_dir or None
    # each session reports its own window
    reset_profiler()
    scopes = contextlib.ExitStack()
    scopes.enter_context(executor.op_scope(torch.profiler.record_function,
                                           all_threads=True))
    _active["scopes"] = scopes
    if trace_dir:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        _active["torch"] = prof


def stop_profiler(sorted_key="total", profile_path=None):
    """Close the session: write the trace (``trace_dir``) and the report
    (to ``profile_path``, else the observability quiet stdout)."""
    with _active_lock:
        if not _active["on"]:
            return
        _active["on"] = False
        trace_dir, _active["dir"] = _active["dir"], None
        prof, _active["torch"] = _active["torch"], None
        scopes, _active["scopes"] = _active["scopes"], None
    if scopes is not None:
        scopes.close()
    if prof is not None:
        prof.stop()
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
    report = format_report(sorted_key)
    if profile_path:
        with open(profile_path, "w") as f:
            f.write(report)
    else:
        _obs.print_report(report)


@contextlib.contextmanager
def profiler(state="All", sorted_key="total", profile_path=None,
             trace_dir=None):
    start_profiler(state, trace_dir)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


@contextlib.contextmanager
def record_event(name):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record(name, time.perf_counter() - t0)


def is_profiling():
    return _active["on"]


def record(name, seconds):
    _obs.observe(TIMING_PREFIX + name, seconds)


def format_report(sorted_key="total"):
    rows = []
    for name, tm in _obs.get_telemetry().timers().items():
        if not name.startswith(TIMING_PREFIX):
            continue
        st = tm.stats()
        if st is not None:
            rows.append((name[len(TIMING_PREFIX):],) + st)
    keyidx = {"total": 2, "calls": 1, "ave": 3, "min": 4,
              "max": 5}.get(sorted_key, 2)
    rows.sort(key=lambda r: -r[keyidx])
    lines = ["%-48s %8s %12s %12s %12s %12s" % (
        "Event", "Calls", "Total(s)", "Avg(s)", "Min(s)", "Max(s)")]
    for r in rows:
        lines.append("%-48s %8d %12.6f %12.6f %12.6f %12.6f" % r)
    return "\n".join(lines)


def _on_device(values, device):
    from .executor import _as_tensor

    return {n: _as_tensor(v, None, device) for n, v in (values or {}).items()}


def compile_step(program, feed, state=None, fetch_list=None, device=None):
    """Run the whole-block step ONCE, outside any executor, under a count
    (``observability.xla_stats``), and return its ``ProgramStats``
    (registered nowhere): FLOPs, bytes, the memory of the run and its
    rows by Program op.  ``state`` and ``feed`` are copied to ``device``
    (None: the card) and nothing is written back: the step's new state
    is thrown away.  The port's counterpart of the JAX package's
    lower-and-compile, shared by :func:`compiled_op_report` and
    ``contrib.memory_usage``; raises when the step cannot be counted."""
    from .core import resolve_device
    from .observability import xla_stats
    from .program_fn import program_to_fn

    dev = resolve_device(device)
    state = _on_device(state, dev)
    feeds = _on_device(feed, dev)
    fn = program_to_fn(program, fetch_list or [], return_state=True,
                       device=dev)

    def outputs(result):
        fetches, new_state = result
        return list(fetches) + [v for n, v in new_state.items()
                                if v is not state.get(n)]

    _, st = xla_stats.capture_step(
        "compile_step", lambda: fn(state, feeds), dev,
        arg_values=[*state.values(), *feeds.values()], out_values=outputs,
        register=False)
    if st is None:
        raise RuntimeError("compile_step: an operator of the step could not "
                           "be counted (compute.capture_errors)")
    return st


def compiled_op_report(program, feed, state=None, fetch_list=None,
                       sorted_key="instructions", compiled=None, device=None):
    """Per-op attribution of one real step (reference:
    paddle/fluid/platform/profiler.cc's per-op device table): for each
    Program op type, the PyTorch operators dispatched under its ops
    (``instructions``; the flash operators count one each) and the
    bytes they wrote (``out_bytes``), from :func:`compile_step`'s count.
    The autograd backward is one ``backward`` row.  These rows are the
    launches a CUDA graph of the step replays, not XLA fusions: nothing
    fuses them.  Pass ``compiled`` (a :func:`compile_step` result) to
    reuse one count.  Returns (report_str, rows_dict)."""
    if compiled is None:
        compiled = compile_step(program, feed, state, fetch_list, device)
    rows = {k: dict(v) for k, v in compiled.op_rows.items()
            if v["instructions"]}
    keyf = ((lambda kv: -kv[1]["out_bytes"]) if sorted_key == "out_bytes"
            else (lambda kv: -kv[1]["instructions"]))
    lines = ["%-32s %14s %16s" % ("Op", "ATen ops", "Out bytes")]
    for name, r in sorted(rows.items(), key=keyf):
        lines.append("%-32s %14d %16d" % (name, r["instructions"],
                                          r["out_bytes"]))
    return "\n".join(lines), rows


def profile_program(program, feed, state=None, iters=10, sorted_key="total",
                    seed=0, device=None):
    """Per-op time attribution (reference profiler.py's sorted op table):
    the block run eagerly on ``device`` (None: the card), each op's rule
    timed to the end of its device work.  A Program with a backward
    meta-op is timed as one ``backward(whole block)`` row.  The first
    sample of each row (warm-up) is dropped.  Returns the report."""
    from .core import f32_bf16_reduction, resolve_device
    from .executor import LoweringContext, interpret_ops, lower_block

    dev = resolve_device(device)
    state = _on_device(state, dev)
    feeds = _on_device(feed, dev)

    def wait():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    times = defaultdict(list)
    ops = program.global_block().ops
    whole = any(op.type in ("backward", "calc_gradient") for op in ops)
    for _ in range(iters):
        ctx = LoweringContext(program, {**state, **feeds}, dev, seed=seed)
        with f32_bf16_reduction(dev):
            if whole:
                t0 = time.perf_counter()
                lower_block(ctx, program.global_block())
                wait()
                times["backward(whole block)"].append(
                    time.perf_counter() - t0)
                continue
            with torch.no_grad():
                for op in ops:
                    t0 = time.perf_counter()
                    interpret_ops(ctx, [op])
                    wait()
                    times[op.type].append(time.perf_counter() - t0)

    rows = []
    for name, ts in times.items():
        ts = ts[1:] if len(ts) > 1 else ts
        total = sum(ts)
        rows.append((name, len(ts), total, total / len(ts), min(ts), max(ts)))
    keyidx = {"total": 2, "calls": 1, "ave": 3, "min": 4,
              "max": 5}.get(sorted_key, 2)
    rows.sort(key=lambda r: -r[keyidx])
    lines = ["%-32s %8s %12s %12s %12s %12s" % (
        "Op", "Calls", "Total(s)", "Avg(s)", "Min(s)", "Max(s)")]
    for r in rows:
        lines.append("%-32s %8d %12.6f %12.6f %12.6f %12.6f" % r)
    return "\n".join(lines)
