"""Compute-side introspection: a step's FLOPs, bytes and memory, and its
MFU, for the port.

The JAX package's ``xla_stats`` reads XLA's ``cost_analysis()`` and
``memory_analysis()`` off a compiled executable.  The port has no
compiler to ask: a step is PyTorch's ATen operators (and the port's own
``paddle_tpu_torch::flash_fwd``/``flash_bwd``) dispatched one by one,
replayed later as a CUDA graph.  So the port counts a step itself, once,
while it runs: :func:`counting` wraps one eager run of the step in a
``TorchDispatchMode`` that sees every operator the step dispatches, the
autograd backward's included, and adds up

- ``flops``: each operator's FLOPs from the formulas
  ``torch.utils.flop_counter`` keeps (``FlopCounterMode``'s: matrix
  products, convolutions, attention; the flash operators register
  theirs), other operators 0;
- ``bytes_accessed``: each operator's input and output tensor bytes, a
  tensor that is both (an in-place result) once, a view operator none;
- ``temp_bytes`` on the card: the allocator's peak over the run, from
  ``torch.cuda.reset_peak_memory_stats`` at its start, less what was
  allocated then and less the outputs; 0 on the CPU, which has no
  allocator to read.

The executor adds ``arg_bytes`` (state and feeds) and ``out_bytes``
(fetches and the state the step writes); ``peak_hbm_bytes`` is their
sum with ``temp_bytes``.  These are the bytes of unfused operators, the
ones a replay launches, not XLA's post-fusion bytes.  The counted run is
one the executor makes anyway: the first, op-by-op run of an entry, or,
for an entry bound before the plane was armed, one eager run of its
captured step in place of a replay (bitwise the replay, as the fast
path's tests hold).  Counting touches no state and no random stream, so
training is bitwise the same with the plane on or off.  The XLA-object
entry points of the JAX package (``capture_compiled``,
``capture_jitted``, ``extract_compiled``) have no counterpart here;
:func:`capture_step` counts one call of a function instead.

Step time is the device's: a pair of CUDA events on the step's stream
around each observed replay, read once the end event has completed
(``Event.query``, never a synchronization of their own) at the next
observed step of that executor, or at :func:`summary`, :func:`last_mfu`
and :func:`program_stats`.  ``sync_timing`` (``enable(sync_timing=True)``
or ``PADDLE_TPU_TORCH_XLA_STATS_BLOCK=1``) waits for the end event inside
the step instead, as the JAX package blocks on its fetches.  On the CPU
the time is the host's wall around the step.  The counted run and a
capture never enter MFU.  Disarmed (the default;
``PADDLE_TPU_TORCH_XLA_STATS=1`` or :func:`enable` arms it), the
executor reads one flag a step.

Published under the JAX package's names (:data:`GAUGES`): static at each
count, ``compute.flops_per_step``, ``.bytes_per_step``,
``.peak_hbm_bytes``, ``.arg_bytes``, ``.temp_bytes``, ``.output_bytes``,
``.arith_intensity`` and ``.roofline_compute_bound``; dynamic at each
observed step, ``compute.step_time_s``, ``compute.mfu`` (flops / step
time / peak flops) and ``compute.bw_util``.  MFU is against one dense
roof a device kind (:data:`PEAK_TABLE`), whatever dtypes the step runs,
as the JAX package defines it; ``configure_peaks`` pins another.
"""
from __future__ import annotations

import collections
import contextlib
import os
import threading
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from . import registry as _reg

__all__ = [
    "enable",
    "disable",
    "active",
    "sync_timing",
    "configure_peaks",
    "restore_defaults",
    "device_peaks",
    "ProgramStats",
    "capture_step",
    "counting",
    "observe_step",
    "observe_stats",
    "program_stats",
    "all_stats",
    "last_mfu",
    "summary",
    "reset",
    "GAUGES",
    "PEAK_TABLE",
]

# every gauge the plane publishes, under the JAX package's names
GAUGES = (
    "compute.flops_per_step",
    "compute.bytes_per_step",
    "compute.peak_hbm_bytes",
    "compute.arg_bytes",
    "compute.temp_bytes",
    "compute.output_bytes",
    "compute.arith_intensity",
    "compute.roofline_compute_bound",
    "compute.step_time_s",
    "compute.mfu",
    "compute.bw_util",
)

# (peak dense FLOP/s, peak memory bytes/s) a device, keyed by a substring
# of its name.  One dense roof a kind, as the JAX package's table has:
# the H100 SXM's dense bf16 tensor-core rate and its HBM3 rate (NVIDIA
# H100 Tensor Core GPU datasheet).  The cpu row is a placeholder that
# keeps MFU defined on the CPU; tests pin their own peaks.
PEAK_TABLE = (
    ("H100", 989.4e12, 3.35e12),
    ("cpu", 1e11, 5e10),
)


def device_peaks(device_kind=None):
    """(peak_flops, peak_membw) of ``device_kind`` (default: the name of
    the current CUDA device; raises without one).  The environment's
    ``PADDLE_TPU_TORCH_PEAK_FLOPS`` / ``PADDLE_TPU_TORCH_PEAK_MEMBW`` win
    over the table; a kind the table does not name gets the cpu row."""
    if device_kind is None:
        if not torch.cuda.is_available():
            raise RuntimeError("device_peaks() reads the CUDA device's name, "
                               "and there is none; pass the device kind")
        device_kind = torch.cuda.get_device_name()
    flops = bw = None
    for key, f, b in PEAK_TABLE:
        if key.lower() in str(device_kind).lower():
            flops, bw = f, b
            break
    if flops is None:
        flops, bw = PEAK_TABLE[-1][1], PEAK_TABLE[-1][2]
    env_f = os.environ.get("PADDLE_TPU_TORCH_PEAK_FLOPS")
    env_b = os.environ.get("PADDLE_TPU_TORCH_PEAK_MEMBW")
    if env_f:
        flops = float(env_f)
    if env_b:
        bw = float(env_b)
    return flops, bw


def device_kind(device):
    """The kind :func:`device_peaks` keys on for a torch device."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


class ProgramStats:
    """The count of one executor entry (keyed by its program tag,
    ``<id-hex>:v<version>``) and its running step-time aggregates.
    ``op_rows`` holds the count by Program op type ({type:
    {"instructions": operators dispatched, "out_bytes": ...}}, the
    autograd backward as ``backward``)."""

    __slots__ = ("tag", "flops", "bytes_accessed", "arg_bytes", "out_bytes",
                 "temp_bytes", "alias_bytes", "code_bytes", "peak_hbm_bytes",
                 "num_devices", "device_kind", "steps", "total_time_s",
                 "last_time_s", "last_mfu", "last_bw_util", "op_rows")

    def __init__(self, tag, flops, bytes_accessed, arg_bytes, out_bytes,
                 temp_bytes, alias_bytes, code_bytes, num_devices,
                 device_kind, op_rows=None):
        self.tag = tag
        self.flops = flops
        self.bytes_accessed = bytes_accessed
        self.arg_bytes = arg_bytes
        self.out_bytes = out_bytes
        self.temp_bytes = temp_bytes
        self.alias_bytes = alias_bytes
        # no executable is built: there is no generated code to count
        self.code_bytes = code_bytes
        self.peak_hbm_bytes = arg_bytes + out_bytes + temp_bytes
        self.num_devices = max(1, int(num_devices))
        self.device_kind = device_kind
        self.op_rows = dict(op_rows or {})
        self.steps = 0
        self.total_time_s = 0.0
        self.last_time_s = None
        self.last_mfu = None
        self.last_bw_util = None

    @property
    def arith_intensity(self):
        """FLOPs per byte accessed, the roofline's x-coordinate."""
        if not self.bytes_accessed:
            return None
        return self.flops / self.bytes_accessed

    def as_dict(self):
        return {
            "tag": self.tag,
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "arg_bytes": self.arg_bytes,
            "out_bytes": self.out_bytes,
            "temp_bytes": self.temp_bytes,
            "alias_bytes": self.alias_bytes,
            "code_bytes": self.code_bytes,
            "peak_hbm_bytes": self.peak_hbm_bytes,
            "num_devices": self.num_devices,
            "device_kind": self.device_kind,
            "arith_intensity": self.arith_intensity,
            "steps": self.steps,
            "total_time_s": self.total_time_s,
            "last_time_s": self.last_time_s,
            "last_mfu": self.last_mfu,
            "last_bw_util": self.last_bw_util,
        }

    def __repr__(self):
        return ("ProgramStats(%r, flops=%.3g, bytes=%.3g, peak_hbm=%.3g, "
                "steps=%d)" % (self.tag, self.flops, self.bytes_accessed,
                               self.peak_hbm_bytes, self.steps))


class _Plane:
    """Module-wide state.  ``active`` is read on the executor's step path,
    so it is a plain attribute; the rest is under the lock."""

    def __init__(self):
        self.active = os.environ.get("PADDLE_TPU_TORCH_XLA_STATS", "0") == "1"
        self.sync = _env_sync()
        self.peak_flops = None
        self.peak_membw = None
        self.lock = threading.Lock()
        self.programs = {}
        self.last_tag = None
        self.clocks = weakref.WeakSet()   # every DeviceClock with events


def _env_sync():
    return os.environ.get("PADDLE_TPU_TORCH_XLA_STATS_BLOCK", "0") == "1"


_plane = _Plane()

_captures = _reg.counter("compute.captures")
_capture_errors = _reg.counter("compute.capture_errors")


def active():
    """Whether the plane is armed."""
    return _plane.active


def sync_timing():
    """Whether an observed step waits for its end event inside the step."""
    return _plane.sync


def enable(peak_flops=None, peak_membw=None, sync_timing=None):
    """Arm the plane.  ``peak_flops``/``peak_membw`` override the table
    for MFU and bandwidth use; ``sync_timing=True`` waits for each
    observed step's end.  None leaves a setting as it is; overrides
    outlive :func:`disable` until :func:`restore_defaults`."""
    if peak_flops is not None:
        _plane.peak_flops = float(peak_flops)
    if peak_membw is not None:
        _plane.peak_membw = float(peak_membw)
    if sync_timing is not None:
        _plane.sync = bool(sync_timing)
    _plane.active = True


def disable():
    _plane.active = False


def configure_peaks(peak_flops=None, peak_membw=None):
    """Set (None: clear back to the table) the peak overrides without
    arming or disarming the plane."""
    _plane.peak_flops = None if peak_flops is None else float(peak_flops)
    _plane.peak_membw = None if peak_membw is None else float(peak_membw)


def restore_defaults():
    """Clear the peak overrides and re-read the sync-timing default."""
    _plane.peak_flops = None
    _plane.peak_membw = None
    _plane.sync = _env_sync()


def _peaks(kind):
    f, b = device_peaks(kind)
    if _plane.peak_flops is not None:
        f = _plane.peak_flops
    if _plane.peak_membw is not None:
        b = _plane.peak_membw
    return f, b


# -- the count ---------------------------------------------------------------

# metadata queries a dispatch mode may see; they run nothing
_META_OPS = frozenset(getattr(torch.ops.aten, n).default for n in (
    "is_contiguous", "size", "sym_size", "stride", "sym_stride",
    "storage_offset", "sym_storage_offset", "numel", "sym_numel", "dim"))


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t):
    return t.numel() * t.element_size()


class StepCount(TorchDispatchMode):
    """One step's count, taken while the step runs (see the module
    docstring).  Each operator runs as it was dispatched; a failure to
    count one is remembered, never raised."""

    def __init__(self, device):
        super().__init__()
        self.device = torch.device(device)
        self.flops = 0
        self.bytes_accessed = 0
        self.temp_bytes = 0
        self.errors = 0
        self.rows = collections.defaultdict(
            lambda: {"instructions": 0, "out_bytes": 0})
        self._scopes = ["(between ops)"]
        self._mem0 = None

    @contextlib.contextmanager
    def scope(self, name):
        """Count what runs inside under the Program op type ``name``."""
        self._scopes.append(name)
        try:
            yield
        finally:
            self._scopes.pop()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func not in _META_OPS:
            try:
                self._note(func, args, kwargs, out)
            except Exception:
                self.errors += 1
        return out

    def _note(self, func, args, kwargs, out):
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        row = self.rows[self._scopes[-1]]
        row["instructions"] += 1
        if func.is_view:
            return
        seen, moved, written = set(), 0, 0
        ins = _tensors((args, kwargs))
        for t in ins:
            key = (t.data_ptr(), t.numel(), t.dtype)
            if key not in seen:
                seen.add(key)
                moved += _nbytes(t)
        for t in _tensors(out):
            key = (t.data_ptr(), t.numel(), t.dtype)
            if key not in seen:
                seen.add(key)
                moved += _nbytes(t)
                written += _nbytes(t)
        self.bytes_accessed += moved
        row["out_bytes"] += written

    def __enter__(self):
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
            self._mem0 = torch.cuda.memory_allocated(self.device)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            if self._mem0 is not None:
                self.temp_bytes = (torch.cuda.max_memory_allocated(self.device)
                                   - self._mem0)

    def finish(self, tag, arg_bytes, out_bytes, register=True):
        """The count as a :class:`ProgramStats`, registered under ``tag``
        and published with ``register``; None (and
        ``compute.capture_errors`` counted) where an operator could not
        be counted."""
        if self.errors:
            _capture_errors.inc()
            return None
        st = ProgramStats(
            tag, flops=float(self.flops),
            bytes_accessed=float(self.bytes_accessed),
            arg_bytes=float(arg_bytes), out_bytes=float(out_bytes),
            # the peak over the run holds its outputs too
            temp_bytes=float(max(0, self.temp_bytes - out_bytes)),
            alias_bytes=0.0, code_bytes=0.0, num_devices=1,
            device_kind=device_kind(self.device), op_rows=self.rows)
        if register:
            with _plane.lock:
                _plane.programs[tag] = st
                _plane.last_tag = tag
            _captures.inc()
            _publish_static(st)
        return st


@contextlib.contextmanager
def counting(device):
    """Count the step that runs inside (yields the :class:`StepCount`;
    call its ``finish`` after).  The executor's Program op loop scopes
    each op under the count while it is on.  A count that cannot start
    is counted in ``compute.capture_errors`` and the step runs uncounted
    (the yielded count then reports an error)."""
    from .. import executor as _executor

    count = StepCount(device)
    stack = contextlib.ExitStack()
    try:
        stack.enter_context(count)
        stack.enter_context(_executor.op_scope(count.scope))
    except Exception:
        stack.close()
        count.errors += 1
        yield count
        return
    with stack:
        yield count


def tensor_bytes(values):
    """Bytes of the distinct tensors among ``values``."""
    seen, n = set(), 0
    for t in values:
        if isinstance(t, torch.Tensor):
            key = (t.data_ptr(), t.numel(), t.dtype)
            if key not in seen:
                seen.add(key)
                n += _nbytes(t)
    return n


def capture_step(tag, run, device, arg_values=(), out_values=None,
                 register=True):
    """Run ``run()`` once under a count on ``device`` and return
    (its result, the :class:`ProgramStats` or None).  ``arg_values`` are
    the step's inputs (state and feeds), ``out_values(result)`` gives
    its outputs (fetches, written state); their bytes are ``arg_bytes``
    and ``out_bytes``.  A counting failure is counted, never raised; an
    error of the step itself propagates."""
    with counting(device) as count:
        result = run()
    try:
        outs = out_values(result) if out_values is not None else ()
        st = count.finish(tag, tensor_bytes(arg_values),
                          tensor_bytes(outs), register=register)
    except Exception:
        _capture_errors.inc()
        st = None
    return result, st


def _publish_static(st):
    _reg.gauge("compute.flops_per_step").set(st.flops)
    _reg.gauge("compute.bytes_per_step").set(st.bytes_accessed)
    _reg.gauge("compute.peak_hbm_bytes").set(st.peak_hbm_bytes)
    _reg.gauge("compute.arg_bytes").set(st.arg_bytes)
    _reg.gauge("compute.temp_bytes").set(st.temp_bytes)
    _reg.gauge("compute.output_bytes").set(st.out_bytes)
    ai = st.arith_intensity
    if ai is not None:
        _reg.gauge("compute.arith_intensity").set(ai)
        pf, pb = _peaks(st.device_kind)
        if pb:
            _reg.gauge("compute.roofline_compute_bound").set(
                1.0 if ai >= pf / pb else 0.0)


# -- step time ---------------------------------------------------------------


class DeviceClock:
    """CUDA-event windows of one executor's steps, each read once its end
    event has completed: ``query()`` only, never a synchronization."""

    def __init__(self):
        self._pending = collections.deque()
        self._lock = threading.Lock()

    def start(self, stream):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def stop(self, start, stream, stats, wait=False):
        """Close the window opened by ``start``; its time goes to
        ``stats`` (None: to no MFU).  ``wait`` waits for the end event
        (sync timing)."""
        end = torch.cuda.Event(enable_timing=True)
        end.record(stream)
        if wait:
            end.synchronize()
        with self._lock:
            self._pending.append((start, end, stats))
        _plane.clocks.add(self)

    def drain(self):
        """Seconds of device time of the windows that completed since the
        last drain (None when none did); each observed on its stats."""
        done = []
        with self._lock:
            keep = collections.deque()
            for item in self._pending:
                (done if item[1].query() else keep).append(item)
            self._pending = keep
        if not done:
            return None
        total = 0.0
        for start, end, st in done:
            seconds = start.elapsed_time(end) / 1e3
            total += seconds
            if st is not None:
                observe_stats(st, seconds)
        return total


def _drain_clocks():
    for clock in list(_plane.clocks):
        clock.drain()


def observe_step(tag, seconds):
    """Fold one measured step of ``tag`` into its aggregates (a tag with
    no count is a no-op).  The executor observes its entries' own
    :class:`ProgramStats` (:func:`observe_stats`), so shape-distinct
    entries of one Program never share one."""
    with _plane.lock:
        st = _plane.programs.get(tag)
    return observe_stats(st, seconds)


def observe_stats(st, seconds):
    """:func:`observe_step` against an explicit :class:`ProgramStats`."""
    if st is None or seconds <= 0:
        return None
    pf, pb = _peaks(st.device_kind)
    mfu = st.flops / seconds / (pf * st.num_devices) if pf else None
    bw = st.bytes_accessed / seconds / (pb * st.num_devices) if pb else None
    st.steps += 1
    st.total_time_s += seconds
    st.last_time_s = seconds
    st.last_mfu = mfu
    st.last_bw_util = bw
    _reg.gauge("compute.step_time_s").set(seconds)
    if mfu is not None:
        _reg.gauge("compute.mfu").set(mfu)
    if bw is not None:
        _reg.gauge("compute.bw_util").set(bw)
    return mfu


def program_stats(tag=None):
    """The :class:`ProgramStats` of ``tag`` (default: the newest count),
    with every completed step folded in, or None."""
    _drain_clocks()
    with _plane.lock:
        if tag is None:
            tag = _plane.last_tag
        return _plane.programs.get(tag)


def all_stats():
    _drain_clocks()
    with _plane.lock:
        return dict(_plane.programs)


def last_mfu():
    """The newest MFU published (None before any observed step)."""
    _drain_clocks()
    v = _reg.gauge("compute.mfu").value
    return v if isinstance(v, (int, float)) else None


def summary():
    """One table over every counted program."""
    rows = sorted(all_stats().values(), key=lambda s: -s.flops)
    lines = ["%-22s %12s %12s %12s %10s %8s %8s" % (
        "Program", "GFLOPs", "MB accessed", "peak HBM MB", "intensity",
        "steps", "MFU")]
    for st in rows:
        ai = st.arith_intensity
        lines.append("%-22s %12.3f %12.3f %12.3f %10s %8d %8s" % (
            st.tag, st.flops / 1e9, st.bytes_accessed / 1e6,
            st.peak_hbm_bytes / 1e6,
            "%.2f" % ai if ai is not None else "-",
            st.steps,
            "%.2f%%" % (100 * st.last_mfu) if st.last_mfu is not None
            else "-"))
    return "\n".join(lines)


def reset():
    """Forget every count and zero the ``compute.*`` cells in place."""
    with _plane.lock:
        _plane.programs.clear()
        _plane.last_tag = None
    _reg.reset("compute.")
