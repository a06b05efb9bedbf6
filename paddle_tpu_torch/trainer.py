"""High-level Trainer / Inferencer with event callbacks, crash-consistent
step-versioned checkpoints, NaN-step guarding and heartbeat-based failure
detection.

The port's copy of ``paddle_tpu/trainer.py``, on the port's Executor:
a training step is one CUDA-graph replay from its third run (the
fast path), feeds come through the device prefetch pipeline
(``reader.device_prefetch``: a side CUDA stream), and checkpoint values
leave the card through ``executor.as_numpy`` (a pinned staging buffer;
bfloat16 widened to float32, cast back to the declared dtype when the
state is collected).  The on-disk layout is the JAX package's
(``params.npz``, ``meta.json``, ``MANIFEST.json``, format 1), so either
package loads the other's parameters.  The step's random state is the
port's ``(seed, step)`` pair, saved as ``rng_state.npy`` (int64[2]); the
JAX package's ``rng_key.npy`` (a jax PRNG key) is validated and ignored
on load, with a warning, and the program's seed kept.
``Trainer(parallel=...)`` (with ``sharding_rules`` and ``zero_stage``) and
``Inferencer(parallel=...)`` attach their mesh through
``Executor.attach_mesh``: a one-rank mesh runs as without one, more
ranks run the executor's mesh step; ``devices=`` names the ranks.

Reference: python/paddle/fluid/contrib/trainer.py (Trainer, the four
*Event classes, CheckpointConfig) and contrib/inferencer.py.  The
reference shipped real fault tolerance (pserver checkpoints, etcd-backed
recovery, trainer heartbeats); this rebuild keeps the spirit with local
machinery in the style of production checkpointing systems (frequent,
validated, rotating checkpoints with cheap resume):

- ``save_checkpoint`` is ATOMIC: everything lands in a
  ``checkpoint_<serial>.tmp/`` staging dir (params npz, meta, rng state,
  and a ``MANIFEST.json`` with per-file size + crc32 written last, each
  fsynced), then one ``rename`` publishes the serial.  A preemption at
  any byte leaves the previous "latest" untouched.
- ``load_checkpoint`` VALIDATES against the manifest and falls back to
  the newest intact serial instead of crashing on a torn directory;
  rotation never deletes the newest intact serial.
- ``Trainer(resume=True)`` restores params + epoch/step + the step RNG
  state, so a restarted run continues bit-for-bit from the last intact
  checkpoint.
- ``Trainer.train(nan_guard=N)`` arms the executor's on-device
  finiteness guard: a non-finite step's update is skipped inside the
  step (the CUDA graph) and N consecutive bad steps rewind to the last
  checkpoint.
- ``FailureMonitor`` wires ``Heartbeat``/``detect_failed_trainers`` into
  the loop: a stale peer triggers checkpoint-then-stop instead of a hang.
"""
from __future__ import annotations

import itertools
import json
import os
import shutil
import threading
import time
import warnings
import zlib
from io import BytesIO

import numpy as np

from . import io as io_mod
from . import observability as _obs
from . import resilience
from . import unique_name
from .core import CUDAPlace
from .data_feeder import DataFeeder
from .executor import Executor, Scope, as_numpy, global_scope, scope_guard
from .framework import Program, program_guard
from .observability import xla_stats as _xla_stats

__all__ = [
    "BeginEpochEvent",
    "EndEpochEvent",
    "BeginStepEvent",
    "EndStepEvent",
    "CheckpointConfig",
    "Trainer",
    "Inferencer",
    "save_checkpoint",
    "load_checkpoint",
    "Heartbeat",
    "detect_failed_trainers",
    "FailureMonitor",
]


class BeginEpochEvent:
    def __init__(self, epoch_id):
        self.epoch = epoch_id


class EndEpochEvent:
    def __init__(self, epoch_id):
        self.epoch = epoch_id


class BeginStepEvent:
    def __init__(self, epoch_id, step_id):
        self.epoch = epoch_id
        self.step = step_id
        self.fetch_metrics = True


class EndStepEvent:
    def __init__(self, epoch_id, step_id, metrics):
        self.epoch = epoch_id
        self.step = step_id
        self.metrics = metrics


class CheckpointConfig:
    def __init__(self, checkpoint_dir=None, max_num_checkpoints=3, epoch_interval=1, step_interval=10):
        assert epoch_interval >= 1 and step_interval >= 1
        self.checkpoint_dir = checkpoint_dir or os.getcwd()
        self.max_num_checkpoints = max_num_checkpoints
        self.epoch_interval = epoch_interval
        self.step_interval = step_interval
        self.epoch_id = 0
        self.step_id = 0
        self.load_serial = None


# ---------------------------------------------------------------------------
# atomic, manifest-verified checkpoints
# ---------------------------------------------------------------------------

CHECKPOINT_FORMAT_VERSION = 1
MANIFEST_NAME = "MANIFEST.json"
# the port's step random state, (seed, step) as int64[2]; the JAX
# package's key file, a jax PRNG key the port cannot use
RNG_STATE_NAME = "rng_state.npy"
JAX_RNG_KEY_NAME = "rng_key.npy"

# transient-FS retry for every checkpoint file IO (flaky network mounts are
# the normal case for shared checkpoint dirs); swap the module attribute to
# tune globally
CHECKPOINT_IO_POLICY = resilience.RetryPolicy(
    max_retries=3, base_delay=0.05, max_delay=1.0)


def _serials(dirname):
    out = []
    if os.path.isdir(dirname):
        for n in os.listdir(dirname):
            if n.startswith("checkpoint_") and n[11:].isdigit():
                out.append(int(n[11:]))
    return sorted(out)


def _npz_bytes(arrays):
    buf = BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _crc(data):
    return zlib.crc32(data) & 0xFFFFFFFF


def _load_manifest(cdir):
    """The parsed manifest dict, or None for a legacy (pre-manifest)
    checkpoint directory.  Raises on unreadable/corrupt JSON."""
    path = os.path.join(cdir, MANIFEST_NAME)
    if not os.path.exists(path):
        return None
    data = resilience.call_with_retry(
        resilience.fs_read_bytes, path, policy=CHECKPOINT_IO_POLICY)
    return json.loads(data.decode("utf-8"))


def _checkpoint_intact(cdir, quick=False):
    """Manifest-validated integrity: every listed file present with the
    recorded size (and, unless ``quick``, crc32).  Legacy dirs count as
    intact when both params.npz and meta.json exist."""
    try:
        man = _load_manifest(cdir)
    except (OSError, ValueError):
        return False
    if man is None:
        return (os.path.exists(os.path.join(cdir, "params.npz"))
                and os.path.exists(os.path.join(cdir, "meta.json")))
    try:
        for name, info in man.get("files", {}).items():
            path = os.path.join(cdir, name)
            if os.path.getsize(path) != info["size"]:
                return False
            if not quick:
                data = resilience.call_with_retry(
                    resilience.fs_read_bytes, path,
                    policy=CHECKPOINT_IO_POLICY)
                if _crc(data) != info["crc32"]:
                    return False
    except OSError:
        return False
    return True


def _rotate_checkpoints(dirname, max_num, trusted=None):
    """Drop serials beyond the newest ``max_num`` — but NEVER the newest
    intact one (if every kept serial is torn/corrupt, the last-known-good
    older serial survives rotation), and sweep stray ``.tmp`` staging dirs
    left by crashed writes.  ``trusted`` marks a serial known intact
    without re-reading it (the one save_checkpoint just wrote + fsynced),
    so the newest-intact scan normally stops immediately; otherwise
    candidates are crc-validated — a size-only check can't see bit rot."""
    serials = _serials(dirname)
    doomed = serials[:-max_num] if max_num and max_num > 0 else []
    if doomed:
        protected = None
        for s in reversed(serials):
            if s == trusted or _checkpoint_intact(
                    os.path.join(dirname, "checkpoint_%d" % s)):
                protected = s
                break
        for old in doomed:
            if old == protected:
                continue
            shutil.rmtree(os.path.join(dirname, "checkpoint_%d" % old),
                          ignore_errors=True)
    for n in os.listdir(dirname):
        if n.startswith("checkpoint_") and n.endswith(".tmp"):
            shutil.rmtree(os.path.join(dirname, n), ignore_errors=True)


# monotonically increasing run ids tie one train()/test() loop's step
# records together across sinks
_run_seq = itertools.count()

# registry counters the trainer's step records report (the same cells the
# executor / prefetcher / resilience layers increment — one source of truth)
_feed_copies = _obs.counter("executor.feed_host_copy")
_transfers = _obs.counter("prefetch.transfer")
_retries = _obs.counter("resilience.retry")


def save_checkpoint(executor, dirname, main_program, serial, meta, max_num=3):
    """Atomically write ``checkpoint_<serial>/`` and rotate old serials.

    Layout: ``params.npz`` (every persistable var, read off the card
    through ``as_numpy``; bfloat16 as float32), ``meta.json``
    (epoch/step), ``rng_state.npy`` (the scope's step random state
    ``(seed, step)``, so a resumed run draws the identical randomness
    stream), and ``MANIFEST.json``
    (per-file size + crc32, program version) written LAST.  All files are
    staged in ``checkpoint_<serial>.tmp/`` with fsync, then one atomic
    rename publishes the serial — a crash mid-write can only ever leave a
    ``.tmp`` dir that loading ignores, never a torn "latest".  Transient
    IO errors retry per ``CHECKPOINT_IO_POLICY``.  Files are serialized
    in memory first (transiently ~2x checkpoint size of host RAM) so the
    byte-exact fault-injection choke point sees whole files; stream to
    disk instead if that ever pinches."""
    serial = int(serial)
    _wall0, _t0 = time.time(), time.perf_counter()
    scope = global_scope()
    cdir = os.path.join(dirname, "checkpoint_%d" % serial)
    tmp = cdir + ".tmp"
    os.makedirs(dirname, exist_ok=True)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    arrays = {}
    for v in main_program.list_vars():
        if not io_mod.is_persistable(v):
            continue
        owner = scope._owner(v.name)
        val = owner.vars[v.name] if owner is not None else None
        if val is None:
            raise KeyError(
                "variable %r has no value in scope (run startup first?)" % v.name)
        arrays[v.name] = as_numpy(val)
    files = {
        "params.npz": _npz_bytes(arrays),
        "meta.json": json.dumps(meta).encode("utf-8"),
    }
    key_owner = scope._owner("__rng_key__")
    rng_key = key_owner.vars.get("__rng_key__") if key_owner is not None else None
    if rng_key is not None:
        buf = BytesIO()
        np.save(buf, np.asarray(rng_key, dtype=np.int64))
        files[RNG_STATE_NAME] = buf.getvalue()
    manifest = {
        "format": CHECKPOINT_FORMAT_VERSION,
        "serial": serial,
        "meta": meta,
        "program_version": int(getattr(main_program, "version", 0)),
        "files": {n: {"size": len(b), "crc32": _crc(b)}
                  for n, b in files.items()},
    }
    for name, data in files.items():
        resilience.call_with_retry(
            resilience.fs_write_bytes, os.path.join(tmp, name), data,
            policy=CHECKPOINT_IO_POLICY)
    resilience.call_with_retry(
        resilience.fs_write_bytes, os.path.join(tmp, MANIFEST_NAME),
        json.dumps(manifest, indent=1).encode("utf-8"),
        policy=CHECKPOINT_IO_POLICY)
    resilience.fsync_dir(tmp)
    # same-serial overwrite: drop the old dir only now, AFTER staging
    # completed — a crash during the long staging writes must never cost
    # the previously intact serial (the rmtree→rename window is two fast
    # metadata ops)
    if os.path.exists(cdir):
        shutil.rmtree(cdir)
    os.rename(tmp, cdir)  # the atomic publish
    resilience.fsync_dir(dirname)
    _rotate_checkpoints(dirname, max_num, trusted=serial)
    # one timing truth for checkpoint IO: the registry timer feeds
    # format_report-style summaries, the span shows up on the trace
    _obs.observe_span("checkpoint.save", _wall0, _t0, {"serial": serial})
    return cdir


def _apply_checkpoint(cdir, main_program):
    """Validate ``cdir`` against its manifest, load params (+ rng state)
    into the current scope, and return the meta dict.  Raises on any
    integrity failure — callers decide whether to fall back.  A JAX
    package checkpoint's ``rng_key.npy`` is validated, then ignored with
    a warning: the scope keeps its own random state."""
    man = _load_manifest(cdir)
    listed = man.get("files", {}) if man is not None else {}

    def read_file(name, required=True):
        path = os.path.join(cdir, name)
        if not os.path.exists(path):
            if required or name in listed:
                raise IOError("checkpoint file %r missing from %r" % (name, cdir))
            return None
        data = resilience.call_with_retry(
            resilience.fs_read_bytes, path, policy=CHECKPOINT_IO_POLICY)
        info = listed.get(name)
        if info is not None and (len(data) != info["size"]
                                 or _crc(data) != info["crc32"]):
            raise IOError(
                "checkpoint file %r fails manifest validation in %r "
                "(torn write?)" % (name, cdir))
        return data

    params = np.load(BytesIO(read_file("params.npz")), allow_pickle=False)
    meta = json.loads(read_file("meta.json").decode("utf-8"))
    rng_data = read_file(RNG_STATE_NAME, required=False)
    if rng_data is None and read_file(JAX_RNG_KEY_NAME, required=False):
        warnings.warn(
            "checkpoint %r holds the JAX package's rng_key.npy, which the "
            "port cannot use: loading the parameters alone and keeping "
            "the scope's own (seed, step)" % cdir)

    # stage everything, THEN commit: a validation failure partway through
    # must leave the scope untouched (no silent mix of checkpoint params
    # and whatever was there before)
    staged = {}
    for v in main_program.list_vars():
        if not io_mod.is_persistable(v):
            continue
        if v.name not in params:
            raise KeyError("checkpoint %r is missing persistable %r" % (cdir, v.name))
        staged[v.name] = params[v.name]
    if rng_data is not None:
        seed, step = np.load(BytesIO(rng_data), allow_pickle=False)
        staged["__rng_key__"] = (int(seed), int(step))
    scope = global_scope()
    for name, val in staged.items():
        scope[name] = val
    return meta


def load_checkpoint(executor, dirname, main_program, serial=None):
    """Load the given (or newest INTACT) checkpoint; returns its meta dict.

    With ``serial=None`` candidates are tried newest-first, and a
    torn/corrupt directory (missing file, size or crc32 mismatch against
    its MANIFEST) is skipped with a warning — so a crash mid-write never
    strands a restart.  An explicit ``serial`` that was rotated away
    raises a clear error listing the available serials; an explicit
    corrupt serial raises instead of silently loading something else."""
    _wall0, _t0 = time.time(), time.perf_counter()
    serials = _serials(dirname)
    if not serials:
        raise IOError("no checkpoints under %r" % dirname)
    if serial is not None:
        serial = int(serial)
        if serial not in serials:
            raise IOError(
                "checkpoint serial %d not found under %r (rotated away or "
                "never written); available serials: %s"
                % (serial, dirname, serials))
        candidates = [serial]
    else:
        candidates = list(reversed(serials))
    failures = []
    for s in candidates:
        cdir = os.path.join(dirname, "checkpoint_%d" % s)
        try:
            meta = _apply_checkpoint(cdir, main_program)
        except Exception as e:  # torn/corrupt: fall back to an older serial
            if serial is not None:
                raise IOError(
                    "checkpoint serial %d under %r is corrupt: %s"
                    % (s, dirname, e)) from e
            failures.append("serial %d: %s" % (s, e))
            warnings.warn(
                "skipping corrupt checkpoint serial %d under %r (%s); "
                "falling back to an older serial" % (s, dirname, e))
            continue
        meta["serial"] = s
        # hand-timed (multi-exit candidate loop; the span is only emitted
        # on success, tagged with the serial that won)
        _obs.observe_span("checkpoint.load", _wall0, _t0, {"serial": s})
        return meta
    raise IOError("no intact checkpoint under %r; tried newest-first: %s"
                  % (dirname, "; ".join(failures)))


class Trainer:
    """train_func() -> loss (first) + extra fetch vars; optimizer_func() ->
    Optimizer.  Runs the loop, fires events, checkpoints, resumes."""

    def __init__(self, train_func, optimizer_func, param_path=None, place=None,
                 parallel=False, checkpoint_config=None, sharding_rules=None,
                 zero_stage=0, use_program_cache=True, resume=True,
                 devices=None):
        """``parallel`` (True: a 1-D dp mesh over every rank of
        ``devices``; or a mesh spec, ``parallel_executor.build_mesh``),
        ``sharding_rules`` and ``zero_stage`` go to
        ``Executor.attach_mesh``: on a one-rank mesh the steps are those of
        ``parallel=False``, on more ranks they are the executor's mesh
        step.  ``devices`` (a port addition, as ``ParallelExecutor``'s)
        lists the ranks' devices, a device named more than once for ranks
        that share it; None is every card for a place on the card, the
        place's device on the CPU.

        ``use_program_cache``: keep the executor's bound entries (one
        CUDA graph a step on the card) hot across steps (default).  On a
        hit the train loop skips the per-step feed/state re-derivation
        entirely, and step metrics come back as lazily-materialized
        fetches — reading them in the event handler is what pays the
        device->host copy, so a handler that only samples metrics every K
        steps costs nothing on the other K-1.

        ``resume``: with a ``checkpoint_config``, restore params, the
        epoch/step position AND the step random state from the newest
        intact checkpoint at startup (torn/corrupt serials are skipped), so
        the continued run is bitwise-identical to one that never crashed.
        ``resume=False`` starts fresh even when checkpoints exist.

        ``place`` None is ``CUDAPlace(0)``, which raises without a card;
        pass ``CPUPlace()`` for the plain PyTorch versions."""
        self.place = place if place is not None else CUDAPlace(0)
        self.parallel = parallel
        self.use_program_cache = bool(use_program_cache)
        self.checkpoint_cfg = checkpoint_config
        self.scope = Scope()
        self.startup_program = Program()
        self.train_program = Program()
        self.nan_bad_steps = 0
        self.nan_rewinds = 0

        # deterministic var names per Trainer instance (several trainers can
        # coexist in one process, e.g. train-then-infer or resume tests)
        with unique_name.guard():
            with program_guard(self.train_program, self.startup_program):
                outs = train_func()
                if not isinstance(outs, (list, tuple)):
                    outs = [outs]
                self.train_func_outputs = list(outs)
                self.loss = outs[0]
                optimizer = optimizer_func()
                optimizer.minimize(self.loss)

        self.test_program = self.train_program.clone(for_test=True)
        self.exe = Executor(self.place)
        if parallel:
            self.exe.attach_mesh(parallel, sharding_rules=sharding_rules,
                                 zero_stage=zero_stage, devices=devices)
        with scope_guard(self.scope):
            self.exe.run(self.startup_program)
            if param_path:
                io_mod.load_persistables(self.exe, param_path, main_program=self.train_program)
        self._epoch_start, self._step_start = 0, 0
        self._serial_start = 0
        if (resume and self.checkpoint_cfg
                and _serials(self.checkpoint_cfg.checkpoint_dir)):
            with scope_guard(self.scope):
                try:
                    meta = load_checkpoint(
                        self.exe, self.checkpoint_cfg.checkpoint_dir,
                        self.train_program,
                        serial=self.checkpoint_cfg.load_serial)
                except IOError as e:
                    if self.checkpoint_cfg.load_serial is not None:
                        # the user PINNED a serial: silently training from
                        # scratch (and rotating their checkpoints away)
                        # would be worse than stopping
                        raise
                    # serials exist but none is intact: starting fresh beats
                    # refusing to start at all
                    warnings.warn("auto-resume skipped: %s" % e)
                else:
                    self._epoch_start = meta.get("epoch", 0)
                    self._step_start = meta.get("step", 0)
                    self._serial_start = meta["serial"]

    def stop(self):
        self.__stopped = True

    def _program_tag(self, program):
        return "%x:v%d" % (id(program), getattr(program, "version", 0))

    def _emit_step_record(self, tel, run_id, prog_tag, phase, epoch_id,
                          step_id, duration_s, verdict, guard,
                          ckpt_save_s=None, ckpt_load_s=None):
        """One trainer step record (the JAX package's keys; ``mfu`` while
        the compute-introspection plane is armed and this program has an
        observed step).  Unlike executor records,
        ``nan_ok`` carries the REAL on-device verdict: an armed guard loop
        reads it every step anyway, so reporting it costs nothing
        extra."""
        rec = {
            "type": "step",
            "ts": time.time(),
            "source": "trainer",
            "phase": phase,
            "run_id": run_id,
            "program": prog_tag,
            "epoch": epoch_id,
            "step": step_id,
            "duration_s": duration_s,
            "steps_per_s": (1.0 / duration_s) if duration_s > 0 else None,
            "feed_host_copies": _feed_copies.value,
            "prefetch_transfers": _transfers.value,
            "nan_ok": verdict,
            "nan_guard": guard,
            "retries": _retries.value,
            "rewinds": self.nan_rewinds,
        }
        if _xla_stats.active():
            # THIS program's count, not the newest gauge: another armed
            # loop in the process must not leak its MFU into these records
            st = _xla_stats.program_stats(prog_tag)
            if st is not None and st.last_mfu is not None:
                rec["mfu"] = st.last_mfu
        if ckpt_save_s is not None:
            rec["checkpoint_save_s"] = ckpt_save_s
        if ckpt_load_s is not None:
            rec["checkpoint_load_s"] = ckpt_load_s
        tel.emit(rec)

    def _rewind_to_checkpoint(self, bad_steps):
        """nan_guard hit its consecutive-failure limit: restore params +
        rng from the newest intact checkpoint (caller holds scope_guard).
        The loaded values replace the scope's tensors, so the next step
        runs op by op and the one after captures again."""
        cfg = self.checkpoint_cfg
        if not (cfg and _serials(cfg.checkpoint_dir)):
            raise FloatingPointError(
                "%d consecutive non-finite training steps and no checkpoint "
                "to rewind to (pass checkpoint_config to enable rewind)"
                % bad_steps)
        meta = load_checkpoint(self.exe, cfg.checkpoint_dir, self.train_program)
        self.nan_rewinds += 1
        _obs.inc("trainer.rewind")
        tel = _obs.get_telemetry()
        if tel.recording:
            tel.emit({
                "type": "rewind",
                "ts": time.time(),
                "bad_steps": bad_steps,
                "serial": meta["serial"],
                "rewinds": self.nan_rewinds,
            })
        warnings.warn(
            "nan_guard: %d consecutive non-finite steps; rewound "
            "parameters/rng to checkpoint serial %d" % (bad_steps, meta["serial"]))

    def _feed_pipeline(self, reader, feeder, program, prefetch,
                       prefetch_buffer):
        """Reader -> creator of per-epoch feed-dict generators,
        ``creator(skip=N)`` dropping the first N batches at the RAW
        reader (before conversion/transfer — a resume must not pay the
        input pipeline for already-applied steps).  With prefetch on
        (default; opt out per call), DataFeeder conversion and the
        host->device transfer run on a background thread into a bounded
        buffer (reader.device_prefetch: pinned memory, a side CUDA
        stream), so the step loop consumes tensors already on the card
        and the executor's replay does no host-side feed work.  Training
        is bitwise-identical either way — the pipeline moves work off the
        critical path, it never changes the values."""
        from .reader import device_prefetch

        if prefetch is None:
            prefetch = device_prefetch.prefetch_enabled_default()

        def creator(skip=0):
            src = reader if not skip else (
                lambda: itertools.islice(reader(), skip, None))
            if prefetch:
                return device_prefetch.decorate_device_feed(
                    src, feeder, self.exe, program,
                    buffer_size=prefetch_buffer)()
            return (feeder.feed(data) for data in src())

        return creator

    def train(self, num_epochs, event_handler=None, reader=None,
              feed_order=None, nan_guard=False, failure_monitor=None,
              prefetch=None, prefetch_buffer=2, attribution=None):
        """Run the training loop.

        ``attribution``: an ``observability.StepAttribution``, attached
        for this call and detached on every way out of it.

        ``prefetch``: route the reader through the async device-feed
        pipeline (``reader.device_prefetch``) so batch N+1's conversion
        and host->device transfer overlap batch N's compute.  ``None``
        (default) and ``True`` turn it on; ``False`` opts out for this
        call.  ``prefetch_buffer``
        bounds the in-flight batches (2 = double buffer).  The pipeline
        composes with the fault-tolerance features below: a rewind or a
        monitor-triggered stop tears the buffer down via the shared
        shutdown path, and resume/nan_guard semantics are unchanged.

        ``nan_guard``: ``True`` (limit 3) or an int N.  Arms the
        executor's on-device step guard: one finiteness reduction over
        loss + parameter gradients per step, and a non-finite step's
        whole state update is skipped INSIDE the step (the CUDA graph) —
        the parameters come out bitwise-unchanged.  After N consecutive bad
        steps, the trainer rewinds params + rng to the newest intact
        checkpoint (or raises FloatingPointError without one).
        ``self.nan_bad_steps`` / ``self.nan_rewinds`` count totals.
        Prompt rewind requires reading the verdict every step, so an
        armed guard trades the fast path's async dispatch pipelining for
        one scalar device->host sync per step (``last_step_ok``) — on top
        of the in-step gating cost (see PERF.md).

        ``failure_monitor``: a :class:`FailureMonitor`.  train() starts
        it, polls it once per step (time-gated, so the cost is one clock
        read), and when a peer's heartbeat goes stale saves a final
        checkpoint and stops cleanly instead of hanging on a dead
        cluster."""
        event_handler = event_handler or (lambda e: None)
        guard_n = 0 if not nan_guard else (
            3 if nan_guard is True else max(int(nan_guard), 1))
        consecutive_bad = 0
        feeder = DataFeeder(
            feed_list=[self.train_program.global_block().var(n) for n in feed_order],
            place=self.place,
            program=self.train_program,
        )
        self.__stopped = False
        serial = self._serial_start
        global_step = 0
        tel = _obs.get_telemetry()
        run_id = "train-%d" % next(_run_seq)
        prog_tag = self._program_tag(self.train_program)
        feed_creator = self._feed_pipeline(reader, feeder, self.train_program,
                                           prefetch, prefetch_buffer)
        if failure_monitor is not None:
            failure_monitor.start()
        if attribution is not None:
            attribution.attach()
        try:
            with scope_guard(self.scope):
                for epoch_id in range(self._epoch_start, num_epochs):
                    event_handler(BeginEpochEvent(epoch_id))
                    # steps already applied before the checkpoint this run
                    # resumed from are dropped at the raw reader (replaying
                    # would double-count them; converting/transferring them
                    # just to discard would stall the resume)
                    skip = (self._step_start
                            if epoch_id == self._epoch_start else 0)
                    feeds = feed_creator(skip)
                    try:
                        for step_id, feed in enumerate(feeds, start=skip):
                            if self.__stopped:
                                return
                            if failure_monitor is not None and failure_monitor.poll():
                                # a peer went silent: publish a final checkpoint
                                # and stop cleanly instead of training into a
                                # dead cluster ("step" = this un-executed step,
                                # so a resume replays it)
                                cfg = self.checkpoint_cfg
                                if cfg:
                                    serial += 1
                                    save_checkpoint(
                                        self.exe, cfg.checkpoint_dir,
                                        self.train_program, serial,
                                        {"epoch": epoch_id, "step": step_id},
                                        cfg.max_num_checkpoints)
                                self.stop()
                                return
                            recording = tel.recording
                            t_step0 = (time.perf_counter() if recording
                                       else 0.0)
                            begin = BeginStepEvent(epoch_id, step_id)
                            event_handler(begin)
                            fetch = self.train_func_outputs if begin.fetch_metrics else []
                            metrics = self.exe.run(
                                self.train_program, feed=feed,
                                fetch_list=fetch,
                                use_program_cache=self.use_program_cache,
                                nan_guard=bool(guard_n),
                            )
                            verdict = None
                            ckpt_load_s = None
                            if guard_n:
                                verdict = self.exe.last_step_ok()
                                if verdict is False:
                                    self.nan_bad_steps += 1
                                    consecutive_bad += 1
                                    if consecutive_bad >= guard_n:
                                        _t = time.perf_counter()
                                        self._rewind_to_checkpoint(consecutive_bad)
                                        ckpt_load_s = time.perf_counter() - _t
                                        consecutive_bad = 0
                                else:
                                    consecutive_bad = 0
                            event_handler(EndStepEvent(epoch_id, step_id, metrics))
                            global_step += 1
                            ckpt_save_s = None
                            cfg = self.checkpoint_cfg
                            if cfg and global_step % cfg.step_interval == 0:
                                serial += 1
                                _t = time.perf_counter()
                                save_checkpoint(
                                    self.exe, cfg.checkpoint_dir, self.train_program, serial,
                                    # "step" counts *completed* steps this epoch, so a
                                    # resume skips exactly [0, step) and the epoch-end
                                    # checkpoint's step=0 means "skip nothing"
                                    {"epoch": epoch_id, "step": step_id + 1}, cfg.max_num_checkpoints,
                                )
                                ckpt_save_s = time.perf_counter() - _t
                            if recording:
                                self._emit_step_record(
                                    tel, run_id, prog_tag, "train",
                                    epoch_id, step_id,
                                    time.perf_counter() - t_step0,
                                    verdict, bool(guard_n),
                                    ckpt_save_s, ckpt_load_s)
                    finally:
                        # early return/exception (stop(), failure monitor,
                        # rewind raise) must tear down in-flight prefetch
                        close = getattr(feeds, "close", None)
                        if close is not None:
                            close()
                    event_handler(EndEpochEvent(epoch_id))
                    cfg = self.checkpoint_cfg
                    if cfg and (epoch_id + 1) % cfg.epoch_interval == 0:
                        serial += 1
                        save_checkpoint(
                            self.exe, cfg.checkpoint_dir, self.train_program, serial,
                            {"epoch": epoch_id + 1, "step": 0}, cfg.max_num_checkpoints,
                        )
        finally:
            if failure_monitor is not None:
                failure_monitor.stop()
            if attribution is not None:
                attribution.detach()

    def test(self, reader, feed_order, prefetch=None, prefetch_buffer=2):
        feeder = DataFeeder(
            feed_list=[self.test_program.global_block().var(n) for n in feed_order],
            place=self.place,
            program=self.test_program,
        )
        accumulated = None
        count = 0
        tel = _obs.get_telemetry()
        run_id = "test-%d" % next(_run_seq)
        prog_tag = self._program_tag(self.test_program)
        feeds = self._feed_pipeline(reader, feeder, self.test_program,
                                    prefetch, prefetch_buffer)(0)
        try:
            with scope_guard(self.scope):
                for feed in feeds:
                    recording = tel.recording
                    t_step0 = time.perf_counter() if recording else 0.0
                    # the eval step writes no state; its bound entry captures
                    # at the second batch and replays one graph a batch after
                    outs = self.exe.run(self.test_program, feed=feed,
                                        fetch_list=self.train_func_outputs,
                                        use_program_cache=self.use_program_cache)
                    vals = [float(np.ravel(o)[0]) for o in outs]
                    accumulated = vals if accumulated is None else [a + v for a, v in zip(accumulated, vals)]
                    count += 1
                    if recording:
                        self._emit_step_record(
                            tel, run_id, prog_tag, "test", 0, count - 1,
                            time.perf_counter() - t_step0, None, False)
        finally:
            close = getattr(feeds, "close", None)
            if close is not None:
                close()
        return [a / max(count, 1) for a in (accumulated or [])]

    def save_params(self, param_path):
        with scope_guard(self.scope):
            io_mod.save_persistables(self.exe, param_path, main_program=self.train_program)

    def save_inference_model(self, param_path, feeded_var_names, target_var_indexes):
        with scope_guard(self.scope):
            io_mod.save_inference_model(
                param_path,
                feeded_var_names,
                [self.train_func_outputs[i] for i in target_var_indexes],
                self.exe,
                main_program=self.train_program,
            )


class Inferencer:
    """infer_func() -> prediction var(s); loads params from param_path
    (reference: contrib/inferencer.py)."""

    def __init__(self, infer_func, param_path, place=None, parallel=False,
                 devices=None):
        self.place = place if place is not None else CUDAPlace(0)
        self.scope = Scope()
        self.startup_program = Program()
        self.inference_program = Program()
        with unique_name.guard():
            with program_guard(self.inference_program, self.startup_program):
                outs = infer_func()
                self.predict_vars = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        self.exe = Executor(self.place)
        if parallel:
            # the mesh of every rank of ``devices`` (True) or a
            # Trainer-style mesh spec: one rank runs as without it
            self.exe.attach_mesh(parallel, devices=devices)
        with scope_guard(self.scope):
            self.exe.run(self.startup_program)
            io_mod.load_persistables(self.exe, param_path, main_program=self.inference_program)

    def infer(self, inputs):
        with scope_guard(self.scope):
            results = self.exe.run(
                self.inference_program, feed=inputs, fetch_list=self.predict_vars
            )
        return results


# ---------------------------------------------------------------------------
# failure detection (reference analog: the cluster heartbeat that
# go/master & pserver use to detect dead trainers)
# ---------------------------------------------------------------------------


class Heartbeat:
    """Background thread touching ``<dir>/<trainer_id>.hb`` with a timestamp
    every ``interval`` seconds; a supervisor calls detect_failed_trainers."""

    def __init__(self, dirname, trainer_id, interval=1.0):
        self.path = os.path.join(dirname, "%s.hb" % trainer_id)
        os.makedirs(dirname, exist_ok=True)
        self.interval = interval
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._beat, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def _beat(self):
        while not self._stop.is_set():
            with open(self.path, "w") as f:
                f.write("%f" % time.time())
            self._stop.wait(self.interval)

    def stop(self):
        """Idempotent; safe even if start() was never called."""
        self._stop.set()
        if self._thread.ident is not None:
            self._thread.join(timeout=5)


def detect_failed_trainers(dirname, timeout):
    """Trainer ids whose heartbeat file is older than ``timeout`` seconds."""
    failed = []
    now = time.time()
    if not os.path.isdir(dirname):
        return failed
    for n in sorted(os.listdir(dirname)):
        if not n.endswith(".hb"):
            continue
        try:
            with open(os.path.join(dirname, n)) as f:
                last = float(f.read().strip() or 0)
        except (OSError, ValueError):
            last = 0.0
        if now - last > timeout:
            failed.append(n[:-3])
    return failed


class FailureMonitor:
    """Heartbeat + stale-peer detection packaged for ``Trainer.train``.

    Owns this trainer's :class:`Heartbeat` and scans the heartbeat dir for
    peers whose beat is older than ``timeout``.  ``poll()`` is cheap
    enough to call every step: the directory scan runs at most once per
    ``check_every`` seconds (default: the heartbeat interval) and the
    result is cached in between.  This trainer's own id is never reported
    failed."""

    def __init__(self, dirname, trainer_id="trainer0", interval=1.0,
                 timeout=10.0, check_every=None):
        self.dirname = dirname
        self.trainer_id = str(trainer_id)
        self.timeout = float(timeout)
        self.check_every = float(interval if check_every is None else check_every)
        self.heartbeat = Heartbeat(dirname, trainer_id, interval)
        self._started = False
        self._last_check = 0.0
        self.failed_peers = []

    def start(self):
        if not self._started:
            self._started = True
            self.heartbeat.start()
        return self

    def poll(self, now=None):
        """Failed peer ids (cached between scans); [] while healthy."""
        now = time.time() if now is None else now
        if now - self._last_check < self.check_every:
            return self.failed_peers
        self._last_check = now
        self.failed_peers = [
            t for t in detect_failed_trainers(self.dirname, self.timeout)
            if t != self.trainer_id
        ]
        return self.failed_peers

    def stop(self):
        if self._started:
            self._started = False
            self.heartbeat.stop()
