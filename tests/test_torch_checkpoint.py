"""The port's fault-tolerant training runtime (``paddle_tpu_torch.trainer``)
on the CPU: the 25 cases of ``tests/unittests/test_fault_tolerance.py``
that are not about the compile cache (the port has none: a CUDA graph
cannot be saved), driven by the port's fault harness
(``paddle_tpu_torch.testing.faults``) — atomic manifest-verified
checkpoints, torn-write fallback, bitwise-identical auto-resume, the
NaN/Inf step guard with rewind, transient-IO retry, heartbeat failure
detection.  The port saves its ``(seed, step)`` random state as
``rng_state.npy`` where the JAX package saves ``rng_key.npy``.  Then the
on-disk format across packages: a JAX-written checkpoint loads into the
port and a port-written one into the JAX package, parameters bitwise
either way; and a bfloat16 state survives a save and a resume bitwise."""
import json
import os
import time
import warnings

import numpy as np
import pytest

import paddle_tpu_torch as fluid
from paddle_tpu_torch.testing import faults
from paddle_tpu_torch.trainer import (
    FailureMonitor,
    Heartbeat,
    _rotate_checkpoints,
    _serials,
    detect_failed_trainers,
    load_checkpoint,
    save_checkpoint,
)


def _train_func():
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    pred = fluid.layers.fc(input=x, size=1, param_attr=fluid.ParamAttr(name="w"))
    return fluid.layers.mean(fluid.layers.square_error_cost(input=pred, label=y))


def _optimizer_func():
    return fluid.optimizer.SGD(learning_rate=0.05)


def _reader():
    rng = np.random.RandomState(0)
    w = np.array([[1.0], [2.0], [-1.0], [0.5]], "float32")
    for _ in range(8):
        x = rng.randn(16, 4).astype("float32")
        yield list(zip(x, x @ w))


def _make_trainer(cdir=None, step_interval=2, max_num=5, seed=7, **kw):
    cfg = None
    if cdir is not None:
        cfg = fluid.CheckpointConfig(
            checkpoint_dir=cdir, max_num_checkpoints=max_num,
            step_interval=step_interval)
    np.random.seed(seed)  # pins the startup init draw across runs
    return fluid.Trainer(_train_func, _optimizer_func, place=fluid.CPUPlace(),
                         checkpoint_config=cfg, **kw)


def _params(t):
    return np.asarray(t.scope.vars["w"]).copy()


def _corrupt(path, offset=None):
    data = bytearray(open(path, "rb").read())
    data[(len(data) // 2) if offset is None else offset] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(data))


# ---------------------------------------------------------------------------
# atomic checkpoints + manifest validation
# ---------------------------------------------------------------------------


def test_checkpoint_writes_manifest(tmp_path):
    cdir = str(tmp_path / "ckpt")
    t = _make_trainer(cdir, step_interval=4)
    t.train(num_epochs=1, reader=_reader, feed_order=["x", "y"])
    serial = _serials(cdir)[-1]
    d = os.path.join(cdir, "checkpoint_%d" % serial)
    man = json.loads(open(os.path.join(d, "MANIFEST.json")).read())
    assert set(man["files"]) == {"params.npz", "meta.json", "rng_state.npy"}
    for name, info in man["files"].items():
        assert os.path.getsize(os.path.join(d, name)) == info["size"]
    assert man["serial"] == serial
    # no staging leftovers after a clean save
    assert not [n for n in os.listdir(cdir) if n.endswith(".tmp")]


def test_torn_write_leaves_previous_latest_intact(tmp_path):
    cdir = str(tmp_path / "ckpt")
    t = _make_trainer(cdir, step_interval=4)
    t.train(num_epochs=1, reader=_reader, feed_order=["x", "y"])
    w_latest = _params(t)
    latest = _serials(cdir)[-1]

    with faults.torn_write("checkpoint_9", at_byte=64):
        with pytest.raises(IOError):
            with fluid.scope_guard(t.scope):
                save_checkpoint(t.exe, cdir, t.train_program, 9,
                                {"epoch": 0, "step": 5})
    # the kill hit the staging dir: serial 9 was never published
    assert _serials(cdir)[-1] == latest
    t2 = _make_trainer(cdir, step_interval=4)
    assert t2._serial_start == latest
    np.testing.assert_array_equal(_params(t2), w_latest)


def test_load_falls_back_to_newest_intact(tmp_path):
    cdir = str(tmp_path / "ckpt")
    t = _make_trainer(cdir, step_interval=2)
    t.train(num_epochs=1, reader=_reader, feed_order=["x", "y"])
    serials = _serials(cdir)
    assert len(serials) >= 3
    _corrupt(os.path.join(cdir, "checkpoint_%d" % serials[-1], "params.npz"))

    with fluid.scope_guard(fluid.Scope()):
        with pytest.warns(UserWarning, match="corrupt checkpoint"):
            meta = load_checkpoint(t.exe, cdir, t.train_program)
    assert meta["serial"] == serials[-2]


def test_load_skips_manifest_garbage(tmp_path):
    cdir = str(tmp_path / "ckpt")
    t = _make_trainer(cdir, step_interval=2)
    t.train(num_epochs=1, reader=_reader, feed_order=["x", "y"])
    serials = _serials(cdir)
    with open(os.path.join(cdir, "checkpoint_%d" % serials[-1],
                           "MANIFEST.json"), "w") as f:
        f.write("{not json")
    with fluid.scope_guard(fluid.Scope()):
        with pytest.warns(UserWarning, match="corrupt checkpoint"):
            meta = load_checkpoint(t.exe, cdir, t.train_program)
    assert meta["serial"] == serials[-2]


def test_load_explicit_missing_serial_lists_available(tmp_path):
    cdir = str(tmp_path / "ckpt")
    t = _make_trainer(cdir, step_interval=4)
    t.train(num_epochs=1, reader=_reader, feed_order=["x", "y"])
    import re

    available = _serials(cdir)
    with pytest.raises(IOError,
                       match=re.escape("available serials: %s" % available)):
        load_checkpoint(t.exe, cdir, t.train_program, serial=777)


def test_load_explicit_corrupt_serial_raises(tmp_path):
    cdir = str(tmp_path / "ckpt")
    t = _make_trainer(cdir, step_interval=4)
    t.train(num_epochs=1, reader=_reader, feed_order=["x", "y"])
    s = _serials(cdir)[-1]
    _corrupt(os.path.join(cdir, "checkpoint_%d" % s, "params.npz"))
    with pytest.raises(IOError, match="corrupt"):
        with fluid.scope_guard(fluid.Scope()):
            load_checkpoint(t.exe, cdir, t.train_program, serial=s)


def test_failed_load_leaves_scope_untouched(tmp_path):
    """A checkpoint that validates but is missing a persistable (e.g. saved
    by an older program revision) must not half-overwrite the scope."""
    import zlib

    cdir = str(tmp_path / "ckpt")
    t = _make_trainer(cdir, step_interval=4)
    t.train(num_epochs=1, reader=_reader, feed_order=["x", "y"])
    s = _serials(cdir)[-1]
    d = os.path.join(cdir, "checkpoint_%d" % s)
    # rewrite params.npz without "w" and keep the manifest consistent, so
    # only the completeness check can catch it
    from io import BytesIO

    data = dict(np.load(os.path.join(d, "params.npz")))
    del data["w"]
    buf = BytesIO()
    np.savez(buf, **data)
    blob = buf.getvalue()
    with open(os.path.join(d, "params.npz"), "wb") as f:
        f.write(blob)
    man = json.loads(open(os.path.join(d, "MANIFEST.json")).read())
    man["files"]["params.npz"] = {"size": len(blob),
                                  "crc32": zlib.crc32(blob) & 0xFFFFFFFF}
    with open(os.path.join(d, "MANIFEST.json"), "w") as f:
        f.write(json.dumps(man))

    scope = fluid.Scope()
    sentinel = np.full((4, 1), 7.5, "float32")
    scope["w"] = sentinel.copy()
    scope["__rng_key__"] = (1, 2)
    with fluid.scope_guard(scope):
        with pytest.raises(IOError, match="missing persistable"):
            load_checkpoint(t.exe, cdir, t.train_program, serial=s)
    np.testing.assert_array_equal(np.asarray(scope["w"]), sentinel)
    assert scope["__rng_key__"] == (1, 2)


def test_rotation_never_deletes_last_known_good(tmp_path):
    cdir = str(tmp_path / "ckpt")
    t = _make_trainer(cdir, step_interval=2, max_num=10)
    t.train(num_epochs=1, reader=_reader, feed_order=["x", "y"])
    serials = _serials(cdir)
    assert len(serials) >= 3
    good = serials[0]
    for s in serials[1:]:
        _corrupt(os.path.join(cdir, "checkpoint_%d" % s, "params.npz"))
    # aggressive rotation would normally keep only the newest serial, but
    # every newer one is corrupt — the oldest (intact) must survive
    _rotate_checkpoints(cdir, max_num=1)
    kept = _serials(cdir)
    assert good in kept
    assert kept[-1] == serials[-1]  # the kept window is still there too


def test_transient_io_error_during_save_retries(tmp_path):
    cdir = str(tmp_path / "ckpt")
    t = _make_trainer(cdir, step_interval=4)
    t.train(num_epochs=1, reader=_reader, feed_order=["x", "y"])
    with faults.flaky_io("params.npz", times=2) as fired:
        with fluid.scope_guard(t.scope):
            save_checkpoint(t.exe, cdir, t.train_program, 9,
                            {"epoch": 1, "step": 0})
    assert fired[0] == 2  # the fault really fired; retry absorbed it
    with fluid.scope_guard(fluid.Scope()):
        meta = load_checkpoint(t.exe, cdir, t.train_program)
    assert meta["serial"] == 9


# ---------------------------------------------------------------------------
# auto-resume
# ---------------------------------------------------------------------------


def test_resume_bitwise_identical_after_crash(tmp_path):
    """Kill training mid-epoch, corrupt the newest checkpoint (as a torn
    write would), restart with resume=True: the continued run must be
    bitwise-identical to an uninterrupted one — params, step counter and
    rng key all restored from the newest INTACT serial."""
    t_ref = _make_trainer(None)
    t_ref.train(num_epochs=1, reader=_reader, feed_order=["x", "y"])
    w_ref = _params(t_ref)

    cdir = str(tmp_path / "ckpt")
    t1 = _make_trainer(cdir, step_interval=2)

    def stop_after_5(e):
        if isinstance(e, fluid.EndStepEvent) and e.step == 4:
            t1.stop()

    t1.train(num_epochs=1, event_handler=stop_after_5, reader=_reader,
             feed_order=["x", "y"])
    serials = _serials(cdir)
    assert serials == [1, 2]
    # saved rng key == the live key at checkpoint time is what makes the
    # replayed steps draw the identical randomness stream
    _corrupt(os.path.join(cdir, "checkpoint_2", "params.npz"))

    with pytest.warns(UserWarning, match="corrupt checkpoint"):
        t2 = _make_trainer(cdir, step_interval=2)
    assert (t2._epoch_start, t2._step_start, t2._serial_start) == (0, 2, 1)
    saved_key = np.load(os.path.join(cdir, "checkpoint_1", "rng_state.npy"))
    np.testing.assert_array_equal(
        np.asarray(t2.scope.vars["__rng_key__"]), saved_key)

    executed = []
    t2.train(num_epochs=1, reader=_reader, feed_order=["x", "y"],
             event_handler=lambda e: executed.append(e.step)
             if isinstance(e, fluid.EndStepEvent) else None)
    assert executed == list(range(2, 8))
    assert _params(t2).tobytes() == w_ref.tobytes()


def test_resume_false_starts_fresh(tmp_path):
    cdir = str(tmp_path / "ckpt")
    t1 = _make_trainer(cdir, step_interval=2)
    t1.train(num_epochs=1, reader=_reader, feed_order=["x", "y"])
    t2 = _make_trainer(cdir, step_interval=2, resume=False)
    assert (t2._epoch_start, t2._step_start, t2._serial_start) == (0, 0, 0)
    assert _params(t2).tobytes() != _params(t1).tobytes()


def test_resume_pinned_serial_failure_raises(tmp_path):
    """An explicitly pinned load_serial that can't be loaded must raise —
    silently training from scratch would rotate away the checkpoints the
    user was trying to restore."""
    cdir = str(tmp_path / "ckpt")
    t1 = _make_trainer(cdir, step_interval=4)
    t1.train(num_epochs=1, reader=_reader, feed_order=["x", "y"])
    cfg = fluid.CheckpointConfig(checkpoint_dir=cdir, max_num_checkpoints=5,
                                 step_interval=4)
    cfg.load_serial = 777
    np.random.seed(7)
    with pytest.raises(IOError, match="not found"):
        fluid.Trainer(_train_func, _optimizer_func, place=fluid.CPUPlace(),
                      checkpoint_config=cfg)


def test_resume_survives_all_serials_corrupt(tmp_path):
    cdir = str(tmp_path / "ckpt")
    t1 = _make_trainer(cdir, step_interval=4)
    t1.train(num_epochs=1, reader=_reader, feed_order=["x", "y"])
    for s in _serials(cdir):
        _corrupt(os.path.join(cdir, "checkpoint_%d" % s, "params.npz"))
    with pytest.warns(UserWarning, match="auto-resume skipped"):
        t2 = _make_trainer(cdir, step_interval=4)
    assert (t2._epoch_start, t2._step_start) == (0, 0)


# ---------------------------------------------------------------------------
# NaN/Inf step guard
# ---------------------------------------------------------------------------


def test_nan_guard_skips_bad_step_bitwise(tmp_path):
    t = _make_trainer(None)
    ws, losses = [], []

    def grab(e):
        if isinstance(e, fluid.EndStepEvent):
            ws.append(_params(t))
            losses.append(float(np.ravel(np.asarray(e.metrics[0]))[0]))

    with faults.nan_feeds(at_steps=[2]):
        t.train(num_epochs=1, event_handler=grab, reader=_reader,
                feed_order=["x", "y"], nan_guard=True)
    # the poisoned step: loss went NaN on device, update skipped bitwise
    assert np.isnan(losses[2])
    assert ws[2].tobytes() == ws[1].tobytes()
    # training continued with finite steps afterwards
    assert ws[3].tobytes() != ws[2].tobytes()
    assert np.isfinite(losses[3])
    assert t.nan_bad_steps == 1 and t.nan_rewinds == 0


def test_nan_guard_rewinds_after_consecutive_failures(tmp_path):
    cdir = str(tmp_path / "ckpt")
    t = _make_trainer(cdir, step_interval=1)
    with faults.nan_feeds(at_steps=[3, 4]):
        with pytest.warns(UserWarning, match="rewound"):
            t.train(num_epochs=1, reader=_reader, feed_order=["x", "y"],
                    nan_guard=2)
    assert t.nan_bad_steps == 2
    assert t.nan_rewinds == 1
    assert np.isfinite(_params(t)).all()


def test_nan_guard_without_checkpoint_raises_on_rewind():
    t = _make_trainer(None)
    with faults.nan_feeds(at_steps=[1, 2]):
        with pytest.raises(FloatingPointError, match="no checkpoint"):
            t.train(num_epochs=1, reader=_reader, feed_order=["x", "y"],
                    nan_guard=2)


def test_nan_guard_off_has_no_verdict_and_poison_propagates():
    t = _make_trainer(None)
    ws = []

    def grab(e):
        if isinstance(e, fluid.EndStepEvent):
            ws.append(_params(t))

    with faults.nan_feeds(at_steps=[2]):
        t.train(num_epochs=1, event_handler=grab, reader=_reader,
                feed_order=["x", "y"])
    assert t.exe.last_step_ok() is None  # no guard: no verdict, no extras
    assert np.isnan(ws[2]).any()  # and the NaN really poisoned the params


def test_nan_guard_matches_unguarded_numerics_bitwise():
    """With no NaN present, the guard's select must be a bitwise no-op on
    the trained parameters (CPU-deterministic)."""

    def run(guard):
        t = _make_trainer(None)
        t.train(num_epochs=1, reader=_reader, feed_order=["x", "y"],
                nan_guard=guard)
        ok = t.exe.last_step_ok()
        return _params(t), ok

    w_off, ok_off = run(False)
    w_on, ok_on = run(True)
    assert w_on.tobytes() == w_off.tobytes()
    assert ok_off is None and ok_on is True


def test_nan_guard_noop_on_stateless_step():
    """A step that writes no state (eval/inference) has no update to skip:
    the guard emits nothing — no verdict, zero extra outputs — so guarded
    eval dispatch costs nothing."""
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.unique_name.guard():
        with fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
            out = fluid.layers.fc(x, size=1)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
        for _ in range(3):  # slow path, then the bound fast path
            res = exe.run(main, feed={"x": np.ones((2, 4), "float32")},
                          fetch_list=[out], nan_guard=True)
        assert len(res) == 1
        assert exe.last_step_ok() is None


def test_nan_guard_direct_executor_api():
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.unique_name.guard():
        with fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
            loss = fluid.layers.mean(fluid.layers.fc(x, size=1))
            fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    feed = {"x": np.ones((2, 4), "float32")}
    with fluid.scope_guard(scope):
        exe.run(startup)
        out = exe.run(main, feed=feed, fetch_list=[loss], nan_guard=True)
        assert exe.last_step_ok() is True
        assert len(out) == 1  # the verdict pseudo-fetch never leaks out
        bad = {"x": np.full((2, 4), np.nan, "float32")}
        exe.run(main, feed=bad, fetch_list=[loss], nan_guard=True)
        assert exe.last_step_ok() is False
        exe.run(main, feed=feed, fetch_list=[loss])
        assert exe.last_step_ok() is None


# ---------------------------------------------------------------------------
# Heartbeat / detect_failed_trainers / FailureMonitor
# ---------------------------------------------------------------------------


def test_heartbeat_stale_vs_fresh(tmp_path):
    d = str(tmp_path / "hb")
    hb = Heartbeat(d, "alive", interval=0.1).start()
    with open(os.path.join(d, "dead.hb"), "w") as f:
        f.write(str(time.time() - 100))
    time.sleep(0.3)
    # "dead" must ALWAYS be detected; "alive" may flicker stale on a
    # loaded shared box (the beat thread starved past the 5s timeout) —
    # retry until it beats again rather than flaking on scheduler noise
    deadline = time.time() + 10
    while True:
        failed = detect_failed_trainers(d, timeout=5.0)
        assert "dead" in failed, failed
        if failed == ["dead"] or time.time() >= deadline:
            break
        time.sleep(0.2)
    assert failed == ["dead"]
    hb.stop()


def test_heartbeat_clean_stop_is_idempotent(tmp_path):
    d = str(tmp_path / "hb")
    hb = Heartbeat(d, "t0", interval=0.05).start()
    time.sleep(0.2)
    hb.stop()
    content = open(hb.path).read()
    time.sleep(0.2)
    assert open(hb.path).read() == content  # no beats after stop
    hb.stop()  # second stop is a no-op
    # stop() without start() must not blow up either
    Heartbeat(d, "never_started", interval=0.05).stop()


def test_detect_failed_trainers_edge_cases(tmp_path):
    d = str(tmp_path / "hb")
    assert detect_failed_trainers(d, timeout=1.0) == []  # missing dir
    os.makedirs(d)
    with open(os.path.join(d, "garbage.hb"), "w") as f:
        f.write("not a float")
    with open(os.path.join(d, "ignored.txt"), "w") as f:
        f.write(str(time.time() - 100))
    with open(os.path.join(d, "fresh.hb"), "w") as f:
        f.write(str(time.time()))
    # unparseable heartbeat counts as dead-forever; non-.hb files ignored;
    # a fresh beat within the timeout window is healthy
    assert detect_failed_trainers(d, timeout=60.0) == ["garbage"]
    # a beat older than a tiny timeout is stale
    with open(os.path.join(d, "slow.hb"), "w") as f:
        f.write(str(time.time() - 0.5))
    assert set(detect_failed_trainers(d, timeout=0.1)) == {"garbage", "slow"}


def test_failure_monitor_poll_interval_and_self_exclusion(tmp_path):
    d = str(tmp_path / "hb")
    os.makedirs(d)
    # this trainer's own beat is ancient — poll must never report self
    with open(os.path.join(d, "me.hb"), "w") as f:
        f.write(str(time.time() - 100))
    mon = FailureMonitor(d, trainer_id="me", interval=0.1, timeout=1.0,
                         check_every=100.0)
    t0 = time.time()
    assert mon.poll(now=t0) == []
    with open(os.path.join(d, "peer.hb"), "w") as f:
        f.write(str(time.time() - 100))
    assert mon.poll(now=t0 + 1) == []  # cached: within check_every
    assert mon.poll(now=t0 + 200) == ["peer"]  # rescans after the window
    mon.stop()  # never started: no-op


def test_failure_monitor_checkpoint_then_stop(tmp_path):
    """A stale peer heartbeat makes the train loop save a final checkpoint
    and stop cleanly instead of hanging."""
    hb_dir = str(tmp_path / "hb")
    cdir = str(tmp_path / "ckpt")
    os.makedirs(hb_dir)
    with open(os.path.join(hb_dir, "trainer1.hb"), "w") as f:
        f.write(str(time.time() - 100))
    t = _make_trainer(cdir, step_interval=100)  # no periodic checkpoints
    mon = FailureMonitor(hb_dir, trainer_id="trainer0", interval=0.05,
                         timeout=1.0, check_every=0.0)
    steps = []
    t.train(num_epochs=4, reader=_reader, feed_order=["x", "y"],
            event_handler=lambda e: steps.append(e.step)
            if isinstance(e, fluid.EndStepEvent) else None,
            failure_monitor=mon)
    assert mon.failed_peers == ["trainer1"]
    assert steps == []  # detected before the first step ran
    assert _serials(cdir) == [1]  # the checkpoint-then-stop artifact
    assert not mon._started  # train() stopped the monitor
    meta = json.loads(open(os.path.join(
        cdir, "checkpoint_1", "meta.json")).read())
    assert meta == {"epoch": 0, "step": 0}  # resume replays the unrun step


# ---------------------------------------------------------------------------
# the on-disk format across packages, and a bfloat16 state
# ---------------------------------------------------------------------------


def _adam_train_func(fl):
    def train_func():
        x = fl.layers.data(name="x", shape=[4], dtype="float32")
        y = fl.layers.data(name="y", shape=[1], dtype="float32")
        h = fl.layers.fc(input=x, size=8, act="relu")
        pred = fl.layers.fc(input=h, size=1)
        return fl.layers.mean(fl.layers.square_error_cost(input=pred, label=y))
    return train_func


def _persistables(trainer):
    """Every persistable of the trainer's program, as numpy (bfloat16
    widened to float32)."""
    out = {}
    for n in trainer.train_program.persistable_names():
        if n not in trainer.scope:
            continue
        v = trainer.scope[n]
        out[n] = (v.float().numpy() if hasattr(v, "numpy")
                  and str(v.dtype) == "torch.bfloat16" else np.asarray(v))
    return out


def _assert_float_state_bitwise(got, want):
    floats = [n for n in want if np.issubdtype(np.asarray(want[n]).dtype,
                                               np.floating)]
    assert floats and set(floats) <= set(got)
    for n in floats:
        a, b = np.asarray(got[n]), np.asarray(want[n])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), n
    for n in set(want) - set(floats):  # int64 counters: int32 in the JAX one
        np.testing.assert_array_equal(np.asarray(got[n]), np.asarray(want[n]))


def test_jax_checkpoint_loads_into_port_bitwise(tmp_path):
    import paddle_tpu as jfluid

    cdir = str(tmp_path / "ckpt")
    np.random.seed(3)
    jt = jfluid.Trainer(
        _adam_train_func(jfluid),
        lambda: jfluid.optimizer.Adam(learning_rate=0.01),
        place=jfluid.CPUPlace(),
        checkpoint_config=jfluid.CheckpointConfig(
            checkpoint_dir=cdir, step_interval=3))
    jt.train(num_epochs=1, reader=_reader, feed_order=["x", "y"])
    serial = _serials(cdir)[-1]
    assert os.path.exists(os.path.join(cdir, "checkpoint_%d" % serial,
                                       "rng_key.npy"))
    with pytest.warns(UserWarning, match="rng_key.npy"):
        tt = fluid.Trainer(
            _adam_train_func(fluid),
            lambda: fluid.optimizer.Adam(learning_rate=0.01),
            place=fluid.CPUPlace(),
            checkpoint_config=fluid.CheckpointConfig(
                checkpoint_dir=cdir, step_interval=3))
    assert tt._serial_start == serial
    want = {n: np.asarray(jt.scope.vars[n])
            for n in jt.train_program.persistable_names()}
    _assert_float_state_bitwise(_persistables(tt), want)
    # the port keeps its own (seed, step) random state
    assert isinstance(tt.scope["__rng_key__"], tuple)


def test_port_checkpoint_loads_into_jax_bitwise(tmp_path):
    import paddle_tpu as jfluid

    cdir = str(tmp_path / "ckpt")
    np.random.seed(4)
    tt = fluid.Trainer(
        _adam_train_func(fluid),
        lambda: fluid.optimizer.Adam(learning_rate=0.01),
        place=fluid.CPUPlace(),
        checkpoint_config=fluid.CheckpointConfig(
            checkpoint_dir=cdir, step_interval=3))
    tt.train(num_epochs=1, reader=_reader, feed_order=["x", "y"])
    serial = _serials(cdir)[-1]
    man = json.loads(open(os.path.join(
        cdir, "checkpoint_%d" % serial, "MANIFEST.json")).read())
    assert man["format"] == 1 and "rng_key.npy" not in man["files"]
    jt = jfluid.Trainer(
        _adam_train_func(jfluid),
        lambda: jfluid.optimizer.Adam(learning_rate=0.01),
        place=jfluid.CPUPlace(),
        checkpoint_config=jfluid.CheckpointConfig(
            checkpoint_dir=cdir, step_interval=3))
    assert jt._serial_start == serial
    got = {n: np.asarray(jt.scope.vars[n])
           for n in jt.train_program.persistable_names()}
    _assert_float_state_bitwise(got, _persistables(tt))


def _bf16_train_func():
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    h = fluid.layers.fc(input=fluid.layers.cast(x, "bfloat16"), size=8,
                        act="relu")
    pred = fluid.layers.cast(fluid.layers.fc(input=h, size=1), "float32")
    return fluid.layers.mean(fluid.layers.square_error_cost(input=pred, label=y))


def test_bf16_state_survives_save_and_resume_bitwise(tmp_path):
    """bfloat16 parameters leave the scope widened to float32
    (``as_numpy``) and come back as bfloat16 when the state is
    collected: a resumed run's state and its next steps are bitwise the
    uninterrupted run's."""
    import torch

    def make(cdir):
        np.random.seed(9)
        return fluid.Trainer(
            _bf16_train_func, lambda: fluid.optimizer.Adam(learning_rate=0.01),
            place=fluid.CPUPlace(),
            checkpoint_config=fluid.CheckpointConfig(
                checkpoint_dir=cdir, max_num_checkpoints=5, step_interval=4))

    def state(t):
        return {n: t.scope[n].clone() for n in t.train_program.persistable_names()
                if n in t.scope}

    cdir = str(tmp_path / "ckpt")
    t1 = make(cdir)
    snaps = {}

    def grab(e):
        if isinstance(e, fluid.EndStepEvent) and e.step in (3, 7):
            snaps[e.step] = state(t1)

    t1.train(num_epochs=1, reader=_reader, feed_order=["x", "y"],
             event_handler=grab)
    assert any(v.dtype == torch.bfloat16 for v in snaps[3].values())
    cfg = fluid.CheckpointConfig(checkpoint_dir=cdir, max_num_checkpoints=5,
                                 step_interval=4)
    cfg.load_serial = 1   # the checkpoint after step 4
    np.random.seed(9)
    t2 = fluid.Trainer(
        _bf16_train_func, lambda: fluid.optimizer.Adam(learning_rate=0.01),
        place=fluid.CPUPlace(), checkpoint_config=cfg)
    assert t2._step_start == 4
    with fluid.scope_guard(t2.scope):
        # the loaded numpy comes back in the declared dtypes at the next run
        t2.exe._collect_state(t2.train_program, t2.scope)
    for n, v in snaps[3].items():
        got = t2.scope[n]
        assert got.dtype == v.dtype, n
        assert got.view(-1).view(torch.uint8).equal(
            v.view(-1).view(torch.uint8)), n
    t2.train(num_epochs=1, reader=_reader, feed_order=["x", "y"])
    for n, v in snaps[7].items():
        got = t2.scope[n]
        assert got.dtype == v.dtype and got.view(-1).view(torch.uint8).equal(
            v.view(-1).view(torch.uint8)), n
