#!/usr/bin/env python
"""Gate for the port's fault-tolerant training runtime: run the two
headline fault-injection scenarios end to end on the CPU and fail loudly
on any regression.  The port's counterpart of ``tools/check_resilience.py``,
both of its scenarios.

Scenario 1 — torn checkpoint write + auto-resume:
  train with periodic checkpoints, stop mid-run, kill a checkpoint write
  at an arbitrary byte offset (nothing is published), corrupt the newest
  published serial, then restart the Trainer with resume on.  It must
  resume from the newest intact serial (serial 1: epoch 0, step 2) with
  that serial's step random state, the port's ``(seed, step)`` pair from
  ``rng_state.npy``, and continue BITWISE-identically to a run that was
  never interrupted.

Scenario 2 — NaN step guard:
  inject a NaN feed at step 2 with ``nan_guard`` on.  The bad step's
  update must be skipped (parameters bitwise unchanged), training must
  go on finitely, with the guard off there is no verdict, and on a clean
  run the guard changes no bit.

Every Trainer's startup draws its initial parameters from the program's
own seed (``random_seed``), so that runs start from the same state.

Runnable locally (the port only: no jax is imported):
    python tools/check_resilience_torch.py
and run under pytest by tests/test_torch_resilience_gate.py.

Exit code 0 = every scenario held.
"""
import os
import sys
import tempfile
import warnings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

SEED = 7


def _train_func():
    import paddle_tpu_torch as fluid

    fluid.default_startup_program().random_seed = SEED
    fluid.default_main_program().random_seed = SEED
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    pred = fluid.layers.fc(input=x, size=1, param_attr=fluid.ParamAttr(name="w"))
    return fluid.layers.mean(fluid.layers.square_error_cost(input=pred, label=y))


def _optimizer_func():
    import paddle_tpu_torch as fluid

    return fluid.optimizer.SGD(learning_rate=0.05)


def _reader():
    rng = np.random.RandomState(0)
    w = np.array([[1.0], [2.0], [-1.0], [0.5]], "float32")
    for _ in range(8):
        x = rng.randn(16, 4).astype("float32")
        yield list(zip(x, x @ w))


def _make_trainer(cdir=None, step_interval=2):
    import paddle_tpu_torch as fluid

    cfg = None
    if cdir is not None:
        cfg = fluid.CheckpointConfig(checkpoint_dir=cdir,
                                     max_num_checkpoints=5,
                                     step_interval=step_interval)
    return fluid.Trainer(_train_func, _optimizer_func, place=fluid.CPUPlace(),
                         checkpoint_config=cfg)


def _params(t):
    return np.asarray(t.scope.vars["w"]).copy()


def scenario_torn_checkpoint_resume():
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.testing import faults
    from paddle_tpu_torch.trainer import RNG_STATE_NAME, _serials, save_checkpoint

    t_ref = _make_trainer(None)
    t_ref.train(num_epochs=1, reader=_reader, feed_order=["x", "y"])
    w_ref = _params(t_ref)
    assert _params(_make_trainer(None)).tobytes() == _params(
        _make_trainer(None)).tobytes(), "the startup's seed does not pin its draw"

    with tempfile.TemporaryDirectory() as td:
        cdir = os.path.join(td, "ckpt")
        t1 = _make_trainer(cdir)

        def stop_mid(e):
            if isinstance(e, fluid.EndStepEvent) and e.step == 4:
                t1.stop()

        t1.train(num_epochs=1, event_handler=stop_mid, reader=_reader,
                 feed_order=["x", "y"])
        assert _serials(cdir) == [1, 2], _serials(cdir)

        # kill the next checkpoint write at an arbitrary byte offset: the
        # staging dir takes the hit, nothing is published
        killed = False
        try:
            with faults.torn_write("checkpoint_9", at_byte=97):
                with fluid.scope_guard(t1.scope):
                    save_checkpoint(t1.exe, cdir, t1.train_program, 9,
                                    {"epoch": 0, "step": 5})
        except IOError:
            killed = True
        assert killed, "torn write did not raise"
        assert _serials(cdir) == [1, 2], "torn serial was published: %s" % _serials(cdir)

        # corrupt the newest published serial too (bit flip mid-file)
        p = os.path.join(cdir, "checkpoint_2", "params.npz")
        blob = bytearray(open(p, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        with open(p, "wb") as f:
            f.write(bytes(blob))

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            t2 = _make_trainer(cdir)
        assert (t2._epoch_start, t2._step_start, t2._serial_start) == (0, 2, 1), (
            "resume position wrong: %s"
            % ((t2._epoch_start, t2._step_start, t2._serial_start),))
        saved = np.load(os.path.join(cdir, "checkpoint_1", RNG_STATE_NAME))
        assert saved.dtype == np.int64 and saved.shape == (2,), saved
        assert int(saved[0]) == SEED, "rng state seed %d, not the program's" % saved[0]
        assert tuple(t2.scope.vars["__rng_key__"]) == tuple(int(v) for v in saved), (
            "rng state not restored: %s vs saved %s"
            % (t2.scope.vars["__rng_key__"], saved))
        t2.train(num_epochs=1, reader=_reader, feed_order=["x", "y"])
        assert _params(t2).tobytes() == w_ref.tobytes(), (
            "resumed training diverged from the uninterrupted run")
    return "torn-checkpoint resume: bitwise-identical continuation OK"


def scenario_nan_guard():
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.testing import faults

    t = _make_trainer(None)
    ws, losses = [], []

    def grab(e):
        if isinstance(e, fluid.EndStepEvent):
            ws.append(_params(t))
            losses.append(float(np.ravel(np.asarray(e.metrics[0]))[0]))

    with faults.nan_feeds(at_steps=[2]):
        t.train(num_epochs=1, event_handler=grab, reader=_reader,
                feed_order=["x", "y"], nan_guard=True)
    assert np.isnan(losses[2]), "injected NaN never reached the loss"
    assert ws[2].tobytes() == ws[1].tobytes(), (
        "NaN step was NOT skipped: parameters changed")
    assert ws[3].tobytes() != ws[2].tobytes(), "training did not continue"
    assert np.isfinite(ws[-1]).all(), "parameters poisoned despite guard"
    assert t.nan_bad_steps == 1, t.nan_bad_steps

    # guard off: no verdict, and the guarded run's numerics match the
    # unguarded run bitwise when no NaN is present
    t_off = _make_trainer(None)
    t_off.train(num_epochs=1, reader=_reader, feed_order=["x", "y"])
    assert t_off.exe.last_step_ok() is None, "guard-off run produced a verdict"
    t_on = _make_trainer(None)
    t_on.train(num_epochs=1, reader=_reader, feed_order=["x", "y"],
               nan_guard=True)
    assert _params(t_on).tobytes() == _params(t_off).tobytes(), (
        "nan_guard changed clean-run numerics")
    return "nan-guard: bad step skipped bitwise, clean run unchanged OK"


def main():
    failures = []
    for scenario in (scenario_torn_checkpoint_resume, scenario_nan_guard):
        try:
            msg = scenario()
        except AssertionError as e:
            failures.append("%s FAILED: %s" % (scenario.__name__, e))
        else:
            print(msg)
    if failures:
        for f in failures:
            sys.stderr.write(f + "\n")
        sys.stderr.write("\nresilience gate FAILED\n")
        return 1
    print("resilience gate OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
