"""The port's Trainer and Inferencer (``paddle_tpu_torch.trainer``) on the
CPU, against the JAX package's.

The five single-device cases of ``tests/unittests/test_trainer.py``
(event flow and convergence, checkpoint rotation and resume, the
Inferencer round trip, heartbeat failure detection, a mid-epoch resume)
run on the port, and the event sequence and the losses are held against
the JAX Trainer's from the same parameters (the port starts from the
JAX trainer's ``save_params`` through ``param_path``): losses within
LOSS_RTOL.  Then a Transformer at 2 layers, d_model 32, vocab 64, batch
4 x 16, dropout 0, ``use_flash=True`` (the JAX package's flash kernels in
Pallas interpret mode, the port's plain versions) trains four steps
through both Trainers from the same parameters, losses within LOSS_RTOL
(the limit of ``test_torch_transformer_train.py``: float32 sums in
another order).  The deferred pieces raise, naming their ROADMAP item.
"""
import os
import time

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu.models import transformer as JT
from paddle_tpu_torch.models import transformer as TT

LOSS_RTOL = 1e-5
TSMALL = dict(src_vocab_size=64, trg_vocab_size=64, max_length=16,
              n_layer=2, n_head=2, d_model=32, d_inner=64, dropout=0.0,
              use_flash=True)
TBATCH, TSEQ, TSTEPS = 4, 16, 4


def _train_func_of(fl):
    def train_func():
        x = fl.layers.data(name="x", shape=[4], dtype="float32")
        y = fl.layers.data(name="y", shape=[1], dtype="float32")
        pred = fl.layers.fc(input=x, size=1, param_attr=fl.ParamAttr(name="w"))
        loss = fl.layers.mean(fl.layers.square_error_cost(input=pred, label=y))
        return loss
    return train_func


_train_func = _train_func_of(fluid)


def _infer_func():
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    return fluid.layers.fc(input=x, size=1, param_attr=fluid.ParamAttr(name="w"))


def _optimizer_func():
    return fluid.optimizer.SGD(learning_rate=0.05)


def _reader():
    rng = np.random.RandomState(0)
    w = np.array([[1.0], [2.0], [-1.0], [0.5]], "float32")
    for _ in range(8):
        x = rng.randn(16, 4).astype("float32")
        yield list(zip(x, x @ w))


def _run_both(tmp_path, num_epochs=4):
    """The JAX Trainer and the port's from the JAX trainer's initial
    parameters: (event names, losses) of each."""
    out = {}
    pdir = str(tmp_path / "init")
    jt = jfluid.Trainer(_train_func_of(jfluid),
                        lambda: jfluid.optimizer.SGD(learning_rate=0.05),
                        place=jfluid.CPUPlace())
    jt.save_params(pdir)
    pt = fluid.Trainer(_train_func, _optimizer_func, param_path=pdir,
                       place=fluid.CPUPlace())
    for name, t, fl in (("jax", jt, jfluid), ("port", pt, fluid)):
        events, losses = [], []

        def handler(e, events=events, losses=losses, fl=fl):
            events.append(type(e).__name__)
            if isinstance(e, fl.EndStepEvent):
                losses.append(float(np.ravel(e.metrics[0])[0]))

        t.train(num_epochs=num_epochs, event_handler=handler, reader=_reader,
                feed_order=["x", "y"])
        out[name] = (events, losses)
    return out, jt, pt


def test_trainer_events_and_convergence(tmp_path):
    out, jt, t = _run_both(tmp_path)
    events, losses = out["port"]
    assert losses[-1] < losses[0]
    assert events[0] == "BeginEpochEvent" and "EndEpochEvent" in events
    assert events == out["jax"][0]
    np.testing.assert_allclose(losses, out["jax"][1], rtol=LOSS_RTOL, atol=0)
    t.save_params(str(tmp_path / "params"))

    metrics = t.test(reader=_reader, feed_order=["x", "y"])
    want = jt.test(reader=_reader, feed_order=["x", "y"])
    assert len(metrics) == 1 and np.isfinite(metrics[0])
    np.testing.assert_allclose(metrics, want, rtol=LOSS_RTOL, atol=0)


def test_trainer_checkpoint_rotation_and_resume(tmp_path):
    cdir = str(tmp_path / "ckpt")
    cfg = fluid.CheckpointConfig(checkpoint_dir=cdir, max_num_checkpoints=2, step_interval=4)
    t = fluid.Trainer(_train_func, _optimizer_func, place=fluid.CPUPlace(), checkpoint_config=cfg)
    t.train(num_epochs=2, reader=_reader, feed_order=["x", "y"])
    serials = sorted(os.listdir(cdir))
    assert len(serials) == 2, serials  # rotated down to max_num_checkpoints

    w_before = np.asarray(t.scope.vars["w"]).copy()
    # a fresh trainer resumes from the latest checkpoint
    cfg2 = fluid.CheckpointConfig(checkpoint_dir=cdir, max_num_checkpoints=2, step_interval=4)
    t2 = fluid.Trainer(_train_func, _optimizer_func, place=fluid.CPUPlace(), checkpoint_config=cfg2)
    np.testing.assert_array_equal(np.asarray(t2.scope.vars["w"]), w_before)
    assert t2._epoch_start == 2


def test_inferencer_roundtrip(tmp_path):
    t = fluid.Trainer(_train_func, _optimizer_func, place=fluid.CPUPlace())
    t.train(num_epochs=2, reader=_reader, feed_order=["x", "y"])
    t.save_params(str(tmp_path / "p"))

    inf = fluid.Inferencer(_infer_func, str(tmp_path / "p"), place=fluid.CPUPlace())
    xs = np.ones((3, 4), "float32")
    (out,) = inf.infer({"x": xs})
    assert out.shape == (3, 1) and np.isfinite(out).all()
    # the JAX Inferencer reads the same files and gives the same values
    jinf = jfluid.Inferencer(
        lambda: jfluid.layers.fc(
            input=jfluid.layers.data(name="x", shape=[4], dtype="float32"),
            size=1, param_attr=jfluid.ParamAttr(name="w")),
        str(tmp_path / "p"), place=jfluid.CPUPlace())
    (want,) = jinf.infer({"x": xs})
    np.testing.assert_allclose(np.asarray(out), np.asarray(want),
                               rtol=LOSS_RTOL, atol=1e-6)


def test_heartbeat_failure_detection(tmp_path):
    d = str(tmp_path / "hb")
    hb = fluid.trainer_mod.Heartbeat(d, "trainer0", interval=0.2).start()
    # a dead trainer wrote once, long ago
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "trainer1.hb"), "w") as f:
        f.write(str(time.time() - 100))
    time.sleep(0.5)
    failed = fluid.trainer_mod.detect_failed_trainers(d, timeout=5.0)
    assert failed == ["trainer1"]
    hb.stop()
    time.sleep(0.3)


def test_trainer_mid_epoch_resume_skips_applied_steps(tmp_path):
    """Resume from a mid-epoch checkpoint must continue at the next step, not
    replay steps that were applied before the checkpoint (regression: the
    loaded step offset was ignored)."""
    cdir = str(tmp_path / "ckpt")
    cfg = fluid.CheckpointConfig(checkpoint_dir=cdir, max_num_checkpoints=5, step_interval=1)

    # first run: stop after step 2 of epoch 0 (3 steps applied, checkpointed
    # each step)
    t = fluid.Trainer(_train_func, _optimizer_func, place=fluid.CPUPlace(), checkpoint_config=cfg)

    def stop_after_3(e):
        if isinstance(e, fluid.EndStepEvent) and e.step == 2:
            t.stop()

    t.train(num_epochs=1, event_handler=stop_after_3, reader=_reader, feed_order=["x", "y"])

    # second run resumes; it must execute exactly steps 3..7 of epoch 0
    t2 = fluid.Trainer(_train_func, _optimizer_func, place=fluid.CPUPlace(), checkpoint_config=cfg)
    assert t2._epoch_start == 0 and t2._step_start == 3
    executed = []

    def record(e):
        if isinstance(e, fluid.EndStepEvent):
            executed.append((e.epoch, e.step))
    t2.train(num_epochs=1, event_handler=record, reader=_reader, feed_order=["x", "y"])
    assert executed == [(0, s) for s in range(3, 8)], executed


def test_trainer_binds_one_entry_and_fetch_metrics_makes_a_second(tmp_path):
    """Steps replay one bound entry; a handler that turns fetch_metrics off
    for some steps runs them through a second entry (another fetch list)
    sharing the first one's state buffers."""
    from paddle_tpu_torch import executor as executor_mod

    t = fluid.Trainer(_train_func, _optimizer_func, place=fluid.CPUPlace())
    c0 = executor_mod.compile_count()
    t.train(num_epochs=1, reader=_reader, feed_order=["x", "y"])
    train_entries = [b for b in t.exe._bound.values()
                     if b.program is t.train_program]
    assert len(train_entries) == 1 and executor_mod.compile_count() - c0 == 1

    def every_other(e):
        if isinstance(e, fluid.BeginStepEvent):
            e.fetch_metrics = e.step % 2 == 0

    t.train(num_epochs=1, reader=_reader, feed_order=["x", "y"],
            event_handler=every_other)
    entries = [b for b in t.exe._bound.values()
               if b.program is t.train_program]
    assert len(entries) == 2 and executor_mod.compile_count() - c0 == 2
    assert entries[0].state["w"] is entries[1].state["w"] is t.scope["w"]


def _transformer_train_func(fl, T):
    def train_func():
        src = fl.layers.data(name="src_word", shape=[TSEQ], dtype="int64")
        trg = fl.layers.data(name="trg_word", shape=[TSEQ], dtype="int64")
        lbl = fl.layers.data(name="lbl_word", shape=[TSEQ], dtype="int64")
        avg_cost, _sum_cost, _token_num, _logits = T.transformer(
            src, trg, lbl, TSMALL["src_vocab_size"], TSMALL["trg_vocab_size"],
            TSMALL["max_length"], TSMALL["n_layer"], TSMALL["n_head"],
            TSMALL["d_model"], TSMALL["d_inner"], TSMALL["dropout"],
            use_flash=TSMALL["use_flash"])
        return avg_cost
    return train_func


def _transformer_optimizer_func(fl):
    def optimizer_func():
        lr = fl.layers.scale(x=fl.layers.noam_decay(TSMALL["d_model"], 8000),
                             scale=2.0)
        return fl.optimizer.AdamOptimizer(learning_rate=lr, beta1=0.9,
                                          beta2=0.98, epsilon=1e-9)
    return optimizer_func


def _token_reader():
    """TSTEPS batches of TBATCH seeded samples, each row with its own
    length and pad tails."""
    rng = np.random.RandomState(5)
    for _ in range(TSTEPS):
        batch = []
        for _ in range(TBATCH):
            ls, lt = rng.randint(6, TSEQ + 1, size=2)
            src = rng.randint(3, 64, size=TSEQ).astype("int64")
            trg = rng.randint(3, 64, size=TSEQ).astype("int64")
            lbl = rng.randint(3, 64, size=TSEQ).astype("int64")
            src[ls:] = 0
            trg[lt:] = 0
            lbl[lt:] = 0
            batch.append((src, trg, lbl))
        yield batch


def test_transformer_trainer_matches_jax(tmp_path):
    pdir = str(tmp_path / "init")
    feed_order = ["src_word", "trg_word", "lbl_word"]
    losses = {}
    jt = jfluid.Trainer(_transformer_train_func(jfluid, JT),
                        _transformer_optimizer_func(jfluid),
                        place=jfluid.CPUPlace())
    jt.save_params(pdir)
    pt = fluid.Trainer(_transformer_train_func(fluid, TT),
                       _transformer_optimizer_func(fluid), param_path=pdir,
                       place=fluid.CPUPlace())
    assert (pt.train_program.to_string()
            == jt.train_program.to_string())
    for name, t, fl in (("jax", jt, jfluid), ("port", pt, fluid)):
        got = losses[name] = []
        t.train(num_epochs=1, reader=_token_reader, feed_order=feed_order,
                event_handler=lambda e, got=got, fl=fl: got.append(
                    float(np.ravel(e.metrics[0])[0]))
                if isinstance(e, fl.EndStepEvent) else None)
    assert len(losses["port"]) == TSTEPS
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=LOSS_RTOL,
                               atol=0)
    assert losses["port"][0] != losses["port"][-1]


def test_deferred_pieces_raise_naming_their_item():
    with pytest.raises(NotImplementedError, match="A11"):
        fluid.Trainer(_train_func, _optimizer_func, place=fluid.CPUPlace(),
                      parallel=True)
    with pytest.raises(NotImplementedError, match="A11"):
        fluid.Trainer(_train_func, _optimizer_func, place=fluid.CPUPlace(),
                      zero_stage=1)
    t = fluid.Trainer(_train_func, _optimizer_func, place=fluid.CPUPlace())
    with pytest.raises(NotImplementedError, match="A9"):
        t.train(num_epochs=1, reader=_reader, feed_order=["x", "y"],
                attribution=object())
    with pytest.raises(NotImplementedError, match="A11"):
        fluid.Inferencer(_infer_func, "unused", place=fluid.CPUPlace(),
                         parallel=True)


def test_trainer_place_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default place is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fluid.Trainer(_train_func, _optimizer_func)
