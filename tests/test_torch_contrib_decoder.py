"""The port's contrib decoder (``paddle_tpu_torch.contrib.decoder``:
``InitState``, ``StateCell``, ``TrainingDecoder``, ``BeamSearchDecoder``)
against the JAX package's, on the CPU.

The cases of ``tests/unittests/test_contrib_decoder.py`` at its sizes
(vocabulary 12, words 8, hidden 16, batch 4, 5 tokens, beam 2, 6 steps):
both packages build the same Programs (the same ``to_string()`` JSON),
the port's seeded startup state is copied into both, and both run the
same feeds.  Limits:
- the copy task trains with Adam at 0.05: the first LOSS_STEPS losses
  within LOSS_RTOL relative of the JAX package's (float32 recurrences of
  5 steps), and the port's best loss over 30 steps under 0.2 of its
  first, the reference test's claim;
- beam decoding: ids, lengths and both levels of LoD equal to the JAX
  package's, scores within SCORE_RTOL relative; two runs bitwise equal;
- the loop-carried slot reads exactly ``max_len`` after ``max_len``
  steps in both packages.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch.contrib import (BeamSearchDecoder, InitState, StateCell,
                                      TrainingDecoder)

VOCAB, WORD_DIM, HIDDEN = 12, 8, 16
BATCH, T = 4, 5
BEAM, MAX_LEN, END_ID = 2, 6, 1
LOSS_STEPS = 8
LOSS_RTOL = 1e-5
SCORE_RTOL = 1e-5


def _rnn_cell_updater(fl):
    L = fl.layers

    def updater(cell):
        current_word = cell.get_input("x")
        prev_h = cell.get_state("h")
        h = L.fc(current_word, size=HIDDEN, act="tanh", name="cell_x2h")
        h2 = L.fc(prev_h, size=HIDDEN, name="cell_h2h")
        cell.set_state("h", L.elementwise_add(h, h2))
    return updater


def _build_state_cell(fl, init_h):
    cell = fl.contrib.StateCell(
        inputs={"x": None},
        states={"h": fl.contrib.InitState(init=init_h)},
        out_state="h",
    )
    cell.state_updater(_rnn_cell_updater(fl))
    return cell


def _copy_task(fl):
    L = fl.layers
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        src = L.data(name="src", shape=[T], dtype="int64")
        trg = L.data(name="trg", shape=[T], dtype="int64")
        src_emb = L.embedding(src, size=[VOCAB, WORD_DIM], dtype="float32")
        init_h = L.fc(L.reduce_mean(src_emb, dim=1), size=HIDDEN, act="tanh")
        cell = _build_state_cell(fl, init_h)
        decoder = fl.contrib.TrainingDecoder(cell)
        trg_emb = L.embedding(trg, size=[VOCAB, WORD_DIM], dtype="float32")
        with decoder.block():
            word = decoder.step_input(trg_emb)
            decoder.state_cell.compute_state(inputs={"x": word})
            score = L.fc(decoder.state_cell.get_state("h"), size=VOCAB,
                         act="softmax", name="out_proj")
            decoder.state_cell.update_states()
            decoder.output(score)
        probs = decoder()  # [batch, T, VOCAB]
        lbl = L.reshape(trg, shape=[-1, T, 1])
        loss = L.reduce_mean(L.cross_entropy(probs, lbl))
        fl.optimizer.Adam(learning_rate=0.05).minimize(loss)
    return main, startup, loss


def _beam_program(fl):
    L = fl.layers
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        src = L.data(name="src", shape=[T], dtype="int64")
        init_ids = L.data(name="init_ids", shape=[BEAM], dtype="int64")
        init_scores = L.data(name="init_scores", shape=[BEAM], dtype="float32")
        src_emb = L.embedding(src, size=[VOCAB, WORD_DIM], dtype="float32")
        init_h = L.fc(L.reduce_mean(src_emb, dim=1), size=HIDDEN, act="tanh")
        cell = _build_state_cell(fl, init_h)
        decoder = fl.contrib.BeamSearchDecoder(
            state_cell=cell, init_ids=init_ids, init_scores=init_scores,
            target_dict_dim=VOCAB, word_dim=WORD_DIM, topk_size=VOCAB,
            sparse_emb=False, max_len=MAX_LEN, beam_size=BEAM, end_id=END_ID)
        decoder.decode()
        sent_ids, sent_scores = decoder()
    return main, startup, [sent_ids.name, sent_scores.name]


def _carried_program(fl, n_steps):
    L = fl.layers
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        boot = L.data(name="boot", shape=[HIDDEN], dtype="float32")
        cell = _build_state_cell(fl, L.fc(boot, size=HIDDEN, act="tanh"))
        decoder = fl.contrib.BeamSearchDecoder(
            state_cell=cell,
            init_ids=L.data(name="ii", shape=[1], dtype="int64"),
            init_scores=L.data(name="isc", shape=[1], dtype="float32"),
            target_dict_dim=VOCAB, word_dim=WORD_DIM,
            max_len=n_steps, beam_size=1, end_id=END_ID)
        zero = L.fill_constant(shape=[1, 1], dtype="float32", value=0.0)
        one = L.fill_constant(shape=[1, 1], dtype="float32", value=1.0)
        with decoder.block():
            acc = decoder.read_array(init=zero)
            decoder.update_array(acc, L.elementwise_add(acc, one))
    return main, startup, acc.name


def _start_both(build, seed):
    """``build(fluid)`` by both packages (asserted the same JSON); the
    port's startup run with ``seed`` and its state copied into a JAX
    scope.  Returns (jax main, jax scope, port main, port executor,
    port scope, build's last output)."""
    jm, js, out = build(jfluid)
    tm, ts, tout = build(tfluid)
    assert jm.to_string() == tm.to_string()
    assert js.to_string() == ts.to_string()
    ts.random_seed = seed
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    texe.run(ts, scope=tscope)
    jscope = jfluid.Scope()
    for n in tm.persistable_names():
        if n in tscope and tscope[n] is not None:
            jscope[n] = np.array(tscope[n])
    return jm, jscope, tm, texe, tscope, getattr(tout, "name", tout)


def test_training_decoder_trains_the_copy_task_as_jax_does():
    jm, jscope, tm, texe, tscope, loss = _start_both(_copy_task, seed=7)
    seqs = np.random.RandomState(0).randint(2, VOCAB, size=(BATCH, T)).astype("int64")
    feed = {"src": seqs, "trg": seqs}
    jexe = jfluid.Executor(jfluid.CPUPlace())
    want, got = [], []
    for step in range(30):
        if step < LOSS_STEPS:
            with jfluid.scope_guard(jscope):
                (lv,) = jexe.run(jm, feed=feed, fetch_list=[loss])
            want.append(float(np.ravel(lv)[0]))
        (lv,) = texe.run(tm, feed=feed, fetch_list=[loss], scope=tscope)
        got.append(float(np.ravel(lv)[0]))
    np.testing.assert_allclose(got[:LOSS_STEPS], want, rtol=LOSS_RTOL)
    assert min(got) < 0.2 * got[0], (got[0], min(got), got[-1])


def test_beam_search_decoder_matches_jax():
    jm, jscope, tm, texe, tscope, fetch = _start_both(_beam_program, seed=3)
    rng = np.random.RandomState(1)
    feed = {
        "src": rng.randint(2, VOCAB, size=(BATCH, T)).astype("int64"),
        "init_ids": np.zeros((BATCH, BEAM), "int64"),
        "init_scores": np.tile(
            np.array([[0.0] + [-1e9] * (BEAM - 1)], "float32"), (BATCH, 1)),
    }
    with jfluid.scope_guard(jscope):
        want = jfluid.Executor(jfluid.CPUPlace()).run(
            jm, feed=feed, fetch_list=fetch, return_numpy=False)
    got = texe.run(tm, feed=feed, fetch_list=fetch, scope=tscope,
                   return_numpy=False)
    again = texe.run(tm, feed=feed, fetch_list=fetch, scope=tscope,
                     return_numpy=False)
    for g, w in zip(got, want):
        assert g.lod() == w.lod()
    np.testing.assert_array_equal(got[0].data, want[0].data)
    np.testing.assert_array_equal(got[0].lengths, want[0].lengths)
    np.testing.assert_allclose(got[1].data, want[1].data, rtol=SCORE_RTOL)
    for g, a in zip(got, again):
        assert g.data.tobytes() == a.data.tobytes()
    # the reference test's own assertions on the port's output
    ids, scores = np.asarray(got[0].data), np.asarray(got[1].data)
    assert ids.shape[0] == BATCH * BEAM and scores.shape[0] == BATCH * BEAM
    assert ids.min() >= 0 and ids.max() < VOCAB
    # one final score a hypothesis: the top beam outscores (or ties) the
    # second for every source
    by_src = scores.reshape(BATCH, BEAM)
    assert np.all(by_src[:, 0] >= by_src[:, 1] - 1e-6)


@pytest.mark.parametrize("n_steps", [1, 4])
def test_read_array_slots_are_loop_carried(n_steps):
    """A read_array slot accumulates across While steps in both packages
    (its seed is emitted in the While's parent block)."""
    jm, jscope, tm, texe, tscope, acc = _start_both(
        lambda fl: _carried_program(fl, n_steps), seed=2)
    feed = {"boot": np.ones((1, HIDDEN), "float32"),
            "ii": np.zeros((1, 1), "int64"),
            "isc": np.zeros((1, 1), "float32")}
    with jfluid.scope_guard(jscope):
        (want,) = jfluid.Executor(jfluid.CPUPlace()).run(
            jm, feed=feed, fetch_list=[acc])
    (got,) = texe.run(tm, feed=feed, fetch_list=[acc], scope=tscope)
    assert float(np.ravel(got)[0]) == float(np.ravel(want)[0]) == float(n_steps)
    # the seed's assign sits in the global block, not the loop's body
    seeds = [op for op in tm.global_block().ops if op.type == "assign"
             and acc in op.outputs.get("Out", [])]
    assert seeds


def test_state_cell_validates_usage():
    L = tfluid.layers
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        boot = L.data(name="boot", shape=[HIDDEN], dtype="float32")
        with pytest.raises(ValueError):
            StateCell(inputs={}, states={"h": InitState(init=boot)}, out_state="nope")
        with pytest.raises(ValueError):
            StateCell(inputs={}, states={"h": "not-an-initstate"}, out_state="h")
        cell = StateCell(inputs={"x": None}, states={"h": InitState(init=boot)},
                         out_state="h")
        with pytest.raises(ValueError):
            cell.get_input("x")  # not bound yet
        with pytest.raises(ValueError):
            cell.compute_state(inputs={"bogus": boot})
        with pytest.raises(ValueError):
            InitState()  # neither init= nor init_boot=


def _decoder(n_steps=3):
    L = tfluid.layers
    boot = L.data(name="boot", shape=[HIDDEN], dtype="float32")
    cell = _build_state_cell(tfluid, L.fc(boot, size=HIDDEN))
    return BeamSearchDecoder(
        state_cell=cell,
        init_ids=L.data(name="ii", shape=[1], dtype="int64"),
        init_scores=L.data(name="isc", shape=[1], dtype="float32"),
        target_dict_dim=VOCAB, word_dim=WORD_DIM,
        max_len=n_steps, beam_size=1, end_id=END_ID)


def test_early_stop_requires_decoder_block():
    with tfluid.program_guard(tfluid.Program(), tfluid.Program()):
        decoder = _decoder()
        with pytest.raises(ValueError, match="early_stop"):
            decoder.early_stop()


def _misuse_read_both_tags(decoder):
    with decoder.block():
        zero = tfluid.layers.fill_constant(shape=[1, 1], dtype="float32", value=0.0)
        decoder.read_array(init=zero, is_ids=True, is_scores=True)


def _misuse_update_unknown(decoder):
    with decoder.block():
        zero = tfluid.layers.fill_constant(shape=[1, 1], dtype="float32", value=0.0)
        decoder.update_array(zero, zero)


def _misuse_results_before_decode(decoder):
    decoder()


def _misuse_block_twice(decoder):
    with decoder.block():
        pass
    with decoder.block():
        pass


@pytest.mark.parametrize("misuse", [
    _misuse_read_both_tags, _misuse_update_unknown,
    _misuse_results_before_decode, _misuse_block_twice])
def test_beam_search_decoder_rejects_misuse(misuse):
    """The JAX package's ValueErrors for a misused BeamSearchDecoder."""
    with tfluid.program_guard(tfluid.Program(), tfluid.Program()):
        with pytest.raises(ValueError):
            misuse(_decoder())


def test_training_decoder_outside_its_block_raises():
    L = tfluid.layers
    with tfluid.program_guard(tfluid.Program(), tfluid.Program()):
        boot = L.data(name="boot", shape=[HIDDEN], dtype="float32")
        decoder = TrainingDecoder(_build_state_cell(tfluid, boot))
        with pytest.raises(ValueError, match="step_input"):
            decoder.step_input(boot)
        with pytest.raises(ValueError):
            decoder()  # outputs only after the block
