"""The stacked dynamic LSTM, the recommender and machine translation
(``models.stacked_dynamic_lstm``, ``models.recommender``,
``models.machine_translation``) through the port's Executor against the
JAX package's, on the CPU, at small widths:
- the stacked LSTM at embedding 8, LSTM 16, depth 2, vocab 50, batch 4,
  lengths 3-9 padded to 9, Adam;
- the recommender with the JAX package's synthetic MovieLens
  vocabularies (the module's defaults), batch 6, 1-4 genres and 1-6
  title words a movie, SGD;
- machine translation at widths 8, dictionary 30, 6 tokens, batch 3,
  Adam; and its beam search (beam 2, 5 steps) on the trained weights.

Both packages build the same Programs (the same ``to_string()`` JSON).
The port's startup state (seeded) is copied into both, and both run the
same seeded feed for STEPS steps, each on its own trajectory: no model
here has a ReLU gate or a batch statistic, so each step is a smooth
function of its state and the two stay together.  Limits: each step's
loss within 1e-5 relative; after the last step, every persistable
(parameters, Adam's moments, the step counters) within 1e-4 of its
tensor's largest magnitude (float32 recurrences of up to 9 steps, three
updates each).  Machine translation's generated ids, their lengths and
both levels of LoD are equal to the JAX package's, its scores within
1e-5 relative.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import lod as JL
from paddle_tpu.models import (machine_translation as JMT, recommender as JR,
                               stacked_dynamic_lstm as JS)
from paddle_tpu_torch import lod as TL
from paddle_tpu_torch.models import (machine_translation as TMT,
                                     recommender as TR,
                                     stacked_dynamic_lstm as TS)

STEPS = 3
LOSS_RTOL = 1e-5
STATE_TOL = 1e-4     # of each persistable's largest magnitude
SCORE_RTOL = 1e-5
MT = dict(batch_size=3, seq_len=6, embedding_dim=8, encoder_size=8,
          decoder_size=8, dict_size=30)
_LOD = {id(jfluid): JL, id(tfluid): TL}


def _ragged(fl, rng, n, lo, hi, vocab, T):
    lens = rng.randint(lo, hi + 1, size=n)
    data = rng.randint(0, vocab, size=(n, T, 1)).astype("int64")
    return _LOD[id(fl)].LoDArray(data, lens)


def _lstm_feed(fl):
    rng = np.random.RandomState(1)
    return {"words": _ragged(fl, rng, 4, 3, 9, 50, 9),
            "label": rng.randint(0, 2, (4, 1)).astype("int64")}


def _recommender_feed(fl):
    rng = np.random.RandomState(2)
    n = 6
    ids = {k: rng.randint(lo, hi, (n, 1)).astype("int64") for k, lo, hi in (
        ("user_id", 1, TR.NUM_USERS + 1), ("gender_id", 0, 2),
        ("age_id", 0, 7), ("job_id", 0, TR.NUM_JOBS),
        ("movie_id", 1, TR.NUM_MOVIES + 1))}
    ids["category_id"] = _ragged(fl, rng, n, 1, 4, TR.NUM_CATEGORIES, 4)
    ids["movie_title"] = _ragged(fl, rng, n, 1, 6, TR.TITLE_VOCAB, 6)
    ids["score"] = rng.uniform(1, 5, (n, 1)).astype("float32")
    return ids


def _mt_words(rng):
    words = rng.randint(3, MT["dict_size"], (MT["batch_size"], MT["seq_len"]))
    for b, n in enumerate(rng.randint(2, MT["seq_len"] + 1, MT["batch_size"])):
        words[b, n:] = JMT.PAD_IDX
    return words.astype("int64")


def _mt_feed(fl):
    rng = np.random.RandomState(3)
    trg = _mt_words(rng)
    return {"src_word": _mt_words(rng), "trg_word": trg,
            "label": np.concatenate([trg[:, 1:], trg[:, :1]], 1)[..., None]}


MODELS = {
    "stacked_dynamic_lstm": (
        lambda M: M.get_model(lstm_size=16, emb_dim=8, vocab_size=50, depth=2,
                              lr=0.01), (JS, TS), _lstm_feed,
        ("main", "startup", "test")),
    "recommender": (lambda M: M.get_model(), (JR, TR), _recommender_feed,
                    ("main", "startup")),
    "machine_translation": (
        lambda M: M.get_model(learning_rate=0.01, **MT), (JMT, TMT), _mt_feed,
        ("main", "startup", "test")),
}


def _state(prog, scope):
    return {n: np.array(scope[n]) for n in prog.persistable_names()
            if n in scope and scope[n] is not None}


@pytest.fixture(scope="module", params=list(MODELS))
def runs(request):
    build, (JM, TM), feed, progs = MODELS[request.param]
    with jfluid.unique_name.guard():
        jm = build(JM)
    with tfluid.unique_name.guard():
        tm = build(TM)
    serialized = {k: (jm[k].to_string(), tm[k].to_string()) for k in progs}
    tm["startup"].random_seed = 5
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    texe.run(tm["startup"], scope=tscope)
    state = _state(tm["main"], tscope)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    for n, v in state.items():
        jscope[n] = v
    losses = []
    for _ in range(STEPS):
        with jfluid.scope_guard(jscope):
            (want,) = jexe.run(jm["main"], feed=feed(jfluid),
                               fetch_list=[jm["loss"]])
        (got,) = texe.run(tm["main"], feed=feed(tfluid),
                          fetch_list=[tm["loss"]], scope=tscope)
        losses.append((float(np.asarray(want).reshape(-1)[0]),
                       float(np.asarray(got).reshape(-1)[0])))
    return {"name": request.param, "serialized": serialized, "losses": losses,
            "jax": _state(jm["main"], jscope), "torch": _state(tm["main"], tscope)}


def test_same_programs_as_jax(runs):
    for key, (want, got) in runs["serialized"].items():
        assert got == want, (runs["name"], key)


def test_losses_match_jax_step_for_step(runs):
    for want, got in runs["losses"]:
        assert np.isfinite(got)
        assert abs(got - want) <= LOSS_RTOL * abs(want), runs["losses"]
    assert runs["losses"][-1][1] < runs["losses"][0][1]


def test_state_matches_jax_after_the_steps(runs):
    want, got = runs["jax"], runs["torch"]
    assert sorted(want) == sorted(got)
    for n, w in want.items():
        g = got[n]
        assert g.shape == w.shape, n
        scale = max(float(np.max(np.abs(w))), 1e-30)
        err = float(np.max(np.abs(g.astype("float64") - w))) / scale
        assert err <= STATE_TOL, (runs["name"], n, err)


def test_machine_translation_generates_the_jax_package_ids():
    """Beam search (beam 2, 5 steps) from the same trained-from-startup
    weights: the same ids, lengths and LoD, scores within SCORE_RTOL."""
    kw = dict(MT, is_generating=True, beam_size=2, max_length=5)
    with jfluid.unique_name.guard():
        jg = JMT.get_model(**kw)
    with tfluid.unique_name.guard():
        tg = TMT.get_model(**kw)
    assert jg["main"].to_string() == tg["main"].to_string()
    tg["startup"].random_seed = 6
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    texe.run(tg["startup"], scope=tscope)
    jscope = jfluid.Scope()
    for n, v in _state(tg["main"], tscope).items():
        jscope[n] = v
    src = _mt_words(np.random.RandomState(4))
    with jfluid.scope_guard(jscope):
        want = jfluid.Executor(jfluid.CPUPlace()).run(
            jg["main"], feed={"src_word": src},
            fetch_list=[jg["ids"], jg["scores"]], return_numpy=False)
    got = texe.run(tg["main"], feed={"src_word": src},
                   fetch_list=[tg["ids"], tg["scores"]], scope=tscope,
                   return_numpy=False)
    for g, w in zip(got, want):
        assert g.lod() == w.lod()
    np.testing.assert_array_equal(got[0].data, want[0].data)
    np.testing.assert_array_equal(got[0].lengths, want[0].lengths)
    np.testing.assert_allclose(got[1].data, want[1].data, rtol=SCORE_RTOL)
