"""Transformer beam-search inference (``get_inference_model``) in the
port against the JAX package's, on the CPU, at the copy task of
``tests/unittests/test_transformer_decode.py`` (1 layer, 2 heads,
d_model 32, vocab 20, 8 sources of 8 tokens, beam 2).

(a) the port's inference Program serialises to the JAX package's JSON;
(b) the JAX package trains the copy task as its own test does; its
    parameters, copied into the port as numpy, decode in both packages
    to the same sentence ids and lengths, bitwise (the JAX package's int32
    against the port's int64 by value), and scores within 1e-5 — trained
    weights give wide margins between beams, so the two packages' float32
    rounding cannot reorder them;
(c) the port trains the copy task itself and decodes at least B - 1 of
    the 8 sources right, as the JAX test requires.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.models import transformer as JT
from paddle_tpu_torch.models import transformer as TT

V, L, B, BEAM = 20, 8, 8, 2
DIMS = dict(src_vocab_size=V, trg_vocab_size=V, max_length=16, n_layer=1,
            n_head=2, d_model=32, d_inner=64)
STEPS = 150
SCORE_TOL = 1e-5


def _programs(fl, T):
    """The copy task's training Programs and the inference model, each
    under a fresh unique_name guard, so their parameter names agree."""
    with fl.unique_name.guard():
        main, startup = fl.Program(), fl.Program()
        startup.random_seed = 9
        with fl.program_guard(main, startup):
            src = fl.layers.data(name="src_word", shape=[L], dtype="int64")
            trg = fl.layers.data(name="trg_word", shape=[L], dtype="int64")
            lbl = fl.layers.data(name="lbl_word", shape=[L], dtype="int64")
            avg, _, _, _ = T.transformer(src, trg, lbl, dropout=0.0,
                                         label_smooth_eps=0.0, **DIMS)
            fl.optimizer.Adam(learning_rate=3e-3).minimize(avg)
    with fl.unique_name.guard():
        inf = T.get_inference_model(beam_size=BEAM, max_out_len=L,
                                     seq_len=L, **DIMS)
    return main, startup, avg, inf


def _copy_task():
    """Target = source, shifted with BOS/EOS."""
    rng = np.random.RandomState(0)
    body = rng.randint(3, V, size=(B, L - 2)).astype("int64")
    pad2 = np.full((B, 2), JT.PAD_IDX, "int64")
    src = np.concatenate([body, pad2], axis=1)
    trg = np.concatenate([np.full((B, 1), JT.BOS_IDX, "int64"), body,
                          pad2[:, :1]], axis=1)
    lbl = np.concatenate([body, np.full((B, 1), JT.EOS_IDX, "int64"),
                          pad2[:, :1]], axis=1)
    return body, {"src_word": src, "trg_word": trg, "lbl_word": lbl}


def _correct(ids, body):
    """Sources whose best beam (row 0 of its group) copies the body and
    then ends."""
    best = np.asarray(ids).reshape(B, BEAM, -1)[:, 0, :]
    return sum(list(best[b, :L - 1]) == list(body[b]) + [JT.EOS_IDX]
               for b in range(B))


def test_inference_program_serializes_as_the_jax_package():
    for kw in (dict(beam_size=BEAM, max_out_len=L, seq_len=L, **DIMS),
               dict(beam_size=4, max_out_len=6, seq_len=10, **DIMS)):
        with jfluid.unique_name.guard():
            j = JT.get_inference_model(**kw)
        with tfluid.unique_name.guard():
            t = TT.get_inference_model(**kw)
        assert j["infer"].to_string() == t["infer"].to_string()
        assert j["startup"].to_string() == t["startup"].to_string()
        assert (j["ids"].name, j["scores"].name) == (t["ids"].name,
                                                     t["scores"].name)
        assert t["feeds"] == ["src_word"]


@pytest.fixture(scope="module")
def jax_trained():
    """The JAX package's copy task, trained as its own test trains it:
    the parameters (numpy) and its decode (LoDArrays)."""
    main, startup, avg, inf = _programs(jfluid, JT)
    body, feed = _copy_task()
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        for _ in range(STEPS):
            (lv,) = exe.run(main, feed=feed, fetch_list=[avg])
        ids, scores = exe.run(inf["infer"], feed={"src_word": feed["src_word"]},
                              fetch_list=[inf["ids"], inf["scores"]],
                              return_numpy=False)
    state = {n: np.asarray(scope[n]) for n in inf["infer"].persistable_names()}
    return {"loss": float(np.ravel(lv)[0]), "state": state, "body": body,
            "src": feed["src_word"], "ids": ids, "scores": scores}


def test_decode_matches_the_jax_package_from_its_trained_parameters(jax_trained):
    assert jax_trained["loss"] < 0.2
    _, _, _, inf = _programs(tfluid, TT)
    scope = tfluid.Scope()
    tfluid.load_numpy_state(inf["infer"], jax_trained["state"], scope=scope,
                            device="cpu")
    ids, scores = tfluid.Executor(tfluid.CPUPlace()).run(
        inf["infer"], feed={"src_word": jax_trained["src"]},
        fetch_list=[inf["ids"], inf["scores"]], scope=scope,
        return_numpy=False)
    j_ids, j_scores = jax_trained["ids"], jax_trained["scores"]
    assert isinstance(ids, tfluid.LoDArray) and ids.data.dtype == np.int64
    assert ids.data.shape == (B * BEAM, L)
    np.testing.assert_array_equal(ids.data, np.asarray(j_ids.data))
    np.testing.assert_array_equal(ids.lengths, np.asarray(j_ids.lengths))
    np.testing.assert_array_equal(ids.sub_lengths,
                                  np.asarray(j_ids.sub_lengths))
    np.testing.assert_allclose(scores.data, np.asarray(j_scores.data),
                               rtol=SCORE_TOL, atol=SCORE_TOL)
    assert _correct(ids.data, jax_trained["body"]) >= B - 1


def test_port_trains_and_decodes_the_copy_task():
    main, startup, avg, inf = _programs(tfluid, TT)
    body, feed = _copy_task()
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    for _ in range(STEPS):
        (lv,) = exe.run(main, feed=feed, fetch_list=[avg], scope=scope)
    assert float(np.ravel(lv)[0]) < 0.2
    ids, scores = exe.run(inf["infer"], feed={"src_word": feed["src_word"]},
                          fetch_list=[inf["ids"], inf["scores"]], scope=scope)
    assert ids.shape == (B * BEAM, L) and scores.shape == (B * BEAM,)
    correct = _correct(ids, body)
    assert correct >= B - 1, (correct, ids[:4], body[:2])
