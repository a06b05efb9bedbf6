"""The semantic-role labeler and the CRNN-CTC OCR model
(``models.label_semantic_roles``, ``models.ocr_crnn_ctc``) through the
port's Executor against the JAX package's, on the CPU, at the JAX
package's own test sizes:
- SRL at depth 2, hidden 32 (``tests/unittests/test_book_models.py``),
  the synthetic CoNLL-05 vocabularies (4,000 words, 2 marks, 11 tags),
  batch 4, sentences of 3-9 tokens padded to 9, all 8 feeds ragged, SGD;
- OCR at ``data_shape [1, 16, 96]``, hidden 16, 8 classes and the blank
  (``tests/unittests/test_ocr_crnn_ctc.py``), batch 4, labels of 1-3
  ids fed as ``[L]`` rows, Adam.

Both packages build the same Programs (the same ``to_string()`` JSON).
The port's startup state (seeded) is copied into both, and both run the
same seeded feed for STEPS steps.  SRL (no gate, no batch statistic:
each step a smooth function of its state) runs on, each package on its
own trajectory: each step's loss within 1e-5 relative (LOSS_RTOL), and
after the last step every persistable within 1e-4 of its tensor's
largest magnitude (STATE_TOL: float32 recurrences of up to 9 steps and
a CRF over them, four updates each).  OCR's ReLUs and batch norms part
two float32 trajectories where a gate sits within rounding of 0, and
Adam's first update moves each element by lr times the sign of its
gradient, so an element whose gradient is at rounding level moves by
+-lr in either package at random (conv2d_6's weight: 2.2e-3 of its
largest magnitude, 3.4e-5 in L2).  So each OCR step starts the port
from the JAX package's state before it, as ``tests/test_torch_zoo.py``
does: each step's loss within LOSS_RTOL, and every persistable after
each step within 1e-4 of its L2 norm in L2 (STATE_L2).  The decode
outputs of every step are equal: SRL's Viterbi path and its lengths,
OCR's greedy decode (``ctc_align``'s ids and lengths), its edit
distance (within 1e-6, a ratio of small integers) and sequence count.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu import lod as JL
from paddle_tpu.models import label_semantic_roles as JS, ocr_crnn_ctc as JO
from paddle_tpu_torch import lod as TL
from paddle_tpu_torch.models import (label_semantic_roles as TS,
                                     ocr_crnn_ctc as TO)

STEPS = 4
LOSS_RTOL = 1e-5
STATE_TOL = 1e-4     # of each persistable's largest magnitude
STATE_L2 = 1e-4      # of each persistable's L2 norm, a step from one state
_LOD = {id(jfluid): JL, id(tfluid): TL}
OCR = dict(data_shape=[1, 16, 96], rnn_hidden_size=16, num_classes=8)
SRL = dict(depth=2, hidden_dim=32)


def _srl_feed(fl):
    rng = np.random.RandomState(30)
    lens = rng.randint(3, 10, size=4)
    lod = _LOD[id(fl)]
    feed = {}
    for name, vocab in [(n, TS.WORD_VOCAB) for n in TS.FEED_NAMES[:-1]] + [
            ("mark", TS.MARK_DICT_LEN), ("target", TS.LABEL_VOCAB)]:
        data = rng.randint(0, vocab, size=(4, 9, 1)).astype("int64")
        feed[name] = lod.LoDArray(data, lens)
    return feed


def _ocr_feed(fl):
    rng = np.random.RandomState(31)
    imgs = rng.randn(4, *OCR["data_shape"]).astype("float32")
    labels = [rng.randint(0, OCR["num_classes"], size=(n,)).astype("int64")
              for n in (2, 1, 3, 2)]
    return {"pixel": imgs, "label": _LOD[id(fl)].pack_sequences(labels)}


def _srl_fetch(m):
    return [m["loss"], m["decode"], m["decode"].name + "@LENGTHS"]


def _ocr_fetch(m):
    (align,) = [op for op in m["main"].global_block().ops
                if op.type == "ctc_align"]
    out = align.outputs["Output"][0]
    return [m["loss"], out, out + "@LENGTHS", m["error"], m["seq_num"]]


#: name -> (get_model, packages' modules, feed, fetches, Programs compared,
#: whether each step starts the port from the JAX package's state)
MODELS = {
    "label_semantic_roles": (lambda M: M.get_model(**SRL), (JS, TS),
                             _srl_feed, _srl_fetch, ("main", "startup"),
                             False),
    "ocr_crnn_ctc": (lambda M: M.get_model(**OCR), (JO, TO), _ocr_feed,
                     _ocr_fetch, ("main", "startup", "test"), True),
}


def _state(prog, scope):
    return {n: np.array(scope[n]) for n in prog.persistable_names()
            if n in scope and scope[n] is not None}


@pytest.fixture(scope="module", params=list(MODELS))
def runs(request):
    build, (JM, TM), feed, fetch, progs, reset = MODELS[request.param]
    with jfluid.unique_name.guard():
        jm = build(JM)
    with tfluid.unique_name.guard():
        tm = build(TM)
    serialized = {k: (jm[k].to_string(), tm[k].to_string()) for k in progs}
    tm["startup"].random_seed = 5
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    texe.run(tm["startup"], scope=tscope)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    for n, v in _state(tm["main"], tscope).items():
        jscope[n] = v
    steps = []
    for _ in range(STEPS):
        if reset:
            tscope = tfluid.Scope()
            tfluid.load_numpy_state(tm["main"], _state(jm["main"], jscope),
                                    scope=tscope, device="cpu")
        with jfluid.scope_guard(jscope):
            want = jexe.run(jm["main"], feed=feed(jfluid),
                            fetch_list=fetch(jm))
        got = texe.run(tm["main"], feed=feed(tfluid), fetch_list=fetch(tm),
                       scope=tscope)
        steps.append({"jax": [np.asarray(w) for w in want],
                      "port": [np.asarray(g) for g in got],
                      "states": (_state(jm["main"], jscope),
                                 _state(tm["main"], tscope))})
    return {"name": request.param, "serialized": serialized, "steps": steps,
            "reset": reset}


def test_same_programs_as_jax(runs):
    for key, (want, got) in runs["serialized"].items():
        assert got == want, (runs["name"], key)


def test_losses_match_jax_step_for_step(runs):
    losses = [(float(st["jax"][0].reshape(-1)[0]),
               float(st["port"][0].reshape(-1)[0])) for st in runs["steps"]]
    for want, got in losses:
        assert np.isfinite(got)
        assert abs(got - want) <= LOSS_RTOL * abs(want), losses
    assert losses[-1][1] < losses[0][1]


def test_decode_matches_jax_step_for_step(runs):
    for st in runs["steps"]:
        for w, g in zip(st["jax"][1:], st["port"][1:]):
            assert g.shape == w.shape
            if w.dtype.kind == "f":
                np.testing.assert_allclose(g, w, rtol=1e-6)
            else:
                np.testing.assert_array_equal(g, w)
    if runs["name"] == "ocr_crnn_ctc":
        assert all(int(st["port"][4]) == 4 for st in runs["steps"])


def test_state_matches_jax_after_the_steps(runs):
    """SRL: every persistable after the last step within STATE_TOL of its
    largest magnitude; OCR: after every step within STATE_L2 in L2."""
    for i, st in enumerate(runs["steps"]):
        if not runs["reset"] and i < STEPS - 1:
            continue
        want, got = st["states"]
        assert sorted(want) == sorted(got)
        for n, w in want.items():
            g = got[n].astype("float64")
            assert g.shape == w.shape, n
            if runs["reset"]:
                err = float(np.linalg.norm(g - w)) / max(
                    float(np.linalg.norm(w)), 1e-30)
                assert err <= STATE_L2, (runs["name"], n, i, err)
            else:
                scale = max(float(np.max(np.abs(w))), 1e-30)
                err = float(np.max(np.abs(g - w))) / scale
                assert err <= STATE_TOL, (runs["name"], n, err)
