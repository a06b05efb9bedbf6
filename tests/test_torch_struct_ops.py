"""The structured-prediction op rules of the port
(``paddle_tpu_torch/ops/struct_ops.py``, all 8) against the JAX
package's on the CPU, one parametrised case an op or an edge of it,
after ``tests/unittests/test_struct_ops.py``, ``test_warpctc_op.py``,
``test_linear_chain_crf_op.py``, ``test_edit_distance_ctc_op.py``,
``test_chunk_eval_op.py`` and ``test_nce_hsigmoid_op.py``.

Each case builds the same Program with each package through the layer
functions (``warpctc``, ``ctc_greedy_decoder``, ``edit_distance``,
``linear_chain_crf``, ``crf_decoding``, ``chunk_eval``, ``nce``,
``hsigmoid``; ``ctc_align`` also raw), copies the JAX startup's
parameters into the port and feeds both the same seeded ragged batches,
whose padding holds random values, through
``test_torch_sequence_ops._run``.  It compares every output and the
``@LENGTHS`` of the outputs that carry them, and the gradients of
mean(first output) with respect to every float feed and parameter:
float32 within 1e-5 relative and absolute (``_run``'s TOL; CTC's
recursion over 9 frames of ``logaddexp``s and the CRF's over 6 steps:
2e-5, REC_TOL), integers exactly.  A label CTC cannot fit costs about
1e5, and that row's gradient is held to IMPOSSIBLE_ROW_TOL.

Edges, each a case: CTC with the blank first and last (OCR's), repeated
labels (a blank must part them), the last label equal to the padding id
0, a label too long for its frames (optax's finite ``-log_epsilon``
cost, about 1e5, where ``F.ctc_loss`` gives infinity), a zero-length
logit row, ``norm_by_times``; ``edit_distance`` with empty hypotheses
and references, normalized or not; the CRF over rows of length 0 and 1
and Viterbi ties (integer emissions, a zero transition: the first
maximum wins); ``chunk_eval`` under the four schemes and with excluded
types; ``nce`` with ``custom_neg_classes`` (exact draws) and a sample
weight, and its default sampler held to the uniform law by a
chi-square over the classes (the port draws from its own generator);
``hsigmoid`` with 2 classes, a power of two and non-powers of two.

R-7 (ROADMAP §C): the JAX package's ``warpctc`` raises on a label fed
as Fluid's ``[B, U, 1]`` rows, which its siblings squeeze; the port
squeezes it, and answers as the JAX package does for the same labels
fed as ``[B, U]``.
"""
import importlib

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import registry as treg
from test_torch_sequence_ops import Ragged, _feed, _run

REC_TOL = 2e-5


def _floats(seed, lengths, width, T=None, scale=1.0):
    r = np.random.RandomState(seed)
    T = T or max(lengths)
    return Ragged((r.randn(len(lengths), T, width) * scale).astype("float32"),
                  lengths)


def _labels(seed, lengths, lo, hi, T=None, rows=None):
    """Ragged int64 ids in [lo, hi), random in the padding too; ``rows``
    overrides the leading ones."""
    r = np.random.RandomState(seed)
    data = r.randint(lo, hi, size=(len(lengths), T or max(lengths)))
    for b, row in enumerate(rows or []):
        data[b, :len(row)] = row
    return Ragged(data.astype("int64"), lengths)


# ---------------------------------------------------------------------------
# CTC: warpctc, ctc_align (test_warpctc_op.py, test_edit_distance_ctc_op.py)
# ---------------------------------------------------------------------------

C = 6   # classes with the blank

#: warpctc cases: (logit lengths, label lengths, blank, fixed label rows,
#: norm_by_times)
CTC_CASES = {
    "blank_first": ([7, 5, 6], [3, 2, 2], 0, None, False),
    "blank_last": ([7, 5, 6], [3, 2, 2], C - 1, None, False),
    "repeats": ([9, 5, 4], [4, 2, 2], 0, [[2, 2, 3, 3], [1, 1], [4, 4]],
                False),
    # the last label is the padding id 0, a class when the blank is last
    "last_label_is_pad_id": ([6, 6, 5], [3, 2, 1], C - 1,
                             [[3, 1, 0], [2, 0], [0]], False),
    # 4 labels with 2 repeats need 6 frames; the middle row has 3
    "label_too_long": ([7, 3, 6], [3, 4, 2], 0, [[1, 2, 3], [2, 2, 3, 3]],
                       False),
    "zero_length_logits": ([6, 0, 5], [2, 0, 2], 0, None, False),
    "norm_by_times": ([7, 5, 6], [3, 2, 2], 0, None, True),
}


def _ctc_spec(case, label3d=False):
    lens, label_lens, blank, rows, _ = CTC_CASES[case]
    lo, hi = (1, C) if blank == 0 else (0, C - 1)
    lab = _labels(11, label_lens, lo, hi, rows=rows)
    if label3d:
        lab = Ragged(lab.data[..., None], lab.lengths)
    return {"x": _floats(10, lens, C, T=9), "y": lab}


def _warpctc(case):
    _, _, blank, _, norm = CTC_CASES[case]
    return lambda fl, v: [fl.layers.warpctc(v["x"], v["y"], blank=blank,
                                            norm_by_times=norm)]


@pytest.mark.parametrize("case", list(CTC_CASES))
def test_warpctc_matches_jax(case):
    impossible = case == "label_too_long"
    got = _run(_ctc_spec(case), _warpctc(case), tol=REC_TOL,
               grad=not impossible)
    loss = got[0].reshape(-1)
    assert np.isfinite(loss).all()
    if impossible:
        # log 0 is -1e5 in the recursion: a finite cost of that order
        assert 5e4 < loss[1] < 2e5 and loss[[0, 2]].max() < 100
        _impossible_row_gradients(case, row=1)
    if case == "zero_length_logits":
        assert loss[1] == 0.0


#: the gradient of a row whose label cannot fit its frames, of its
#: largest |value|: its forward variables sit near -1e5, where float32's
#: spacing is 2**-7, and it weighs each path by exp of their differences,
#: so each weight carries up to exp(2**-7) - 1 = 0.8% of rounding
IMPOSSIBLE_ROW_TOL = 1e-2


def _impossible_row_gradients(case, row):
    """The gradients of ``case`` with respect to the logits, row by row:
    the rows that fit within REC_TOL, ``row`` within IMPOSSIBLE_ROW_TOL
    of its largest magnitude."""
    spec = _ctc_spec(case)
    (_, g), (_, w) = (_ctc_run(fl, spec, case) for fl in (tfluid, jfluid))
    fit = [b for b in range(len(g)) if b != row]
    np.testing.assert_allclose(g[fit], w[fit], rtol=REC_TOL, atol=REC_TOL)
    scale = np.abs(w[row]).max()
    assert scale > 0.01
    np.testing.assert_allclose(g[row], w[row], rtol=0,
                               atol=IMPOSSIBLE_ROW_TOL * scale)


def test_warpctc_loss_matches_torch_ctc_loss():
    """Where a label fits its frames, the rule's loss is
    ``F.ctc_loss``'s (reference: test_struct_ops.py's torch check)."""
    import torch

    spec = _ctc_spec("repeats")
    got = _run(spec, _warpctc("repeats"), tol=REC_TOL)[0].reshape(-1)
    x, y = spec["x"], spec["y"]
    want = torch.nn.functional.ctc_loss(
        torch.log_softmax(torch.tensor(x.data), -1).transpose(0, 1),
        torch.tensor(y.data), torch.tensor(x.lengths).long(),
        torch.tensor(y.lengths).long(), blank=0, reduction="none")
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5)


def _ctc_run(fl, spec, case):
    """``case``'s loss and its gradient with respect to the logits, run
    by one package alone on ``spec`` (labels declared ``shape=[1]``)."""
    main, startup = fl.Program(), fl.Program()
    with fl.unique_name.guard(), fl.program_guard(main, startup):
        x = fl.layers.data(name="x", shape=[C], dtype="float32", lod_level=1,
                           stop_gradient=False)
        y = fl.layers.data(name="y", shape=[1], dtype="int64", lod_level=1)
        (loss,) = _warpctc(case)(fl, {"x": x, "y": y})
        (g,) = fl.backward.calc_gradient(fl.layers.mean(loss), [x])
    with fl.scope_guard(fl.Scope()):
        out = fl.Executor(fl.CPUPlace()).run(main, feed=_feed(spec)(fl),
                                             fetch_list=[loss, g])
    return [np.asarray(o) for o in out]


def test_warpctc_squeezes_a_label_of_rows_r7():
    """R-7: fed ``[B, U, 1]`` labels, the JAX package's ``warpctc``
    raises (optax's rank assertion); the port squeezes them: its loss
    and gradient are its own for the labels fed ``[B, U]`` (bitwise),
    and the JAX package's for those (REC_TOL)."""
    rows, flat = (_ctc_spec("blank_first", label3d=True),
                  _ctc_spec("blank_first"))
    with pytest.raises(AssertionError, match="rank"):
        _ctc_run(jfluid, rows, "blank_first")
    got = _ctc_run(tfluid, rows, "blank_first")
    for g, p, w in zip(got, _ctc_run(tfluid, flat, "blank_first"),
                       _ctc_run(jfluid, flat, "blank_first")):
        assert g.tobytes() == p.tobytes()
        np.testing.assert_allclose(g, w, rtol=REC_TOL, atol=REC_TOL)


def test_ctc_greedy_decoder_matches_jax():
    """Frames that argmax to [0 1 1 0 2 2 0] decode to [1, 2]
    (test_struct_ops.py), and seeded logits over ragged rows, a zero
    length among them."""
    ids = np.array([0, 1, 1, 0, 2, 2, 0])
    x = np.random.RandomState(12).rand(3, 7, 3).astype("float32")
    x[0, np.arange(7), ids] = 5.0
    got = _run({"x": Ragged(x, [7, 5, 0])},
               lambda fl, v: [fl.layers.ctc_greedy_decoder(v["x"], blank=0)],
               lod=(0,))
    assert got[0][0, :2].tolist() == [1, 2] and got[1][0] == 2
    assert (got[0][0, 2:] == 0).all() and got[1][2] == 0


@pytest.mark.parametrize("merge", [True, False])
def test_ctc_align_matches_jax(merge):
    """The raw op over ids: blanks dropped, repeats merged (or kept),
    the kept ids compacted, zeros past the new lengths."""
    ids = _labels(13, [8, 3, 0, 8], 0, 3, T=8,
                  rows=[[1, 1, 0, 1, 2, 2, 2, 0], [0, 0, 0]])

    def body(fl, v):
        helper = importlib.import_module(
            fl.__name__ + ".layer_helper").LayerHelper("ctc_align")
        out = helper.create_variable_for_type_inference(dtype="int64")
        helper.append_op(type="ctc_align", inputs={"Input": [v["ids"]]},
                         outputs={"Output": [out]},
                         attrs={"blank": 0, "merge_repeated": merge})
        return [out]

    got = _run({"ids": ids}, body, lod=(0,))
    assert got[0][0, :got[1][0]].tolist() == ([1, 1, 2] if merge
                                              else [1, 1, 1, 2, 2, 2])
    assert got[1][1] == 0 and got[1][2] == 0


# ---------------------------------------------------------------------------
# edit distance (test_edit_distance_ctc_op.py)
# ---------------------------------------------------------------------------

#: (hypothesis lengths, reference lengths)
EDIT_CASES = {
    "ragged": ([4, 6, 1, 5], [5, 3, 2, 5]),
    "empty_hypotheses": ([0, 3, 0], [2, 4, 0]),
    "empty_references": ([3, 0, 5], [0, 0, 2]),
}


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("case", list(EDIT_CASES))
def test_edit_distance_matches_jax(case, normalized):
    hl, rl = EDIT_CASES[case]
    spec = {"h": _labels(14, hl, 0, 5, T=6), "r": _labels(15, rl, 0, 5, T=6)}
    got = _run(spec, lambda fl, v: list(fl.layers.edit_distance(
        v["h"], v["r"], normalized=normalized)))
    want = np.array([_levenshtein(h[:a], r[:b]) for h, r, a, b in zip(
        spec["h"].data, spec["r"].data, hl, rl)], np.float32)
    if normalized:
        want = want / np.maximum(np.array(rl, np.float32), 1.0)
    np.testing.assert_allclose(got[0].reshape(-1), want, rtol=1e-6)
    assert got[1] == len(hl)


def _levenshtein(a, b):
    d = np.zeros((len(a) + 1, len(b) + 1))
    d[:, 0] = np.arange(len(a) + 1)
    d[0, :] = np.arange(len(b) + 1)
    for i in range(1, len(a) + 1):
        for j in range(1, len(b) + 1):
            d[i, j] = min(d[i - 1, j] + 1, d[i, j - 1] + 1,
                          d[i - 1, j - 1] + (a[i - 1] != b[j - 1]))
    return d[len(a), len(b)]


# ---------------------------------------------------------------------------
# linear-chain CRF, Viterbi (test_linear_chain_crf_op.py)
# ---------------------------------------------------------------------------

K = 4
#: (emission lengths, padded length)
CRF_CASES = {"ragged": ([3, 2, 6, 4], 6), "lengths_0_and_1": ([0, 1, 5, 1], 5)}


def _alpha(fl, main):
    return [op.outputs["Alpha"][0] for op in main.global_block().ops
            if op.type == "linear_chain_crf"]


@pytest.mark.parametrize("case", list(CRF_CASES))
def test_linear_chain_crf_matches_jax(case):
    lens, T = CRF_CASES[case]
    spec = {"x": _floats(16, lens, K, T=T, scale=2.0),
            "y": _labels(17, lens, 0, K, T=T)}
    got = _run(spec, lambda fl, v: [fl.layers.linear_chain_crf(
        v["x"], v["y"], param_attr=fl.ParamAttr(name="crfw"))],
        extra=_alpha, tol=REC_TOL)
    nll = got[0].reshape(-1)
    assert (nll[np.array(lens) == 0] == 0).all() and (nll >= -1e-5).all()


@pytest.mark.parametrize("case", list(CRF_CASES))
def test_crf_decoding_matches_jax(case):
    """The Viterbi path (and its lengths) and the 0/1 match against the
    label, both exact."""
    lens, T = CRF_CASES[case]
    spec = {"x": _floats(18, lens, K, T=T, scale=2.0),
            "y": _labels(19, lens, 0, K, T=T)}

    def body(fl, v):
        attr = fl.ParamAttr(name="crfw")
        fl.layers.linear_chain_crf(v["x"], v["y"], param_attr=attr)
        return [fl.layers.crf_decoding(v["x"], attr),
                fl.layers.crf_decoding(v["x"], attr, label=v["y"])]

    got = _run(spec, body, lod=(0, 1), grad=False)
    for b, n in enumerate(lens):
        assert (got[0][b, n:] == 0).all()
        np.testing.assert_array_equal(got[1][b, :n],
                                      got[0][b, :n] == spec["y"].data[b, :n])


def test_crf_decoding_ties_take_the_first_maximum():
    """Integer emissions and a zero transition: every step ties, and the
    path is the one the first maxima give, in both packages."""
    e = np.array([[[1, 1, 0, 1], [2, 0, 2, 2], [0, 0, 0, 0]],
                  [[0, 3, 3, 1], [1, 1, 1, 1], [5, 2, 5, 5]]], np.float32)
    spec = {"x": Ragged(e, [3, 2]), "y": _labels(25, [3, 2], 0, K, T=3)}

    def body(fl, v):
        attr = fl.ParamAttr(name="crfw",
                            initializer=fl.initializer.Constant(0.0))
        fl.layers.linear_chain_crf(v["x"], v["y"], param_attr=attr)
        return [fl.layers.crf_decoding(v["x"], attr)]

    got = _run(spec, body, lod=(0,), grad=False)
    assert got[0].tolist() == [[0, 0, 0], [1, 0, 0]]


# ---------------------------------------------------------------------------
# chunk_eval (test_chunk_eval_op.py)
# ---------------------------------------------------------------------------

NUM_TYPES = 3
#: scheme -> tag ids in [0, hi), the last (hi - 1) the Other tag
SCHEMES = {"IOB": 2 * NUM_TYPES + 1, "IOE": 2 * NUM_TYPES + 1,
           "IOBES": 4 * NUM_TYPES + 1, "plain": NUM_TYPES + 1}


@pytest.mark.parametrize("excluded", [None, [1]])
@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_chunk_eval_matches_jax(scheme, excluded):
    lens = [8, 6, 10, 0, 9]
    hi = SCHEMES[scheme]
    lab = _labels(20, lens, 0, hi, T=10)
    inf = Ragged(np.where(np.random.RandomState(21).rand(5, 10) < 0.3,
                          _labels(22, lens, 0, hi, T=10).data, lab.data),
                 lens)
    got = _run({"i": inf, "l": lab}, lambda fl, v: list(fl.layers.chunk_eval(
        v["i"], v["l"], chunk_scheme=scheme, num_chunk_types=NUM_TYPES,
        excluded_chunk_types=excluded)))
    p, r, f1, ni, nl, nc = got
    assert 0 < nc <= min(ni, nl) and p.dtype == np.float32
    if scheme == "IOB" and excluded is None:
        want = [_iob_chunks(a[:n]) for a, n in zip(inf.data, lens)]
        have = [_iob_chunks(b[:n]) for b, n in zip(lab.data, lens)]
        assert int(ni) == sum(map(len, want))
        assert int(nl) == sum(map(len, have))
        assert int(nc) == sum(len(a & b) for a, b in zip(want, have))


def _iob_chunks(tags):
    """(begin, end, type) chunks under IOB (test_struct_ops.py)."""
    chunks, start, cur = [], None, None
    for i, t in enumerate(tags):
        if t == NUM_TYPES * 2:
            if start is not None:
                chunks.append((start, i - 1, cur))
                start = None
            continue
        typ, tag = int(t) // 2, int(t) % 2
        if tag == 0 or start is None or typ != cur:
            if start is not None:
                chunks.append((start, i - 1, cur))
            start, cur = i, typ
    if start is not None:
        chunks.append((start, len(tags) - 1, cur))
    return set(chunks)


# ---------------------------------------------------------------------------
# nce, hsigmoid (test_nce_hsigmoid_op.py)
# ---------------------------------------------------------------------------

D = 5
NEGS = [1, 4, 6, 1]


def _nce_body(classes, negs=NEGS, weighted=False):
    def body(fl, v):
        cost = fl.layers.nce(v["x"], v["y"], num_total_classes=classes,
                             num_neg_samples=len(negs),
                             sample_weight=v["w"] if weighted else None)
        (op,) = [o for o in fl.default_main_program().global_block().ops
                 if o.type == "nce"]
        op.attrs["custom_neg_classes"] = list(negs)
        return [cost] + [op.outputs[s][0] for s in ("SampleLogits",
                                                    "SampleLabels")]
    return body


@pytest.mark.parametrize("weighted", [False, True])
def test_nce_custom_negatives_match_jax(weighted):
    """``custom_neg_classes`` (a repeated class among them): the costs,
    sample logits and labels, and the gradients with respect to the
    input, the weight and the bias."""
    r = np.random.RandomState(23)
    spec = {"x": r.randn(6, D).astype("float32"),
            "y": r.randint(0, 8, (6, 1)).astype("int64"),
            "w": r.rand(6, 1).astype("float32")}
    if not weighted:
        del spec["w"]
    got = _run(spec, _nce_body(8, weighted=weighted))
    assert got[2][:, 1:].tolist() == [NEGS] * 6
    assert (got[2][:, 0] == spec["y"][:, 0]).all()


def _nce_draws(classes, rows, negs, steps):
    """The default sampler's SampleLabels over ``steps`` runs of one
    Program through one executor."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[D], dtype="float32")
        y = tfluid.layers.data(name="y", shape=[1], dtype="int64")
        cost = tfluid.layers.nce(x, y, num_total_classes=classes,
                                 num_neg_samples=negs)
        (op,) = [o for o in main.global_block().ops if o.type == "nce"]
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.ones((rows, D), np.float32),
            "y": np.zeros((rows, 1), np.int64)}
    return [np.asarray(exe.run(main, feed=feed, scope=scope, fetch_list=[
        cost, op.outputs["SampleLabels"][0]])[1])[:, 1:] for _ in range(steps)]


def test_nce_default_sampler_is_uniform_and_draws_anew():
    """The port's negatives (its own generator) against the uniform law
    over the classes: a chi-square over 10 classes of 2 x 8,192 x 8
    draws below 27.88 (p = 0.001 at 9 degrees of freedom), every id in
    range, and the two steps' draws different."""
    classes = 10
    a, b = _nce_draws(classes, 8192, 8, 2)
    draws = np.concatenate([a.ravel(), b.ravel()])
    assert draws.min() >= 0 and draws.max() < classes
    counts = np.bincount(draws, minlength=classes)
    expect = draws.size / classes
    assert ((counts - expect) ** 2 / expect).sum() < 27.88, counts
    assert not np.array_equal(a, b)


@pytest.mark.parametrize("classes", [2, 6, 8, 11])
@pytest.mark.parametrize("bias", [True, False])
def test_hsigmoid_matches_jax(classes, bias):
    """The costs and the gradients with respect to the input, the
    weight and the bias, over every label of the tree."""
    r = np.random.RandomState(24 + classes)
    spec = {"x": r.randn(2 * classes, D).astype("float32"),
            "y": np.arange(2 * classes).reshape(-1, 1).astype("int64")
            % classes}
    got = _run(spec, lambda fl, v: [fl.layers.hsigmoid(
        v["x"], v["y"], num_classes=classes,
        bias_attr=None if bias else False)])
    assert (got[0] > 0).all()


def test_every_struct_rule_is_ported():
    """The port registers every rule of the JAX package's
    ``ops/struct_ops.py``, and none of them waits on the host."""
    from paddle_tpu import registry as jreg
    from paddle_tpu.ops import struct_ops as JSO
    import paddle_tpu_torch.ops.struct_ops as TSO

    def names(module, registry):
        return {t for t, fn in registry.RULES.items()
                if fn.__module__ == module.__name__}

    want = names(JSO, jreg)
    assert len(want) == 8 and want == names(TSO, treg)
    assert not any(treg.reads_host(t) for t in want)
