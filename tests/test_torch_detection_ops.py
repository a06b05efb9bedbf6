"""The detection op rules of the port
(``paddle_tpu_torch/ops/detection_ops.py``, all 14) against the JAX
package's on the CPU, one parametrised case an op or an edge of it,
after ``tests/unittests/test_detection_ops.py`` (10 cases) and
``test_rpn_ops_op.py`` (9).

Each case builds the same Program with each package through the layer
functions of ``layers/detection.py`` (``multiclass_nms`` also raw,
through ``LayerHelper``), copies the JAX startup's parameters into the
port and feeds both the same seeded batches, ground truth ragged where
the op takes lengths, through ``test_torch_sequence_ops._run``.  It
compares every output and the ``@LENGTHS`` of the outputs that carry
them, and, where the first output is differentiable, the gradients of
mean(first output) with respect to every float feed: float32 within
1e-5 relative and absolute (``_run``'s TOL; the perspective warp's 8 x 8
solves, LAPACK in both but factored in another order: 1e-4,
SOLVE_TOL), integers exactly.  Exact: the prior and anchor tables
(bitwise), match indices, ``target_assign``'s weights, NMS's kept rows,
labels and counts, the sampled indices and labels of
``rpn_target_assign`` and ``generate_proposal_labels``, and
``detection_map``'s state.

Edges, each a case: the prior tables under ``clip``, ``flip`` and
``min_max_aspect_ratios_order``; the IoU of degenerate boxes (zero
width, a point, identical and touching boxes, whose gradients split at
the ties); a ground-truth row of length 0 and IoU ties in
``bipartite_match``, under both match types; ``ssd_loss`` with a row
of no ground truth and with mining capped by the candidates, and its
gradients with respect to Loc and Conf; NMS over equal scores (the
lower index first), with every box under ``score_threshold`` and with
``keep_top_k`` above the survivors; ``detection_map`` pooled over two
batches, ``11point`` and difficult boxes.
"""
import importlib

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import registry as treg
from test_torch_sequence_ops import Ragged, _feed, _run

SOLVE_TOL = 1e-4


def _boxes(rng, shape, lo=0.0, span=0.5):
    """Random ``[..., 4]`` corner boxes: a corner in [lo, lo + span), a
    size in [0, span)."""
    xy = lo + rng.rand(*shape, 2) * span
    wh = rng.rand(*shape, 2) * span
    return np.concatenate([xy, xy + wh], -1).astype("float32")


def _op(fl, op_type, inputs, outputs, attrs):
    """``op_type`` appended raw; ``outputs`` maps each slot to its
    dtype.  Returns the output variables in ``outputs``' order."""
    helper = importlib.import_module(
        fl.__name__ + ".layer_helper").LayerHelper(op_type)
    outs = {s: helper.create_variable_for_type_inference(dtype=d)
            for s, d in outputs.items()}
    helper.append_op(type=op_type, inputs={k: [v] for k, v in inputs.items()},
                     outputs={s: [v] for s, v in outs.items()}, attrs=attrs)
    return list(outs.values())


def test_every_detection_rule_is_ported_and_none_reads_the_host():
    from paddle_tpu import registry as jreg
    from paddle_tpu.ops import detection_ops as JD
    import paddle_tpu_torch.ops.detection_ops as TD

    def names(module, registry):
        return {t for t, fn in registry.RULES.items()
                if fn.__module__ == module.__name__}

    want = names(JD, jreg)
    assert len(want) == 14 and want == names(TD, treg)
    assert not any(treg.reads_host(t) for t in want)


# ---------------------------------------------------------------------------
# priors and anchors (test_prior_box_shapes_and_values)
# ---------------------------------------------------------------------------


def test_prior_and_anchor_tables_bitwise_equal_jax():
    """Every combination of clip, flip and the min-max order, two min
    and max sizes, on a non-square image and map; anchors too: the
    tables and variances bitwise the JAX package's numpy ones."""
    def build(fl, v):
        out = []
        for clip in (False, True):
            for flip in (False, True):
                for order in (False, True):
                    out += fl.layers.prior_box(
                        input=v["fm"], image=v["img"], min_sizes=[7.0, 11.0],
                        max_sizes=[15.0, 21.0], aspect_ratios=[2.0, 3.0],
                        flip=flip, clip=clip, min_max_aspect_ratios_order=order)
        out += fl.layers.prior_box(input=v["fm"], image=v["img"],
                                   min_sizes=[8.0], steps=[6.0, 7.0],
                                   offset=0.25, variance=[0.3, 0.1, 0.7, 0.2])
        out += fl.layers.anchor_generator(
            v["fm"], anchor_sizes=[32.0, 64.0, 128.0],
            aspect_ratios=[0.5, 1.0, 2.0], stride=[16.0, 12.0], offset=0.3)
        return out

    spec = {"img": np.zeros((1, 3, 32, 30), "float32"),
            "fm": np.zeros((1, 8, 5, 4), "float32")}
    got = _run(spec, build, grad=False, tol=0.0)
    assert got[0].shape == (5, 4, 8, 4) and got[-2].shape == (5, 4, 9, 4)
    clipped = got[8]
    assert clipped.min() == 0.0 and clipped.max() == 1.0
    # cell (0, 0) of the reference case: center (4, 4) at step 8
    ref = _run({"img": np.zeros((1, 3, 32, 32), "float32"),
                "fm": np.zeros((1, 8, 4, 4), "float32")},
               lambda fl, v: list(fl.layers.prior_box(
                   input=v["fm"], image=v["img"], min_sizes=[8.0],
                   max_sizes=[16.0], aspect_ratios=[2.0], flip=True,
                   clip=True)), grad=False, tol=0.0)
    np.testing.assert_array_equal(ref[0][0, 0, 0], np.float32([0, 0, .25, .25]))


# ---------------------------------------------------------------------------
# IoU, matching, coding, assignment
# ---------------------------------------------------------------------------

_DEGENERATE = np.float32([
    [0.1, 0.1, 0.1, 0.5],     # zero width
    [0.3, 0.3, 0.3, 0.3],     # a point
    [0.2, 0.2, 0.6, 0.6],
    [0.2, 0.2, 0.6, 0.6],     # the same box again
    [0.6, 0.2, 0.9, 0.6],     # touching the one before
])

IOU_CASES = {
    "random": lambda r: (_boxes(r, (5,)), _boxes(r, (7,))),
    "degenerate": lambda r: (_DEGENERATE, _DEGENERATE[::-1].copy()),
}


@pytest.mark.parametrize("case", list(IOU_CASES))
def test_iou_similarity_matches_jax(case):
    x, y = IOU_CASES[case](np.random.RandomState(0))
    got = _run({"x": x, "y": y},
               lambda fl, v: [fl.layers.iou_similarity(v["x"], v["y"])])
    if case == "degenerate":
        assert got[0][2, 2] == 1.0 and got[0][0, 0] == 0.0


def test_iou_similarity_keeps_the_lengths_of_x():
    rng = np.random.RandomState(1)
    x = Ragged(_boxes(rng, (3, 4)), [4, 0, 2])
    _run({"x": x, "y": _boxes(rng, (6,))},
         lambda fl, v: [fl.layers.iou_similarity(v["x"], v["y"])], lod=(0,))


def _tied_dist(rng, B, G, M):
    """Similarities of a few levels only, so that the global argmax and
    the column argmax meet ties."""
    return (rng.randint(0, 4, size=(B, G, M)) * 0.25).astype("float32")


#: bipartite_match cases: (dist, lengths or None for a dense feed)
MATCH_CASES = {
    # the reference's greedy example: (0, 0) = 0.9 first, then gt 1 -> 1
    "greedy": (np.float32([[[0.9, 0.2, 0.1], [0.8, 0.7, 0.3]]]), [2]),
    "ragged_ties": (_tied_dist(np.random.RandomState(2), 3, 4, 9),
                    [3, 0, 4]),
    "random_dense": (np.random.RandomState(3).rand(2, 3, 8)
                     .astype("float32"), None),
}


@pytest.mark.parametrize("match_type", ["bipartite", "per_prediction"])
@pytest.mark.parametrize("case", list(MATCH_CASES))
def test_bipartite_match_matches_jax(case, match_type):
    dist, lens = MATCH_CASES[case]
    spec = {"d": Ragged(dist, lens) if lens is not None else dist}
    got = _run(spec, lambda fl, v: list(fl.layers.bipartite_match(
        v["d"], match_type=match_type, dist_threshold=0.3)))
    if case == "greedy" and match_type == "bipartite":
        np.testing.assert_array_equal(got[0][0], [0, 1, -1])
    if case == "ragged_ties":
        assert (got[0][1] == -1).all()   # the row of no ground truth


BOX_CODER_CASES = ["roundtrip", "unnormalized", "encode_batched"]


@pytest.mark.parametrize("case", BOX_CODER_CASES)
def test_box_coder_matches_jax(case):
    """Decode then encode (test_box_coder_roundtrip: the diagonal of the
    encoding gives the codes back); ``box_normalized=False``; an encode
    of a ``[B, N, 4]`` target."""
    rng = np.random.RandomState(4)
    M = 6
    prior = np.sort(rng.rand(M, 2, 2), axis=1).reshape(M, 4).astype("float32")
    pvar = np.full((M, 4), 0.1, "float32")
    codes = (rng.randn(2, M, 4) * 0.2).astype("float32")
    spec = {"p": prior, "v": pvar, "c": codes}

    def build(fl, v):
        L = fl.layers
        if case == "encode_batched":
            return [L.box_coder(v["p"], v["v"], L.abs(v["c"]) + 0.1,
                                code_type="encode_center_size")]
        norm = case == "roundtrip"
        dec = L.box_coder(v["p"], v["v"], v["c"], box_normalized=norm,
                          code_type="decode_center_size")
        return [dec, L.box_coder(v["p"], v["v"], dec, box_normalized=norm,
                                 code_type="encode_center_size")]

    got = _run(spec, build)
    if case == "roundtrip":
        for m in range(M):
            np.testing.assert_allclose(got[1][0, m, m], codes[0, m],
                                       rtol=1e-3, atol=1e-4)


def test_target_assign_matches_jax():
    rng = np.random.RandomState(5)
    x = Ragged(rng.randn(3, 4, 2).astype("float32"), [4, 1, 3])
    midx = rng.randint(-1, 4, size=(3, 7)).astype("int32")
    midx[1] = np.minimum(midx[1], 0)
    got = _run({"x": x, "m": midx}, lambda fl, v: list(
        fl.layers.target_assign(v["x"], v["m"], mismatch_value=-3)))
    np.testing.assert_array_equal(got[1][..., 0], midx >= 0)
    assert (got[0][midx < 0] == -3).all()


# ---------------------------------------------------------------------------
# the SSD loss and detection_output (test_ssd_loss_and_detection_output_run)
# ---------------------------------------------------------------------------

#: ssd_loss cases: (gt lengths, ssd_loss kwargs)
SSD_CASES = {
    "reference": ([3, 2], {}),
    "row_without_gt": ([3, 0, 2], {}),
    "bipartite_mining_capped": ([3, 2], dict(neg_pos_ratio=20.0,
                                             match_type="bipartite",
                                             overlap_threshold=0.3)),
}


def _ssd_spec(lens, M=24, C=5, G=3, seed=0):
    rng = np.random.RandomState(seed)
    B = len(lens)
    prior = np.sort(rng.rand(M, 2, 2), axis=1).reshape(M, 4).astype("float32")
    return {
        "l": (rng.randn(B, M, 4) * 0.1).astype("float32"),
        "c": rng.randn(B, M, C).astype("float32"),
        "gb": Ragged(np.sort(rng.rand(B, G, 2, 2), axis=2).reshape(B, G, 4)
                     .astype("float32"), lens),
        "gl": Ragged(rng.randint(1, C, size=(B, G)).astype("int64"), lens),
        "p": prior, "pv": np.full((M, 4), 0.1, "float32")}


@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_loss_and_its_gradients_match_jax(case):
    """The loss ``[B, 1]`` and the gradients of its mean with respect to
    Loc, Conf, the boxes and the priors, beside the reference case's
    detection_output."""
    lens, kw = SSD_CASES[case]
    spec = _ssd_spec(lens)

    def build(fl, v):
        L = fl.layers
        loss = L.ssd_loss(v["l"], v["c"], v["gb"], v["gl"], v["p"], v["pv"],
                          **kw)
        if case != "reference":
            return [loss]
        return [loss, L.detection_output(v["l"], v["c"], v["p"], v["pv"],
                                         nms_threshold=0.45, keep_top_k=10)]

    got = _run(spec, build, lod=(1,) if case == "reference" else ())
    loss = got[0]
    assert loss.shape == (len(lens), 1) and np.isfinite(loss).all()
    if case == "row_without_gt":
        assert loss[1, 0] == 0.0 and (loss[[0, 2]] > 0).all()
    if case == "reference":
        out = got[1]
        assert out.shape == (2, 10, 6)
        valid = out[out[:, :, 0] >= 0]
        assert (valid[:, 0] >= 1).all() and (valid[:, 1] <= 1).all()


def test_ssd_mining_is_capped_by_the_candidates():
    """At 20 negatives a positive the candidates run out: the loss is
    then the loss at 1000 a positive, exactly (the cap, not the ratio,
    decides)."""
    spec = _ssd_spec([3, 2])

    def build(ratio):
        return lambda fl, v: [fl.layers.ssd_loss(
            v["l"], v["c"], v["gb"], v["gl"], v["p"], v["pv"],
            neg_pos_ratio=ratio)]

    capped = _run(spec, build(20.0), grad=False)[0]
    np.testing.assert_array_equal(capped, _run(spec, build(1000.0),
                                               grad=False)[0])
    assert not np.array_equal(capped, _run(spec, build(1.0), grad=False)[0])


# ---------------------------------------------------------------------------
# multiclass NMS (test_nms_suppresses_overlaps)
# ---------------------------------------------------------------------------


def _nms(spec, **attrs):
    def build(fl, v):
        a = dict(background_label=0, score_threshold=0.01,
                 nms_threshold=0.5, nms_top_k=400, keep_top_k=200,
                 nms_eta=1.0)
        a.update(attrs)
        return _op(fl, "multiclass_nms", {"BBoxes": v["b"], "Scores": v["s"]},
                   {"Out": "float32"}, a)
    return _run(spec, build, lod=(0,), grad=False)


def _nms_spec(B=2, C=4, M=12, seed=6, levels=None):
    rng = np.random.RandomState(seed)
    s = (rng.randint(0, levels, size=(B, C, M)) / float(levels)
         if levels else rng.rand(B, C, M))
    return {"b": _boxes(rng, (B, M), span=0.4), "s": s.astype("float32")}


NMS_CASES = {
    "random": (dict(), dict(nms_top_k=8, keep_top_k=10)),
    "equal_scores": (dict(levels=3), dict(nms_top_k=9, keep_top_k=12)),
    "all_below_threshold": (dict(), dict(score_threshold=1.5)),
    "keep_top_k_above_survivors": (dict(M=5, C=3), dict(keep_top_k=50)),
    "background_2": (dict(), dict(background_label=2, nms_threshold=0.2)),
}


@pytest.mark.parametrize("case", list(NMS_CASES))
def test_multiclass_nms_matches_jax(case):
    spec_kw, attrs = NMS_CASES[case]
    out, counts = _nms(_nms_spec(**spec_kw), **attrs)
    assert counts.dtype.kind == "i"
    for b, n in enumerate(counts):
        assert (out[b, :n, 0] >= 0).all() and (out[b, n:] == -1).all()
    if case == "all_below_threshold":
        assert (counts == 0).all()
    if case == "keep_top_k_above_survivors":
        assert out.shape == (2, 15, 6)


def test_detection_output_suppresses_overlaps():
    """The reference's three boxes, two nearly the same: NMS keeps the
    first and the third."""
    prior = np.float32([[0.1, 0.1, 0.4, 0.4], [0.1, 0.1, 0.41, 0.41],
                        [0.6, 0.6, 0.9, 0.9]])
    conf = np.zeros((1, 3, 2), "float32")
    conf[0, :, 1] = [5.0, 4.0, 3.0]
    conf[0, :, 0] = -5.0
    spec = {"l": np.zeros((1, 3, 4), "float32"), "c": conf, "p": prior}
    got = _run(spec, lambda fl, v: [fl.layers.detection_output(
        v["l"], v["c"], v["p"], None, nms_threshold=0.5, keep_top_k=5)],
        lod=(0,), grad=False)
    kept = got[0][0][got[0][0, :, 0] >= 0]
    assert len(kept) == 2 and got[1][0] == 2
    np.testing.assert_allclose(kept[:, 2:], prior[[0, 2]], atol=1e-5)


def test_multiclass_nms_runs_only_when_its_output_is_read(monkeypatch):
    """The training Program of ``models.ssd`` holds ``detection_output``
    beside the loss: fetching the loss alone runs no NMS loop, fetching
    the detections runs it once."""
    from paddle_tpu_torch.ops import detection_ops as TD

    calls = []
    keep = TD._nms_keep
    monkeypatch.setattr(TD, "_nms_keep",
                        lambda *a: calls.append(1) or keep(*a))
    spec = _ssd_spec([3, 2])
    L = tfluid.layers
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        v = {n: L.data(name=n, shape=list(spec[n].shape), dtype="float32",
                       append_batch_size=False)
             for n in ("l", "c", "p", "pv")}
        v["gb"] = L.data(name="gb", shape=[4], dtype="float32", lod_level=1)
        v["gl"] = L.data(name="gl", shape=[], dtype="int64", lod_level=1)
        loss = L.ssd_loss(v["l"], v["c"], v["gb"], v["gl"], v["p"], v["pv"])
        out = L.detection_output(v["l"], v["c"], v["p"], v["pv"])
    feed = _feed(spec)(tfluid)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(main, feed=feed, fetch_list=[loss], scope=tfluid.Scope())
    assert calls == []
    exe.run(main, feed=feed, fetch_list=[out], scope=tfluid.Scope())
    assert calls == [1]


# ---------------------------------------------------------------------------
# the RPN stack and the EAST transforms (test_rpn_ops_op.py)
# ---------------------------------------------------------------------------


def test_polygon_box_transform_matches_jax():
    x = np.random.RandomState(0).randn(2, 4, 3, 5).astype("float32")
    _run({"x": x}, lambda fl, v: [fl.layers.polygon_box_transform(v["x"])])


def _grid_anchors(H, W, A):
    anchors = np.zeros((H, W, A, 4), "float32")
    for i in range(H):
        for j in range(W):
            for a in range(A):
                cx, cy, s = j * 10 + 5, i * 10 + 5, 6 + 4 * a
                anchors[i, j, a] = [cx - s, cy - s, cx + s, cy + s]
    return anchors


def _proposal_spec(case):
    rng = np.random.RandomState(1)
    if case == "clamps_huge_deltas":
        d = np.zeros((1, 4, 1, 1), "float32")
        d[0, 2:] = 10.0
        return ({"s": np.ones((1, 1, 1, 1), "float32"), "d": d,
                 "i": np.float32([[1000.0, 1000.0, 1.0]]),
                 "a": np.float32([10, 10, 19, 19]).reshape(1, 1, 1, 4),
                 "v": np.ones((1, 1, 1, 4), "float32")},
                dict(pre_nms_top_n=1, post_nms_top_n=1, min_size=1.0))
    B, A, H, W = (1, 2, 3, 3) if case == "decode_and_nms" else (2, 3, 4, 5)
    spec = {"s": rng.rand(B, A, H, W).astype("float32"),
            "d": (rng.randn(B, 4 * A, H, W) * 0.1).astype("float32"),
            "i": np.float32([[32.0, 32.0, 1.0], [40.0, 36.0, 1.5]][:B]),
            "a": _grid_anchors(H, W, A),
            "v": np.ones((H, W, A, 4), "float32")}
    if case == "decode_and_nms":
        return spec, dict(pre_nms_top_n=A * H * W, post_nms_top_n=6,
                          nms_thresh=0.6, min_size=1.0)
    spec["v"] = rng.uniform(0.5, 1.5, (H, W, A, 4)).astype("float32")
    return spec, dict(pre_nms_top_n=40, post_nms_top_n=12, nms_thresh=0.4,
                      min_size=2.0)


@pytest.mark.parametrize("case", ["decode_and_nms", "clamps_huge_deltas",
                                  "batched"])
def test_generate_proposals_matches_jax(case):
    spec, kw = _proposal_spec(case)
    got = _run(spec, lambda fl, v: list(fl.layers.generate_proposals(
        v["s"], v["d"], v["i"], v["a"], v["v"], **kw)), lod=(0, 1),
        grad=False)
    rois, counts = got[0], got[2]
    assert (counts > 0).all()
    if case == "clamps_huge_deltas":
        assert rois[0, 0, 2] - rois[0, 0, 0] + 1 <= 10 * (1000.0 / 16.0) + 1


def _rpn_spec(case):
    if case == "labels":
        anchors = np.float32([[0, 0, 10, 10], [20, 20, 30, 30],
                              [100, 100, 110, 110], [6, 6, 14, 14]])
        gt = Ragged(np.float32([[[0, 0, 10, 10], [21, 21, 30, 30]]]), [2])
        pred = np.tile(np.arange(4, dtype="float32")[None, :, None], (1, 1, 4))
        kw = dict(rpn_batch_size_per_im=4)
    elif case == "padded_gt_keeps_forced_fg":
        anchors = np.float32([[0, 0, 10, 10], [50, 50, 60, 60]])
        gt = Ragged(np.float32([[[0, 0, 7, 7], [0, 0, 0, 0]]]), [1])
        pred = np.zeros((1, 2, 4), "float32")
        kw = dict(rpn_batch_size_per_im=2)
    else:
        rng = np.random.RandomState(7)
        anchors = _boxes(rng, (30,), span=40.0)
        gt = Ragged(_boxes(rng, (2, 3), span=40.0), [3, 1])
        pred = rng.randn(2, 30, 4).astype("float32")
        kw = dict(rpn_batch_size_per_im=8, rpn_positive_overlap=0.5)
    B, N = pred.shape[:2]
    logits = np.arange(B * N, dtype="float32").reshape(B, N, 1)
    return ({"p": pred, "l": logits, "a": anchors,
             "var": np.full_like(anchors, 0.5), "g": gt}, kw)


@pytest.mark.parametrize("case", ["labels", "padded_gt_keeps_forced_fg",
                                  "random"])
def test_rpn_target_assign_matches_jax(case):
    spec, kw = _rpn_spec(case)
    got = _run(spec, lambda fl, v: list(fl.layers.rpn_target_assign(
        v["p"], v["l"], v["a"], v["var"], v["g"], **kw)), lod=(0, 1, 2, 3))
    label = got[2]
    if case == "labels":
        assert label[0, 0, 0] == 1 and label[0, 1, 0] == 1
        assert set(got[1][0, :2, 0]) == {0.0, 1.0}
        assert (label[0, 2:, 0] == 0).all()
    if case == "padded_gt_keeps_forced_fg":
        assert label[0, 0, 0] == 1


def _labels_spec(case):
    if case == "classes_and_targets":
        return ({"r": Ragged(np.float32([[[0, 0, 10, 10], [18, 18, 31, 31],
                                          [50, 50, 60, 60]]]), [3]),
                 "c": np.int64([[3, 7]]),
                 "b": Ragged(np.float32([[[0, 0, 10, 10], [20, 20, 30, 30]]]),
                             [2])},
                dict(batch_size_per_im=8, fg_fraction=0.5,
                     bbox_reg_weights=(1.0, 1.0, 1.0, 1.0), class_nums=10))
    if case == "no_gt_yields_background":
        return ({"r": np.float32([[[0, 0, 10, 10], [20, 20, 30, 30]]]),
                 "c": Ragged(np.zeros((1, 1), "int64"), [0]),
                 "b": Ragged(np.zeros((1, 1, 4), "float32"), [0])},
                dict(batch_size_per_im=4, class_nums=5))
    rng = np.random.RandomState(8)
    return ({"r": Ragged(_boxes(rng, (2, 9), span=30.0), [9, 6]),
             "c": rng.randint(1, 6, size=(2, 3)).astype("int64"),
             "b": Ragged(_boxes(rng, (2, 3), span=30.0), [3, 2])},
            dict(batch_size_per_im=10, fg_fraction=0.3, fg_thresh=0.3,
                 bg_thresh_hi=0.3, bg_thresh_lo=0.05, class_nums=6))


@pytest.mark.parametrize("case", ["classes_and_targets",
                                  "no_gt_yields_background", "random"])
def test_generate_proposal_labels_matches_jax(case):
    spec, kw = _labels_spec(case)
    got = _run(spec, lambda fl, v: list(fl.layers.generate_proposal_labels(
        v["r"], v["c"], v["b"], **kw)), lod=(0, 1, 2, 3, 4))
    rois, labels, inw = got[0], got[1][..., 0], got[3]
    if case == "classes_and_targets":
        assert 3 in labels[0] and 7 in labels[0]
        for row, c in enumerate(labels[0]):
            if c > 0:
                assert inw[0, row, 4 * c:4 * c + 4].sum() == 4
                assert inw[0, row].sum() == 4
    if case == "no_gt_yields_background":
        assert (labels[0, :2] == 0).all() and np.abs(rois[0, :2]).sum() > 0


def _quads(rng, R, W, H):
    """Convex quads: the image rectangle shrunk and jittered."""
    base = np.float32([0, 0, W - 1, 0, W - 1, H - 1, 0, H - 1])
    inset = np.float32([1, 1, -1, 1, -1, -1, 1, -1])
    return (base + inset * rng.uniform(0.2, 1.5, (R, 8))).astype("float32")


@pytest.mark.parametrize("case", ["identity_quad", "random_quads"])
def test_roi_perspective_transform_matches_jax(case):
    rng = np.random.RandomState(2)
    if case == "identity_quad":
        x = rng.randn(1, 1, 6, 6).astype("float32")
        spec = {"x": x, "r": np.float32([[0, 0, 5, 0, 5, 5, 0, 5]])}
        size = (6, 6)
    else:
        spec = {"x": rng.randn(1, 2, 7, 9).astype("float32"),
                "r": _quads(rng, 3, 9, 7)}
        size = (4, 5)
    got = _run(spec, lambda fl, v: [fl.layers.roi_perspective_transform(
        v["x"], v["r"], *size, spatial_scale=1.0)], tol=SOLVE_TOL)
    if case == "identity_quad":
        np.testing.assert_allclose(got[0][0, 0], spec["x"][0, 0], rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# detection_map (test_detection_map_*, test_detection_map_in_graph_*)
# ---------------------------------------------------------------------------

_PAD = [[-1, 0, 0, 0, 0, 0]]


def _map_batch(det, gtb, gtl, lens, diff=None):
    spec = {"d": np.float32(det), "b": Ragged(np.float32(gtb), lens),
            "l": np.int64(gtl)}
    if diff is not None:
        spec["df"] = np.int64(diff)
    return spec


MAP_CASES = {
    # test_detection_map_in_graph_matches_host_metric
    "in_graph": (_map_batch(
        [[[1, 0.9, 0, 0, 1, 1], [1, 0.6, 5, 5, 6, 6]] + _PAD * 2,
         [[2, 0.8, 2, 2, 3, 3]] + _PAD * 3],
        [[[0, 0, 1, 1], [0, 0, 0, 0]], [[2, 2, 3, 3], [5, 5, 6, 6]]],
        [[1, 0], [2, 1]], [1, 2]), 3, 0.5),
    # test_detection_map_metric: a hit and a miss, AP 0.5
    "metric": (_map_batch(
        [[[1, 0.9, 0.1, 0.1, 0.3, 0.3], [1, 0.8, 0.0, 0.6, 0.1, 0.9]]
         + _PAD],
        [[[0.1, 0.1, 0.3, 0.3], [0.5, 0.5, 0.8, 0.8]]], [[1, 1]], [2]),
        3, 0.3),
    # test_detection_map_difficult_neutral_rule
    "difficult": (_map_batch(
        [[[1, 0.9, 0, 0, 1, 1], [1, 0.8, 4, 4, 5, 5]]],
        [[[0, 0, 1, 1], [4, 4, 5, 5]]], [[1, 1]], [2], diff=[[1, 0]]),
        2, 0.5),
}


def _map(spec, class_num, ov, ap="integral", states=False, cap=8):
    def build(fl, v):
        kw = {}
        if "df" in v:
            kw = dict(gt_difficult=v["df"], evaluate_difficult=False)
        if states:
            kw["input_states"] = [v["pc"], v["tp"], v["fp"]]
        return list(fl.layers.detection_map(
            v["d"], v["b"], v["l"], class_num=class_num,
            overlap_threshold=ov, ap_version=ap, state_capacity=cap, **kw))
    return _run(spec, build, grad=False)


@pytest.mark.parametrize("ap", ["integral", "11point"])
@pytest.mark.parametrize("case", list(MAP_CASES))
def test_detection_map_matches_jax(case, ap):
    spec, class_num, ov = MAP_CASES[case]
    m, pc, tp, fp = _map(spec, class_num, ov, ap)
    if case == "in_graph":
        np.testing.assert_array_equal(pc.ravel(), [0, 2, 1])
    if case == "metric" and ap == "integral":
        np.testing.assert_allclose(m, 0.5, atol=1e-6)
    if case == "difficult":
        assert pc.ravel()[1] == 1 and (tp[1, :, 0] >= 0).sum() == 1
        assert (fp[1, :, 0] >= 0).sum() == 0 and m[0] == 1.0


#: two batches pooled through the state (test_detection_map_pools_tp_fp_
#: across_batches, test_detection_map_evaluator_accumulates_across_batches)
POOL_CASES = {
    "pools_tp_fp": ([_map_batch([[[1, 0.9, 0, 0, 1, 1]] + _PAD * 3],
                                [[[0, 0, 1, 1]]], [[1]], [1]),
                     _map_batch([[[1, 0.95, 5, 5, 6, 6],
                                  [1, 0.5, 0, 0, 1, 1]] + _PAD * 2],
                                [[[0, 0, 1, 1]]], [[1]], [1])], 2 / 3),
    "evaluator": ([_map_batch([[[1, 0.9, 0, 0, 1, 1]] + _PAD * 2],
                              [[[0, 0, 1, 1]]], [[1]], [1]),
                   _map_batch([[[1, 0.6, 5, 5, 6, 6]] + _PAD * 2],
                              [[[4, 4, 5, 5]]], [[1]], [1])], 0.5),
}


@pytest.mark.parametrize("ap", ["integral", "11point"])
@pytest.mark.parametrize("case", list(POOL_CASES))
def test_detection_map_pools_two_batches_like_jax(case, ap):
    (first, second), pooled = POOL_CASES[case]
    _, pc, tp, fp = _map(first, 2, 0.5, ap)
    m, *_ = _map(dict(second, pc=pc.astype("int32"), tp=tp, fp=fp), 2, 0.5,
                 ap, states=True)
    if ap == "integral":
        np.testing.assert_allclose(m, pooled, rtol=1e-6)
