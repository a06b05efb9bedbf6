"""The nn op rules of the port that came last (``paddle_tpu_torch/ops/
nn_ops.py``: the 3-D and transposed convolutions, ``pool3d``, ``lrn``,
the losses, ``auc``, ``mean_iou``, ``im2sequence``, the image resizes
and ``roi_pool``) against the JAX package's on the CPU, one
parametrised case an op or an edge of it, after the matching
``tests/unittests/test_*_op.py`` cases.

Each case builds the same one-op Program with each package (the op
appended raw through ``LayerHelper``), copies the JAX startup's state
into the port (``test_torch_tensor_ops._case``), runs both on the same
seeded numpy feed and compares the outputs, float32 to 1e-5 relative and
absolute and integer ones exactly, and the gradients of mean(first
output) through ``calc_gradient``, 1e-5.

Traps of a line-by-line port, each a case:
- ``auc`` on a one-column ``Predict`` scores column 0 (the JAX
  package's ``prob[:, 1]`` clamps the index); the histograms count ids
  the same way on every run;
- gradients at a tie: ``sigmoid_cross_entropy_with_logits`` at x = 0
  with label 0 has gradient exactly 0 (``jnp.maximum`` splits the tie,
  ``|x|`` has slope +1 at 0), ``margin_rank_loss`` at z = 0 a half
  share, ``roi_pool`` splits a cell's gradient equally among tied
  maxima;
- ``bilinear_interp`` antialiases when it shrinks an axis and
  ``nearest_interp`` takes half-pixel centres (``jax.image.resize``);
- ``lrn``'s ``alpha`` is not divided by ``n``; ``rank_loss`` overflows
  to inf at d = 100 as the JAX package's does;
- ``mean_iou``'s confusion matrix wraps a negative index and drops one
  out of range; ``im2sequence``'s paddings are [top, left, bottom,
  right]; ``roi_pool`` gives -inf for a cell that covers no pixel;
- ``conv3d_transpose`` ignores ``dilations`` and ``groups``, as the
  JAX package's rule does; ``conv2d_transpose`` takes both.
"""
import numpy as np
import pytest

import paddle_tpu_torch as tfluid
from test_torch_tensor_ops import _case


def _rand(seed, shape, lo=-2.0, hi=2.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype("float32")


def _randn(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype("float32")


def _f32(rows):
    return np.array(rows, "float32")


# ---------------------------------------------------------------------------
# convolutions and pooling (test_conv2d_transpose_op.py,
# test_conv3d_pool3d_op.py, test_norm_ops_op.py's lrn)
# ---------------------------------------------------------------------------

#: (input shape, filter shape, attrs)
CONVS = {
    "conv3d": ((1, 2, 4, 5, 5), (3, 2, 3, 3, 3), {"paddings": [1, 1, 1]}),
    "conv3d stride dilation": ((2, 2, 6, 7, 5), (3, 2, 2, 3, 2),
                               {"strides": [2, 1, 2], "paddings": [1, 0, 1],
                                "dilations": [2, 1, 1]}),
    "conv3d groups": ((1, 4, 4, 4, 4), (6, 2, 3, 3, 3),
                      {"paddings": [1, 1, 1], "groups": 2}),
    "conv2d_transpose": ((2, 3, 5, 5), (3, 4, 3, 3), {}),
    "conv2d_transpose stride padding": ((2, 3, 5, 5), (3, 4, 3, 3),
                                        {"strides": [2, 2], "paddings": [1, 1]}),
    "conv2d_transpose grads": ((2, 3, 4, 4), (3, 2, 3, 3),
                               {"strides": [2, 2], "paddings": [1, 1]}),
    "conv2d_transpose groups dilation": ((2, 4, 5, 4), (4, 3, 3, 2),
                                         {"strides": [2, 1], "paddings": [1, 0],
                                          "dilations": [2, 2], "groups": 2}),
    "conv3d_transpose": ((1, 2, 3, 3, 3), (2, 2, 2, 2, 2), {"strides": [2, 2, 2]}),
    "conv3d_transpose padding": ((1, 2, 3, 4, 3), (2, 3, 3, 3, 3),
                                 {"strides": [2, 1, 2], "paddings": [1, 1, 0]}),
    # the JAX package's rule reads neither attribute: the output is the
    # dilation-1, one-group convolution's, [1, 4, 5, 5, 5]
    "conv3d_transpose dilation ignored": ((1, 2, 3, 3, 3), (2, 4, 3, 3, 3),
                                          {"dilations": [2, 2, 2]}),
    "conv3d_transpose groups ignored": ((1, 2, 3, 3, 3), (2, 4, 3, 3, 3),
                                        {"groups": 2}),
}


@pytest.mark.parametrize("case", list(CONVS))
def test_convolution_matches_jax(case):
    xs, ws, attrs = CONVS[case]
    got, _ = _case({"x": _randn(1, xs), "w": _randn(2, ws, 0.5)},
                   case.split()[0], {"Input": ["x"], "Filter": ["w"]},
                   {"Output": 1}, attrs)
    if "ignored" in case:
        assert got[0].shape == (1, 4, 5, 5, 5)


def test_conv3d_transpose_ignores_dilations_and_groups():
    x, w = _randn(1, (1, 2, 3, 3, 3)), _randn(2, (2, 4, 3, 3, 3), 0.5)
    outs = [_case({"x": x, "w": w}, "conv3d_transpose",
                  {"Input": ["x"], "Filter": ["w"]}, {"Output": 1}, attrs)[0]
            for attrs in ({}, {"dilations": [2, 2, 2]}, {"groups": 2})]
    for o in outs[1:]:
        for a, b in zip(o, outs[0]):
            np.testing.assert_array_equal(a, b)


#: pool3d: (pooling type, ksize, strides, paddings, ceil_mode, exclusive,
#: global, input shape)
POOLS = {
    "max": ("max", 2, 2, 0, False, True, False, (1, 2, 4, 4, 4)),
    "avg": ("avg", 2, 2, 0, False, True, False, (1, 2, 4, 4, 4)),
    "max padded": ("max", 3, 2, 1, False, True, False, (2, 2, 5, 6, 5)),
    "max ceil": ("max", 3, 2, 0, True, True, False, (1, 2, 6, 6, 5)),
    # the last window starts in the right padding: -inf for max, 0/0 for
    # the exclusive average, as in the JAX package
    "max ceil window in padding": ("max", 2, 2, 1, True, True, False,
                                   (1, 1, 5, 5, 5)),
    "avg padded exclusive": ("avg", 3, 2, 1, False, True, False, (1, 2, 5, 5, 5)),
    "avg padded inclusive": ("avg", 3, 2, 1, False, False, False, (1, 2, 5, 5, 5)),
    "avg ceil exclusive": ("avg", 3, 2, 0, True, True, False, (1, 2, 6, 6, 6)),
    "avg ceil inclusive": ("avg", 3, 2, 0, True, False, False, (1, 2, 6, 6, 6)),
    "global avg": ("avg", 2, 1, 0, False, True, True, (2, 3, 3, 4, 5)),
}


@pytest.mark.parametrize("case", list(POOLS))
def test_pool3d_matches_jax(case):
    ptype, k, st, pad, ceil, excl, glob, shape = POOLS[case]
    x = (np.random.RandomState(2).permutation(int(np.prod(shape)))
         .reshape(shape) * 0.09).astype("float32")
    got, _ = _case({"x": x}, "pool3d", {"X": ["x"]}, {"Out": 1},
                   {"pooling_type": ptype, "ksize": [k] * 3, "strides": [st] * 3,
                    "paddings": [pad] * 3, "ceil_mode": ceil,
                    "exclusive": excl, "global_pooling": glob})
    if case == "max ceil window in padding":
        assert np.isneginf(got[0]).any()


@pytest.mark.parametrize("n,k,alpha,beta", [(5, 1.0, 1e-2, 0.75),
                                            (5, 2.0, 1e-4, 0.75),
                                            (3, 1.0, 0.5, 0.5)])
def test_lrn_matches_jax(n, k, alpha, beta):
    x = _rand(2, (2, 6, 4, 4), 0.0, 1.0) * 3
    got, _ = _case({"x": x}, "lrn", {"X": ["x"]}, {"Out": 1, "MidOut": 1},
                   {"n": n, "k": k, "alpha": alpha, "beta": beta})
    # alpha multiplies the window's sum as it is (F.local_response_norm
    # divides it by n)
    sq = np.zeros_like(x, np.float64)
    for c in range(x.shape[1]):
        sq[:, c] = (x[:, max(0, c - n // 2):c + n // 2 + 1].astype(np.float64)
                    ** 2).sum(1)
    np.testing.assert_allclose(got[1], k + alpha * sq, rtol=1e-5)


# ---------------------------------------------------------------------------
# losses (test_losses_op.py, test_more_losses_op.py)
# ---------------------------------------------------------------------------


def _losses():
    rng = np.random.RandomState(4)
    lr_lab = (rng.rand(5, 1) > 0.5).astype("float32")
    pm_lab = np.where(rng.rand(5, 1) > 0.5, 1.0, -1.0).astype("float32")
    sx = (np.random.RandomState(2).randn(5, 4) * 3).astype("float32")
    sl = np.random.RandomState(2).uniform(0, 1, (5, 4)).astype("float32")
    return {
        "smooth_l1_loss": ("smooth_l1_loss", {"x": _randn(1, (4, 6), 2),
                                              "y": _randn(2, (4, 6), 2)},
                           {"X": ["x"], "Y": ["y"]}, {"Out": 1, "Diff": 1},
                           {"sigma": 1.0}, ["x", "y"]),
        "smooth_l1_loss weights sigma": (
            "smooth_l1_loss", {"x": _randn(8, (4, 3)), "y": _randn(9, (4, 3)),
                               "iw": _rand(10, (4, 3), 0.5, 1.5),
                               "ow": _rand(11, (4, 3), 0.5, 1.5)},
            {"X": ["x"], "Y": ["y"], "InsideWeight": ["iw"],
             "OutsideWeight": ["ow"]}, {"Out": 1, "Diff": 1}, {"sigma": 2.0},
            ["x", "y"]),
        "dice_loss": ("dice_loss", {"x": _rand(2, (4, 5), 0.0, 1.0),
                                    "label": (_rand(3, (4, 5), 0.0, 1.0) > 0.5)
                                    .astype("float32")},
                      {"X": ["x"], "Label": ["label"]}, None, {"epsilon": 1e-5},
                      ["x"]),
        "rank_loss": ("rank_loss", {"label": lr_lab, "left": _randn(3, (5, 1)),
                                    "right": _randn(5, (5, 1))},
                      {"Label": ["label"], "Left": ["left"], "Right": ["right"]},
                      None, {}, ["left", "right"]),
        # log1p(exp(100)) overflows float32 to inf in the JAX package;
        # F.softplus would give 100
        "rank_loss overflow": ("rank_loss", {"label": _f32([[1.0], [0.0], [1.0]]),
                                             "left": _f32([[100.0], [1.0], [-3.0]]),
                                             "right": _f32([[0.0], [0.5], [2.0]])},
                               {"Label": ["label"], "Left": ["left"],
                                "Right": ["right"]}, None, {}, []),
        "margin_rank_loss": ("margin_rank_loss", {"label": pm_lab,
                                                  "x1": _randn(6, (5, 1)),
                                                  "x2": _randn(7, (5, 1))},
                             {"Label": ["label"], "X1": ["x1"], "X2": ["x2"]},
                             None, {"margin": 0.3}, ["x1", "x2"]),
        # z = -label * (x1 - x2) + margin lands on 0 in rows 0 and 2
        "margin_rank_loss tie": ("margin_rank_loss",
                                 {"label": _f32([[1.0], [-1.0], [-1.0], [1.0]]),
                                  "x1": _f32([[0.5], [0.0], [0.0], [2.0]]),
                                  "x2": _f32([[0.25], [1.0], [0.25], [0.0]])},
                                 {"Label": ["label"], "X1": ["x1"], "X2": ["x2"]},
                                 None, {"margin": 0.25}, ["x1", "x2"]),
        "huber_loss": ("huber_loss", {"x": _randn(0, (6, 3)),
                                      "y": _randn(0, (6, 3)) + _randn(1, (6, 3), 2)},
                       {"X": ["x"], "Y": ["y"]}, {"Out": 1, "Residual": 1},
                       {"delta": 1.0}, ["x", "y"]),
        # residuals exactly on the delta and at 0
        "huber_loss bounds": ("huber_loss", {"x": _f32([[0.0, 1.0, -2.0, 3.0]]),
                                             "y": _f32([[1.0, 1.0, -2.5, 1.0]])},
                              {"X": ["x"], "Y": ["y"]}, {"Out": 1, "Residual": 1},
                              {"delta": 1.0}, ["x", "y"]),
        "log_loss": ("log_loss", {"p": _rand(1, (8, 1), 0.05, 0.95),
                                  "label": np.random.RandomState(1).randint(
                                      0, 2, (8, 1)).astype("float32")},
                     {"Predicted": ["p"], "Labels": ["label"]}, {"Loss": 1},
                     {"epsilon": 1e-4}, ["p"]),
        "sigmoid_cross_entropy_with_logits": (
            "sigmoid_cross_entropy_with_logits", {"x": sx, "label": sl},
            {"X": ["x"], "Label": ["label"]}, None, {"ignore_index": -100},
            ["x", "label"]),
        "sigmoid_cross_entropy_with_logits ignore": (
            "sigmoid_cross_entropy_with_logits",
            {"x": _f32([[1.0, -2.0, 3.0]]), "label": _f32([[1.0, -100.0, 0.0]])},
            {"X": ["x"], "Label": ["label"]}, None, {"ignore_index": -100},
            ["x"]),
        # a zero logit with label 0: gradient 0 in the JAX package (0.5 in
        # the literal torch expression and in F.binary_cross_entropy_...)
        "sigmoid_cross_entropy_with_logits zero logit": (
            "sigmoid_cross_entropy_with_logits",
            {"x": _f32([[0.0, 0.0, -0.0, 2.0]]), "label": _f32([[0.0, 1.0, 0.0, 0.5]])},
            {"X": ["x"], "Label": ["label"]}, None, {"ignore_index": -100},
            ["x"]),
    }


LOSSES = _losses()


@pytest.mark.parametrize("case", list(LOSSES))
def test_loss_matches_jax(case):
    op, feeds, inputs, outputs, attrs, wrt = LOSSES[case]
    got, _ = _case(feeds, op, inputs, outputs, attrs, wrt=wrt)
    n_out = len(outputs or {"Out": 1})
    if case == "rank_loss overflow":
        assert np.isposinf(got[0][0, 0])
    if case == "margin_rank_loss tie":
        # d out / d x1 = -label / 4 times the half share, on the two ties
        gx1 = got[n_out]
        assert gx1[0, 0] == np.float32(-0.5 / 4) and gx1[2, 0] == np.float32(0.5 / 4)
    if case == "sigmoid_cross_entropy_with_logits zero logit":
        gx = got[n_out]
        # label 1: the half share, -label and -1/2, over the mean's 4
        assert gx[0, 0] == 0.0 and gx[0, 2] == 0.0
        assert gx[0, 1] == np.float32(-1.0 / 4)
    if case == "sigmoid_cross_entropy_with_logits ignore":
        assert got[0][0, 1] == 0.0 and got[1][0, 1] == 0.0


# ---------------------------------------------------------------------------
# metrics (test_metric_ops_op.py)
# ---------------------------------------------------------------------------

AUC_OUT = {"AUC": 1, "StatPosOut": 1, "StatNegOut": 1}
AUC_TYPES = {s: "float32" for s in AUC_OUT}


def _auc_feeds(seed, rows, cols, thresholds, scores=None):
    rng = np.random.RandomState(seed)
    stat = rng.randint(0, 3, (2, thresholds + 1)).astype("float32")
    return {"p": rng.rand(rows, cols).astype("float32") if scores is None
            else scores,
            "label": rng.randint(0, 2, (rows, 1)).astype("int64"),
            "sp": stat[0], "sn": stat[1]}


AUCS = {
    "rank formula": (_auc_feeds(1, 64, 2, 4095), 4095),
    "few thresholds": (_auc_feeds(2, 40, 2, 7), 7),
    # DeepFM's sigmoid output: the JAX package's prob[:, 1] clamps to
    # column 0
    "one column": (_auc_feeds(3, 32, 1, 63), 63),
    # scores on bin edges, past 1 and below 0, and NaN: bins 0 and the
    # last take them, NaN to bin 0
    "edges": (_auc_feeds(4, 6, 2, 3, _f32([[0, 0.25], [0, 0.5], [0, 1.0],
                                            [0, 1.5], [0, -0.2], [0, np.nan]])), 3),
}


@pytest.mark.parametrize("case", list(AUCS))
def test_auc_matches_jax(case):
    feeds, thresholds = AUCS[case]
    got, _ = _case(feeds, "auc", {"Predict": ["p"], "Label": ["label"],
                                  "StatPos": ["sp"], "StatNeg": ["sn"]},
                   AUC_OUT, {"num_thresholds": thresholds}, dtypes=AUC_TYPES,
                   grad=False)
    score = feeds["p"][:, min(1, feeds["p"].shape[1] - 1)]
    bins = np.clip(np.nan_to_num(score * (thresholds + 1)), 0,
                   thresholds).astype(int)
    pos = np.bincount(bins, feeds["label"][:, 0] > 0, thresholds + 1)
    np.testing.assert_array_equal(got[1], feeds["sp"] + pos)
    np.testing.assert_array_equal(got[2] + got[1], feeds["sp"] + feeds["sn"]
                                  + np.bincount(bins, None, thresholds + 1))


def test_auc_without_stats_matches_jax():
    feeds = _auc_feeds(5, 16, 2, 15)
    del feeds["sp"], feeds["sn"]
    _case(feeds, "auc", {"Predict": ["p"], "Label": ["label"]}, {"AUC": 1},
          {"num_thresholds": 15}, dtypes={"AUC": "float32"}, grad=False)


MIOU_OUT = {"OutMeanIou": 1, "OutWrong": 1, "OutCorrect": 1}
MIOU_TYPES = {"OutMeanIou": "float32", "OutWrong": "int32", "OutCorrect": "int32"}
MIOUS = {
    "reference": (np.array([[0, 1, 2, 1], [2, 2, 0, 1]], "int64"),
                  np.array([[0, 1, 1, 1], [2, 0, 0, 2]], "int64"), 3),
    "random": (np.random.RandomState(6).randint(0, 5, (4, 9)).astype("int64"),
               np.random.RandomState(7).randint(0, 5, (4, 9)).astype("int64"), 5),
    # label * 2 + prediction: 1, 9 (dropped), -1 (wraps to 3), -9
    # (dropped), 2, 2
    "ids out of range": (np.array([1, 1, 1, 1, 0, 0], "int64"),
                         np.array([0, 4, -1, -5, 1, 1], "int64"), 2),
}


@pytest.mark.parametrize("case", list(MIOUS))
def test_mean_iou_matches_jax(case):
    pred, label, n = MIOUS[case]
    got, _ = _case({"pred": pred, "label": label}, "mean_iou",
                   {"Predictions": ["pred"], "Labels": ["label"]}, MIOU_OUT,
                   {"num_classes": n}, dtypes=MIOU_TYPES, grad=False)
    assert got[1].dtype == got[2].dtype == np.int32
    if case == "ids out of range":
        # counts [0, 1, 2, 1]: correct [0, 1], wrong [1, 2]
        assert got[2].tolist() == [0, 1] and got[1].tolist() == [1, 2]


# ---------------------------------------------------------------------------
# image ops (test_one_hot_im2seq_op.py, test_image_resize_op.py,
# test_misc_math_op.py's nearest_interp, test_roi_pool_op.py)
# ---------------------------------------------------------------------------

#: (input shape, kernels, strides, paddings [top, left, bottom, right])
IM2SEQ = {
    "reference": ((1, 2, 4, 4), [2, 2], [2, 2], [0, 0, 0, 0]),
    "overlapping": ((2, 3, 5, 4), [3, 2], [1, 1], [0, 0, 0, 0]),
    "asymmetric paddings": ((2, 2, 5, 6), [2, 3], [1, 2], [1, 0, 2, 1]),
}


@pytest.mark.parametrize("case", list(IM2SEQ))
def test_im2sequence_matches_jax(case):
    shape, k, st, pad = IM2SEQ[case]
    x = _randn(1, shape)
    got, _ = _case({"x": x}, "im2sequence", {"X": ["x"]}, {"Out": 1},
                   {"kernels": k, "strides": st, "paddings": pad})
    n, c, h, w = shape
    oh = (h + pad[0] + pad[2] - k[0]) // st[0] + 1
    ow = (w + pad[1] + pad[3] - k[1]) // st[1] + 1
    xp = np.pad(x, [(0, 0), (0, 0), (pad[0], pad[2]), (pad[1], pad[3])])
    want = np.stack([xp[:, :, i * st[0]:i * st[0] + k[0],
                        j * st[1]:j * st[1] + k[1]].reshape(n, -1)
                     for i in range(oh) for j in range(ow)], 1)
    np.testing.assert_array_equal(got[0], want)


#: (op, input shape, out_h, out_w)
RESIZES = {
    "bilinear up": ("bilinear_interp", (2, 3, 4, 4), 8, 6),
    "bilinear down 8 to 4": ("bilinear_interp", (2, 3, 8, 8), 4, 4),
    "bilinear down 8 to 5x7": ("bilinear_interp", (2, 3, 8, 8), 5, 7),
    "bilinear up and down": ("bilinear_interp", (1, 2, 6, 9), 10, 4),
    "nearest down": ("nearest_interp", (1, 2, 4, 4), 2, 2),
    "nearest up": ("nearest_interp", (2, 3, 4, 5), 8, 10),
    "nearest 8 to 5x7": ("nearest_interp", (2, 3, 8, 8), 5, 7),
}


@pytest.mark.parametrize("case", list(RESIZES))
def test_resize_matches_jax(case):
    op, shape, oh, ow = RESIZES[case]
    x = _randn(1, shape)
    got, _ = _case({"x": x}, op, {"X": ["x"]}, {"Out": 1},
                   {"out_h": oh, "out_w": ow})
    if op == "nearest_interp":
        # every output pixel is one of the input's
        assert np.isin(got[0], x).all()


def _roi_feeds():
    x = _randn(0, (1, 3, 8, 8))
    rois = _f32([[0, 0, 7, 7], [2, 2, 10, 10], [4, 0, 6, 3]])
    distinct = (np.random.RandomState(1).permutation(3 * 8 * 8)
                .reshape(1, 3, 8, 8) * 0.1).astype("float32")
    # two values only: most cells hold tied maxima
    tied = np.floor(_rand(2, (1, 2, 6, 6), 0.0, 2.0))
    return {
        "reference": ({"x": x, "rois": rois}, 2, 2, 0.5),
        "grad": ({"x": distinct, "rois": rois[:2]}, 2, 2, 0.5),
        # one ROI over the whole 6 x 6 image: 2 x 3 cells of 3 x 2 pixels
        "ties": ({"x": tied, "rois": _f32([[0, 0, 5, 5]])}, 2, 3, 1.0),
        # the second ROI lies past the image: every cell -inf; the third
        # spans 3 rows over 4 cells, so one cell is empty
        "empty cells": ({"x": x, "rois": _f32([[0, 0, 3, 3], [10, 10, 14, 14],
                                                [5, 6, 7, 8]])}, 4, 2, 1.0),
    }


ROIS = _roi_feeds()


@pytest.mark.parametrize("case", list(ROIS))
def test_roi_pool_matches_jax(case):
    feeds, ph, pw, scale = ROIS[case]
    got, _ = _case(feeds, "roi_pool", {"X": ["x"], "ROIs": ["rois"]}, {"Out": 1},
                   {"pooled_height": ph, "pooled_width": pw,
                    "spatial_scale": scale}, wrt=["x"])
    out, gx = got
    if case == "ties":
        # a cell with k tied maxima gives each of them 1/k of its share
        x = feeds["x"][0]
        want = np.zeros_like(x)
        for i in range(2):
            for j in range(3):
                cell = x[:, 3 * i:3 * i + 3, 2 * j:2 * j + 2]
                top = cell == cell.max((1, 2), keepdims=True)
                want[:, 3 * i:3 * i + 3, 2 * j:2 * j + 2] = top / (
                    top.sum((1, 2), keepdims=True) * out.size)
        np.testing.assert_array_equal(gx[0], want)
        assert (want * out.size < 1).any()
    if case == "empty cells":
        assert np.isneginf(out[1]).all() and np.isneginf(out[2]).any()
        assert np.isfinite(out[0]).all() and np.isfinite(gx).all()


def test_roi_pool_on_rois_with_lengths_raises():
    """ROIs over a batch of images carry lengths; the JAX package reads
    them as image indices (ROADMAP R-5), so the port refuses them."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.unique_name.guard(), tfluid.program_guard(main, startup):
        x = tfluid.layers.data(name="x", shape=[2, 4, 4], dtype="float32")
        rois = tfluid.layers.data(name="rois", shape=[4], dtype="float32",
                                  lod_level=1)
        out = tfluid.layers.roi_pool(x, rois, 1, 1)
    feed = {"x": _randn(0, (2, 2, 4, 4)),
            "rois": tfluid.create_lod_tensor(_f32([[0, 0, 1, 1], [1, 1, 3, 3]]),
                                             [[1, 1]], tfluid.CPUPlace())}
    with pytest.raises(ValueError, match="R-5"):
        tfluid.Executor(tfluid.CPUPlace()).run(main, feed=feed, fetch_list=[out],
                                               scope=tfluid.Scope())


def test_every_nn_ops_name_has_a_port_rule():
    import paddle_tpu.ops  # noqa: F401
    import paddle_tpu_torch.ops  # noqa: F401
    from paddle_tpu import registry as jreg
    from paddle_tpu_torch import registry as treg

    names = {n for n, f in jreg.RULES.items()
             if f.__module__ == "paddle_tpu.ops.nn_ops"}
    assert len(names) == 30
    assert not names - set(treg.RULES)
    assert set(treg.RULES) <= set(jreg.RULES)
    assert len(treg.RULES) == 221
