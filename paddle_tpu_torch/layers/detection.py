"""Detection layers (reference: python/paddle/fluid/layers/detection.py).

The port's copy of the JAX package's ``paddle_tpu/layers/detection.py``:
the same layer functions build the same Programs, op for op and attr
for attr.  SSD stack: prior_box, multi_box_head, iou_similarity,
bipartite_match, box_coder, target_assign, ssd_loss, detection_output,
anchor_generator; the RPN and RCNN rules and the EAST transforms.
Ground-truth boxes and labels ride the padded-plus-lengths layout; the
rules are in ``ops/detection_ops.py``.
"""
from __future__ import annotations

import numpy as np

from ..framework import Variable
from ..layer_helper import LayerHelper

__all__ = [
    "prior_box",
    "multi_box_head",
    "bipartite_match",
    "target_assign",
    "detection_output",
    "ssd_loss",
    "detection_map",
    "iou_similarity",
    "box_coder",
    "anchor_generator",
    "rpn_target_assign",
    "generate_proposals",
    "generate_proposal_labels",
    "roi_perspective_transform",
    "polygon_box_transform",
]


def iou_similarity(x, y, name=None):
    """IoU matrix between box sets (reference detection.py:304)."""
    helper = LayerHelper("iou_similarity", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="iou_similarity", inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]})
    return out


def box_coder(prior_box, prior_box_var, target_box, code_type="encode_center_size",
              box_normalized=True, name=None):
    """Encode/decode boxes vs priors (reference detection.py:332)."""
    helper = LayerHelper("box_coder", **locals())
    out = helper.create_variable_for_type_inference(dtype=target_box.dtype)
    inputs = {"PriorBox": [prior_box], "TargetBox": [target_box]}
    if prior_box_var is not None:
        inputs["PriorBoxVar"] = [prior_box_var]
    helper.append_op(
        type="box_coder",
        inputs=inputs,
        outputs={"OutputBox": [out]},
        attrs={"code_type": code_type, "box_normalized": box_normalized},
    )
    return out


def bipartite_match(dist_matrix, match_type=None, dist_threshold=None, name=None):
    """Greedy bipartite (+ optional per-prediction) matching
    (reference detection.py:491)."""
    helper = LayerHelper("bipartite_match", **locals())
    match_indices = helper.create_variable_for_type_inference(dtype="int32", stop_gradient=True)
    match_distance = helper.create_variable_for_type_inference(dtype=dist_matrix.dtype, stop_gradient=True)
    helper.append_op(
        type="bipartite_match",
        inputs={"DistMat": [dist_matrix]},
        outputs={"ColToRowMatchIndices": [match_indices], "ColToRowMatchDist": [match_distance]},
        attrs={"match_type": match_type or "bipartite", "dist_threshold": dist_threshold or 0.5},
    )
    return match_indices, match_distance


def target_assign(input, matched_indices, negative_indices=None, mismatch_value=None, name=None):
    """Gather per-prior targets from matched gt (reference detection.py:576)."""
    helper = LayerHelper("target_assign", **locals())
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    out_weight = helper.create_variable_for_type_inference(dtype="float32")
    helper.append_op(
        type="target_assign",
        inputs={"X": [input], "MatchIndices": [matched_indices]},
        outputs={"Out": [out], "OutWeight": [out_weight]},
        attrs={"mismatch_value": mismatch_value or 0},
    )
    return out, out_weight


def ssd_loss(location, confidence, gt_box, gt_label, prior_box, prior_box_var=None,
             background_label=0, overlap_threshold=0.5, neg_pos_ratio=3.0,
             neg_overlap=0.5, loc_loss_weight=1.0, conf_loss_weight=1.0,
             match_type="per_prediction", mining_type="max_negative",
             normalize=True, sample_size=None):
    """Fused SSD multibox loss (reference detection.py:662): IoU match →
    hard-negative mining → smooth-L1 loc + softmax conf losses.  Returns
    [batch, 1] (already normalized by total positives when ``normalize``)."""
    if mining_type != "max_negative":
        raise NotImplementedError("only max_negative mining is supported")
    helper = LayerHelper("ssd_loss", **locals())
    loss = helper.create_variable_for_type_inference(dtype=location.dtype)
    inputs = {
        "Loc": [location],
        "Conf": [confidence],
        "GTBox": [gt_box],
        "GTLabel": [gt_label],
        "PriorBox": [prior_box],
    }
    if prior_box_var is not None:
        inputs["PriorBoxVar"] = [prior_box_var]
    helper.append_op(
        type="ssd_loss",
        inputs=inputs,
        outputs={"Loss": [loss]},
        attrs={
            "background_label": background_label,
            "overlap_threshold": overlap_threshold,
            "neg_pos_ratio": neg_pos_ratio,
            "neg_overlap": neg_overlap,
            "loc_loss_weight": loc_loss_weight,
            "conf_loss_weight": conf_loss_weight,
            "match_type": match_type,
            "normalize": normalize,
        },
    )
    return loss


def detection_output(loc, scores, prior_box, prior_box_var, background_label=0,
                     nms_threshold=0.3, nms_top_k=400, keep_top_k=200,
                     score_threshold=0.01, nms_eta=1.0):
    """Decode + multiclass NMS (reference detection.py:190).  Returns a
    padded ``[batch, keep_top_k, 6]`` tensor (label, score, x0, y0, x1, y1;
    rows past each image's detection count are -1) with a lengths companion —
    the dense analog of the reference's LoD output."""
    helper = LayerHelper("detection_output", **locals())
    decoded = box_coder(
        prior_box=prior_box,
        prior_box_var=prior_box_var,
        target_box=loc,
        code_type="decode_center_size",
    )
    from .nn import softmax, transpose

    scores = softmax(input=scores)
    scores = transpose(scores, perm=[0, 2, 1])  # [B, C, M]
    out = helper.create_variable_for_type_inference(dtype=loc.dtype, lod_level=1, stop_gradient=True)
    helper.append_op(
        type="multiclass_nms",
        inputs={"BBoxes": [decoded], "Scores": [scores]},
        outputs={"Out": [out]},
        attrs={
            "background_label": background_label,
            "nms_threshold": nms_threshold,
            "nms_top_k": nms_top_k,
            "keep_top_k": keep_top_k,
            "score_threshold": score_threshold,
            "nms_eta": nms_eta,
        },
    )
    return out


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=[1.0],
              variance=[0.1, 0.1, 0.2, 0.2], flip=False, clip=False,
              steps=[0.0, 0.0], offset=0.5, name=None,
              min_max_aspect_ratios_order=False):
    """SSD prior boxes for one feature map (reference detection.py:895).
    Output layout [H, W, num_priors, 4] (+ same-shaped variances)."""
    helper = LayerHelper("prior_box", **locals())

    def _list(v):
        return [float(x) for x in (v if isinstance(v, (list, tuple)) else [v])]

    min_sizes = _list(min_sizes)
    max_sizes = _list(max_sizes) if max_sizes else []
    aspect_ratios = _list(aspect_ratios)

    # static output shape: priors per cell
    ars = [1.0]
    for ar in aspect_ratios:
        if all(abs(ar - o) > 1e-6 for o in ars):
            ars.append(ar)
            if flip:
                ars.append(1.0 / ar)
    num_priors = len(ars) * len(min_sizes) + len(max_sizes)
    shp = None
    if input.shape is not None and len(input.shape) == 4:
        shp = [input.shape[2], input.shape[3], num_priors, 4]

    box = helper.create_variable_for_type_inference(dtype=input.dtype, shape=shp, stop_gradient=True)
    var = helper.create_variable_for_type_inference(dtype=input.dtype, shape=shp, stop_gradient=True)
    helper.append_op(
        type="prior_box",
        inputs={"Input": [input], "Image": [image]},
        outputs={"Boxes": [box], "Variances": [var]},
        attrs={
            "min_sizes": min_sizes,
            "max_sizes": max_sizes,
            "aspect_ratios": aspect_ratios,
            "variances": list(variance),
            "flip": flip,
            "clip": clip,
            "steps": list(steps),
            "offset": offset,
            "min_max_aspect_ratios_order": min_max_aspect_ratios_order,
        },
    )
    return box, var


def anchor_generator(input, anchor_sizes=None, aspect_ratios=None,
                     variance=[0.1, 0.1, 0.2, 0.2], stride=None, offset=0.5, name=None):
    """RPN anchors for one feature map (reference detection.py:1261)."""
    helper = LayerHelper("anchor_generator", **locals())
    num = len(anchor_sizes) * len(aspect_ratios)
    shp = None
    if input.shape is not None and len(input.shape) == 4:
        shp = [input.shape[2], input.shape[3], num, 4]
    anchor = helper.create_variable_for_type_inference(dtype=input.dtype, shape=shp, stop_gradient=True)
    var = helper.create_variable_for_type_inference(dtype=input.dtype, shape=shp, stop_gradient=True)
    helper.append_op(
        type="anchor_generator",
        inputs={"Input": [input]},
        outputs={"Anchors": [anchor], "Variances": [var]},
        attrs={
            "anchor_sizes": [float(a) for a in anchor_sizes],
            "aspect_ratios": [float(a) for a in aspect_ratios],
            "variances": list(variance),
            "stride": [float(s) for s in stride],
            "offset": offset,
        },
    )
    return anchor, var


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None, max_sizes=None,
                   steps=None, step_w=None, step_h=None, offset=0.5, variance=[0.1, 0.1, 0.2, 0.2],
                   flip=True, clip=False, kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """SSD detection head over multiple feature maps (reference
    detection.py:1015): per-map loc/conf convs + concatenated priors.
    Returns (mbox_locs [B, M, 4], mbox_confs [B, M, C], boxes [M, 4],
    variances [M, 4])."""
    from . import nn, tensor

    n_layer = len(inputs)
    if min_sizes is None:
        # reference: evenly spaced ratios between min_ratio% and max_ratio%
        min_sizes, max_sizes = [], []
        step = int(np.floor((max_ratio - min_ratio) / (n_layer - 2)))
        for ratio in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
        min_sizes = [base_size * 0.1] + min_sizes
        max_sizes = [base_size * 0.2] + max_sizes

    locs, confs, boxes_list, vars_list = [], [], [], []
    for i, x in enumerate(inputs):
        mins = min_sizes[i]
        maxs = max_sizes[i] if max_sizes else None
        ar = aspect_ratios[i] if isinstance(aspect_ratios[i], (list, tuple)) else [aspect_ratios[i]]
        st = steps[i] if steps else [step_w[i] if step_w else 0.0, step_h[i] if step_h else 0.0]
        box, var = prior_box(
            x, image, mins, maxs, ar, variance, flip, clip, st, offset,
            min_max_aspect_ratios_order=min_max_aspect_ratios_order,
        )
        npri = int(box.shape[2])

        mbox_loc = nn.conv2d(input=x, num_filters=npri * 4, filter_size=kernel_size,
                             padding=pad, stride=stride)
        # NCHW -> [B, H*W*num_priors, 4]
        loc = nn.transpose(mbox_loc, perm=[0, 2, 3, 1])
        loc = nn.reshape(loc, shape=[0, -1, 4])
        locs.append(loc)

        mbox_conf = nn.conv2d(input=x, num_filters=npri * num_classes, filter_size=kernel_size,
                              padding=pad, stride=stride)
        conf = nn.transpose(mbox_conf, perm=[0, 2, 3, 1])
        conf = nn.reshape(conf, shape=[0, -1, num_classes])
        confs.append(conf)

        boxes_list.append(nn.reshape(box, shape=[-1, 4]))
        vars_list.append(nn.reshape(var, shape=[-1, 4]))

    mbox_locs = tensor.concat(locs, axis=1)
    mbox_confs = tensor.concat(confs, axis=1)
    boxes = tensor.concat(boxes_list, axis=0)
    variances = tensor.concat(vars_list, axis=0)
    boxes.stop_gradient = True
    variances.stop_gradient = True
    return mbox_locs, mbox_confs, boxes, variances


def polygon_box_transform(input, name=None):
    """Per-pixel quad offsets -> absolute coordinates (reference
    detection.py:373; kernel detection/polygon_box_transform_op.cc)."""
    helper = LayerHelper("polygon_box_transform", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype, shape=input.shape)
    helper.append_op(
        type="polygon_box_transform", inputs={"Input": [input]},
        outputs={"Output": [out]},
    )
    return out


def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000, nms_thresh=0.5,
                       min_size=0.1, eta=1.0, name=None):
    """RPN proposals from anchor deltas (reference detection.py:1463).
    Static-shape: outputs are [batch, post_nms_top_n, ...] padded, the valid
    count rides the lengths metadata instead of LoD."""
    helper = LayerHelper("generate_proposals", name=name)
    rois = helper.create_variable_for_type_inference(dtype=bbox_deltas.dtype)
    probs = helper.create_variable_for_type_inference(dtype=scores.dtype)
    helper.append_op(
        type="generate_proposals",
        inputs={"Scores": [scores], "BboxDeltas": [bbox_deltas],
                "ImInfo": [im_info], "Anchors": [anchors], "Variances": [variances]},
        outputs={"RpnRois": [rois], "RpnRoiProbs": [probs]},
        attrs={"pre_nms_topN": pre_nms_top_n, "post_nms_topN": post_nms_top_n,
               "nms_thresh": nms_thresh, "min_size": min_size, "eta": eta},
    )
    rois.stop_gradient = True
    probs.stop_gradient = True
    return rois, probs


def rpn_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var, gt_boxes,
                      rpn_batch_size_per_im=256, fg_fraction=0.5,
                      rpn_positive_overlap=0.7, rpn_negative_overlap=0.3,
                      use_random=True, name=None):
    """Sample fg/bg anchors for RPN training (reference detection.py:51).
    Deterministic top-IoU sampling (use_random accepted for API parity);
    returns (pred_loc, pred_scores, target_label, target_bbox), each
    [batch, rpn_batch_size_per_im, ...]."""
    helper = LayerHelper("rpn_target_assign", name=name)
    dtype = bbox_pred.dtype
    loc = helper.create_variable_for_type_inference(dtype=dtype)
    score = helper.create_variable_for_type_inference(dtype=dtype)
    label = helper.create_variable_for_type_inference(dtype="int32")
    tgt = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(
        type="rpn_target_assign",
        inputs={"BboxPred": [bbox_pred], "ClsLogits": [cls_logits],
                "AnchorBox": [anchor_box], "AnchorVar": [anchor_var],
                "GtBoxes": [gt_boxes]},
        outputs={"PredictedLocation": [loc], "PredictedScores": [score],
                 "TargetLabel": [label], "TargetBBox": [tgt]},
        attrs={"rpn_batch_size_per_im": rpn_batch_size_per_im,
               "rpn_fg_fraction": fg_fraction,
               "rpn_positive_overlap": rpn_positive_overlap,
               "rpn_negative_overlap": rpn_negative_overlap,
               "use_random": use_random},
    )
    label.stop_gradient = True
    tgt.stop_gradient = True
    return loc, score, label, tgt


def generate_proposal_labels(rpn_rois, gt_classes, gt_boxes, im_info=None,
                             batch_size_per_im=512, fg_fraction=0.25,
                             fg_thresh=0.5, bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                             class_nums=81, use_random=True, name=None):
    """Sample RoIs + targets for the RCNN head (reference detection.py:1401).
    Returns (rois, labels_int32, bbox_targets, bbox_inside_weights,
    bbox_outside_weights), each [batch, batch_size_per_im, ...]."""
    helper = LayerHelper("generate_proposal_labels", name=name)
    dtype = rpn_rois.dtype
    rois = helper.create_variable_for_type_inference(dtype=dtype)
    labels = helper.create_variable_for_type_inference(dtype="int32")
    tgt = helper.create_variable_for_type_inference(dtype=dtype)
    inw = helper.create_variable_for_type_inference(dtype=dtype)
    outw = helper.create_variable_for_type_inference(dtype=dtype)
    inputs = {"RpnRois": [rpn_rois], "GtClasses": [gt_classes], "GtBoxes": [gt_boxes]}
    if im_info is not None:
        inputs["ImInfo"] = [im_info]
    helper.append_op(
        type="generate_proposal_labels",
        inputs=inputs,
        outputs={"Rois": [rois], "LabelsInt32": [labels], "BboxTargets": [tgt],
                 "BboxInsideWeights": [inw], "BboxOutsideWeights": [outw]},
        attrs={"batch_size_per_im": batch_size_per_im, "fg_fraction": fg_fraction,
               "fg_thresh": fg_thresh, "bg_thresh_hi": bg_thresh_hi,
               "bg_thresh_lo": bg_thresh_lo,
               "bbox_reg_weights": list(bbox_reg_weights),
               "class_nums": class_nums, "use_random": use_random},
    )
    for v in (labels, tgt, inw, outw):
        v.stop_gradient = True
    return rois, labels, tgt, inw, outw


def roi_perspective_transform(input, rois, transformed_height, transformed_width,
                              spatial_scale=1.0, name=None):
    """Perspective-warp quadrilateral RoIs ([R, 8] quads) to a fixed
    rectangle (reference detection.py:1353)."""
    helper = LayerHelper("roi_perspective_transform", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="roi_perspective_transform",
        inputs={"X": [input], "ROIs": [rois]},
        outputs={"Out": [out]},
        attrs={"transformed_height": transformed_height,
               "transformed_width": transformed_width,
               "spatial_scale": spatial_scale},
    )
    return out


def detection_map(detect_res, label_boxes, label_classes, class_num,
                  background_label=0, overlap_threshold=0.3,
                  input_states=None, ap_version="integral",
                  state_capacity=512, gt_difficult=None,
                  evaluate_difficult=True, name=None):
    """Accumulative in-graph mAP (reference detection.py:399).  The padded
    analog of the reference LoD contract: ``detect_res`` [batch, K, 6]
    (label, score, x0, y0, x1, y1; invalid rows -1), ground truth as
    separate boxes [batch, G, 4] + classes [batch, G].

    With ``evaluate_difficult=False`` and a ``gt_difficult`` [batch, G]
    mask, difficult ground truth follows the reference rule: excluded
    from the positive count, and detections matched to one are NEUTRAL
    (neither TP nor FP).

    Returns (map_out, accum_pos_count, accum_true_pos, accum_false_pos);
    feed the three accum states back through ``input_states`` to pool the
    metric across batches in-graph.
    """
    helper = LayerHelper("detection_map", name=name)
    map_out = helper.create_variable_for_type_inference(dtype="float32")
    pc = helper.create_variable_for_type_inference(dtype="int32")
    tp = helper.create_variable_for_type_inference(dtype="float32")
    fp = helper.create_variable_for_type_inference(dtype="float32")
    inputs = {"DetectRes": [detect_res], "GtBoxes": [label_boxes],
              "GtLabels": [label_classes]}
    if gt_difficult is not None:
        inputs["GtDifficult"] = [gt_difficult]
    if input_states is not None:
        inputs["PosCount"] = [input_states[0]]
        inputs["TruePos"] = [input_states[1]]
        inputs["FalsePos"] = [input_states[2]]
    helper.append_op(
        type="detection_map",
        inputs=inputs,
        outputs={"MAP": [map_out], "AccumPosCount": [pc],
                 "AccumTruePos": [tp], "AccumFalsePos": [fp]},
        attrs={"class_num": class_num, "background_label": background_label,
               "overlap_threshold": overlap_threshold, "ap_type": ap_version,
               "state_capacity": state_capacity,
               "evaluate_difficult": bool(evaluate_difficult)},
    )
    for v in (map_out, pc, tp, fp):
        v.stop_gradient = True
    return map_out, pc, tp, fp
