"""Detection op rules: prior boxes and anchors, IoU, bipartite matching,
box en/decoding, target assignment, the fused SSD loss, multiclass NMS,
the RPN and RCNN sampling rules, the EAST transforms and the in-graph
mAP.

Translated from the JAX package's ``paddle_tpu/ops/detection_ops.py``,
every rule of it, over the padded-plus-lengths layout: ground truth is
``[B, G, 4]`` with a lengths companion (a missing one means full rows)
and every rule is a masked computation with static shapes.  The loops
the JAX package runs as a ``lax.fori_loop`` (the bipartite match's G
steps of a global argmax, NMS's K steps of suppression, the mAP's K
steps of greedy matching) are a Python loop over the steps here, each
step a few torch ops batched over the images and the classes, as the
JAX package's ``vmap`` batches them.  No Pallas kernel ever computed
these ops, so no hand-written kernel stands behind them.

Ties follow the JAX package: ``lax.top_k`` puts the lower index first
and ``jnp.argsort`` is stable, so every ranking here is a stable
descending ``torch.sort`` sliced (``torch.topk``'s tie order is
unspecified); ``torch.argmax`` takes the first maximum, as
``jnp.argmax`` does.  ``jnp.maximum`` and ``jnp.minimum`` split a tied
gradient, and so do ``torch.maximum`` and ``torch.minimum``, which the
rules use wherever a tie can meet a gradient.

No rule reads a value back to the host or copies host data to the card:
the prior and anchor tables are computed on the device (in float64 from
``arange``, in the JAX package's numpy order, then cast), and constants
are device fills, so a dense-fed Program holding these ops binds into
one CUDA graph.
"""
from __future__ import annotations

import math

import torch

from ..registry import register
from .common import at_least_f32, device_values
from .sequence_ops import _mask


def _gt_lengths(ctx, op, slot, x):
    """The lengths of ``op``'s ``slot`` input (``x``) as int32; a tensor
    without them is a batch of full rows."""
    lens = ctx.get_lengths(op.inputs[slot][0])
    if lens is None:
        return torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                          device=x.device)
    return lens.to(torch.int32)


def _max0(x):
    """``jnp.maximum(x, 0.0)``, its gradient split at a tie."""
    return torch.maximum(x, x.new_zeros(()))


def _desc(x, k=None):
    """The stable descending sort of ``x``'s last axis, its first ``k``
    entries: ``lax.top_k``'s values and indices, ties lower index first."""
    val, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    if k is not None:
        val, idx = val[..., :k], idx[..., :k]
    return val, idx


def _take_rows(x, idx):
    """``x[b, idx[b, ...]]`` over the batch: x ``[B, N, ...]``, idx
    ``[B, ...]`` -> ``[B, ..., *x.shape[2:]]``."""
    B = x.shape[0]
    flat = idx.reshape(B, -1).long()
    tail = x.shape[2:]
    out = torch.gather(x, 1, flat.reshape(flat.shape + (1,) * len(tail))
                       .expand(flat.shape + tail))
    return out.reshape(tuple(idx.shape) + tuple(tail))


# ---------------------------------------------------------------------------
# priors / anchors
# ---------------------------------------------------------------------------


def _expand_aspect_ratios(aspect_ratios, flip):
    out = [1.0]
    for ar in aspect_ratios:
        if all(abs(ar - o) > 1e-6 for o in out):
            out.append(float(ar))
            if flip:
                out.append(1.0 / float(ar))
    return out


def prior_sizes(min_sizes, max_sizes, aspect_ratios, flip,
                min_max_order=False):
    """The (width, height) of each prior of a cell, in the reference's
    order (prior_box_op.h): per min size, the aspect ratios then the
    max size's square, or (``min_max_order``) the min square, the max
    square, then the other ratios."""
    ars = _expand_aspect_ratios(aspect_ratios, flip)
    out = []
    for i, ms in enumerate(min_sizes):
        sq = ([(math.sqrt(ms * max_sizes[i]),) * 2] if max_sizes else [])
        ratios = [(ms * math.sqrt(ar), ms / math.sqrt(ar)) for ar in ars]
        if not min_max_order:
            out += ratios + sq
        else:
            out += [(ms, ms)] + sq + ratios[1:]
    return out


def _cell_table(H, W, cx_of, cy_of, half, scale, device):
    """``[H, W, P, 4]`` float32 corner boxes ``(cx -+ hw, cy -+ hh)`` of
    each cell's P priors, divided by ``scale`` (the image's width and
    height, or None), in float64 and then rounded once to float32: the
    numpy table's bits, each operation a correctly rounded float64 one
    in the same order.  ``cx_of``/``cy_of`` map a float64 ``arange`` to
    the cell centers."""
    f64 = torch.float64
    cx = cx_of(torch.arange(W, dtype=f64, device=device))[None, :, None]
    cy = cy_of(torch.arange(H, dtype=f64, device=device))[:, None, None]
    hw = device_values([h for h, _ in half], f64, device)
    hh = device_values([h for _, h in half], f64, device)
    corners = [cx - hw, cy - hh, cx + hw, cy + hh]
    if scale is not None:
        # by a device tensor, not a Python number: CUDA divides by a
        # host scalar as a product with its reciprocal, one more rounding
        sw, sh = (torch.full((), size, dtype=f64, device=device)
                  for size in scale)
        corners = [c / d for c, d in zip(corners, (sw, sh, sw, sh))]
    P = len(half)
    return torch.stack([c.expand(H, W, P) for c in corners],
                       -1).to(torch.float32)


def _variances(variance, shape, device):
    v = device_values([float(x) for x in variance], torch.float32, device)
    return v.expand(shape).contiguous()


@register("prior_box")
def _prior_box(ctx, op):
    """SSD prior boxes of one NCHW feature map (reference
    prior_box_op.h; the JAX package's ``prior_box_np``): Boxes and
    Variances ``[H, W, P, 4]`` float32, normalized by the image size,
    clipped to [0, 1] under ``clip``."""
    x = ctx.get_input(op, "Input")
    img = ctx.get_input(op, "Image")
    a = op.attrs
    H, W = x.shape[2], x.shape[3]
    img_h, img_w = img.shape[2], img.shape[3]
    steps = list(a.get("steps", [0.0, 0.0]))
    offset = float(a.get("offset", 0.5))
    step_w = steps[0] or float(img_w) / W
    step_h = steps[1] or float(img_h) / H
    sizes = prior_sizes(
        list(a["min_sizes"]), list(a.get("max_sizes") or []),
        list(a.get("aspect_ratios", [1.0])), bool(a.get("flip", False)),
        bool(a.get("min_max_aspect_ratios_order", False)))
    b = _cell_table(H, W, lambda w: (w + offset) * step_w,
                    lambda h: (h + offset) * step_h,
                    [(bw / 2.0, bh / 2.0) for bw, bh in sizes],
                    (img_w, img_h), x.device)
    if a.get("clip", False):
        b = torch.clamp(b, 0.0, 1.0)
    ctx.set_output(op, "Boxes", b)
    ctx.set_output(op, "Variances", _variances(
        a.get("variances", [0.1, 0.1, 0.2, 0.2]), b.shape, x.device))


@register("anchor_generator")
def _anchor_generator(ctx, op):
    """Faster-RCNN anchors of one feature map (reference
    anchor_generator_op.h): ``[H, W, A, 4]`` in pixels, per ratio then
    per size."""
    x = ctx.get_input(op, "Input")
    a = op.attrs
    stride = [float(s) for s in a["stride"]]
    offset = float(a.get("offset", 0.5))
    half = []
    for r in a["aspect_ratios"]:
        for s in a["anchor_sizes"]:
            half.append((s * math.sqrt(r) / 2, s / math.sqrt(r) / 2))
    arr = _cell_table(x.shape[2], x.shape[3],
                      lambda w: (w + offset) * stride[0],
                      lambda h: (h + offset) * stride[1], half, None,
                      x.device)
    ctx.set_output(op, "Anchors", arr)
    ctx.set_output(op, "Variances", _variances(
        a.get("variances", [0.1, 0.1, 0.2, 0.2]), arr.shape, x.device))


# ---------------------------------------------------------------------------
# IoU / matching / coding
# ---------------------------------------------------------------------------


def _iou(a, b):
    """a: [..., N, 4], b: [..., M, 4] -> [..., N, M] (xmin, ymin, xmax,
    ymax); 0 where the union is empty."""
    ax0, ay0, ax1, ay1 = (a[..., :, None, i] for i in range(4))
    bx0, by0, bx1, by1 = (b[..., None, :, i] for i in range(4))
    ix = _max0(torch.minimum(ax1, bx1) - torch.maximum(ax0, bx0))
    iy = _max0(torch.minimum(ay1, by1) - torch.maximum(ay0, by0))
    inter = ix * iy
    area_a = _max0(ax1 - ax0) * _max0(ay1 - ay0)
    area_b = _max0(bx1 - bx0) * _max0(by1 - by0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / torch.clamp(union, min=1e-10), 0.0)


@register("iou_similarity")
def _iou_similarity(ctx, op):
    """IoU of X's boxes (``[G, 4]`` or ``[B, G, 4]``, its lengths kept)
    against Y's ``[M, 4]``."""
    x = ctx.get_input(op, "X")
    y = ctx.get_input(op, "Y")
    if x.dim() == 2:
        out = _iou(x, y)
    else:
        out = _iou(x, y.expand((x.shape[0],) + tuple(y.shape)))
    ctx.set_output(op, "Out", out)
    if x.dim() == 3:
        ctx.copy_lengths(op.inputs["X"][0], op.outputs["Out"][0])


def _bipartite_match(dist, gt_mask):
    """Greedy global bipartite matching (reference bipartite_match_op.cc)
    over a batch: dist ``[B, G, M]`` similarities, gt_mask ``[B, G]`` the
    valid rows.  G steps, each the batch's global argmax (the first
    maximum, g-major), taken where positive, its row and column then
    cleared to -1.  Returns (match index ``[B, M]`` int32, -1 unmatched;
    match distance ``[B, M]``)."""
    B, G, M = dist.shape
    d = torch.where(gt_mask[:, :, None], dist, -1.0)
    midx = torch.full((B, M), -1, dtype=torch.int32, device=dist.device)
    mdist = dist.new_zeros((B, M))
    g_ids = torch.arange(G, device=dist.device)
    m_ids = torch.arange(M, device=dist.device)
    for _ in range(G):
        flat = d.reshape(B, -1).argmax(1)
        val = torch.gather(d.reshape(B, -1), 1, flat[:, None])[:, 0]
        g, m = flat // M, flat % M
        take = val > 0
        col = (m_ids[None, :] == m[:, None]) & take[:, None]
        row = (g_ids[None, :] == g[:, None]) & take[:, None]
        midx = torch.where(col, g[:, None].to(torch.int32), midx)
        mdist = torch.where(col, val[:, None], mdist)
        d = torch.where(row[:, :, None] | col[:, None, :], -1.0, d)
    return midx, mdist


def _match(dist, gt_mask, match_type, overlap_threshold):
    midx, mdist = _bipartite_match(dist, gt_mask)
    if match_type == "per_prediction":
        d = torch.where(gt_mask[:, :, None], dist, -1.0)
        best_v, _ = d.max(1)
        best_g = d.argmax(1).to(torch.int32)
        extra = (midx < 0) & (best_v > overlap_threshold)
        midx = torch.where(extra, best_g, midx)
        mdist = torch.where(extra, best_v, mdist)
    return midx, mdist


@register("bipartite_match")
def _bipartite_match_op(ctx, op):
    """Bipartite (then, under ``per_prediction``, column-wise argmax
    above ``dist_threshold``) matching of DistMat ``[B, G, M]`` (or
    ``[G, M]``) over its lengths' valid rows."""
    dist = ctx.get_input(op, "DistMat")
    match_type = op.attrs.get("match_type", "bipartite")
    thr = float(op.attrs.get("dist_threshold", 0.5))
    squeeze = dist.dim() == 2
    if squeeze:
        dist = dist[None]
    lens = _gt_lengths(ctx, op, "DistMat", dist)
    G = dist.shape[1]
    gt_mask = _mask(lens, G, torch.bool)
    with torch.no_grad():
        midx, mdist = _match(dist, gt_mask, match_type, thr)
    if squeeze:
        midx, mdist = midx[0], mdist[0]
    ctx.set_output(op, "ColToRowMatchIndices", midx)
    ctx.set_output(op, "ColToRowMatchDist", mdist)


def _encode_box(prior, prior_var, gt):
    """center-size encoding (reference box_coder_op.h
    encode_center_size)."""
    pw = prior[..., 2] - prior[..., 0]
    ph = prior[..., 3] - prior[..., 1]
    pcx = (prior[..., 0] + prior[..., 2]) / 2
    pcy = (prior[..., 1] + prior[..., 3]) / 2
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    gcx = (gt[..., 0] + gt[..., 2]) / 2
    gcy = (gt[..., 1] + gt[..., 3]) / 2
    eps = 1e-10
    pw_, ph_ = torch.clamp(pw, min=eps), torch.clamp(ph, min=eps)
    t = torch.stack([(gcx - pcx) / pw_, (gcy - pcy) / ph_,
                     torch.log(torch.clamp(gw / pw_, min=eps)),
                     torch.log(torch.clamp(gh / ph_, min=eps))], -1)
    return t / prior_var if prior_var is not None else t


def _decode_box(prior, prior_var, code):
    pw = prior[..., 2] - prior[..., 0]
    ph = prior[..., 3] - prior[..., 1]
    pcx = (prior[..., 0] + prior[..., 2]) / 2
    pcy = (prior[..., 1] + prior[..., 3]) / 2
    if prior_var is not None:
        code = code * prior_var
    cx = code[..., 0] * pw + pcx
    cy = code[..., 1] * ph + pcy
    w = torch.exp(code[..., 2]) * pw
    h = torch.exp(code[..., 3]) * ph
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


@register("box_coder")
def _box_coder(ctx, op):
    """Encode TargetBox against PriorBox ``[M, 4]`` (out ``[.., N, M,
    4]``, gt by prior) or decode codes ``[.., M, 4]``; with
    ``box_normalized=False`` the prior's max corner moves by one pixel."""
    prior = ctx.get_input(op, "PriorBox")
    pvar = ctx.get_input(op, "PriorBoxVar", None)
    target = ctx.get_input(op, "TargetBox")
    code_type = op.attrs.get("code_type", "encode_center_size")
    if not bool(op.attrs.get("box_normalized", True)):
        prior = prior + device_values([0.0, 0.0, 1.0, 1.0], prior.dtype,
                                prior.device)
    if "encode" in code_type:
        out = _encode_box(prior[None], None if pvar is None else pvar[None],
                          target[..., None, :])
    else:
        out = _decode_box(prior, pvar, target)
    ctx.set_output(op, "OutputBox", out)


@register("target_assign")
def _target_assign(ctx, op):
    """Gather per-prior targets from matched rows (reference
    target_assign_op.h): X ``[B, G, K]``, MatchIndices ``[B, M]``; Out
    ``[B, M, K]`` (``mismatch_value`` where unmatched), OutWeight
    ``[B, M, 1]`` float32."""
    x = ctx.get_input(op, "X")
    midx = ctx.get_input(op, "MatchIndices")
    mismatch_value = op.attrs.get("mismatch_value", 0)
    safe = torch.clamp(midx.long(), 0, x.shape[1] - 1)
    out = _take_rows(x, safe)
    matched = (midx >= 0)[:, :, None]
    out = torch.where(matched, out, torch.full((), mismatch_value,
                                               dtype=x.dtype,
                                               device=x.device))
    ctx.set_output(op, "Out", out)
    ctx.set_output(op, "OutWeight", matched.to(torch.float32))


# ---------------------------------------------------------------------------
# SSD loss (fused pipeline)
# ---------------------------------------------------------------------------


@register("ssd_loss")
def _ssd_loss(ctx, op):
    """The fused SSD multibox loss (reference detection.py ssd_loss):
    IoU match over GTBox's valid rows, max-negative hard mining ranked by
    a stable descending sort of the negatives' confidence loss (at most
    ``neg_pos_ratio`` per positive, as many as there are candidates),
    smooth-L1 on the encoded matched boxes and the softmax loss; Loss
    ``[B, 1]``, divided by ``max(sum(num_pos), 1)`` under ``normalize``.
    The match and the mining are integer decisions: the gradient reaches
    Loc and Conf (and the boxes through their encoding) only."""
    loc = at_least_f32(ctx.get_input(op, "Loc"))
    conf = ctx.get_input(op, "Conf")
    gt_box = at_least_f32(ctx.get_input(op, "GTBox"))
    gt_label = ctx.get_input(op, "GTLabel")
    prior = ctx.get_input(op, "PriorBox")
    pvar = ctx.get_input(op, "PriorBoxVar", None)
    a = op.attrs
    background = int(a.get("background_label", 0))
    overlap_t = float(a.get("overlap_threshold", 0.5))
    neg_pos_ratio = float(a.get("neg_pos_ratio", 3.0))
    neg_overlap = float(a.get("neg_overlap", 0.5))
    loc_w = float(a.get("loc_loss_weight", 1.0))
    conf_w = float(a.get("conf_loss_weight", 1.0))
    match_type = a.get("match_type", "per_prediction")

    if gt_label.dim() == 3:
        gt_label = gt_label[..., 0]
    gt_label = gt_label.long()
    lens = _gt_lengths(ctx, op, "GTBox", gt_box)
    B, M = loc.shape[0], loc.shape[1]
    G = gt_box.shape[1]
    dev = loc.device
    gt_mask = _mask(lens, G, torch.bool)

    with torch.no_grad():
        iou = _iou(gt_box.detach(), prior.expand((B,) + tuple(prior.shape)))
        midx, mdist = _match(iou, gt_mask, match_type, overlap_t)
    pos = midx >= 0
    safe = torch.clamp(midx.long(), 0, G - 1)
    tgt_label = torch.where(pos, torch.gather(gt_label, 1, safe), background)

    logp = torch.log_softmax(at_least_f32(conf), dim=-1)
    conf_loss = -torch.gather(logp, 2, tgt_label[:, :, None])[:, :, 0]

    # hard negative mining (reference mine_hard_examples_op,
    # max_negative): each prior's rank among the candidates by loss
    num_pos = pos.to(torch.int32).sum(1)
    neg_cand = ~pos & (mdist < neg_overlap)
    neg_loss = torch.where(neg_cand, conf_loss.detach(), -math.inf)
    _, order = _desc(neg_loss)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(M, device=dev).expand(B, M))
    num_neg = torch.minimum(
        (num_pos.to(torch.float32) * neg_pos_ratio).to(torch.int32),
        neg_cand.to(torch.int32).sum(1))
    neg_sel = neg_cand & (rank < num_neg[:, None])

    tgt_box = _take_rows(gt_box, safe)
    enc = _encode_box(prior[None], None if pvar is None else pvar[None],
                      tgt_box)
    ad = torch.abs(loc - enc)
    smooth = torch.where(ad < 1.0, 0.5 * ad * ad, ad - 0.5).sum(-1)
    loc_loss = (smooth * pos.to(smooth.dtype)).sum(1)
    conf_total = (conf_loss * (pos | neg_sel).to(conf_loss.dtype)).sum(1)
    total = loc_w * loc_loss + conf_w * conf_total
    if bool(a.get("normalize", True)):
        total = total / torch.clamp(num_pos.to(total.dtype).sum(), min=1.0)
    ctx.set_output(op, "Loss", total[:, None])


# ---------------------------------------------------------------------------
# detection_output: decode + multiclass NMS
# ---------------------------------------------------------------------------


def _nms_keep(boxes, keep, iou_threshold):
    """Greedy NMS over boxes ``[..., K, 4]`` sorted by score, descending,
    from the keep mask ``keep`` ``[..., K]`` (the valid boxes): box j
    stays iff no kept box i < j overlaps it above the threshold.  K
    steps, each over the whole batch (multiclass_nms_op.cc's order)."""
    K = boxes.shape[-2]
    ids = torch.arange(K, device=boxes.device)
    # over_t[..., j, i]: box i < j overlaps box j above the threshold
    over_t = ((_iou(boxes, boxes) > iou_threshold)
              & (ids[:, None] < ids[None, :])).transpose(-1, -2).contiguous()
    keep = keep.clone()
    for j in range(K):
        keep[..., j] &= ~(over_t[..., j, :] & keep).any(-1)
    return keep


@register("multiclass_nms")
def _multiclass_nms(ctx, op):
    """Per class: scores above ``score_threshold``, the top
    ``min(nms_top_k, M)`` by stable sort, greedy NMS; then the top
    ``keep_top_k`` over the classes with the background left out.  Out
    ``[B, keep_top_k, 6]`` (label, score, box; rows past the count -1),
    its counts the lengths.  ``nms_eta`` is not read, as in the JAX
    package.  Nothing runs when no later op or fetch reads Out: a
    Program of ``models.ssd`` trains with its ``detection_output`` in
    place, which the JAX package's jit drops as dead code, and a 400-step
    loop each training step would cost more than the loss."""
    if not ctx.reads(op, "Out"):
        return
    bboxes = ctx.get_input(op, "BBoxes")
    scores = ctx.get_input(op, "Scores")
    a = op.attrs
    background = int(a.get("background_label", 0))
    score_t = float(a.get("score_threshold", 0.01))
    nms_t = float(a.get("nms_threshold", 0.3))
    nms_top_k = int(a.get("nms_top_k", 400))
    keep_top_k = int(a.get("keep_top_k", 200))

    B, C, M = scores.shape
    k = min(nms_top_k, M)
    dev = scores.device
    val, idx = _desc(torch.where(scores > score_t, scores, -math.inf), k)
    bx = _take_rows(bboxes, idx)
    keep = _nms_keep(bx, val > -math.inf, nms_t)
    cls = torch.arange(C, device=dev)[None, :, None].expand(B, C, k)
    flat_v = torch.where(keep & (cls != background), val,
                         -math.inf).reshape(B, C * k)
    kk = min(keep_top_k, C * k)
    top_v, sel = _desc(flat_v, kk)
    box_id = torch.gather(idx.reshape(B, C * k), 1, sel)
    out = torch.cat([torch.gather(cls.reshape(B, C * k), 1, sel)
                     .to(bboxes.dtype)[..., None], top_v[..., None],
                     _take_rows(bboxes, box_id)], -1)
    valid = top_v > -math.inf
    out = torch.where(valid[..., None], out, -1.0)
    ctx.set_output(op, "Out", out)
    ctx.set_lengths(op.outputs["Out"][0], valid.to(torch.int32).sum(1))


# ---------------------------------------------------------------------------
# RPN / Faster-RCNN stack + EAST utilities + in-graph mAP
# (reference: operators/detection/{generate_proposals,rpn_target_assign,
#  generate_proposal_labels,roi_perspective_transform,polygon_box_transform}
#  _op.* and operators/detection_map_op.*)
# ---------------------------------------------------------------------------


@register("polygon_box_transform")
def _polygon_box_transform(ctx, op):
    """Per-pixel quad offsets -> absolute coordinates
    (polygon_box_transform_op.cc: even channels x = w - in, odd channels
    y = h - in)."""
    x = ctx.get_input(op, "Input")
    G, H, W = x.shape[1:]
    jj = torch.arange(W, dtype=x.dtype, device=x.device)[None, None, None, :]
    ii = torch.arange(H, dtype=x.dtype, device=x.device)[None, None, :, None]
    even = (torch.arange(G, device=x.device) % 2 == 0)[None, :, None, None]
    ctx.set_output(op, "Output", torch.where(even, jj - x, ii - x))


def _clip(x, lo, hi):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``, ties split."""
    return torch.minimum(torch.maximum(x, lo), hi)


@register("generate_proposals")
def _generate_proposals(ctx, op):
    """RPN proposals (generate_proposals_op.cc): decode the anchor deltas
    (the +1 pixel rule, exp clamped at log(1000/16)), clip to the image,
    drop boxes under ``min_size`` or centered outside, the pre-NMS top
    ``pre_nms_topN``, greedy NMS, the post-NMS top ``post_nms_topN``.
    RpnRois ``[B, post, 4]`` and RpnRoiProbs ``[B, post, 1]``, zeros past
    each image's count (their lengths)."""
    scores = ctx.get_input(op, "Scores")
    deltas = ctx.get_input(op, "BboxDeltas")
    im_info = ctx.get_input(op, "ImInfo")
    anchors = ctx.get_input(op, "Anchors")
    variances = ctx.get_input(op, "Variances")
    a = op.attrs
    pre_n = int(a.get("pre_nms_topN", 6000))
    post_n = int(a.get("post_nms_topN", 1000))
    nms_thresh = float(a.get("nms_thresh", 0.5))
    min_size = float(a.get("min_size", 0.1))

    B, A, H, W = scores.shape
    N = A * H * W
    anc = anchors.reshape(N, 4)
    k1 = min(pre_n, N)
    k2 = min(post_n, k1)
    bbox_clip = float(math.log(1000.0 / 16.0))

    s = scores.permute(0, 2, 3, 1).reshape(B, N)
    d = deltas.reshape(B, A, 4, H, W).permute(0, 3, 4, 1, 2).reshape(B, N, 4)
    if variances is not None:
        d = d * variances.reshape(N, 4)
    aw = anc[:, 2] - anc[:, 0] + 1
    ah = anc[:, 3] - anc[:, 1] + 1
    acx = anc[:, 0] + 0.5 * aw
    acy = anc[:, 1] + 0.5 * ah
    cx = d[..., 0] * aw + acx
    cy = d[..., 1] * ah + acy
    bw = torch.exp(torch.clamp(d[..., 2], max=bbox_clip)) * aw
    bh = torch.exp(torch.clamp(d[..., 3], max=bbox_clip)) * ah
    h, w, scale = (im_info[:, i:i + 1] for i in range(3))
    zero = h.new_zeros(())
    boxes = torch.stack([_clip(cx - bw / 2, zero, w - 1),
                         _clip(cy - bh / 2, zero, h - 1),
                         _clip(cx + bw / 2 - 1, zero, w - 1),
                         _clip(cy + bh / 2 - 1, zero, h - 1)], -1)
    # FilterBoxes: min_size floored at 1, centers inside the image
    ms = max(min_size, 1.0) * scale
    ws = boxes[..., 2] - boxes[..., 0] + 1
    hs = boxes[..., 3] - boxes[..., 1] + 1
    ok = ((ws >= ms) & (hs >= ms) & (boxes[..., 0] + ws / 2 <= w - 1)
          & (boxes[..., 1] + hs / 2 <= h - 1))
    top_s, idx = _desc(torch.where(ok, s, -math.inf), k1)
    top_b = _take_rows(boxes, idx)
    keep = _nms_keep(top_b.detach(), top_s > -math.inf, nms_thresh)
    out_s, sel = _desc(torch.where(keep, top_s, -math.inf), k2)
    out_b = _take_rows(top_b, sel)
    valid = out_s > -math.inf
    out_b = torch.where(valid[..., None], out_b, 0.0)
    out_s = torch.where(valid, out_s, 0.0)
    counts = valid.to(torch.int32).sum(1)
    ctx.set_output(op, "RpnRois", out_b)
    ctx.set_output(op, "RpnRoiProbs", out_s[..., None])
    ctx.set_lengths(op.outputs["RpnRois"][0], counts)
    ctx.set_lengths(op.outputs["RpnRoiProbs"][0], counts)


def _topk_mask_indices(priority, mask, k):
    """Indices of the up to ``k`` highest-priority True entries of
    ``mask`` (``[B, N]`` -> ``[B, k]`` indices and valid flags), ties
    lower index first; slots past the pool come back invalid."""
    B, n = priority.shape
    kk = min(k, n)
    val, idx = _desc(torch.where(mask, priority, -math.inf), kk)
    ok = val > -math.inf
    if kk < k:
        idx = torch.cat([idx, idx.new_zeros((B, k - kk))], 1)
        ok = torch.cat([ok, ok.new_zeros((B, k - kk))], 1)
    return idx, ok


def _sample(best, fg, bg, S, n_fg):
    """The fixed-size sample of rpn_target_assign and
    generate_proposal_labels: the top ``n_fg`` foreground by ``best``,
    the top ``S - n_fg`` background by ``-best``, the valid rows packed
    first (a stable sort keeps foreground ahead).  Returns (sel, ok,
    is_fg), each ``[B, S]``."""
    fg_idx, fg_ok = _topk_mask_indices(best, fg, n_fg)
    bg_idx, bg_ok = _topk_mask_indices(-best, bg, S - n_fg)
    sel = torch.cat([fg_idx, bg_idx], 1)
    ok = torch.cat([fg_ok, bg_ok], 1)
    is_fg = ok & (torch.arange(S, device=ok.device) < n_fg)
    _, order = torch.sort((~ok).to(torch.uint8), dim=1, stable=True)
    return (torch.gather(sel, 1, order), torch.gather(ok, 1, order),
            torch.gather(is_fg, 1, order))


@register("rpn_target_assign")
def _rpn_target_assign(ctx, op):
    """Foreground and background anchors and a fixed-size sample an image
    (rpn_target_assign_op.cc, deterministic: the highest-IoU foreground
    and the lowest-IoU background first).  Every ground truth's best
    anchor is foreground too, its index scattered into an N + 1 buffer
    whose last slot takes the padded rows'."""
    bbox_pred = ctx.get_input(op, "BboxPred")
    cls_logits = ctx.get_input(op, "ClsLogits")
    anchors = ctx.get_input(op, "AnchorBox").reshape(-1, 4)
    anchor_var = ctx.get_input(op, "AnchorVar")
    gt_name = op.inputs["GtBoxes"][0]
    gt_boxes = ctx.get(gt_name)
    a = op.attrs
    S = int(a.get("rpn_batch_size_per_im", 256))
    fg_frac = float(a.get("rpn_fg_fraction", 0.5))
    pos_ov = float(a.get("rpn_positive_overlap", 0.7))
    neg_ov = float(a.get("rpn_negative_overlap", 0.3))

    B, G = gt_boxes.shape[:2]
    N = anchors.shape[0]
    avar = anchor_var.reshape(-1, 4) if anchor_var is not None else None
    n_fg = int(S * fg_frac)
    gt_lens = _gt_lengths(ctx, op, "GtBoxes", gt_boxes)
    gmask = _mask(gt_lens, G, torch.bool)

    with torch.no_grad():
        iou = _iou(anchors.expand(B, N, 4), gt_boxes.detach())  # [B, N, G]
        iou = torch.where(gmask[:, None, :], iou, -1.0)
        best, _ = iou.max(2)
        argbest = iou.argmax(2)
        best_anchor = torch.where(gmask, iou.argmax(1), N)
        fg = torch.cat([best >= pos_ov, gmask.new_zeros((B, 1))], 1)
        fg = fg.scatter(1, best_anchor, True)[:, :N]
        bg = (best < neg_ov) & ~fg
        sel, ok, is_fg = _sample(best, fg, bg, S, n_fg)

    match = torch.gather(argbest, 1, sel)
    tgt = _encode_box(anchors[sel], avar[sel] if avar is not None else None,
                      _take_rows(gt_boxes, match))
    tgt = torch.where(is_fg[..., None], tgt, 0.0)
    counts = ok.to(torch.int32).sum(1)
    ctx.set_output(op, "PredictedLocation", _take_rows(bbox_pred, sel))
    ctx.set_output(op, "PredictedScores", _take_rows(cls_logits, sel))
    ctx.set_output(op, "TargetLabel", is_fg.to(torch.int32)[..., None])
    ctx.set_output(op, "TargetBBox", tgt)
    for slot in ("PredictedLocation", "PredictedScores", "TargetLabel",
                 "TargetBBox"):
        ctx.set_lengths(op.outputs[slot][0], counts)


@register("generate_proposal_labels")
def _generate_proposal_labels(ctx, op):
    """RoIs sampled against the ground truth for the RCNN head
    (generate_proposal_labels_op.cc): the ground truth joins the pool,
    foreground at IoU >= ``fg_thresh`` (the best box's class), background
    in [lo, hi); a fixed ``batch_size_per_im`` sample with each
    foreground row's regression target in its class's 4 columns of a
    ``[S, 4 * class_nums]`` row, written by a scatter to distinct
    places."""
    rois_name = op.inputs["RpnRois"][0]
    rois = ctx.get(rois_name)
    gt_classes = ctx.get_input(op, "GtClasses")
    gt_boxes = ctx.get_input(op, "GtBoxes")
    a = op.attrs
    S = int(a.get("batch_size_per_im", 512))
    fg_frac = float(a.get("fg_fraction", 0.25))
    fg_thresh = float(a.get("fg_thresh", 0.5))
    bg_hi = float(a.get("bg_thresh_hi", 0.5))
    bg_lo = float(a.get("bg_thresh_lo", 0.0))
    C = int(a.get("class_nums", 81))
    weights = [float(w) for w in a.get("bbox_reg_weights",
                                       [0.1, 0.1, 0.2, 0.2])]

    if gt_classes.dim() == 3:
        gt_classes = gt_classes[..., 0]
    B, R = rois.shape[:2]
    G = gt_boxes.shape[1]
    dev = rois.device
    n_fg = int(S * fg_frac)
    roi_lens = _gt_lengths(ctx, op, "RpnRois", rois)
    gt_lens = _gt_lengths(ctx, op, "GtBoxes", gt_boxes)

    pool = torch.cat([rois, gt_boxes], 1)
    gmask = _mask(gt_lens, G, torch.bool)
    pmask = torch.cat([_mask(roi_lens, R, torch.bool), gmask], 1)
    with torch.no_grad():
        iou = torch.where(gmask[:, None, :],
                          _iou(pool.detach(), gt_boxes.detach()), -1.0)
        # a valid roi with no (or no overlapping) gt is background at
        # overlap 0, as in the reference
        best = torch.where(pmask, _max0(iou.max(2)[0]), -1.0)
        argbest = iou.argmax(2)
        fg = best >= fg_thresh
        bg = (best >= bg_lo) & (best < bg_hi) & pmask
        sel, ok, is_fg = _sample(best, fg, bg, S, n_fg)

    match = torch.gather(argbest, 1, sel)
    picked = _take_rows(pool, sel)
    out_rois = torch.where(ok[..., None], picked, 0.0)
    labels = torch.where(is_fg, torch.gather(gt_classes.long(), 1, match),
                         0).to(torch.int32)
    enc = (_encode_box(picked, None, _take_rows(gt_boxes, match))
           / device_values(weights, picked.dtype, dev))
    cols = (labels.long() * 4)[..., None] + torch.arange(4, device=dev)
    tgt = enc.new_zeros((B, S, 4 * C)).scatter(
        2, cols, torch.where(is_fg[..., None], enc, 0.0))
    inside = enc.new_zeros((B, S, 4 * C)).scatter(
        2, cols, is_fg[..., None].to(enc.dtype).expand(B, S, 4))
    counts = ok.to(torch.int32).sum(1)
    ctx.set_output(op, "Rois", out_rois)
    ctx.set_output(op, "LabelsInt32", labels[..., None])
    ctx.set_output(op, "BboxTargets", tgt)
    ctx.set_output(op, "BboxInsideWeights", inside)
    ctx.set_output(op, "BboxOutsideWeights", inside)
    for slot in ("Rois", "LabelsInt32", "BboxTargets", "BboxInsideWeights",
                 "BboxOutsideWeights"):
        ctx.set_lengths(op.outputs[slot][0], counts)


@register("roi_perspective_transform")
def _roi_perspective_transform(ctx, op):
    """Warp quadrilateral RoIs ``[R, 8]`` to a ``th x tw`` rectangle
    (roi_perspective_transform_op.cc): each RoI's homography from the
    rectangle to its quad by a batched 8 x 8 solve, then a bilinear
    sample of its image along it (0 outside).  Out ``[R, C, th, tw]``;
    an RoI's image is its lengths entry where the RoIs carry R of them,
    else image 0 (the JAX package's reading)."""
    x = ctx.get_input(op, "X")
    rois_name = op.inputs["ROIs"][0]
    rois = ctx.get(rois_name)
    roi_batch = ctx.get_lengths(rois_name)
    th = int(op.attrs.get("transformed_height", 8))
    tw = int(op.attrs.get("transformed_width", 8))
    scale = float(op.attrs.get("spatial_scale", 1.0))

    C, H, W = x.shape[1:]
    R = rois.shape[0]
    dev = x.device
    if roi_batch is not None and roi_batch.shape[0] == R:
        batch_idx = roi_batch.long()
    else:
        batch_idx = torch.zeros((R,), dtype=torch.long, device=dev)

    quad = (rois.reshape(R, 4, 2) * scale).to(x.dtype)
    rect = [(0.0, 0.0), (tw - 1.0, 0.0), (tw - 1.0, th - 1.0),
            (0.0, th - 1.0)]
    zero, one = quad.new_zeros(R), quad.new_ones(R)
    rows, rhs = [], []
    for i, (sx, sy) in enumerate(rect):
        dx, dy = quad[:, i, 0], quad[:, i, 1]
        rows.append(torch.stack([one * sx, one * sy, one, zero, zero, zero,
                                 -dx * sx, -dx * sy], -1))
        rows.append(torch.stack([zero, zero, zero, one * sx, one * sy, one,
                                 -dy * sx, -dy * sy], -1))
        rhs += [dx, dy]
    # solve_ex: no read of the info flag, so nothing waits on the host (a
    # singular system gives non-finite values, as jnp.linalg.solve does)
    h8 = torch.linalg.solve_ex(torch.stack(rows, 1), torch.stack(rhs, 1))[0]
    hm = torch.cat([h8, one[:, None]], 1).reshape(R, 3, 3)

    gy, gx = torch.meshgrid(torch.arange(th, dtype=x.dtype, device=dev),
                            torch.arange(tw, dtype=x.dtype, device=dev),
                            indexing="ij")
    grid = torch.stack([gx, gy, torch.ones_like(gx)]).reshape(3, -1)
    uvw = hm @ grid
    u = uvw[:, 0] / uvw[:, 2]
    v = uvw[:, 1] / uvw[:, 2]
    x0 = torch.clamp(torch.floor(u).to(torch.int32), 0, W - 1)
    y0 = torch.clamp(torch.floor(v).to(torch.int32), 0, H - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    # jnp.clip's ties: on the identity quad every weight sits at 0
    zero, one = u.new_zeros(()), u.new_ones(())
    wx = _clip(u - x0, zero, one)[:, None]
    wy = _clip(v - y0, zero, one)[:, None]
    img = x[batch_idx].reshape(R, C, H * W)

    def at(yy, xx):
        flat = (yy.long() * W + xx.long())[:, None, :].expand(R, C, -1)
        return torch.gather(img, 2, flat)

    out = (at(y0, x0) * (1 - wy) * (1 - wx) + at(y1, x0) * wy * (1 - wx)
           + at(y0, x1) * (1 - wy) * wx + at(y1, x1) * wy * wx)
    inb = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    ctx.set_output(op, "Out", (out * inb[:, None]).reshape(R, C, th, tw))


@register("detection_map")
def _detection_map(ctx, op):
    """In-graph accumulative mAP (detection_map_op.h).  Each image's
    detections, by score, are matched greedily to its ground truth of
    their class (K steps over the batch); each class keeps its
    ``state_capacity`` highest-scored (score, hit) rows of true and false
    positives (a stable descending sort of the old rows and the new), its
    positive count accumulated.  With ``evaluate_difficult=False``,
    difficult ground truth leaves the count and a detection matched to
    one is neither.  ``integral`` or ``11point`` AP, averaged over the
    classes present (the background left out)."""
    det = ctx.get_input(op, "DetectRes")
    gt_boxes = ctx.get_input(op, "GtBoxes")
    gt_labels = ctx.get_input(op, "GtLabels")
    a = op.attrs
    C = int(a["class_num"])
    background = int(a.get("background_label", 0))
    ov_t = float(a.get("overlap_threshold", 0.3))
    ap_type = a.get("ap_type", "integral")
    CAP = int(a.get("state_capacity", 512))

    pos_count = ctx.get_input(op, "PosCount")
    true_pos = ctx.get_input(op, "TruePos")
    false_pos = ctx.get_input(op, "FalsePos")
    if gt_labels.dim() == 3:
        gt_labels = gt_labels[..., 0]
    B, K = det.shape[:2]
    G = gt_boxes.shape[1]
    dev, ft = det.device, at_least_f32(det).dtype
    det = det.to(ft)
    gt_lens = _gt_lengths(ctx, op, "GtBoxes", gt_boxes)
    if pos_count is None:
        pos_count = torch.zeros((C, 1), dtype=torch.int32, device=dev)
        true_pos = torch.full((C, CAP, 2), -1.0, dtype=ft, device=dev)
        false_pos = torch.full((C, CAP, 2), -1.0, dtype=ft, device=dev)
    gmask = _mask(gt_lens, G, torch.bool)
    gt_diff = ctx.get_input(op, "GtDifficult", None)
    if gt_diff is not None and gt_diff.dim() == 3:
        gt_diff = gt_diff[..., 0]
    if gt_diff is None or bool(a.get("evaluate_difficult", True)):
        diff_mask = torch.zeros((B, G), dtype=torch.bool, device=dev)
    else:
        diff_mask = gt_diff.to(torch.bool) & gmask

    # greedy match of each image's detections, score descending
    _, order = _desc(torch.where(det[..., 0] >= 0, det[..., 1], -math.inf))
    ds = _take_rows(det, order)
    iou = _iou(ds[..., 2:6], gt_boxes.to(ft))  # [B, K, G]
    gl = gt_labels.to(torch.int32)
    claimed = torch.zeros((B, G), dtype=torch.bool, device=dev)
    tp = torch.zeros((B, K), dtype=torch.bool, device=dev)
    neutral = torch.zeros((B, K), dtype=torch.bool, device=dev)
    g_ids = torch.arange(G, device=dev)
    for i in range(K):
        lab = ds[:, i, 0].to(torch.int32)
        ious = torch.where(gmask & (gl == lab[:, None]), iou[:, i], -1.0)
        j = ious.argmax(1, keepdim=True)
        hit = ((torch.gather(ious, 1, j) >= ov_t)
               & ~torch.gather(claimed, 1, j) & (ds[:, i:i + 1, 0] >= 0))
        claimed = claimed | ((g_ids[None, :] == j) & hit)
        gd = torch.gather(diff_mask, 1, j)
        tp[:, i:i + 1] = hit & ~gd
        neutral[:, i:i + 1] = hit & gd

    ds_flat = ds.reshape(B * K, 6)
    tp_flat = tp.reshape(B * K)
    valid_flat = (ds_flat[:, 0] >= 0) & ~neutral.reshape(B * K)
    class_ids = torch.arange(C, dtype=torch.int32, device=dev)
    in_c = valid_flat[None, :] & (ds_flat[None, :, 0].to(torch.int32)
                                  == class_ids[:, None])    # [C, BK]
    npos = ((gmask & ~diff_mask)[None] & (gl[None] == class_ids[:, None, None])
            ).to(torch.int32).sum((1, 2))
    sc = ds_flat[:, 1][None, :]
    ones = torch.ones((C, B * K), dtype=ft, device=dev)

    def fold(buf, hits):
        new = torch.stack([torch.where(hits, sc, -1.0), ones], -1)
        rows = torch.cat([buf.to(ft), new], 1)              # [C, CAP+BK, 2]
        _, sel = _desc(rows[..., 0], CAP)
        return _take_rows(rows, sel)

    pos_count = pos_count.to(torch.int32) + npos[:, None]
    true_pos = fold(true_pos, in_c & tp_flat[None, :])
    false_pos = fold(false_pos, in_c & ~tp_flat[None, :])

    merged_s = torch.cat([true_pos[..., 0], false_pos[..., 0]], 1)
    merged_tp = torch.cat([torch.ones(CAP, dtype=ft, device=dev),
                           torch.zeros(CAP, dtype=ft, device=dev)])
    mvalid = merged_s >= 0
    _, order = _desc(torch.where(mvalid, merged_s, -math.inf))
    vrow = torch.gather(mvalid, 1, order)
    t = merged_tp[order] * vrow
    f = (1 - merged_tp[order]) * vrow
    ctp = torch.cumsum(t, 1)
    cfp = torch.cumsum(f, 1)
    npos_all = pos_count[:, 0]
    recall = ctp / torch.clamp(npos_all, min=1)[:, None].to(ft)
    precision = ctp / torch.clamp(ctp + cfp, min=1e-12)
    if ap_type == "11point":
        # jnp.linspace(0, 1, 11) in float32: arange times the rounded 0.1
        pts = torch.arange(11, dtype=ft, device=dev) * 0.1
        prec_at = torch.where((recall[:, None, :] >= pts[None, :, None])
                              & vrow[:, None, :], precision[:, None, :], 0.0)
        ap = prec_at.max(2)[0].mean(1)
    else:
        # every point: the running max of precision from the right
        rprev = torch.cat([recall.new_zeros((C, 1)), recall[:, :-1]], 1)
        pmax = torch.cummax(precision.flip(1), 1)[0].flip(1)
        ap = torch.where(vrow, (recall - rprev) * pmax, 0.0).sum(1)
    present = (npos_all > 0) & (class_ids != background)
    aps = torch.where(present, ap, 0.0)
    m_ap = aps.sum() / torch.clamp(present.to(torch.int32).sum(), min=1)
    ctx.set_output(op, "MAP", m_ap.reshape(1))
    ctx.set_output(op, "AccumPosCount", pos_count)
    ctx.set_output(op, "AccumTruePos", true_pos)
    ctx.set_output(op, "AccumFalsePos", false_pos)
