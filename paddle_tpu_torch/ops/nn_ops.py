"""NN op rules: the convolutions (2-D, 3-D and transposed), pooling,
batch_norm, layer_norm, lrn, dropout, softmax, the losses, embedding
lookup, the metrics (accuracy, auc, mean_iou), im2sequence, the image
resizes and roi_pool.

Translated from the JAX package's ``paddle_tpu/ops/nn_ops.py``, every
rule of it.  They are torch ops: XLA fused them (or ran its own
convolutions) on the TPU, and no Pallas kernel ever computed them; on
the card the convolutions and pooling are cuDNN's.  An output that no later
op reads and no fetch asks for (softmax_with_cross_entropy's Softmax,
dropout's Mask, layer_norm's Mean and Variance) is not computed: XLA
dropped such dead values from the JAX package's step.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..registry import register
from .common import at_least_f32, in_range, mixed_dtypes, wrapped_index


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


@register("conv2d", "depthwise_conv2d")
def _conv2d(ctx, op):
    """The convolution, plus an optional ``Bias`` per output channel.
    Layers never give conv2d a ``Bias``; the inference transpiler's
    conv+BN fold does (the JAX package's rule never reads one)."""
    x = ctx.get_input(op, "Input")  # NCHW
    w = ctx.get_input(op, "Filter")  # OIHW (I = C/groups)
    x, w = mixed_dtypes(x, w)
    groups = op.attrs.get("groups", 1) or 1
    if op.type == "depthwise_conv2d":
        groups = x.shape[1]
    out = F.conv2d(x, w, stride=_pair(op.attrs.get("strides", [1, 1])),
                   padding=_pair(op.attrs.get("paddings", [0, 0])),
                   dilation=_pair(op.attrs.get("dilations", [1, 1])),
                   groups=groups)
    bias = ctx.get_input(op, "Bias")
    if bias is not None:
        out = out + bias.to(out.dtype).reshape(1, -1, 1, 1)
    ctx.set_output(op, "Output", out.to(x.dtype))


@register("conv3d")
def _conv3d(ctx, op):
    x = ctx.get_input(op, "Input")  # NCDHW
    w = ctx.get_input(op, "Filter")  # OIDHW (I = C/groups)
    x, w = mixed_dtypes(x, w)
    out = F.conv3d(x, w, stride=_pair(op.attrs.get("strides", [1, 1, 1]), 3),
                   padding=_pair(op.attrs.get("paddings", [0, 0, 0]), 3),
                   dilation=_pair(op.attrs.get("dilations", [1, 1, 1]), 3),
                   groups=op.attrs.get("groups", 1) or 1)
    ctx.set_output(op, "Output", out.to(x.dtype))


@register("conv2d_transpose")
def _conv2d_transpose(ctx, op):
    """The transposed convolution of a filter laid out
    ``[in, out/groups, kh, kw]`` (the reference's and torch's layout):
    the JAX package's lhs-dilated convolution with the flipped filter,
    padded ``dilation * (k - 1) - padding`` a side, which is
    ``F.conv_transpose2d`` with no output padding; its output is
    ``(H - 1) * stride - 2 * padding + dilation * (k - 1) + 1``."""
    x = ctx.get_input(op, "Input")  # NCHW
    w = ctx.get_input(op, "Filter")
    x, w = mixed_dtypes(x, w)
    out = F.conv_transpose2d(
        x, w, stride=_pair(op.attrs.get("strides", [1, 1])),
        padding=_pair(op.attrs.get("paddings", [0, 0])),
        groups=op.attrs.get("groups", 1) or 1,
        dilation=_pair(op.attrs.get("dilations", [1, 1])))
    ctx.set_output(op, "Output", out.to(x.dtype))


@register("conv3d_transpose")
def _conv3d_transpose(ctx, op):
    """The 3-D transposed convolution of a filter ``[in, out, kd, kh,
    kw]``.  The JAX package's rule reads only ``strides`` and
    ``paddings``: a ``dilations`` or ``groups`` attribute changes
    nothing there, and so nothing here (ROADMAP's "Checked" list)."""
    x = ctx.get_input(op, "Input")
    w = ctx.get_input(op, "Filter")
    out = F.conv_transpose3d(
        x, w, stride=_pair(op.attrs.get("strides", [1, 1, 1]), 3),
        padding=_pair(op.attrs.get("paddings", [0, 0, 0]), 3))
    ctx.set_output(op, "Output", out.to(x.dtype))


def _pool(ctx, op, nd):
    """Max or average pooling over ``nd`` spatial axes (NCHW, NCDHW),
    padded explicitly first: low side ``paddings``, high side the same
    or, under ``ceil_mode``, as much as the last partial window needs
    (the JAX package's ``pads_hi``; a window that starts in the right
    padding still counts, which torch's own ceil_mode would drop).  Max
    pads with -inf.  Average pooling divides by the window's in-bounds
    count (``exclusive``) only where there is padding."""
    x = ctx.get_input(op, "X")
    a = op.attrs
    ksize = _pair(a.get("ksize"), nd)
    strides = _pair(a.get("strides", [1] * nd), nd)
    pads = _pair(a.get("paddings", [0] * nd), nd)
    if a.get("global_pooling", False):
        ksize, pads, strides = tuple(x.shape[2:]), (0,) * nd, (1,) * nd
    pads_hi = list(pads)
    if a.get("ceil_mode", False):
        for i in range(nd):
            in_sz = x.shape[2 + i]
            out_sz = -(-(in_sz - ksize[i] + 2 * pads[i]) // strides[i]) + 1
            needed = (out_sz - 1) * strides[i] + ksize[i] - in_sz - pads[i]
            pads_hi[i] = max(needed, pads[i])
    # F.pad lists the last axis first: (W low, W high, H low, H high, ...)
    pad = tuple(p for i in reversed(range(nd)) for p in (pads[i], pads_hi[i]))
    max_pool = (F.max_pool2d, F.max_pool3d)[nd - 2]
    avg_pool = (F.avg_pool2d, F.avg_pool3d)[nd - 2]
    if a.get("pooling_type", "max") == "max":
        xp = F.pad(x, pad, value=float("-inf"))
        out = max_pool(xp, ksize, strides)
    else:
        xf = at_least_f32(x)
        s = avg_pool(F.pad(xf, pad), ksize, strides, divisor_override=1)
        if a.get("exclusive", True) and (any(pads) or any(pads_hi)):
            ones = F.pad(torch.ones_like(xf[:1, :1]), pad)
            cnt = avg_pool(ones, ksize, strides, divisor_override=1)
            out = (s / cnt).to(x.dtype)
        else:
            out = (s / float(math.prod(ksize))).to(x.dtype)
    ctx.set_output(op, "Out", out)


@register("pool2d")
def _pool2d(ctx, op):
    _pool(ctx, op, 2)


@register("pool3d")
def _pool3d(ctx, op):
    _pool(ctx, op, 3)


@register("batch_norm")
def _batch_norm(ctx, op):
    """Batch normalization over every axis but the channel's (axis 1 in
    NCHW, the last in NHWC), in the JAX package's order, in float32 (or
    float64 for a float64 input):
    ``(x - m) * rsqrt(v + eps) * Scale + Bias``.  Training uses the
    batch's mean and biased variance (the gradient of ``Y`` flows
    through both) and updates the running statistics as
    ``running * momentum + batch * (1 - momentum)``, without gradient,
    stored back in their own dtype through ``MeanOut``/``VarianceOut``
    (which name the same persistable variables).  ``is_test`` (the
    attribute, or a run for test) uses the running statistics and passes
    them through."""
    x = ctx.get_input(op, "X")
    scale = ctx.get_input(op, "Scale")
    bias = ctx.get_input(op, "Bias")
    mean = ctx.get_input(op, "Mean")
    var = ctx.get_input(op, "Variance")
    eps = op.attrs.get("epsilon", 1e-5)
    momentum = op.attrs.get("momentum", 0.9)
    is_test = op.attrs.get("is_test", False) or ctx.is_test
    c_axis = 1 if op.attrs.get("data_layout", "NCHW") == "NCHW" else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != c_axis)
    shape = [1] * x.dim()
    shape[c_axis] = -1

    xf = at_least_f32(x)
    if is_test:
        m, v = mean, var
    else:
        m = xf.mean(axes)
        v = xf.var(axes, unbiased=False)
        ctx.set_output(op, "MeanOut", (
            at_least_f32(mean) * momentum + m.detach() * (1 - momentum)
        ).to(mean.dtype))
        ctx.set_output(op, "VarianceOut", (
            at_least_f32(var) * momentum + v.detach() * (1 - momentum)
        ).to(var.dtype))
    inv = torch.rsqrt(v + eps)
    y = ((xf - m.reshape(shape)) * inv.reshape(shape) * scale.reshape(shape)
         + bias.reshape(shape))
    ctx.set_output(op, "Y", y.to(x.dtype))
    ctx.set_output(op, "SavedMean", m)
    ctx.set_output(op, "SavedVariance", v)
    if is_test:
        ctx.set_output(op, "MeanOut", mean)
        ctx.set_output(op, "VarianceOut", var)


@register("layer_norm")
def _layer_norm(ctx, op):
    """Normalized over the axes from ``begin_norm_axis`` on, in float32
    (or float64 for a float64 input), times ``Scale`` plus ``Bias``,
    both widened to that type, and ``Y`` cast back to ``X``'s dtype: the
    JAX package's order, where a bfloat16 ``Scale`` multiplies a float32
    product."""
    x = ctx.get_input(op, "X")
    begin = op.attrs.get("begin_norm_axis", 1)
    eps = op.attrs.get("epsilon", 1e-5)
    norm_shape = tuple(x.shape[begin:])
    xf = at_least_f32(x)
    scale = ctx.get_input(op, "Scale")
    bias = ctx.get_input(op, "Bias")
    y = F.layer_norm(
        xf, norm_shape,
        None if scale is None else scale.to(xf.dtype).reshape(norm_shape),
        None if bias is None else bias.to(xf.dtype).reshape(norm_shape), eps)
    ctx.set_output(op, "Y", y.to(x.dtype))
    if ctx.reads(op, "Mean") or ctx.reads(op, "Variance"):
        axes = tuple(range(begin, x.dim()))
        ctx.set_output(op, "Mean", xf.mean(axes).reshape(x.shape[:begin]))
        ctx.set_output(op, "Variance", xf.var(axes, unbiased=False)
                       .reshape(x.shape[:begin]))


@register("lrn")
def _lrn(ctx, op):
    """Local response normalization across channels, the JAX package's
    form: ``MidOut = k + alpha * S`` with ``S`` the sum of ``x**2`` over
    the ``n`` channels centred on each (zero past the ends), and
    ``Out = x / MidOut**beta``.  (``F.local_response_norm`` divides
    ``alpha`` by ``n``.)"""
    x = ctx.get_input(op, "X")  # NCHW
    n = op.attrs.get("n", 5)
    k = op.attrs.get("k", 1.0)
    alpha = op.attrs.get("alpha", 1e-4)
    beta = op.attrs.get("beta", 0.75)
    half = n // 2
    acc = F.avg_pool3d((x * x).unsqueeze(1), (n, 1, 1), 1, (half, 0, 0),
                       divisor_override=1).squeeze(1)
    mid = k + alpha * acc
    ctx.set_output(op, "Out", x / mid ** beta)
    ctx.set_output(op, "MidOut", mid)


@register("dropout")
def _dropout(ctx, op):
    x = ctx.get_input(op, "X")
    p = op.attrs.get("dropout_prob", 0.5)
    is_test = op.attrs.get("is_test", False) or ctx.is_test
    impl = op.attrs.get("dropout_implementation", "downgrade_in_infer")
    if is_test:
        out = x * (1.0 - p) if impl == "downgrade_in_infer" else x
        ctx.set_output(op, "Out", out)
        return
    gen = ctx.op_generator(op, op.attrs.get("seed", 0) or 0)
    mask = torch.rand(x.shape, generator=gen, device=x.device) < (1.0 - p)
    if impl == "upscale_in_train":
        out = torch.where(mask, x / max(1.0 - p, 1e-8), 0.0).to(x.dtype)
    else:
        out = torch.where(mask, x, 0.0).to(x.dtype)
    ctx.set_output(op, "Out", out)
    if ctx.reads(op, "Mask"):
        ctx.set_output(op, "Mask", mask.to(x.dtype))
    ctx.copy_lengths(op.inputs["X"][0], op.outputs["Out"][0])


@register("softmax")
def _softmax(ctx, op):
    x = ctx.get_input(op, "X")
    ctx.set_output(op, "Out",
                   torch.softmax(at_least_f32(x), dim=-1).to(x.dtype))


@register("cross_entropy")
def _cross_entropy(ctx, op):
    """-log of the probability at the label (hard) or the label-weighted
    sum of -log probabilities (soft), probabilities clipped to
    [1e-20, 1].  The clip is the JAX package's ``jnp.clip`` (a max then
    a min), whose gradient at either bound is one half; hard labels are
    gathered as in softmax_with_cross_entropy."""
    x = ctx.get_input(op, "X")  # probs [..., C]
    label = ctx.get_input(op, "Label")
    ignore = op.attrs.get("ignore_index", -100)
    xf = at_least_f32(x)
    xf = torch.minimum(torch.maximum(xf, xf.new_full((), 1e-20)),
                       xf.new_full((), 1.0))
    logp = torch.log(xf)
    if op.attrs.get("soft_label", False):
        loss = -torch.sum(label.float() * logp, dim=-1, keepdim=True)
    else:
        lab = label.reshape(label.shape[:-1]) if label.shape[-1] == 1 else label
        lab = lab[..., None]
        loss = -torch.gather(logp, -1, wrapped_index(lab, logp.shape[-1]))
        loss = torch.where(in_range(lab, logp.shape[-1]), loss, float("nan"))
        loss = torch.where(lab == ignore, 0.0, loss)
    ctx.set_output(op, "Y", loss.to(x.dtype))


@register("softmax_with_cross_entropy")
def _softmax_with_cross_entropy(ctx, op):
    logits = ctx.get_input(op, "Logits")
    label = ctx.get_input(op, "Label")
    soft = op.attrs.get("soft_label", False)
    ignore = op.attrs.get("ignore_index", -100)
    logp = torch.log_softmax(at_least_f32(logits), dim=-1)
    if soft:
        loss = -torch.sum(label.float() * logp, dim=-1, keepdim=True)
    else:
        lab = label.reshape(label.shape[:-1]) if label.shape[-1] == 1 else label
        lab = lab[..., None]
        loss = -torch.gather(logp, -1, wrapped_index(lab, logp.shape[-1]))
        loss = torch.where(in_range(lab, logp.shape[-1]), loss, float("nan"))
        loss = torch.where(lab == ignore, 0.0, loss)
    if ctx.reads(op, "Softmax"):
        ctx.set_output(op, "Softmax", torch.exp(logp).to(logits.dtype))
    ctx.set_output(op, "Loss", loss.to(logits.dtype))


@register("square_error_cost")
def _square_error_cost(ctx, op):
    x = ctx.get_input(op, "X")
    y = ctx.get_input(op, "Y")
    d = x - y
    ctx.set_output(op, "Out", d * d)


def _abs(x):
    """``|x|`` with the JAX package's gradient at 0 (+1; torch's is 0)."""
    return torch.where(x >= 0, x, -x)


@register("smooth_l1_loss")
def _smooth_l1(ctx, op):
    x = ctx.get_input(op, "X")
    y = ctx.get_input(op, "Y")
    sigma = op.attrs.get("sigma", 1.0)
    iw = ctx.get_input(op, "InsideWeight")
    ow = ctx.get_input(op, "OutsideWeight")
    s2 = sigma * sigma
    d = x - y
    if iw is not None:
        d = d * iw
    ad = _abs(d)
    loss = torch.where(ad < 1.0 / s2, 0.5 * d * d * s2, ad - 0.5 / s2)
    if ow is not None:
        loss = loss * ow
    ctx.set_output(op, "Diff", d)
    ctx.set_output(op, "Out", loss.reshape(loss.shape[0], -1).sum(1, keepdim=True))


@register("dice_loss")
def _dice_loss(ctx, op):
    x = ctx.get_input(op, "X")
    label = ctx.get_input(op, "Label").to(x.dtype)
    eps = op.attrs.get("epsilon", 1e-5)
    x2 = x.reshape(x.shape[0], -1)
    l2 = label.reshape(label.shape[0], -1)
    inter = (x2 * l2).sum(1)
    union = x2.sum(1) + l2.sum(1)
    dice = 1.0 - (2.0 * inter + eps) / (union + eps)
    ctx.set_output(op, "Out", dice.mean().reshape(1))


@register("rank_loss")
def _rank_loss(ctx, op):
    """``log1p(exp(d)) - label * d`` as written (``inf`` where ``exp(d)``
    overflows, as in the JAX package; ``F.softplus`` would not)."""
    label = ctx.get_input(op, "Label")
    d = ctx.get_input(op, "Left") - ctx.get_input(op, "Right")
    ctx.set_output(op, "Out", torch.log1p(torch.exp(d)) - label * d)


@register("margin_rank_loss")
def _margin_rank_loss(ctx, op):
    """``maximum(0, -label * (x1 - x2) + margin)``; at a tie the gradient
    is shared half and half, as ``jnp.maximum``'s (``relu``'s is 0)."""
    label = ctx.get_input(op, "Label")
    x1 = ctx.get_input(op, "X1")
    x2 = ctx.get_input(op, "X2")
    z = -label * (x1 - x2) + op.attrs.get("margin", 0.1)
    ctx.set_output(op, "Out", torch.maximum(z.new_zeros(()), z))


@register("huber_loss")
def _huber_loss(ctx, op):
    x = ctx.get_input(op, "X")
    y = ctx.get_input(op, "Y")
    delta = op.attrs.get("delta", 1.0)
    d = y - x
    ad = _abs(d)
    ctx.set_output(op, "Out", torch.where(ad <= delta, 0.5 * d * d,
                                          delta * (ad - 0.5 * delta)))
    ctx.set_output(op, "Residual", d)


@register("log_loss")
def _log_loss(ctx, op):
    p = ctx.get_input(op, "Predicted")
    label = ctx.get_input(op, "Labels")
    eps = op.attrs.get("epsilon", 1e-4)
    ctx.set_output(op, "Loss", -label * torch.log(p + eps)
                   - (1 - label) * torch.log(1 - p + eps))


@register("sigmoid_cross_entropy_with_logits")
def _sigmoid_ce(ctx, op):
    """``max(x, 0) - x * label + log1p(exp(-|x|))``, 0 where the label is
    ``ignore_index``, in float32 (float64 for a float64 input).  The
    maximum and ``|x|`` carry the JAX package's gradients at x = 0 (a
    half share, and +1), so a zero logit with label 0 has gradient 0,
    where ``F.binary_cross_entropy_with_logits`` gives 0.5."""
    x = at_least_f32(ctx.get_input(op, "X"))
    label = ctx.get_input(op, "Label").to(x.dtype)
    loss = (torch.maximum(x, x.new_zeros(())) - x * label
            + torch.log1p(torch.exp(-_abs(x))))
    ignore = op.attrs.get("ignore_index", -100)
    ctx.set_output(op, "Out", torch.where(label == ignore, 0.0, loss))


@register("lookup_table")
def _lookup_table(ctx, op):
    w = ctx.get_input(op, "W")  # [V, D]
    ids = ctx.get_input(op, "Ids")
    padding_idx = op.attrs.get("padding_idx", -1)
    flat = ids.reshape(ids.shape[:-1]) if (ids.dim() > 1 and ids.shape[-1] == 1) else ids
    out = F.embedding(wrapped_index(flat, w.shape[0]), w)
    out = torch.where(in_range(flat, w.shape[0])[..., None], out,
                      float("nan"))
    if padding_idx is not None and padding_idx >= 0:
        out = torch.where((flat == padding_idx)[..., None], 0.0, out)
    ctx.set_output(op, "Out", out)
    ctx.copy_lengths(op.inputs["Ids"][0], op.outputs["Out"][0])


@register("accuracy")
def _accuracy(ctx, op):
    idx = ctx.get_input(op, "Indices")  # [N, k] top_k indices
    label = ctx.get_input(op, "Label")  # [N, 1]
    correct = (idx == label.to(idx.dtype)).any(dim=-1)
    n = correct.shape[0]
    num_correct = correct.float().sum()
    ctx.set_output(op, "Accuracy", (num_correct / n).reshape(1))
    ctx.set_output(op, "Correct", num_correct.to(torch.int32).reshape(1))
    ctx.set_output(op, "Total", torch.full((1,), n, dtype=torch.int32,
                                           device=idx.device))


def _count(n, idx, weight):
    """A float32 histogram of ``n`` bins: ``weight`` added at each of
    ``idx`` (int64 in [0, n)).  The counts are whole numbers, exact in
    float32 below 2**24 in any order, so the card's atomic adds give the
    same bits on every run."""
    return torch.zeros(n, dtype=torch.float32, device=idx.device).index_add_(
        0, idx, weight.to(torch.float32))


@register("auc")
def _auc(ctx, op):
    """The ROC AUC over ``num_thresholds + 1`` score bins, the batch's
    histograms added to the ``StatPos``/``StatNeg`` persistables (written
    back through ``StatPosOut``/``StatNegOut``).  The positive score is
    column 1 of ``Predict``, or column 0 of a one-column input: the JAX
    package's ``prob[:, 1]`` clamps the index there.  The area is summed
    in float64, where every partial sum of these whole and half counts is
    exact, so it has the same bits in any order (the card's, the CPU's)
    and is within float32 rounding of the JAX package's float32 sums."""
    prob = ctx.get_input(op, "Predict")  # [N, C]
    label = ctx.get_input(op, "Label").reshape(-1)
    score = prob[:, min(1, prob.shape[1] - 1)].detach()
    num_bins = op.attrs.get("num_thresholds", 4095) + 1
    # the JAX package's int32 cast then clip: truncated toward 0, NaN to
    # bin 0, the rest clipped to [0, num_bins - 1]
    s = score * num_bins
    s = torch.where(torch.isnan(s), 0.0, s).clamp(0, num_bins - 1)
    bins = s.to(torch.int64)
    is_pos = (label > 0).to(torch.float32)
    pos_hist = _count(num_bins, bins, is_pos)
    neg_hist = _count(num_bins, bins, 1.0 - is_pos)
    stat_pos = ctx.get_input(op, "StatPos")
    stat_neg = ctx.get_input(op, "StatNeg")
    if stat_pos is not None:
        pos_hist = pos_hist + stat_pos
        neg_hist = neg_hist + stat_neg
        ctx.set_output(op, "StatPosOut", pos_hist)
        ctx.set_output(op, "StatNegOut", neg_hist)
    tot_pos = pos_hist.double().flip(0).cumsum(0).flip(0)
    tot_neg = neg_hist.double().flip(0).cumsum(0).flip(0)
    zero = tot_pos.new_zeros(1)
    tp = torch.cat([tot_pos, zero])
    fp = torch.cat([tot_neg, zero])
    auc = torch.sum((fp[:-1] - fp[1:]) * (tp[:-1] + tp[1:]) / 2.0)
    both = tot_pos[0] * tot_neg[0]
    auc = torch.where(both > 0, auc / torch.maximum(both, both.new_ones(())),
                      auc.new_full((), 0.5))
    ctx.set_output(op, "AUC", auc.to(torch.float32).reshape(1))


@register("mean_iou")
def _mean_iou(ctx, op):
    """Mean intersection over union from the confusion matrix of
    ``label * num_classes + prediction``, counted as the JAX package's
    ``.at[idx].add`` counts: an index in [-n*n, 0) wraps, any other
    outside [0, n*n) is dropped.  ``OutWrong`` and ``OutCorrect`` are
    int32.  The mean is taken in float64, where the sum of up to 32
    classes' float32 ratios of counts is exact (the same bits in any
    order), and rounded to float32."""
    pred = ctx.get_input(op, "Predictions").reshape(-1)
    label = ctx.get_input(op, "Labels").reshape(-1)
    n = op.attrs["num_classes"]
    idx = label.to(torch.int32).long() * n + pred.to(torch.int32).long()
    cm = _count(n * n, wrapped_index(idx, n * n),
                in_range(idx, n * n)).reshape(n, n)
    inter = torch.diagonal(cm)
    union = cm.sum(0) + cm.sum(1) - inter
    valid = union > 0
    iou = torch.where(valid, inter / torch.clamp(union, min=1.0), 0.0)
    miou = iou.double().sum() / torch.clamp(valid.double().sum(), min=1.0)
    ctx.set_output(op, "OutMeanIou", miou.to(torch.float32).reshape(1))
    ctx.set_output(op, "OutWrong", (cm.sum(1) - inter).to(torch.int32))
    ctx.set_output(op, "OutCorrect", inter.to(torch.int32))


@register("im2sequence")
def _im2sequence(ctx, op):
    """Each ``kernels`` patch of the NCHW input, ``paddings`` being
    ``[top, left, bottom, right]``, as one time step ``[C * kh * kw]``
    (channel-major): ``Out`` is ``[N, oh * ow, C * kh * kw]`` with
    lengths ``oh * ow`` a row.  A Program that fetches it is never bound
    (a fetch that carries lengths, ``executor._graph_refusal``)."""
    x = ctx.get_input(op, "X")  # NCHW
    kh, kw = _pair(op.attrs["kernels"])
    sh, sw = _pair(op.attrs.get("strides", [1, 1]))
    pt, pl, pb, pr = (op.attrs.get("paddings") or [0, 0, 0, 0])
    xp = F.pad(x, (pl, pr, pt, pb))
    oh = (xp.shape[2] - kh) // sh + 1
    ow = (xp.shape[3] - kw) // sw + 1
    patches = F.unfold(xp, (kh, kw), stride=(sh, sw))  # [N, C*kh*kw, oh*ow]
    ctx.set_output(op, "Out", patches.transpose(1, 2))
    ctx.set_lengths(op.outputs["Out"][0],
                    torch.full((x.shape[0],), oh * ow, dtype=torch.int32,
                               device=x.device))


def _feeds_out_size(op):
    return bool(op.inputs.get("OutSize"))


@register("bilinear_interp", reads_host=_feeds_out_size)
def _bilinear_interp(ctx, op):
    """``jax.image.resize(..., "bilinear")``: half-pixel centres, and a
    triangle filter widened by the scale where it shrinks an axis
    (antialiasing), which is ``F.interpolate(antialias=True)``.  The size
    is ``out_h``/``out_w``, or an ``OutSize`` input read back to the host
    at every run: a Program that feeds one runs op by op and is never
    captured (``reads_host`` holds for such an op only)."""
    x = ctx.get_input(op, "X")  # NCHW
    out_size = ctx.get_input(op, "OutSize")
    if out_size is not None:
        oh, ow = (int(v) for v in out_size.reshape(-1).tolist()[:2])
    else:
        oh, ow = op.attrs["out_h"], op.attrs["out_w"]
    out = F.interpolate(x, size=(oh, ow), mode="bilinear",
                        align_corners=False, antialias=True)
    ctx.set_output(op, "Out", out.to(x.dtype))


@register("nearest_interp")
def _nearest_interp(ctx, op):
    """``jax.image.resize(..., "nearest")``: the source pixel whose cell
    holds the output's half-pixel centre, ``F.interpolate``'s
    ``nearest-exact`` (its ``nearest`` floors the unshifted position)."""
    x = ctx.get_input(op, "X")
    out = F.interpolate(x, size=(op.attrs["out_h"], op.attrs["out_w"]),
                        mode="nearest-exact")
    ctx.set_output(op, "Out", out.to(x.dtype))


@register("roi_pool")
def _roi_pool(ctx, op):
    """Max pooling of each ROI ``(x1, y1, x2, y2)`` (scaled by
    ``spatial_scale``, rounded half to even) over a ``pooled_height x
    pooled_width`` grid of image 0, the JAX package's plain-ROI path: a
    cell that covers no pixel is -inf, and tied maxima share a cell's
    gradient equally (``amax``).  ROIs that carry lengths (a batch of
    images) raise: the JAX package reads the lengths as image indices
    there (ROADMAP R-5)."""
    x = ctx.get_input(op, "X")  # [N, C, H, W]
    rois = ctx.get_input(op, "ROIs")  # [R, 4]
    if ctx.get_lengths(op.inputs["ROIs"][0]) is not None:
        raise ValueError(
            "roi_pool: ROIs that carry lengths (ROIs over a batch of images) "
            "are not supported: the JAX package reads their lengths as image "
            "indices (ROADMAP R-5); pass plain [R, 4] ROIs over image 0")
    ph = op.attrs.get("pooled_height", 1)
    pw = op.attrs.get("pooled_width", 1)
    scale = op.attrs.get("spatial_scale", 1.0)
    h, w = x.shape[2], x.shape[3]
    corner = torch.round(rois * scale).to(torch.int64)
    x1, y1, x2, y2 = corner.unbind(1)
    rw = torch.clamp(x2 - x1 + 1, min=1)
    rh = torch.clamp(y2 - y1 + 1, min=1)
    ys = torch.arange(h, device=x.device)
    xs = torch.arange(w, device=x.device)
    feats = x[:1]  # every plain ROI reads image 0
    rows = []
    for i in range(ph):
        hs = y1 + torch.div(i * rh, ph, rounding_mode="floor")
        he = y1 + torch.div((i + 1) * rh + ph - 1, ph, rounding_mode="floor")
        ymask = (ys >= hs[:, None]) & (ys < torch.maximum(he, hs + 1)[:, None])
        cells = []
        for j in range(pw):
            ws = x1 + torch.div(j * rw, pw, rounding_mode="floor")
            we = x1 + torch.div((j + 1) * rw + pw - 1, pw, rounding_mode="floor")
            xmask = (xs >= ws[:, None]) & (xs < torch.maximum(we, ws + 1)[:, None])
            m = ymask[:, None, :, None] & xmask[:, None, None, :]  # [R,1,H,W]
            cells.append(torch.amax(torch.where(m, feats, float("-inf")),
                                    dim=(2, 3)))
        rows.append(torch.stack(cells, -1))
    ctx.set_output(op, "Out", torch.stack(rows, -2))  # [R, C, ph, pw]
