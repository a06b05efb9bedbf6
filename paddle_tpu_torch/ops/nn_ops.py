"""NN op rules: conv2d, pool2d, batch_norm, layer_norm, dropout, softmax,
the losses, embedding lookup and accuracy.

Translated from the JAX package's ``paddle_tpu/ops/nn_ops.py``, for the
ops the port runs so far.  They are torch ops: XLA fused them (or ran
its own convolutions) on the TPU, and no Pallas kernel ever computed
them; on the card conv2d and pool2d are cuDNN's.  An output that no later
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


@register("pool2d")
def _pool2d(ctx, op):
    """Max or average pooling over NCHW, padded explicitly first: low
    side ``paddings``, high side the same or, under ``ceil_mode``, as much
    as the last partial window needs (the JAX package's ``pads_hi``; a
    window that starts in the right padding still counts, which torch's
    own ceil_mode would drop).  Average pooling divides by the window's
    in-bounds count (``exclusive``) only where there is padding."""
    x = ctx.get_input(op, "X")
    a = op.attrs
    ksize = _pair(a.get("ksize"))
    strides = _pair(a.get("strides", [1, 1]))
    pads = _pair(a.get("paddings", [0, 0]))
    if a.get("global_pooling", False):
        ksize, pads, strides = tuple(x.shape[2:]), (0, 0), (1, 1)
    pads_hi = list(pads)
    if a.get("ceil_mode", False):
        for i in range(2):
            in_sz = x.shape[2 + i]
            out_sz = -(-(in_sz - ksize[i] + 2 * pads[i]) // strides[i]) + 1
            needed = (out_sz - 1) * strides[i] + ksize[i] - in_sz - pads[i]
            pads_hi[i] = max(needed, pads[i])
    # F.pad lists the last axis first: (W low, W high, H low, H high)
    pad = (pads[1], pads_hi[1], pads[0], pads_hi[0])
    if a.get("pooling_type", "max") == "max":
        xp = F.pad(x, pad, value=float("-inf"))
        out = F.max_pool2d(xp, ksize, strides)
    else:
        xf = at_least_f32(x)
        s = F.avg_pool2d(F.pad(xf, pad), ksize, strides, divisor_override=1)
        if a.get("exclusive", True) and (any(pads) or any(pads_hi)):
            ones = F.pad(torch.ones_like(xf[:1, :1]), pad)
            cnt = F.avg_pool2d(ones, ksize, strides, divisor_override=1)
            out = (s / cnt).to(x.dtype)
        else:
            out = (s / float(math.prod(ksize))).to(x.dtype)
    ctx.set_output(op, "Out", out)


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
