"""NN op rules: layer_norm, dropout, softmax, the loss, embedding lookup.

Translated from the JAX package's ``paddle_tpu/ops/nn_ops.py``, for the
ops the port runs so far.  They are torch ops: XLA fused them on the
TPU, and no Pallas kernel ever computed them.  An output that no later
op reads and no fetch asks for (softmax_with_cross_entropy's Softmax,
dropout's Mask, layer_norm's Mean and Variance) is not computed: XLA
dropped such dead values from the JAX package's step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..registry import register


def _wrapped_index(idx, n):
    """``idx`` as int64 indices into an axis of length ``n`` the way the
    JAX package's ``jnp.take``/``take_along_axis`` read them: an index in
    [-n, 0) wraps to ``n + idx``; one outside [-n, n) is clamped to a
    valid row here, and :func:`_in_range` marks it for the NaN fill."""
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx).clamp(0, max(n - 1, 0))


def _in_range(idx, n):
    """Where ``idx`` is a valid index into an axis of length ``n``
    (negatives in [-n, 0) included); elsewhere the JAX package's gathers
    fill NaN."""
    return (idx >= -n) & (idx < n)


@register("layer_norm")
def _layer_norm(ctx, op):
    x = ctx.get_input(op, "X")
    begin = op.attrs.get("begin_norm_axis", 1)
    eps = op.attrs.get("epsilon", 1e-5)
    norm_shape = tuple(x.shape[begin:])
    scale = ctx.get_input(op, "Scale")
    bias = ctx.get_input(op, "Bias")
    y = F.layer_norm(x.float(), norm_shape,
                     None if scale is None else scale.reshape(norm_shape),
                     None if bias is None else bias.reshape(norm_shape), eps)
    ctx.set_output(op, "Y", y.to(x.dtype))
    if ctx.reads(op, "Mean") or ctx.reads(op, "Variance"):
        axes = tuple(range(begin, x.dim()))
        xf = x.float()
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
    ctx.set_output(op, "Out", torch.softmax(x.float(), dim=-1).to(x.dtype))


@register("softmax_with_cross_entropy")
def _softmax_with_cross_entropy(ctx, op):
    logits = ctx.get_input(op, "Logits")
    label = ctx.get_input(op, "Label")
    soft = op.attrs.get("soft_label", False)
    ignore = op.attrs.get("ignore_index", -100)
    logp = torch.log_softmax(logits.float(), dim=-1)
    if soft:
        loss = -torch.sum(label.float() * logp, dim=-1, keepdim=True)
    else:
        lab = label.reshape(label.shape[:-1]) if label.shape[-1] == 1 else label
        lab = lab[..., None]
        loss = -torch.gather(logp, -1, _wrapped_index(lab, logp.shape[-1]))
        loss = torch.where(_in_range(lab, logp.shape[-1]), loss, float("nan"))
        loss = torch.where(lab == ignore, 0.0, loss)
    if ctx.reads(op, "Softmax"):
        ctx.set_output(op, "Softmax", torch.exp(logp).to(logits.dtype))
    ctx.set_output(op, "Loss", loss.to(logits.dtype))


@register("lookup_table")
def _lookup_table(ctx, op):
    w = ctx.get_input(op, "W")  # [V, D]
    ids = ctx.get_input(op, "Ids")
    padding_idx = op.attrs.get("padding_idx", -1)
    flat = ids.reshape(ids.shape[:-1]) if (ids.dim() > 1 and ids.shape[-1] == 1) else ids
    out = F.embedding(_wrapped_index(flat, w.shape[0]), w)
    out = torch.where(_in_range(flat, w.shape[0])[..., None], out,
                      float("nan"))
    if padding_idx is not None and padding_idx >= 0:
        out = torch.where((flat == padding_idx)[..., None], 0.0, out)
    ctx.set_output(op, "Out", out)
