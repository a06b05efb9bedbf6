"""Quantization op rules: ``fake_quantize_abs_max`` (quantize-aware
training), ``quantized_mul`` and ``quantized_conv2d`` (int8 inference).

Translated from the JAX package's
``paddle_tpu/contrib/quantize/quantize_transpiler.py`` and
``int8_inference.py``, whose transpilers (``contrib.quantize`` here)
write these ops into a Program.

The int8 products are exact in integer arithmetic: each output is a sum
of at most K products of magnitude 127 * 127, an integer far below
2**31 and 2**53.  So every route below gives the same int32 bits:

- a CPU tensor takes the plain version: the int8 values as float64,
  their product (every partial sum an integer below 2**53, exact in any
  order) cast to int32;
- a CUDA tensor takes ``torch._int_mm``, cuBLASLt's int8 GEMM with int32
  accumulation, its operands padded with zeros to its shape limits (more
  than 16 rows, K and N multiples of 8; a zero changes no integer sum).
  Any other device raises.

The reference computed these products with XLA's ``dot_general`` and
``conv_general_dilated``, not in a Pallas kernel, so no hand-written
kernel stands behind them.  A convolution is one im2col GEMM a group:
the int8 input is copied once into a zero-padded NHWC tensor, and a
strided view of it (taps outer, channels inner, stride and dilation in
the view's strides) is copied once into the GEMM's row-major [M, K]
operand.  That costs kh * kw copies of the int8 input's bytes, as many
as the reference's decomposition into kh * kw shifted matmuls
(``_int8_conv_as_matmuls``) copies in its slices, but runs one GEMM with
one int32 output instead of kh * kw of them summed.  The filter becomes
a K-major [O, K] matrix (a copy of the int8 weight).

Every scale is computed and applied on the device, so a captured step
holds these rules.  A division by a constant is a product with the
constant's float32 reciprocal (:func:`_reciprocal`): XLA rewrites the
reference's ``w / 127`` into ``w * (1 / 127)``, and so the port computes
that product, on the CPU and on the card alike (PyTorch's CUDA division
by a Python number would multiply by a reciprocal taken in double).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..registry import register

__all__ = ["quantize_activation", "int8_matmul", "int8_conv2d",
           "fake_quantize_abs_max"]

QMAX = 127.0
#: zero rows appended to every CUDA GEMM's first operand: ``torch._int_mm``
#: takes more than 16 rows, and a fixed count keeps a symbolic batch
#: symbolic under ``torch.export``
PAD_ROWS = 16


def _round8(n):
    return -(-n // 8) * 8


def _reciprocal(c):
    """``1 / c`` rounded to float32, as a Python float (exact in double,
    so a float32 tensor multiplies by this very value)."""
    return float(np.float32(1) / np.float32(c))


def _plain(t):
    """Whether ``t`` takes the plain version: it lies on the CPU."""
    return t.device.type == "cpu"


def quantize_activation(x):
    """Dynamic per-tensor abs-max quantization of ``x`` (the JAX
    package's ``_quantize_activation``): (int8 values, the float32 scale
    as a 0-d device tensor)."""
    xf = x.float()
    sx = xf.abs().amax().clamp_min(1e-8)
    xq = torch.round(xf / sx * QMAX).clamp(-QMAX, QMAX).to(torch.int8)
    return xq, sx


def _rescale(acc, sx, ws, shape):
    """``acc * (sx / 127) * (ws / 127)`` in float32, the reference's
    order, ``ws`` (one scale an output channel) reshaped to ``shape``."""
    r = _reciprocal(QMAX)
    return acc.float() * (sx * r) * (ws.reshape(-1).float() * r).reshape(shape)


def _int_mm(a, b_t, rows, cols):
    """``a [rows + PAD_ROWS, K8] @ b_t [N8, K8].T`` on the card through
    ``torch._int_mm`` (``b_t`` K-major, so both operands are K-major as
    cuBLASLt's int8 GEMM wants them), cut to ``[rows, cols]``."""
    if not a.is_cuda:
        raise RuntimeError("int8 GEMM: a tensor on %s is neither on the CPU "
                           "nor on a CUDA device" % a.device)
    return torch._int_mm(a, b_t.t())[:rows, :cols]


def _weight_rows(w_t):
    """The K-major weight ``[N, K]`` padded with zeros to multiples of 8."""
    n, k = w_t.shape
    if (n, k) != (_round8(n), _round8(k)):
        w_t = F.pad(w_t, (0, _round8(k) - k, 0, _round8(n) - n))
    return w_t.contiguous()


def int8_matmul(a, b_t):
    """``a [M, K] @ b_t [N, K].T`` of int8 values as int32 ``[M, N]``,
    exact: on a CPU tensor the plain version (float64 product), on a CUDA
    tensor ``torch._int_mm`` on zero-padded operands."""
    m, k = a.shape
    n = b_t.shape[0]
    if _plain(a):
        return torch.mm(a.double(), b_t.double().t()).to(torch.int32)
    a = F.pad(a, (0, _round8(k) - k, 0, PAD_ROWS))
    return _int_mm(a, _weight_rows(b_t), m, n)


def _conv_rows(xq, kh, kw, strides, pads, dil, groups):
    """The int8 NCHW input as one im2col matrix a group, each a strided
    view ``[N, OH, OW, kh, kw, C/groups]`` of a zero-padded NHWC copy:
    (views, rows M = N * OH * OW, OH, OW)."""
    n, c, h, w = xq.shape
    (sh, sw), (ph, pw), (dh, dw) = strides, pads, dil
    xp = xq.new_zeros((n, h + 2 * ph, w + 2 * pw, c))
    xp[:, ph:ph + h, pw:pw + w].copy_(xq.permute(0, 2, 3, 1))
    oh = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    ow = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    s_n, s_h, s_w, s_c = xp.stride()
    cg = c // groups
    views = [xp.as_strided((n, oh, ow, kh, kw, cg),
                           (s_n, s_h * sh, s_w * sw, s_h * dh, s_w * dw, s_c),
                           xp.storage_offset() + g * cg)
             for g in range(groups)]
    return views, n * oh * ow, oh, ow


def int8_conv2d(xq, wq, strides, pads, dil, groups):
    """The integer convolution of int8 ``xq`` (NCHW) with int8 ``wq``
    (OIHW): int32 ``[N, O, OH, OW]``, exact, as im2col GEMMs (one a
    group) through :func:`int8_matmul`'s routes."""
    o, cg, kh, kw = wq.shape
    views, m, oh, ow = _conv_rows(xq, kh, kw, strides, pads, dil, groups)
    og, k = o // groups, kh * kw * cg
    accs = []
    for g, view in enumerate(views):
        w_t = wq[g * og:(g + 1) * og].permute(0, 2, 3, 1).reshape(og, k)
        if _plain(xq):
            accs.append(int8_matmul(view.reshape(m, k), w_t))
            continue
        # the GEMM's padded operand, written once from the strided view
        k8 = _round8(k)
        rows = xq.new_empty((m + PAD_ROWS, k8))
        rows[m:].zero_()
        if k8 != k:
            rows[:m, k:].zero_()
        rows[:m, :k].view(view.shape).copy_(view)
        accs.append(_int_mm(rows, _weight_rows(w_t), m, og))
    acc = accs[0] if groups == 1 else torch.cat(accs, dim=1)
    return acc.reshape(xq.shape[0], oh, ow, o).permute(0, 3, 1, 2)


def fake_quantize_abs_max(x, bits=8):
    """Quantize-dequantize ``x`` at its abs-max in the forward, the
    straight-through estimator in the backward: ``x + (qdq - x)`` with
    the difference detached, so the gradient is the upstream gradient
    (the JAX package's ``x + stop_gradient(qdq - x)``).  Returns (out,
    the scale as a 0-d device tensor)."""
    qmax = float(2 ** (bits - 1) - 1)
    xd = x.detach()
    scale = xd.abs().amax().clamp_min(1e-8)
    # the reference's ``q / qmax * scale``, as XLA computes it: the
    # division a product with the reciprocal, merged with ``scale`` first
    qdq = (torch.round(xd / scale * qmax).clamp(-qmax, qmax)
           * (_reciprocal(qmax) * scale))
    return x + (qdq - xd), scale


@register("fake_quantize_abs_max")
def _fake_quantize_abs_max(ctx, op):
    x = ctx.get_input(op, "X")
    out, scale = fake_quantize_abs_max(x, int(op.attrs.get("bit_length", 8)))
    ctx.set_output(op, "Out", out)
    if "OutScale" in op.outputs:
        ctx.set_output(op, "OutScale", scale.reshape(1))


def _finish(ctx, op, out, x, shape):
    """Add the op's ``Bias`` (one an output channel; the conv+BN fold's
    shift) in float32, then cast to bfloat16 where ``x`` is."""
    bias = ctx.get_input(op, "Bias")
    if bias is not None:
        out = out + bias.float().reshape(shape)
    return out.to(x.dtype) if x.dtype == torch.bfloat16 else out


@register("quantized_mul")
def _quantized_mul(ctx, op):
    x = ctx.get_input(op, "X")
    wq = ctx.get_input(op, "QWeight")   # int8 [K, N]
    ws = ctx.get_input(op, "WScale")    # float32 [N]
    xn = op.attrs.get("x_num_col_dims", 1)
    xs = tuple(x.shape)
    xq, sx = quantize_activation(x.reshape((math.prod(xs[:xn]), -1)))
    acc = int8_matmul(xq, wq.to(torch.int8).t())
    out = _finish(ctx, op, _rescale(acc, sx, ws, (1, -1)), x, (1, -1))
    ctx.set_output(op, "Out", out.reshape(xs[:xn] + (wq.shape[1],)))


@register("quantized_conv2d")
def _quantized_conv2d(ctx, op):
    x = ctx.get_input(op, "Input")      # NCHW
    wq = ctx.get_input(op, "QWeight")   # int8 OIHW
    ws = ctx.get_input(op, "WScale")    # float32 [O]
    xq, sx = quantize_activation(x)
    acc = int8_conv2d(xq, wq.to(torch.int8),
                      tuple(op.attrs.get("strides", [1, 1])),
                      tuple(op.attrs.get("paddings", [0, 0])),
                      tuple(op.attrs.get("dilations", [1, 1])),
                      op.attrs.get("groups", 1) or 1)
    shape = (1, -1, 1, 1)
    ctx.set_output(op, "Output",
                   _finish(ctx, op, _rescale(acc, sx, ws, shape), x, shape))
