"""Structured-prediction op rules: CTC, edit distance, the linear-chain
CRF, chunk evaluation, NCE and the hierarchical sigmoid.

Translated from the JAX package's ``paddle_tpu/ops/struct_ops.py``,
every rule of it, over the padded-plus-lengths layout: each rule is a
masked dense computation with static shapes.  The recursions the JAX
package runs as a ``lax.scan`` (CTC's forward variables, the CRF's
forward algorithm and Viterbi pass, the edit distance's rows) are a
Python loop over the time axis here, each step a few torch ops with the
carry gated by ``t < length``; autograd differentiates the loop, as JAX
differentiates the scan.  No Pallas kernel ever computed these ops, so
no hand-written kernel stands behind them.

No rule reads a value back to the host or copies host data to the card
(constants are made on the device by fills), so a dense-fed Program
holding these ops binds into one CUDA graph.  Gathers of parameter rows
go through ``F.embedding``, whose CUDA backward sorts the ids rather
than adding with atomics: a bound step then gives the bits of the same
step run op by op.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..registry import register
from .common import at_least_f32, device_values
from .sequence_ops import _lengths_for, _mask


def _ids(x):
    """An id tensor ``[B, T]`` (a ``[B, T, 1]`` one squeezed) as int64."""
    if x.dim() == 3:
        x = x[..., 0]
    return x.long()


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (no threshold, unlike
    ``F.softplus``), with its gradient ``sigmoid(x)`` everywhere."""
    return torch.logaddexp(x, torch.zeros_like(x))


# ---------------------------------------------------------------------------
# CTC
# ---------------------------------------------------------------------------


def _ctc_loss(logits, logit_lens, labels, label_lens, blank,
              log_epsilon=-1e5):
    """Per-row CTC negative log-likelihood ``[B]``: optax's
    ``ctc_loss_with_forward_probs`` recursion (optax 0.2.6), which the
    JAX package calls.  ``log_epsilon`` stands for log 0, so a label that
    cannot fit its frames costs about ``-log_epsilon`` rather than
    infinity; a padded frame carries both forward variables unchanged."""
    B, T, K = logits.shape
    U = labels.shape[1]
    dtype = logits.dtype
    logprobs = torch.log_softmax(logits, dim=-1)
    # repeat[b, n]: label n equals label n + 1, over the padded labels,
    # with a 0 column after the last
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(dtype), (0, 1))
    # one_hot(labels) @ logprobs: an id outside [0, K) emits log-prob 0
    inside = (labels >= 0) & (labels < K)
    emit_lp = torch.gather(logprobs, 2, labels.clamp(0, K - 1)[:, None, :]
                           .expand(B, T, U))
    emit_lp = torch.where(inside[:, None, :], emit_lp, 0.0)
    phi_lp = logprobs[:, :, blank:blank + 1]  # [B, T, 1]
    pad = (~_mask(logit_lens, T, torch.bool)).to(dtype)  # [B, T]

    def update_phi(phi, added):
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], added)], 1)

    phi = torch.cat([logits.new_zeros((B, 1)),
                     logits.new_full((B, U), log_epsilon)], 1)
    emit = logits.new_full((B, U), log_epsilon)
    for t in range(T):
        prev_phi = update_phi(phi, emit + log_epsilon * repeat)
        le, lphi = emit_lp[:, t], phi_lp[:, t]
        next_emit = torch.logaddexp(prev_phi[:, :-1] + le, emit + le)
        next_phi = update_phi(prev_phi + lphi,
                              emit + lphi + log_epsilon * (1.0 - repeat))
        p = pad[:, t:t + 1]
        emit = p * emit + (1.0 - p) * next_emit
        phi = p * phi + (1.0 - p) * next_phi
    phi_last = update_phi(phi, emit)
    return -torch.gather(phi_last, 1, label_lens.long()[:, None])[:, 0]


@register("warpctc")
def _warpctc(ctx, op):
    """CTC loss (reference operators/warpctc_op.h, which wraps warp-ctc).

    Logits ``[B, T, C]`` padded + lengths; Label ``[B, U]`` (or Fluid's
    ``[B, U, 1]`` rows, squeezed: ROADMAP R-7) padded + lengths.  Out
    Loss ``[B, 1]``, divided by each row's frame count (at least 1) under
    ``norm_by_times``."""
    logits = at_least_f32(ctx.get_input(op, "Logits"))
    labels = _ids(ctx.get_input(op, "Label"))
    logit_lens = _lengths_for(ctx, op, "Logits")
    label_lens = _lengths_for(ctx, op, "Label")
    loss = _ctc_loss(logits, logit_lens, labels, label_lens,
                     int(op.attrs.get("blank", 0)))
    if op.attrs.get("norm_by_times", False):
        loss = loss / torch.clamp(logit_lens.to(loss.dtype), min=1.0)
    ctx.set_output(op, "Loss", loss[:, None])


@register("ctc_align")
def _ctc_align(ctx, op):
    """CTC greedy-decode alignment (reference operators/ctc_align_op.h):
    merge repeated ids, drop blanks.  The kept ids are written at their
    cumsum positions into a ``[B, T + 1]`` buffer whose last column
    takes the dropped ones, then cut to ``[B, T]`` (zeros past each
    row's new length, a device tensor)."""
    x = ctx.get_input(op, "Input")  # [B, T] ids
    lens = _lengths_for(ctx, op, "Input")
    blank = int(op.attrs.get("blank", 0))
    B, T = x.shape
    keep = _mask(lens, T, torch.bool) & (x != blank)
    if op.attrs.get("merge_repeated", True):
        prev = torch.cat([torch.full_like(x[:, :1], -1), x[:, :-1]], 1)
        keep = keep & (x != prev)
    pos = torch.cumsum(keep.long(), 1) - 1
    pos = torch.where(keep, pos, T)
    out = x.new_zeros((B, T + 1)).scatter_(1, pos, x)[:, :T]
    ctx.set_output(op, "Output", out)
    ctx.set_lengths(op.outputs["Output"][0],
                    keep.sum(1).to(torch.int32))


@register("edit_distance")
def _edit_distance(ctx, op):
    """Levenshtein distance (reference operators/edit_distance_op.h).

    One row of the table a hypothesis token; the row's left-to-right
    dependency (insertions) is a min-plus prefix, ``j + cummin(cand -
    j)``, vectorized along the reference.  Out ``[B, 1]`` float32 (over
    the reference's length, at least 1, when ``normalized``);
    SequenceNum the batch size, an int32 scalar."""
    hyp = _ids(ctx.get_input(op, "Hyps"))
    ref = _ids(ctx.get_input(op, "Refs"))
    hyp_lens = _lengths_for(ctx, op, "Hyps")
    ref_lens = _lengths_for(ctx, op, "Refs")
    B, Th = hyp.shape
    Tr = ref.shape[1]
    jr = torch.arange(Tr + 1, dtype=torch.float32, device=hyp.device)[None]
    row = jr.expand(B, Tr + 1)
    for i in range(Th):
        sub = (ref != hyp[:, i:i + 1]).float()
        cand = torch.minimum(row[:, 1:] + 1.0, row[:, :-1] + sub)
        cand = torch.cat([torch.full_like(row[:, :1], 1.0 + i), cand], 1)
        new_row = jr + torch.cummin(cand - jr, 1).values
        new_row = torch.minimum(cand, new_row)
        row = torch.where((i < hyp_lens)[:, None], new_row, row)
    dist = torch.gather(row, 1, ref_lens.long()[:, None])[:, 0]
    if op.attrs.get("normalized", True):
        dist = dist / torch.clamp(ref_lens.float(), min=1.0)
    ctx.set_output(op, "Out", dist[:, None])
    ctx.set_output(op, "SequenceNum",
                   torch.full((), B, dtype=torch.int32, device=hyp.device))


# ---------------------------------------------------------------------------
# Linear-chain CRF
# ---------------------------------------------------------------------------


def _crf_inputs(ctx, op):
    """Emission ``[B, T, K]`` (float32 or wider), its lengths, and the
    transition's rows (reference linear_chain_crf_op.h): 0 = start
    weights, 1 = end weights, 2.. = tag -> tag."""
    x = at_least_f32(ctx.get_input(op, "Emission"))
    w = ctx.get_input(op, "Transition").to(x.dtype)
    return x, _lengths_for(ctx, op, "Emission"), w[0], w[1], w[2:]


@register("linear_chain_crf")
def _linear_chain_crf(ctx, op):
    """The forward algorithm in log space (the reference's
    ForwardOneSequence works in normalized exp space).  LogLikelihood
    ``[B, 1]`` = logZ - score(label path), the NLL (the reference's
    ``return -ll``), 0 for a row of length 0.  Alpha ``[B, T, K]`` holds
    the log-space forward variables, each row's carried unchanged past
    its length (the JAX package's layout, not Fluid's normalized one)."""
    x, lens, ws, we, A = _crf_inputs(ctx, op)
    y = _ids(ctx.get_input(op, "Label"))
    B, T, K = x.shape
    alpha = ws[None, :] + x[:, 0]
    alphas = [alpha]
    for t in range(1, T):
        nxt = torch.logsumexp(alpha[:, :, None] + A[None], dim=1) + x[:, t]
        alpha = torch.where((t < lens)[:, None], nxt, alpha)
        alphas.append(alpha)
    log_z = torch.logsumexp(alpha + we[None, :], dim=1)

    m = _mask(lens, T, x.dtype)
    emit = torch.gather(x, 2, y[:, :, None])[:, :, 0]
    score = (emit * m).sum(1)
    score = score + (A[y[:, :-1], y[:, 1:]] * m[:, 1:]).sum(1)
    last = torch.clamp(lens.long() - 1, min=0)
    y_last = torch.gather(y, 1, last[:, None])[:, 0]
    score = score + ws[y[:, 0]] + we[y_last]
    nll = torch.where(lens > 0, log_z - score, 0.0)
    ctx.set_output(op, "LogLikelihood", nll[:, None])
    if op.outputs.get("Alpha"):
        ctx.set_output(op, "Alpha", torch.stack(alphas, 1))


@register("crf_decoding")
def _crf_decoding(ctx, op):
    """Viterbi decoding (reference crf_decoding_op.h): a max-sum pass
    keeping each step's argmax (the first index on ties, as
    ``jnp.argmax``), then the backtrace from each row's last step.
    ViterbiPath ``[B, T]`` int64, zeros past each row's length, which it
    keeps; with a Label, a 0/1 match of the path against it, as the
    reference gives."""
    x, lens, ws, we, A = _crf_inputs(ctx, op)
    B, T, K = x.shape
    v = ws[None, :] + x[:, 0]
    bps = []  # bps[t]: the best previous tag for each tag at step t + 1
    for t in range(1, T):
        scores = v[:, :, None] + A[None]  # [B, K_prev, K]
        bps.append(torch.argmax(scores, dim=1))
        nv = torch.amax(scores, dim=1) + x[:, t]
        v = torch.where((t < lens)[:, None], nv, v)
    final = torch.argmax(v + we[None, :], dim=1)

    last = lens.long() - 1
    cur, path = final, [None] * T
    for t in range(T - 1, -1, -1):
        stepped = (torch.gather(bps[t], 1, cur[:, None])[:, 0]
                   if t < T - 1 else cur)
        cur = torch.where(t == last, final, torch.where(t < last, stepped, cur))
        path[t] = cur
    path = torch.where(_mask(lens, T, torch.bool), torch.stack(path, 1), 0)
    if op.inputs.get("Label"):
        path = (path == _ids(ctx.get_input(op, "Label"))).long()
    ctx.set_output(op, "ViterbiPath", path)
    ctx.set_lengths(op.outputs["ViterbiPath"][0], lens)


# ---------------------------------------------------------------------------
# chunk_eval
# ---------------------------------------------------------------------------

_CHUNK_SCHEMES = {
    # scheme: (num_tag_types, tag_begin, tag_inside, tag_end, tag_single)
    "IOB": (2, 0, 1, -1, -1),
    "IOE": (2, -1, 0, 1, -1),
    "IOBES": (4, 0, 1, 2, 3),
    "plain": (1, -1, -1, -1, -1),
}


def _chunk_marks(tag, typ, valid, other, tb, ti, te, tsg):
    """Vectorized ChunkBegin/ChunkEnd (reference chunk_eval_op.h:83,95).

    begin[i]: a chunk starts at i.  end[i]: a chunk ends at i (the
    reference's ChunkEnd(prev=i, cur=i+1), plus the trailing in-chunk
    case).  ``typ`` is ``other`` past each row's length."""
    neg = torch.full_like(tag[:, :1], -1)
    oth = torch.full_like(typ[:, :1], other)
    ptag = torch.cat([neg, tag[:, :-1]], 1)
    ptyp = torch.cat([oth, typ[:, :-1]], 1)

    def chunk_begin(pt, pty, t, ty):
        same = ((t == tb) | ((t == ti) & ((pt == te) | (pt == tsg)))
                | ((t == te) & ((pt == te) | (pt == tsg))) | (t == tsg))
        return torch.where(pty == other, ty != other,
                           (ty != other) & ((ty != pty) | same))

    def chunk_end(pt, pty, t, ty):
        inner = torch.where((pt == tb) | (pt == ti), (t == tb) | (t == tsg),
                            (pt == te) | (pt == tsg))
        return (pty != other) & ((ty == other) | (ty != pty) | inner)

    begin = chunk_begin(ptag, ptyp, tag, typ) & valid
    ntag = torch.cat([tag[:, 1:], neg], 1)
    ntyp = torch.cat([typ[:, 1:], oth], 1)
    end = chunk_end(tag, typ, ntag, ntyp) & valid & (typ != other)
    return begin, end


@register("chunk_eval")
def _chunk_eval(ctx, op):
    """Chunk-level precision, recall and F1 for sequence labeling
    (reference chunk_eval_op.h).  A chunk is matched iff both sequences
    start one at the same position with the same type and the first
    chunk end at or after it (a reversed ``cummin`` over the end marks)
    is the same.  P/R/F1 float32 scalars, the counts int32 scalars."""
    inf = _ids(ctx.get_input(op, "Inference"))
    lab = _ids(ctx.get_input(op, "Label"))
    lens = _lengths_for(ctx, op, "Label")
    scheme = op.attrs.get("chunk_scheme", "IOB")
    excluded = list(op.attrs.get("excluded_chunk_types", []) or [])
    ntt, tb, ti, te, tsg = _CHUNK_SCHEMES[scheme]
    other = int(op.attrs["num_chunk_types"])
    B, T = lab.shape
    valid = _mask(lens, T, torch.bool)
    t_idx = torch.arange(T, device=lab.device)[None, :]

    def marks(seq):
        if scheme == "plain":
            tag, typ = torch.zeros_like(seq), torch.where(valid, seq, other)
        else:
            tag, typ = seq % ntt, torch.where(valid, seq // ntt, other)
        begin, end = _chunk_marks(tag, typ, valid, other, tb, ti, te, tsg)
        # the first position j >= i with a chunk end; T if none
        first_end = torch.cummin(torch.where(end, t_idx, T).flip(1),
                                 1).values.flip(1)
        kept = torch.ones_like(valid)
        for e in excluded:
            kept = kept & (typ != e)
        return typ, begin & kept, first_end

    typ_i, beg_i, fe_i = marks(inf)
    typ_l, beg_l, fe_l = marks(lab)
    n_inf = beg_i.sum().to(torch.int32)
    n_lab = beg_l.sum().to(torch.int32)
    n_cor = (beg_i & beg_l & (typ_i == typ_l) & (fe_i == fe_l)).sum() \
        .to(torch.int32)
    p = n_cor / torch.clamp(n_inf, min=1)
    r = n_cor / torch.clamp(n_lab, min=1)
    f1 = torch.where(n_cor > 0, 2 * p * r / torch.clamp(p + r, min=1e-12),
                     0.0)
    ctx.set_output(op, "Precision", torch.where(n_inf > 0, p, 0.0).float())
    ctx.set_output(op, "Recall", torch.where(n_lab > 0, r, 0.0).float())
    ctx.set_output(op, "F1-Score", f1.float())
    ctx.set_output(op, "NumInferChunks", n_inf)
    ctx.set_output(op, "NumLabelChunks", n_lab)
    ctx.set_output(op, "NumCorrectChunks", n_cor)


# ---------------------------------------------------------------------------
# NCE / hierarchical sigmoid
# ---------------------------------------------------------------------------


@register("nce")
def _nce(ctx, op):
    """Noise-contrastive estimation (reference nce_op.h).  The negatives
    are uniform over ``[0, num_total_classes)`` from the op's generator
    (``ctx.op_generator``, so a captured step's replay draws an eager
    step's bits), or the ``custom_neg_classes`` constant.  With
    o = sigmoid(z) and b = num_neg / num_total_classes, cost_true =
    -log(o / (o + b)) and cost_neg = -log(b / (o + b)), written in logit
    space (softplus forms) for saturated z.  SampleLogits holds o,
    SampleLabels the label then the negatives."""
    x = at_least_f32(ctx.get_input(op, "Input"))  # [B, D]
    weight = ctx.get_input(op, "Weight").to(x.dtype)  # [C, D]
    label = ctx.get_input(op, "Label").long()  # [B, num_true]
    bias = ctx.get_input(op, "Bias")
    if label.dim() == 1:
        label = label[:, None]
    B, num_true = label.shape
    num_neg = int(op.attrs.get("num_neg_samples", 10))
    num_classes = int(op.attrs["num_total_classes"])
    custom = list(op.attrs.get("custom_neg_classes", []) or [])
    if custom:
        neg = device_values(custom, torch.int64, x.device)[None].expand(B, -1)
    else:
        gen = ctx.op_generator(op, op.attrs.get("seed", 0))
        neg = torch.randint(0, num_classes, (B, num_neg), generator=gen,
                            device=x.device)
    samples = torch.cat([label, neg], 1)  # [B, S]
    z = torch.einsum("bd,bsd->bs", x, F.embedding(samples, weight))
    if bias is not None:
        z = z + F.embedding(samples, bias.reshape(-1, 1).to(x.dtype))[..., 0]
    b = float(num_neg) / float(num_classes)
    u = torch.logaddexp(torch.full_like(z, math.log1p(b)), math.log(b) - z)
    cost_true = u[:, :num_true]
    cost_neg = (u - _softplus(-z) - math.log(b))[:, num_true:]
    cost = cost_true.sum(1) + cost_neg.sum(1)
    sw = ctx.get_input(op, "SampleWeight")
    if sw is not None:
        cost = cost * sw.reshape(-1).to(cost.dtype)
    ctx.set_output(op, "Cost", cost[:, None])
    ctx.set_output(op, "SampleLogits", torch.sigmoid(z))
    ctx.set_output(op, "SampleLabels", samples)


@register("hierarchical_sigmoid")
def _hierarchical_sigmoid(ctx, op):
    """Hierarchical sigmoid over the implicit complete binary tree
    (reference hierarchical_sigmoid_op.h + math/matrix_bit_code.h).

    For label l, code c = l + num_classes; bit k uses internal node
    (c >> (k+1)) - 1 with target bit (c >> k) & 1, for the k whose node
    exists.  Cost = sum_k softplus(pre_k) - bit_k * pre_k, pre clipped
    to [-40, 40] as the reference does.  The slots past a label's path
    are masked out exactly, as the JAX package does (the reference
    leaves log 2 in each, hierarchical_sigmoid_op.h:76; the gradients
    are the same)."""
    x = at_least_f32(ctx.get_input(op, "X"))  # [B, D]
    w = ctx.get_input(op, "W").to(x.dtype)  # [C - 1, D]
    label = ctx.get_input(op, "Label").long().reshape(-1)  # [B]
    bias = ctx.get_input(op, "Bias")
    num_classes = int(op.attrs["num_classes"])
    max_len = max(int(math.ceil(math.log2(max(num_classes, 2)))), 1)
    c = (label + num_classes)[:, None]
    ks = torch.arange(max_len, device=x.device)[None, :]
    up = torch.bitwise_right_shift(c, ks + 1)  # [B, L]
    bit = torch.bitwise_and(torch.bitwise_right_shift(c, ks), 1).to(x.dtype)
    valid = (up > 0).to(x.dtype)
    node = torch.clamp(up - 1, 0, num_classes - 2)
    pre = torch.einsum("bd,bld->bl", x, F.embedding(node, w))
    if bias is not None:
        pre = pre + F.embedding(node, bias.reshape(-1, 1).to(x.dtype))[..., 0]
    pre = torch.clamp(pre, -40.0, 40.0)
    cost = (_softplus(pre) - bit * pre) * valid
    ctx.set_output(op, "Out", cost.sum(1)[:, None])
    ctx.set_output(op, "PreOut", pre * valid)
