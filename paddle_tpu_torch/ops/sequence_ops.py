"""Sequence and recurrence op rules over the padded-plus-lengths layout.

Translated from the JAX package's ``paddle_tpu/ops/sequence_ops.py``,
every rule of it.  A ragged batch is a dense padded ``[batch, max_len,
...]`` tensor with an int32 ``<name>@LENGTHS`` companion, and every rule
is a masked dense computation on the device with static shapes: no rule
reads a length back to the host, except ``sequence_mask`` without a
``maxlen`` (its output's width is the longest length), which is marked
``reads_host`` for that use only.  Scatters that the JAX package writes
with ``.at[].set(mode="drop")`` write one extra column or row, the
dropped entries' target, and cut it off.

The recurrences (``lstm``, ``lstmp``, ``gru``), which the JAX package
runs as a ``lax.scan`` that XLA fused, are a Python loop over the time
axis (``_scan_rnn``): each step computes the cell on cuBLAS and torch
ops and gates the carry by ``t < length``, so a row's state stays as it
was past its length and its outputs there are zeros.  Autograd
differentiates the loop.  No Pallas kernel ever computed these ops, so
no hand-written kernel stands behind them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import torch_dtype
from ..registry import register
from .common import at_least_f32, device_values


def _mask(lengths, maxlen, dtype=torch.float32):
    """[B] lengths -> [B, maxlen] mask (1 at valid steps)."""
    t = torch.arange(maxlen, dtype=torch.int32, device=lengths.device)[None, :]
    return (t < lengths.to(torch.int32)[:, None]).to(dtype)


def _lengths_for(ctx, op, slot="X"):
    """The lengths of ``op``'s ``slot`` input; a tensor without them is a
    batch of full-length sequences."""
    name = op.inputs[slot][0]
    lens = ctx.get_lengths(name)
    if lens is None:
        x = ctx.get(name)
        lens = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                          device=x.device)
    return lens


def _trail(x, lead=2):
    """``(1,) * (x.dim() - lead)``: the broadcast tail of a [B, T] mask."""
    return (1,) * (x.dim() - lead)


def _along_time(x, idx):
    """``jnp.take_along_axis(x, idx[B, T'] broadcast, axis=1)``."""
    idx = idx.long().reshape(tuple(idx.shape) + _trail(x))
    return torch.gather(x, 1, idx.expand(tuple(idx.shape[:2]) + tuple(x.shape[2:])))


def _reverse_seq(x, lengths):
    """Reverse each sequence within its valid region (padding stays put)."""
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    L = lengths.long()[:, None]
    return _along_time(x, torch.where(t < L, L - 1 - t, t))


def _act(name):
    return {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu,
            "identity": lambda v: v, "linear": lambda v: v}[name]


# ---------------------------------------------------------------------------
# pooling / softmax / conv over time
# ---------------------------------------------------------------------------


@register("sequence_pool")
def _sequence_pool(ctx, op):
    """Pool each sequence's valid steps.  ``MAX`` and ``MIN`` share a
    tied gradient equally, as ``jnp.max`` does (``amax``); ``MaxIndex``
    is the first maximum's step."""
    x = ctx.get_input(op, "X")  # [B, T, ...]
    lens = _lengths_for(ctx, op)
    pooltype = op.attrs.get("pooltype", "AVERAGE").upper()
    B, T = x.shape[0], x.shape[1]
    m = _mask(lens, T, x.dtype).reshape((B, T) + _trail(x))
    denom = torch.clamp(lens.to(x.dtype), min=1).reshape((B,) + _trail(x))
    if pooltype == "AVERAGE":
        out = (x * m).sum(1) / denom
    elif pooltype == "SUM":
        out = (x * m).sum(1)
    elif pooltype == "SQRT":
        out = (x * m).sum(1) / torch.sqrt(denom)
    elif pooltype in ("MAX", "MIN"):
        info = torch.finfo if x.is_floating_point() else torch.iinfo
        fill = info(x.dtype).min if pooltype == "MAX" else info(x.dtype).max
        v = torch.where(m > 0, x, fill)
        if pooltype == "MAX":
            out = v.amax(1)
            if ctx.reads(op, "MaxIndex"):
                ctx.set_output(op, "MaxIndex", v.argmax(1).to(torch.int32))
        else:
            out = v.amin(1)
    elif pooltype == "LAST":
        idx = torch.clamp(lens.long() - 1, min=0)[:, None]
        out = _along_time(x, idx)[:, 0]
    elif pooltype == "FIRST":
        out = x[:, 0]
    else:
        raise NotImplementedError("sequence_pool type %r" % pooltype)
    ctx.set_output(op, "Out", out)


@register("sequence_softmax")
def _sequence_softmax(ctx, op):
    x = ctx.get_input(op, "X")  # [B, T] or [B, T, 1]
    lens = _lengths_for(ctx, op)
    squeeze = x.dim() == 3 and x.shape[-1] == 1
    v = x[..., 0] if squeeze else x
    m = _mask(lens, v.shape[1], torch.bool)
    v = torch.where(m, at_least_f32(v), -1e30)
    out = torch.where(m, torch.softmax(v, dim=1), 0.0).to(x.dtype)
    if squeeze:
        out = out[..., None]
    ctx.set_output(op, "Out", out)
    ctx.copy_lengths(op.inputs["X"][0], op.outputs["Out"][0])


def _shift_time(x, off):
    """``x`` moved ``off`` steps along time (``out[t] = x[t + off]``),
    zeros where that falls outside [0, T)."""
    T = x.shape[1]
    if off < 0:
        return F.pad(x, (0, 0, -off, 0))[:, :T]
    if off > 0:
        return F.pad(x, (0, 0, 0, off))[:, off:]
    return x


@register("sequence_conv")
def _sequence_conv(ctx, op):
    """Context-window conv over time: Filter [contextLength * D, F];
    window row k sees x[t + contextStart + k] (zero outside the
    sequence)."""
    x = ctx.get_input(op, "X")  # [B, T, D]
    w = ctx.get_input(op, "Filter")
    lens = _lengths_for(ctx, op)
    if int(op.attrs.get("contextStride", 1)) != 1:
        # the reference's restriction (sequence_conv_op.cc PADDLE_ENFORCE)
        raise NotImplementedError("sequence_conv: contextStride must be 1")
    clen = int(op.attrs.get("contextLength", op.attrs.get("context_length", 3)))
    cstart = op.attrs.get("contextStart", op.attrs.get("context_start"))
    cstart = int(-(clen - 1) // 2 if cstart is None else cstart)
    B, T, D = x.shape
    m = _mask(lens, T, x.dtype)[:, :, None]
    xm = x * m
    im = torch.cat([_shift_time(xm, cstart + k) for k in range(clen)], dim=-1)
    out = (im.reshape(B * T, clen * D) @ w).reshape(B, T, -1) * m
    ctx.set_output(op, "Out", out.to(x.dtype))
    ctx.copy_lengths(op.inputs["X"][0], op.outputs["Out"][0])


@register("row_conv")
def _row_conv(ctx, op):
    """Lookahead conv (reference row_conv_op.cc): out[t] = sum_k
    x[t + k] * W[k]."""
    x = ctx.get_input(op, "X")  # [B, T, D]
    w = ctx.get_input(op, "Filter")  # [future_context + 1, D]
    lens = _lengths_for(ctx, op)
    m = _mask(lens, x.shape[1], x.dtype)[:, :, None]
    xm = x * m
    out = torch.zeros_like(xm)
    for k in range(w.shape[0]):
        out = out + _shift_time(xm, k) * w[k][None, None, :]
    ctx.set_output(op, "Out", (out * m).to(x.dtype))
    ctx.copy_lengths(op.inputs["X"][0], op.outputs["Out"][0])


# ---------------------------------------------------------------------------
# shape / structure ops
# ---------------------------------------------------------------------------


@register("sequence_expand")
def _sequence_expand(ctx, op):
    """Expand x by y's sequence structure (reference sequence_expand_op).

    x one step a row -> broadcast over y's time axis; x already [B, T,
    ...] -> re-masked to y's lengths.  ``ref_level=0`` against a nested
    y: x's row i is repeated ``y@SUBLENGTHS[i]`` times, a row gather of
    static shape (``repeat_interleave`` with ``output_size``, as
    ``jnp.repeat`` with ``total_repeat_length``)."""
    x = ctx.get_input(op, "X")
    yname = op.inputs["Y"][0]
    y = ctx.get(yname)
    ylens = ctx.get_lengths(yname)
    ysub = ctx.get_sub_lengths(yname)
    out_name = op.outputs["Out"][0]

    if int(op.attrs.get("ref_level", -1)) == 0 and ysub is not None:
        counts = ysub.reshape(-1).to(torch.int32)
        n_rows = y.shape[0]
        gidx = torch.repeat_interleave(
            torch.arange(counts.shape[0], device=x.device), counts.long(),
            output_size=n_rows)
        ctx.set_output(op, "Out", x.index_select(0, gidx))
        xlens = ctx.get_lengths(op.inputs["X"][0])
        if xlens is not None:
            ctx.set_lengths(out_name, xlens.reshape(-1).index_select(0, gidx))
        elif x.dim() >= 3:
            # [rows, T, ...] without lengths: every row is full length (a
            # 2-D x is per-row features, whose dim 1 is no length)
            ctx.set_lengths(out_name, torch.full(
                (n_rows,), x.shape[1], dtype=torch.int32, device=x.device))
        ctx.set_sub_lengths(out_name, counts)
        return

    if ylens is None:
        ylens = torch.full((y.shape[0],), y.shape[1], dtype=torch.int32,
                           device=y.device)
    T = y.shape[1]
    if x.dim() == 2:  # [B, D] -> [B, T, D]
        out = x[:, None].expand((x.shape[0], T) + tuple(x.shape[1:]))
    elif x.shape[1] == 1:
        out = x.expand((x.shape[0], T) + tuple(x.shape[2:]))
    elif x.shape[1] >= T:
        out = x[:, :T]
    else:
        out = F.pad(x, (0, 0) * (x.dim() - 2) + (0, T - x.shape[1]))
    m = _mask(ylens, T, out.dtype).reshape((out.shape[0], T) + _trail(out))
    ctx.set_output(op, "Out", out * m)
    ctx.set_lengths(out_name, ylens)


@register("sequence_expand_as")
def _sequence_expand_as(ctx, op):
    _sequence_expand(ctx, op)


def _scatter_time(out, pos, x):
    """``out.at[b, pos[b, t]].set(x[b, t], mode="drop")`` for ``pos`` in
    [0, out.shape[1]]: ``out`` gets one more column, the target of the
    dropped entries, which is cut off again."""
    n = out.shape[1]
    wide = torch.cat([out, out.new_zeros((out.shape[0], 1) + tuple(out.shape[2:]))], 1)
    idx = pos.long().reshape(tuple(pos.shape) + _trail(x)).expand(x.shape)
    return wide.scatter(1, idx, x.to(out.dtype))[:, :n]


@register("sequence_concat")
def _sequence_concat(ctx, op):
    """Concat along time a row, compacting the valid prefixes:
    out[b] = x1[b, :L1] ++ x2[b, :L2] ++ ..., then zero padding."""
    names = op.inputs["X"]
    xs = [ctx.get(n) for n in names]
    B = xs[0].shape[0]
    Ttot = sum(int(x.shape[1]) for x in xs)
    dev = xs[0].device
    out = torch.zeros((B, Ttot) + tuple(xs[0].shape[2:]), dtype=xs[0].dtype,
                      device=dev)
    offs = torch.zeros((B,), dtype=torch.int32, device=dev)
    for n, x in zip(names, xs):
        ln = ctx.get_lengths(n)
        if ln is None:
            ln = torch.full((B,), x.shape[1], dtype=torch.int32, device=dev)
        t = torch.arange(x.shape[1], dtype=torch.int32, device=dev)[None, :]
        pos = torch.where(t < ln[:, None], offs[:, None] + t, Ttot)
        out = _scatter_time(out, pos, x)
        offs = offs + ln.to(torch.int32)
    ctx.set_output(op, "Out", out)
    ctx.set_lengths(op.outputs["Out"][0], offs)


@register("sequence_reshape")
def _sequence_reshape(ctx, op):
    """[B, T, D] -> [B, T * D / new_dim, new_dim]; a row's valid data is
    a contiguous prefix, so a per-row reshape keeps the packing."""
    x = ctx.get_input(op, "X")
    lens = _lengths_for(ctx, op)
    new_dim = int(op.attrs["new_dim"])
    B, T = x.shape[0], x.shape[1]
    D = 1
    for d in x.shape[2:]:
        D *= int(d)
    if (T * D) % new_dim:
        raise ValueError("sequence_reshape: T*D=%d not divisible by new_dim=%d"
                         % (T * D, new_dim))
    ctx.set_output(op, "Out", x.reshape(B, (T * D) // new_dim, new_dim))
    ctx.set_lengths(op.outputs["Out"][0], (lens * D) // new_dim)


@register("sequence_enumerate")
def _sequence_enumerate(ctx, op):
    x = ctx.get_input(op, "X")  # [B, T] ids (or [B, T, 1])
    lens = _lengths_for(ctx, op)
    win = int(op.attrs["win_size"])
    pad = op.attrs.get("pad_value", 0)
    v = x[..., 0] if x.dim() == 3 and x.shape[-1] == 1 else x
    T = v.shape[1]
    ar = torch.arange(T, dtype=torch.int32, device=x.device)
    pos = ar[:, None] + torch.arange(win, dtype=torch.int32, device=x.device)[None, :]
    gathered = v[:, torch.clamp(pos, max=T - 1).long()]  # [B, T, win]
    valid = pos[None] < lens.to(torch.int32)[:, None, None]
    ctx.set_output(op, "Out", torch.where(valid, gathered, pad))
    ctx.copy_lengths(op.inputs["X"][0], op.outputs["Out"][0])


@register("sequence_scatter")
def _sequence_scatter(ctx, op):
    """out = x; out[b, ids[b, j]] += updates[b, j] for j < len(ids[b]).
    An id in [-N, 0) wraps and one outside [-N, N) is dropped, as the
    JAX package's ``.at[].add(mode="drop")`` takes them."""
    x = ctx.get_input(op, "X")  # [B, N] (or [B, N, D])
    ids_name = op.inputs["Ids"][0]
    ids = ctx.get(ids_name)
    upd = ctx.get_input(op, "Updates")
    ilens = ctx.get_lengths(ids_name)
    if ids.dim() == 3 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    B, T = ids.shape
    N = x.shape[1]
    if ilens is None:
        ilens = torch.full((B,), T, dtype=torch.int32, device=x.device)
    valid = torch.arange(T, dtype=torch.int32, device=x.device)[None, :] < ilens[:, None]
    idx = ids.long()
    idx = torch.where(idx < 0, idx + N, idx)
    safe = torch.where(valid & (idx >= 0) & (idx < N), idx, N)
    vals = torch.where(valid.reshape(tuple(valid.shape) + _trail(upd)), upd, 0)
    wide = torch.cat([x, x.new_zeros((B, 1) + tuple(x.shape[2:]))], 1)
    index = safe.reshape(tuple(safe.shape) + _trail(upd)).expand(vals.shape)
    ctx.set_output(op, "Out", wide.scatter_add(1, index, vals.to(x.dtype))[:, :N])


@register("sequence_slice")
def _sequence_slice(ctx, op):
    x = ctx.get_input(op, "X")  # [B, T, ...]
    off = ctx.get_input(op, "Offset").reshape(-1).to(torch.int32)
    length = ctx.get_input(op, "Length").reshape(-1).to(torch.int32)
    B, T = x.shape[0], x.shape[1]
    t = torch.arange(T, dtype=torch.int32, device=x.device)[None, :]
    out = _along_time(x, torch.clamp(off[:, None] + t, 0, T - 1))
    m = _mask(length, T, x.dtype).reshape((B, T) + _trail(x))
    ctx.set_output(op, "Out", out * m)
    ctx.set_lengths(op.outputs["Out"][0], length)


@register("sequence_pad")
def _sequence_pad(ctx, op):
    x = ctx.get_input(op, "X")
    pad_value = ctx.get_input(op, "PadValue")
    lens = _lengths_for(ctx, op)
    maxlen = int(op.attrs.get("padded_length", -1))
    T = x.shape[1]
    if maxlen <= 0:
        maxlen = T
    if maxlen < T:
        x = x[:, :maxlen]
        lens = torch.clamp(lens, max=maxlen)
    elif maxlen > T:
        x = F.pad(x, (0, 0) * (x.dim() - 2) + (0, maxlen - T))
    m = _mask(lens, maxlen, x.dtype).reshape((x.shape[0], maxlen) + _trail(x))
    out = x * m + pad_value.to(x.dtype).expand(x.shape) * (1 - m)
    ctx.set_output(op, "Out", out)
    ctx.set_output(op, "Length", lens.to(torch.int64))


@register("sequence_unpad")
def _sequence_unpad(ctx, op):
    x = ctx.get_input(op, "X")
    length = ctx.get_input(op, "Length").reshape(-1).to(torch.int32)
    m = _mask(length, x.shape[1], x.dtype).reshape(
        (x.shape[0], x.shape[1]) + _trail(x))
    ctx.set_output(op, "Out", x * m)
    ctx.set_lengths(op.outputs["Out"][0], length)


def _mask_width_from_data(op):
    return int(op.attrs.get("maxlen", -1)) < 0


@register("sequence_mask", reads_host=_mask_width_from_data)
def _sequence_mask(ctx, op):
    """lengths -> [B, maxlen] mask.  Without a ``maxlen`` attr the width
    is ``MaxLenTensor`` or the longest length, read back to the host (the
    output's shape depends on it): such an op is ``reads_host``, and its
    Program runs op by op."""
    x = ctx.get_input(op, "X").reshape(-1)
    maxlen = int(op.attrs.get("maxlen", -1))
    if maxlen < 0:
        mv = ctx.get_input(op, "MaxLenTensor")
        maxlen = int((mv if mv is not None else x.max()).reshape(-1)[0])
    out = _mask(x, maxlen, torch.bool)
    ctx.set_output(op, "Y", out.to(torch_dtype(op.attrs.get("out_dtype", "int64"))))


@register("sequence_erase")
def _sequence_erase(ctx, op):
    """Remove the listed tokens, compacting each sequence to the front."""
    x = ctx.get_input(op, "X")  # [B, T] ids (or [B, T, 1])
    lens = _lengths_for(ctx, op)
    squeeze = x.dim() == 3 and x.shape[-1] == 1
    v = x[..., 0] if squeeze else x
    T = v.shape[1]
    keep = torch.arange(T, dtype=torch.int32, device=x.device)[None, :] < lens[:, None]
    for tok in op.attrs.get("tokens", []):
        keep = keep & (v != tok)
    pos = torch.where(keep, torch.cumsum(keep.long(), 1) - 1, T)
    out = _scatter_time(torch.zeros_like(v), pos, v)
    if squeeze:
        out = out[..., None]
    ctx.set_output(op, "Out", out)
    ctx.set_lengths(op.outputs["Out"][0], keep.to(torch.int32).sum(1, dtype=torch.int32))


def _flat_payload(x, old_lens):
    """The valid rows of a padded [B, T, ...] tensor as a flat [B * T,
    ...] buffer (payload first, zeros after).  A tensor without lengths
    is already flat."""
    if old_lens is None:
        return x
    B, T = x.shape[:2]
    tail = tuple(x.shape[2:])
    lens = old_lens.long()
    t = torch.arange(T, device=x.device)[None, :]
    pos = (torch.cumsum(lens, 0) - lens)[:, None] + t
    safe = torch.where(t < lens[:, None], pos, B * T)  # dropped: row B * T
    flat = x.new_zeros((B * T + 1,) + tail)
    return flat.index_copy(0, safe.reshape(-1), x.reshape((-1,) + tail))[:B * T]


def _repack(flat, new_lens, T2):
    """Re-segment a flat payload into a padded [B2, T2, ...] layout."""
    tail = tuple(flat.shape[1:])
    lens = new_lens.long()
    t = torch.arange(T2, device=flat.device)[None, :]
    pos = (torch.cumsum(lens, 0) - lens)[:, None] + t
    out = flat[torch.clamp(pos, 0, flat.shape[0] - 1)]
    valid = (t < lens[:, None]).reshape(tuple(pos.shape) + (1,) * len(tail))
    return torch.where(valid, out, 0)


@register("lod_reset")
def _lod_reset(ctx, op):
    """Re-segment x's flat payload under a new LoD (reference
    lod_reset_op.h, which leaves its flat data as it is; the padded
    layout repacks rows).  A ``target_lod`` attr's lengths are made on
    the device by fills, no host copy."""
    xname = op.inputs["X"][0]
    x = ctx.get(xname)
    old_lens = ctx.get_lengths(xname)
    flat = _flat_payload(x, old_lens)
    out_name = op.outputs["Out"][0]
    if op.inputs.get("Y"):
        yname = op.inputs["Y"][0]
        ylens = ctx.get_lengths(yname)
        y = ctx.get(yname)
        if ylens is None:
            # a plain-Tensor Y carries LoD offsets (reference
            # lod_reset_op.h): lengths are consecutive differences
            y_offs = y.reshape(-1).to(torch.int32)
            ylens = y_offs[1:] - y_offs[:-1]
            T2 = flat.shape[0]  # no static bound beyond the payload
        else:
            T2 = y.shape[1] if y.dim() >= 2 else flat.shape[0]
        ctx.set_output(op, "Out", _repack(flat, ylens.to(torch.int32), T2))
        ctx.set_lengths(out_name, ylens)
        return
    # reference lod_reset_op.h: target_lod is an offset vector, from 0 to
    # the payload's row count
    offs = [int(v) for v in op.attrs.get("target_lod", [])]
    if len(offs) < 2 or offs[0] != 0:
        raise ValueError(
            "lod_reset target_lod must be offsets starting at 0, got %s" % (offs,))
    lens = [b - a for a, b in zip(offs, offs[1:])]
    if old_lens is None and offs[-1] != int(flat.shape[0]):
        raise ValueError("lod_reset target_lod ends at %d but X has %d payload "
                         "rows" % (offs[-1], int(flat.shape[0])))
    lens_t = device_values(lens, torch.int32, x.device)
    ctx.set_output(op, "Out", _repack(flat, lens_t, max(lens)))
    ctx.set_lengths(out_name, lens_t)


# ---------------------------------------------------------------------------
# recurrences: a loop over time with mask-gated carries
# ---------------------------------------------------------------------------


def _scan_rnn(step, x, lens, init_carry, is_reverse=False):
    """Run ``step(carry, xt) -> (carry, outs)`` over the time axis of
    ``x [B, T, ...]``; a row's carry moves only while ``t < length`` and
    its outputs past the length are zeros.  Returns (final carry, outputs
    stacked to [B, T, ...])."""
    T = x.shape[1]
    if is_reverse:
        x = _reverse_seq(x, lens)
    m = _mask(lens, T, torch.bool)
    carry = tuple(init_carry)
    steps = []
    for xt, mt in zip(x.unbind(1), m.unbind(1)):
        mt = mt[:, None]
        new_carry, out = step(carry, xt)
        carry = tuple(torch.where(mt, n, c) for n, c in zip(new_carry, carry))
        steps.append(tuple(torch.where(mt, o, 0.0) for o in out))
    outs = tuple(torch.stack(o, 1) for o in zip(*steps))
    if is_reverse:
        outs = tuple(_reverse_seq(o, lens) for o in outs)
    return carry, outs


def _lstm_acts(op):
    return (_act(op.attrs.get("gate_activation", "sigmoid")),
            _act(op.attrs.get("cell_activation", "tanh")),
            _act(op.attrs.get("candidate_activation", "tanh")))


def _lstm_cell(g, c, peep, act_g, act_c, act_cand):
    """One LSTM cell from its pre-activations ``g`` [B, 4D], column
    blocks {c, i, f, o}; ``peep`` the (W_ic, W_fc, W_oc) peepholes or
    None."""
    g_c, g_i, g_f, g_o = g.chunk(4, -1)
    if peep is not None:
        w_ic, w_fc, w_oc = peep
        i = act_g(g_i + w_ic * c)
        f = act_g(g_f + w_fc * c)
    else:
        i, f = act_g(g_i), act_g(g_f)
    c_new = f * c + i * act_cand(g_c)
    o = act_g(g_o + w_oc * c_new) if peep is not None else act_g(g_o)
    return o * act_c(c_new), c_new


def _lstm_bias(op, b, D):
    """(gate bias [4D], peepholes or None) from the [1, 4D or 7D] Bias."""
    bias = b.reshape(-1)
    if not op.attrs.get("use_peepholes", True):
        return bias[:4 * D], None
    return bias[:4 * D], (bias[4 * D:5 * D], bias[5 * D:6 * D], bias[6 * D:7 * D])


@register("lstm")
def _lstm(ctx, op):
    """dynamic_lstm: input pre-projected [B, T, 4D]; recurrent weight
    [D, 4D] with column blocks {c, i, f, o} (reference lstm_op's W_ch,
    W_ih, W_fh, W_oh); bias [1, 4D], plus [3D] peepholes W_ic, W_fc,
    W_oc with ``use_peepholes``."""
    x = ctx.get_input(op, "Input")
    w = ctx.get_input(op, "Weight")
    h0 = ctx.get_input(op, "H0")
    c0 = ctx.get_input(op, "C0")
    lens = _lengths_for(ctx, op, "Input")
    D, B = w.shape[0], x.shape[0]
    b_gate, peep = _lstm_bias(op, ctx.get_input(op, "Bias"), D)
    acts = _lstm_acts(op)
    h_init = h0 if h0 is not None else x.new_zeros((B, D))
    c_init = c0 if c0 is not None else x.new_zeros((B, D))

    def step(carry, xt):
        h, c = carry
        h_new, c_new = _lstm_cell(xt + h @ w + b_gate, c, peep, *acts)
        return (h_new, c_new), (h_new, c_new)

    _, (hs, cs) = _scan_rnn(step, x, lens, (h_init, c_init),
                            op.attrs.get("is_reverse", False))
    ctx.set_output(op, "Hidden", hs)
    ctx.set_output(op, "Cell", cs)
    ctx.set_lengths(op.outputs["Hidden"][0], lens)
    if op.outputs.get("Cell"):
        ctx.set_lengths(op.outputs["Cell"][0], lens)


@register("lstmp")
def _lstmp(ctx, op):
    """dynamic_lstmp (reference lstmp_op): an LSTM with a recurrent
    projection; recurrent weight [P, 4D], projection weight [D, P]."""
    x = ctx.get_input(op, "Input")  # [B, T, 4D]
    w = ctx.get_input(op, "Weight")  # [P, 4D]
    w_proj = ctx.get_input(op, "ProjWeight")  # [D, P]
    lens = _lengths_for(ctx, op, "Input")
    P, D = w.shape[0], w.shape[1] // 4
    B = x.shape[0]
    b_gate, peep = _lstm_bias(op, ctx.get_input(op, "Bias"), D)
    acts = _lstm_acts(op)
    act_p = _act(op.attrs.get("proj_activation", "tanh"))

    def step(carry, xt):
        r, c = carry  # r: [B, P], the projected hidden
        h_new, c_new = _lstm_cell(xt + r @ w + b_gate, c, peep, *acts)
        r_new = act_p(h_new @ w_proj)
        return (r_new, c_new), (r_new, c_new)

    init = (x.new_zeros((B, P)), x.new_zeros((B, D)))
    _, (rs, cs) = _scan_rnn(step, x, lens, init, op.attrs.get("is_reverse", False))
    ctx.set_output(op, "Projection", rs)
    ctx.set_output(op, "Cell", cs)
    ctx.set_lengths(op.outputs["Projection"][0], lens)


def _gru_step(xt, h, w, bias, act_g, act_c, origin_mode=False):
    """One GRU step: weight [D, 3D] ({update, reset} then the candidate's
    columns).  The reference gru_op's ``origin_mode`` is h = u * h_prev +
    (1 - u) * c; its default h = (1 - u) * h_prev + u * c."""
    D = h.shape[-1]
    g_ur = xt[:, :2 * D] + h @ w[:, :2 * D]
    if bias is not None:
        g_ur = g_ur + bias[:2 * D]
    u, r = act_g(g_ur).chunk(2, -1)
    g_c = xt[:, 2 * D:] + (r * h) @ w[:, 2 * D:]
    if bias is not None:
        g_c = g_c + bias[2 * D:]
    c = act_c(g_c)
    h_new = u * h + (1 - u) * c if origin_mode else (1 - u) * h + u * c
    return h_new, u, r, c


@register("gru")
def _gru(ctx, op):
    """dynamic_gru: input pre-projected [B, T, 3D]; weight [D, 3D];
    bias [1, 3D]."""
    x = ctx.get_input(op, "Input")
    w = ctx.get_input(op, "Weight")
    b = ctx.get_input(op, "Bias")
    h0 = ctx.get_input(op, "H0")
    lens = _lengths_for(ctx, op, "Input")
    act_g = _act(op.attrs.get("gate_activation", "sigmoid"))
    act_c = _act(op.attrs.get("candidate_activation", "tanh"))
    origin_mode = op.attrs.get("origin_mode", False)
    bias = b.reshape(-1) if b is not None else None
    h_init = h0 if h0 is not None else x.new_zeros((x.shape[0], w.shape[0]))

    def step(carry, xt):
        h_new = _gru_step(xt, carry[0], w, bias, act_g, act_c, origin_mode)[0]
        return (h_new,), (h_new,)

    _, (hs,) = _scan_rnn(step, x, lens, (h_init,), op.attrs.get("is_reverse", False))
    ctx.set_output(op, "Hidden", hs)
    ctx.set_lengths(op.outputs["Hidden"][0], lens)


_UNIT_ACTS = {0: "identity", 1: "sigmoid", 2: "tanh", 3: "relu"}


@register("gru_unit")
def _gru_unit(ctx, op):
    xt = ctx.get_input(op, "Input")  # [B, 3D]
    h = ctx.get_input(op, "HiddenPrev")
    w = ctx.get_input(op, "Weight")
    b = ctx.get_input(op, "Bias")
    act_g = _act(_UNIT_ACTS.get(op.attrs.get("gate_activation", 1), "sigmoid"))
    act_c = _act(_UNIT_ACTS.get(op.attrs.get("activation", 2), "tanh"))
    bias = b.reshape(-1) if b is not None else None
    h_new, u, r, c = _gru_step(xt, h, w, bias, act_g, act_c,
                               op.attrs.get("origin_mode", False))
    ctx.set_output(op, "Hidden", h_new)
    ctx.set_output(op, "Gate", torch.cat([u, r, c], dim=-1))
    ctx.set_output(op, "ResetHiddenPrev", r * h)


@register("lstm_unit")
def _lstm_unit(ctx, op):
    """One LSTM step's elementwise part (reference lstm_unit_op.h): X
    [B, 4D] gates {i, f, o, g}; C = f * c_prev + i * tanh(g), H = o *
    tanh(C), the forget gate's input shifted by ``forget_bias``."""
    x = ctx.get_input(op, "X")
    c_prev = ctx.get_input(op, "C_prev")
    g_i, g_f, g_o, g_g = x.chunk(4, -1)
    i = torch.sigmoid(g_i)
    f = torch.sigmoid(g_f + op.attrs.get("forget_bias", 0.0))
    o = torch.sigmoid(g_o)
    c = f * c_prev + i * torch.tanh(g_g)
    ctx.set_output(op, "C", c)
    ctx.set_output(op, "H", o * torch.tanh(c))
