"""Decoder-only Transformer LM for the decode runtime (PyTorch).

Counterpart of the decode half of ``paddle_tpu/models/transformer.py``:
the same post-norm blocks (bias-free q/k/v/o projections, relu FFN),
scaled token embedding plus sinusoid positions, and the same two steps
the serving scheduler drives —

* :func:`lm_prefill_chunk`: one resumable prefill chunk over the paged
  pool.  Per layer the chunk's k/v are written into the sequence's pages
  first, then the chunk attends through the page table over everything
  cached so far (:func:`~paddle_tpu_torch.parallel.flash_attention.
  paged_prefill_attention`).  Monolithic prefill is one bucket-wide
  chunk; every row's result depends on its position alone, so chunked
  and monolithic prefill give the same bits.
* :func:`lm_decode_step`: one token per slot — project q/k/v, write k/v
  at each slot's current page/offset, attend over the slot's own pages
  (:func:`~paddle_tpu_torch.parallel.flash_attention.
  paged_decode_attention`), finish the block stack, emit logits.

Unlike the JAX steps, which return new pools, these update ``k_pool`` /
``v_pool`` IN PLACE (``index_put_``) and return only logits: no second
copy of the pools ever exists.  Writes aimed at the scratch page 0
(inactive slots, pad-tail pages) may collide; whichever lands is
harmless because page 0 is never read unmasked.

``lm_params`` keeps the JAX package's numpy initialiser, so one seed
gives both packages the same arrays, and :func:`params_from_numpy`
turns that numpy pytree into a :class:`TransformerLM` on a device.  The
legacy whole-prompt ``lm_prefill`` is not ported: it needs the flash
forward kernel, and the scheduler prefills through chunks.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core import resolve_device
from ..parallel.flash_attention import (
    paged_decode_attention,
    paged_prefill_attention,
)

__all__ = ["lm_params", "params_from_numpy", "TransformerLM",
           "lm_prefill_chunk", "lm_decode_step", "build_decode_model"]


def _position_encoding_table(max_len, d_model):
    """Sinusoid table (reference transformer_model.py position_encoding_init)."""
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    inv = 1.0 / np.power(10000.0, (np.arange(d_model) // 2 * 2.0) / d_model)
    ang = pos * inv[None, :]
    table = np.zeros((max_len, d_model), dtype=np.float32)
    table[:, 0::2] = np.sin(ang[:, 0::2])
    table[:, 1::2] = np.cos(ang[:, 1::2])
    return table


def lm_params(seed=0, vocab_size=256, n_layer=2, n_head=2, d_model=64,
              d_inner=128, max_length=512):
    """Initialize decoder-only LM weights (numpy f32) + the static meta
    dict ``build_decode_model`` needs.  Returns ``(params, meta)``; the
    same seed gives the same arrays as the JAX package's ``lm_params``."""
    rng = np.random.RandomState(seed)

    def w(rows, cols, scale=None):
        s = scale if scale is not None else 1.0 / np.sqrt(rows)
        return (rng.randn(rows, cols) * s).astype(np.float32)

    params = {
        "tok_emb": (rng.randn(vocab_size, d_model) * 0.02).astype(np.float32),
        "pos_table": _position_encoding_table(max_length, d_model),
        "out_w": w(d_model, vocab_size),
        "layers": [
            {
                "wq": w(d_model, d_model), "wk": w(d_model, d_model),
                "wv": w(d_model, d_model), "wo": w(d_model, d_model),
                "ln1_s": np.ones(d_model, np.float32),
                "ln1_b": np.zeros(d_model, np.float32),
                "ffn_w1": w(d_model, d_inner),
                "ffn_b1": np.zeros(d_inner, np.float32),
                "ffn_w2": w(d_inner, d_model),
                "ffn_b2": np.zeros(d_model, np.float32),
                "ln2_s": np.ones(d_model, np.float32),
                "ln2_b": np.zeros(d_model, np.float32),
            }
            for _ in range(n_layer)
        ],
    }
    meta = dict(vocab_size=vocab_size, n_layer=n_layer, n_head=n_head,
                d_model=d_model, d_inner=d_inner, max_length=max_length,
                head_dim=d_model // n_head)
    return params, meta


_LAYER_KEYS = ("wq", "wk", "wv", "wo", "ln1_s", "ln1_b", "ffn_w1", "ffn_b1",
               "ffn_w2", "ffn_b2", "ln2_s", "ln2_b")


def _frozen(array, device):
    return nn.Parameter(torch.as_tensor(np.asarray(array, np.float32),
                                        device=device).clone(),
                        requires_grad=False)


class _LMBlock(nn.Module):
    """One post-norm block's weights, named as in the JAX pytree."""

    def __init__(self, lp, device):
        super().__init__()
        for key in _LAYER_KEYS:
            setattr(self, key, _frozen(lp[key], device))


class TransformerLM(nn.Module):
    """The LM's weights on one device (inference only: no gradients).

    Built by :func:`params_from_numpy`; :func:`lm_prefill_chunk` and
    :func:`lm_decode_step` read it the way the JAX steps read the
    ``params`` pytree."""

    def __init__(self, params, n_head, device):
        super().__init__()
        self.n_head = int(n_head)
        self.tok_emb = _frozen(params["tok_emb"], device)
        self.pos_table = _frozen(params["pos_table"], device)
        self.out_w = _frozen(params["out_w"], device)
        self.layers = nn.ModuleList(_LMBlock(lp, device)
                                    for lp in params["layers"])

    @property
    def device(self):
        return self.tok_emb.device

    @property
    def d_model(self):
        return self.tok_emb.shape[1]


def params_from_numpy(params, device=None, n_head=None, meta=None):
    """The JAX package's ``lm_params`` pytree (numpy arrays) as a
    :class:`TransformerLM` on ``device`` (None: the card; raises without
    one).  ``n_head`` comes from ``meta`` when not given."""
    if n_head is None:
        if meta is None:
            raise ValueError("params_from_numpy needs n_head or meta")
        n_head = meta["n_head"]
    return TransformerLM(params, n_head, resolve_device(device))


def _lm_ln(x, scale, bias, eps=1e-5):
    """Layer norm written out as the JAX package writes it."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * scale + bias


def _lm_block_tail(lp, x, attn_out):
    """Post-norm residual tail shared by prefill and decode: attention
    output projection + LN, then the relu FFN + LN."""
    x = _lm_ln(x + attn_out @ lp.wo, lp.ln1_s, lp.ln1_b)
    h = torch.clamp_min(x @ lp.ffn_w1 + lp.ffn_b1, 0.0)
    return _lm_ln(x + h @ lp.ffn_w2 + lp.ffn_b2, lp.ln2_s, lp.ln2_b)


def _embed(lm, tokens, positions):
    """Scaled token embedding + position rows.  Token ids are taken as
    JAX's gather takes them: a negative id wraps once, then ids clamp into
    ``[0, vocab)`` — on the card an out-of-range index would otherwise be
    a device assert that ends the process."""
    vocab = lm.tok_emb.shape[0]
    ids = tokens.long()
    ids = torch.where(ids < 0, ids + vocab, ids).clamp(0, vocab - 1)
    scale = float(np.float32(np.sqrt(lm.d_model)))  # JAX's f32 multiplier
    return lm.tok_emb[ids] * scale + lm.pos_table[positions.long()]


def lm_prefill_chunk(lm, tokens, start, valid, k_pool, v_pool, chunk_pages,
                     gather_pages):
    """One chunk of a prompt's prefill, resumable at any page boundary.

    ``tokens``: [C] int — the chunk's token window (pad tail arbitrary),
    absolute positions ``start .. start + C - 1``; ``valid``: real
    tokens in this window; ``chunk_pages``: [C // page_size] int32 page
    ids this chunk's k/v are written into (tail entries -> scratch);
    ``gather_pages``: [max_pages] int32 — the sequence's full page-table
    row, what the chunk attends over.  ``k_pool``/``v_pool``
    ([L, P, ps, H, Dh]) are updated IN PLACE.  Returns the logits [V] at
    row ``valid - 1`` (only the final chunk's are meaningful).
    """
    C = tokens.shape[0]
    ps = k_pool.shape[2]
    nb = C // ps
    H = lm.n_head
    dh = lm.d_model // H
    start = int(start)
    positions = torch.clamp_max(
        start + torch.arange(C, device=tokens.device),
        lm.pos_table.shape[0] - 1)
    x = _embed(lm, tokens, positions)
    chunk_idx = chunk_pages.long()
    for li, lp in enumerate(lm.layers):
        q = (x @ lp.wq).reshape(C, H, dh)
        k = (x @ lp.wk).reshape(C, H, dh)
        v = (x @ lp.wv).reshape(C, H, dh)
        k_pool[li].index_put_(
            (chunk_idx,), k.reshape(nb, ps, H, dh).to(k_pool.dtype))
        v_pool[li].index_put_(
            (chunk_idx,), v.reshape(nb, ps, H, dh).to(v_pool.dtype))
        ctx = paged_prefill_attention(q, k_pool[li], v_pool[li],
                                      gather_pages, start)
        x = _lm_block_tail(lp, x, ctx.reshape(C, lm.d_model))
    return x[int(valid) - 1] @ lm.out_w


def lm_decode_step(lm, tokens, positions, k_pool, v_pool, page_tables,
                   kv_lens):
    """One decode iteration: token s of each slot at cache index
    ``positions[s]``.  Writes k/v into the paged pools IN PLACE, attends
    over each slot's first ``kv_lens[s]`` cached tokens and returns the
    logits [S, V].  ``kv_lens[s] == 0`` = inactive slot (scratch-page
    write, zero attention, garbage logits the scheduler ignores)."""
    S = tokens.shape[0]
    ps = k_pool.shape[2]
    H = lm.n_head
    dh = lm.d_model // H
    pos = positions.long()
    x = _embed(lm, tokens, pos)
    pages = page_tables.long()[torch.arange(S, device=pos.device), pos // ps]
    offsets = pos % ps
    for li, lp in enumerate(lm.layers):
        q = (x @ lp.wq).reshape(S, H, dh)
        k = (x @ lp.wk).reshape(S, H, dh)
        v = (x @ lp.wv).reshape(S, H, dh)
        k_pool[li].index_put_((pages, offsets), k.to(k_pool.dtype))
        v_pool[li].index_put_((pages, offsets), v.to(v_pool.dtype))
        ctx = paged_decode_attention(q, k_pool[li], v_pool[li], page_tables,
                                     kv_lens)
        x = _lm_block_tail(lp, x, ctx.reshape(S, lm.d_model))
    return x @ lm.out_w


def build_decode_model(params, meta, eos_id=None, device=None):
    """Wrap LM weights as a serving ``DecodeModel`` on ``device``.

    ``params`` is the ``lm_params`` numpy pytree (copied onto ``device``
    by :func:`params_from_numpy`) or a :class:`TransformerLM` already on
    it.  ``device=None`` means the card and raises when there is none;
    the tests pass ``device="cpu"``."""
    from ..serving.decode_scheduler import DecodeModel

    dev = resolve_device(device)
    lm = params if isinstance(params, TransformerLM) else \
        params_from_numpy(params, dev, meta=meta)
    if lm.device != dev:
        raise ValueError("TransformerLM lives on %s, not %s"
                         % (lm.device, dev))

    def prefill_chunk_fn(tokens, start, valid, k_pool, v_pool, chunk_pages,
                         gather_pages):
        return lm_prefill_chunk(lm, tokens, start, valid, k_pool, v_pool,
                                chunk_pages, gather_pages)

    def decode_fn(tokens, positions, k_pool, v_pool, page_tables, kv_lens):
        return lm_decode_step(lm, tokens, positions, k_pool, v_pool,
                              page_tables, kv_lens)

    return DecodeModel(
        prefill_chunk_fn, decode_fn, num_layers=meta["n_layer"],
        num_heads=meta["n_head"], head_dim=meta["head_dim"],
        vocab_size=meta["vocab_size"], eos_id=eos_id, device=dev,
        name="transformer-lm")
