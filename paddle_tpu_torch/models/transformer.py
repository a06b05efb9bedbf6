"""Transformer models of the port (PyTorch): the Transformer-base
training graph, and the decoder-only LM of the decode runtime.

Training.  :func:`get_model` / :func:`transformer` and the functions under
them (:func:`multi_head_attention`, :func:`encoder_layer`,
:func:`decoder_layer`, :func:`wrap_encoder`, :func:`wrap_decoder`) are
copies of the top half of ``paddle_tpu/models/transformer.py``: they
build the same Fluid Program (post-norm Transformer-base, n_layer=6,
d_model=512, n_head=8, d_inner=2048, sinusoid positions, label smoothing
0.1, Adam + noam decay), which the port's ``Executor.run`` trains on the
card; with ``use_flash=True`` every attention is the ``flash_attention``
op, whose kernels are hand-written for Hopper.

Beam-search inference.  :func:`get_inference_model` /
:func:`fast_decode` are copies of the JAX package's: a ``While`` loop
whose body re-runs the decoder over the whole padded prefix, takes
``top_k`` and ``beam_search``, and writes three tensor arrays, then
``beam_search_decode`` backtracks the beams.  Built under a fresh
``unique_name.guard()``, as the training graph is, their parameters are
named as the trained ones; ``Executor.run`` runs the loop eagerly
(``layers/control_flow.py``) with cuBLAS products and torch ops on the
card — no flash kernel, as in the JAX package.

Decode serving.  The decoder-only LM is the counterpart of the decode
half of ``paddle_tpu/models/transformer.py``: the same post-norm blocks
(bias-free q/k/v/o projections, relu FFN), scaled token embedding plus
sinusoid positions, and the same steps the serving scheduler drives —

* :func:`lm_prefill`: the legacy whole-prompt prefill.  One causal pass
  over the padded prompt, each layer's attention the flash forward
  (:func:`~paddle_tpu_torch.parallel.flash_attention.flash_attention`
  with ``kv_lens = [length]``; ``use_flash=False`` runs
  :func:`~paddle_tpu_torch.parallel.flash_attention.mha_reference`);
  it returns every layer's k/v for the scheduler to scatter into the
  prompt's pages.  The scheduler takes this path for a model built with
  ``build_decode_model(..., chunked=False)``;

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
turns that numpy pytree into a :class:`TransformerLM` on a device.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import framework, layers
from .. import optimizer as optim
from ..core import resolve_device
from ..initializer import NumpyArrayInitializer
from ..param_attr import ParamAttr
from ..parallel.flash_attention import (
    flash_attention,
    mha_reference,
    paged_decode_attention,
    paged_prefill_attention,
)

__all__ = ["multi_head_attention", "encoder_layer", "decoder_layer",
           "wrap_encoder", "wrap_decoder", "transformer", "get_model",
           "fast_decode", "get_inference_model",
           "lm_params", "params_from_numpy", "TransformerLM",
           "lm_prefill", "lm_prefill_chunk", "lm_decode_step",
           "build_decode_model"]


def _position_encoding_table(max_len, d_model):
    """Sinusoid table (reference transformer_model.py position_encoding_init)."""
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    inv = 1.0 / np.power(10000.0, (np.arange(d_model) // 2 * 2.0) / d_model)
    ang = pos * inv[None, :]
    table = np.zeros((max_len, d_model), dtype=np.float32)
    table[:, 0::2] = np.sin(ang[:, 0::2])
    table[:, 1::2] = np.cos(ang[:, 1::2])
    return table


# ---------------------------------------------------------------------------
# The training graph (Transformer-base for WMT en-de): Program-building
# functions copied from the top half of paddle_tpu/models/transformer.py,
# so both packages build the same Program, the pipelined stacks
# (``pipeline_stages``: a ``layers.Pipeline`` a stack) included.
# ---------------------------------------------------------------------------

# Transformer-base hyperparameters (reference transformer_model.py / the
# ModelHyperParams in dist_transformer.py)
D_MODEL = 512
D_INNER = 2048
N_HEAD = 8
N_LAYER = 6
DROPOUT = 0.1
MAX_LENGTH = 256
SRC_VOCAB = 10000
TRG_VOCAB = 10000
PAD_IDX = 0
EOS_IDX = 1
BOS_IDX = 2


def _causal_bias_table(max_len):
    """[max_len, max_len] upper-triangular -1e9 mask, sliced per sequence."""
    return np.triu(np.full((max_len, max_len), -1e9, dtype=np.float32), k=1)


def _const_table(name, array):
    """A frozen lookup table materialized as a non-trainable parameter."""
    return layers.create_parameter(
        shape=list(array.shape),
        dtype="float32",
        name=name,
        attr=ParamAttr(
            name=name, initializer=NumpyArrayInitializer(array), trainable=False
        ),
    )


def multi_head_attention(
    queries,
    keys,
    values,
    attn_bias,
    d_key,
    d_value,
    d_model,
    n_head,
    dropout_rate=0.0,
    cache=None,
    use_flash=False,
    flash_causal=False,
    kv_lens=None,
):
    """Reference transformer_model.py:45 multi_head_attention.  [B,T,D] in,
    [B,T,D] out; heads split via reshape+transpose (a view in torch).
    ``cache`` (dict with 'k','v' variables) enables incremental decode."""
    keys = queries if keys is None else keys
    values = keys if values is None else values

    q = layers.fc(input=queries, size=d_key * n_head, num_flatten_dims=2, bias_attr=False)
    k = layers.fc(input=keys, size=d_key * n_head, num_flatten_dims=2, bias_attr=False)
    v = layers.fc(input=values, size=d_value * n_head, num_flatten_dims=2, bias_attr=False)

    def split_heads(x, d):
        b, t = x.shape[0], x.shape[1]
        x = layers.reshape(x=x, shape=[b if b and b > 0 else -1, t, n_head, d])
        return layers.transpose(x=x, perm=[0, 2, 1, 3])  # [B,H,T,d]

    q = split_heads(q, d_key)
    k = split_heads(k, d_key)
    v = split_heads(v, d_value)

    if cache is not None:
        k = cache["k"] = layers.concat([cache["k"], k], axis=2)
        v = cache["v"] = layers.concat([cache["v"], v], axis=2)

    if use_flash and cache is None:
        # the flash attention kernels: padding via kv_lens, no [T,S] bias
        ctx = layers.flash_attention(q, k, v, kv_lens=kv_lens, causal=flash_causal)
    else:
        product = layers.matmul(x=q, y=k, transpose_y=True, alpha=d_key**-0.5)
        if attn_bias is not None:
            product = layers.elementwise_add(x=product, y=attn_bias)
        weights = layers.softmax(product)
        if dropout_rate:
            weights = layers.dropout(weights, dropout_prob=dropout_rate, is_test=False)
        ctx = layers.matmul(weights, v)  # [B,H,Tq,dv]
    ctx = layers.transpose(ctx, perm=[0, 2, 1, 3])
    b, t = queries.shape[0], queries.shape[1]
    ctx = layers.reshape(x=ctx, shape=[b if b and b > 0 else -1, t, n_head * d_value])
    return layers.fc(input=ctx, size=d_model, num_flatten_dims=2, bias_attr=False)


def positionwise_feed_forward(x, d_inner_hid, d_hid, dropout_rate=0.0):
    """Reference transformer_model.py:167 — two matmuls with a relu."""
    hidden = layers.fc(input=x, size=d_inner_hid, num_flatten_dims=2, act="relu")
    if dropout_rate:
        hidden = layers.dropout(hidden, dropout_prob=dropout_rate, is_test=False)
    return layers.fc(input=hidden, size=d_hid, num_flatten_dims=2)


def post_process(prev_out, out, dropout_rate=0.0):
    """Residual add + layer_norm (post-norm, as the reference's
    post_process_layer cmd='dan': dropout, add, norm)."""
    if dropout_rate:
        out = layers.dropout(out, dropout_prob=dropout_rate, is_test=False)
    if prev_out is not None:
        out = layers.elementwise_add(x=out, y=prev_out)
    return layers.layer_norm(out, begin_norm_axis=len(out.shape) - 1)


def prepare_encoder_decoder(
    word_ids, vocab_size, d_model, max_length, dropout_rate, pos_table, word_emb_name
):
    """Token embedding * sqrt(d_model) + sinusoid position encoding
    (reference transformer_model.py:185 prepare_encoder)."""
    emb = layers.embedding(
        input=word_ids,
        size=[vocab_size, d_model],
        padding_idx=PAD_IDX,
        param_attr=ParamAttr(name=word_emb_name),
    )
    emb = layers.scale(x=emb, scale=d_model**0.5)
    seq_len = word_ids.shape[1]
    pos_enc = layers.slice(pos_table, axes=[0], starts=[0], ends=[seq_len])
    out = layers.elementwise_add(x=emb, y=pos_enc, axis=1)
    if dropout_rate:
        out = layers.dropout(out, dropout_prob=dropout_rate, is_test=False)
    return out


def _make_pipe(n_layer, stages, microbatches, repeats, use_flash, what):
    """Shared guard-and-construct for the pipelined encoder/decoder stacks."""
    if n_layer % stages:
        raise ValueError("%s n_layer %d %% pipeline_stages %d != 0"
                         % (what, n_layer, stages))
    if use_flash:
        raise ValueError(
            "use_flash composes with sp, not pp: the flash kernel's "
            "sequence-parallel path reads the mesh, which inside a "
            "pipeline stage would nest shard_maps")
    return layers.Pipeline(
        num_stages=stages,
        num_microbatches=microbatches or 2 * stages,
        circular_repeats=repeats)


def encoder_layer(x, attn_bias, n_head, d_key, d_value, d_model, d_inner, dropout,
                  use_flash=False, kv_lens=None):
    attn = multi_head_attention(x, None, None, attn_bias, d_key, d_value, d_model, n_head, dropout,
                                use_flash=use_flash, kv_lens=kv_lens)
    x = post_process(x, attn, dropout)
    ffn = positionwise_feed_forward(x, d_inner, d_model, dropout)
    return post_process(x, ffn, dropout)


def decoder_layer(
    x, enc_out, slf_bias, dec_enc_bias, n_head, d_key, d_value, d_model, d_inner, dropout, cache=None,
    use_flash=False, trg_lens=None, src_lens=None,
):
    slf = multi_head_attention(x, None, None, slf_bias, d_key, d_value, d_model, n_head, dropout, cache=cache,
                               use_flash=use_flash, flash_causal=True, kv_lens=trg_lens)
    x = post_process(x, slf, dropout)
    cross = multi_head_attention(x, enc_out, None, dec_enc_bias, d_key, d_value, d_model, n_head, dropout,
                                 use_flash=use_flash, kv_lens=src_lens)
    x = post_process(x, cross, dropout)
    ffn = positionwise_feed_forward(x, d_inner, d_model, dropout)
    return post_process(x, ffn, dropout)


def _pad_bias(word_ids):
    """[B,1,1,T] additive bias: -1e9 at pad positions, computed in-graph."""
    pad = layers.fill_constant(shape=[1], dtype=word_ids.dtype, value=PAD_IDX)
    is_pad = layers.cast(layers.equal(word_ids, pad), "float32")
    bias = layers.scale(x=is_pad, scale=-1e9)
    return layers.unsqueeze(bias, axes=[1, 2])


def _word_lens(word_ids):
    """[B] int32 non-pad lengths (padding is contiguous at the tail)."""
    pad = layers.fill_constant(shape=[1], dtype=word_ids.dtype, value=PAD_IDX)
    non_pad = layers.cast(layers.logical_not(layers.equal(word_ids, pad)), "float32")
    lens = layers.reduce_sum(non_pad, dim=1)
    lens = layers.cast(lens, "int32")
    lens.stop_gradient = True
    return lens


def wrap_encoder(
    src_word,
    src_vocab_size=SRC_VOCAB,
    max_length=MAX_LENGTH,
    n_layer=N_LAYER,
    n_head=N_HEAD,
    d_model=D_MODEL,
    d_inner=D_INNER,
    dropout=DROPOUT,
    use_flash=False,
    pipeline_stages=0,
    pipeline_microbatches=None,
    pipeline_circular_repeats=1,
):
    """The encoder stack; returns (enc_out, src_bias).

    ``pipeline_stages=S`` builds the stack as a ``layers.Pipeline``
    (n_layer/S layers a stage, stage-stacked parameters), run on one
    device as the microbatched sequence of its stages; the pad bias
    rides along as a per-microbatch side input.
    ``pipeline_circular_repeats=R`` (must divide S) lays the stages out
    circularly (``parallel.pipeline.circular_stage_index``)."""
    pos_table = _const_table("src_pos_enc_table", _position_encoding_table(max_length, d_model))
    src_bias = _pad_bias(src_word)
    src_lens = _word_lens(src_word) if use_flash else None
    x = prepare_encoder_decoder(src_word, src_vocab_size, d_model, max_length, dropout, pos_table, "src_word_emb")
    if pipeline_stages:
        pipe = _make_pipe(n_layer, pipeline_stages, pipeline_microbatches,
                          pipeline_circular_repeats, use_flash, "encoder")
        with pipe.stage():
            h = pipe.stage_input(x)
            bias_l = pipe.stage_side_input(src_bias)
            for _ in range(n_layer // pipeline_stages):
                h = encoder_layer(h, bias_l, n_head, d_model // n_head,
                                  d_model // n_head, d_model, d_inner, dropout)
            pipe.stage_output(h)
        return pipe(), src_bias
    for _ in range(n_layer):
        x = encoder_layer(x, src_bias, n_head, d_model // n_head, d_model // n_head, d_model, d_inner, dropout,
                          use_flash=use_flash, kv_lens=src_lens)
    return x, src_bias


def wrap_decoder(
    trg_word,
    enc_out,
    src_bias,
    trg_vocab_size=TRG_VOCAB,
    max_length=MAX_LENGTH,
    n_layer=N_LAYER,
    n_head=N_HEAD,
    d_model=D_MODEL,
    d_inner=D_INNER,
    dropout=DROPOUT,
    caches=None,
    causal=True,
    use_flash=False,
    src_word=None,
    pipeline_stages=0,
    pipeline_microbatches=None,
    pipeline_circular_repeats=1,
):
    """The decoder stack and the output projection; returns logits.

    ``pipeline_stages`` pipelines the decoder stack like wrap_encoder's
    (training graph only — incremental decode with ``caches`` keeps the
    sequential stack): enc_out and both attention biases ride as
    per-microbatch side inputs."""
    pos_table = _const_table("trg_pos_enc_table", _position_encoding_table(max_length, d_model))
    seq_len = trg_word.shape[1]
    trg_lens = _word_lens(trg_word) if use_flash else None
    src_lens = _word_lens(src_word) if (use_flash and src_word is not None) else None
    slf_bias = _pad_bias(trg_word)  # [B,1,1,T]
    if causal:
        causal_table = _const_table("causal_bias_table", _causal_bias_table(max_length))
        causal_bias = layers.slice(causal_table, axes=[0, 1], starts=[0, 0], ends=[seq_len, seq_len])
        causal_bias = layers.unsqueeze(causal_bias, axes=[0, 1])  # [1,1,T,T]
        slf_bias = layers.elementwise_add(x=causal_bias, y=slf_bias)
    x = prepare_encoder_decoder(trg_word, trg_vocab_size, d_model, max_length, dropout, pos_table, "trg_word_emb")
    if pipeline_stages and caches is None:
        pipe = _make_pipe(n_layer, pipeline_stages, pipeline_microbatches,
                          pipeline_circular_repeats, use_flash, "decoder")
        with pipe.stage():
            h = pipe.stage_input(x)
            enc_l = pipe.stage_side_input(enc_out)
            # [B,1,T,T] at runtime (causal [1,1,T,T] broadcast over the
            # [B,1,1,T] pad bias): batch-leading, slices per microbatch
            slf_l = pipe.stage_side_input(slf_bias)
            src_l = pipe.stage_side_input(src_bias)
            for _ in range(n_layer // pipeline_stages):
                h = decoder_layer(
                    h, enc_l, slf_l, src_l, n_head, d_model // n_head,
                    d_model // n_head, d_model, d_inner, dropout)
            pipe.stage_output(h)
        x = pipe()
    else:
        for i in range(n_layer):
            x = decoder_layer(
                x,
                enc_out,
                slf_bias,
                src_bias,
                n_head,
                d_model // n_head,
                d_model // n_head,
                d_model,
                d_inner,
                dropout,
                cache=caches[i] if caches is not None else None,
                use_flash=use_flash and caches is None and causal,
                trg_lens=trg_lens,
                src_lens=src_lens,
            )
    logits = layers.fc(input=x, size=trg_vocab_size, num_flatten_dims=2, bias_attr=False)
    return logits


def transformer(
    src_word,
    trg_word,
    lbl_word,
    src_vocab_size=SRC_VOCAB,
    trg_vocab_size=TRG_VOCAB,
    max_length=MAX_LENGTH,
    n_layer=N_LAYER,
    n_head=N_HEAD,
    d_model=D_MODEL,
    d_inner=D_INNER,
    dropout=DROPOUT,
    label_smooth_eps=0.1,
    use_flash=False,
    pipeline_stages=0,
    pipeline_microbatches=None,
    pipeline_circular_repeats=1,
):
    """Training graph (reference transformer_model.py:282 transformer).
    Returns (avg_cost, sum_cost, token_count, logits)."""
    enc_out, src_bias = wrap_encoder(src_word, src_vocab_size, max_length, n_layer, n_head, d_model, d_inner, dropout,
                                     use_flash=use_flash, pipeline_stages=pipeline_stages,
                                     pipeline_microbatches=pipeline_microbatches,
                                     pipeline_circular_repeats=pipeline_circular_repeats)
    logits = wrap_decoder(trg_word, enc_out, src_bias, trg_vocab_size, max_length, n_layer, n_head, d_model, d_inner,
                          dropout, use_flash=use_flash, src_word=src_word,
                          pipeline_stages=pipeline_stages,
                          pipeline_microbatches=pipeline_microbatches,
                          pipeline_circular_repeats=pipeline_circular_repeats)

    label = layers.one_hot(input=lbl_word, depth=trg_vocab_size)
    if label_smooth_eps:
        label = layers.label_smooth(label=label, epsilon=label_smooth_eps)
    cost = layers.softmax_with_cross_entropy(logits=logits, label=label, soft_label=True)  # [B,T,1]

    pad = layers.fill_constant(shape=[1], dtype=lbl_word.dtype, value=PAD_IDX)
    non_pad = layers.cast(layers.logical_not(layers.equal(lbl_word, pad)), "float32")
    weights = layers.unsqueeze(non_pad, axes=[2])
    weighted = layers.elementwise_mul(x=cost, y=weights)
    sum_cost = layers.reduce_sum(weighted)
    token_num = layers.reduce_sum(weights)
    token_num.stop_gradient = True
    avg_cost = layers.elementwise_div(x=sum_cost, y=token_num)
    return avg_cost, sum_cost, token_num, logits


def get_model(
    batch_size=32,
    seq_len=64,
    src_vocab_size=SRC_VOCAB,
    trg_vocab_size=TRG_VOCAB,
    max_length=MAX_LENGTH,
    n_layer=N_LAYER,
    n_head=N_HEAD,
    d_model=D_MODEL,
    d_inner=D_INNER,
    dropout=DROPOUT,
    learning_rate=2.0,
    warmup_steps=8000,
    use_flash=False,
    pipeline_stages=0,
    pipeline_microbatches=None,
    pipeline_circular_repeats=1,
):
    """The training Programs: ``main`` (forward, backward and Adam with
    noam decay), ``startup``, ``test`` (the forward, cloned for test),
    the feed names and the loss/sum_cost/token_num/predict variables."""
    main = framework.Program()
    startup = framework.Program()
    with framework.program_guard(main, startup):
        src_word = layers.data(name="src_word", shape=[seq_len], dtype="int64")
        trg_word = layers.data(name="trg_word", shape=[seq_len], dtype="int64")
        lbl_word = layers.data(name="lbl_word", shape=[seq_len], dtype="int64")
        avg_cost, sum_cost, token_num, logits = transformer(
            src_word, trg_word, lbl_word,
            src_vocab_size, trg_vocab_size, max_length,
            n_layer, n_head, d_model, d_inner, dropout,
            use_flash=use_flash,
            pipeline_stages=pipeline_stages,
            pipeline_microbatches=pipeline_microbatches,
            pipeline_circular_repeats=pipeline_circular_repeats,
        )
        inference_program = main.clone(for_test=True)
        lr = layers.scale(x=layers.noam_decay(d_model, warmup_steps), scale=float(learning_rate))
        opt = optim.AdamOptimizer(learning_rate=lr, beta1=0.9, beta2=0.98, epsilon=1e-9)
        opt.minimize(avg_cost)
    return {
        "main": main,
        "startup": startup,
        "test": inference_program,
        "feeds": ["src_word", "trg_word", "lbl_word"],
        "loss": avg_cost,
        "sum_cost": sum_cost,
        "token_num": token_num,
        "predict": logits,
    }


def fast_decode(
    src_word,
    beam_size,
    max_out_len,
    src_vocab_size=SRC_VOCAB,
    trg_vocab_size=TRG_VOCAB,
    max_length=MAX_LENGTH,
    n_layer=N_LAYER,
    n_head=N_HEAD,
    d_model=D_MODEL,
    d_inner=D_INNER,
):
    """Beam-search inference graph (reference analog: the transformer
    benchmark's fast_decoder), a copy of the JAX package's: beam lanes
    fold into the batch axis and each While step re-runs the decoder on
    the *whole padded prefix* with causal masking, so every iteration has
    the same shapes.  Its attention is ``matmul`` + ``softmax`` (no flash
    kernel), as in the JAX package; there is no k/v cache.

    Build INSIDE the same unique_name scope as the training graph clone so
    parameter names line up with the trained scope.
    """
    enc_out, src_bias = wrap_encoder(src_word, src_vocab_size, max_length, n_layer, n_head, d_model, d_inner, 0.0)

    def expand_to_beam(x):
        ex = layers.expand(layers.unsqueeze(x, axes=[1]), [1, beam_size] + [1] * (len(x.shape) - 1))
        return layers.reshape(x=ex, shape=[-1] + [int(d) for d in x.shape[1:]])

    enc_out_b = expand_to_beam(enc_out)          # [B*beam, Ts, D]
    src_bias_b = expand_to_beam(src_bias)        # [B*beam, 1, 1, Ts]

    batch_ref = layers.reduce_sum(enc_out, dim=[1, 2], keep_dim=True)  # [B,1,1] batch-size anchor
    batch_ref = layers.reshape(batch_ref, shape=[-1, 1])

    # decoded tokens so far, padded: [B*beam, max_out_len], starts all PAD
    # with BOS at position 0
    tokens0 = layers.fill_constant_batch_size_like(
        input=enc_out_b, shape=[-1, max_out_len], dtype="int64", value=float(PAD_IDX)
    )
    pos_onehot0 = layers.cast(
        layers.equal(
            layers.cumsum(
                layers.fill_constant_batch_size_like(
                    input=enc_out_b, shape=[-1, max_out_len], dtype="float32", value=1.0
                ),
                axis=1,
            ),
            layers.fill_constant(shape=[1], dtype="float32", value=1.0),
        ),
        "int64",
    )  # one-hot at column 0
    tokens0 = layers.elementwise_add(
        tokens0, layers.scale(pos_onehot0, scale=float(BOS_IDX))
    )
    tokens = layers.assign(tokens0)

    init_ids = layers.fill_constant_batch_size_like(
        input=batch_ref, shape=[-1, beam_size], dtype="int64", value=float(BOS_IDX)
    )
    lane = layers.cumsum(
        layers.fill_constant_batch_size_like(
            input=batch_ref, shape=[-1, beam_size], dtype="float32", value=1.0
        ),
        axis=1,
    )
    one = layers.fill_constant(shape=[1], dtype="float32", value=1.0)
    init_scores = layers.scale(
        x=layers.cast(layers.logical_not(layers.equal(lane, one)), "float32"), scale=-1e9
    )
    pre_ids = layers.assign(init_ids)
    pre_scores = layers.assign(init_scores)

    ids_arr = layers.create_array("int64", capacity=max_out_len)
    scores_arr = layers.create_array("float32", capacity=max_out_len)
    parents_arr = layers.create_array("int32", capacity=max_out_len)

    counter = layers.zeros(shape=[1], dtype="int64", force_cpu=True)
    max_len_const = layers.fill_constant(shape=[1], dtype="int64", value=max_out_len - 1)
    cond = layers.less_than(x=counter, y=max_len_const)

    row_base = layers.scale(
        x=layers.cumsum(
            layers.fill_constant_batch_size_like(
                input=batch_ref, shape=[-1, 1], dtype="float32", value=1.0
            ),
            axis=0,
        ),
        scale=float(beam_size), bias=-float(beam_size),
    )

    while_op = layers.While(cond=cond, maxlen=max_out_len)
    with while_op.block():
        # full-prefix decoder pass with causal mask; positions > counter are
        # PAD so their keys are masked out by the decoder's pad bias
        logits = wrap_decoder(
            tokens, enc_out_b, src_bias_b, trg_vocab_size, max_length,
            n_layer, n_head, d_model, d_inner, 0.0, causal=True,
        )  # [B*beam, max_out_len, V]

        # logits at the current position: one-hot(counter) row-reduce
        step_f = layers.cast(counter, "float32")
        col = layers.cumsum(
            layers.fill_constant_batch_size_like(
                input=enc_out_b, shape=[-1, max_out_len], dtype="float32", value=1.0
            ),
            axis=1,
        )  # 1..L
        onehot = layers.cast(
            layers.equal(col, layers.elementwise_add(step_f, one)), "float32"
        )  # [B*beam, L], 1 at column == counter
        cur_logits = layers.reduce_sum(
            layers.elementwise_mul(logits, layers.unsqueeze(onehot, axes=[2]), axis=0),
            dim=1,
        )  # [B*beam, V]
        probs = layers.softmax(cur_logits)

        topk_scores, topk_ids = layers.topk(probs, k=beam_size)
        topk_scores = layers.reshape(x=topk_scores, shape=[-1, beam_size, beam_size])
        topk_ids = layers.reshape(x=topk_ids, shape=[-1, beam_size, beam_size])
        acc_scores = layers.elementwise_add(
            x=layers.log(topk_scores), y=layers.unsqueeze(pre_scores, axes=[2])
        )
        sel_ids, sel_scores, parents = layers.beam_search(
            pre_ids, pre_scores, topk_ids, acc_scores, beam_size, EOS_IDX
        )

        layers.array_write(sel_ids, i=counter, array=ids_arr)
        layers.array_write(sel_scores, i=counter, array=scores_arr)
        layers.array_write(parents, i=counter, array=parents_arr)

        # reorder token prefixes by parent lane, then append sel_ids at
        # position counter+1
        flat_parents = layers.cast(
            layers.elementwise_add(
                layers.cast(parents, "float32"), row_base
            ),
            "int64",
        )  # [B, beam] flat indices into B*beam
        flat_parents = layers.reshape(flat_parents, shape=[-1])
        tokens_re = layers.gather(tokens, flat_parents)  # [B*beam, L]
        next_onehot = layers.cast(
            layers.equal(col, layers.elementwise_add(layers.elementwise_add(step_f, one), one)),
            "int64",
        )  # 1 at column counter+1
        new_tok = layers.elementwise_mul(
            next_onehot, layers.reshape(sel_ids, shape=[-1, 1]), axis=0
        )
        keep = layers.elementwise_mul(
            tokens_re,
            layers.elementwise_sub(
                layers.fill_constant_batch_size_like(
                    input=tokens_re, shape=[-1, max_out_len], dtype="int64", value=1.0
                ),
                next_onehot,
            ),
        )
        layers.assign(layers.elementwise_add(keep, new_tok), output=tokens)

        layers.assign(layers.reshape(sel_ids, shape=[-1, beam_size]), output=pre_ids)
        layers.assign(sel_scores, output=pre_scores)
        layers.increment(x=counter, value=1, in_place=True)
        layers.less_than(x=counter, y=max_len_const, cond=cond)

    sentence_ids, sentence_scores = layers.beam_search_decode(
        ids_arr, scores_arr, parents_arr, beam_size, EOS_IDX
    )
    return sentence_ids, sentence_scores


def get_inference_model(
    beam_size=4,
    max_out_len=32,
    seq_len=64,
    src_vocab_size=SRC_VOCAB,
    trg_vocab_size=TRG_VOCAB,
    max_length=MAX_LENGTH,
    n_layer=N_LAYER,
    n_head=N_HEAD,
    d_model=D_MODEL,
    d_inner=D_INNER,
):
    """Standalone decode program sharing parameter names with get_model's
    training program (build both under the same fresh unique_name guard)."""
    infer = framework.Program()
    startup = framework.Program()
    with framework.program_guard(infer, startup):
        src_word = layers.data(name="src_word", shape=[seq_len], dtype="int64")
        ids, scores = fast_decode(
            src_word, beam_size, max_out_len, src_vocab_size, trg_vocab_size,
            max_length, n_layer, n_head, d_model, d_inner,
        )
    return {"infer": infer, "startup": startup, "ids": ids, "scores": scores,
            "feeds": ["src_word"]}


# ---------------------------------------------------------------------------
# The decoder-only LM of the decode runtime
# ---------------------------------------------------------------------------


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


def _step_scalar(value, device):
    """A step's scalar (a chunk's start, its valid rows, a prompt's
    length) as a [1] int32 tensor on ``device``.  The scheduler passes
    tensors already there, which a CUDA graph captures by address; a
    Python int is uploaded (a direct caller's convenience)."""
    if isinstance(value, torch.Tensor):
        return value.reshape(1).to(device=device, dtype=torch.int32)
    return torch.tensor([int(value)], dtype=torch.int32, device=device)


def _row_logits(lm, x, row):
    """Logits of row ``row`` ([1] int32 on x's device) of ``x`` [T, d]:
    the row picked on the device (no host index), then the vector
    product the JAX steps' ``x[i] @ out_w`` is."""
    return torch.index_select(x, 0, row.long())[0] @ lm.out_w


def lm_prefill(lm, tokens, length, *, use_flash):
    """Causal pass over one padded prompt.  ``tokens``: [T] int (pad tail
    arbitrary), ``length``: the real token count, a [1] int32 tensor on
    the tokens' device (or an int).  Returns
    ``(last_logits [V], k [L, T, H, Dh], v [L, T, H, Dh])`` — k/v in the
    page-scatter layout, pad-tail rows masked downstream by kv_lens.
    Each layer attends with ``flash_attention`` (``use_flash``; the flash
    forward kernel on a CUDA tensor) or ``mha_reference``, causally over
    keys below ``length``.  Nothing reads ``length`` on the host, so the
    pass can be captured once a bucket and replayed for any length."""
    T = tokens.shape[0]
    H = lm.n_head
    dh = lm.d_model // H
    lens1 = _step_scalar(length, tokens.device)
    x = _embed(lm, tokens, torch.arange(T, device=tokens.device))
    attn = flash_attention if use_flash else mha_reference
    ks, vs = [], []
    for lp in lm.layers:
        q = (x @ lp.wq).reshape(T, H, dh)
        k = (x @ lp.wk).reshape(T, H, dh)
        v = (x @ lp.wv).reshape(T, H, dh)
        ks.append(k)
        vs.append(v)
        ctx = attn(q.transpose(0, 1)[None], k.transpose(0, 1)[None],
                   v.transpose(0, 1)[None], causal=True, kv_lens=lens1)
        x = _lm_block_tail(lp, x, ctx[0].transpose(0, 1).reshape(T, lm.d_model))
    return _row_logits(lm, x, lens1 - 1), torch.stack(ks), torch.stack(vs)


def lm_prefill_chunk(lm, tokens, start, valid, k_pool, v_pool, chunk_pages,
                     gather_pages):
    """One chunk of a prompt's prefill, resumable at any page boundary.

    ``tokens``: [C] int — the chunk's token window (pad tail arbitrary),
    absolute positions ``start .. start + C - 1``; ``valid``: real
    tokens in this window; ``start`` and ``valid`` are [1] int32
    tensors on the tokens' device (or ints); ``chunk_pages``:
    [C // page_size] int32 page ids this chunk's k/v are written into
    (tail entries -> scratch); ``gather_pages``: [max_pages] int32 — the
    sequence's full page-table row, what the chunk attends over.
    ``k_pool``/``v_pool`` ([L, P, ps, H, Dh]) are updated IN PLACE.
    Returns the logits [V] at row ``valid - 1`` (only the final chunk's
    are meaningful).  Nothing here reads a value on the host, so one
    capture a width serves every start.
    """
    C = tokens.shape[0]
    ps = k_pool.shape[2]
    nb = C // ps
    H = lm.n_head
    dh = lm.d_model // H
    start = _step_scalar(start, tokens.device)
    valid = _step_scalar(valid, tokens.device)
    positions = torch.clamp_max(
        start + torch.arange(C, dtype=torch.int32, device=tokens.device),
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
    return _row_logits(lm, x, valid - 1)


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


def build_decode_model(params, meta, eos_id=None, use_flash=None,
                       device=None, chunked=True):
    """Wrap LM weights as a serving ``DecodeModel`` on ``device``.

    ``params`` is the ``lm_params`` numpy pytree (copied onto ``device``
    by :func:`params_from_numpy`) or a :class:`TransformerLM` already on
    it.  ``device=None`` means the card and raises when there is none;
    the tests pass ``device="cpu"``.

    ``use_flash``: the legacy whole-prompt prefill's attention
    (:func:`lm_prefill`); None means flash on the card and
    ``mha_reference`` on the CPU.  ``chunked=False`` builds the model
    with ``prefill_fn`` only — the JAX package's ``DecodeModel`` with
    ``prefill_chunk_fn=None`` — so the scheduler prefills each prompt in
    one legacy call; by default the model has both and the scheduler
    prefills through chunks."""
    from ..serving.decode_scheduler import DecodeModel

    dev = resolve_device(device)
    lm = params if isinstance(params, TransformerLM) else \
        params_from_numpy(params, dev, meta=meta)
    if lm.device != dev:
        raise ValueError("TransformerLM lives on %s, not %s"
                         % (lm.device, dev))

    if use_flash is None:
        use_flash = dev.type == "cuda"

    def prefill_fn(tokens, length):
        return lm_prefill(lm, tokens, length, use_flash=use_flash)

    def prefill_chunk_fn(tokens, start, valid, k_pool, v_pool, chunk_pages,
                         gather_pages):
        return lm_prefill_chunk(lm, tokens, start, valid, k_pool, v_pool,
                                chunk_pages, gather_pages)

    def decode_fn(tokens, positions, k_pool, v_pool, page_tables, kv_lens):
        return lm_decode_step(lm, tokens, positions, k_pool, v_pool,
                              page_tables, kv_lens)

    return DecodeModel(
        prefill_fn, decode_fn,
        prefill_chunk_fn=prefill_chunk_fn if chunked else None,
        num_layers=meta["n_layer"],
        num_heads=meta["n_head"], head_dim=meta["head_dim"],
        vocab_size=meta["vocab_size"], eos_id=eos_id, device=dev,
        name="transformer-lm")
