"""Attention seq2seq for WMT-14 en-fr machine translation.

Reference: benchmark/fluid/models/machine_translation.py (bi-LSTM encoder +
per-step additive-attention LSTM decoder) and the generation path of
python/paddle/fluid/tests/book/test_machine_translation.py (While-loop beam
search).

The port's copy of the JAX package's
``paddle_tpu/models/machine_translation.py``: the same Programs.
- Ragged source and target are padded ``[batch, len]`` with in-graph pad
  masks; the attention softmax is masked additively.
- The training decoder is a DynamicRNN over the dense target: its
  ``static_rnn`` op reads nothing back to the host, so the training step
  binds and replays as one CUDA graph.
- Generation keeps the beam dimension static (``[batch * beam, ...]``
  states) inside a ``While``, whose condition is read on the host each
  iteration: that Program runs op by op.  Beams are reordered by a gather
  on explicit parent indices.
"""
from __future__ import annotations

from .. import framework, layers
from ..param_attr import ParamAttr
from .. import optimizer as optim

DICT_SIZE = 30000
EMB_DIM = 512
ENCODER_SIZE = 512
DECODER_SIZE = 512
BOS_IDX = 0  # <s>   (reference wmt14 dict layout)
EOS_IDX = 1  # <e>
PAD_IDX = 2  # reuse <unk> slot for padding in the dense layout


def _pad_mask(word_ids, dtype="float32"):
    """[B, S] 1.0 at real tokens, 0.0 at pads (in-graph, no fed bias)."""
    pad = layers.fill_constant(shape=[1], dtype=word_ids.dtype, value=PAD_IDX)
    return layers.cast(layers.logical_not(layers.equal(word_ids, pad)), dtype)


def bi_lstm_encoder(input_seq, gate_size):
    """reference machine_translation.py:57 — forward+backward scan LSTMs."""
    fwd_in = layers.fc(input=input_seq, size=gate_size * 4, act="tanh", bias_attr=False, num_flatten_dims=2)
    fwd, _ = layers.dynamic_lstm(input=fwd_in, size=gate_size * 4, use_peepholes=False)
    bwd_in = layers.fc(input=input_seq, size=gate_size * 4, act="tanh", bias_attr=False, num_flatten_dims=2)
    bwd, _ = layers.dynamic_lstm(input=bwd_in, size=gate_size * 4, is_reverse=True, use_peepholes=False)
    return fwd, bwd


def lstm_step(gate_input, hidden_prev, cell_prev, size):
    """reference machine_translation.py:32 lstm_step: plain LSTM cell math
    on [B, 4D] pre-activations."""
    gates = layers.elementwise_add(
        x=gate_input, y=layers.fc(input=hidden_prev, size=size * 4, bias_attr=False)
    )
    i, f, o, g = layers.split(gates, num_or_sections=4, dim=1)
    i, f, o = layers.sigmoid(i), layers.sigmoid(f), layers.sigmoid(o)
    g = layers.tanh(g)
    cell = layers.elementwise_add(
        x=layers.elementwise_mul(x=f, y=cell_prev), y=layers.elementwise_mul(x=i, y=g)
    )
    hidden = layers.elementwise_mul(x=o, y=layers.tanh(cell))
    return hidden, cell


def simple_attention(encoder_vec, encoder_proj, decoder_state, attn_bias, decoder_size):
    """Additive (Bahdanau) attention (reference machine_translation.py:106).
    ``attn_bias`` is [B, S] with -1e9 at source pads."""
    state_proj = layers.fc(input=decoder_state, size=decoder_size, bias_attr=False)
    state_ex = layers.unsqueeze(state_proj, axes=[1])  # [B,1,D]
    mix = layers.tanh(x=layers.elementwise_add(x=encoder_proj, y=state_ex))
    e = layers.fc(input=mix, size=1, num_flatten_dims=2, bias_attr=False)  # [B,S,1]
    e = layers.squeeze(e, axes=[2])
    e = layers.elementwise_add(x=e, y=attn_bias)
    w = layers.softmax(e)  # [B,S]
    w = layers.unsqueeze(w, axes=[2])
    ctx = layers.reduce_sum(layers.elementwise_mul(x=encoder_vec, y=w), dim=1)  # [B,H]
    return ctx


def _encode(src_word, embedding_dim, encoder_size, decoder_size, source_dict_dim):
    src_mask = _pad_mask(src_word)  # [B,S]
    attn_bias = layers.scale(x=src_mask, scale=1e9, bias=-1e9)  # 0 real, -1e9 pad
    src_emb = layers.embedding(
        input=src_word, size=[source_dict_dim, embedding_dim], padding_idx=PAD_IDX
    )
    fwd, bwd = bi_lstm_encoder(src_emb, encoder_size)
    encoder_vec = layers.concat([fwd, bwd], axis=2)  # [B,S,2H]
    encoder_proj = layers.fc(
        input=encoder_vec, size=decoder_size, bias_attr=False, num_flatten_dims=2
    )
    backward_first = layers.sequence_first_step(bwd)
    decoder_boot = layers.fc(input=backward_first, size=decoder_size, act="tanh", bias_attr=False)
    return encoder_vec, encoder_proj, decoder_boot, attn_bias


def train_decoder(trg_word, encoder_vec, encoder_proj, decoder_boot, attn_bias,
                  embedding_dim, decoder_size, target_dict_dim):
    trg_emb = layers.embedding(
        input=trg_word, size=[target_dict_dim, embedding_dim], padding_idx=PAD_IDX
    )
    cell_boot = layers.fill_constant_batch_size_like(
        input=decoder_boot, shape=[-1, decoder_size], dtype="float32", value=0.0
    )
    rnn = layers.DynamicRNN()
    with rnn.block():
        current_word = rnn.step_input(trg_emb)  # [B, emb]
        hidden_mem = rnn.memory(init=decoder_boot)
        cell_mem = rnn.memory(init=cell_boot)
        context = simple_attention(encoder_vec, encoder_proj, hidden_mem, attn_bias, decoder_size)
        decoder_in = layers.fc(
            input=layers.concat([context, current_word], axis=1),
            size=decoder_size * 4, bias_attr=False,
        )
        h, c = lstm_step(decoder_in, hidden_mem, cell_mem, decoder_size)
        rnn.update_memory(hidden_mem, h)
        rnn.update_memory(cell_mem, c)
        out = layers.fc(input=h, size=target_dict_dim, act="softmax")
        rnn.output(out)
    return rnn()  # [B, T, V] probabilities


def beam_search_decoder(encoder_vec, encoder_proj, decoder_boot, attn_bias,
                        embedding_dim, decoder_size, target_dict_dim,
                        beam_size, max_length):
    """While-loop beam search (reference test_machine_translation.py decode).
    Beam lanes are folded into the batch axis ([B*beam, ...] states), so
    every step is the decoder math of training."""

    def expand_to_beam(x):
        # [B, ...] -> [B*beam, ...] (lane-major per batch row)
        ex = layers.expand(layers.unsqueeze(x, axes=[1]), [1, beam_size] + [1] * (len(x.shape) - 1))
        return layers.reshape(x=ex, shape=[-1] + [int(d) for d in x.shape[1:]])

    enc_vec = expand_to_beam(encoder_vec)
    enc_proj = expand_to_beam(encoder_proj)
    bias = expand_to_beam(attn_bias)

    init_ids = layers.fill_constant_batch_size_like(
        input=decoder_boot, shape=[-1, beam_size], dtype="int64", value=float(BOS_IDX)
    )
    # lane-0-only start: scores [0, -1e9, -1e9, ...] per row (the reference
    # encodes this in the init lod)
    lane = layers.cumsum(
        layers.fill_constant_batch_size_like(
            input=decoder_boot, shape=[-1, beam_size], dtype="float32", value=1.0
        ),
        axis=1,
    )  # 1..beam
    one = layers.fill_constant(shape=[1], dtype="float32", value=1.0)
    init_scores = layers.scale(
        x=layers.cast(layers.logical_not(layers.equal(lane, one)), "float32"), scale=-1e9
    )

    pre_ids = layers.assign(init_ids)
    pre_scores = layers.assign(init_scores)
    hidden = expand_to_beam(decoder_boot)
    cell = layers.fill_constant_batch_size_like(
        input=hidden, shape=[-1, decoder_size], dtype="float32", value=0.0
    )

    ids_arr = layers.create_array("int64", capacity=max_length)
    scores_arr = layers.create_array("float32", capacity=max_length)
    parents_arr = layers.create_array("int32", capacity=max_length)

    counter = layers.zeros(shape=[1], dtype="int64", force_cpu=True)
    max_len_const = layers.fill_constant(shape=[1], dtype="int64", value=max_length)
    cond = layers.less_than(x=counter, y=max_len_const)

    # per-row iota*beam, to turn [B, beam] parent lanes into flat gather ids
    row_base = layers.scale(
        x=layers.cumsum(
            layers.fill_constant_batch_size_like(
                input=decoder_boot, shape=[-1, 1], dtype="float32", value=1.0
            ),
            axis=0,
        ),
        scale=float(beam_size), bias=-float(beam_size),
    )  # [B,1]: 0, beam, 2*beam, ...

    while_op = layers.While(cond=cond, maxlen=max_length)
    with while_op.block():
        cur_emb = layers.embedding(
            input=pre_ids, size=[target_dict_dim, embedding_dim],
            padding_idx=PAD_IDX, param_attr=ParamAttr(name="trg_embedding"),
        )  # [B, beam, emb]
        cur_emb = layers.reshape(x=cur_emb, shape=[-1, embedding_dim])
        context = simple_attention(enc_vec, enc_proj, hidden, bias, decoder_size)
        decoder_in = layers.fc(
            input=layers.concat([context, cur_emb], axis=1),
            size=decoder_size * 4, bias_attr=False,
        )
        h, c = lstm_step(decoder_in, hidden, cell, decoder_size)
        probs = layers.fc(input=h, size=target_dict_dim, act="softmax")  # [B*beam, V]
        topk_scores, topk_ids = layers.topk(probs, k=beam_size)
        topk_scores = layers.reshape(x=topk_scores, shape=[-1, beam_size, beam_size])
        topk_ids = layers.reshape(x=topk_ids, shape=[-1, beam_size, beam_size])
        acc_scores = layers.elementwise_add(
            x=layers.log(topk_scores), y=layers.unsqueeze(pre_scores, axes=[2])
        )
        sel_ids, sel_scores, parents = layers.beam_search(
            pre_ids, pre_scores, topk_ids, acc_scores, beam_size, EOS_IDX
        )
        layers.array_write(sel_ids, counter, ids_arr)
        layers.array_write(sel_scores, counter, scores_arr)
        layers.array_write(parents, counter, parents_arr)

        # reorder recurrent state by parent lane
        flat_parent = layers.reshape(
            x=layers.elementwise_add(
                x=layers.cast(parents, "float32"), y=row_base, axis=0
            ),
            shape=[-1],
        )
        flat_parent = layers.cast(flat_parent, "int32")
        layers.assign(layers.gather(h, flat_parent), hidden)
        layers.assign(layers.gather(c, flat_parent), cell)
        layers.assign(sel_ids, pre_ids)
        layers.assign(sel_scores, pre_scores)

        layers.increment(x=counter, value=1, in_place=True)
        eos = layers.fill_constant(shape=[1], dtype="int64", value=EOS_IDX)
        alive = layers.reduce_sum(
            layers.cast(layers.logical_not(layers.equal(sel_ids, eos)), "float32")
        )
        zero = layers.fill_constant(shape=[1], dtype="float32", value=0.0)
        keep_going = layers.logical_and(
            x=layers.less_than(x=counter, y=max_len_const),
            y=layers.less_than(x=zero, y=alive),
        )
        layers.assign(keep_going, cond)

    sentence_ids, sentence_scores = layers.beam_search_decode(
        ids_arr, scores_arr, parents_arr, beam_size, EOS_IDX
    )
    return sentence_ids, sentence_scores


def seq_to_seq_net(src_word, trg_word, label, embedding_dim=EMB_DIM,
                   encoder_size=ENCODER_SIZE, decoder_size=DECODER_SIZE,
                   source_dict_dim=DICT_SIZE, target_dict_dim=DICT_SIZE):
    """Training graph (reference machine_translation.py:53 seq_to_seq_net)."""
    encoder_vec, encoder_proj, decoder_boot, attn_bias = _encode(
        src_word, embedding_dim, encoder_size, decoder_size, source_dict_dim
    )
    prediction = train_decoder(
        trg_word, encoder_vec, encoder_proj, decoder_boot, attn_bias,
        embedding_dim, decoder_size, target_dict_dim,
    )
    cost = layers.cross_entropy(input=prediction, label=label)  # [B,T,1]
    trg_mask = layers.unsqueeze(_pad_mask(layers.squeeze(label, axes=[2])), axes=[2])
    masked = layers.elementwise_mul(x=cost, y=trg_mask)
    avg_cost = layers.elementwise_div(
        x=layers.reduce_sum(masked), y=layers.reduce_sum(trg_mask)
    )
    return avg_cost, prediction


def get_model(batch_size=16, seq_len=32, embedding_dim=EMB_DIM,
              encoder_size=ENCODER_SIZE, decoder_size=DECODER_SIZE,
              dict_size=DICT_SIZE, is_generating=False,
              beam_size=3, max_length=50, learning_rate=0.0002):
    main = framework.Program()
    startup = framework.Program()
    with framework.program_guard(main, startup):
        src_word = layers.data(name="src_word", shape=[seq_len], dtype="int64")
        if is_generating:
            enc = _encode(src_word, embedding_dim, encoder_size, decoder_size, dict_size)
            sentence_ids, sentence_scores = beam_search_decoder(
                *enc, embedding_dim, decoder_size, dict_size, beam_size, max_length
            )
            return {
                "main": main, "startup": startup, "feeds": ["src_word"],
                "ids": sentence_ids, "scores": sentence_scores,
            }
        trg_word = layers.data(name="trg_word", shape=[seq_len], dtype="int64")
        label = layers.data(name="label", shape=[seq_len, 1], dtype="int64")
        avg_cost, prediction = seq_to_seq_net(
            src_word, trg_word, label, embedding_dim, encoder_size,
            decoder_size, dict_size, dict_size,
        )
        inference_program = main.clone(for_test=True)
        opt = optim.AdamOptimizer(learning_rate=learning_rate)
        opt.minimize(avg_cost)
    return {
        "main": main, "startup": startup, "test": inference_program,
        "feeds": ["src_word", "trg_word", "label"],
        "loss": avg_cost, "predict": prediction,
    }
