"""Semantic role labeling: a stacked bidirectional LSTM and a
linear-chain CRF on CoNLL-05 (reference: python/paddle/fluid/tests/book/
test_label_semantic_roles.py: db_lstm with 8 feature embeddings, a
stack of LSTMs of alternating direction, the CRF loss, Viterbi decode).

The port's copy of the JAX package's
``paddle_tpu/models/label_semantic_roles.py``: the same Programs.  Each
LSTM is a Python loop over the padded batch (``ops/sequence_ops.py``),
the CRF's forward algorithm and Viterbi pass loops over the steps
(``ops/struct_ops.py``); the decode shares the CRF's transition
parameter ``crfw``.  All 8 feeds are ragged (``LoDArray``s), so a
training step runs op by op.
"""
from __future__ import annotations

from .. import framework, layers, optimizer as optim
from ..param_attr import ParamAttr

WORD_DIM = 32
MARK_DIM = 5
HIDDEN = 128
DEPTH = 4  # stacked LSTM layers (alternating direction), reference depth=8

# CoNLL-05's sizes as the JAX package's synthetic dataset gives them
# (paddle_tpu/dataset/conll05.py:29-32).  The port has no ``dataset``
# package yet (ROADMAP A12); with the real dictionaries under DATA_HOME
# the JAX package reads their sizes instead.
WORD_VOCAB = 4000
MARK_DICT_LEN = 2
LABEL_VOCAB = 11  # 5 chunk types, B- and I- each, and O

FEED_NAMES = ["word", "ctx_n2", "ctx_n1", "ctx_0", "ctx_p1", "ctx_p2", "mark"]


def db_lstm(word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, mark,
            word_dict_len, mark_dict_len, depth=DEPTH, hidden_dim=HIDDEN):
    """Stacked bi-directional LSTM feature tower -> per-step tag scores."""
    word_slots = [word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2]
    embs = [
        layers.embedding(
            input=w, size=[word_dict_len, WORD_DIM], dtype="float32")
        for w in word_slots
    ]
    embs.append(layers.embedding(
        input=mark, size=[mark_dict_len, MARK_DIM], dtype="float32"))

    hidden_0 = layers.sums(
        [layers.fc(input=e, size=hidden_dim, num_flatten_dims=2) for e in embs])
    lstm_0, _ = layers.dynamic_lstm(
        input=layers.fc(input=hidden_0, size=hidden_dim * 4, num_flatten_dims=2),
        size=hidden_dim * 4,
    )

    inputs = [hidden_0, lstm_0]
    for i in range(1, depth):
        mix = layers.sums([
            layers.fc(input=inputs[0], size=hidden_dim, num_flatten_dims=2),
            layers.fc(input=inputs[1], size=hidden_dim, num_flatten_dims=2),
        ])
        lstm, _ = layers.dynamic_lstm(
            input=layers.fc(input=mix, size=hidden_dim * 4, num_flatten_dims=2),
            size=hidden_dim * 4,
            is_reverse=(i % 2) == 1,
        )
        inputs = [mix, lstm]

    return layers.sums([
        layers.fc(input=inputs[0], size=LABEL_VOCAB, num_flatten_dims=2),
        layers.fc(input=inputs[1], size=LABEL_VOCAB, num_flatten_dims=2),
    ])


def get_model(lr=1e-2, depth=DEPTH, hidden_dim=HIDDEN):
    """Build the SRL model; returns a dict with keys
    ``main``/``startup``/``feeds``/``loss``/``decode`` (the Viterbi
    path of the main Program's emissions)."""
    main, startup = framework.Program(), framework.Program()
    with framework.program_guard(main, startup):
        feats = [
            layers.data(name=n, shape=[1], dtype="int64", lod_level=1)
            for n in FEED_NAMES
        ]
        label = layers.data(name="target", shape=[1], dtype="int64", lod_level=1)

        feature_out = db_lstm(*feats, word_dict_len=WORD_VOCAB,
                              mark_dict_len=MARK_DICT_LEN, depth=depth,
                              hidden_dim=hidden_dim)
        crf_cost = layers.linear_chain_crf(
            input=feature_out, label=label,
            param_attr=ParamAttr(name="crfw"))
        avg_cost = layers.reduce_mean(crf_cost)
        decode = layers.crf_decoding(
            input=feature_out, param_attr=ParamAttr(name="crfw"))
        optim.SGD(learning_rate=lr).minimize(avg_cost)

    return {"main": main, "startup": startup,
            "feeds": FEED_NAMES + ["target"],
            "loss": avg_cost, "decode": decode}
