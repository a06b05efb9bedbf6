"""Stacked dynamic LSTM for IMDB sentiment
(reference: benchmark/fluid/models/stacked_dynamic_lstm.py).

The port's copy of the JAX package's
``paddle_tpu/models/stacked_dynamic_lstm.py``: the same Programs.  The
reference builds a hand-rolled LSTM from DynamicRNN steps of fc ops; as
in the JAX package, this network is embed 512 -> tanh fc -> a stack of
``dynamic_lstm`` -> last-step pool -> softmax fc.  A ragged feed
(``words`` a ``LoDArray``) keeps the Program off the CUDA graph: each
step runs op by op.
"""
from __future__ import annotations

from .. import framework, layers, optimizer as optim

VOCAB_SIZE = 5147  # imdb.word_dict() size in the reference dataset
LSTM_SIZE = 512
EMB_DIM = 512


def lstm_net(sentence, lstm_size, depth=1):
    """reference stacked_dynamic_lstm.py:31 lstm_net (a DynamicRNN loop)
    as a stack of dynamic_lstm."""
    hidden = layers.fc(input=sentence, size=lstm_size, act="tanh", num_flatten_dims=2)
    for _ in range(depth):
        proj = layers.fc(input=hidden, size=lstm_size * 4, num_flatten_dims=2)
        hidden, _cell = layers.dynamic_lstm(input=proj, size=lstm_size * 4, use_peepholes=False)
    last = layers.sequence_last_step(hidden)
    logit = layers.fc(input=last, size=2, act="softmax")
    return logit


def get_model(batch_size=64, lstm_size=LSTM_SIZE, emb_dim=EMB_DIM, vocab_size=None, depth=1, lr=0.001):
    """The training Programs (``main``: forward, backward, Adam;
    ``startup``; ``test``, the forward cloned for test), the feed names,
    the loss, the batch accuracy and the prediction.  The port has no
    ``dataset`` package, so ``vocab_size=None`` takes ``VOCAB_SIZE``
    (5147, the reference's IMDB dictionary), where the JAX package reads
    ``imdb.word_dict()``."""
    if vocab_size is None:
        vocab_size = VOCAB_SIZE
    main = framework.Program()
    startup = framework.Program()
    with framework.program_guard(main, startup):
        data = layers.data(name="words", shape=[1], lod_level=1, dtype="int64")
        sentence = layers.embedding(input=data, size=[vocab_size, emb_dim])
        logit = lstm_net(sentence, lstm_size, depth=depth)
        label = layers.data(name="label", shape=[1], dtype="int64")
        loss = layers.cross_entropy(input=logit, label=label)
        avg_cost = layers.mean(x=loss)
        batch_acc = layers.accuracy(input=logit, label=label)
        inference_program = main.clone(for_test=True)
        adam = optim.AdamOptimizer(learning_rate=lr)
        adam.minimize(avg_cost)
    return {
        "main": main,
        "startup": startup,
        "test": inference_program,
        "feeds": ["words", "label"],
        "loss": avg_cost,
        "acc": batch_acc,
        "predict": logit,
    }
