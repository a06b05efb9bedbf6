"""N-gram word2vec language model (reference: the fluid book word2vec
chapter, python/paddle/fluid/tests/book/test_word2vec.py style — four
context-word embeddings concatenated, a sigmoid hidden fc, then a
softmax, NCE or hierarchical-sigmoid output head over the imikolov
vocabulary).

The port's copy of the JAX package's ``paddle_tpu/models/word2vec.py``:
the same Programs.  Each head trains on the card through
``Executor.run``: the softmax, and the sampled NCE and
hierarchical-sigmoid heads (``ops/struct_ops.py``), whose steps bind
into one CUDA graph as the softmax head's do.
"""
from __future__ import annotations

from .. import framework, layers, optimizer as optim
from ..param_attr import ParamAttr

EMB_SIZE = 32
HIDDEN_SIZE = 256
N = 5  # 4 context words -> predict the 5th
VOCAB_SIZE = 2073  # imikolov build_dict size in the reference dataset


def ngram_net(words, vocab_size=VOCAB_SIZE, emb_size=EMB_SIZE, hidden_size=HIDDEN_SIZE,
              dtype="float32"):
    """reference test_word2vec.py inference_program: shared 'shared_w'
    embedding for the 4 context words, concat, sigmoid fc."""
    embs = []
    for w in words:
        embs.append(
            layers.embedding(
                input=w,
                size=[vocab_size, emb_size],
                dtype=dtype,
                param_attr=ParamAttr(name="shared_w"),
            )
        )
    concat = layers.concat(input=embs, axis=1)
    hidden = layers.fc(input=concat, size=hidden_size, act="sigmoid")
    return hidden


def get_model(loss_type="softmax", vocab_size=VOCAB_SIZE, emb_size=EMB_SIZE,
              hidden_size=HIDDEN_SIZE, num_neg_samples=8, lr=1e-3, dtype="float32"):
    """The training Programs (``main``: forward, backward, Adam;
    ``startup``; ``test``, the forward cloned for test), the feed names
    and the loss.  ``dtype`` is the embedding's and so the model's."""
    main = framework.Program()
    startup = framework.Program()
    with framework.program_guard(main, startup):
        names = ["firstw", "secondw", "thirdw", "fourthw"]
        words = [layers.data(name=n, shape=[1], dtype="int64") for n in names]
        next_word = layers.data(name="nextw", shape=[1], dtype="int64")
        hidden = ngram_net(words, vocab_size, emb_size, hidden_size, dtype)
        if loss_type == "softmax":
            predict = layers.fc(input=hidden, size=vocab_size, act="softmax")
            cost = layers.cross_entropy(input=predict, label=next_word)
        elif loss_type == "nce":
            cost = layers.nce(
                input=hidden,
                label=next_word,
                num_total_classes=vocab_size,
                num_neg_samples=num_neg_samples,
            )
        elif loss_type == "hsigmoid":
            cost = layers.hsigmoid(input=hidden, label=next_word, num_classes=vocab_size)
        else:
            raise ValueError("unknown loss_type %r" % (loss_type,))
        avg_cost = layers.mean(cost)
        inference_program = main.clone(for_test=True)
        optim.AdamOptimizer(learning_rate=lr).minimize(avg_cost)
    return {
        "main": main,
        "startup": startup,
        "test": inference_program,
        "feeds": names + ["nextw"],
        "loss": avg_cost,
    }
