"""DeepFM CTR model (reference: the fluid CTR/DeepFM benchmark —
models/fluid/PaddleRec deepfm).

y = sigmoid( w0 + Σ_i w1[f_i]            (first order)
           + ΣΣ_{i<j} <v[f_i], v[f_j]>   (FM second order, computed as
                                          0.5*(  (Σv)² - Σv²  ) — one matmul)
           + MLP(concat v[f_i]) )        (deep part)

The port's copy of the JAX package's ``paddle_tpu/models/deepfm.py``:
the same Programs (``sigmoid_cross_entropy_with_logits``, then ``auc``
over ``sigmoid(logit)`` with its two histogram persistables, Adam).
Field embeddings are gathers from one table; the FM pairwise term uses
the sum-of-squares identity (no O(F²) loop).  ``is_sparse`` is an
attribute of the embeddings that changes nothing here, as in the
reference on one device.
"""
from __future__ import annotations

from .. import framework, layers, optimizer as optim
from ..param_attr import ParamAttr

NUM_FIELDS = 26
SPARSE_FEATURE_DIM = 1000  # ids per field (hashed), reference uses 1e6-1e7
EMBEDDING_DIM = 8


def deepfm_net(feat_ids, embedding_size=EMBEDDING_DIM, sparse_feature_dim=SPARSE_FEATURE_DIM,
               num_fields=NUM_FIELDS, hidden_sizes=(64, 32), is_sparse=True, dtype="float32"):
    """``feat_ids``: int64 [batch, num_fields] — one id per field."""
    # first-order weights: [vocab, 1] table
    w1 = layers.embedding(
        input=feat_ids,
        size=[sparse_feature_dim, 1],
        is_sparse=is_sparse,
        param_attr=ParamAttr(name="deepfm_w1"),
        dtype=dtype,
    )  # [B, F, 1]
    first_order = layers.reduce_sum(w1, dim=1)  # [B, 1]

    # shared factor table: [vocab, k]
    v = layers.embedding(
        input=feat_ids,
        size=[sparse_feature_dim, embedding_size],
        is_sparse=is_sparse,
        param_attr=ParamAttr(name="deepfm_v"),
        dtype=dtype,
    )  # [B, F, k]
    sum_v = layers.reduce_sum(v, dim=1)  # [B, k]
    sum_v_sq = layers.elementwise_mul(sum_v, sum_v)
    v_sq = layers.elementwise_mul(v, v)
    sq_sum_v = layers.reduce_sum(v_sq, dim=1)  # [B, k]
    second_order = layers.scale(
        layers.reduce_sum(layers.elementwise_sub(sum_v_sq, sq_sum_v), dim=1, keep_dim=True),
        scale=0.5,
    )  # [B, 1]

    deep = layers.reshape(v, shape=[-1, num_fields * embedding_size])
    for h in hidden_sizes:
        deep = layers.fc(input=deep, size=h, act="relu")
    deep_out = layers.fc(input=deep, size=1)

    logit = layers.elementwise_add(layers.elementwise_add(first_order, second_order), deep_out)
    return logit


def get_model(batch_size=256, embedding_size=EMBEDDING_DIM, sparse_feature_dim=SPARSE_FEATURE_DIM,
              num_fields=NUM_FIELDS, lr=1e-3, is_sparse=True, dtype="float32"):
    """The training Programs (``main``: forward, ``auc``, backward, Adam;
    ``startup``; ``test``, cloned for test before the optimizer), the
    feed names, the loss, the AUC and the predicted click probability.
    ``dtype`` is the embeddings' and the label's, and so the model's
    (the AUC's histograms stay float32)."""
    main = framework.Program()
    startup = framework.Program()
    with framework.program_guard(main, startup):
        feat_ids = layers.data(name="feat_ids", shape=[num_fields], dtype="int64")
        label = layers.data(name="label", shape=[1], dtype=dtype)
        logit = deepfm_net(feat_ids, embedding_size, sparse_feature_dim, num_fields,
                           is_sparse=is_sparse, dtype=dtype)
        loss = layers.sigmoid_cross_entropy_with_logits(x=logit, label=label)
        avg_cost = layers.mean(loss)
        predict = layers.sigmoid(logit)
        auc, _auc_states = layers.auc(input=predict, label=layers.cast(x=label, dtype="int64"))
        inference_program = main.clone(for_test=True)
        optim.AdamOptimizer(learning_rate=lr).minimize(avg_cost)
    return {
        "main": main,
        "startup": startup,
        "test": inference_program,
        "feeds": ["feat_ids", "label"],
        "loss": avg_cost,
        "auc": auc,
        "predict": predict,
    }
