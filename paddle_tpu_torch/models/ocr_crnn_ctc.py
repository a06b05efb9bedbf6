"""CRNN-CTC OCR model (reference: the fluid OCR recognition benchmark,
models/fluid/ocr_recognition/crnn_ctc_model.py style: conv-bn-pool
groups, ``im2sequence``, a bidirectional GRU, an fc, ``warpctc``).

The port's copy of the JAX package's ``paddle_tpu/models/ocr_crnn_ctc.py``:
the same Programs.  The image's columns become the time steps
(``im2sequence``), each GRU direction is a Python loop over them
(``ops/sequence_ops.py``) and CTC a loop over the frames
(``ops/struct_ops.py``); the greedy decoder and the edit distance give
the evaluation path.  The label is a ragged feed (a ``LoDArray``), so a
training step runs op by op.
"""
from __future__ import annotations

from .. import framework, layers, optimizer as optim

NUM_CLASSES = 95  # ASCII printable charset, blank = NUM_CLASSES
DATA_SHAPE = [1, 48, 384]  # C, H, W


def conv_bn_pool(input, group, out_ch, pool_stride=2):
    tmp = input
    for i in range(group):
        tmp = layers.conv2d(
            input=tmp,
            num_filters=out_ch,
            filter_size=3,
            padding=1,
            bias_attr=False,
            act=None,
        )
        tmp = layers.batch_norm(input=tmp, act="relu")
    if pool_stride:
        tmp = layers.pool2d(
            input=tmp, pool_size=2, pool_type="max", pool_stride=pool_stride
        )
    return tmp


def encoder_net(images, rnn_hidden_size=200, num_classes=NUM_CLASSES):
    # 4 conv groups: 48x384 -> 24x192 -> 12x96 -> 6x48 -> 3x24
    tmp = conv_bn_pool(images, 2, 16)
    tmp = conv_bn_pool(tmp, 2, 32)
    tmp = conv_bn_pool(tmp, 2, 64)
    conv_features = conv_bn_pool(tmp, 2, 128)
    # [B, 128, 3, 24] -> the columns as time steps: full-height windows
    sliced_feature = layers.im2sequence(
        input=conv_features, stride=[1, 1], filter_size=[conv_features.shape[2], 1]
    )  # [B, W', C*H]
    fc_1 = layers.fc(input=sliced_feature, size=rnn_hidden_size * 3, num_flatten_dims=2)
    fc_2 = layers.fc(input=sliced_feature, size=rnn_hidden_size * 3, num_flatten_dims=2)
    gru_forward = layers.dynamic_gru(input=fc_1, size=rnn_hidden_size, candidate_activation="relu")
    gru_backward = layers.dynamic_gru(
        input=fc_2, size=rnn_hidden_size, candidate_activation="relu", is_reverse=True
    )
    fc_out = layers.fc(
        input=[gru_forward, gru_backward],
        size=num_classes + 1,
        num_flatten_dims=2,
    )
    return fc_out


def ctc_train_net(images, label, lr=1e-3, rnn_hidden_size=200, num_classes=NUM_CLASSES):
    fc_out = encoder_net(images, rnn_hidden_size=rnn_hidden_size, num_classes=num_classes)
    cost = layers.warpctc(input=fc_out, label=label, blank=num_classes, norm_by_times=True)
    sum_cost = layers.reduce_sum(cost)
    decoded_out = layers.ctc_greedy_decoder(input=fc_out, blank=num_classes)
    casted_label = layers.cast(x=label, dtype="int64")
    error, seq_num = layers.edit_distance(input=decoded_out, label=casted_label)
    return sum_cost, error, seq_num, fc_out


def get_model(batch_size=16, lr=1e-3, data_shape=None, rnn_hidden_size=200, num_classes=NUM_CLASSES):
    """The training Programs (``main``: forward, backward, Adam;
    ``startup``; ``test``, the forward cloned for test before Adam), the
    feed names, the summed CTC loss, the edit distance and sequence
    count of the greedy decode, and the logits."""
    main = framework.Program()
    startup = framework.Program()
    with framework.program_guard(main, startup):
        images = layers.data(name="pixel", shape=list(data_shape or DATA_SHAPE), dtype="float32")
        label = layers.data(name="label", shape=[1], lod_level=1, dtype="int64")
        sum_cost, error, seq_num, fc_out = ctc_train_net(
            images, label, lr, rnn_hidden_size=rnn_hidden_size, num_classes=num_classes)
        inference_program = main.clone(for_test=True)
        optim.AdamOptimizer(learning_rate=lr).minimize(sum_cost)
    return {
        "main": main,
        "startup": startup,
        "test": inference_program,
        "feeds": ["pixel", "label"],
        "loss": sum_cost,
        "error": error,
        "seq_num": seq_num,
        "logits": fc_out,
    }
