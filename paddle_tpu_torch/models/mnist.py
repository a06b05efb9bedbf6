"""MNIST LeNet (reference: benchmark/fluid/models/mnist.py).

The port's copy of the JAX package's ``paddle_tpu/models/mnist.py``: the
same Program (conv 5x5x20 -> max pool 2 -> conv 5x5x50 -> max pool 2 ->
fc 10 softmax, cross entropy, accuracy, Adam), which the port's
``Executor.run`` trains on the card.
"""
from __future__ import annotations

import numpy as np

from .. import framework, layers, nets, optimizer as optim
from ..initializer import Normal
from ..param_attr import ParamAttr

SEED = 1


def cnn_model(data):
    """conv-pool ×2 + fc, as reference mnist.py:38 cnn_model."""
    conv_pool_1 = nets.simple_img_conv_pool(
        input=data, filter_size=5, num_filters=20, pool_size=2, pool_stride=2, act="relu"
    )
    conv_pool_2 = nets.simple_img_conv_pool(
        input=conv_pool_1, filter_size=5, num_filters=50, pool_size=2, pool_stride=2, act="relu"
    )
    SIZE = 10
    input_shape = conv_pool_2.shape
    param_shape = [int(np.prod(input_shape[1:]))] + [SIZE]
    scale = (2.0 / (param_shape[0] ** 2 * SIZE)) ** 0.5
    predict = layers.fc(
        input=conv_pool_2,
        size=SIZE,
        act="softmax",
        param_attr=ParamAttr(initializer=Normal(loc=0.0, scale=scale)),
    )
    return predict


def get_model(batch_size=128, lr=0.001):
    """The training Programs: ``main`` (forward, backward, Adam),
    ``startup``, ``test`` (the forward cloned for test), the feed names
    and the loss/accuracy/prediction variables.  ``batch_size`` is the
    caller's to feed; the Programs take any batch."""
    main = framework.Program()
    startup = framework.Program()
    with framework.program_guard(main, startup):
        images = layers.data(name="pixel", shape=[1, 28, 28], dtype="float32")
        label = layers.data(name="label", shape=[1], dtype="int64")
        predict = cnn_model(images)
        cost = layers.cross_entropy(input=predict, label=label)
        avg_cost = layers.mean(x=cost)
        batch_acc = layers.accuracy(input=predict, label=label)
        inference_program = main.clone(for_test=True)
        opt = optim.AdamOptimizer(learning_rate=lr, beta1=0.9, beta2=0.999)
        opt.minimize(avg_cost)
    return {
        "main": main,
        "startup": startup,
        "test": inference_program,
        "feeds": ["pixel", "label"],
        "loss": avg_cost,
        "acc": batch_acc,
        "predict": predict,
    }
