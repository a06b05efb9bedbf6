"""VGG-16 with batch norm (reference: benchmark/fluid/models/vgg.py).

The port's copy of the JAX package's ``paddle_tpu/models/vgg.py``: the
same Programs (five ``img_conv_group`` blocks of 3x3 convolutions with
batch norm and dropout, two fc layers of 512, a softmax fc, cross
entropy, accuracy, Adam), which the port's ``Executor.run`` trains on
the card.  The convolutions are cuDNN's there; no kernel of this repo
runs.
"""
from __future__ import annotations

from .. import framework, layers, nets, optimizer as optim


def vgg16_bn_drop(input, is_train=True):
    def conv_block(input, num_filter, groups, dropouts):
        return nets.img_conv_group(
            input=input,
            pool_size=2,
            pool_stride=2,
            conv_num_filter=[num_filter] * groups,
            conv_filter_size=3,
            conv_act="relu",
            conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=dropouts,
            pool_type="max",
        )

    conv1 = conv_block(input, 64, 2, [0.3, 0])
    conv2 = conv_block(conv1, 128, 2, [0.4, 0])
    conv3 = conv_block(conv2, 256, 3, [0.4, 0.4, 0])
    conv4 = conv_block(conv3, 512, 3, [0.4, 0.4, 0])
    conv5 = conv_block(conv4, 512, 3, [0.4, 0.4, 0])

    drop = layers.dropout(x=conv5, dropout_prob=0.5)
    fc1 = layers.fc(input=drop, size=512, act=None)
    bn = layers.batch_norm(input=fc1, act="relu", is_test=not is_train)
    drop2 = layers.dropout(x=bn, dropout_prob=0.5)
    fc2 = layers.fc(input=drop2, size=512, act=None)
    return fc2


def get_model(batch_size=64, class_dim=10, image_shape=(3, 32, 32), lr=1e-3,
              dtype="float32"):
    """The training Programs (``main``: forward, backward, Adam;
    ``startup``; ``test``, the forward cloned for test), the feed names
    and the loss/accuracy/prediction variables.  ``batch_size`` is the
    caller's to feed; ``dtype`` is the images' and so the model's."""
    main = framework.Program()
    startup = framework.Program()
    with framework.program_guard(main, startup):
        images = layers.data(name="pixel", shape=list(image_shape), dtype=dtype)
        label = layers.data(name="label", shape=[1], dtype="int64")
        net = vgg16_bn_drop(images)
        predict = layers.fc(input=net, size=class_dim, act="softmax")
        cost = layers.cross_entropy(input=predict, label=label)
        avg_cost = layers.mean(x=cost)
        batch_acc = layers.accuracy(input=predict, label=label)
        inference_program = main.clone(for_test=True)
        opt = optim.AdamOptimizer(learning_rate=lr)
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
