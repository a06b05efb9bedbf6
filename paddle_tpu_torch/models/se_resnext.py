"""SE-ResNeXt-50/101/152 (reference: benchmark/fluid/models/se_resnext.py).

The port's copy of the JAX package's ``paddle_tpu/models/se_resnext.py``:
the same Programs (grouped-convolution bottlenecks with
squeeze-and-excitation, global average pooling, dropout, a softmax fc,
cross entropy, accuracy, momentum), which the port's ``Executor.run``
trains on the card.  The convolutions are cuDNN's there; no kernel of
this repo runs.
"""
from __future__ import annotations

from .. import framework, layers, optimizer as optim


def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1, act=None, is_train=True):
    conv = layers.conv2d(
        input=input,
        num_filters=num_filters,
        filter_size=filter_size,
        stride=stride,
        padding=(filter_size - 1) // 2,
        groups=groups,
        act=None,
        bias_attr=False,
    )
    return layers.batch_norm(input=conv, act=act, is_test=not is_train)


def squeeze_excitation(input, num_channels, reduction_ratio):
    pool = layers.pool2d(input=input, pool_type="avg", global_pooling=True)
    squeeze = layers.fc(input=pool, size=num_channels // reduction_ratio, act="relu")
    excitation = layers.fc(input=squeeze, size=num_channels, act="sigmoid")
    scale = layers.elementwise_mul(x=input, y=excitation, axis=0)
    return scale


def shortcut(input, ch_out, stride, is_train=True):
    ch_in = input.shape[1]
    if ch_in != ch_out or stride != 1:
        filter_size = 1
        return conv_bn_layer(input, ch_out, filter_size, stride, is_train=is_train)
    return input


def bottleneck_block(input, num_filters, stride, cardinality, reduction_ratio, is_train=True):
    conv0 = conv_bn_layer(input=input, num_filters=num_filters, filter_size=1, act="relu", is_train=is_train)
    conv1 = conv_bn_layer(
        input=conv0, num_filters=num_filters, filter_size=3, stride=stride,
        groups=cardinality, act="relu", is_train=is_train,
    )
    conv2 = conv_bn_layer(input=conv1, num_filters=num_filters * 2, filter_size=1, act=None, is_train=is_train)
    scale = squeeze_excitation(input=conv2, num_channels=num_filters * 2, reduction_ratio=reduction_ratio)
    short = shortcut(input, num_filters * 2, stride, is_train=is_train)
    return layers.elementwise_add(x=short, y=scale, act="relu")


def SE_ResNeXt(input, class_dim, depth=50, is_train=True):
    cfg = {
        50: ([3, 4, 6, 3], 32, 16),
        101: ([3, 4, 23, 3], 32, 16),
        152: ([3, 8, 36, 3], 64, 16),
    }
    stages, cardinality, reduction_ratio = cfg[depth]
    if depth in (50, 101):
        num_filters_list = [128, 256, 512, 1024]
        conv = conv_bn_layer(input=input, num_filters=64, filter_size=7, stride=2, act="relu", is_train=is_train)
        conv = layers.pool2d(input=conv, pool_size=3, pool_stride=2, pool_padding=1, pool_type="max")
    else:
        num_filters_list = [128, 256, 512, 1024]
        conv = conv_bn_layer(input=input, num_filters=64, filter_size=3, stride=2, act="relu", is_train=is_train)
        conv = conv_bn_layer(input=conv, num_filters=64, filter_size=3, stride=1, act="relu", is_train=is_train)
        conv = conv_bn_layer(input=conv, num_filters=128, filter_size=3, stride=1, act="relu", is_train=is_train)
        conv = layers.pool2d(input=conv, pool_size=3, pool_stride=2, pool_padding=1, pool_type="max")

    for block in range(len(stages)):
        for i in range(stages[block]):
            conv = bottleneck_block(
                input=conv,
                num_filters=num_filters_list[block],
                stride=2 if i == 0 and block != 0 else 1,
                cardinality=cardinality,
                reduction_ratio=reduction_ratio,
                is_train=is_train,
            )

    pool = layers.pool2d(input=conv, pool_size=7, pool_type="avg", global_pooling=True)
    drop = layers.dropout(x=pool, dropout_prob=0.2)
    out = layers.fc(input=drop, size=class_dim, act="softmax")
    return out


def get_model(batch_size=32, class_dim=1000, depth=50, image_shape=(3, 224, 224), lr=0.1,
              dtype="float32"):
    """The training Programs (``main``: forward, backward, momentum 0.9;
    ``startup``; ``test``, the forward cloned for test), the feed names
    and the loss/accuracy/prediction variables.  ``batch_size`` is the
    caller's to feed; ``dtype`` is the images' and so the model's."""
    main = framework.Program()
    startup = framework.Program()
    with framework.program_guard(main, startup):
        image = layers.data(name="data", shape=list(image_shape), dtype=dtype)
        label = layers.data(name="label", shape=[1], dtype="int64")
        predict = SE_ResNeXt(image, class_dim, depth=depth)
        cost = layers.cross_entropy(input=predict, label=label)
        avg_cost = layers.mean(x=cost)
        batch_acc = layers.accuracy(input=predict, label=label)
        inference_program = main.clone(for_test=True)
        opt = optim.MomentumOptimizer(learning_rate=lr, momentum=0.9)
        opt.minimize(avg_cost)
    return {
        "main": main,
        "startup": startup,
        "test": inference_program,
        "feeds": ["data", "label"],
        "loss": avg_cost,
        "acc": batch_acc,
        "predict": predict,
    }
