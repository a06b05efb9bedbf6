"""ResNet-50/101/152 and the CIFAR-10 ResNets (reference:
benchmark/fluid/models/resnet.py).

The port's copy of the JAX package's ``paddle_tpu/models/resnet.py``: the
same Programs (conv + batch_norm blocks, bottleneck or basic residual
blocks, global average pooling, fc softmax, cross entropy, accuracy,
momentum), which the port's ``Executor.run`` trains on the card.  The
convolutions are cuDNN's there and batch_norm is torch ops; no kernel of
this repo runs.
"""
from __future__ import annotations

from .. import framework, layers, optimizer as optim


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act="relu", is_train=True):
    conv1 = layers.conv2d(
        input=input,
        filter_size=filter_size,
        num_filters=ch_out,
        stride=stride,
        padding=padding,
        act=None,
        bias_attr=False,
    )
    return layers.batch_norm(input=conv1, act=act, is_test=not is_train)


def shortcut(input, ch_out, stride, is_train=True):
    ch_in = input.shape[1]
    if ch_in != ch_out:
        return conv_bn_layer(input, ch_out, 1, stride, 0, None, is_train=is_train)
    return input


def basicblock(input, ch_out, stride, is_train=True):
    short = shortcut(input, ch_out, stride, is_train=is_train)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1, is_train=is_train)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None, is_train=is_train)
    return layers.elementwise_add(x=short, y=conv2, act="relu")


def bottleneck(input, ch_out, stride, is_train=True):
    short = shortcut(input, ch_out * 4, stride, is_train=is_train)
    conv1 = conv_bn_layer(input, ch_out, 1, stride, 0, is_train=is_train)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, is_train=is_train)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, act=None, is_train=is_train)
    return layers.elementwise_add(x=short, y=conv3, act="relu")


def layer_warp(block_func, input, ch_out, count, stride, is_train=True):
    res_out = block_func(input, ch_out, stride, is_train=is_train)
    for i in range(count - 1):
        res_out = block_func(res_out, ch_out, 1, is_train=is_train)
    return res_out


def resnet_imagenet(input, class_dim, depth=50, is_train=True):
    cfg = {
        18: ([2, 2, 2, 2], basicblock),
        34: ([3, 4, 6, 3], basicblock),
        50: ([3, 4, 6, 3], bottleneck),
        101: ([3, 4, 23, 3], bottleneck),
        152: ([3, 8, 36, 3], bottleneck),
    }
    stages, block_func = cfg[depth]
    conv1 = conv_bn_layer(input, ch_out=64, filter_size=7, stride=2, padding=3, is_train=is_train)
    pool1 = layers.pool2d(input=conv1, pool_type="max", pool_size=3, pool_stride=2, pool_padding=1)
    res1 = layer_warp(block_func, pool1, 64, stages[0], 1, is_train=is_train)
    res2 = layer_warp(block_func, res1, 128, stages[1], 2, is_train=is_train)
    res3 = layer_warp(block_func, res2, 256, stages[2], 2, is_train=is_train)
    res4 = layer_warp(block_func, res3, 512, stages[3], 2, is_train=is_train)
    pool2 = layers.pool2d(input=res4, pool_size=7, pool_type="avg", pool_stride=1, global_pooling=True)
    out = layers.fc(input=pool2, size=class_dim, act="softmax")
    return out


def resnet_cifar10(input, class_dim, depth=32, is_train=True):
    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(input=input, ch_out=16, filter_size=3, stride=1, padding=1, is_train=is_train)
    res1 = layer_warp(basicblock, conv1, 16, n, 1, is_train=is_train)
    res2 = layer_warp(basicblock, res1, 32, n, 2, is_train=is_train)
    res3 = layer_warp(basicblock, res2, 64, n, 2, is_train=is_train)
    pool = layers.pool2d(input=res3, pool_size=8, pool_type="avg", pool_stride=1, global_pooling=True)
    out = layers.fc(input=pool, size=class_dim, act="softmax")
    return out


def get_model(batch_size=32, class_dim=1000, depth=50, image_shape=(3, 224, 224), lr=0.1, dtype="float32"):
    """The training Programs: ``main`` (forward, backward, momentum 0.9),
    ``startup``, ``test`` (the forward cloned for test: batch_norm on its
    running statistics), the feed names and the loss/accuracy/prediction
    variables.  ``batch_size`` is the caller's to feed; the Programs take
    any batch."""
    main = framework.Program()
    startup = framework.Program()
    with framework.program_guard(main, startup):
        image = layers.data(name="data", shape=list(image_shape), dtype=dtype)
        label = layers.data(name="label", shape=[1], dtype="int64")
        predict = resnet_imagenet(image, class_dim, depth=depth)
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
