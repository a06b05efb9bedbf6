"""Composite networks (reference: python/paddle/fluid/nets.py).

The port's copy of the JAX package's ``paddle_tpu/nets.py``, for the
helpers whose ops the port runs: ``simple_img_conv_pool`` (conv2d +
pool2d), ``img_conv_group`` (conv2d, batch_norm where
``conv_with_batchnorm`` asks, dropout, pool2d) and
``scaled_dot_product_attention``.  ``sequence_conv_pool`` and ``glu``
wait for the sequence ops and split/sigmoid (ROADMAP A10).
"""
from __future__ import annotations

from . import layers

__all__ = [
    "simple_img_conv_pool",
    "scaled_dot_product_attention",
    "img_conv_group",
]


def simple_img_conv_pool(
    input,
    num_filters,
    filter_size,
    pool_size,
    pool_stride,
    pool_padding=0,
    pool_type="max",
    global_pooling=False,
    conv_stride=1,
    conv_padding=0,
    conv_dilation=1,
    conv_groups=1,
    param_attr=None,
    bias_attr=None,
    act=None,
    use_cudnn=True,
    use_mkldnn=False,
):
    """One conv2d followed by one pool2d (LeNet-style building block)."""
    conv_out = layers.conv2d(
        input=input,
        num_filters=num_filters,
        filter_size=filter_size,
        stride=conv_stride,
        padding=conv_padding,
        dilation=conv_dilation,
        groups=conv_groups,
        param_attr=param_attr,
        bias_attr=bias_attr,
        act=act,
    )
    return layers.pool2d(
        input=conv_out,
        pool_size=pool_size,
        pool_type=pool_type,
        pool_stride=pool_stride,
        pool_padding=pool_padding,
        global_pooling=global_pooling,
    )


def img_conv_group(
    input,
    conv_num_filter,
    pool_size,
    conv_padding=1,
    conv_filter_size=3,
    conv_act=None,
    param_attr=None,
    conv_with_batchnorm=False,
    conv_batchnorm_drop_rate=0.0,
    pool_stride=1,
    pool_type="max",
    use_cudnn=True,
    use_mkldnn=False,
):
    """VGG-style block: a stack of conv layers (each optionally followed by
    batch norm + dropout, with the activation moved onto the batch norm),
    capped by a single pooling layer.

    ``conv_num_filter`` is a list — one entry per conv.  Every other
    per-conv setting may be given either as one value (applied to every
    conv) or as a list of the same length.
    """
    if not isinstance(conv_num_filter, (list, tuple)):
        raise TypeError("conv_num_filter must be a list/tuple of filter counts")
    depth = len(conv_num_filter)

    def broadcast(setting):
        """One value -> repeated per conv; a list must match the depth."""
        if hasattr(setting, "__len__"):
            if len(setting) != depth:
                raise ValueError(
                    "per-conv setting %r has length %d, want %d"
                    % (setting, len(setting), depth)
                )
            return list(setting)
        return [setting] * depth

    layer_configs = zip(
        conv_num_filter,
        broadcast(conv_filter_size),
        broadcast(conv_padding),
        broadcast(param_attr),
        broadcast(conv_with_batchnorm),
        broadcast(conv_batchnorm_drop_rate),
    )

    x = input
    for filters, fsize, pad, attr, with_bn, drop_rate in layer_configs:
        x = layers.conv2d(
            input=x,
            num_filters=filters,
            filter_size=fsize,
            padding=pad,
            param_attr=attr,
            act=None if with_bn else conv_act,
        )
        if with_bn:
            x = layers.batch_norm(input=x, act=conv_act)
            if abs(drop_rate) > 1e-5:
                x = layers.dropout(x=x, dropout_prob=drop_rate)

    return layers.pool2d(
        input=x, pool_size=pool_size, pool_type=pool_type, pool_stride=pool_stride
    )


def scaled_dot_product_attention(queries, keys, values, num_heads=1, dropout_rate=0.0):
    """Multi-head scaled dot-product attention over [batch, len, d] inputs;
    returns [batch, q_len, d_v]."""
    for name, t in (("queries", queries), ("keys", keys), ("values", values)):
        if len(t.shape) != 3:
            raise ValueError("%s must be 3-D [batch, len, hidden]" % name)
    if queries.shape[-1] != keys.shape[-1]:
        raise ValueError("queries and keys must have the same hidden size")
    if keys.shape[1] != values.shape[1]:
        raise ValueError("keys and values must have the same length")
    if queries.shape[-1] % num_heads or values.shape[-1] % num_heads:
        raise ValueError("hidden size must be divisible by num_heads")

    def to_heads(x):
        """[b, t, d] -> [b, heads, t, d/heads] (identity for one head)."""
        if num_heads == 1:
            return x
        b, t, d = x.shape
        x = layers.reshape(x=x, shape=[b if b > 0 else -1, t, num_heads, d // num_heads])
        return layers.transpose(x=x, perm=[0, 2, 1, 3])

    def from_heads(x):
        """Inverse of to_heads."""
        if len(x.shape) == 3:
            return x
        x = layers.transpose(x, perm=[0, 2, 1, 3])
        b, t, h, d = x.shape
        return layers.reshape(x=x, shape=[b if b > 0 else -1, t, h * d])

    depth_per_head = keys.shape[-1] // num_heads
    q = layers.scale(x=to_heads(queries), scale=depth_per_head**-0.5)
    scores = layers.matmul(x=q, y=to_heads(keys), transpose_y=True)
    weights = layers.softmax(scores)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate, is_test=False)
    return from_heads(layers.matmul(weights, to_heads(values)))
