"""Neural-network layers (reference: python/paddle/fluid/layers/nn.py).

The port's copy of the JAX package's layer functions: each builds
graph ops via LayerHelper, with the reference's signatures, so a model
builds the same Program in both packages.  The port's op rules live in
paddle_tpu_torch/ops/; an op without a rule builds but raises
``NotImplementedError`` when the Executor reaches it.
"""
from __future__ import annotations

import numpy as np

from ..framework import Variable
from ..initializer import Constant
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = [
    "fc",
    "warpctc",
    "ctc_greedy_decoder",
    "edit_distance",
    "linear_chain_crf",
    "crf_decoding",
    "chunk_eval",
    "nce",
    "hsigmoid",
    "flash_attention",
    "switch_moe",
    "beam_search",
    "beam_search_decode",
    "embedding",
    "dropout",
    "cross_entropy",
    "square_error_cost",
    "softmax",
    "conv2d",
    "conv3d",
    "pool2d",
    "pool3d",
    "batch_norm",
    "layer_norm",
    "conv2d_transpose",
    "conv3d_transpose",
    "reduce_sum",
    "reduce_mean",
    "reduce_max",
    "reduce_min",
    "reduce_prod",
    "split",
    "l2_normalize",
    "matmul",
    "topk",
    "transpose",
    "softmax_with_cross_entropy",
    "smooth_l1",
    "one_hot",
    "autoincreased_step_counter",
    "reshape",
    "squeeze",
    "unsqueeze",
    "lrn",
    "pad",
    "pad_constant_like",
    "label_smooth",
    "roi_pool",
    "dice_loss",
    "image_resize",
    "image_resize_short",
    "resize_bilinear",
    "gather",
    "scatter",
    "random_crop",
    "mean_iou",
    "relu",
    "log",
    "crop",
    "rank_loss",
    "margin_rank_loss",
    "elu",
    "relu6",
    "pow",
    "stanh",
    "hard_sigmoid",
    "swish",
    "prelu",
    "brelu",
    "leaky_relu",
    "soft_relu",
    "flatten",
    "stack",
    "unstack",
    "pad2d",
    "expand",
    "uniform_random_batch_size_like",
    "gaussian_random",
    "sampling_id",
    "gaussian_random_batch_size_like",
    "sum",
    "slice",
    "shape",
    "scale",
    "elementwise_add",
    "elementwise_div",
    "elementwise_sub",
    "elementwise_mul",
    "elementwise_max",
    "elementwise_min",
    "elementwise_pow",
    "logical_and",
    "logical_or",
    "logical_xor",
    "logical_not",
    "clip",
    "clip_by_norm",
    "mean",
    "mul",
    "sigmoid_cross_entropy_with_logits",
    "maxout",
    "multiplex",
    "cos_sim",
    "dropout",
    "im2sequence",
    "log_loss",
    "huber_loss",
]


def fc(
    input,
    size,
    num_flatten_dims=1,
    param_attr=None,
    bias_attr=None,
    act=None,
    is_test=False,
    name=None,
):
    """Fully connected (reference nn.py:130 ``fc``): one mul op per input
    (MXU matmul), summed, plus bias & activation (fused by XLA)."""
    helper = LayerHelper("fc", **locals())
    dtype = helper.input_dtype()
    mul_results = []
    for input_var, p_attr in helper.iter_inputs_and_params():
        in_shape = input_var.shape
        param_shape = [int(np.prod(in_shape[num_flatten_dims:]))] + [size]
        w = helper.create_parameter(attr=p_attr, shape=param_shape, dtype=dtype)
        out_shape = (list(in_shape[:num_flatten_dims]) + [size]) if in_shape is not None else None
        tmp = helper.create_variable_for_type_inference(dtype, shape=out_shape)
        helper.append_op(
            type="mul",
            inputs={"X": [input_var], "Y": [w]},
            outputs={"Out": [tmp]},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
        )
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(dtype, shape=mul_results[0].shape)
        helper.append_op(type="sum", inputs={"X": mul_results}, outputs={"Out": [pre_bias]})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False, padding_idx=None, param_attr=None, dtype="float32"):
    """Lookup table (reference nn.py:268).  is_sparse selects the sparse-grad
    pserver path when running under the distribute transpiler; on a single
    TPU it is a dense gather (one-hot matmul on MXU for small vocab)."""
    helper = LayerHelper("embedding", **locals())
    w = helper.create_parameter(attr=helper.param_attr, shape=size, dtype=dtype, is_bias=False)
    if input.shape is None:
        out_shape = None
    elif len(input.shape) and input.shape[-1] == 1:
        out_shape = list(input.shape[:-1]) + [size[1]]  # trailing id dim folds away
    else:
        out_shape = list(input.shape) + [size[1]]
    tmp = helper.create_variable_for_type_inference(dtype, shape=out_shape)
    padding_idx = -1 if padding_idx is None else (padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    helper.append_op(
        type="lookup_table",
        inputs={"Ids": [input], "W": [w]},
        outputs={"Out": [tmp]},
        attrs={"is_sparse": is_sparse, "is_distributed": is_distributed, "padding_idx": padding_idx},
    )
    return tmp


def dropout(x, dropout_prob, is_test=False, seed=None, name=None, dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype, shape=x.shape)
    mask = helper.create_variable_for_type_inference(dtype=x.dtype, shape=x.shape, stop_gradient=True)
    helper.append_op(
        type="dropout",
        inputs={"X": [x]},
        outputs={"Out": [out], "Mask": [mask]},
        attrs={
            "dropout_prob": dropout_prob,
            "is_test": is_test,
            "seed": seed if seed is not None else 0,
            "dropout_implementation": dropout_implementation,
        },
    )
    return out


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="cross_entropy",
        inputs={"X": [input], "Label": [label]},
        outputs={"Y": [out]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index},
    )
    return out


def square_error_cost(input, label):
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(dtype=input.dtype, shape=input.shape)
    helper.append_op(type="square_error_cost", inputs={"X": [input], "Y": [label]}, outputs={"Out": [out]})
    return out


def softmax(input, param_attr=None, bias_attr=None, use_cudnn=True, name=None):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype, shape=input.shape)
    helper.append_op(type="softmax", inputs={"X": [input]}, outputs={"Out": [out]})
    return out


def _conv_out_size(in_size, k, pad, stride, dilation=1):
    if in_size is None or in_size < 0:
        return -1
    return (in_size + 2 * pad - (dilation * (k - 1) + 1)) // stride + 1


def conv2d(
    input,
    num_filters,
    filter_size,
    stride=1,
    padding=0,
    dilation=1,
    groups=None,
    param_attr=None,
    bias_attr=None,
    use_cudnn=True,
    use_mkldnn=False,
    act=None,
    name=None,
):
    """2-D convolution (reference nn.py:1557 conv2d / operators/conv_op.cc).
    Lowered to lax.conv_general_dilated → MXU."""
    helper = LayerHelper("conv2d", **locals())
    dtype = helper.input_dtype()
    groups = groups or 1
    num_channels = input.shape[1]
    fsize = filter_size if isinstance(filter_size, (list, tuple)) else [filter_size] * 2
    stride_ = stride if isinstance(stride, (list, tuple)) else [stride] * 2
    padding_ = padding if isinstance(padding, (list, tuple)) else [padding] * 2
    dilation_ = dilation if isinstance(dilation, (list, tuple)) else [dilation] * 2
    filter_shape = [num_filters, num_channels // groups] + list(fsize)

    fan_in = (num_channels // groups) * int(np.prod(fsize))
    from ..initializer import Normal

    default_init = Normal(0.0, (2.0 / fan_in) ** 0.5)
    w = helper.create_parameter(attr=helper.param_attr, shape=filter_shape, dtype=dtype, default_initializer=default_init)
    out_shape = None
    if input.shape is not None:
        oh = _conv_out_size(input.shape[2], fsize[0], padding_[0], stride_[0], dilation_[0])
        ow = _conv_out_size(input.shape[3], fsize[1], padding_[1], stride_[1], dilation_[1])
        out_shape = [input.shape[0], num_filters, oh, ow]
    pre_bias = helper.create_variable_for_type_inference(dtype, shape=out_shape)
    helper.append_op(
        type="conv2d",
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={
            "strides": list(stride_),
            "paddings": list(padding_),
            "dilations": list(dilation_),
            "groups": groups,
        },
    )
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1, groups=None, param_attr=None, bias_attr=None, use_cudnn=True, act=None, name=None):
    helper = LayerHelper("conv3d", **locals())
    dtype = helper.input_dtype()
    groups = groups or 1
    num_channels = input.shape[1]
    fsize = filter_size if isinstance(filter_size, (list, tuple)) else [filter_size] * 3
    stride_ = stride if isinstance(stride, (list, tuple)) else [stride] * 3
    padding_ = padding if isinstance(padding, (list, tuple)) else [padding] * 3
    dilation_ = dilation if isinstance(dilation, (list, tuple)) else [dilation] * 3
    filter_shape = [num_filters, num_channels // groups] + list(fsize)
    w = helper.create_parameter(attr=helper.param_attr, shape=filter_shape, dtype=dtype)
    out_shape = None
    if input.shape is not None and len(input.shape) == 5:
        spatial = input.shape[2:]
        if all(s and s > 0 for s in spatial):
            out_shape = [input.shape[0], num_filters] + [
                (s + 2 * padding_[i] - dilation_[i] * (fsize[i] - 1) - 1) // stride_[i] + 1
                for i, s in enumerate(spatial)
            ]
    pre_bias = helper.create_variable_for_type_inference(dtype, shape=out_shape)
    helper.append_op(
        type="conv3d",
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": list(stride_), "paddings": list(padding_), "dilations": list(dilation_), "groups": groups},
    )
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool2d(
    input,
    pool_size=-1,
    pool_type="max",
    pool_stride=1,
    pool_padding=0,
    global_pooling=False,
    use_cudnn=True,
    ceil_mode=False,
    use_mkldnn=False,
    name=None,
    exclusive=True,
):
    helper = LayerHelper("pool2d", name=name)
    ksize = pool_size if isinstance(pool_size, (list, tuple)) else [pool_size] * 2
    stride = pool_stride if isinstance(pool_stride, (list, tuple)) else [pool_stride] * 2
    padding = pool_padding if isinstance(pool_padding, (list, tuple)) else [pool_padding] * 2
    out_shape = None
    if input.shape is not None:
        if global_pooling:
            out_shape = [input.shape[0], input.shape[1], 1, 1]
        else:
            hw = []
            for i in range(2):
                s = input.shape[2 + i]
                if s is None or s < 0:
                    hw.append(-1)
                elif ceil_mode:
                    hw.append((s - ksize[i] + 2 * padding[i] + stride[i] - 1) // stride[i] + 1)
                else:
                    hw.append((s - ksize[i] + 2 * padding[i]) // stride[i] + 1)
            out_shape = [input.shape[0], input.shape[1]] + hw
    out = helper.create_variable_for_type_inference(dtype=input.dtype, shape=out_shape)
    helper.append_op(
        type="pool2d",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={
            "pooling_type": pool_type,
            "ksize": list(ksize),
            "strides": list(stride),
            "paddings": list(padding),
            "global_pooling": global_pooling,
            "ceil_mode": ceil_mode,
            "exclusive": exclusive,
        },
    )
    return out


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1, pool_padding=0, global_pooling=False, use_cudnn=True, ceil_mode=False, name=None, exclusive=True):
    helper = LayerHelper("pool3d", name=name)
    ksize = pool_size if isinstance(pool_size, (list, tuple)) else [pool_size] * 3
    stride = pool_stride if isinstance(pool_stride, (list, tuple)) else [pool_stride] * 3
    padding = pool_padding if isinstance(pool_padding, (list, tuple)) else [pool_padding] * 3
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="pool3d",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={
            "pooling_type": pool_type,
            "ksize": list(ksize),
            "strides": list(stride),
            "paddings": list(padding),
            "global_pooling": global_pooling,
            "ceil_mode": ceil_mode,
            "exclusive": exclusive,
        },
    )
    return out


def batch_norm(
    input,
    act=None,
    is_test=False,
    momentum=0.9,
    epsilon=1e-05,
    param_attr=None,
    bias_attr=None,
    data_layout="NCHW",
    in_place=False,
    use_mkldnn=False,
    name=None,
    moving_mean_name=None,
    moving_variance_name=None,
    do_model_average_for_mean_and_var=False,
    fuse_with_relu=False,
):
    """Batch normalization (reference nn.py:2153 / operators/batch_norm_op.cc).
    Running stats are persistable non-trainable params updated in-graph."""
    helper = LayerHelper("batch_norm", **locals())
    dtype = helper.input_dtype()
    channels = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    pshape = [channels]

    scale = helper.create_parameter(
        attr=helper.param_attr, shape=pshape, dtype=dtype, default_initializer=Constant(1.0)
    )
    bias = helper.create_parameter(attr=helper.bias_attr, shape=pshape, dtype=dtype, is_bias=True)
    mean = helper.create_parameter(
        attr=ParamAttr(name=moving_mean_name, initializer=Constant(0.0), trainable=False),
        shape=pshape,
        dtype=dtype,
    )
    mean.stop_gradient = True
    variance = helper.create_parameter(
        attr=ParamAttr(name=moving_variance_name, initializer=Constant(1.0), trainable=False),
        shape=pshape,
        dtype=dtype,
    )
    variance.stop_gradient = True

    saved_mean = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype, shape=input.shape)

    helper.append_op(
        type="batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias], "Mean": [mean], "Variance": [variance]},
        outputs={
            "Y": [out],
            "MeanOut": [mean],
            "VarianceOut": [variance],
            "SavedMean": [saved_mean],
            "SavedVariance": [saved_var],
        },
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test, "data_layout": data_layout},
    )
    return helper.append_activation(out)


def layer_norm(
    input,
    scale=True,
    shift=True,
    begin_norm_axis=1,
    epsilon=1e-05,
    param_attr=None,
    bias_attr=None,
    act=None,
    name=None,
):
    helper = LayerHelper("layer_norm", **locals())
    dtype = helper.input_dtype()
    nshape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": [input]}
    if scale:
        s = helper.create_parameter(attr=helper.param_attr, shape=nshape, dtype=dtype, default_initializer=Constant(1.0))
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(attr=helper.bias_attr, shape=nshape, dtype=dtype, is_bias=True)
        inputs["Bias"] = [b]
    out = helper.create_variable_for_type_inference(dtype, shape=input.shape)
    mean_out = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    var_out = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    helper.append_op(
        type="layer_norm",
        inputs=inputs,
        outputs={"Y": [out], "Mean": [mean_out], "Variance": [var_out]},
        attrs={"begin_norm_axis": begin_norm_axis, "epsilon": epsilon},
    )
    return helper.append_activation(out)


def conv2d_transpose(
    input,
    num_filters,
    output_size=None,
    filter_size=None,
    padding=0,
    stride=1,
    dilation=1,
    groups=None,
    param_attr=None,
    bias_attr=None,
    use_cudnn=True,
    act=None,
    name=None,
):
    helper = LayerHelper("conv2d_transpose", **locals())
    dtype = helper.input_dtype()
    groups = groups or 1
    in_c = input.shape[1]
    stride_ = stride if isinstance(stride, (list, tuple)) else [stride] * 2
    padding_ = padding if isinstance(padding, (list, tuple)) else [padding] * 2
    dilation_ = dilation if isinstance(dilation, (list, tuple)) else [dilation] * 2
    if filter_size is None:
        if output_size is None:
            raise ValueError("either filter_size or output_size required")
        osize = output_size if isinstance(output_size, (list, tuple)) else [output_size] * 2
        h, w = input.shape[2], input.shape[3]
        filter_size = [
            (osize[0] - (h - 1) * stride_[0] + 2 * padding_[0] - 1) // dilation_[0] + 1,
            (osize[1] - (w - 1) * stride_[1] + 2 * padding_[1] - 1) // dilation_[1] + 1,
        ]
    fsize = filter_size if isinstance(filter_size, (list, tuple)) else [filter_size] * 2
    filter_shape = [in_c, num_filters // groups] + list(fsize)
    w = helper.create_parameter(attr=helper.param_attr, shape=filter_shape, dtype=dtype)
    out_shape = None
    if input.shape is not None and len(input.shape) == 4:
        h, w_in = input.shape[2], input.shape[3]
        if h and h > 0 and w_in and w_in > 0:
            oh = (h - 1) * stride_[0] - 2 * padding_[0] + dilation_[0] * (fsize[0] - 1) + 1
            ow = (w_in - 1) * stride_[1] - 2 * padding_[1] + dilation_[1] * (fsize[1] - 1) + 1
            out_shape = [input.shape[0], num_filters, oh, ow]
    pre_bias = helper.create_variable_for_type_inference(dtype, shape=out_shape)
    helper.append_op(
        type="conv2d_transpose",
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": list(stride_), "paddings": list(padding_), "dilations": list(dilation_), "groups": groups},
    )
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None, padding=0, stride=1, dilation=1, groups=None, param_attr=None, bias_attr=None, use_cudnn=True, act=None, name=None):
    helper = LayerHelper("conv3d_transpose", **locals())
    dtype = helper.input_dtype()
    in_c = input.shape[1]
    fsize = filter_size if isinstance(filter_size, (list, tuple)) else [filter_size] * 3
    stride_ = stride if isinstance(stride, (list, tuple)) else [stride] * 3
    padding_ = padding if isinstance(padding, (list, tuple)) else [padding] * 3
    filter_shape = [in_c, num_filters] + list(fsize)
    w = helper.create_parameter(attr=helper.param_attr, shape=filter_shape, dtype=dtype)
    out_shape = None
    if input.shape is not None and len(input.shape) == 5:
        spatial = input.shape[2:]
        if all(s and s > 0 for s in spatial):
            out_shape = [input.shape[0], num_filters] + [
                (s - 1) * stride_[i] - 2 * padding_[i] + fsize[i] for i, s in enumerate(spatial)
            ]
    pre_bias = helper.create_variable_for_type_inference(dtype, shape=out_shape)
    helper.append_op(
        type="conv3d_transpose",
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": list(stride_), "paddings": list(padding_)},
    )
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def _reduce(op_type, input, dim, keep_dim, name):
    helper = LayerHelper(op_type, name=name)
    shape = None
    if input.shape is not None:
        if dim is None:
            shape = [1] * len(input.shape) if keep_dim else [1]
        else:
            dims = [d % len(input.shape) for d in (dim if isinstance(dim, (list, tuple)) else [dim])]
            if keep_dim:
                shape = [1 if i in dims else s for i, s in enumerate(input.shape)]
            else:
                shape = [s for i, s in enumerate(input.shape) if i not in dims] or [1]
    out = helper.create_variable_for_type_inference(dtype=input.dtype, shape=shape)
    helper.append_op(
        type=op_type,
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={
            "dim": dim if dim is None or isinstance(dim, (list, tuple)) else [dim],
            "keep_dim": keep_dim,
            "reduce_all": dim is None,
        },
    )
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_sum", input, dim, keep_dim, name)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_mean", input, dim, keep_dim, name)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_max", input, dim, keep_dim, name)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_min", input, dim, keep_dim, name)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_prod", input, dim, keep_dim, name)


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    if isinstance(num_or_sections, int):
        num = num_or_sections
        sections = None
    else:
        num = len(num_or_sections)
        sections = list(num_or_sections)
    shapes = [None] * num
    if input.shape is not None:
        ax = dim % len(input.shape)
        if sections:
            sizes = sections
        elif input.shape[ax] is not None and input.shape[ax] > 0:
            sizes = [input.shape[ax] // num] * num
        else:
            sizes = [None] * num
        shapes = [
            [sz if i == ax else s for i, s in enumerate(input.shape)] for sz in sizes
        ]
    outs = [
        helper.create_variable_for_type_inference(dtype=input.dtype, shape=shapes[k])
        for k in range(num)
    ]
    helper.append_op(
        type="split",
        inputs={"X": [input]},
        outputs={"Out": outs},
        attrs={"axis": dim, "sections": sections, "num": 0 if sections else num},
    )
    return outs


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    if len(x.shape) == 1:
        axis = 0
    helper = LayerHelper("l2_normalize", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype, shape=x.shape)
    norm = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="norm",
        inputs={"X": [x]},
        outputs={"Out": [out], "Norm": [norm]},
        attrs={"axis": axis, "epsilon": epsilon},
    )
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    shape = None
    if x.shape is not None and y.shape is not None and len(x.shape) >= 2 and len(y.shape) >= 2:
        m = x.shape[-1] if transpose_x else x.shape[-2]
        n = y.shape[-2] if transpose_y else y.shape[-1]
        batch = list(x.shape[:-2]) if len(x.shape) >= len(y.shape) else list(y.shape[:-2])
        shape = batch + [m, n]
    out = helper.create_variable_for_type_inference(dtype=x.dtype, shape=shape)
    helper.append_op(
        type="matmul",
        inputs={"X": [x], "Y": [y]},
        outputs={"Out": [out]},
        attrs={"transpose_X": transpose_x, "transpose_Y": transpose_y, "alpha": float(alpha)},
    )
    return out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    values = helper.create_variable_for_type_inference(dtype=input.dtype)
    indices = helper.create_variable_for_type_inference(dtype="int64", stop_gradient=True)
    helper.append_op(
        type="top_k",
        inputs={"X": [input]},
        outputs={"Out": [values], "Indices": [indices]},
        attrs={"k": k},
    )
    return values, indices


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", name=name)
    shape = [x.shape[p] for p in perm] if x.shape is not None else None
    out = helper.create_variable_for_type_inference(dtype=x.dtype, shape=shape)
    helper.append_op(type="transpose", inputs={"X": [x]}, outputs={"Out": [out]}, attrs={"axis": list(perm)})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False, ignore_index=-100, numeric_stable_mode=True, return_softmax=False):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax_out = helper.create_variable_for_type_inference(dtype=logits.dtype, shape=logits.shape)
    loss = helper.create_variable_for_type_inference(dtype=logits.dtype)
    helper.append_op(
        type="softmax_with_cross_entropy",
        inputs={"Logits": [logits], "Label": [label]},
        outputs={"Softmax": [softmax_out], "Loss": [loss]},
        attrs={"soft_label": soft_label, "ignore_index": ignore_index},
    )
    if return_softmax:
        return loss, softmax_out
    return loss


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper("smooth_l1_loss")
    diff = helper.create_variable_for_type_inference(dtype=x.dtype)
    loss = helper.create_variable_for_type_inference(dtype=x.dtype)
    inputs = {"X": [x], "Y": [y]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight]
    helper.append_op(
        type="smooth_l1_loss",
        inputs=inputs,
        outputs={"Diff": [diff], "Out": [loss]},
        attrs={"sigma": sigma if sigma is not None else 1.0},
    )
    return loss


def one_hot(input, depth):
    helper = LayerHelper("one_hot")
    out = helper.create_variable_for_type_inference(dtype="float32")
    helper.append_op(type="one_hot", inputs={"X": [input]}, outputs={"Out": [out]}, attrs={"depth": depth})
    return out


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """Persistable int64 counter incremented once per executor run
    (reference nn.py:4349)."""
    helper = LayerHelper("global_step_counter")
    counter_name = counter_name or "@STEP_COUNTER@"
    counter = helper.create_global_variable(
        name=counter_name, dtype="int64", shape=[1], persistable=True
    )
    helper.set_variable_initializer(counter, Constant(value=float(begin - 1)))
    helper.append_op(
        type="increment", inputs={"X": [counter]}, outputs={"Out": [counter]}, attrs={"step": float(step)}
    )
    counter.stop_gradient = True
    return counter


def _infer_reshape_shape(in_shape, shape):
    """Static output-shape inference with reference reshape semantics
    (0 = copy input dim, one -1 = inferred); None where unknowable."""
    if in_shape is None:
        # explicit dims are still known; 0 (copy) is not, -1 stays symbolic
        return [int(s) if s not in (0,) else None for s in shape]
    out = []
    for i, s in enumerate(shape):
        if s == 0:
            out.append(in_shape[i] if i < len(in_shape) else None)
        else:
            out.append(int(s))
    if None in out:
        return out
    known = [d for d in out if d != -1]
    if -1 in out and all(d is not None and d >= 0 for d in in_shape):
        total = int(np.prod(in_shape))
        rest = int(np.prod(known)) if known else 1
        out[out.index(-1)] = total // rest if rest else -1
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=True, name=None):
    helper = LayerHelper("reshape", name=name)
    out = helper.create_variable_for_type_inference(
        dtype=x.dtype, shape=_infer_reshape_shape(x.shape, shape))
    helper.append_op(type="reshape", inputs={"X": [x]}, outputs={"Out": [out]}, attrs={"shape": list(shape)})
    return helper.append_activation(out) if act else out


def squeeze(input, axes, name=None):
    helper = LayerHelper("squeeze", name=name)
    shape = None
    if input.shape is not None:
        dims = [a % len(input.shape) for a in axes]
        shape = [s for i, s in enumerate(input.shape) if i not in dims]
    out = helper.create_variable_for_type_inference(dtype=input.dtype, shape=shape)
    helper.append_op(type="squeeze", inputs={"X": [input]}, outputs={"Out": [out]}, attrs={"axes": list(axes)})
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze", name=name)
    shape = None
    if input.shape is not None:
        shape = list(input.shape)
        for a in sorted(axes):
            shape.insert(a if a >= 0 else a + len(shape) + 1, 1)
    out = helper.create_variable_for_type_inference(dtype=input.dtype, shape=shape)
    helper.append_op(type="unsqueeze", inputs={"X": [input]}, outputs={"Out": [out]}, attrs={"axes": list(axes)})
    return out


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    helper = LayerHelper("lrn", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype, shape=input.shape)
    mid = helper.create_variable_for_type_inference(dtype=input.dtype, stop_gradient=True)
    helper.append_op(
        type="lrn",
        inputs={"X": [input]},
        outputs={"Out": [out], "MidOut": [mid]},
        attrs={"n": n, "k": k, "alpha": alpha, "beta": beta},
    )
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="pad", inputs={"X": [x]}, outputs={"Out": [out]}, attrs={"paddings": list(paddings), "pad_value": float(pad_value)}
    )
    return out


def pad2d(input, paddings=[0, 0, 0, 0], mode="constant", pad_value=0.0, data_format="NCHW", name=None):
    helper = LayerHelper("pad2d", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="pad2d",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"paddings": list(paddings), "mode": mode, "pad_value": float(pad_value)},
    )
    return out


def pad_constant_like(x, y, pad_value=0.0, name=None):
    helper = LayerHelper("pad_constant_like", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="pad_constant_like", inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]}, attrs={"pad_value": float(pad_value)}
    )
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32", name=None):
    helper = LayerHelper("label_smooth", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    inputs = {"X": [label]}
    if prior_dist is not None:
        inputs["PriorDist"] = [prior_dist]
    helper.append_op(type="label_smooth", inputs=inputs, outputs={"Out": [out]}, attrs={"epsilon": float(epsilon)})
    return out


def roi_pool(input, rois, pooled_height=1, pooled_width=1, spatial_scale=1.0):
    helper = LayerHelper("roi_pool")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="roi_pool",
        inputs={"X": [input], "ROIs": [rois]},
        outputs={"Out": [out]},
        attrs={"pooled_height": pooled_height, "pooled_width": pooled_width, "spatial_scale": spatial_scale},
    )
    return out


def dice_loss(input, label, epsilon=1e-5):
    helper = LayerHelper("dice_loss")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="dice_loss", inputs={"X": [input], "Label": [label]}, outputs={"Out": [out]}, attrs={"epsilon": epsilon}
    )
    return out


def image_resize(input, out_shape=None, scale=None, name=None, resample="BILINEAR"):
    helper = LayerHelper("image_resize", name=name)
    if out_shape is None:
        out_shape = [int(input.shape[2] * scale), int(input.shape[3] * scale)]
    op_type = "bilinear_interp" if resample == "BILINEAR" else "nearest_interp"
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type=op_type,
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"out_h": int(out_shape[0]), "out_w": int(out_shape[1])},
    )
    return out


def resize_bilinear(input, out_shape=None, scale=None, name=None):
    return image_resize(input, out_shape, scale, name, "BILINEAR")


def image_resize_short(input, out_short_len, resample="BILINEAR"):
    h, w = input.shape[2], input.shape[3]
    short = min(h, w)
    out_shape = [int(h * out_short_len / short), int(w * out_short_len / short)]
    return image_resize(input, out_shape=out_shape, resample=resample)


def gather(input, index):
    helper = LayerHelper("gather")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(type="gather", inputs={"X": [input], "Index": [index]}, outputs={"Out": [out]})
    return out


def scatter(input, index, updates, name=None):
    helper = LayerHelper("scatter", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype, shape=input.shape)
    helper.append_op(
        type="scatter", inputs={"X": [input], "Ids": [index], "Updates": [updates]}, outputs={"Out": [out]}
    )
    return out


def random_crop(x, shape, seed=None):
    helper = LayerHelper("random_crop")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="random_crop",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"shape": list(shape), "seed": seed or 0},
    )
    return out


def mean_iou(input, label, num_classes):
    helper = LayerHelper("mean_iou")
    out_miou = helper.create_variable_for_type_inference(dtype="float32")
    out_wrong = helper.create_variable_for_type_inference(dtype="int32", stop_gradient=True)
    out_correct = helper.create_variable_for_type_inference(dtype="int32", stop_gradient=True)
    helper.append_op(
        type="mean_iou",
        inputs={"Predictions": [input], "Labels": [label]},
        outputs={"OutMeanIou": [out_miou], "OutWrong": [out_wrong], "OutCorrect": [out_correct]},
        attrs={"num_classes": num_classes},
    )
    return out_miou, out_wrong, out_correct


def crop(x, shape=None, offsets=None, name=None):
    helper = LayerHelper("crop", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    inputs = {"X": [x]}
    attrs = {}
    if isinstance(shape, Variable):
        inputs["Y"] = [shape]
    else:
        attrs["shape"] = list(shape)
    if offsets is not None:
        attrs["offsets"] = list(offsets)
    helper.append_op(type="crop", inputs=inputs, outputs={"Out": [out]}, attrs=attrs)
    return out


def rank_loss(label, left, right, name=None):
    helper = LayerHelper("rank_loss", name=name)
    out = helper.create_variable_for_type_inference(dtype="float32")
    helper.append_op(
        type="rank_loss", inputs={"Label": [label], "Left": [left], "Right": [right]}, outputs={"Out": [out]}
    )
    return out


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    helper = LayerHelper("margin_rank_loss", name=name)
    out = helper.create_variable_for_type_inference(dtype="float32")
    helper.append_op(
        type="margin_rank_loss",
        inputs={"Label": [label], "X1": [left], "X2": [right]},
        outputs={"Out": [out]},
        attrs={"margin": margin},
    )
    return out


def _act_layer(op_type, x, name=None, **attrs):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype, shape=x.shape)
    helper.append_op(type=op_type, inputs={"X": [x]}, outputs={"Out": [out]}, attrs=attrs)
    return out


def relu(x, name=None):
    return _act_layer("relu", x, name)


def log(x, name=None):
    return _act_layer("log", x, name)


def elu(x, alpha=1.0, name=None):
    return _act_layer("elu", x, name, alpha=alpha)


def relu6(x, threshold=6.0, name=None):
    return _act_layer("relu6", x, name, threshold=threshold)


def pow(x, factor=1.0, name=None):
    return _act_layer("pow", x, name, factor=factor)


def stanh(x, scale_a=2.0 / 3.0, scale_b=1.7159, name=None):
    return _act_layer("stanh", x, name, scale_a=scale_a, scale_b=scale_b)


def hard_sigmoid(x, slope=0.2, offset=0.5, name=None):
    return _act_layer("hard_sigmoid", x, name, slope=slope, offset=offset)


def swish(x, beta=1.0, name=None):
    return _act_layer("swish", x, name, beta=beta)


def brelu(x, t_min=0.0, t_max=24.0, name=None):
    return _act_layer("brelu", x, name, t_min=t_min, t_max=t_max)


def leaky_relu(x, alpha=0.02, name=None):
    return _act_layer("leaky_relu", x, name, alpha=alpha)


def soft_relu(x, threshold=40.0, name=None):
    return _act_layer("soft_relu", x, name, threshold=threshold)


def prelu(x, mode, param_attr=None, name=None):
    helper = LayerHelper("prelu", name=name)
    if mode not in ("all", "channel", "element"):
        raise ValueError("mode must be all|channel|element")
    alpha_shape = [1]
    if mode == "channel":
        alpha_shape = [x.shape[1]]
    elif mode == "element":
        alpha_shape = list(x.shape[1:])
    alpha = helper.create_parameter(
        attr=ParamAttr._to_attr(param_attr), shape=alpha_shape, dtype="float32", is_bias=False,
        default_initializer=Constant(0.25),
    )
    out = helper.create_variable_for_type_inference(dtype=x.dtype, shape=x.shape)
    helper.append_op(
        type="prelu", inputs={"X": [x], "Alpha": [alpha]}, outputs={"Out": [out]}, attrs={"mode": mode}
    )
    return out


def flatten(x, axis=1, name=None):
    helper = LayerHelper("flatten", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="flatten", inputs={"X": [x]}, outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def stack(x, axis=0):
    helper = LayerHelper("stack")
    x = x if isinstance(x, (list, tuple)) else [x]
    shape = None
    if x[0].shape is not None:
        shape = list(x[0].shape)
        shape.insert(axis if axis >= 0 else axis + len(shape) + 1, len(x))
    out = helper.create_variable_for_type_inference(dtype=x[0].dtype, shape=shape)
    helper.append_op(type="stack", inputs={"X": x}, outputs={"Y": [out]}, attrs={"axis": axis})
    return out


def unstack(x, axis=0, num=None):
    helper = LayerHelper("unstack")
    if num is None:
        num = x.shape[axis]
    outs = [helper.create_variable_for_type_inference(dtype=x.dtype) for _ in range(num)]
    helper.append_op(type="unstack", inputs={"X": [x]}, outputs={"Y": outs}, attrs={"axis": axis, "num": num})
    return outs


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="expand", inputs={"X": [x]}, outputs={"Out": [out]}, attrs={"expand_times": list(expand_times)}
    )
    return out


def uniform_random_batch_size_like(input, shape, dtype="float32", input_dim_idx=0, output_dim_idx=0, min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="uniform_random_batch_size_like",
        inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={
            "shape": list(shape),
            "dtype": dtype,
            "min": float(min),
            "max": float(max),
            "seed": seed,
            "input_dim_idx": input_dim_idx,
            "output_dim_idx": output_dim_idx,
        },
    )
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="gaussian_random",
        outputs={"Out": [out]},
        attrs={"shape": list(shape), "mean": float(mean), "std": float(std), "seed": seed, "dtype": dtype},
    )
    return out


def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("sampling_id")
    out = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op(type="sampling_id", inputs={"X": [x]}, outputs={"Out": [out]}, attrs={"seed": seed})
    return out


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0, output_dim_idx=0, mean=0.0, std=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="gaussian_random_batch_size_like",
        inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={
            "shape": list(shape),
            "mean": float(mean),
            "std": float(std),
            "seed": seed,
            "dtype": dtype,
            "input_dim_idx": input_dim_idx,
            "output_dim_idx": output_dim_idx,
        },
    )
    return out


def sum(x):
    helper = LayerHelper("sum")
    x = x if isinstance(x, (list, tuple)) else [x]
    out = helper.create_variable_for_type_inference(dtype=x[0].dtype, shape=x[0].shape)
    helper.append_op(type="sum", inputs={"X": x}, outputs={"Out": [out]})
    return out


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="slice",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"axes": list(axes), "starts": list(starts), "ends": list(ends)},
    )
    return out


def shape(input):
    helper = LayerHelper("shape")
    out = helper.create_variable_for_type_inference(dtype="int32", stop_gradient=True)
    helper.append_op(type="shape", inputs={"Input": [input]}, outputs={"Out": [out]})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", name=name, act=act)
    out = helper.create_variable_for_type_inference(dtype=x.dtype, shape=x.shape)
    helper.append_op(
        type="scale",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"scale": float(scale), "bias": float(bias), "bias_after_scale": bias_after_scale},
    )
    return helper.append_activation(out)


def _elementwise(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, name=name, act=act)
    out = helper.create_variable_for_type_inference(dtype=x.dtype, shape=x.shape)
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]}, attrs={"axis": axis})
    return helper.append_activation(out)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_add", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_div", x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_sub", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mul", x, y, axis, act, name)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_max", x, y, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_min", x, y, axis, act, name)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_pow", x, y, axis, act, name)


def _logical(op_type, x, y, out=None, name=None):
    helper = LayerHelper(op_type, name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype="bool", shape=x.shape)
        out.stop_gradient = True
    inputs = {"X": [x]} if y is None else {"X": [x], "Y": [y]}
    helper.append_op(type=op_type, inputs=inputs, outputs={"Out": [out]})
    return out


def logical_and(x, y, out=None, name=None):
    return _logical("logical_and", x, y, out, name)


def logical_or(x, y, out=None, name=None):
    return _logical("logical_or", x, y, out, name)


def logical_xor(x, y, out=None, name=None):
    return _logical("logical_xor", x, y, out, name)


def logical_not(x, out=None, name=None):
    return _logical("logical_not", x, None, out, name)


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype, shape=x.shape)
    helper.append_op(
        type="clip", inputs={"X": [x]}, outputs={"Out": [out]}, attrs={"min": float(min), "max": float(max)}
    )
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype, shape=x.shape)
    helper.append_op(
        type="clip_by_norm", inputs={"X": [x]}, outputs={"Out": [out]}, attrs={"max_norm": float(max_norm)}
    )
    return out


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype, shape=[1])
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(
        type="mul",
        inputs={"X": [x], "Y": [y]},
        outputs={"Out": [out]},
        attrs={"x_num_col_dims": x_num_col_dims, "y_num_col_dims": y_num_col_dims},
    )
    return out


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100, name=None):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype, shape=x.shape)
    helper.append_op(
        type="sigmoid_cross_entropy_with_logits",
        inputs={"X": [x], "Label": [label]},
        outputs={"Out": [out]},
        attrs={"ignore_index": ignore_index},
    )
    return out


def maxout(x, groups, name=None):
    from .ops import maxout as _maxout

    return _maxout(x, groups, name)


def multiplex(inputs, index):
    helper = LayerHelper("multiplex")
    out = helper.create_variable_for_type_inference(dtype=inputs[0].dtype)
    helper.append_op(type="multiplex", inputs={"X": inputs, "Ids": [index]}, outputs={"Out": [out]})
    return out


def cos_sim(X, Y):
    helper = LayerHelper("cos_sim")
    out = helper.create_variable_for_type_inference(dtype=X.dtype)
    xnorm = helper.create_variable_for_type_inference(dtype=X.dtype)
    ynorm = helper.create_variable_for_type_inference(dtype=X.dtype)
    helper.append_op(
        type="cos_sim",
        inputs={"X": [X], "Y": [Y]},
        outputs={"Out": [out], "XNorm": [xnorm], "YNorm": [ynorm]},
    )
    return out


def im2sequence(input, filter_size=1, stride=1, padding=0, input_image_size=None, out_stride=1, name=None):
    helper = LayerHelper("im2sequence", name=name)
    fsize = filter_size if isinstance(filter_size, (list, tuple)) else [filter_size] * 2
    stride_ = stride if isinstance(stride, (list, tuple)) else [stride] * 2
    pad_ = padding if isinstance(padding, (list, tuple)) else [padding] * 4
    if len(pad_) == 2:
        pad_ = list(pad_) * 2
    out_shape = None
    if input.shape is not None and len(input.shape) == 4:
        n, c, h, w = input.shape
        if h is not None and w is not None and h > 0 and w > 0:
            oh = (h + pad_[0] + pad_[2] - fsize[0]) // stride_[0] + 1
            ow = (w + pad_[1] + pad_[3] - fsize[1]) // stride_[1] + 1
            out_shape = [n, oh * ow, c * fsize[0] * fsize[1]]
    out = helper.create_variable_for_type_inference(dtype=input.dtype, shape=out_shape, lod_level=1)
    helper.append_op(
        type="im2sequence",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"kernels": list(fsize), "strides": list(stride_), "paddings": list(pad_)},
    )
    return out


def log_loss(input, label, epsilon=1e-4, name=None):
    helper = LayerHelper("log_loss", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="log_loss",
        inputs={"Predicted": [input], "Labels": [label]},
        outputs={"Loss": [out]},
        attrs={"epsilon": epsilon},
    )
    return out


def huber_loss(input, label, delta):
    helper = LayerHelper("huber_loss")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    residual = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="huber_loss",
        inputs={"X": [input], "Y": [label]},
        outputs={"Out": [out], "Residual": [residual]},
        attrs={"delta": delta},
    )
    return out


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id, level=0, name=None):
    """One beam-expansion step (reference nn.py:3280 / beam_search_op.cc).

    TPU-native static-beam contract (see ops/decode_ops.py): all tensors are
    ``[batch, beam]``-shaped; ``ids``/``scores`` are the per-beam candidate
    ids and ACCUMULATED log-probs ``[batch, beam, K]``.  Returns
    ``(selected_ids, selected_scores, parent_idx)`` — parenthood is explicit
    instead of LoD-encoded, so the whole step is one fused topk on device.
    Seed ``pre_scores`` with ``[0, -1e9, ...]`` per batch row on step 0 (the
    reference gets this effect from lod of the init ids).
    """
    helper = LayerHelper("beam_search", name=name)
    sel_ids = helper.create_variable_for_type_inference(dtype=ids.dtype, shape=pre_ids.shape)
    sel_scores = helper.create_variable_for_type_inference(dtype=scores.dtype, shape=pre_scores.shape)
    parent_idx = helper.create_variable_for_type_inference(dtype="int32", shape=pre_ids.shape, stop_gradient=True)
    helper.append_op(
        type="beam_search",
        inputs={"pre_ids": [pre_ids], "pre_scores": [pre_scores], "ids": [ids], "scores": [scores]},
        outputs={"selected_ids": [sel_ids], "selected_scores": [sel_scores], "parent_idx": [parent_idx]},
        attrs={"beam_size": beam_size, "end_id": end_id, "level": level},
    )
    return sel_ids, sel_scores, parent_idx


def beam_search_decode(ids, scores, parents, beam_size, end_id, name=None):
    """Backtrace beams into full sentences (reference nn.py:3349 /
    beam_search_decode_op.cc).  ``ids``/``scores``/``parents`` are tensor
    arrays written once per decode step via ``array_write`` (each element
    ``[batch, beam]``).

    Returns the reference's 2-level structure in the padded-rows layout:
    ``sentence_ids [batch*beam, T]`` — one row per hypothesis, padded with
    ``end_id`` past each sentence's finish, beams grouped per source in
    row order — and ``sentence_scores [batch*beam]``.  Fetching with
    ``return_numpy=False`` yields a ``LoDArray`` whose lengths are the
    per-hypothesis token counts (through the first ``end_id``) and whose
    sub_lengths group beam rows per source sentence.  Reshape to
    ``[batch, beam, T]`` with ``ids.reshape(batch, beam, -1)`` when a
    dense view is wanted (backtrace = one reversed lax.scan on device)."""
    helper = LayerHelper("beam_search_decode", name=name)
    sentence_ids = helper.create_variable_for_type_inference(dtype="int64", stop_gradient=True)
    sentence_scores = helper.create_variable_for_type_inference(dtype="float32", stop_gradient=True)
    helper.append_op(
        type="beam_search_decode",
        inputs={"Ids": [ids], "Scores": [scores], "Parents": [parents]},
        outputs={"SentenceIds": [sentence_ids], "SentenceScores": [sentence_scores]},
        attrs={"beam_size": beam_size, "end_id": end_id},
    )
    return sentence_ids, sentence_scores


# ---------------------------------------------------------------------------
# structured prediction: CTC / CRF / chunk_eval / NCE / hsigmoid
# (reference nn.py: warpctc:3587, edit_distance:3486, ctc_greedy_decoder:3532,
#  linear_chain_crf:1019, crf_decoding:1073, chunk_eval:1155, nce:4104,
#  hsigmoid:4186)
# ---------------------------------------------------------------------------


def warpctc(input, label, blank=0, norm_by_times=False, name=None):
    """CTC loss (reference nn.py:3587).  ``input`` holds unscaled logits
    ``[batch, max_time, num_classes + 1]`` (padded+lengths, vs the
    reference's LoD layout); ``label`` is ``[batch, max_label_len]`` int.
    Returns per-sequence loss ``[batch, 1]``."""
    helper = LayerHelper("warpctc", **locals())
    loss = helper.create_variable_for_type_inference(
        dtype=input.dtype, shape=[input.shape[0] if input.shape else -1, 1]
    )
    helper.append_op(
        type="warpctc",
        inputs={"Logits": [input], "Label": [label]},
        outputs={"Loss": [loss]},
        attrs={"blank": blank, "norm_by_times": norm_by_times},
    )
    return loss


def ctc_greedy_decoder(input, blank, name=None):
    """Greedy CTC decode (reference nn.py:3532): argmax per frame, then
    merge repeats and drop blanks (ctc_align op)."""
    helper = LayerHelper("ctc_greedy_decoder", **locals())
    _, topk_indices = topk(input, k=1)
    argmax = squeeze(topk_indices, axes=[-1])
    out = helper.create_variable_for_type_inference(
        dtype="int64", shape=list(argmax.shape) if argmax.shape else None, stop_gradient=True
    )
    helper.append_op(
        type="ctc_align",
        inputs={"Input": [argmax]},
        outputs={"Output": [out]},
        attrs={"blank": blank, "merge_repeated": True},
    )
    return out


def edit_distance(input, label, normalized=True, ignored_tokens=None, name=None):
    """Levenshtein distance between hyp and ref id sequences (reference
    nn.py:3486).  Returns ``(distance [batch, 1], seq_num scalar)``."""
    helper = LayerHelper("edit_distance", **locals())
    if ignored_tokens is not None and len(ignored_tokens) > 0:
        erased_input = helper.create_variable_for_type_inference(dtype=input.dtype, shape=input.shape)
        erased_label = helper.create_variable_for_type_inference(dtype=label.dtype, shape=label.shape)
        helper.append_op(
            type="sequence_erase",
            inputs={"X": [input]},
            outputs={"Out": [erased_input]},
            attrs={"tokens": list(ignored_tokens)},
        )
        helper.append_op(
            type="sequence_erase",
            inputs={"X": [label]},
            outputs={"Out": [erased_label]},
            attrs={"tokens": list(ignored_tokens)},
        )
        input, label = erased_input, erased_label
    out = helper.create_variable_for_type_inference(
        dtype="float32", shape=[input.shape[0] if input.shape else -1, 1], stop_gradient=True
    )
    seq_num = helper.create_variable_for_type_inference(dtype="int32", shape=[], stop_gradient=True)
    helper.append_op(
        type="edit_distance",
        inputs={"Hyps": [input], "Refs": [label]},
        outputs={"Out": [out], "SequenceNum": [seq_num]},
        attrs={"normalized": normalized},
    )
    return out, seq_num


def linear_chain_crf(input, label, param_attr=None):
    """Linear-chain CRF NLL cost (reference nn.py:1019).  Creates the
    ``[size + 2, size]`` transition parameter (rows 0/1 = start/end weights)
    and returns the per-sequence negative log-likelihood ``[batch, 1]``."""
    helper = LayerHelper("linear_chain_crf", **locals())
    size = input.shape[-1]
    transition = helper.create_parameter(
        attr=helper.param_attr, shape=[size + 2, size], dtype=helper.input_dtype()
    )
    alpha = helper.create_variable_for_type_inference(dtype=helper.input_dtype(), shape=input.shape)
    log_likelihood = helper.create_variable_for_type_inference(
        dtype=helper.input_dtype(), shape=[input.shape[0] if input.shape else -1, 1]
    )
    helper.append_op(
        type="linear_chain_crf",
        inputs={"Emission": [input], "Transition": [transition], "Label": [label]},
        outputs={"Alpha": [alpha], "LogLikelihood": [log_likelihood]},
        attrs={},
    )
    return log_likelihood


def crf_decoding(input, param_attr, label=None):
    """Viterbi decode with a trained CRF transition param (reference
    nn.py:1073).  With ``label``, returns per-position 0/1 correctness."""
    helper = LayerHelper("crf_decoding", **locals())
    transition = helper.get_parameter(param_attr.name)
    viterbi_path = helper.create_variable_for_type_inference(
        dtype="int64", shape=list(input.shape[:-1]) if input.shape else None, stop_gradient=True
    )
    inputs = {"Emission": [input], "Transition": [transition]}
    if label is not None:
        inputs["Label"] = [label]
    helper.append_op(type="crf_decoding", inputs=inputs, outputs={"ViterbiPath": [viterbi_path]})
    return viterbi_path


def chunk_eval(input, label, chunk_scheme, num_chunk_types, excluded_chunk_types=None):
    """Chunk-level precision/recall/F1 for sequence labeling (reference
    nn.py:1155).  Returns (precision, recall, f1, num_infer_chunks,
    num_label_chunks, num_correct_chunks)."""
    helper = LayerHelper("chunk_eval", **locals())
    precision = helper.create_variable_for_type_inference(dtype="float32", shape=[], stop_gradient=True)
    recall = helper.create_variable_for_type_inference(dtype="float32", shape=[], stop_gradient=True)
    f1_score = helper.create_variable_for_type_inference(dtype="float32", shape=[], stop_gradient=True)
    num_infer_chunks = helper.create_variable_for_type_inference(dtype="int32", shape=[], stop_gradient=True)
    num_label_chunks = helper.create_variable_for_type_inference(dtype="int32", shape=[], stop_gradient=True)
    num_correct_chunks = helper.create_variable_for_type_inference(dtype="int32", shape=[], stop_gradient=True)
    helper.append_op(
        type="chunk_eval",
        inputs={"Inference": [input], "Label": [label]},
        outputs={
            "Precision": [precision],
            "Recall": [recall],
            "F1-Score": [f1_score],
            "NumInferChunks": [num_infer_chunks],
            "NumLabelChunks": [num_label_chunks],
            "NumCorrectChunks": [num_correct_chunks],
        },
        attrs={
            "num_chunk_types": num_chunk_types,
            "chunk_scheme": chunk_scheme,
            "excluded_chunk_types": excluded_chunk_types or [],
        },
    )
    return precision, recall, f1_score, num_infer_chunks, num_label_chunks, num_correct_chunks


def nce(
    input,
    label,
    num_total_classes,
    sample_weight=None,
    param_attr=None,
    bias_attr=None,
    num_neg_samples=None,
    name=None,
):
    """Noise-contrastive estimation loss (reference nn.py:4104).  Weight is
    ``[num_total_classes, dim]``; negatives drawn uniformly on device."""
    helper = LayerHelper("nce", **locals())
    dim = input.shape[1]
    w = helper.create_parameter(
        attr=helper.param_attr, shape=[num_total_classes, dim], dtype=input.dtype
    )
    inputs = {"Input": [input], "Label": [label], "Weight": [w]}
    if helper.bias_attr is not False:
        b = helper.create_parameter(
            attr=helper.bias_attr, shape=[num_total_classes, 1], dtype=input.dtype, is_bias=True
        )
        inputs["Bias"] = [b]
    if sample_weight is not None:
        inputs["SampleWeight"] = [sample_weight]
    if num_neg_samples is None:
        num_neg_samples = 10
    cost = helper.create_variable_for_type_inference(
        dtype=input.dtype, shape=[input.shape[0] if input.shape else -1, 1]
    )
    sample_logits = helper.create_variable_for_type_inference(dtype=input.dtype)
    sample_labels = helper.create_variable_for_type_inference(dtype=label.dtype, stop_gradient=True)
    helper.append_op(
        type="nce",
        inputs=inputs,
        outputs={"Cost": [cost], "SampleLogits": [sample_logits], "SampleLabels": [sample_labels]},
        attrs={
            "num_total_classes": int(num_total_classes),
            "num_neg_samples": int(num_neg_samples),
        },
    )
    return cost


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None, name=None):
    """Hierarchical sigmoid cost over a complete binary class tree
    (reference nn.py:4186).  Returns ``[batch, 1]``."""
    helper = LayerHelper("hsigmoid", **locals())
    dim = input.shape[1]
    if num_classes < 2:
        raise ValueError("num_classes must be >= 2, got %r" % (num_classes,))
    w = helper.create_parameter(
        attr=helper.param_attr, shape=[num_classes - 1, dim], dtype=input.dtype
    )
    inputs = {"X": [input], "W": [w], "Label": [label]}
    if helper.bias_attr is not False:
        b = helper.create_parameter(
            attr=helper.bias_attr, shape=[1, num_classes - 1], dtype=input.dtype, is_bias=True
        )
        inputs["Bias"] = [b]
    out = helper.create_variable_for_type_inference(
        dtype=input.dtype, shape=[input.shape[0] if input.shape else -1, 1]
    )
    pre_out = helper.create_variable_for_type_inference(dtype=input.dtype)
    helper.append_op(
        type="hierarchical_sigmoid",
        inputs=inputs,
        outputs={"Out": [out], "PreOut": [pre_out]},
        attrs={"num_classes": int(num_classes)},
    )
    return out


def flash_attention(q, k, v, kv_lens=None, causal=False, sequence_parallel=True,
                    sp_engine="auto", name=None):
    """Fused flash attention over [batch, heads, time, head_dim] tensors
    (the hand-written CUDA kernels of parallel/flash_attention.py on the
    card).  ``kv_lens`` ([batch] int) applies a key padding mask without
    building a [T, S] bias.  No reference analog — the reference
    composes matmul+softmax.

    ``sequence_parallel`` and ``sp_engine`` are kept in the op's attrs
    so the Program matches the JAX package's; the port has no
    sequence-parallel engine yet, and its Executor takes no mesh."""
    helper = LayerHelper("flash_attention", **locals())
    out = helper.create_variable_for_type_inference(dtype=q.dtype, shape=q.shape)
    inputs = {"Q": [q], "K": [k], "V": [v]}
    if kv_lens is not None:
        inputs["KVLens"] = [kv_lens]
    helper.append_op(
        type="flash_attention",
        inputs=inputs,
        outputs={"Out": [out]},
        attrs={"causal": causal, "sequence_parallel": bool(sequence_parallel),
               "sp_engine": sp_engine},
    )
    return out


def switch_moe(input, num_experts, expert_hidden, capacity_factor=2.0,
               param_attr=None, name=None):
    """Switch-style Mixture-of-Experts FFN: top-1 gating over
    ``num_experts`` relu FFNs of hidden width ``expert_hidden``.

    No reference analog (Fluid v0.15 predates MoE).  Single device: dense
    top-1 computation.  Under a ``ParallelExecutor`` whose ``mesh_shape``
    carries an ``ep`` axis equal to ``num_experts``, experts run
    EXPERT-PARALLEL — one expert per device, tokens shipped by
    ``all_to_all`` with capacity ``capacity_factor`` and the Switch
    overflow-drop rule (parallel/moe.py).  Input [batch(, time), d]."""
    helper = LayerHelper("switch_moe", **locals())
    d = int(input.shape[-1])
    gate_w = helper.create_parameter(
        attr=param_attr, shape=[d, num_experts], dtype=input.dtype)
    w1 = helper.create_parameter(
        attr=param_attr, shape=[num_experts, d, expert_hidden], dtype=input.dtype)
    w2 = helper.create_parameter(
        attr=param_attr, shape=[num_experts, expert_hidden, d], dtype=input.dtype)
    out = helper.create_variable_for_type_inference(dtype=input.dtype,
                                                    shape=input.shape)
    helper.append_op(
        type="switch_moe",
        inputs={"X": [input], "GateW": [gate_w], "ExpertW1": [w1],
                "ExpertW2": [w2]},
        outputs={"Out": [out]},
        attrs={"capacity_factor": float(capacity_factor)},
    )
    return out
