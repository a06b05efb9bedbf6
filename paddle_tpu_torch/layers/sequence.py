"""Sequence layers over the padded-plus-lengths ragged layout.

The port's copy of the JAX package's ``paddle_tpu/layers/sequence.py``:
the same layer functions build the same Programs, with the same
parameter names, shapes and initializers, so weights carry over by name.
Reference: the sequence_* / dynamic_* layers of
python/paddle/fluid/layers/nn.py (dynamic_lstm:330, dynamic_lstmp:442,
dynamic_gru:634, gru_unit:752, sequence_conv:1262, sequence_softmax:1312,
sequence_pool:1740, sequence_expand:2660, lstm_unit:3009, row_conv:4318,
lod_reset:4774, sequence_enumerate:6299, sequence_mask:6345).  Every
sequence is ``[batch, max_len, ...]`` plus int32 lengths; the rules are
in ``ops/sequence_ops.py``.
"""
from __future__ import annotations

from ..framework import Variable
from ..layer_helper import LayerHelper

__all__ = [
    "dynamic_lstm",
    "dynamic_lstmp",
    "dynamic_gru",
    "gru_unit",
    "lstm_unit",
    "sequence_conv",
    "sequence_softmax",
    "sequence_pool",
    "sequence_first_step",
    "sequence_last_step",
    "sequence_concat",
    "sequence_expand",
    "sequence_expand_as",
    "sequence_pad",
    "sequence_unpad",
    "sequence_mask",
    "sequence_reshape",
    "sequence_enumerate",
    "sequence_scatter",
    "sequence_slice",
    "sequence_erase",
    "lod_reset",
    "row_conv",
]


def dynamic_lstm(
    input,
    size,
    h_0=None,
    c_0=None,
    param_attr=None,
    bias_attr=None,
    use_peepholes=True,
    is_reverse=False,
    gate_activation="sigmoid",
    cell_activation="tanh",
    candidate_activation="tanh",
    dtype="float32",
    name=None,
):
    """LSTM over a padded batch (reference nn.py:330).  ``input`` is the
    pre-projected gate input [B, T, 4D] (apply ``fc`` first, as in the
    reference); ``size`` = 4*D.  Returns (hidden, cell), both [B, T, D]."""
    helper = LayerHelper("lstm", **locals())
    D = size // 4
    weight = helper.create_parameter(attr=helper.param_attr, shape=[D, 4 * D], dtype=dtype)
    bias_size = [1, 7 * D] if use_peepholes else [1, 4 * D]
    bias = helper.create_parameter(attr=helper.bias_attr, shape=bias_size, dtype=dtype, is_bias=True)
    hc_shape = None if input.shape is None else list(input.shape[:2]) + [D]
    hidden = helper.create_variable_for_type_inference(dtype, shape=hc_shape)
    cell = helper.create_variable_for_type_inference(dtype, shape=hc_shape)
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if c_0 is not None:
        inputs["C0"] = [c_0]
    helper.append_op(
        type="lstm",
        inputs=inputs,
        outputs={"Hidden": [hidden], "Cell": [cell]},
        attrs={
            "use_peepholes": use_peepholes,
            "is_reverse": is_reverse,
            "gate_activation": gate_activation,
            "cell_activation": cell_activation,
            "candidate_activation": candidate_activation,
        },
    )
    return hidden, cell


def dynamic_lstmp(
    input,
    size,
    proj_size,
    param_attr=None,
    bias_attr=None,
    use_peepholes=True,
    is_reverse=False,
    gate_activation="sigmoid",
    cell_activation="tanh",
    candidate_activation="tanh",
    proj_activation="tanh",
    dtype="float32",
    name=None,
):
    """Projected LSTM (reference nn.py:442).  Returns (projection, cell)."""
    helper = LayerHelper("lstmp", **locals())
    D = size // 4
    weight = helper.create_parameter(attr=helper.param_attr, shape=[proj_size, 4 * D], dtype=dtype)
    proj_weight = helper.create_parameter(attr=helper.param_attr, shape=[D, proj_size], dtype=dtype)
    bias_size = [1, 7 * D] if use_peepholes else [1, 4 * D]
    bias = helper.create_parameter(attr=helper.bias_attr, shape=bias_size, dtype=dtype, is_bias=True)
    proj = helper.create_variable_for_type_inference(
        dtype, shape=None if input.shape is None else list(input.shape[:2]) + [proj_size])
    cell = helper.create_variable_for_type_inference(
        dtype, shape=None if input.shape is None else list(input.shape[:2]) + [D])
    helper.append_op(
        type="lstmp",
        inputs={"Input": [input], "Weight": [weight], "ProjWeight": [proj_weight], "Bias": [bias]},
        outputs={"Projection": [proj], "Cell": [cell]},
        attrs={
            "use_peepholes": use_peepholes,
            "is_reverse": is_reverse,
            "gate_activation": gate_activation,
            "cell_activation": cell_activation,
            "candidate_activation": candidate_activation,
            "proj_activation": proj_activation,
        },
    )
    return proj, cell


def dynamic_gru(
    input,
    size,
    param_attr=None,
    bias_attr=None,
    is_reverse=False,
    gate_activation="sigmoid",
    candidate_activation="tanh",
    h_0=None,
    origin_mode=False,
):
    """GRU over a padded batch (reference nn.py:634).  ``input`` is the
    pre-projected [B, T, 3D]; ``size`` = D.  Returns hidden [B, T, D]."""
    helper = LayerHelper("gru", **locals())
    dtype = input.dtype
    weight = helper.create_parameter(attr=helper.param_attr, shape=[size, 3 * size], dtype=dtype)
    bias = helper.create_parameter(attr=helper.bias_attr, shape=[1, 3 * size], dtype=dtype, is_bias=True)
    hidden = helper.create_variable_for_type_inference(
        dtype, shape=None if input.shape is None else list(input.shape[:2]) + [size])
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    helper.append_op(
        type="gru",
        inputs=inputs,
        outputs={"Hidden": [hidden]},
        attrs={
            "is_reverse": is_reverse,
            "gate_activation": gate_activation,
            "candidate_activation": candidate_activation,
            "origin_mode": origin_mode,
        },
    )
    return hidden


def gru_unit(
    input,
    hidden,
    size,
    param_attr=None,
    bias_attr=None,
    activation="tanh",
    gate_activation="sigmoid",
    origin_mode=False,
):
    """Single GRU step (reference nn.py:752).  ``size`` = 3*D as in the
    reference; returns (new_hidden, reset_hidden_prev, gate)."""
    helper = LayerHelper("gru_unit", **locals())
    dtype = input.dtype
    D = size // 3
    act_ids = {"identity": 0, "sigmoid": 1, "tanh": 2, "relu": 3}
    weight = helper.create_parameter(attr=helper.param_attr, shape=[D, 3 * D], dtype=dtype)
    gate = helper.create_variable_for_type_inference(dtype)
    reset_hidden_pre = helper.create_variable_for_type_inference(dtype)
    updated_hidden = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "HiddenPrev": [hidden], "Weight": [weight]}
    if helper.bias_attr is not False:
        bias = helper.create_parameter(attr=helper.bias_attr, shape=[1, 3 * D], dtype=dtype, is_bias=True)
        inputs["Bias"] = [bias]
    helper.append_op(
        type="gru_unit",
        inputs=inputs,
        outputs={"Hidden": [updated_hidden], "Gate": [gate], "ResetHiddenPrev": [reset_hidden_pre]},
        attrs={
            "activation": act_ids[activation],
            "gate_activation": act_ids[gate_activation],
            "origin_mode": origin_mode,
        },
    )
    return updated_hidden, reset_hidden_pre, gate


def lstm_unit(
    x_t,
    hidden_t_prev,
    cell_t_prev,
    forget_bias=0.0,
    param_attr=None,
    bias_attr=None,
    name=None,
):
    """Single LSTM step (reference nn.py:3009): fc over concat(x, h_prev)
    produces the 4D gates {i,f,c,o}, then the elementwise cell update.
    Returns (hidden, cell)."""
    from . import nn as _nn
    from . import tensor as _tensor

    size = cell_t_prev.shape[-1]
    concat_out = _tensor.concat([x_t, hidden_t_prev], axis=-1)
    fc_out = _nn.fc(
        input=concat_out,
        size=4 * size,
        num_flatten_dims=len(concat_out.shape) - 1,
        param_attr=param_attr,
        bias_attr=bias_attr,
    )
    helper = LayerHelper("lstm_unit", name=name)
    c = helper.create_variable_for_type_inference(x_t.dtype)
    h = helper.create_variable_for_type_inference(x_t.dtype)
    helper.append_op(
        type="lstm_unit",
        inputs={"X": [fc_out], "C_prev": [cell_t_prev]},
        outputs={"C": [c], "H": [h]},
        attrs={"forget_bias": forget_bias},
    )
    return h, c


def sequence_conv(
    input,
    num_filters,
    filter_size=3,
    filter_stride=1,
    padding=None,
    bias_attr=None,
    param_attr=None,
    act=None,
    name=None,
):
    """Context-window convolution over the time axis (reference nn.py:1262)."""
    helper = LayerHelper("sequence_conv", **locals())
    dtype = helper.input_dtype()
    filter_shape = [filter_size * input.shape[-1], num_filters]
    filter_param = helper.create_parameter(attr=helper.param_attr, shape=filter_shape, dtype=dtype)
    out_shape = None if input.shape is None else list(input.shape[:-1]) + [num_filters]
    pre_bias = helper.create_variable_for_type_inference(dtype, shape=out_shape)
    helper.append_op(
        type="sequence_conv",
        inputs={"X": [input], "Filter": [filter_param]},
        outputs={"Out": [pre_bias]},
        attrs={
            "contextStride": filter_stride,
            "contextStart": -int(filter_size // 2),
            "contextLength": filter_size,
        },
    )
    pre_act = helper.append_bias_op(pre_bias, dim_start=2)
    return helper.append_activation(pre_act)


def sequence_softmax(input, param_attr=None, bias_attr=None, use_cudnn=False, name=None):
    """Softmax over each sequence's valid time steps (reference nn.py:1312)."""
    helper = LayerHelper("sequence_softmax", **locals())
    out = helper.create_variable_for_type_inference(input.dtype, shape=input.shape)
    helper.append_op(type="sequence_softmax", inputs={"X": [input]}, outputs={"Out": [out]})
    return out


def sequence_pool(input, pool_type):
    """Pool each sequence to one vector (reference nn.py:1740).
    pool_type: average|sum|sqrt|max|min|last|first."""
    helper = LayerHelper("sequence_pool", **locals())
    out_shape = None if input.shape is None else [input.shape[0]] + list(input.shape[2:])
    out = helper.create_variable_for_type_inference(input.dtype, shape=out_shape)
    max_index = helper.create_variable_for_type_inference("int32", stop_gradient=True)
    helper.append_op(
        type="sequence_pool",
        inputs={"X": [input]},
        outputs={"Out": [out], "MaxIndex": [max_index]},
        attrs={"pooltype": pool_type.upper()},
    )
    return out


def sequence_first_step(input):
    """First valid step of each sequence (reference nn.py:1839)."""
    return sequence_pool(input, "first")


def sequence_last_step(input):
    """Last valid step of each sequence (reference nn.py:1872)."""
    return sequence_pool(input, "last")


def sequence_concat(input, name=None):
    """Concatenate sequences along time, compacting padding (nn.py:1815)."""
    helper = LayerHelper("sequence_concat", **locals())
    out = helper.create_variable_for_type_inference(helper.input_dtype())
    helper.append_op(type="sequence_concat", inputs={"X": list(input)}, outputs={"Out": [out]})
    return out


def sequence_expand(x, y, ref_level=-1, name=None):
    """Expand x by y's sequence structure (reference nn.py:2660)."""
    helper = LayerHelper("sequence_expand", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="sequence_expand",
        inputs={"X": [x], "Y": [y]},
        outputs={"Out": [out]},
        attrs={"ref_level": ref_level},
    )
    return out


def sequence_expand_as(x, y, name=None):
    """Expand x to y's time extent (reference nn.py:2730)."""
    helper = LayerHelper("sequence_expand_as", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sequence_expand_as", inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]})
    return out


def sequence_pad(x, pad_value, maxlen=None, name=None):
    """Pad/re-pad a sequence batch to ``maxlen`` (reference nn.py:2796).
    Returns (padded, lengths)."""
    helper = LayerHelper("sequence_pad", **locals())
    if not hasattr(pad_value, "name"):  # python scalar -> constant var
        from .tensor import fill_constant

        pad_value = fill_constant(shape=[1], dtype=str(x.dtype), value=float(pad_value))
    out = helper.create_variable_for_type_inference(x.dtype)
    length = helper.create_variable_for_type_inference("int64", stop_gradient=True)
    helper.append_op(
        type="sequence_pad",
        inputs={"X": [x], "PadValue": [pad_value]},
        outputs={"Out": [out], "Length": [length]},
        attrs={"padded_length": -1 if maxlen is None else maxlen},
    )
    return out, length


def sequence_unpad(x, length, name=None):
    """Attach lengths to a dense batch, masking the padding (sequence_unpad_op)."""
    helper = LayerHelper("sequence_unpad", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sequence_unpad", inputs={"X": [x], "Length": [length]}, outputs={"Out": [out]})
    return out


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """lengths [B] -> mask [B, maxlen] (reference nn.py:6345)."""
    helper = LayerHelper("sequence_mask", **locals())
    out = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    inputs = {"X": [x]}
    attrs = {"out_dtype": dtype}
    if isinstance(maxlen, Variable):
        inputs["MaxLenTensor"] = [maxlen]
        attrs["maxlen"] = -1
    else:
        attrs["maxlen"] = -1 if maxlen is None else int(maxlen)
    helper.append_op(type="sequence_mask", inputs=inputs, outputs={"Y": [out]}, attrs=attrs)
    return out


def sequence_reshape(input, new_dim):
    """Re-chunk each sequence's features to width new_dim (reference nn.py:3907)."""
    helper = LayerHelper("sequence_reshape", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="sequence_reshape", inputs={"X": [input]}, outputs={"Out": [out]}, attrs={"new_dim": new_dim}
    )
    return out


def sequence_enumerate(input, win_size, pad_value=0, name=None):
    """Sliding-window id enumeration (reference nn.py:6299)."""
    helper = LayerHelper("sequence_enumerate", **locals())
    out = helper.create_variable_for_type_inference(input.dtype, stop_gradient=True)
    helper.append_op(
        type="sequence_enumerate",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"win_size": win_size, "pad_value": pad_value},
    )
    return out


def sequence_scatter(input, index, updates, name=None):
    """Scatter-add sequence updates into rows (reference nn.py:5450)."""
    helper = LayerHelper("sequence_scatter", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="sequence_scatter",
        inputs={"X": [input], "Ids": [index], "Updates": [updates]},
        outputs={"Out": [out]},
    )
    return out


def sequence_slice(input, offset, length, name=None):
    """Per-sequence slice by (offset, length) tensors (sequence_slice_op)."""
    helper = LayerHelper("sequence_slice", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="sequence_slice",
        inputs={"X": [input], "Offset": [offset], "Length": [length]},
        outputs={"Out": [out]},
    )
    return out


def sequence_erase(input, tokens, name=None):
    """Drop the listed token ids, compacting each sequence (sequence_erase_op)."""
    helper = LayerHelper("sequence_erase", **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="sequence_erase", inputs={"X": [input]}, outputs={"Out": [out]}, attrs={"tokens": list(tokens)}
    )
    return out


def lod_reset(x, y=None, target_lod=None):
    """Reset the sequence-length metadata (reference nn.py:4774)."""
    helper = LayerHelper("lod_reset", **locals())
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": [x]}
    attrs = {}
    if y is not None:
        inputs["Y"] = [y]
    elif target_lod is not None:
        attrs["target_lod"] = [int(v) for v in target_lod]
    else:
        raise ValueError("lod_reset needs y or target_lod")
    helper.append_op(type="lod_reset", inputs=inputs, outputs={"Out": [out]}, attrs=attrs)
    return out


def row_conv(input, future_context_size, param_attr=None, act=None, name=None):
    """Lookahead row convolution (reference nn.py:4318)."""
    helper = LayerHelper("row_conv", **locals())
    dtype = helper.input_dtype()
    filter_shape = [future_context_size + 1, input.shape[-1]]
    filter_param = helper.create_parameter(attr=helper.param_attr, shape=filter_shape, dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="row_conv", inputs={"X": [input], "Filter": [filter_param]}, outputs={"Out": [out]}
    )
    return helper.append_activation(out)
