"""Tensor-creation layers (reference: python/paddle/fluid/layers/tensor.py)."""
from __future__ import annotations

import numpy as np

from ..framework import Variable, default_main_program
from ..initializer import Constant
from ..layer_helper import LayerHelper

__all__ = [
    "create_tensor",
    "create_parameter",
    "create_global_var",
    "cast",
    "concat",
    "sums",
    "assign",
    "fill_constant",
    "fill_constant_batch_size_like",
    "argmin",
    "argmax",
    "argsort",
    "ones",
    "zeros",
    "reverse",
    "has_inf",
    "has_nan",
    "isfinite",
]


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_variable(name=helper.name, dtype=dtype, persistable=persistable)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False, default_initializer=None):
    from ..param_attr import ParamAttr

    helper = LayerHelper("create_parameter", name=name)
    attr = attr or ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias, default_initializer)


def create_global_var(shape, value, dtype, persistable=False, force_cpu=False, name=None):
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(
        dtype=dtype, shape=shape, persistable=persistable, name=name or helper.name
    )
    helper.set_variable_initializer(var, Constant(value=float(value)))
    return var


def cast(x, dtype):
    from ..core import canonical_dtype

    dtype = canonical_dtype(dtype)
    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(dtype=dtype, shape=x.shape)
    helper.append_op(
        type="cast",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"in_dtype": x.dtype, "out_dtype": dtype},
    )
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    shape = None
    if all(v.shape is not None for v in input):
        shape = list(input[0].shape)
        ax = axis % len(shape)
        try:
            shape[ax] = sum(v.shape[ax] for v in input)
        except TypeError:
            shape = None
    out = helper.create_variable_for_type_inference(dtype=input[0].dtype, shape=shape)
    helper.append_op(type="concat", inputs={"X": input}, outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def sums(input, out=None):
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=input[0].dtype, shape=input[0].shape)
    helper.append_op(type="sum", inputs={"X": input}, outputs={"Out": [out]})
    return out


def assign(input, output=None):
    helper = LayerHelper("assign")
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_variable_for_type_inference(dtype=input.dtype, shape=input.shape)
        helper.append_op(type="assign", inputs={"X": [input]}, outputs={"Out": [output]})
    else:
        arr = np.asarray(input)
        if output is None:
            output = helper.create_variable_for_type_inference(dtype=str(arr.dtype), shape=arr.shape)
        helper.append_op(
            type="assign_value",
            outputs={"Out": [output]},
            attrs={"shape": list(arr.shape), "dtype": str(arr.dtype), "values": arr},
        )
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=dtype, shape=shape)
    helper.append_op(
        type="fill_constant",
        outputs={"Out": [out]},
        attrs={"shape": list(shape), "dtype": dtype, "value": float(value)},
    )
    out.stop_gradient = True
    return out


def fill_constant_batch_size_like(input, shape, dtype, value, input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype=dtype, shape=shape)
    helper.append_op(
        type="fill_constant_batch_size_like",
        inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={
            "shape": list(shape),
            "dtype": dtype,
            "value": float(value),
            "input_dim_idx": input_dim_idx,
            "output_dim_idx": output_dim_idx,
        },
    )
    out.stop_gradient = True
    return out


def _arg_op(x, axis, op_type):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(dtype="int64")
    out.stop_gradient = True
    helper.append_op(type=op_type, inputs={"X": [x]}, outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def argmin(x, axis=0):
    return _arg_op(x, axis, "arg_min")


def argmax(x, axis=0):
    return _arg_op(x, axis, "arg_max")


def argsort(input, axis=-1, name=None):
    helper = LayerHelper("argsort", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype, shape=input.shape)
    ids = helper.create_variable_for_type_inference(dtype="int64", shape=input.shape)
    ids.stop_gradient = True
    helper.append_op(
        type="argsort", inputs={"X": [input]}, outputs={"Out": [out], "Indices": [ids]}, attrs={"axis": axis}
    )
    return out, ids


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=1.0)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=0.0)


def reverse(x, axis):
    helper = LayerHelper("reverse")
    out = helper.create_variable_for_type_inference(dtype=x.dtype, shape=x.shape)
    helper.append_op(type="reverse", inputs={"X": [x]}, outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def _unary_flag(x, op_type):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(dtype="bool", shape=[1])
    out.stop_gradient = True
    helper.append_op(type=op_type, inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def has_inf(x):
    return _unary_flag(x, "has_inf")


def has_nan(x):
    return _unary_flag(x, "has_nan")


def isfinite(x):
    return _unary_flag(x, "isfinite")
