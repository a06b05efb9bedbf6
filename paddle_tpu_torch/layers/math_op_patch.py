"""Operator sugar on Variable (reference: python/paddle/fluid/layers/math_op_patch.py)."""
from __future__ import annotations

import numpy as np

from ..framework import Variable
from ..layer_helper import LayerHelper


def _to_variable(value, ref: Variable):
    if isinstance(value, Variable):
        return value
    helper = LayerHelper("const")
    out = helper.create_variable_for_type_inference(dtype=ref.dtype, shape=[1])
    helper.append_op(
        type="fill_constant",
        outputs={"Out": [out]},
        attrs={"shape": [1], "dtype": ref.dtype, "value": float(value)},
    )
    return out


def binary(x, y, op_type):
    ref = x if isinstance(x, Variable) else y
    x = _to_variable(x, ref)
    y = _to_variable(y, ref)
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(dtype=ref.dtype, shape=x.shape)
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]}, attrs={"axis": -1})
    return out


def compare(x, y, op_type):
    ref = x if isinstance(x, Variable) else y
    x = _to_variable(x, ref)
    y = _to_variable(y, ref)
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(dtype="bool", shape=x.shape)
    out.stop_gradient = True
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]})
    return out


def scale(x, factor):
    helper = LayerHelper("scale")
    out = helper.create_variable_for_type_inference(dtype=x.dtype, shape=x.shape)
    helper.append_op(type="scale", inputs={"X": [x]}, outputs={"Out": [out]}, attrs={"scale": float(factor)})
    return out
