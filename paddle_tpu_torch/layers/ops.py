"""Generated activation / simple op layers
(reference: python/paddle/fluid/layers/ops.py)."""
from __future__ import annotations

from ..layer_helper import LayerHelper

_ACT_NOATTR = [
    "sigmoid",
    "logsigmoid",
    "exp",
    "tanh",
    "tanh_shrink",
    "softplus",
    "softsign",
    "abs",
    "ceil",
    "floor",
    "cos",
    "sin",
    "round",
    "reciprocal",
    "square",
    "sqrt",
    "rsqrt",
    "selu",
    "sign",
]

__all__ = list(_ACT_NOATTR) + [
    "uniform_random", "hard_shrink", "softshrink", "cumsum", "thresholded_relu", "maxout",
]


def _make_act(op_type):
    def layer(x, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(dtype=x.dtype, shape=x.shape)
        helper.append_op(type=op_type, inputs={"X": [x]}, outputs={"Out": [out]})
        return out

    layer.__name__ = op_type
    layer.__doc__ = "%s activation (reference operators/activation_op.cc)" % op_type
    return layer


for _t in _ACT_NOATTR:
    globals()[_t] = _make_act(_t)


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random")
    out = helper.create_variable_for_type_inference(dtype=dtype, shape=shape)
    helper.append_op(
        type="uniform_random",
        outputs={"Out": [out]},
        attrs={"shape": list(shape), "dtype": dtype, "min": float(min), "max": float(max), "seed": seed or 0},
    )
    return out


def _attr_act(op_type, x, name=None, **attrs):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype, shape=x.shape)
    helper.append_op(type=op_type, inputs={"X": [x]}, outputs={"Out": [out]}, attrs=attrs)
    return out


def hard_shrink(x, threshold=0.5):
    return _attr_act("hard_shrink", x, threshold=threshold)


def softshrink(x, alpha=0.5):
    return _attr_act("softshrink", x, **{"lambda": alpha})


def thresholded_relu(x, threshold=1.0):
    return _attr_act("thresholded_relu", x, threshold=threshold)


def cumsum(x, axis=-1, exclusive=False, reverse=False):
    return _attr_act("cumsum", x, axis=axis, exclusive=exclusive, reverse=reverse)


def maxout(x, groups, name=None):
    helper = LayerHelper("maxout", name=name)
    shape = list(x.shape) if x.shape else None
    if shape:
        shape[1] = shape[1] // groups
    out = helper.create_variable_for_type_inference(dtype=x.dtype, shape=shape)
    helper.append_op(type="maxout", inputs={"X": [x]}, outputs={"Out": [out]}, attrs={"groups": groups})
    return out
