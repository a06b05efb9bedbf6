"""Weight-decay regularizers (reference: python/paddle/fluid/regularizer.py).

The port's copy of the JAX package's ``paddle_tpu/regularizer.py``: the
decay term is appended to each gradient as ordinary ops.
"""
from __future__ import annotations

from .framework import Variable
from .layer_helper import LayerHelper

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer", "append_regularization_ops"]


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    """grad += coeff * param"""

    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        helper = LayerHelper("l2_decay")
        decay = helper.create_variable_for_type_inference(dtype=param.dtype, shape=param.shape)
        block.append_op(
            type="scale",
            inputs={"X": [param]},
            outputs={"Out": [decay]},
            attrs={"scale": self._regularization_coeff},
        )
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    """grad += coeff * sign(param)"""

    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        helper = LayerHelper("l1_decay")
        sign = helper.create_variable_for_type_inference(dtype=param.dtype, shape=param.shape)
        decay = helper.create_variable_for_type_inference(dtype=param.dtype, shape=param.shape)
        block.append_op(type="sign", inputs={"X": [param]}, outputs={"Out": [sign]})
        block.append_op(
            type="scale",
            inputs={"X": [sign]},
            outputs={"Out": [decay]},
            attrs={"scale": self._regularization_coeff},
        )
        return decay


def append_regularization_ops(parameters_and_grads, regularization=None):
    params_and_grads = []
    for param, grad in parameters_and_grads:
        regularization_term = None
        if grad is None:
            params_and_grads.append((param, grad))
            continue
        if param.regularizer is not None:
            regularization_term = param.regularizer(param, grad, grad.block)
        elif regularization is not None:
            regularization_term = regularization(param, grad, grad.block)
        if regularization_term is None:
            params_and_grads.append((param, grad))
            continue
        helper = LayerHelper("regularized")
        new_grad = helper.create_variable_for_type_inference(dtype=param.dtype, shape=param.shape)
        grad.block.append_op(
            type="elementwise_add",
            inputs={"X": [grad], "Y": [regularization_term]},
            outputs={"Out": [new_grad]},
            attrs={"axis": -1},
        )
        params_and_grads.append((param, new_grad))
    return params_and_grads


# reference-style aliases
L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
