"""Gradient / error clipping (reference: python/paddle/fluid/clip.py)."""
from __future__ import annotations

import functools

from .framework import Variable, default_main_program
from .layer_helper import LayerHelper

__all__ = [
    "ErrorClipByValue",
    "GradientClipByValue",
    "GradientClipByNorm",
    "GradientClipByGlobalNorm",
    "set_gradient_clip",
    "append_gradient_clip_ops",
    "error_clip_callback",
]


class BaseErrorClipAttr:
    def _append_clip_op(self, block, grad_name):
        raise NotImplementedError


class ErrorClipByValue(BaseErrorClipAttr):
    def __init__(self, max, min=None):
        max = float(max)
        min = float(min) if min is not None else -max
        self.max = max
        self.min = min

    def _append_clip_op(self, block, grad_name):
        block.append_op(
            type="clip",
            inputs={"X": [grad_name]},
            outputs={"Out": [grad_name]},
            attrs={"min": self.min, "max": self.max},
        )


def error_clip_callback(block, context):
    op_desc = block.ops[-1]
    for grad_n in op_desc.all_output_names():
        fwd_var = block.var_recursive(grad_n.replace("@GRAD", ""))
        error_clip = getattr(fwd_var, "error_clip", None)
        if error_clip is not None:
            error_clip._append_clip_op(block, grad_n)


class BaseGradientClipAttr:
    def _process_context(self, context, param, grad):
        raise NotImplementedError

    def _create_operators(self, param, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        return param, grad


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        max = float(max)
        min = float(min) if min is not None else -max
        self.max = max
        self.min = min

    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        from .layers import nn

        new_grad = nn.clip(x=grad, min=self.min, max=self.max)
        return param, new_grad


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        from .layers import nn

        new_grad = nn.clip_by_norm(x=grad, max_norm=self.clip_norm)
        return param, new_grad


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """scale_i = clip_norm / max(global_norm, clip_norm)
    (reference clip.py:199)."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _process_context(self, context, param, grad):
        if self.group_name not in context:
            context[self.group_name] = []
            context[self.group_name + "_clip_value"] = self.clip_norm
        elif context[self.group_name + "_clip_value"] != self.clip_norm:
            raise ValueError("all parameters' 'clip_norm' of a same group should be the same")
        from .layers import nn, ops

        sq = nn.reduce_sum(ops.square(grad))
        context[self.group_name].append(sq)
        self.context = context

    def _create_operators(self, param, grad):
        from .layers import nn, ops, tensor

        group_scale_name = self.group_name + "_scale"
        if group_scale_name not in self.context:
            group_norm = ops.sqrt(nn.sum(self.context[self.group_name]))
            clip_var = tensor.fill_constant(shape=[1], dtype=group_norm.dtype, value=self.clip_norm)
            group_scale = nn.elementwise_div(
                x=clip_var, y=nn.elementwise_max(x=clip_var, y=group_norm)
            )
            self.context[group_scale_name] = group_scale
        new_grad = nn.elementwise_mul(x=grad, y=self.context[group_scale_name])
        return param, new_grad


def set_gradient_clip(clip, param_list=None, program=None):
    if not isinstance(clip, BaseGradientClipAttr):
        raise TypeError("clip should be an instance of BaseGradientClipAttr")
    program = program or default_main_program()
    if param_list is None:
        param_list = program.global_block().all_parameters()
    if all(isinstance(elem, str) for elem in param_list):
        param_list = [program.global_block().var(elem) for elem in param_list]
    for param in param_list:
        param.gradient_clip_attr = clip


def append_gradient_clip_ops(param_grads):
    context = {}
    for p, g in param_grads:
        clip_attr = getattr(p, "gradient_clip_attr", None) or NullGradientClipAttr()
        clip_attr._process_context(context=context, param=p, grad=g)
    res = []
    for p, g in param_grads:
        clip_attr = getattr(p, "gradient_clip_attr", None) or NullGradientClipAttr()
        res.append(clip_attr._create_operators(param=p, grad=g))
    return res
