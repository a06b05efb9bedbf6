"""Learning-rate schedules (reference:
python/paddle/fluid/layers/learning_rate_scheduler.py).

The port's copy of the JAX package's schedules.  Each returns a Variable
computed in-graph from the global step counter, so the schedule runs as
ordinary ops before the update ops.
"""
from __future__ import annotations

import math

from ..framework import default_main_program
from ..layer_helper import LayerHelper
from . import nn
from . import ops
from . import tensor

__all__ = [
    "exponential_decay",
    "natural_exp_decay",
    "inverse_time_decay",
    "polynomial_decay",
    "piecewise_decay",
    "noam_decay",
    "append_LARS",
]


def _decay_step_counter(begin=0):
    global_step = nn.autoincreased_step_counter(counter_name="@LR_DECAY_COUNTER@", begin=begin, step=1)
    return tensor.cast(global_step, "float32")


def noam_decay(d_model, warmup_steps):
    """lr = d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)
    (reference learning_rate_scheduler.py:36; Transformer schedule)."""
    global_step = _decay_step_counter(1)
    a = nn.pow(global_step, -0.5)
    b = nn.pow(tensor.fill_constant([1], "float32", float(warmup_steps)), -1.5) * global_step
    lr_value = nn.elementwise_min(a, b) * (d_model**-0.5)
    return lr_value


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    """lr * decay_rate ^ (step / decay_steps), via exp(x·log r)."""
    global_step = _decay_step_counter()
    div_res = global_step / float(decay_steps)
    if staircase:
        div_res = ops.floor(div_res)
    return ops.exp(div_res * math.log(float(decay_rate))) * float(learning_rate)


def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    global_step = _decay_step_counter()
    div_res = global_step / float(decay_steps)
    if staircase:
        div_res = ops.floor(div_res)
    return ops.exp(div_res * (-float(decay_rate))) * float(learning_rate)


def inverse_time_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    global_step = _decay_step_counter()
    div_res = global_step / float(decay_steps)
    if staircase:
        div_res = ops.floor(div_res)
    return (div_res * float(decay_rate) + 1.0).__rtruediv__(float(learning_rate))


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001, power=1.0, cycle=False):
    global_step = _decay_step_counter()
    if cycle:
        div_res = ops.ceil(global_step / float(decay_steps))
        # avoid zero on step 0
        zero = tensor.fill_constant([1], "float32", 0.0)
        one = tensor.fill_constant([1], "float32", 1.0)
        div_res = nn.elementwise_max(div_res, one)
        decay_steps_var = div_res * float(decay_steps)
        frac = global_step / decay_steps_var
        del zero
    else:
        frac = nn.elementwise_min(
            global_step / float(decay_steps), tensor.fill_constant([1], "float32", 1.0)
        )
    base = (1.0 - frac) if power == 1.0 else (1.0 - frac) ** power
    return base * (float(learning_rate) - float(end_learning_rate)) + float(end_learning_rate)


def piecewise_decay(boundaries, values):
    """Step-function schedule; lowered as nested where()s on the step counter."""
    if len(values) - len(boundaries) != 1:
        raise ValueError("len(values) must equal len(boundaries) + 1")
    global_step = _decay_step_counter()
    helper = LayerHelper("piecewise_decay")
    lr = helper.create_variable_for_type_inference(dtype="float32", shape=[1])
    helper.append_op(
        type="piecewise_decay",
        inputs={"Step": [global_step]},
        outputs={"Out": [lr]},
        attrs={"boundaries": [float(b) for b in boundaries], "values": [float(v) for v in values]},
    )
    return lr


def append_LARS(params_grads, learning_rate, weight_decay):
    """Layer-wise adaptive rate scaling (reference
    learning_rate_scheduler.py:312)."""
    outs = []
    for param, grad in params_grads:
        p_norm = ops.sqrt(nn.reduce_sum(ops.square(param)))
        g_norm = ops.sqrt(nn.reduce_sum(ops.square(grad)))
        local_lr = learning_rate * p_norm / (g_norm + weight_decay * p_norm + 1e-12)
        outs.append(local_lr)
    return outs
