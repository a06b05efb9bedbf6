"""Metric layers (reference: python/paddle/fluid/layers/metric_op.py).

The port's copy of the JAX package's ``paddle_tpu/layers/metric_op.py``:
``accuracy`` builds ``top_k`` + ``accuracy`` ops (both have rules);
``auc``'s op has no rule yet and raises when run."""
from __future__ import annotations

from ..framework import Variable
from ..initializer import Constant
from ..layer_helper import LayerHelper

__all__ = ["accuracy", "auc"]


def accuracy(input, label, k=1, correct=None, total=None):
    helper = LayerHelper("accuracy")
    topk_out = helper.create_variable_for_type_inference(dtype=input.dtype)
    topk_indices = helper.create_variable_for_type_inference(dtype="int64", stop_gradient=True)
    helper.append_op(
        type="top_k",
        inputs={"X": [input]},
        outputs={"Out": [topk_out], "Indices": [topk_indices]},
        attrs={"k": k},
    )
    acc_out = helper.create_variable_for_type_inference(dtype="float32", stop_gradient=True)
    if correct is None:
        correct = helper.create_variable_for_type_inference(dtype="int32", stop_gradient=True)
    if total is None:
        total = helper.create_variable_for_type_inference(dtype="int32", stop_gradient=True)
    helper.append_op(
        type="accuracy",
        inputs={"Out": [topk_out], "Indices": [topk_indices], "Label": [label]},
        outputs={"Accuracy": [acc_out], "Correct": [correct], "Total": [total]},
    )
    return acc_out


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1, slide_steps=1):
    helper = LayerHelper("auc")
    stat_pos = helper.create_global_variable(
        persistable=True, dtype="float32", shape=[num_thresholds + 1], name=helper.name + "_stat_pos"
    )
    stat_neg = helper.create_global_variable(
        persistable=True, dtype="float32", shape=[num_thresholds + 1], name=helper.name + "_stat_neg"
    )
    for v in (stat_pos, stat_neg):
        v.stop_gradient = True
        helper.set_variable_initializer(v, Constant(0.0))
    auc_out = helper.create_variable_for_type_inference(dtype="float32", stop_gradient=True)
    helper.append_op(
        type="auc",
        inputs={"Predict": [input], "Label": [label], "StatPos": [stat_pos], "StatNeg": [stat_neg]},
        outputs={"AUC": [auc_out], "StatPosOut": [stat_pos], "StatNegOut": [stat_neg]},
        attrs={"curve": curve, "num_thresholds": num_thresholds},
    )
    return auc_out, [stat_pos, stat_neg]
