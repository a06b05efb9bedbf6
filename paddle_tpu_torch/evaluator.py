"""Evaluator (reference: python/paddle/fluid/evaluator.py — deprecated there
in favor of fluid.metrics; kept for API parity).

The port's copy of the JAX package's ``evaluator.py``.  ``reset`` zeroes
(or fills) the state tensors in place, so a step bound to them stays
bound: a new tensor in their place would make the next run bind and
capture again.  ``eval`` reads them through ``as_numpy``."""
from __future__ import annotations

import warnings

import numpy as np
import torch

from .executor import as_numpy, global_scope
from .layer_helper import LayerHelper
from .initializer import Constant

__all__ = ["Evaluator", "ChunkEvaluator", "EditDistance", "DetectionMAP"]


def _fill_state(var, value):
    """Set the state ``var`` to ``value`` everywhere in the global scope:
    its tensor in place (no scope version bump), else a new numpy array
    as the JAX package writes."""
    scope = global_scope()
    owner = scope._owner(var.name)
    held = owner.vars[var.name] if owner is not None else None
    if isinstance(held, torch.Tensor):
        held.fill_(value)
        return
    scope[var.name] = np.full(
        [d if d > 0 else 1 for d in (var.shape or [1])], value,
        dtype=var.dtype if isinstance(var.dtype, str) else "float32")


def _state_value(var):
    """The state ``var``'s first value, from the global scope."""
    return float(as_numpy(global_scope()[var.name]).reshape(-1)[0])


def _clone_var_(block, var):
    return block.create_var(
        name=var.name,
        shape=var.shape,
        dtype=var.dtype,
        lod_level=var.lod_level,
        persistable=True,
    )


class Evaluator:
    """Accumulates metric states as persistable vars; ``eval`` runs a small
    program over them."""

    def __init__(self, name, **kwargs):
        warnings.warn("better to use fluid.metrics instead", Warning)
        self.states = []
        self.metrics = []
        self.helper = LayerHelper(name, **kwargs)

    def reset(self, executor, reset_program=None):
        for var in self.states:
            _fill_state(var, 0)

    def eval(self, executor, eval_program=None):
        raise NotImplementedError()

    def _create_state(self, suffix, dtype, shape, init_value=0.0):
        state = self.helper.create_global_variable(
            name="_".join([self.helper.name, str(suffix)]),
            persistable=True,
            dtype=dtype,
            shape=shape,
        )
        self.helper.set_variable_initializer(state, Constant(init_value))
        self.states.append(state)
        return state


class ChunkEvaluator(Evaluator):
    def __init__(self, input, label, chunk_scheme, num_chunk_types, excluded_chunk_types=None):
        super().__init__("chunk_eval")
        main_program = self.helper.main_program
        if main_program.current_block().idx != 0:
            raise ValueError("You can only invoke Evaluator in root block")
        self.num_infer_chunks = self._create_state(dtype="int64", shape=[1], suffix="num_infer_chunks")
        self.num_label_chunks = self._create_state(dtype="int64", shape=[1], suffix="num_label_chunks")
        self.num_correct_chunks = self._create_state(dtype="int64", shape=[1], suffix="num_correct_chunks")
        from .layers import chunk_eval as chunk_eval_layer  # type: ignore

        (precision, recall, f1_score, num_infer_chunks, num_label_chunks, num_correct_chunks) = chunk_eval_layer(
            input=input,
            label=label,
            chunk_scheme=chunk_scheme,
            num_chunk_types=num_chunk_types,
            excluded_chunk_types=excluded_chunk_types,
        )
        from .layers import tensor as tl

        tl.sums(input=[self.num_infer_chunks, num_infer_chunks], out=self.num_infer_chunks)
        tl.sums(input=[self.num_label_chunks, num_label_chunks], out=self.num_label_chunks)
        tl.sums(input=[self.num_correct_chunks, num_correct_chunks], out=self.num_correct_chunks)
        self.metrics.extend([precision, recall, f1_score])

    def eval(self, executor, eval_program=None):
        num_infer = _state_value(self.num_infer_chunks)
        num_label = _state_value(self.num_label_chunks)
        num_correct = _state_value(self.num_correct_chunks)
        precision = num_correct / num_infer if num_infer else 0.0
        recall = num_correct / num_label if num_label else 0.0
        f1 = 2 * precision * recall / (precision + recall) if num_correct else 0.0
        return np.array([precision]), np.array([recall]), np.array([f1])


class EditDistance(Evaluator):
    def __init__(self, input, label, ignored_tokens=None, **kwargs):
        super().__init__("edit_distance", **kwargs)
        from .layers import edit_distance as edit_distance_layer  # type: ignore

        distances, seq_num = edit_distance_layer(input=input, label=label, ignored_tokens=ignored_tokens)
        self.total_distance = self._create_state(dtype="float32", shape=[1], suffix="total_distance")
        self.seq_num = self._create_state(dtype="int64", shape=[1], suffix="seq_num")
        from .layers import nn, tensor as tl

        dist_sum = nn.reduce_sum(distances)
        tl.sums(input=[self.total_distance, dist_sum], out=self.total_distance)
        tl.sums(input=[self.seq_num, seq_num], out=self.seq_num)
        self.metrics.append(distances)

    def eval(self, executor, eval_program=None):
        total = _state_value(self.total_distance)
        n = _state_value(self.seq_num)
        return np.array([total / n if n else 0.0])


class DetectionMAP(Evaluator):
    """Accumulative detection mAP evaluator (reference evaluator.py:298).

    Builds two in-graph ``layers.detection_map`` ops: a stateless one for
    the current-minibatch mAP and a state-fed one whose accumulator
    outputs write back into this evaluator's persistable state vars, so
    every ``Executor.run`` of the training/eval program pools TP/FP/gt
    counts across batches.  Padded-contract inputs (see
    layers/detection.py detection_map): ``input`` [B, K, 6],
    ``gt_box`` [B, G, 4], ``gt_label`` [B, G] (+ lengths via LoDArray).
    With ``evaluate_difficult=False``, difficult gt follow the reference
    rule: excluded from the positive count, and detections matched to one
    are neutral (neither TP nor FP).
    """

    def __init__(self, input, gt_label, gt_box, gt_difficult=None,
                 class_num=None, background_label=0, overlap_threshold=0.5,
                 evaluate_difficult=True, ap_version="integral",
                 state_capacity=512):
        super().__init__("map_eval")
        from .layers import detection as det_layers
        from .layers import tensor as tl

        if class_num is None:
            raise ValueError("DetectionMAP needs class_num")
        label = gt_label
        # difficult gt ride the op's native path (reference rule: excluded
        # from npos, matched detections neutral — NOT false positives)
        diff_kwargs = dict(gt_difficult=gt_difficult,
                           evaluate_difficult=evaluate_difficult)

        # current-minibatch mAP (stateless)
        self.cur_map, _, _, _ = det_layers.detection_map(
            input, gt_box, label, class_num,
            background_label=background_label,
            overlap_threshold=overlap_threshold,
            ap_version=ap_version, state_capacity=state_capacity,
            **diff_kwargs)

        # accumulative mAP: accumulator outputs ARE the persistable states
        pc = self._create_state(dtype="int32", shape=[class_num, 1],
                                suffix="accum_pos_count")
        # -1 marks an empty TP/FP score slot (see ops/detection_ops.py)
        tp = self._create_state(dtype="float32", shape=[class_num, state_capacity, 2],
                                suffix="accum_true_pos", init_value=-1.0)
        fp = self._create_state(dtype="float32", shape=[class_num, state_capacity, 2],
                                suffix="accum_false_pos", init_value=-1.0)
        accum_map, pc_out, tp_out, fp_out = det_layers.detection_map(
            input, gt_box, label, class_num,
            background_label=background_label,
            overlap_threshold=overlap_threshold,
            input_states=(pc, tp, fp),
            ap_version=ap_version, state_capacity=state_capacity,
            **diff_kwargs)
        tl.assign(pc_out, output=pc)
        tl.assign(tp_out, output=tp)
        tl.assign(fp_out, output=fp)
        self.accum_map = accum_map
        self.metrics.extend([self.cur_map, accum_map])

    def get_map_var(self):
        """(current-batch mAP var, accumulative mAP var) — fetch both."""
        return self.cur_map, self.accum_map

    def reset(self, executor, reset_program=None):
        """Empty the pooled TP/FP state (score slots use -1 as 'empty')."""
        for var in self.states:
            _fill_state(var, 0 if var.name.endswith("pos_count") else -1.0)
