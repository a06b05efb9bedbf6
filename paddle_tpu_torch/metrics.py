"""Host-side metric accumulators.

Parity surface: python/paddle/fluid/metrics.py (reference) — same class
names and update()/eval() contracts, different machinery: every metric
declares its accumulator schema in ``_zero_state`` (so reset/snapshot are
generic), batch updates are vectorized numpy (no per-sample Python loops),
and DetectionMAP pools true/false positives across *all* accumulated
batches before building a single precision/recall curve — averaging
per-batch APs (what a naive port would do) is not mAP.

The port's copy of the JAX package's ``metrics.py``.  ``update`` takes
what ``Executor.run`` fetches (numpy arrays, ``LazyFetch``es, or tensors
with ``return_numpy=False``): every argument is brought to the host
first (:func:`_host`), so the numbers are the JAX package's on the same
values.
"""
from __future__ import annotations

import copy
import functools

import numpy as np
import torch

from .executor import LazyFetch, as_numpy

__all__ = [
    "MetricBase",
    "CompositeMetric",
    "Precision",
    "Recall",
    "Accuracy",
    "ChunkEvaluator",
    "EditDistance",
    "DetectionMAP",
    "Auc",
]


def _host(value):
    """A fetched value on the host: a tensor or a ``LazyFetch`` as its
    numpy array, anything else as it is."""
    if isinstance(value, torch.Tensor):
        return as_numpy(value)
    if isinstance(value, LazyFetch):
        return np.asarray(value)
    return value


def _host_args(update):
    """``update`` with every argument brought to the host first."""

    @functools.wraps(update)
    def wrapped(self, *args, **kwargs):
        return update(self, *map(_host, args),
                      **{k: _host(v) for k, v in kwargs.items()})

    return wrapped


class MetricBase:
    """A named, resettable accumulator.

    Subclasses override ``_zero_state`` to declare their accumulator
    fields and zero values; ``reset`` (re)installs them as attributes and
    ``get_config`` snapshots them.  ``update`` folds one fetched batch in;
    ``eval`` reduces the accumulated state to the metric value.
    """

    def __init__(self, name=None):
        self._name = str(name) if name is not None else type(self).__name__
        self.reset()

    def __str__(self):
        return self._name

    def _zero_state(self):
        return {}

    def reset(self):
        schema = self._zero_state()
        if schema:
            for field, zero in schema.items():
                setattr(self, field, copy.deepcopy(zero))
            return
        # No declared schema (external subclass in the reference style, state
        # attrs assigned in __init__): zero every public attribute by type.
        for attr, value in list(self.__dict__.items()):
            if attr.startswith("_"):
                continue
            if isinstance(value, bool):
                setattr(self, attr, False)
            elif isinstance(value, int):
                setattr(self, attr, 0)
            elif isinstance(value, float):
                setattr(self, attr, 0.0)
            elif isinstance(value, (np.ndarray, np.generic)):
                setattr(self, attr, np.zeros_like(value))
            else:
                setattr(self, attr, None)

    def get_config(self):
        snapshot = {
            field: copy.deepcopy(getattr(self, field)) for field in self._zero_state()
        }
        return {"name": self._name, "states": snapshot}

    def update(self, *args, **kwargs):
        raise NotImplementedError(
            "%s must implement update()" % type(self).__name__
        )

    def eval(self):
        raise NotImplementedError(
            "%s must implement eval()" % type(self).__name__
        )


class CompositeMetric(MetricBase):
    """Fans one (preds, labels) stream out to several metrics."""

    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        if not isinstance(metric, MetricBase):
            raise ValueError("add_metric expects a MetricBase, got %r" % (metric,))
        self._metrics.append(metric)

    @_host_args
    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


def _binary_counts(preds, labels):
    """Round probabilities to hard predictions and count tp/fp/fn in one
    pass.  Only the value 1 counts as positive on either side — an ignore
    label like -1 must not read as a positive."""
    hard = np.rint(np.asarray(preds, np.float64)).reshape(-1) == 1
    truth = np.asarray(labels).reshape(-1) == 1
    tp = int(np.count_nonzero(hard & truth))
    fp = int(np.count_nonzero(hard & ~truth))
    fn = int(np.count_nonzero(~hard & truth))
    return tp, fp, fn


class Precision(MetricBase):
    """Binary precision: tp / (tp + fp) over all seen batches."""

    def _zero_state(self):
        return {"tp": 0, "fp": 0}

    @_host_args
    def update(self, preds, labels):
        tp, fp, _ = _binary_counts(preds, labels)
        self.tp += tp
        self.fp += fp

    def eval(self):
        predicted_pos = self.tp + self.fp
        return self.tp / predicted_pos if predicted_pos else 0.0


class Recall(MetricBase):
    """Binary recall: tp / (tp + fn) over all seen batches."""

    def _zero_state(self):
        return {"tp": 0, "fn": 0}

    @_host_args
    def update(self, preds, labels):
        tp, _, fn = _binary_counts(preds, labels)
        self.tp += tp
        self.fn += fn

    def eval(self):
        actual_pos = self.tp + self.fn
        return self.tp / actual_pos if actual_pos else 0.0


class Accuracy(MetricBase):
    """Weighted running mean of per-batch accuracy values (the fetched
    output of ``layers.accuracy``), weighted by batch size."""

    def _zero_state(self):
        return {"value": 0.0, "weight": 0.0}

    @_host_args
    def update(self, value, weight):
        value = np.asarray(value, np.float64).reshape(-1)
        if value.size != 1:
            raise ValueError("Accuracy.update expects a scalar accuracy value")
        if weight < 0:
            raise ValueError("Accuracy.update weight must be >= 0")
        self.value += float(value[0]) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("no batches accumulated — call update first")
        return self.value / self.weight


class ChunkEvaluator(MetricBase):
    """Accumulates chunk_eval's three counters; eval -> (P, R, F1)."""

    def _zero_state(self):
        return {"num_infer_chunks": 0, "num_label_chunks": 0, "num_correct_chunks": 0}

    @_host_args
    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        def scalar(x):
            return int(np.asarray(x).reshape(-1)[0])

        self.num_infer_chunks += scalar(num_infer_chunks)
        self.num_label_chunks += scalar(num_label_chunks)
        self.num_correct_chunks += scalar(num_correct_chunks)

    def eval(self):
        correct = self.num_correct_chunks
        precision = correct / self.num_infer_chunks if self.num_infer_chunks else 0.0
        recall = correct / self.num_label_chunks if self.num_label_chunks else 0.0
        f1 = 2 * precision * recall / (precision + recall) if correct else 0.0
        return precision, recall, f1


class EditDistance(MetricBase):
    """Mean edit distance + fraction of imperfect sequences."""

    def _zero_state(self):
        return {"total_distance": 0.0, "seq_num": 0, "instance_error": 0}

    @_host_args
    def update(self, distances, seq_num):
        distances = np.asarray(distances, np.float64)
        self.total_distance += float(distances.sum())
        self.instance_error += int(np.count_nonzero(distances > 0))
        self.seq_num += int(np.asarray(seq_num).reshape(-1)[0])

    def eval(self):
        if self.seq_num == 0:
            raise ValueError("no data accumulated")
        return self.total_distance / self.seq_num, self.instance_error / self.seq_num


class DetectionMAP(MetricBase):
    """Mean average precision over every batch seen since reset.

    Each ``update`` stores the raw per-image detections and ground truth;
    ``eval`` matches detections to ground truth across the *whole*
    accumulated set and builds one global precision/recall curve per class
    (pooled TP/FP — equivalent to the reference's stateful detection_map
    op chain, and NOT the same as averaging per-batch mAPs, which
    overweights small batches and misorders scores across batches).
    """

    def __init__(self, name=None, num_classes=None, overlap_threshold=0.5,
                 ap_version="integral", background=0):
        self.num_classes = num_classes
        self.overlap_threshold = overlap_threshold
        self.ap_version = ap_version
        self.background = background
        super().__init__(name)

    def _zero_state(self):
        return {"_images": [], "_scalar_maps": []}

    def reset(self, executor=None, reset_program=None):
        # executor/reset_program accepted for reference API compatibility
        # (the reference resets in-graph state vars); our state is host-side.
        super().reset()

    @_host_args
    def update(self, detections, gt_boxes=None, gt_labels=None, gt_lens=None):
        if gt_boxes is None:
            # reference compat: a precomputed scalar mAP value
            self._scalar_maps.append(float(np.asarray(detections).reshape(-1)[0]))
            return
        self._images.extend(
            _split_images(detections, gt_boxes, gt_labels, gt_lens)
        )

    def eval(self):
        if self._images and self._scalar_maps:
            raise ValueError(
                "DetectionMAP saw both raw-detection and precomputed-scalar "
                "updates since reset; the two modes cannot be combined"
            )
        if self._images:
            return _map_over_images(
                self._images, self.num_classes, self.overlap_threshold,
                self.ap_version, self.background,
            )
        if self._scalar_maps:
            return float(np.mean(self._scalar_maps))
        raise ValueError("no data accumulated")


class Auc(MetricBase):
    """Streaming AUC: histogram positives/negatives by score bucket, then
    integrate the ROC curve over bucket prefix sums at eval."""

    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        self._curve = curve
        self._buckets = int(num_thresholds)
        super().__init__(name)

    def _zero_state(self):
        return {
            "_hist_pos": np.zeros(self._buckets + 1),
            "_hist_neg": np.zeros(self._buckets + 1),
        }

    @_host_args
    def update(self, preds, labels):
        preds = np.asarray(preds, np.float64)
        scores = preds[:, 1] if preds.ndim == 2 else preds.reshape(-1)
        truth = np.asarray(labels).reshape(-1).astype(bool)
        bins = np.clip((scores * self._buckets).astype(np.int64), 0, self._buckets)
        self._hist_pos += np.bincount(bins[truth], minlength=self._buckets + 1)
        self._hist_neg += np.bincount(bins[~truth], minlength=self._buckets + 1)

    def eval(self):
        # sweep the threshold from the top bucket down: prefix sums give the
        # (FP, TP) staircase; trapezoids integrate it in one vector op
        tp = np.cumsum(self._hist_pos[::-1])
        fp = np.cumsum(self._hist_neg[::-1])
        total_pos, total_neg = tp[-1], fp[-1]
        if total_pos == 0 or total_neg == 0:
            return 0.0
        tp_prev = np.concatenate([[0.0], tp[:-1]])
        fp_prev = np.concatenate([[0.0], fp[:-1]])
        area = np.sum((fp - fp_prev) * (tp + tp_prev) / 2.0)
        return float(area / (total_pos * total_neg))


# -- detection mAP machinery -------------------------------------------------


def _split_images(detections, gt_boxes, gt_labels, gt_lens):
    """Explode one fetched batch into per-image records:
    (det_rows [k, 6], gt_boxes [g, 4], gt_labels [g])."""
    detections = np.asarray(detections, np.float64)
    gt_boxes = np.asarray(gt_boxes, np.float64)
    gt_labels = np.asarray(gt_labels)
    gt_lens = np.asarray(gt_lens).astype(int).reshape(-1)
    images = []
    for b in range(len(gt_lens)):
        det = detections[b]
        det = det[det[:, 0] >= 0]  # drop invalid (-1) padding rows
        g = gt_lens[b]
        images.append((det, gt_boxes[b, :g], gt_labels[b, :g].reshape(-1)))
    return images


def _iou_one_to_many(box, others):
    """IoU of one [4] box against [g, 4] boxes, vectorized."""
    ix = np.clip(np.minimum(box[2], others[:, 2]) - np.maximum(box[0], others[:, 0]), 0, None)
    iy = np.clip(np.minimum(box[3], others[:, 3]) - np.maximum(box[1], others[:, 1]), 0, None)
    inter = ix * iy
    area = (box[2] - box[0]) * (box[3] - box[1])
    areas = (others[:, 2] - others[:, 0]) * (others[:, 3] - others[:, 1])
    union = area + areas - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def _average_precision(tp_sorted, npos, ap_version):
    """AP from a score-sorted tp/fp sequence for one class."""
    ctp = np.cumsum(tp_sorted)
    cfp = np.cumsum(1.0 - tp_sorted)
    recall = ctp / npos
    precision = ctp / np.maximum(ctp + cfp, 1e-12)
    if ap_version == "11point":
        return float(np.mean([
            precision[recall >= t].max() if (recall >= t).any() else 0.0
            for t in np.linspace(0, 1, 11)
        ]))
    # VOC2010 every-point interpolation: running max of precision from the
    # right, integrated over recall steps
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    steps = np.nonzero(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[steps + 1] - mrec[steps]) * mpre[steps + 1]))


def _map_over_images(images, num_classes, overlap_threshold, ap_version, background):
    """Pooled-mAP core: greedy-match each class's detections (globally
    score-sorted) to ground truth per image, then one AP per class."""
    aps = []
    for c in range(num_classes):
        if c == background:
            continue
        npos = sum(int((gl == c).sum()) for _, _, gl in images)
        entries = []  # (score, image index, box)
        for idx, (det, _, _) in enumerate(images):
            for row in det[det[:, 0] == c]:
                entries.append((float(row[1]), idx, row[2:6]))
        if npos == 0:
            continue
        entries.sort(key=lambda e: -e[0])
        claimed = [np.zeros(len(gl), bool) for _, _, gl in images]
        tp = np.zeros(len(entries))
        for i, (_, idx, box) in enumerate(entries):
            _, gb, gl = images[idx]
            cand = np.nonzero(gl == c)[0]
            if cand.size == 0:
                continue
            overlaps = _iou_one_to_many(box, gb[cand])
            j = int(np.argmax(overlaps))
            if overlaps[j] >= overlap_threshold and not claimed[idx][cand[j]]:
                claimed[idx][cand[j]] = True
                tp[i] = 1.0
        aps.append(_average_precision(tp, npos, ap_version))
    return float(np.mean(aps)) if aps else 0.0


def compute_detection_map(detections, gt_boxes, gt_labels, gt_lens, num_classes,
                          overlap_threshold=0.5, ap_version="integral", background=0):
    """mAP of one fetched batch (host-side analog of the reference's
    detection_map op output for a single evaluation pass).

    detections: ``detection_output`` result, [B, K, 6] rows
    (label, score, x0, y0, x1, y1), invalid rows -1.
    gt_boxes [B, G, 4], gt_labels [B, G], gt_lens [B].
    ap_version: 'integral' (VOC2010 every-point) or '11point'.
    """
    images = _split_images(*map(_host, (detections, gt_boxes, gt_labels,
                                        gt_lens)))
    return _map_over_images(images, num_classes, overlap_threshold, ap_version, background)
