"""VOC-style detection accuracy: per-class average precision and mAP@IoU.

A copy of ``repro/eval/detection_map.py``, pure numpy: the metric runs on
host-side arrays (the batched, fixed-size
:class:`repro_torch.models.postprocess.Detections` the serving path returns,
moved to the host) so it composes with every executor and with streamed
sessions. The JAX package pools the per-image matches through its sharded
evaluator's one-shard case; here the same pooling is written out.

Conventions match the rest of the repo:

* boxes are (cx, cy, w, h) in [0, 1] normalized image coordinates
  (``snn_yolo.decode_head`` output and ``synthetic_detection.sample``
  ground truth both use this format),
* matching is the VOC greedy rule: within an image, predictions are
  visited in descending score order; a prediction is a true positive if
  its best-IoU *unmatched* ground-truth box of the same class clears the
  IoU threshold, otherwise a false positive (duplicate detections of an
  already-matched box are FPs),
* AP is the all-points interpolated area under the precision-recall
  curve (VOC 2010+ / "continuous" definition),
* classes with zero ground-truth boxes are excluded from the mean
  (their AP is reported as NaN), matching the VOC evaluator.
"""
from __future__ import annotations

from typing import Any, Iterable, Mapping

import numpy as np


def iou_matrix_xywh(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of center-format boxes: (P, 4) × (G, 4) → (P, G)."""
    a = np.asarray(a, np.float64).reshape(-1, 4)
    b = np.asarray(b, np.float64).reshape(-1, 4)
    ax0, ay0 = a[:, 0] - a[:, 2] / 2, a[:, 1] - a[:, 3] / 2
    ax1, ay1 = a[:, 0] + a[:, 2] / 2, a[:, 1] + a[:, 3] / 2
    bx0, by0 = b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2
    bx1, by1 = b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2
    iw = np.maximum(
        np.minimum(ax1[:, None], bx1[None, :]) - np.maximum(ax0[:, None], bx0[None, :]), 0.0
    )
    ih = np.maximum(
        np.minimum(ay1[:, None], by1[None, :]) - np.maximum(ay0[:, None], by0[None, :]), 0.0
    )
    inter = iw * ih
    union = (a[:, 2] * a[:, 3])[:, None] + (b[:, 2] * b[:, 3])[None, :] - inter
    return inter / np.maximum(union, 1e-12)


def match_image(
    pred_boxes: np.ndarray,
    pred_scores: np.ndarray,
    gt_boxes: np.ndarray,
    *,
    iou_threshold: float = 0.5,
) -> np.ndarray:
    """Greedy VOC matching for ONE image and ONE class.

    Returns a bool array over predictions (in the order given): True = the
    prediction matched a previously-unmatched ground-truth box at
    IoU >= threshold. Predictions are visited in descending score order;
    ties keep the input order (stable sort).
    """
    p = np.asarray(pred_boxes, np.float64).reshape(-1, 4)
    g = np.asarray(gt_boxes, np.float64).reshape(-1, 4)
    tp = np.zeros(len(p), bool)
    if len(p) == 0 or len(g) == 0:
        return tp
    order = np.argsort(-np.asarray(pred_scores, np.float64), kind="stable")
    iou = iou_matrix_xywh(p, g)
    taken = np.zeros(len(g), bool)
    for i in order:
        j = int(np.argmax(np.where(taken, -1.0, iou[i])))
        if not taken[j] and iou[i, j] >= iou_threshold:
            taken[j] = True
            tp[i] = True
    return tp


def average_precision(scores: np.ndarray, tp: np.ndarray, n_gt: int) -> float:
    """All-points interpolated AP from pooled per-prediction match flags.

    ``scores``/``tp`` pool every prediction of one class across the whole
    split; ``n_gt`` is that class's total ground-truth count. Returns NaN
    when n_gt == 0 (class absent from the split), 0.0 when there are no
    predictions for a present class.
    """
    if n_gt == 0:
        return float("nan")
    scores = np.asarray(scores, np.float64).reshape(-1)
    tp = np.asarray(tp, bool).reshape(-1)
    if scores.size == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    tp = tp[order]
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(~tp)
    recall = cum_tp / n_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1)
    # precision envelope: max precision at any recall >= r
    env = np.maximum.accumulate(precision[::-1])[::-1]
    # integrate over the recall steps
    r_prev = 0.0
    ap = 0.0
    for r, p in zip(recall, env):
        if r > r_prev:
            ap += (r - r_prev) * p
            r_prev = r
    return float(ap)


def _as_image_preds(item: Any) -> Mapping[str, np.ndarray]:
    """Accept either a dict {boxes, scores, classes} or a Detections-like
    NamedTuple (boxes, scores, classes, valid) for one image."""
    if isinstance(item, Mapping):
        return item
    boxes = np.asarray(item.boxes)
    scores = np.asarray(item.scores)
    classes = np.asarray(item.classes)
    valid = np.asarray(item.valid).astype(bool)
    return {"boxes": boxes[valid], "scores": scores[valid], "classes": classes[valid]}


def detections_to_predictions(dets) -> list:
    """Batched Detections (host arrays) → list of per-image prediction
    dicts (padding rows dropped)."""
    boxes = np.asarray(dets.boxes)
    scores = np.asarray(dets.scores)
    classes = np.asarray(dets.classes)
    valid = np.asarray(dets.valid).astype(bool)
    out = []
    for i in range(boxes.shape[0]):
        v = valid[i]
        out.append(
            {"boxes": boxes[i][v], "scores": scores[i][v], "classes": classes[i][v]}
        )
    return out


def evaluate_detections(
    predictions: Iterable,
    ground_truths: Iterable[Mapping[str, Any]],
    *,
    num_classes: int,
    iou_threshold: float = 0.5,
) -> dict:
    """Per-class AP + mAP over a paired (predictions, ground_truths) split.

    ``predictions``: per image, a dict {boxes (P,4), scores (P,),
    classes (P,)} or a single-image Detections. ``ground_truths``: per
    image, a dict {boxes (G,4), classes (G,)}. Images align by position
    (a mismatched pairing raises — silent truncation would shrink the
    recall denominator and inflate mAP).

    Returns {"map": float, "per_class_ap": (C,) list (NaN = class absent),
    "n_gt": (C,) list, "n_pred": (C,) list, "n_images": int,
    "iou_threshold": float}. Scores pool as f32, as the JAX package's do.
    """
    preds = list(predictions)
    gts = list(ground_truths)
    if len(preds) != len(gts):
        raise ValueError(
            f"pairing mismatch: {len(preds)} predictions, {len(gts)} ground "
            "truths — images align by position"
        )
    n_gt = np.zeros(num_classes, np.int64)
    scores: list = [[] for _ in range(num_classes)]
    tps: list = [[] for _ in range(num_classes)]
    for pred, gt in zip(preds, gts):
        pred = _as_image_preds(pred)
        p_boxes = np.asarray(pred["boxes"], np.float64).reshape(-1, 4)
        p_scores = np.asarray(pred["scores"], np.float64).reshape(-1)
        p_cls = np.asarray(pred["classes"], np.int64).reshape(-1)
        g_boxes = np.asarray(gt["boxes"], np.float64).reshape(-1, 4)
        g_cls = np.asarray(gt["classes"], np.int64).reshape(-1)
        for c in range(num_classes):
            n_gt[c] += int(np.sum(g_cls == c))
            sel = p_cls == c
            if not np.any(sel):
                continue
            tps[c].extend(match_image(
                p_boxes[sel], p_scores[sel], g_boxes[g_cls == c],
                iou_threshold=iou_threshold,
            ).tolist())
            scores[c].extend(p_scores[sel].tolist())
    aps = [
        average_precision(np.asarray(scores[c], np.float32), np.asarray(tps[c], bool),
                          int(n_gt[c]))
        for c in range(num_classes)
    ]
    present = [a for a in aps if not np.isnan(a)]
    return {
        "map": float(np.mean(present)) if present else float("nan"),
        "per_class_ap": aps,
        "n_gt": n_gt.tolist(),
        "n_pred": [len(s) for s in scores],
        "n_images": len(preds),
        "iou_threshold": float(iou_threshold),
    }


def map50(
    predictions: Iterable,
    ground_truths: Iterable[Mapping[str, Any]],
    *,
    num_classes: int,
) -> float:
    """mAP at IoU 0.5 (the paper's headline metric on IVS 3cls)."""
    return evaluate_detections(
        predictions, ground_truths, num_classes=num_classes, iou_threshold=0.5
    )["map"]
