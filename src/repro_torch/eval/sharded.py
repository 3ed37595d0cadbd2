"""Sharded mAP evaluation: stripe the val split, reduce exactly.

Counterpart of ``repro/eval/sharded.py``. ``harness.evaluate_detector``
scores the whole split in one process; here the images are split across
shards, each shard's forward→decode→NMS runs through the compile-once
executor plan, and the pooled per-class (score, TP) lists reduce before the
AP sweep. The reduction is EXACT — the pooled precision-recall curve, and
so the mAP, is bit-identical to the single-process evaluation:

* shard s of k owns global image indices s, s+k, s+2k, ...
  (``synthetic_detection.eval_shard_indices``),
* VOC greedy matching is per image, so it shards embarrassingly; each shard
  emits flat per-prediction records (global image index, class, score, TP
  flag) plus its per-class ground-truth counts (:func:`match_stats`),
* the records are gathered — on the host (one process, one card or none),
  across the visible cards (one process, ``n_shards`` cards or more), or
  across the processes of a job (``distributed.collectives
  .eval_stats_allgather``: an all-gather of the padded rows and an integer
  all-reduce of the recall denominators) — and re-sorted by global image
  index (stable), which rebuilds the single-process pooling order exactly,
  so score ties resolve identically.

Under a multi-controller launch (``distributed.runtime.initialize``),
process ``i`` walks only shards ``i, i+P, ...``
(:meth:`DistributedContext.owned_shards`) and every process returns the
same full report. ``n_shards`` must stripe evenly over the processes.

Scores travel as float32, the detector's native dtype, so the gather is
bit-preserving.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.data import synthetic_detection as sd
from repro_torch.distributed import collectives as C
from repro_torch.distributed import runtime
from repro_torch.eval import detection_map as dm


@dataclass(frozen=True)
class ShardedEvalConfig:
    """How to split and reduce one evaluation.

    * ``n_shards`` — stripe count; shard s owns image indices s, s+k, ...
    * ``batch`` — per-shard forward chunk size (outputs are bitwise
      invariant to batch grouping, so this only trades memory for speed).
    * ``use_device_mesh`` — None: gather across the cards when ``n_shards``
      cards are visible, else on the host. True forces the card gather
      (raises without enough cards); False forces the host.
    """

    n_shards: int = 1
    batch: int = 8
    use_device_mesh: Optional[bool] = None

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")


@dataclass
class ShardStats:
    """One shard's flat match records + recall denominators, appended in
    ascending global image order and, within an image, in the order
    ``detection_map.evaluate_detections`` pools in — so a stable re-sort of
    the concatenated shards by ``image_idx`` IS the single-process order."""

    image_idx: np.ndarray  # (P,) int32 global image index per prediction
    cls: np.ndarray  # (P,) int32
    score: np.ndarray  # (P,) float32
    tp: np.ndarray  # (P,) bool
    n_gt: np.ndarray  # (C,) int32 per-class ground-truth count
    n_images: int

    @classmethod
    def empty(cls, num_classes: int) -> "ShardStats":
        return cls(image_idx=np.zeros(0, np.int32), cls=np.zeros(0, np.int32),
                   score=np.zeros(0, np.float32), tp=np.zeros(0, bool),
                   n_gt=np.zeros(num_classes, np.int32), n_images=0)


def match_stats(predictions: Iterable, ground_truths: Iterable[Mapping[str, Any]],
                image_indices: Sequence[int], *, num_classes: int,
                iou_threshold: float = 0.5) -> ShardStats:
    """Greedy-match one shard's (predictions, ground_truths) — the per-image
    half of ``detection_map.evaluate_detections`` — and record every pooled
    entry with its GLOBAL image index."""
    idx_out: list = []
    cls_out: list = []
    score_out: list = []
    tp_out: list = []
    n_gt = np.zeros(num_classes, np.int32)
    preds = list(predictions)
    gts = list(ground_truths)
    if not len(preds) == len(gts) == len(image_indices):
        raise ValueError(
            f"pairing mismatch: {len(preds)} predictions, {len(gts)} ground truths, "
            f"{len(image_indices)} image indices — images align by position")
    for pred, gt, g_idx in zip(preds, gts, image_indices):
        pred = dm._as_image_preds(pred)
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
            tp = dm.match_image(p_boxes[sel], p_scores[sel], g_boxes[g_cls == c],
                                iou_threshold=iou_threshold)
            k = int(np.sum(sel))
            idx_out.extend([int(g_idx)] * k)
            cls_out.extend([c] * k)
            score_out.extend(p_scores[sel].tolist())
            tp_out.extend(tp.tolist())
    return ShardStats(image_idx=np.asarray(idx_out, np.int32), cls=np.asarray(cls_out, np.int32),
                      score=np.asarray(score_out, np.float32), tp=np.asarray(tp_out, bool),
                      n_gt=n_gt, n_images=len(preds))


# ------------------------------------------------------------------ reduce --


def _gather_host(stats: Sequence[ShardStats]) -> ShardStats:
    """Reference reduction: plain concatenation + integer sum."""
    return ShardStats(
        image_idx=np.concatenate([s.image_idx for s in stats]),
        cls=np.concatenate([s.cls for s in stats]),
        score=np.concatenate([s.score for s in stats]),
        tp=np.concatenate([s.tp for s in stats]),
        n_gt=np.sum([s.n_gt for s in stats], axis=0).astype(np.int32),
        n_images=sum(s.n_images for s in stats),
    )


def _pad_rows(stats: Sequence[ShardStats], cap: int) -> tuple[dict, np.ndarray]:
    """Each shard's records as one row padded to ``cap``, with a ``valid``
    mask and its image count (so a shard with no predictions still counts
    its images), and the (k, C) ground-truth counts: the payload of every
    gather but the host one."""
    def pad(x, fill=0):
        out = np.full((cap,), fill, dtype=x.dtype)
        out[: x.size] = x
        return out

    rows = {
        "image_idx": np.stack([pad(s.image_idx) for s in stats]),
        "cls": np.stack([pad(s.cls) for s in stats]),
        "score": np.stack([pad(s.score) for s in stats]),
        "tp": np.stack([pad(s.tp) for s in stats]),
        "valid": np.stack([pad(np.ones(s.image_idx.size, bool), fill=False) for s in stats]),
        "n_images": np.asarray([[s.n_images] for s in stats], np.int32),
    }
    return rows, np.stack([s.n_gt for s in stats]).astype(np.int32)


def _unpad_rows(g: dict, total_gt: np.ndarray) -> ShardStats:
    """The gathered rows back to flat records, in row order, dropping the
    padding by the gathered ``valid`` mask."""
    valid = g["valid"].astype(bool)
    k = valid.shape[0]
    return ShardStats(
        image_idx=np.concatenate([g["image_idx"][s][valid[s]] for s in range(k)]),
        cls=np.concatenate([g["cls"][s][valid[s]] for s in range(k)]),
        score=np.concatenate([g["score"][s][valid[s]] for s in range(k)]),
        tp=np.concatenate([g["tp"][s][valid[s]].astype(bool) for s in range(k)]),
        n_gt=np.asarray(total_gt, np.int32),
        n_images=int(g["n_images"].sum()),
    )


def _gather_mesh(stats: Sequence[ShardStats]) -> ShardStats:
    """The single-process reduction across the cards: row s on card s,
    gathered and summed by ``collectives.device_allgather``. Needs one
    visible card per shard."""
    k = len(stats)
    n_dev = torch.cuda.device_count()
    if n_dev < k:
        raise ValueError(f"the card gather of {k} shards needs {k} devices; "
                         f"{n_dev} CUDA devices are visible")
    rows, counts = _pad_rows(stats, max(1, max(s.image_idx.size for s in stats)))
    return _unpad_rows(*C.device_allgather(rows, counts, k))


def _gather_process(local: ShardStats, ctx) -> ShardStats:
    """The multi-controller reduction: every host contributes ONE row (its
    merged owned-shard records). Two phases over ``eval_stats_allgather``:
    an int gather agrees on the padded row capacity (hosts own different
    record counts), then the padded rows gather and the counts sum."""
    sizes, _ = C.eval_stats_allgather({"n": np.array([[local.image_idx.size]], np.int32)},
                                      np.zeros((1, 1), np.int32), ctx)
    rows, counts = _pad_rows([local], max(1, int(sizes["n"].max())))
    return _unpad_rows(*C.eval_stats_allgather(rows, counts, ctx))


def _pick_gather(eval_cfg: ShardedEvalConfig) -> str:
    if eval_cfg.n_shards == 1:
        return "host"  # nothing to reduce
    use = eval_cfg.use_device_mesh
    if use is None:
        use = torch.cuda.device_count() >= eval_cfg.n_shards
    return "mesh" if use else "host"


def pool_stats(stats: Sequence[ShardStats], *, num_classes: int, iou_threshold: float = 0.5,
               eval_cfg: Optional[ShardedEvalConfig] = None, ctx=None) -> dict:
    """Reduce per-shard stats and sweep AP — the sharded back half of
    ``detection_map.evaluate_detections``, bit-identical to it.

    Single-controller (``stats`` holds EVERY shard): gathers across the
    cards or on the host per ``eval_cfg``. Multi-controller (``stats``
    holds only this host's owned shards): merges the local shards, then
    reduces across processes (:func:`_gather_process`). Either way the
    pooled records stable-sort by global image index, which is exactly the
    order the single-process evaluator pooled in. Returns the
    ``evaluate_detections`` report plus ``n_shards``/``n_hosts``/``gather``.
    """
    ctx = ctx or runtime.get_context()
    if ctx.is_multi_controller:
        eval_cfg = eval_cfg or ShardedEvalConfig(n_shards=len(stats) * ctx.n_hosts)
        gather = "process"
        local = _gather_host(stats) if stats else ShardStats.empty(num_classes)
        merged = _gather_process(local, ctx)
        n_shards = eval_cfg.n_shards
    else:
        eval_cfg = eval_cfg or ShardedEvalConfig(n_shards=len(stats))
        gather = _pick_gather(eval_cfg)
        merged = _gather_mesh(stats) if gather == "mesh" else _gather_host(stats)
        n_shards = len(stats)
    order = np.argsort(merged.image_idx, kind="stable")
    cls = merged.cls[order]
    score = merged.score[order]
    tp = merged.tp[order]
    aps, n_pred = [], []
    for c in range(num_classes):
        sel = cls == c
        n_pred.append(int(np.sum(sel)))
        aps.append(dm.average_precision(score[sel], tp[sel], int(merged.n_gt[c])))
    present = [a for a in aps if not np.isnan(a)]
    return {
        "map": float(np.mean(present)) if present else float("nan"),
        "per_class_ap": aps,
        "n_gt": merged.n_gt.astype(np.int64).tolist(),
        "n_pred": n_pred,
        "n_images": int(merged.n_images),
        "iou_threshold": float(iou_threshold),
        "n_shards": n_shards,
        "n_hosts": ctx.n_hosts,
        "gather": gather,
    }


def _same_ap(a: float, b: float) -> bool:
    return a == b or (np.isnan(a) and np.isnan(b))


def reports_identical(a: Mapping[str, Any], b: Mapping[str, Any]) -> bool:
    """NaN-aware exact equality of two evaluation reports on every shared
    key (mAP, per-class AP, GT/prediction counts, image count, IoU
    threshold); sharded-only keys such as ``n_shards``/``gather`` are
    ignored. The ``eval_map --shards`` and serve ``--eval-map`` gates."""
    return (
        _same_ap(a["map"], b["map"])
        and len(a["per_class_ap"]) == len(b["per_class_ap"])
        and all(_same_ap(x, y) for x, y in zip(a["per_class_ap"], b["per_class_ap"]))
        and a["n_gt"] == b["n_gt"]
        and a["n_pred"] == b["n_pred"]
        and a["n_images"] == b["n_images"]
        and a["iou_threshold"] == b["iou_threshold"]
    )


# ------------------------------------------------------------- evaluators --


def evaluate_predictions_sharded(predictions: Sequence, ground_truths: Sequence[Mapping[str, Any]],
                                 *, num_classes: int, iou_threshold: float = 0.5,
                                 eval_cfg: Optional[ShardedEvalConfig] = None,
                                 ctx=None) -> dict:
    """Sharded scoring of already-computed predictions (the serve
    ``--eval-map`` path): stripe the paired lists across
    ``eval_cfg.n_shards``, match per shard, reduce. Bit-identical to
    ``detection_map.evaluate_detections`` on the same pairing for any shard
    count, empty shards included, provided the scores are
    float32-representable (detector outputs are).

    Multi-controller: this host matches only its owned shards and the
    reduction crosses processes — every host passes the same pairing and
    returns the same full report."""
    ctx = ctx or runtime.get_context()
    eval_cfg = eval_cfg or ShardedEvalConfig(n_shards=max(1, ctx.n_hosts))
    ctx.validate_shard_count(eval_cfg.n_shards)
    predictions = list(predictions)
    ground_truths = list(ground_truths)
    if len(predictions) != len(ground_truths):
        raise ValueError(f"{len(predictions)} predictions vs {len(ground_truths)} ground "
                         "truths — the pairing aligns by position")
    n = len(predictions)
    stats = []
    for s in ctx.owned_shards(eval_cfg.n_shards):
        idx = sd.eval_shard_indices(n, s, eval_cfg.n_shards)
        stats.append(match_stats([predictions[i] for i in idx], [ground_truths[i] for i in idx],
                                 idx, num_classes=num_classes, iou_threshold=iou_threshold))
    return pool_stats(stats, num_classes=num_classes, iou_threshold=iou_threshold,
                      eval_cfg=eval_cfg, ctx=ctx)


def evaluate_detector_sharded(det, *, n_images: int = 32, split: str = "val",
                              iou_threshold: float = 0.5,
                              eval_cfg: Optional[ShardedEvalConfig] = None, source=None,
                              ctx=None) -> dict:
    """Sharded ``harness.evaluate_detector``: each shard materializes only
    its stripe of the eval split (``source``, any ``DetectionSource``; the
    synthetic generator by default — both it and the file loaders are
    deterministic per (split, index)), runs forward→decode→NMS in
    ``eval_cfg.batch`` chunks with TF32 off, and the match stats reduce
    through :func:`pool_stats`. Bit-identical to the single-process path
    for any shard count (a row's outputs do not depend on its batch).

    Multi-controller: process ``i`` walks ONLY its owned shards, on the
    detector's device, and every process returns the same full report.
    ``eval_cfg`` defaults to one shard per host; an uneven count raises."""
    from repro_torch.data import detection_datasets as dd
    from repro_torch.eval import harness

    ctx = ctx or runtime.get_context()
    eval_cfg = eval_cfg or ShardedEvalConfig(n_shards=max(1, ctx.n_hosts))
    ctx.validate_shard_count(eval_cfg.n_shards)
    cfg = det.cfg
    source = source or dd.SyntheticSource()
    cap = source.num_eval_images(split)
    if cap is not None:
        n_images = min(n_images, cap)
    stats = []
    for s in ctx.owned_shards(eval_cfg.n_shards):
        images, gts = source.eval_set(
            n_images, split=split, hw=cfg.input_hw, grid_div=harness.grid_div(cfg),
            num_anchors=cfg.num_anchors, num_classes=cfg.num_classes,
            shard_id=s, n_shards=eval_cfg.n_shards,
        )
        idx = sd.eval_shard_indices(n_images, s, eval_cfg.n_shards)
        preds = harness.predictions(det, images, eval_cfg.batch)
        stats.append(match_stats(preds, gts, idx, num_classes=cfg.num_classes,
                                 iou_threshold=iou_threshold))
    report = pool_stats(stats, num_classes=cfg.num_classes, iou_threshold=iou_threshold,
                        eval_cfg=eval_cfg, ctx=ctx)
    report["split"] = split
    return report
