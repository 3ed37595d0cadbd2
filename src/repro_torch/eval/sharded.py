"""The bit-identical contract between two evaluation reports.

Counterpart of the predicate half of ``repro/eval/sharded.py``:
:func:`reports_identical` is what ``benchmarks/eval_map.py`` and the serve
CLI's ``--eval-map`` gate on. The mesh-sharded evaluator itself (striped
split, per-shard forward→decode→NMS, a gathered and re-sorted reduction)
is ROADMAP queue 1 item 7; ``harness.evaluate_detector(sharded=)`` raises
until it lands.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np


def _same_ap(a: float, b: float) -> bool:
    return a == b or (np.isnan(a) and np.isnan(b))


def reports_identical(a: Mapping[str, Any], b: Mapping[str, Any]) -> bool:
    """NaN-aware exact equality of two evaluation reports on every shared
    key (mAP, per-class AP, GT/prediction counts, image count, IoU
    threshold); sharded-only keys such as ``n_shards``/``gather`` are
    ignored."""
    return (
        _same_ap(a["map"], b["map"])
        and len(a["per_class_ap"]) == len(b["per_class_ap"])
        and all(_same_ap(x, y) for x, y in zip(a["per_class_ap"], b["per_class_ap"]))
        and a["n_gt"] == b["n_gt"]
        and a["n_pred"] == b["n_pred"]
        and a["n_images"] == b["n_images"]
        and a["iou_threshold"] == b["iou_threshold"]
    )
