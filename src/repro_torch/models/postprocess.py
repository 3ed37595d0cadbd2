"""Detection postprocess: YOLOv2 decode → score threshold → class-aware
greedy NMS with a fixed budget of picks. Counterpart of
``repro/models/postprocess.py``; batched over images, on the head's device.

Boxes are (cx, cy, w, h) in [0, 1] image coordinates.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models.snn_yolo import DEFAULT_ANCHORS, decode_head

# the most (image, box, box) pairs whose IoU one pass of nms computes: its
# f32 temporaries stay near 256 MB each whatever the batch (a 64-image
# megabatch at 576x1024 has 64 x 2880^2 pairs)
NMS_PAIRS_PER_PASS = 1 << 26


class Detections(NamedTuple):
    """Fixed-size per-image detection set; ``valid`` marks live rows
    (invalid rows are zero padding)."""

    boxes: torch.Tensor  # (..., max_out, 4)
    scores: torch.Tensor  # (..., max_out)
    classes: torch.Tensor  # (..., max_out) int32
    valid: torch.Tensor  # (..., max_out) bool

    @property
    def count(self) -> torch.Tensor:
        return self.valid.to(torch.int32).sum(dim=-1)

    def row(self, i: int) -> "Detections":
        return Detections(*(f[i] for f in self))


def iou_xywh(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of center-format boxes; broadcasts over leading dims."""
    ax0, ay0 = a[..., 0] - a[..., 2] / 2, a[..., 1] - a[..., 3] / 2
    ax1, ay1 = a[..., 0] + a[..., 2] / 2, a[..., 1] + a[..., 3] / 2
    bx0, by0 = b[..., 0] - b[..., 2] / 2, b[..., 1] - b[..., 3] / 2
    bx1, by1 = b[..., 0] + b[..., 2] / 2, b[..., 1] + b[..., 3] / 2
    iw = torch.clamp(torch.minimum(ax1, bx1) - torch.maximum(ax0, bx0), min=0.0)
    ih = torch.clamp(torch.minimum(ay1, by1) - torch.maximum(ay0, by0), min=0.0)
    inter = iw * ih
    union = a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter
    return inter / torch.clamp(union, min=1e-9)


def nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    classes: Optional[torch.Tensor] = None,
    *,
    iou_threshold: float = 0.5,
    max_out: int = 32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS over a batch of images: boxes (B, M, 4), scores (B, M),
    classes (B, M) or None. With classes, a pick suppresses only boxes of
    its own class. Scores ≤ 0 are dead on arrival. Each of the
    ``min(max_out, M)`` rounds picks the live box of highest score (ties:
    the first index, as ``jnp.argmax``). The suppression table is built in
    passes of whole images, at most ``NMS_PAIRS_PER_PASS`` box pairs a
    pass: each image's table is its own, so the passes change no bit.

    Returns (indices (B, max_out) int32, valid (B, max_out) bool)."""
    b, m = scores.shape
    idx = torch.zeros((b, max_out), dtype=torch.int32, device=scores.device)
    ok = torch.zeros((b, max_out), dtype=torch.bool, device=scores.device)
    if m == 0:
        return idx, ok
    neg_inf = float("-inf")  # a Python scalar: no copy to the device, no host wait
    live = torch.where(scores > 0.0, scores, neg_inf)
    # suppress[b, i, j]: picking box i kills box j (the pick itself too)
    suppress = torch.empty((b, m, m), dtype=torch.bool, device=scores.device)
    per_pass = max(1, NMS_PAIRS_PER_PASS // (m * m))
    for i0 in range(0, b, per_pass):
        bx = boxes[i0:i0 + per_pass]
        sup = iou_xywh(bx[:, None, :, :], bx[:, :, None, :]) >= iou_threshold
        if classes is not None:
            cl = classes[i0:i0 + per_pass]
            sup &= cl[:, :, None] == cl[:, None, :]
        suppress[i0:i0 + per_pass] = sup
    rows = torch.arange(b, device=scores.device)
    for k in range(min(max_out, m)):
        i = torch.argmax(live, dim=1)
        picked = live[rows, i] > 0.0
        live = torch.where(suppress[rows, i] & picked[:, None], neg_inf, live)
        idx[:, k] = i.to(torch.int32)
        ok[:, k] = picked
    return idx, ok


def postprocess(
    head: torch.Tensor,
    anchors=DEFAULT_ANCHORS,
    *,
    score_threshold: float = 0.25,
    iou_threshold: float = 0.5,
    max_detections: int = 32,
) -> Detections:
    """``decode_head`` (with its score threshold) → best-class scoring →
    class-aware NMS. head: (N, gh, gw, A, 5+C) → batched Detections; every
    valid score is ≥ ``score_threshold``."""
    boxes, obj, cls = decode_head(head, anchors, threshold=score_threshold)
    cls_id = torch.argmax(cls, dim=-1).to(torch.int32)
    score = obj * cls.amax(dim=-1)
    score = torch.where(score >= score_threshold, score, torch.zeros_like(score))
    n = head.shape[0]
    boxes_f = boxes.reshape(n, -1, 4)
    score_f, cls_f = score.reshape(n, -1), cls_id.reshape(n, -1)
    idx, ok = nms(
        boxes_f, score_f, cls_f, iou_threshold=iou_threshold, max_out=max_detections
    )
    gather = idx.long()
    okf = ok.to(boxes.dtype)
    return Detections(
        boxes=torch.gather(boxes_f, 1, gather[..., None].expand(-1, -1, 4)) * okf[..., None],
        scores=torch.gather(score_f, 1, gather) * okf,
        classes=torch.gather(cls_f, 1, gather) * ok.to(torch.int32),
        valid=ok,
    )
