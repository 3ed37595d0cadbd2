"""Synthetic cityscape-like detection data matched to IVS 3cls statistics.

A copy of ``repro/data/synthetic_detection.py`` (numpy and zlib only), held
to the same pinned crc32s (``tests/fixtures/data_checksums.json``): the
same (split, index) gives the same image and targets, byte for byte, in
both packages.

The IVS 3cls dataset (paper §IV-A: ~10k train / 1k test, 1920x1080 resized
to 1024x576, three classes: vehicle / bike / pedestrian) is not
redistributable, so a synthetic set with matched statistics stands in:

* image: per-image sky/road gradient + textured noise (so the encoder sees
  non-trivial multibit input and activation sparsity statistics are
  realistic after the first LIF),
* objects: 1–12 boxes per image; class mix 55% vehicle / 22% bike / 23%
  pedestrian; log-normal box sizes with per-class aspect ratios (vehicles
  wide, pedestrians tall); objects rendered as filled rectangles with
  class-dependent intensity so boxes are actually learnable,
* deterministic per (split, index) — reproducible across hosts without a
  shared filesystem; each data-parallel host generates only its shard.

Targets use the YOLOv2 grid format of models/snn_yolo.py: (gh, gw, A, 5+C)
with [tx, ty, tw, th, obj, cls...].
"""
from __future__ import annotations

import zlib
from typing import Iterator, Optional

import numpy as np

CLASSES = ("vehicle", "bike", "pedestrian")
CLASS_P = np.array([0.55, 0.22, 0.23])
# per-class (mean_area_frac, aspect w/h)
SIZE_STATS = {0: (0.015, 1.9), 1: (0.004, 0.7), 2: (0.003, 0.45)}

# Anchor shapes in grid-cell units: a copy of snn_yolo.DEFAULT_ANCHORS, so
# the data pipeline stays numpy-only. Targets
# encode tw/th log-scale against the best-shape-IoU anchor — the exact
# inverse of snn_yolo.decode_head, so a trained head decodes to the boxes
# it was supervised on.
ANCHORS = ((1.0, 1.0), (2.0, 2.0), (4.0, 2.5), (2.5, 4.0), (6.0, 6.0))


def split_seed(split: str, index: int) -> int:
    """Deterministic per-(split, index) seed. zlib.crc32 — NOT Python's
    ``hash``, which is salted per process and would silently break the
    "reproducible across hosts" contract without PYTHONHASHSEED."""
    return (zlib.crc32(split.encode("utf-8")) & 0xFFFF) * 1_000_003 + index


def _best_anchor(bw_cells: float, bh_cells: float, anchors) -> int:
    """Anchor with max shape-IoU (boxes concentric, sizes in cell units)."""
    best, best_iou = 0, -1.0
    for a, (aw, ah) in enumerate(anchors):
        inter = min(bw_cells, aw) * min(bh_cells, ah)
        iou = inter / (bw_cells * bh_cells + aw * ah - inter)
        if iou > best_iou:
            best, best_iou = a, iou
    return best


def encode_targets(boxes, classes, *, gh: int, gw: int, num_anchors: int = 5,
                   num_classes: int = 3, anchors=ANCHORS) -> np.ndarray:
    """YOLOv2 grid targets from normalized (cx, cy, w, h) boxes — the exact
    inverse of ``snn_yolo.decode_head`` (best-shape-IoU anchor, within-cell
    tx/ty offsets, log-scale tw/th vs that anchor). Shared by the synthetic
    generator and the real-data loaders so every source supervises the
    head identically."""
    tgt = np.zeros((gh, gw, num_anchors, 5 + num_classes), np.float32)
    for (cx, cy, bw, bh), c in zip(boxes, classes):
        gx, gy = min(int(cx * gw), gw - 1), min(int(cy * gh), gh - 1)
        a = _best_anchor(bw * gw, bh * gh, anchors[:num_anchors])
        aw, ah = anchors[a]
        tgt[gy, gx, a, 0:4] = (
            cx * gw - gx, cy * gh - gy,
            np.log(max(bw * gw / aw, 1e-6)), np.log(max(bh * gh / ah, 1e-6)),
        )
        tgt[gy, gx, a, 4] = 1.0
        tgt[gy, gx, a, 5 + int(c)] = 1.0
    return tgt


def _render_image(rng, hw, boxes, classes):
    h, w = hw
    sky = np.linspace(0.65, 0.25, h, dtype=np.float32)[:, None, None]
    img = np.repeat(np.repeat(sky, w, axis=1), 3, axis=2).copy()
    img += rng.normal(0, 0.05, (h, w, 3)).astype(np.float32)
    # low-frequency texture (buildings/road patches)
    for _ in range(6):
        x0, y0 = rng.integers(0, w - 8), rng.integers(0, h - 8)
        ww, hh = rng.integers(8, w // 2), rng.integers(8, h // 2)
        img[y0 : y0 + hh, x0 : x0 + ww] += rng.uniform(-0.15, 0.15)
    shade = {0: (0.15, 0.25, 0.55), 1: (0.55, 0.2, 0.2), 2: (0.2, 0.5, 0.25)}
    for (cx, cy, bw, bh), c in zip(boxes, classes):
        x0 = int(max(0, (cx - bw / 2) * w))
        x1 = int(min(w, (cx + bw / 2) * w))
        y0 = int(max(0, (cy - bh / 2) * h))
        y1 = int(min(h, (cy + bh / 2) * h))
        if x1 > x0 and y1 > y0:
            img[y0:y1, x0:x1] = np.asarray(shade[c]) + rng.normal(0, 0.03, 3)
    return np.clip(img, 0.0, 1.0)


def sample(index: int, *, split: str = "train", hw=(576, 1024), num_classes: int = 3,
           num_anchors: int = 5, grid_div: int = 32, anchors=ANCHORS):
    """Deterministic (image, target, boxes) for one index."""
    rng = np.random.default_rng(split_seed(split, index))
    n_obj = int(rng.integers(1, 13))
    classes = rng.choice(num_classes, size=n_obj, p=CLASS_P)
    boxes = []
    for c in classes:
        area, aspect = SIZE_STATS[int(c)]
        a = float(np.exp(rng.normal(np.log(area), 0.6)))
        bh = float(np.sqrt(a / aspect))
        bw = float(a / max(bh, 1e-6))
        bw, bh = min(bw, 0.6), min(bh, 0.6)
        cx = float(rng.uniform(bw / 2, 1 - bw / 2))
        # objects sit in the lower 2/3 (road) like driving footage
        cy = float(rng.uniform(max(bh / 2, 0.33), 1 - bh / 2))
        boxes.append((cx, cy, bw, bh))
    img = _render_image(rng, hw, boxes, classes)

    gh, gw = hw[0] // grid_div, hw[1] // grid_div
    tgt = encode_targets(boxes, classes, gh=gh, gw=gw, num_anchors=num_anchors,
                         num_classes=num_classes, anchors=anchors)
    return img, tgt, (boxes, classes)


def batches(
    batch_size: int,
    *,
    split: str = "train",
    hw=(576, 1024),
    steps: Optional[int] = None,
    host_id: int = 0,
    n_hosts: int = 1,
    start_index: int = 0,
    **kw,
) -> Iterator[dict]:
    """Host-sharded deterministic batch stream: host h yields indices
    h, h+n_hosts, ... so the global batch is disjoint across hosts.
    ``start_index`` skips the first ``start_index`` per-host samples —
    resuming (or fine-tuning past) a consumed prefix without replaying it,
    composable with host striping."""
    i = start_index
    step = 0
    while steps is None or step < steps:
        imgs, tgts = [], []
        for _ in range(batch_size):
            img, tgt, _ = sample(i * n_hosts + host_id, split=split, hw=hw, **kw)
            imgs.append(img)
            tgts.append(tgt)
            i += 1
        yield {"image": np.stack(imgs), "target": np.stack(tgts)}
        step += 1


def eval_shard_indices(n_images: int, shard_id: int = 0, n_shards: int = 1) -> list:
    """Global sample indices owned by one evaluation shard, under the SAME
    striping contract as :func:`batches` host striping: shard s of k owns
    indices s, s+k, s+2k, ... — disjoint across shards, union = range(n).
    A shard can be empty when n_shards > n_images."""
    if not 0 <= shard_id < n_shards:
        raise ValueError(f"shard_id {shard_id} out of range for {n_shards} shards")
    return list(range(shard_id, n_images, n_shards))


def eval_set(n_images: int, *, split: str = "val", hw=(576, 1024),
             shard_id: int = 0, n_shards: int = 1, **kw):
    """Fixed evaluation split for the mAP harness: returns
    (images (N,H,W,3), ground_truths) where ground_truths[i] is the
    {"boxes" (G,4) xywh-normalized, "classes" (G,)} dict
    ``eval.detection_map`` consumes.

    ``shard_id``/``n_shards`` stripe the GLOBAL ``n_images`` split the way
    :func:`batches` stripes training data: this shard materializes only the
    samples of :func:`eval_shard_indices` (possibly none), so a mesh of k
    hosts generates k disjoint shards whose union is the single-host set."""
    imgs, gts = [], []
    for i in eval_shard_indices(n_images, shard_id, n_shards):
        img, _, (boxes, classes) = sample(i, split=split, hw=hw, **kw)
        imgs.append(img)
        gts.append({
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "classes": np.asarray(classes, np.int64).reshape(-1),
        })
    h, w = hw
    images = np.stack(imgs) if imgs else np.zeros((0, h, w, 3), np.float32)
    return images, gts
