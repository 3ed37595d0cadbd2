"""Detection data sources behind one protocol: the ``DetectionSource`` the
training and evaluation code consumes, the synthetic generator as one, and
the file-backed COCO-json and VOC-xml loaders.

A numpy copy of ``repro/data/detection_datasets.py``: the same spec, the
same letterbox (integer-index nearest-neighbour resize onto a gray canvas,
boxes through the same placed-pixel geometry) and the same targets
(``synthetic_detection.encode_targets``), so a (source, index) gives the
same image, ground truth and target, byte for byte, in both packages.
Every source emits what the synthetic pipeline does:

* ``eval_set(n, ...) -> (images (N, H, W, 3) float32 in [0, 1],
  [{"boxes" (G, 4) cxcywh normalized, "classes" (G,)} ...])``, with the
  ``shard_id``/``n_shards`` striping contract;
* ``batches(b, ...) -> iterator of {"image", "target"}`` with YOLO grid
  targets, host-striped (``host_id``/``n_hosts``) from ``start_index``.

Dataset selection is a string spec (the ``--dataset`` flag everywhere):

    synthetic              the deterministic IVS-3cls-like generator
    coco:<instances.json>  COCO-style json (bbox = [x, y, w, h] pixels)
    voc:<dir>              VOC layout (<dir>/Annotations/*.xml + images)

Image decoding: ``.npy`` (float in [0, 1] or uint8) and binary ``.ppm`` /
``.pgm`` load with numpy alone; anything else (png/jpg) needs PIL and
raises a ``ValueError`` naming the dependency-free formats where PIL is
not installed. The committed fixture (tests/fixtures/coco_fixture) is ppm.
"""
from __future__ import annotations

import json
import os
import re
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Any, Iterator, Optional, Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch.data import synthetic_detection as sd

LETTERBOX_PAD_VALUE = 0.5  # neutral gray, like YOLO's 114/255 convention


# ---------------------------------------------------------------- protocol --


@runtime_checkable
class DetectionSource(Protocol):
    """What the eval/train stack needs from a dataset. ``synthetic_detection``
    (wrapped by :class:`SyntheticSource`) and the file-backed loaders both
    satisfy it; ``repro_torch.eval.harness``, ``launch/serve``,
    ``launch/train_detector`` and ``convert`` accept any implementation."""

    name: str

    def num_eval_images(self, split: str) -> Optional[int]:
        """Finite eval-split size, or None for unbounded (synthetic)."""
        ...

    def eval_set(self, n_images: int, *, split: str = "val", hw=(576, 1024),
                 shard_id: int = 0, n_shards: int = 1, **kw) -> tuple:
        ...

    def batches(self, batch_size: int, *, split: str = "train", hw=(576, 1024),
                steps: Optional[int] = None, host_id: int = 0, n_hosts: int = 1,
                start_index: int = 0, **kw) -> Iterator[dict]:
        ...


class SyntheticSource:
    """The deterministic synthetic IVS-3cls-like generator as a source."""

    name = "synthetic"

    def num_eval_images(self, split: str) -> Optional[int]:
        return None  # generated on demand: any n_images is materializable

    def eval_set(self, n_images: int, **kw):
        return sd.eval_set(n_images, **kw)

    def batches(self, batch_size: int, **kw):
        return sd.batches(batch_size, **kw)


# --------------------------------------------------------------- letterbox --


def letterbox_image(img: np.ndarray, hw) -> tuple:
    """Aspect-preserving resize onto a ``hw`` gray canvas.

    Nearest-neighbor with integer index math (source row of output row i
    is ``i * h // nh``) — bit-deterministic across hosts and platforms,
    which the sharded-eval parity gate requires. Returns
    ``(canvas float32 (H, W, 3), (top, left, nh, nw))`` where (nh, nw) is
    the placed size and (top, left) the pad offset.
    """
    img = np.asarray(img)
    h, w = img.shape[:2]
    H, W = hw
    s = min(H / h, W / w)
    nh = min(H, max(1, int(round(h * s))))
    nw = min(W, max(1, int(round(w * s))))
    rows = (np.arange(nh) * h) // nh
    cols = (np.arange(nw) * w) // nw
    resized = img[rows][:, cols].astype(np.float32)
    if resized.ndim == 2:
        resized = np.repeat(resized[:, :, None], 3, axis=2)
    top, left = (H - nh) // 2, (W - nw) // 2
    canvas = np.full((H, W, 3), LETTERBOX_PAD_VALUE, np.float32)
    canvas[top : top + nh, left : left + nw] = resized
    return canvas, (top, left, nh, nw)


def letterbox_boxes(boxes: np.ndarray, geom, hw) -> np.ndarray:
    """Map (cx, cy, w, h) boxes normalized to the ORIGINAL image into the
    letterboxed normalized frame, using the placed-pixel geometry from
    :func:`letterbox_image` — the box transform and the pixel transform
    share (top, left, nh, nw), so targets built from these boxes stay
    ``decode_head``'s exact inverse on the letterboxed image."""
    top, left, nh, nw = geom
    H, W = hw
    b = np.asarray(boxes, np.float32).reshape(-1, 4).copy()
    b[:, 0] = (b[:, 0] * nw + left) / W
    b[:, 1] = (b[:, 1] * nh + top) / H
    b[:, 2] = b[:, 2] * nw / W
    b[:, 3] = b[:, 3] * nh / H
    return b


# ----------------------------------------------------------- image loading --


def _read_ppm(path: str) -> np.ndarray:
    """Binary PPM (P6) / PGM (P5) reader — numpy-only, so the committed
    fixture needs no imaging dependency. Returns uint8 (H, W, 3|1)."""
    with open(path, "rb") as f:
        data = f.read()
    # header: magic, width, height, maxval — whitespace/comment separated
    tokens, pos = [], 0
    while len(tokens) < 4:
        m = re.compile(rb"\s*(#[^\n]*\n|\S+)").match(data, pos)
        if m is None:
            raise ValueError(f"{path}: truncated PNM header")
        pos = m.end()
        if not m.group(1).startswith(b"#"):
            tokens.append(m.group(1))
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    if magic not in (b"P6", b"P5") or maxval > 255:
        raise ValueError(f"{path}: unsupported PNM variant {magic!r}/{maxval}")
    ch = 3 if magic == b"P6" else 1
    # spec: EXACTLY one whitespace byte between maxval and the raster.
    # Demand the rest of the file is that byte plus exactly h*w*ch pixel
    # bytes — a CRLF-written header would otherwise shift every pixel by
    # one byte while still passing a length-only check on the slice.
    body = data[pos + 1 :]
    if data[pos : pos + 1] not in (b" ", b"\t", b"\n", b"\r") or \
            len(body) != h * w * ch:
        raise ValueError(
            f"{path}: expected a single whitespace then {h * w * ch} pixel "
            f"bytes after the header, got {len(body)} trailing bytes"
        )
    return np.frombuffer(body, np.uint8).reshape(h, w, ch)


def _read_image(path: str) -> np.ndarray:
    """Image file -> float32 (H, W, C) in [0, 1]. Uint8 content scales by
    /255 exactly like ``serve.detector.synth_streams``, so uint8-sourced
    frames stay exact under the bit-serial 8-bit encode path."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        arr = np.load(path)
    elif ext in (".ppm", ".pgm", ".pnm"):
        arr = _read_ppm(path)
    else:
        try:
            from PIL import Image
        except ImportError as e:  # no PIL: only ppm/pgm/npy decode
            raise ValueError(
                f"{path}: decoding {ext!r} needs PIL, which is not installed "
                "— convert to .ppm or .npy for a dependency-free load"
            ) from e
        arr = np.asarray(Image.open(path).convert("RGB"))
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    arr = np.asarray(arr, np.float32)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


# ------------------------------------------------------- file-backed sources --


@dataclass(frozen=True)
class ImageRecord:
    """One annotated image: path + ground truth normalized to ITS size."""

    path: str
    hw: tuple  # (h, w) of the stored image, from the annotation
    boxes: Any  # (G, 4) float32 cxcywh in [0, 1] of the ORIGINAL image
    classes: Any  # (G,) int64


class _FileDetectionSource:
    """Shared machinery: letterboxed eval sets and target-encoded batches
    over a fixed record list. Subclasses only parse annotations.

    The whole annotation set backs every split — real train/val separation
    is a dataset-preparation concern (point the spec at the split's own
    annotation file); at fixture scale reusing one set for both is the
    point. ``batches`` cycles the records (index modulo size) so small
    sets still drive arbitrarily long fine-tunes.
    """

    name = "file"

    def __init__(self, records: Sequence[ImageRecord], class_names: Sequence[str]):
        if not records:
            raise ValueError(f"{self.name}: no annotated images found")
        self.records = list(records)
        self.class_names = tuple(class_names)

    def num_eval_images(self, split: str) -> Optional[int]:
        return len(self.records)

    def _check_classes(self, num_classes: int) -> None:
        if len(self.class_names) > num_classes:
            raise ValueError(
                f"{self.name}: dataset has {len(self.class_names)} classes "
                f"{self.class_names} but the detector is configured for "
                f"{num_classes} — they must agree for class indices to mean "
                "the same thing on both sides"
            )

    def _letterboxed(self, index: int, hw) -> tuple:
        rec = self.records[index % len(self.records)]
        img, geom = letterbox_image(_read_image(rec.path), hw)
        boxes = letterbox_boxes(rec.boxes, geom, hw)
        return img, boxes, np.asarray(rec.classes, np.int64).reshape(-1)

    def eval_set(self, n_images: int, *, split: str = "val", hw=(576, 1024),
                 shard_id: int = 0, n_shards: int = 1, num_classes: int = 3,
                 **kw) -> tuple:
        """Letterboxed (images, ground_truths) for this shard's stripe of
        the first ``min(n_images, len(records))`` images — same striping
        contract as ``synthetic_detection.eval_set``, so the sharded and
        single-host evaluators see identical per-image content."""
        self._check_classes(num_classes)
        n = min(n_images, len(self.records))
        imgs, gts = [], []
        for i in sd.eval_shard_indices(n, shard_id, n_shards):
            img, boxes, classes = self._letterboxed(i, hw)
            imgs.append(img)
            gts.append({"boxes": boxes.reshape(-1, 4), "classes": classes})
        h, w = hw
        images = np.stack(imgs) if imgs else np.zeros((0, h, w, 3), np.float32)
        return images, gts

    def batches(self, batch_size: int, *, split: str = "train", hw=(576, 1024),
                steps: Optional[int] = None, host_id: int = 0, n_hosts: int = 1,
                start_index: int = 0, grid_div: int = 32, num_anchors: int = 5,
                num_classes: int = 3, anchors=sd.ANCHORS) -> Iterator[dict]:
        """Host-striped {"image", "target"} stream with the SAME global
        index contract as ``synthetic_detection.batches`` (host h owns
        indices h, h+n_hosts, ...; ``start_index`` skips a consumed
        prefix); targets come from ``encode_targets`` on the letterboxed
        boxes."""
        self._check_classes(num_classes)
        gh, gw = hw[0] // grid_div, hw[1] // grid_div
        i = start_index
        step = 0
        while steps is None or step < steps:
            imgs, tgts = [], []
            for _ in range(batch_size):
                img, boxes, classes = self._letterboxed(i * n_hosts + host_id, hw)
                imgs.append(img)
                tgts.append(sd.encode_targets(
                    boxes, classes, gh=gh, gw=gw, num_anchors=num_anchors,
                    num_classes=num_classes, anchors=anchors,
                ))
                i += 1
            yield {"image": np.stack(imgs), "target": np.stack(tgts)}
            step += 1


class CocoJsonSource(_FileDetectionSource):
    """COCO-style annotation loader: ``images`` / ``annotations`` /
    ``categories``, bbox as [x, y, w, h] in absolute pixels. Image files
    resolve relative to the json's directory; category ids map to
    contiguous class indices in ascending-id order (the conventional
    COCO-to-training mapping); ``iscrowd`` regions are skipped."""

    name = "coco"

    def __init__(self, json_path: str):
        with open(json_path) as f:
            data = json.load(f)
        root = os.path.dirname(os.path.abspath(json_path))
        cats = sorted(data.get("categories", []), key=lambda c: c["id"])
        if not cats:
            raise ValueError(f"{json_path}: no categories")
        cat_to_idx = {c["id"]: i for i, c in enumerate(cats)}
        by_image: dict = {im["id"]: im for im in data.get("images", [])}
        anns: dict = {im_id: [] for im_id in by_image}
        for a in data.get("annotations", []):
            if a.get("iscrowd"):
                continue
            if a["image_id"] not in by_image:
                raise ValueError(
                    f"{json_path}: annotation {a.get('id')} references "
                    f"unknown image_id {a['image_id']}"
                )
            anns[a["image_id"]].append(a)
        records = []
        for im_id in sorted(by_image):
            im = by_image[im_id]
            h, w = int(im["height"]), int(im["width"])
            boxes, classes = [], []
            for a in anns[im_id]:
                x, y, bw, bh = (float(v) for v in a["bbox"])
                if a["category_id"] not in cat_to_idx:
                    raise ValueError(
                        f"{json_path}: annotation {a.get('id')} has unknown "
                        f"category_id {a['category_id']}"
                    )
                boxes.append(((x + bw / 2) / w, (y + bh / 2) / h, bw / w, bh / h))
                classes.append(cat_to_idx[a["category_id"]])
            records.append(ImageRecord(
                path=os.path.join(root, im["file_name"]), hw=(h, w),
                boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
                classes=np.asarray(classes, np.int64).reshape(-1),
            ))
        super().__init__(records, [c["name"] for c in cats])


class VocXmlSource(_FileDetectionSource):
    """VOC layout loader: ``<dir>/Annotations/*.xml`` (or ``<dir>/*.xml``)
    with images in ``<dir>/JPEGImages/`` (or next to the xmls). Class
    indices follow ``class_names`` when given, else the sorted set of
    object names found — pass ``class_names`` explicitly when the mapping
    must stay stable across differently-populated directories."""

    name = "voc"

    def __init__(self, root_dir: str, class_names: Optional[Sequence[str]] = None):
        ann_dir = os.path.join(root_dir, "Annotations")
        if not os.path.isdir(ann_dir):
            ann_dir = root_dir
        xmls = sorted(
            os.path.join(ann_dir, f) for f in os.listdir(ann_dir)
            if f.endswith(".xml")
        )
        img_dir = os.path.join(root_dir, "JPEGImages")
        if not os.path.isdir(img_dir):
            img_dir = ann_dir
        parsed = []
        names_seen: set = set()
        for xml_path in xmls:
            node = ET.parse(xml_path).getroot()
            size = node.find("size")
            h, w = int(size.find("height").text), int(size.find("width").text)
            objs = []
            for obj in node.findall("object"):
                name = obj.find("name").text.strip()
                bb = obj.find("bndbox")
                x0, y0, x1, y1 = (
                    float(bb.find(k).text) for k in ("xmin", "ymin", "xmax", "ymax")
                )
                names_seen.add(name)
                objs.append((name, ((x0 + x1) / 2 / w, (y0 + y1) / 2 / h,
                                    (x1 - x0) / w, (y1 - y0) / h)))
            parsed.append((xml_path, (h, w), node.findtext("filename"), objs))
        if class_names is None:
            class_names = sorted(names_seen)
        name_to_idx = {n: i for i, n in enumerate(class_names)}
        records = []
        for xml_path, hw, filename, objs in parsed:
            unknown = sorted({n for n, _ in objs if n not in name_to_idx})
            if unknown:
                raise ValueError(
                    f"{xml_path}: object classes {unknown} not in "
                    f"class_names {tuple(class_names)}"
                )
            records.append(ImageRecord(
                path=os.path.join(img_dir, filename), hw=hw,
                boxes=np.asarray([b for _, b in objs], np.float32).reshape(-1, 4),
                classes=np.asarray([name_to_idx[n] for n, _ in objs],
                                   np.int64).reshape(-1),
            ))
        super().__init__(records, class_names)


# -------------------------------------------------------------------- spec --


def parse_dataset_spec(spec: Optional[str]) -> DetectionSource:
    """``--dataset`` string -> source: ``synthetic`` (default),
    ``coco:<instances.json>``, or ``voc:<dir>``."""
    if spec is None or spec in ("", "synthetic"):
        return SyntheticSource()
    kind, _, arg = spec.partition(":")
    if kind == "coco" and arg:
        return CocoJsonSource(arg)
    if kind == "voc" and arg:
        return VocXmlSource(arg)
    raise ValueError(
        f"unknown dataset spec {spec!r} — expected 'synthetic', "
        "'coco:<instances.json>' or 'voc:<dir>'"
    )
