"""Detection data sources behind one protocol: the ``DetectionSource`` the
training and evaluation code consumes, and the synthetic generator as one.

Counterpart of ``repro/data/detection_datasets.py``. Only the ``synthetic``
spec is ported; the COCO-json and VOC-xml loaders wait for ROADMAP queue 1
item 5, and their specs raise here rather than train on another dataset.
"""
from __future__ import annotations

from typing import Iterator, Optional, Protocol, runtime_checkable

from repro_torch.data import synthetic_detection as sd


@runtime_checkable
class DetectionSource(Protocol):
    """What the eval/train stack needs from a dataset: finite split sizes,
    the (images, ground truths) of an eval split, and a host-striped
    stream of {"image", "target"} batches with YOLO grid targets."""

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


def parse_dataset_spec(spec: Optional[str]) -> DetectionSource:
    """``--dataset`` string -> source. ``synthetic`` (the default) only."""
    if spec is None or spec in ("", "synthetic"):
        return SyntheticSource()
    raise ValueError(
        f"dataset spec {spec!r} is not supported by the port: only 'synthetic' "
        "is; the COCO-json and VOC-xml loaders ('coco:<instances.json>', "
        "'voc:<dir>') are ROADMAP.md queue 1 item 5"
    )
