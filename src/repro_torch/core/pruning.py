"""Fine-grained magnitude pruning (paper §II-C): zero the smallest-|w|
``rate`` fraction of each 3×3 kernel; 1×1 kernels stay intact.

Counterpart of ``repro/core/pruning.py``: the threshold is the k-th
smallest magnitude after a sort, and a weight survives when strictly
greater than it.
"""
from __future__ import annotations

import math
from typing import Any

import torch


def magnitude_threshold(w: torch.Tensor, rate: float) -> torch.Tensor:
    """|w| value such that ``rate`` fraction of entries fall at or below it."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"rate must be in [0,1), got {rate}")
    flat = w.abs().reshape(-1)
    k = int(math.floor(rate * flat.numel()))
    if k == 0:
        return torch.zeros((), dtype=w.dtype, device=w.device)
    return torch.sort(flat).values[k - 1]


def prune_by_rate(w: torch.Tensor, rate: float) -> torch.Tensor:
    thr = magnitude_threshold(w, rate)
    return torch.where(w.abs() > thr, w, torch.zeros_like(w))


def is_spatial_kernel(w: torch.Tensor) -> bool:
    """True for HWIO conv kernels with spatial extent > 1 (the 3×3 targets)."""
    return w.dim() == 4 and (w.shape[0] > 1 or w.shape[1] > 1)


def prune_tree(params: Any, rate: float = 0.8) -> Any:
    """Prune every 3×3 kernel of a nested dict of tensors; the rest is
    returned as it was (same objects)."""
    if isinstance(params, dict):
        return {k: prune_tree(v, rate) for k, v in params.items()}
    if isinstance(params, torch.Tensor) and is_spatial_kernel(params):
        return prune_by_rate(params, rate)
    return params
