"""Fine-grained magnitude pruning (paper §II-C): zero the smallest-|w|
``rate`` fraction of each 3×3 kernel; 1×1 kernels stay intact.

Counterpart of ``repro/core/pruning.py``: the threshold is the k-th
smallest magnitude after a sort, and a weight survives when strictly
greater than it. :func:`mask_tree` gives the {0, 1} masks that keep a
fine-tune on the pruned support.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch import tree as tu


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


def make_mask(w: torch.Tensor, rate: float) -> torch.Tensor:
    thr = magnitude_threshold(w, rate)
    return (w.abs() > thr).to(w.dtype)


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


def mask_tree(params: Any, rate: float = 0.8) -> Any:
    """Masks for prune-aware fine-tuning (masked gradient updates): each 3×3
    kernel's :func:`make_mask`, ones for every other leaf."""
    return tu.tree_map(
        lambda w: make_mask(w, rate) if is_spatial_kernel(w) else torch.ones_like(w), params
    )


def density(w: torch.Tensor) -> float:
    """Fraction of nonzero weights."""
    return float((w != 0).float().mean())


def tree_sparsity_report(params: Any) -> dict:
    """Per-leaf density and the parameters kept in all (Table I accounting);
    leaves named by their keys joined with "/", e.g. ``stage0/agg/w``."""
    leaves = {}
    total = kept = 0
    for keys, leaf in tu.flatten_with_keys(params):
        nnz = int((leaf != 0).sum())
        leaves["/".join(map(str, keys))] = {
            "shape": tuple(leaf.shape), "nnz": nnz, "density": nnz / leaf.numel()}
        total += leaf.numel()
        kept += nnz
    return {"leaves": leaves, "total_params": total, "kept_params": kept,
            "kept_frac": kept / max(total, 1)}
