"""mIoUT — mean Intersection over Union across Time-steps (paper §II-D, eq 1,
Fig 4) — and the mixed time-step schedule it drives.

Counterpart of ``repro/core/miout.py``. For a spike tensor s ∈ {0,1} with
shape (T, ..., C):
  firing count f = Σ_t s[t]                    per neuron
  Intersection_c = #{neurons in channel c with f == T}
  Union_c        = #{neurons in channel c with f >= 1}
  mIoUT          = mean_c Intersection_c / Union_c

Fig 4's worked example: 4 neurons fire at every step, 2 fire some-but-not-all
steps → 4 / (4+2) = 0.67. High mIoUT ⇒ per-step features are nearly
identical ⇒ that layer's input time step can drop to 1 (conv computed once,
LIF still emits T distinct outputs — paper's C2 configuration).
"""
from __future__ import annotations

from typing import Sequence

import torch


def miout(spikes: torch.Tensor, *, channel_axis: int = -1, eps: float = 1e-9) -> torch.Tensor:
    """spikes: (T, ..., C) binary. Returns the scalar mIoUT (f32)."""
    t = spikes.shape[0]
    counts = spikes.to(torch.int32).sum(dim=0)  # (..., C)
    axis = channel_axis % counts.dim()
    reduce_axes = tuple(i for i in range(counts.dim()) if i != axis)
    inter = (counts == t).float().sum(dim=reduce_axes)
    union = (counts >= 1).float().sum(dim=reduce_axes)
    iou = inter / torch.clamp(union, min=eps)
    # channels that never fire have union 0: the paper averages over
    # channels, so all-silent ones are masked out rather than counted as 0/0
    valid = (union > 0).float()
    return (iou * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def repeat_conv_for_timesteps(conv_out: torch.Tensor, out_t: int) -> torch.Tensor:
    """Mixed-time-step mechanics (paper §II-A): a layer with in_T=1 computes
    its convolution once and feeds the same result to the LIF for ``out_t``
    steps; the LIF state evolution makes the outputs differ across steps.
    conv_out: (...,) single-step result -> (out_t, ...)."""
    return conv_out[None].expand((out_t,) + tuple(conv_out.shape))


def schedule_ops(layer_macs: Sequence[int], in_ts: Sequence[int]) -> int:
    """Total MACs for a mixed-time-step schedule: each layer's conv runs
    in_T times (the LIF/elementwise cost is negligible in the paper's
    accounting)."""
    if len(layer_macs) != len(in_ts):
        raise ValueError("length mismatch")
    return int(sum(m * t for m, t in zip(layer_macs, in_ts)))


def choose_schedule(
    mious: Sequence[float],
    layer_macs: Sequence[int],
    *,
    threshold: float = 0.6,
    full_t: int = 3,
) -> list[int]:
    """Greedy prefix rule from the paper: layers at the front of the network
    whose mIoUT reaches the threshold run with in_T=1; the first layer with
    low mIoUT and everything after it run at full_t (the paper drops only
    prefix layers — dropping late ones hurts accuracy without saving much,
    Fig 15)."""
    in_ts = []
    prefix = True
    for m in mious:
        if prefix and m >= threshold:
            in_ts.append(1)
        else:
            prefix = False
            in_ts.append(full_t)
    return [t for t, _ in zip(in_ts, layer_macs)]
