"""The gated one-to-all product (paper §III-B.1, Figs 8/9/11) in plain
PyTorch: a SAME convolution of a binary spike map with a pruned weight
tensor, computed as one term per nonzero weight broadcast against the
shifted spike plane.

Counterpart of ``repro/core/spike_conv.py``; NHWC spikes, HWIO weights.
:func:`conv_reference` and :func:`gated_one_to_all` compute the same
numbers; the CUDA kernel (``kernels/gated_one_to_all.py``) does the block-
convolution variant on compressed weights.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import bitmask as bm


def conv_reference(spikes: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Dense SAME (zero-padded) conv oracle, f32 out, convolved in float64
    (exact for integer operands in any conv algorithm)."""
    kh, kw = w.shape[0], w.shape[1]
    y = F.conv2d(spikes.double().permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1),
                 padding=((kh - 1) // 2, (kw - 1) // 2))
    return y.permute(0, 2, 3, 1).float()


def _shift2d(x: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """out[y, x] = x[y + dr, x + dc], zero outside (the enable map of
    Fig 8(b))."""
    _, h, w_, _ = x.shape
    out = torch.zeros_like(x)
    out[:, max(-dr, 0):h + min(-dr, 0), max(-dc, 0):w_ + min(-dc, 0)] = \
        x[:, max(dr, 0):h + min(dr, 0), max(dc, 0):w_ + min(dc, 0)]
    return out


def gated_one_to_all(spikes: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Shift-accumulate sparse conv. spikes (N, H, W, Cin) binary; w
    (kh, kw, Cin, K). Returns (N, H, W, K) f32: per tap, the shifted map's
    channel contraction (the PE array's one-to-all broadcast)."""
    kh, kw, _, k = w.shape
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    s = spikes.float()
    out = torch.zeros(tuple(spikes.shape[:3]) + (k,), dtype=torch.float32,
                      device=spikes.device)
    for r in range(kh):
        for c in range(kw):
            out = out + _shift2d(s, r - ph, c - pw) @ w[r, c].float()
    return out


def gated_one_to_all_compressed(spikes: torch.Tensor, cw: bm.BitmaskWeights,
                                dtype=torch.float32) -> torch.Tensor:
    """The same on bitmask-compressed weights: decode, then accumulate."""
    return gated_one_to_all(spikes, bm.decode(cw, dtype))


def accumulate_count(w: torch.Tensor, spatial_size: int) -> int:
    """Accumulates the gated dataflow performs for one layer: nnz(w) ×
    spatial positions (the paper's −47.3% latency accounting)."""
    return int(torch.count_nonzero(w)) * spatial_size


def dense_count(w: torch.Tensor, spatial_size: int) -> int:
    return int(w.numel()) * spatial_size
