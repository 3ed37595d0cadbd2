"""Block convolution (paper §II-B): non-overlapping spatial blocks, each
convolved on its own with replicate padding at its border.

Counterpart of ``repro/core/block_conv.py``; NHWC activations and HWIO
weights at the public functions, as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK_H = 18
BLOCK_W = 32


def conv2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain SAME (zero-padded) NHWC × HWIO conv, stride 1."""
    kh, kw = w.shape[0], w.shape[1]
    if kh == 1 and kw == 1:
        return x @ w[0, 0]
    y = F.conv2d(
        x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=((kh - 1) // 2, (kw - 1) // 2)
    )
    return y.permute(0, 2, 3, 1)


def to_blocks(x: torch.Tensor, block_h: int = BLOCK_H, block_w: int = BLOCK_W) -> torch.Tensor:
    """NHWC → (N, nbh, nbw, block_h, block_w, C)."""
    n, h, w, c = x.shape
    if h % block_h or w % block_w:
        raise ValueError(f"({h},{w}) not divisible by block ({block_h},{block_w})")
    x = x.reshape(n, h // block_h, block_h, w // block_w, block_w, c)
    return x.permute(0, 1, 3, 2, 4, 5)


def from_blocks(xb: torch.Tensor) -> torch.Tensor:
    """(N, nbh, nbw, bh, bw, C) → NHWC."""
    n, nbh, nbw, bh, bw, c = xb.shape
    return xb.permute(0, 1, 3, 2, 4, 5).reshape(n, nbh * bh, nbw * bw, c)


def block_conv2d(
    x: torch.Tensor, w: torch.Tensor, *, block_h: int = BLOCK_H, block_w: int = BLOCK_W
) -> torch.Tensor:
    """Block convolution: an independent SAME conv per block, replicate-
    padded at block borders. The convolution itself is ``F.conv2d`` over
    the edge-padded blocks (the JAX package leaves it to XLA's conv)."""
    kh = w.shape[0]
    pad = (kh - 1) // 2
    xb = to_blocks(x, block_h, block_w)
    n, nbh, nbw, bh, bw, c = xb.shape
    flat = xb.reshape(n * nbh * nbw, bh, bw, c).permute(0, 3, 1, 2)
    if pad:
        flat = F.pad(flat, (pad, pad, pad, pad), mode="replicate")
    out = F.conv2d(flat, w.permute(3, 2, 0, 1))
    out = out.permute(0, 2, 3, 1).reshape(n, nbh, nbw, bh, bw, w.shape[-1])
    return from_blocks(out)
