"""Bit-serial multibit input processing (paper §III-C.2, Fig 12): the RGB
encoding layer on the spike datapath, its 8-bit inputs split into binary
planes and processed one plane at a time,

    conv(x, w) = Σ_b 2^b · conv(bitplane_b(x), w).

Counterpart of ``repro/core/bitserial.py``. The serving path hands the
kernels the u8 pixel values instead, the exact fold of these planes; this
module is the plane-serial reference the fold is tested against.
"""
from __future__ import annotations

import torch


def to_bitplanes(x_u8: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """uint8 NHWC → (B, N, H, W, C) binary f32 planes, LSB first."""
    x = x_u8.to(torch.uint8)
    return torch.stack([((x >> b) & 1).float() for b in range(bits)])


def from_bitplanes(planes: torch.Tensor) -> torch.Tensor:
    """(B, ...) binary → integer-valued f32."""
    weights = torch.tensor([2.0**b for b in range(planes.shape[0])], dtype=planes.dtype,
                           device=planes.device)
    return torch.tensordot(weights, planes, dims=([0], [0]))


def bitserial_conv(x_u8: torch.Tensor, w: torch.Tensor, conv_fn) -> torch.Tensor:
    """Run ``conv_fn`` (any binary-input conv, e.g. the gated one-to-all
    product) once per bit plane and shift-add the results."""
    planes = to_bitplanes(x_u8)
    acc = conv_fn(planes[0], w)
    for b in range(1, planes.shape[0]):
        acc = acc + (2.0**b) * conv_fn(planes[b], w)
    return acc
