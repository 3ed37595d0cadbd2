"""8-bit fixed-point quantization (paper Table I, Fig 16: 8b FXP weights).

Counterpart of ``repro/core/quant.py``. Symmetric per-tensor (or per-axis)
FXP: q = clip(round(x / s), -128, 127), s = max|x| / 127, with
round-half-to-even as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

INT8_MAX = 127


class Quantized(NamedTuple):
    q: torch.Tensor  # int8 payload
    scale: torch.Tensor  # f32 scale(s)


def quantize(x: torch.Tensor, *, axis=None, bits: int = 8) -> Quantized:
    qmax = 2 ** (bits - 1) - 1
    ax = x.abs()
    amax = ax.amax() if axis is None else ax.amax(dim=axis, keepdim=True)
    # all-zero slices (dead channels) get scale 1, so q == 0 and no 0/0
    scale = torch.where(amax > 0, amax, torch.full_like(amax, float(qmax))) / qmax
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax).to(torch.int8)
    return Quantized(q=q, scale=scale.float())


def dequantize(qx: Quantized) -> torch.Tensor:
    return qx.q.float() * qx.scale


def fake_quant(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Quantize → dequantize (forward only: this slice trains nothing)."""
    return torch.clamp(torch.round(x / scale), -INT8_MAX - 1, INT8_MAX) * scale


def fake_quant_tensor(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    qmax = 2 ** (bits - 1) - 1
    scale = torch.clamp(x.abs().amax(), min=1e-8) / qmax
    return fake_quant(x, scale)
