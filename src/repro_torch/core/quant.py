"""8-bit fixed-point quantization (paper Table I, Fig 16: 8b FXP weights).

Counterpart of ``repro/core/quant.py``. Symmetric per-tensor (or per-axis)
FXP: q = clip(round(x / s), -128, 127), s = max|x| / 127, with
round-half-to-even as ``jnp.round`` does. Quantization-aware training
passes the gradient straight through the fake quantization (STE). The
ASIC accumulates in 16 bits (Fig 16): :func:`conv_acc_worst_case` bounds
what any spike input can drive, :func:`int8_conv_accumulate` computes the
exact int32 sums and :func:`acc_range_ok` checks them against
``ACC_BITS``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

INT8_MAX = 127
ACC_BITS = 16  # the ASIC accumulator width; checked by the tests, not enforced


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


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        return torch.clamp(torch.round(x / scale), -INT8_MAX - 1, INT8_MAX) * scale

    @staticmethod
    def backward(ctx, g):
        return g, None


def fake_quant(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Quantize → dequantize. The gradient passes straight through to ``x``;
    ``scale`` gets none."""
    return _FakeQuant.apply(x, scale)


def fake_quant_tensor(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    qmax = 2 ** (bits - 1) - 1
    scale = torch.clamp(x.abs().amax(), min=1e-8) / qmax
    return fake_quant(x, scale)


def int8_conv_accumulate(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int8 × int8 → int32 accumulation of a stride-1 SAME conv, x NHWC and
    w HWIO (the layout the JAX package's callers pass). PyTorch has no
    integer convolution, so the patches are unfolded and contracted in
    float64: every product and partial sum is an integer of magnitude at
    most 128·128·kh·kw·C, far inside the 2^53 where f64 is exact in any
    summation order, so the cast back is the integer result."""
    kh, kw, cin, kout = w_q.shape
    n, h, w, _ = x_q.shape
    x = x_q.to(torch.float64).permute(0, 3, 1, 2)
    # SAME: the extra row/column of an even kernel goes after, as XLA pads
    x = F.pad(x, ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
    cols = F.unfold(x, (kh, kw))  # (N, C·kh·kw, H·W), C-major as below
    wm = w_q.to(torch.float64).permute(3, 2, 0, 1).reshape(kout, cin * kh * kw)
    acc = (wm @ cols).reshape(n, kout, h, w)
    return acc.permute(0, 2, 3, 1).to(torch.int32)


def acc_range_ok(acc: torch.Tensor, bits: int = ACC_BITS) -> bool:
    lim = 2 ** (bits - 1)
    return bool(((acc >= -lim) & (acc < lim)).all())


def conv_acc_worst_case(w_q) -> int:
    """Largest |accumulator| value any binary-spike input can drive through
    an int8 conv with kernel ``w_q`` (HWIO, numpy or a tensor): max over
    output channels of Σ|w_q| across taps and input channels — the bound the
    eval harness reports against ``ACC_BITS``."""
    if isinstance(w_q, torch.Tensor):
        w_q = w_q.cpu().numpy()
    aw = np.abs(np.asarray(w_q, np.int64))
    return int(aw.reshape(-1, aw.shape[-1]).sum(axis=0).max())
