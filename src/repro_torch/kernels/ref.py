"""Plain-PyTorch oracles for every kernel of the port, as
``repro/kernels/ref.py`` is for the JAX package's Pallas kernels: each
computes the kernel's function from the dense operands, independent of the
kernel's own plain version (which repeats the kernel's arithmetic on the
packed operands)."""
from __future__ import annotations

import torch

from repro_torch.core import block_conv as bc
from repro_torch.core import lif as lifm


def gated_conv_ref(x: torch.Tensor, w_dense: torch.Tensor, *, bh: int = bc.BLOCK_H,
                   bw: int = bc.BLOCK_W) -> torch.Tensor:
    """Block convolution (replicate-padded independent tiles) with dense
    weights — the semantics the gated one-to-all kernel reproduces. x NHWC
    (any int/float), w HWIO. Returns f32. Convolves in float64, exact for
    integer operands whatever algorithm the backend picks (cuDNN may choose
    an inexact Winograd or FFT conv in float32)."""
    y = bc.block_conv2d(x.double(), w_dense.double(), block_h=bh, block_w=bw)
    return y.float()


def fused_lif_ref(psum_t: torch.Tensor, *, threshold: float = 0.5,
                  leak: float = 0.25) -> torch.Tensor:
    """LIF oracle through :func:`repro_torch.core.lif.lif_over_time` (hard
    reset, from v=0). psum_t (T, M, C) → int8 spikes."""
    spikes, _ = lifm.lif_over_time(psum_t.float(), threshold=threshold, leak=leak,
                                   reset="hard")
    return spikes.to(torch.int8)


def bitmask_matmul_ref(x: torch.Tensor, w_dense: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ W (K, N) in f32 (full f32 on the card while
    ``torch.backends.cuda.matmul.allow_tf32`` is False, PyTorch's default)."""
    return x.float() @ w_dense.float()
