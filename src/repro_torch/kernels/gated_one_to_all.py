"""Gated one-to-all block convolution on bitmask-compressed weights (paper
§III-B.1): the unfused kernel executor's conv.

Counterpart of ``repro/kernels/gated_one_to_all.py``
(``gated_one_to_all_pallas``). :func:`gated_one_to_all` is the wrapper: on
a CUDA tensor it launches ``csrc/gated_one_to_all.cu`` (built with ``nvcc``
for ``sm_90a``, see :mod:`repro_torch.backend`), which decodes the packed
weights inside the kernel and skips dead taps; on a CPU tensor it runs
:func:`gated_one_to_all_reference`, the plain PyTorch version beside it.
There is no other route: a CUDA tensor never falls back to the plain
version, and a failed build or launch raises.

Both compute integers exactly (u8 × int8 into int32 in the kernel; integer-
valued partial sums below 2^24 in the plain version), so they agree bit for
bit on any device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import backend
from repro_torch.core import block_conv as bc
from repro_torch.kernels.fused_pipeline import block_windows, decode_dense

KERNEL = "gated_one_to_all"  # the library, and its launch count


def gated_conv_ref(x: torch.Tensor, w_dense: torch.Tensor, *, bh: int = bc.BLOCK_H,
                   bw: int = bc.BLOCK_W) -> torch.Tensor:
    """Block convolution (replicate-padded independent tiles) with dense
    weights — the semantics the kernel reproduces, as
    ``repro/kernels/ref.py::gated_conv_ref``. x NHWC (any int/float), w
    HWIO. Returns f32. Convolves in float64, exact for integer operands
    whatever algorithm the backend picks (cuDNN may choose an inexact
    Winograd or FFT conv in float32)."""
    y = bc.block_conv2d(x.double(), w_dense.double(), block_h=bh, block_w=bw)
    return y.float()


def gated_one_to_all_reference(
    x: torch.Tensor,
    maskp: torch.Tensor,
    vals: torch.Tensor,
    tap_any: torch.Tensor,
    *,
    kout: int,
    kh: int,
    kw: int,
    bh: int,
    bw: int,
) -> torch.Tensor:
    """The plain PyTorch version of the kernel; same arguments and result
    as :func:`gated_one_to_all`. :func:`decode_dense`, then an im2col
    product over the taps alive in any K-block (a tap dead in one K-block
    has zero weights there, so the sum is the same). Partial sums are
    integer-valued floats, exact in any order: f32 while every sum stays
    below 2^24, else f64."""
    m, h, wd, c = x.shape
    taps = tuple(int(t) for t in torch.nonzero(tap_any.any(dim=0)).flatten().tolist())
    if not taps:
        return torch.zeros((m, h, wd, kout), dtype=torch.int32, device=x.device)
    w = decode_dense(maskp, vals)[list(taps), :, :kout]  # (L, C, kout)
    bound = 255 * 127 * len(taps) * c
    dt = torch.float32 if bound < 2**24 else torch.float64
    patches = block_windows(x, taps, kh=kh, kw=kw, bh=bh, bw=bw)  # (M, H, W, L, C)
    acc = patches.reshape(-1, len(taps) * c).to(dt) @ w.reshape(len(taps) * c, kout).to(dt)
    return acc.to(torch.int32).reshape(m, h, wd, kout)


def _check(x, maskp, vals, tap_any, kout, kh, kw, bh, bw):
    if x.dtype != torch.uint8 or x.dim() != 4:
        raise ValueError(f"x must be (M, H, W, C) uint8, got {tuple(x.shape)} {x.dtype}")
    if maskp.dtype != torch.uint8 or maskp.dim() != 4 or vals.dtype != torch.int8 \
            or vals.dim() != 2 or vals.shape[0] != maskp.shape[0]:
        raise ValueError(f"maskp {tuple(maskp.shape)} {maskp.dtype} / vals "
                         f"{tuple(vals.shape)} {vals.dtype} are not a packed layer")
    kb_total, taps_total, c8, kblk = maskp.shape
    if tap_any.dtype != torch.int32 or tuple(tap_any.shape) != (kb_total, taps_total):
        raise ValueError(f"tap_any must be ({kb_total}, {taps_total}) int32, got "
                         f"{tuple(tap_any.shape)} {tap_any.dtype}")
    m, h, wd, c = x.shape
    if kh != kw or kh % 2 != 1 or taps_total != kh * kw or c8 * 8 != c:
        raise ValueError(f"maskp {tuple(maskp.shape)} does not fit x {tuple(x.shape)} "
                         f"and a {kh}x{kw} kernel (odd and square)")
    if kblk % 4 or not 0 < kout <= kb_total * kblk or vals.shape[1] < 1:
        raise ValueError(f"K-block {kblk} (a multiple of 4) / kout {kout} / VPAD "
                         f"{vals.shape[1]} do not fit")
    if h % bh or wd % bw:
        raise ValueError(f"({h},{wd}) not divisible by block ({bh},{bw})")
    for name, t in (("x", x), ("maskp", maskp), ("vals", vals), ("tap_any", tap_any)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for vector loads")


def gated_one_to_all(
    x: torch.Tensor,
    maskp: torch.Tensor,
    vals: torch.Tensor,
    tap_any: torch.Tensor,
    *,
    kout: int,
    kh: int,
    kw: int,
    bh: int,
    bw: int,
) -> torch.Tensor:
    """One launch for a whole layer's conv.

    x: (M, H, W, C) uint8 — binary spikes or u8 pixels, C % 8 == 0 (the
    packed layer's padded channels; time and batch folded into M). maskp:
    (KB, kh*kw, C/8, KBLK) uint8; vals: (KB, VPAD) int8; tap_any: (KB,
    kh*kw) int32 — :func:`repro_torch.kernels.ops.pack_conv_weights`'s
    arrays, on x's device. Returns (M, H, W, kout) int32."""
    _check(x, maskp, vals, tap_any, kout, kh, kw, bh, bw)
    kwargs = dict(kout=kout, kh=kh, kw=kw, bh=bh, bw=bw)
    if x.device.type == "cpu":
        return gated_one_to_all_reference(x, maskp, vals, tap_any, **kwargs)
    if x.device.type != "cuda":
        raise ValueError(f"gated_one_to_all runs on cuda or cpu, not {x.device}")
    m, h, wd, c = x.shape
    kb_total, _, _, kblk = maskp.shape
    out = torch.empty((m, h, wd, kout), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = _launcher()(
            x.data_ptr(), maskp.data_ptr(), vals.data_ptr(), tap_any.data_ptr(),
            out.data_ptr(), m, h, wd, c, kout, kb_total, kblk, vals.shape[1],
            kh, kw, bh, bw, torch.cuda.current_stream().cuda_stream,
        )
    backend.check_launch(err, KERNEL)
    backend.launches[KERNEL] += 1
    return out


@functools.cache
def _launcher():
    """The C entry point, its signature declared once: five pointers, twelve
    ints, the stream."""
    fn = backend.load_kernels()[KERNEL].gated_one_to_all_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    return fn
