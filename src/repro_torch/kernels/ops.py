"""Host side of the kernels: bitmask packing of conv weights, the decode
into the kernel's dense live-tap layout, the per-layer affine bundle, and
the layer entry points :func:`fused_conv_bn_lif` (predecoded weights, or
the packed ones for the kernel to decode) and :func:`gated_conv` (the
unfused conv on the packed weights).

Counterpart of ``repro/kernels/ops.py``. Packing is numpy and byte-equal to
the JAX package's (``maskp``, ``vals``, ``tap_any``, ``tap_alive``): the
compressed format is the paper's, whatever device runs the layer. The TPU
kernel's macro-tiled block layout has no counterpart here — the CUDA kernel
clamps neighbour coordinates into each block instead of copying padded
blocks (:func:`repro_torch.kernels.fused_pipeline.block_windows`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import lif
from repro_torch.kernels import fused_pipeline as fp
from repro_torch.kernels import gated_one_to_all as g2a


class PackedConvWeights(NamedTuple):
    maskp: np.ndarray  # (KB, taps, C8, KBLK) uint8 bit-packed over C
    vals: np.ndarray  # (KB, VPAD) int8
    tap_any: np.ndarray  # (KB, taps) int32
    kh: int
    kw: int
    cin: int  # padded input channels (multiple of 8)
    kout: int  # true output channels
    kblk: int
    # taps with any nonzero weight across all K-blocks: the kernel skips
    # the dead ones (a pruned 3×3 often loses whole taps)
    tap_alive: tuple = ()

    @property
    def compressed_bytes(self) -> int:
        """Bytes of the compressed form: packed mask bits + padded values."""
        return self.maskp.size + self.vals.size

    @property
    def kp(self) -> int:
        """Output channels padded to whole K-blocks."""
        return self.maskp.shape[0] * self.kblk


class PackedTensors(NamedTuple):
    """A packed layer's arrays on a device, as the kernels take them."""

    maskp: torch.Tensor  # (KB, taps, C8, KBLK) uint8
    vals: torch.Tensor  # (KB, VPAD) int8
    tap_any: torch.Tensor  # (KB, taps) int32


def packed_tensors(pw: PackedConvWeights, device) -> PackedTensors:
    """Copy a packed layer's maskp, vals and tap_any to ``device`` (a plan
    does this once per layer)."""
    return PackedTensors(
        *(torch.from_numpy(np.ascontiguousarray(a)).to(device)
          for a in (pw.maskp, pw.vals, pw.tap_any))
    )


class LiveWeights(NamedTuple):
    """The kernel's weight operand, decoded once per plan: the live taps'
    int8 weights as (L, Cp/4, Kp, 4) — each channel quad innermost, one
    dp4a word per (tap, quad, output channel) — and the L tap indices."""

    w: torch.Tensor
    taps: tuple


def pack_conv_weights(
    w_int8: np.ndarray, *, kblk: int = 128, vpad: int | None = None
) -> PackedConvWeights:
    """w_int8: (kh, kw, Cin, K) int8 (zeros = pruned). Host-side pack.
    ``vpad`` fixes the padded length of each K-block's value vector; one
    smaller than a block's nonzero count raises."""
    w = np.asarray(w_int8)
    kh, kw, cin, k = w.shape
    taps = kh * kw
    cin_p = int(np.ceil(cin / 8)) * 8
    k_p = int(np.ceil(k / kblk)) * kblk
    wp = np.zeros((kh, kw, cin_p, k_p), np.int8)
    wp[:, :, :cin, :k] = w
    kb_total = k_p // kblk

    maskp = np.zeros((kb_total, taps, cin_p // 8, kblk), np.uint8)
    vals_list = []
    tap_any = np.zeros((kb_total, taps), np.int32)
    for kb in range(kb_total):
        wb = wp[:, :, :, kb * kblk : (kb + 1) * kblk].reshape(taps, cin_p, kblk)
        mask = (wb != 0).astype(np.uint8)
        tap_any[kb] = mask.reshape(taps, -1).any(axis=1).astype(np.int32)
        # bit c -> word c//8, position c%8
        m = mask.reshape(taps, cin_p // 8, 8, kblk)
        for b in range(8):
            maskp[kb] |= (m[:, :, b, :] << b).astype(np.uint8)
        vals_list.append(wb[wb != 0].ravel())
    max_nnz = max((v.size for v in vals_list), default=0)
    if vpad is None:
        vpad = max(max_nnz, 1)
    elif vpad < max_nnz:
        raise ValueError(
            f"vpad={vpad} < max per-K-block nnz={max_nnz}: a decode would "
            "read past the packed values"
        )
    vpad = max(vpad, 1)
    vals = np.zeros((kb_total, vpad), np.int8)
    for kb, v in enumerate(vals_list):
        vals[kb, : v.size] = v
    return PackedConvWeights(
        maskp=maskp,
        vals=vals,
        tap_any=tap_any,
        kh=kh,
        kw=kw,
        cin=cin_p,
        kout=k,
        kblk=kblk,
        tap_alive=tuple(int(t) for t in np.flatnonzero(tap_any.any(axis=0))),
    )


def unpack_conv_weights(pw: PackedConvWeights) -> np.ndarray:
    """Inverse of :func:`pack_conv_weights`: the dense int8 kernel
    (kh, kw, cin_padded, kout)."""
    maskp = np.asarray(pw.maskp)
    vals = np.asarray(pw.vals)
    kb_total, taps, c8, kblk = maskp.shape
    cin_p = c8 * 8
    w = np.zeros((taps, cin_p, kb_total * kblk), np.int8)
    for kb in range(kb_total):
        bits = np.stack([(maskp[kb] >> b) & 1 for b in range(8)], axis=2)
        mask = bits.reshape(taps, cin_p, kblk).astype(bool)
        block = np.zeros((taps, cin_p, kblk), np.int8)
        block[mask] = vals[kb, : int(mask.sum())]  # C-order, matching pack
        w[:, :, kb * kblk : (kb + 1) * kblk] = block
    return w.reshape(pw.kh, pw.kw, cin_p, kb_total * kblk)[..., : pw.kout]


def validate_packed(pw: PackedConvWeights) -> None:
    """Raise if any K-block's nonzero count exceeds the value buffer."""
    maskp = np.asarray(pw.maskp)
    vpad = int(pw.vals.shape[1])
    nnz_per_kb = np.unpackbits(maskp.reshape(maskp.shape[0], -1), axis=1).sum(axis=1)
    worst = int(nnz_per_kb.max()) if nnz_per_kb.size else 0
    if worst > vpad:
        raise ValueError(
            f"packed weights invalid: K-block nnz={worst} exceeds VPAD={vpad}; "
            "repack with a larger vpad"
        )


def predecode(pw: PackedConvWeights, device) -> LiveWeights:
    """Decode the bitmask-packed weights into the kernel's live-tap layout
    on ``device``. Inference weights are static, so a plan does this once
    (the JAX package's ``predecode=True`` mode)."""
    taps = tuple(pw.tap_alive)
    wd = unpack_conv_weights(pw).reshape(pw.kh * pw.kw, pw.cin, pw.kout)
    live = np.zeros((len(taps), pw.cin, pw.kp), np.int8)
    live[:, :, : pw.kout] = wd[list(taps)]
    quads = live.reshape(len(taps), pw.cin // 4, 4, pw.kp).transpose(0, 1, 3, 2)
    return LiveWeights(
        w=torch.from_numpy(np.ascontiguousarray(quads)).to(device), taps=taps
    )


def pad_affine(rows: torch.Tensor, kp: int) -> torch.Tensor:
    """(5, kout) per-channel rows → the kernel's (5, Kp) bundle. Channels
    past the layer width get (scale, mean 0, rinv 1, gamma 0, beta 0) and
    are never written out."""
    kout = rows.shape[1]
    if kout == kp:
        return rows.contiguous()
    fill = torch.tensor([0.0, 0.0, 1.0, 0.0, 0.0], dtype=torch.float32, device=rows.device)
    pad = fill[:, None].expand(fp.AFFINE_ROWS, kp - kout).clone()
    pad[0] = rows[0, 0]
    return torch.cat([rows, pad], dim=1).contiguous()


def affine_bundle(
    pw: PackedConvWeights,
    scale: torch.Tensor,  # () f32 — FXP dequant scale (per tensor)
    mean: torch.Tensor,  # (C,) f32 — tdBN running mean
    var: torch.Tensor,  # (C,) f32 — tdBN running var
    gamma: torch.Tensor,
    beta: torch.Tensor,
    *,
    eps: float = 1e-5,
) -> torch.Tensor:
    """The kernel's (5, Kp) constants: [FXP scale, mean, rsqrt(var+eps),
    gamma, beta]. ``rsqrt(var+eps)`` comes from :func:`repro_torch.core.lif.
    bn_rinv`, the helper the dense path's eval-mode tdBN uses too, so the
    two executors multiply by the same value on the same device."""
    kout = mean.shape[0]
    rows = torch.stack(
        [
            scale.float().reshape(()).expand(kout),
            mean.float(),
            lif.bn_rinv(var, eps).float(),
            gamma.float(),
            beta.float(),
        ]
    )
    return pad_affine(rows, pw.kp)


def fused_conv_bn_lif(
    x_t: torch.Tensor,  # (t_in, N, H, W, C) uint8 spikes {0,1} or u8 pixels
    pw: PackedConvWeights,
    affine: torch.Tensor,  # (5, Kp) from affine_bundle
    *,
    v0: torch.Tensor | None,  # (N, H, W, Kout) f32, None = cold start
    out_t: int,
    bn_scale: float,
    threshold: float,
    leak: float,
    reset: str = "hard",
    v_init: float = 0.0,
    bh: int,
    bw: int,
    weights: LiveWeights | None = None,
    predecode_weights: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The whole per-layer pipeline (conv → FXP rescale → tdBN affine → LIF
    over ``out_t`` steps) in one kernel launch. Returns (spikes (out_t, N,
    H, W, Kout) uint8 {0,1}, final membrane (N, H, W, Kout) f32).

    ``weights``: the layer's predecoded operand (a plan holds it); decoded
    from ``pw`` here when not given. ``predecode_weights=False`` hands the
    kernel the bitmask-packed weights instead, decoded inside it (the JAX
    package's ``predecode=False``; both modes are bit-equal). The encode
    layer passes its u8 pixel values — the exact fold of its 8 bit-serial
    planes."""
    c = x_t.shape[-1]
    if c > pw.cin:
        raise ValueError(f"input has {c} channels, weights {pw.cin}")
    if c < pw.cin:  # zero channels times zero weights: exact
        x_t = torch.nn.functional.pad(x_t, (0, pw.cin - c))
    x_t = x_t.to(torch.uint8).contiguous()
    v0 = None if v0 is None else v0.float().contiguous()
    kwargs = dict(kout=pw.kout, kh=pw.kh, kw=pw.kw, bh=bh, bw=bw, t_out=out_t,
                  bn_scale=bn_scale, threshold=threshold, leak=leak, reset=reset,
                  v_init=v_init)
    if not predecode_weights:
        dev = x_t.device
        return fp.fused_pipeline_packed(
            x_t, torch.from_numpy(pw.maskp).to(dev), torch.from_numpy(pw.vals).to(dev),
            pw.tap_alive, affine, v0, **kwargs,
        )
    if weights is None:
        weights = predecode(pw, x_t.device)
    return fp.fused_pipeline(x_t, weights.w, weights.taps, affine, v0, **kwargs)


def gated_conv(
    x: torch.Tensor,  # (N, H, W, C) uint8 spikes {0,1} or u8 pixels
    pw: PackedConvWeights,
    *,
    bh: int,
    bw: int,
    weights: PackedTensors | None = None,
) -> torch.Tensor:
    """Sparse-compressed block convolution, NHWC → NHWK int32, in one
    launch of the gated one-to-all kernel on the packed weights (decoded
    inside it). The leading axis is a plain batch: callers fold time steps
    into it. ``weights``: the layer's packed arrays on x's device (a plan
    holds them); copied from ``pw`` here when not given. Channels are
    zero-padded up to ``pw.cin`` (zero inputs times zero weights: exact).
    The encode layer passes its u8 pixel values — the exact fold of its 8
    bit-serial planes."""
    c = x.shape[-1]
    if c > pw.cin:
        raise ValueError(f"input has {c} channels, weights {pw.cin}")
    if c < pw.cin:
        x = torch.nn.functional.pad(x, (0, pw.cin - c))
    x = x.to(torch.uint8).contiguous()
    if weights is None:
        weights = packed_tensors(pw, x.device)
    return g2a.gated_one_to_all(
        x, weights.maskp, weights.vals, weights.tap_any,
        kout=pw.kout, kh=pw.kh, kw=pw.kw, bh=bh, bw=bw,
    )
