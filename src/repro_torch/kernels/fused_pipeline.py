"""Fused layer pipeline: block conv over the live taps → FXP rescale → tdBN
inference affine → LIF over all time steps, in one kernel launch per layer.

Counterpart of ``repro/kernels/fused_pipeline.py`` (``fused_pipeline_pallas``
in both weight modes). :func:`fused_pipeline` (predecoded weights, the
serving path) and :func:`fused_pipeline_packed` (bitmask-packed weights,
decoded in the kernel) are the wrappers: on a CUDA tensor they launch
``csrc/fused_pipeline.cu`` (built with ``nvcc`` for ``sm_90a``, see
:mod:`repro_torch.backend`); on a CPU tensor they run
:func:`fused_pipeline_reference`, the plain PyTorch version beside it
(after :func:`decode_packed`, for the packed mode).
There is no other route: a CUDA tensor never falls back to the plain
version, and a failed build or launch raises.

The kernel runs each time step's conv as an int8 GEMM on the tensor cores
(``mma.sync`` u8 × s8 → s32, exact in any order) with the block's weights
resident in shared memory; the plain version is an im2col product of
integer-valued f32, also exact. Both then compute the same float chain,
the plain version one eager op at a time (each product rounded on its
own), the kernel with the same roundings pinned by ``__fmul_rn``/
``__fadd_rn`` and built ``-fmad=false``, so the two agree bit for bit on
the card. A block's weight slice that does not fit in shared memory (a
7×7 layer at C = 256) is streamed in K-chunks in both modes: copied
(predecoded), or decoded chunk by chunk in the kernel (packed). Every
layer of the detector fits.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import backend

AFFINE_ROWS = 5  # FXP scale, tdBN mean, rsqrt(var+eps), gamma, beta
KERNEL = "fused_pipeline"  # the library, and the predecoded mode's launch count
KERNEL_PACKED = "fused_pipeline_packed"  # the packed mode's launch count

# The tiles a caller may name, in the order of ``launch_named``'s table in
# csrc/fused_pipeline.cu: (steps per pass, n8 tiles per warp, warps along
# the pixels, warps along the channels). A tile covers 16·wm pixels ×
# 8·ni·wn output channels. ``tile=None`` keeps the kernel's shape rule
# (:func:`rule_tile`).
TILES = ((4, 2, 4, 2), (4, 2, 2, 4), (1, 2, 8, 1), (1, 4, 8, 1), (1, 4, 4, 2), (1, 2, 2, 4))
TIME_BATCH_PIX = 8192  # kTimeBatchPix: the largest map the rule batches over time
DEFAULT_SMS = 132  # an H100 SXM's multiprocessors, where no card is asked


def rule_tile(t_in: int, npix: int, kout: int, sms: int = DEFAULT_SMS) -> tuple:
    """The tile ``launch()`` picks by shape (``npix`` = N·H·W)."""
    if t_in > 1 and npix <= TIME_BATCH_PIX:
        return TILES[0] if kout <= 32 else TILES[1]
    if kout <= 16:
        return TILES[2]
    if kout <= 32:
        return TILES[3]
    blocks64 = -(-npix // 64) * -(-kout // 64)
    return TILES[4] if blocks64 >= sms else TILES[5]


@functools.cache
def tile_plan(tile, *, c: int, kp: int, n_live: int, kh: int, bh: int, bw: int,
              packed: bool = False, kblk: int = 0) -> tuple[int, bool]:
    """(dynamic shared-memory bytes, weights resident) of ``tile``'s plan for
    a layer, asked of the built library (``fused_pipeline_tile_plan``: the
    kernel's own ``plan_smem``, no launch), so the card's. -1 bytes: the
    tile cannot run the layer. ``c`` is the padded input channel count the
    kernel sees, ``kp`` the padded output width."""
    fn = backend.load_kernels()[KERNEL].fused_pipeline_tile_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_int)]
    resident = ctypes.c_int(0)
    smem = fn(TILES.index(tuple(tile)), c, kp, kh, bh, bw, n_live, int(packed), kblk,
              ctypes.byref(resident))
    if smem == -2:
        raise ValueError(f"no layer: C={c}, Kp={kp}, {kh}x{kh}, block ({bh},{bw}), "
                         f"{n_live} live taps, packed={packed}, kblk={kblk}")
    return smem, bool(resident.value)


@functools.cache
def check_tile(tile, *, t_in: int, c: int, kp: int, n_live: int, kh: int, bh: int,
               bw: int, packed: bool = False, kblk: int = 0, on_card: bool = True) -> int:
    """The index of ``tile`` in :data:`TILES`, or -1 for None (the shape
    rule). Raises ValueError for a tile the kernel would refuse: one not in
    the table, four steps a pass where there is one conv (t_in == 1), and,
    ``on_card``, a plan that does not fit in shared memory or (packed)
    weights that would have to stream (:func:`tile_plan`). Memoized: a
    layer's launches ask once."""
    if tile is None:
        return -1
    tile = tuple(int(v) for v in tile)
    if tile not in TILES:
        raise ValueError(f"tile {tile} is not one of the kernel's tiles {TILES}")
    if tile[0] > 1 and t_in == 1:
        raise ValueError(f"tile {tile} batches 4 steps a pass; this layer runs one conv "
                         "(t_in == 1)")
    if on_card:
        smem, resident = tile_plan(tile, c=c, kp=kp, n_live=n_live, kh=kh, bh=bh, bw=bw,
                                   packed=packed, kblk=kblk)
        if smem < 0:
            raise ValueError(f"tile {tile}: its shared-memory plan does not fit this layer "
                             f"(C={c}, {n_live} live taps)")
        if packed and not resident:
            raise ValueError(f"tile {tile}: these packed weights do not fit in shared memory "
                             "and stream through the kernel's own tile; pass tile=None")
    return TILES.index(tile)


def block_windows(
    x: torch.Tensor, taps: tuple, *, kh: int, kw: int, bh: int, bw: int
) -> torch.Tensor:
    """(..., H, W, C) → (..., H, W, len(taps), C): for every output pixel,
    the input value under each listed tap of a kh×kw window, with each
    bh×bw block replicate-padded at its own border (block convolution,
    paper §II-B). Clamping the neighbour coordinate into the pixel's block
    is the same as convolving edge-padded independent blocks — what
    ``repro.kernels.ops._block_layout`` builds with halos."""
    h, w = x.shape[-3], x.shape[-2]
    if h % bh or w % bw:
        raise ValueError(f"({h},{w}) not divisible by block ({bh},{bw})")
    pad = (kh - 1) // 2
    dev = x.device
    hh = torch.arange(h, device=dev)
    ww = torch.arange(w, device=dev)
    h0, w0 = (hh // bh) * bh, (ww // bw) * bw
    wins = []
    for tap in taps:
        ih = torch.minimum(torch.maximum(hh + tap // kw - pad, h0), h0 + bh - 1)
        iw = torch.minimum(torch.maximum(ww + tap % kw - pad, w0), w0 + bw - 1)
        wins.append(x.index_select(-3, ih).index_select(-2, iw))
    return torch.stack(wins, dim=-2)


def fused_pipeline_reference(
    x: torch.Tensor,
    w: torch.Tensor,
    taps: tuple,
    affine: torch.Tensor,
    v0: torch.Tensor | None,
    *,
    kout: int,
    kh: int,
    kw: int,
    bh: int,
    bw: int,
    t_out: int,
    bn_scale: float,
    threshold: float,
    leak: float,
    reset: str = "hard",
    v_init: float = 0.0,
    tile: tuple | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel; same arguments and results
    as :func:`fused_pipeline` (``tile`` names a kernel tile, which the plain
    version has none of: it changes nothing). The conv is an im2col product
    of integer-valued f32 (every partial sum is an integer below 2^24, so
    exact in any summation order); the epilogue and LIF are one eager op per
    step."""
    del tile
    t_in, n, h, wd, c = x.shape
    n_live = len(taps)
    kp = w.shape[2]
    if n_live:
        wm = w.permute(0, 1, 3, 2).reshape(n_live * c, kp)[:, :kout].float()
        patches = block_windows(x, taps, kh=kh, kw=kw, bh=bh, bw=bw)
        acc = patches.reshape(-1, n_live * c).float() @ wm
        acc = acc.reshape(t_in, n, h, wd, kout)
    else:
        acc = torch.zeros((t_in, n, h, wd, kout), dtype=torch.float32, device=x.device)
    scale, mean, rinv, gamma, beta = affine[:, :kout]
    y = acc * scale
    x_hat = (y - mean) * rinv
    drives = (x_hat * bn_scale) * gamma + beta
    if v0 is None:
        v = torch.full((n, h, wd, kout), v_init, dtype=torch.float32, device=x.device)
    else:
        v = v0
    spikes = []
    for t in range(t_out):
        v = v * leak + drives[0 if t_in == 1 else t]
        s = v >= threshold
        spikes.append(s)
        if reset == "soft":
            v = torch.where(s, v - threshold, v)
        else:
            v = torch.where(s, torch.zeros_like(v), v)
    return torch.stack(spikes).to(torch.uint8), v


def decode_dense(maskp: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the in-kernel bitmask decode:
    bitmask-packed weights (maskp (KB, taps, C/8, KBLK) uint8, vals
    (KB, VPAD) int8) → dense int8 weights (taps, C, KB*KBLK). A set bit's
    value is ``vals[kb, rank]``, its rank counted in the K-block's
    (tap, channel, k) order — the JAX kernels' cumsum-and-gather, index
    clipped to VPAD."""
    kb_total, taps_total, c8, kblk = maskp.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=maskp.device)
    bits = (maskp[:, :, :, None, :] >> shifts[:, None]) & 1  # (KB, taps, C8, 8, KBLK)
    flat = bits.reshape(kb_total, -1).long()
    idx = (flat.cumsum(dim=1) - 1).clamp(0, vals.shape[1] - 1)
    dense = torch.where(flat > 0, torch.gather(vals.long(), 1, idx), 0)
    dense = dense.reshape(kb_total, taps_total, c8 * 8, kblk)
    return dense.permute(1, 2, 0, 3).reshape(taps_total, c8 * 8, kb_total * kblk).to(torch.int8)


def decode_packed(maskp: torch.Tensor, vals: torch.Tensor, taps: tuple) -> torch.Tensor:
    """:func:`decode_dense`, then the live taps in the packed mode's
    (L, C/4, KB*KBLK, 4) layout."""
    dense = decode_dense(maskp, vals)
    _, c, kp = dense.shape
    live = dense[list(taps)].reshape(len(taps), c // 4, 4, kp)
    return live.permute(0, 1, 3, 2).contiguous()


def _check(x, taps, affine, v0, kp, kout, kh, kw, bh, bw, t_out, reset, weights):
    """Validate the operands the kernel takes besides the weights (whose
    shapes the wrappers check); ``weights`` are checked for device and
    contiguity with the rest."""
    if x.dtype != torch.uint8 or x.dim() != 5:
        raise ValueError(f"x must be (t_in, N, H, W, C) uint8, got {tuple(x.shape)} {x.dtype}")
    t_in, n, h, wd, c = x.shape
    if c % 4 or kp % 4 or not 0 < kout <= kp:
        raise ValueError(f"x channels {c} / kout {kout} / padded K {kp} do not fit")
    if any(not 0 <= t < kh * kw for t in taps):
        raise ValueError(f"tap indices {taps} outside a {kh}x{kw} kernel")
    if affine.dtype != torch.float32 or tuple(affine.shape) != (AFFINE_ROWS, kp):
        raise ValueError(f"affine must be ({AFFINE_ROWS}, {kp}) f32, got {tuple(affine.shape)}")
    if v0 is not None and (v0.dtype != torch.float32 or tuple(v0.shape) != (n, h, wd, kout)):
        raise ValueError(f"v0 must be ({n}, {h}, {wd}, {kout}) f32, got {tuple(v0.shape)}")
    if not (t_out >= 1 and t_in in (1, t_out)):
        raise ValueError(f"t_in={t_in}, t_out={t_out}: need t_out >= 1 and t_in in (1, t_out)")
    if kh != kw or kh % 2 != 1 or h % bh or wd % bw:
        raise ValueError(f"kernel {kh}x{kw} / block ({bh},{bw}) do not fit ({h},{wd})")
    if reset not in ("hard", "soft"):
        raise ValueError(f"reset must be 'hard' or 'soft', got {reset!r}")
    for name, t in (("x", x), ("affine", affine), ("v0", v0), *weights):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for vector loads")


def fused_pipeline(
    x: torch.Tensor,
    w: torch.Tensor,
    taps: tuple,
    affine: torch.Tensor,
    v0: torch.Tensor | None,
    *,
    kout: int,
    kh: int,
    kw: int,
    bh: int,
    bw: int,
    t_out: int,
    bn_scale: float,
    threshold: float,
    leak: float,
    reset: str = "hard",
    v_init: float = 0.0,
    tile: tuple | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch for a whole layer, predecoded weights.

    x: (t_in, N, H, W, C) uint8 — binary spikes, or the encode layer's u8
    pixel values; C % 4 == 0. w: (L, C/4, Kp, 4) int8 — the live taps'
    weights, each channel quad innermost (:func:`repro_torch.kernels.ops.
    predecode`). taps: the L live tap indices. affine: (5, Kp) f32. v0:
    (N, H, W, kout) f32, or None for a cold start at ``v_init``. tile: one
    of :data:`TILES`, or None for the kernel's shape rule; it changes the
    speed, never the result, and an illegal one raises ValueError
    (:func:`check_tile`; the shared-memory plan is checked on the card).

    Returns (spikes (t_out, N, H, W, kout) uint8 {0,1}, membrane
    (N, H, W, kout) f32)."""
    taps = tuple(int(t) for t in taps)
    if w.dtype != torch.int8 or w.dim() != 4 or w.shape[3] != 4:
        raise ValueError(f"w must be (L, C/4, Kp, 4) int8, got {tuple(w.shape)} {w.dtype}")
    if w.shape[0] != len(taps) or w.shape[1] * 4 != x.shape[-1]:
        raise ValueError(f"weights {tuple(w.shape)} do not fit x {tuple(x.shape)} "
                         f"and {len(taps)} live taps")
    _check(x, taps, affine, v0, w.shape[2], kout, kh, kw, bh, bw, t_out, reset,
           (("w", w),))
    tile_idx = check_tile(None if tile is None else tuple(tile), t_in=x.shape[0],
                          c=x.shape[-1], kp=w.shape[2], n_live=len(taps), kh=kh, bh=bh,
                          bw=bw, on_card=x.device.type == "cuda")
    kwargs = dict(kout=kout, kh=kh, kw=kw, bh=bh, bw=bw, t_out=t_out,
                  bn_scale=bn_scale, threshold=threshold, leak=leak,
                  reset=reset, v_init=v_init)
    if x.device.type == "cpu":
        return fused_pipeline_reference(x, w, taps, affine, v0, **kwargs)
    if x.device.type != "cuda":
        raise ValueError(f"fused_pipeline runs on cuda or cpu, not {x.device}")
    fn = _launcher("fused_pipeline_launch", 6, 12)
    return _launch(KERNEL, fn, (x.data_ptr(), w.data_ptr()), (w.shape[2],),
                   x, taps, affine, v0, tile=tile_idx, **kwargs)


def fused_pipeline_packed(
    x: torch.Tensor,
    maskp: torch.Tensor,
    vals: torch.Tensor,
    taps: tuple,
    affine: torch.Tensor,
    v0: torch.Tensor | None,
    *,
    kout: int,
    kh: int,
    kw: int,
    bh: int,
    bw: int,
    t_out: int,
    bn_scale: float,
    threshold: float,
    leak: float,
    reset: str = "hard",
    v_init: float = 0.0,
    tile: tuple | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_pipeline` on bitmask-packed weights, decoded inside the
    kernel (the paper's on-chip decode; the JAX package's
    ``predecode=False``). maskp: (KB, kh*kw, C/8, KBLK) uint8; vals:
    (KB, VPAD) int8; C % 8 == 0 and KBLK % 8 == 0. On the CPU it decodes
    with :func:`decode_packed` and runs the plain version."""
    taps = tuple(int(t) for t in taps)
    if maskp.dtype != torch.uint8 or maskp.dim() != 4 or vals.dtype != torch.int8 \
            or vals.dim() != 2 or vals.shape[0] != maskp.shape[0]:
        raise ValueError(f"maskp {tuple(maskp.shape)} {maskp.dtype} / vals "
                         f"{tuple(vals.shape)} {vals.dtype} are not a packed layer")
    kb_total, taps_total, c8, kblk = maskp.shape
    if taps_total != kh * kw or c8 * 8 != x.shape[-1] or kblk % 8:
        raise ValueError(f"maskp {tuple(maskp.shape)} does not fit x {tuple(x.shape)} "
                         f"and a {kh}x{kw} kernel")
    _check(x, taps, affine, v0, kb_total * kblk, kout, kh, kw, bh, bw, t_out, reset,
           (("maskp", maskp), ("vals", vals)))
    tile_idx = check_tile(None if tile is None else tuple(tile), t_in=x.shape[0],
                          c=x.shape[-1], kp=kb_total * kblk, n_live=len(taps), kh=kh, bh=bh,
                          bw=bw, packed=True, kblk=kblk, on_card=x.device.type == "cuda")
    kwargs = dict(kout=kout, kh=kh, kw=kw, bh=bh, bw=bw, t_out=t_out,
                  bn_scale=bn_scale, threshold=threshold, leak=leak,
                  reset=reset, v_init=v_init)
    if x.device.type == "cpu":
        return fused_pipeline_reference(
            x, decode_packed(maskp, vals, taps), taps, affine, v0, **kwargs
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused_pipeline_packed runs on cuda or cpu, not {x.device}")
    fn = _launcher("fused_pipeline_packed_launch", 7, 14)
    return _launch(KERNEL_PACKED, fn, (x.data_ptr(), maskp.data_ptr(), vals.data_ptr()),
                   (kb_total, kblk, vals.shape[1]), x, taps, affine, v0, tile=tile_idx,
                   **kwargs)


PLAN_KEYS = ("smem_bytes", "steps_per_pass", "tile_pixels", "tile_channels", "halo",
             "chunk", "chunks_per_pass", "grid_x", "grid_y", "blocks_per_sm", "k_segment",
             "resident")


def last_plan() -> dict:
    """The tile plan of this process's last kernel launch (either weight
    mode), for diagnostics: shared memory, tile shape, halo mode, chunks,
    grid, blocks per SM, and whether the tile's weights are resident in
    shared memory (1) or streamed in K-chunks (0)."""
    out = (ctypes.c_int * len(PLAN_KEYS))()
    backend.load_kernels()[KERNEL].fused_pipeline_last_plan(out)
    return dict(zip(PLAN_KEYS, out))


@functools.cache
def _launcher(symbol: str, n_ptr: int, n_int: int):
    """A C entry point of the built library, with its signature declared
    once (ctypes would otherwise pass every argument as a 32-bit int): the
    pointers, the ints, the tap list, four floats, the reset flag, the
    tile index, the stream."""
    fn = getattr(backend.load_kernels()[KERNEL], symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * n_ptr
        + [ctypes.c_int] * n_int
        + [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        + [ctypes.c_float] * 4
        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    )
    return fn


def _launch(name, fn, weight_ptrs, weight_ints, x, taps, affine, v0, *, kout, kh, kw,
            bh, bw, t_out, bn_scale, threshold, leak, reset, v_init, tile):
    t_in, n, h, wd, c = x.shape
    spk = torch.empty((t_out, n, h, wd, kout), dtype=torch.uint8, device=x.device)
    mem = torch.empty((n, h, wd, kout), dtype=torch.float32, device=x.device)
    tap_arr = (ctypes.c_int * max(1, len(taps)))(*taps)
    with torch.cuda.device(x.device):
        err = fn(
            *weight_ptrs, affine.data_ptr(), None if v0 is None else v0.data_ptr(),
            spk.data_ptr(), mem.data_ptr(), t_in, t_out, n, h, wd, c, kout,
            *weight_ints, kh, kw, bh, bw, tap_arr, len(taps), bn_scale, threshold,
            leak, v_init, 1 if reset == "soft" else 0, tile,
            torch.cuda.current_stream().cuda_stream,
        )
    backend.check_launch(err, name)
    backend.launches[name] += 1
    return spk, mem
