"""Whole-detector compression plan and the conv executors.

Counterpart of ``repro/core/plan.py``. :func:`build_plan` walks the
``snn_yolo`` parameter dict once and compiles every conv into a
:class:`CompressedLayerPlan` — FXP8 quantize → bitmask-pack → decode once
into the kernel's live-tap layout on the device (pruning happens before,
on the parameters).

Executors (``SNNDetConfig.conv_exec``):

* ``dense`` — the oracle: block conv of the int8 weights as integer-valued
  floats, the FXP scale applied once after the accumulation. Used as the
  on-card cross-check and for calibration.
* ``gated`` — the paper's shift-accumulate dataflow in plain PyTorch:
  a live-tap im2col over the replicate-padded blocks, integer-valued f32
  (exact), the scale applied once. Converted checkpoints name it in their
  sidecar.
* ``pallas`` — the kernel executor, registered under the JAX package's name
  so ``detector_config.json`` sidecars written there select it. Conv +
  tdBN + LIF layers run as one launch of the fused CUDA kernel
  (:func:`run_fused`, called from ``snn_yolo``). Where the fused chain is
  off (``taps=`` recording, ``pool_drive``'s pooled layers) each conv is
  one launch of the gated one-to-all CUDA kernel on the compressed
  weights; the 1×1 spike layers (the head among them) contract in place
  as a plain matmul.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import block_conv as bc
from repro_torch.core import quant
from repro_torch.kernels import ops as kops
from repro_torch.kernels.fused_pipeline import block_windows

DEFAULT_KBLK = 128


class CompressedLayerPlan(NamedTuple):
    """One conv layer, compiled for the compressed path."""

    name: str
    packed: kops.PackedConvWeights  # bitmask-compressed int8 weights (host)
    scale: torch.Tensor  # () f32 — FXP8 per-tensor dequant scale
    w_q: torch.Tensor  # (kh, kw, cin, kout) int8 dense — the dense oracle's operand
    in_bits: int  # 1 = binary spikes, 8 = u8 pixels (bit-serial encode)
    nnz: int
    live: kops.LiveWeights  # the fused kernel's operand, decoded once on the device
    compressed: kops.PackedTensors  # maskp, vals, tap_any on the device (gated kernel)
    # the fused kernel's tuned tiles (autotune.TileConfig) by launch shape
    # (N, H, W); a launch at any other shape keeps the kernel's rule
    tiles: dict = {}

    def tile_for(self, x: torch.Tensor):
        """The tile for a launch on ``x`` (t, N, H, W, C); None: the rule."""
        return self.tiles.get(tuple(x.shape[1:4]))

    @property
    def dense_bytes(self) -> int:
        return int(np.prod(tuple(self.w_q.shape)))

    @property
    def compressed_bytes(self) -> int:
        return int(self.packed.compressed_bytes)


class DetectorPlan(NamedTuple):
    layers: dict  # name -> CompressedLayerPlan
    block_hw: tuple  # (bh, bw) spatial block for every executor

    @property
    def dense_bytes(self) -> int:
        return sum(lp.dense_bytes for lp in self.layers.values())

    @property
    def compressed_bytes(self) -> int:
        return sum(lp.compressed_bytes for lp in self.layers.values())

    def summary(self) -> dict:
        """JSON-serializable per-layer compression report plus totals."""
        layers = {
            name: {
                "shape": list(lp.w_q.shape),
                "nnz": int(lp.nnz),
                "density": round(lp.nnz / max(1, lp.dense_bytes), 4),
                "dense_bytes": lp.dense_bytes,
                "compressed_bytes": lp.compressed_bytes,
                "scale": float(lp.scale),
                "in_bits": lp.in_bits,
            }
            for name, lp in self.layers.items()
        }
        return {
            "block_hw": list(self.block_hw),
            "layers": layers,
            "dense_bytes": self.dense_bytes,
            "compressed_bytes": self.compressed_bytes,
            "compression_ratio": round(
                self.dense_bytes / max(1, self.compressed_bytes), 3
            ),
        }


def build_layer_plan(
    name: str, w: torch.Tensor, *, weight_bits: int = 8, in_bits: int = 1,
) -> CompressedLayerPlan:
    """Quantize + bitmask-pack one HWIO kernel and decode it for the kernel
    on ``w``'s device."""
    qw = quant.quantize(w, bits=weight_bits)
    w_q = qw.q.reshape(w.shape)
    kout = w.shape[-1]
    kblk = min(DEFAULT_KBLK, -(-kout // 8) * 8)  # small layers: one tight K-block
    packed = kops.pack_conv_weights(w_q.cpu().numpy(), kblk=kblk)
    return CompressedLayerPlan(
        name=name,
        packed=packed,
        scale=qw.scale.reshape(()),
        w_q=w_q,
        in_bits=in_bits,
        nnz=int(torch.count_nonzero(w_q)),
        live=kops.predecode(packed, w.device),
        compressed=kops.packed_tensors(packed, w.device),
    )


def build_plan(params: Any, cfg, *, tile_cache: dict | None = None) -> DetectorPlan:
    """Compile the whole (already pruned) detector parameter dict in one
    pass, on the device the weights live on. The encode layer takes 8-bit
    input; every other layer binary spikes. K-blocks are the defaults.

    ``tile_cache``: (layer shape, batch) key → the fused kernel's tile
    (:mod:`repro_torch.kernels.autotune`). ``None`` consults the packaged
    autotune cache (a missing, stale or foreign one means no tuned tile);
    ``{}`` keeps the kernel's shape rule for every layer. Each layer keeps
    its tiles by launch shape, checked here against the kernel once; a
    launch at a batch the cache was not tuned at keeps the rule. A tile
    changes the speed, never the numerics."""
    from repro_torch.kernels import autotune  # lazy: autotune reads snn_yolo's layers
    from repro_torch.kernels import fused_pipeline as fp

    if not cfg.weight_bits:
        raise ValueError(
            "build_plan requires quantized weights (cfg.weight_bits > 0); "
            "weight_bits=0 means float weights, which only conv_exec='dense' runs"
        )
    shapes = autotune.detector_layer_shapes(cfg)
    if tile_cache is None:
        tile_cache = autotune.packaged_cache()
    bh, bw = cfg.block_hw
    layers = {}
    for name, layer_p in params.items():
        lp = build_layer_plan(
            name, layer_p["w"], weight_bits=cfg.weight_bits,
            in_bits=8 if name == "encode" else 1,
        )
        shape = shapes.get(name)
        tiles = {} if shape is None else autotune.tiles_for(shape, tile_cache)
        for tile in tiles.values():  # an illegal tile raises here, not at a launch
            fp.check_tile(tuple(tile), t_in=shape.t_in, c=lp.packed.cin, kp=lp.packed.kp,
                          n_live=len(lp.live.taps), kh=shape.kh, bh=bh, bw=bw,
                          on_card=layer_p["w"].device.type == "cuda")
        layers[name] = lp._replace(
            tiles={(b, shape.h, shape.w): t for b, t in tiles.items()})
    return DetectorPlan(layers=layers, block_hw=tuple(cfg.block_hw))


# -------------------------------------------------------------- executors --

# name -> fn(x_t (T, N, H, W, C), CompressedLayerPlan, cfg) -> f32
CONV_EXECUTORS: dict[str, Callable] = {}


def register_conv_executor(name: str):
    def deco(fn):
        CONV_EXECUTORS[name] = fn
        return fn

    return deco


def run_conv(x_t: torch.Tensor, lp: CompressedLayerPlan, cfg) -> torch.Tensor:
    """Run one conv layer through the configured executor."""
    try:
        fn = CONV_EXECUTORS[cfg.conv_exec]
    except KeyError:
        raise ValueError(
            f"unknown conv_exec={cfg.conv_exec!r}; registered: {sorted(CONV_EXECUTORS)}"
        ) from None
    return fn(x_t, lp, cfg)


def quantize_input_u8(x: torch.Tensor) -> torch.Tensor:
    """[0,1] float → uint8 grid (the paper's 8-bit RGB input); exact for
    images on the k/255 grid."""
    return torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.uint8)


def _effective_scale(lp: CompressedLayerPlan) -> torch.Tensor:
    return lp.scale / 255.0 if lp.in_bits == 8 else lp.scale


@register_conv_executor("dense")
def _exec_dense(x_t: torch.Tensor, lp: CompressedLayerPlan, cfg) -> torch.Tensor:
    """Oracle: dense block conv of the int8 weights, dequantized after the
    accumulation. Operands are integers, convolved in float64, where every
    sum is exact whatever algorithm the backend picks (cuDNN may choose a
    Winograd or FFT conv, inexact in float32); the f32 result is therefore
    the exact integer accumulator, as in the kernel."""
    t, n = x_t.shape[:2]
    x = x_t.reshape((t * n,) + tuple(x_t.shape[2:]))
    if lp.in_bits == 8:
        x = quantize_input_u8(x)
    x = x.double()
    w_int = lp.w_q.double()
    bh, bw = cfg.block_hw
    if cfg.use_block_conv and w_int.shape[0] > 1:
        y = bc.block_conv2d(x, w_int, block_h=bh, block_w=bw)
    else:
        y = bc.conv2d(x, w_int)
    y = y.float() * _effective_scale(lp)
    return y.reshape((t, n) + tuple(y.shape[1:]))


def _blocked_gated(x: torch.Tensor, w: torch.Tensor, bh: int, bw: int,
                   tap_alive: tuple) -> torch.Tensor:
    """Gated one-to-all over independent replicate-padded blocks: every
    live tap's window (the neighbour clamped into the pixel's block) is
    stacked along a new axis and the (live taps · channels) contraction is
    one matmul. Fully pruned taps (``tap_alive``, fixed at pack time) are
    never visited. Integer-valued f32: every partial sum is an integer below
    2^24, exact in any order (TF32 off, the PyTorch default for matmuls)."""
    kh, kw, _, kout = w.shape
    if kh == 1 and kw == 1:  # no taps to gate and no halo: contract in place
        return x @ w[0, 0].float()
    n, h, wd, c = x.shape
    taps = tuple(tap_alive)
    if not taps:  # every tap pruned away
        return torch.zeros((n, h, wd, kout), dtype=torch.float32, device=x.device)
    patches = block_windows(x, taps, kh=kh, kw=kw, bh=bh, bw=bw)  # (N, H, W, L, C)
    w2 = torch.stack([w[t // kw, t % kw] for t in taps]).reshape(len(taps) * c, kout)
    y = patches.reshape(-1, len(taps) * c) @ w2.float()
    return y.reshape(n, h, wd, kout)


@register_conv_executor("gated")
def _exec_gated(x_t: torch.Tensor, lp: CompressedLayerPlan, cfg) -> torch.Tensor:
    """The paper's shift-accumulate dataflow over the blocked layout, in
    plain PyTorch. The int8 weights accumulate as integer-valued f32 and
    the scale is applied once to the final integer, so it is bit-equal to
    the other executors. The 8-bit encode layer convolves its u8 pixel
    values, the exact fold of its bit-serial planes."""
    t, n = x_t.shape[:2]
    x = x_t.reshape((t * n,) + tuple(x_t.shape[2:]))
    x = (quantize_input_u8(x) if lp.in_bits == 8 else x).float()
    bh, bw = cfg.block_hw
    y = _blocked_gated(x, lp.w_q, bh, bw, lp.packed.tap_alive) * _effective_scale(lp)
    return y.reshape((t, n) + tuple(y.shape[1:]))


@register_conv_executor("pallas")
def _exec_kernel(x_t: torch.Tensor, lp: CompressedLayerPlan, cfg) -> torch.Tensor:
    """The kernel executor's unfused conv, where the fused chain is off.
    Time folds into the batch, so a layer is one launch of the gated one-
    to-all kernel on the compressed weights; the encode layer hands it its
    u8 pixel values (the exact fold of the JAX executor's 8 bit-serial
    planes, still one launch). Pointwise spike layers (the detection head
    among them) have no taps to gate and no halo: one channel contraction
    in place, integer-valued f32, exact. Fused layers never reach here
    (``snn_yolo`` calls :func:`run_fused`)."""
    t, n = x_t.shape[:2]
    x = x_t.reshape((t * n,) + tuple(x_t.shape[2:]))
    kh, kw = lp.w_q.shape[0], lp.w_q.shape[1]
    if lp.in_bits != 8 and kh == 1 and kw == 1:
        y = (x.float() @ lp.w_q[0, 0].float()) * lp.scale
    else:
        if lp.in_bits == 8:
            x = quantize_input_u8(x)
        bh, bw = cfg.block_hw
        acc = kops.gated_conv(x, lp.packed, bh=bh, bw=bw, weights=lp.compressed)
        y = acc.float() * _effective_scale(lp)
    return y.reshape((t, n) + tuple(y.shape[1:]))


def precompute_affines(plan: DetectorPlan, params, bn_state, cfg) -> dict:
    """The kernel's (5, Kp) affine bundle for every fused layer, built once
    from the weights and calibrated BN statistics."""
    out = {}
    for name, lp in plan.layers.items():
        p = params.get(name)
        st = (bn_state or {}).get(name)
        if p is None or st is None or "gamma" not in p:
            continue
        out[name] = kops.affine_bundle(
            lp.packed, _effective_scale(lp), st["mean"], st["var"], p["gamma"], p["beta"]
        )
    return out


def run_fused(
    x_t: torch.Tensor,
    lp: CompressedLayerPlan,
    cfg,
    *,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    v0: torch.Tensor | None,
    out_t: int,
    affine: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """conv → FXP rescale → tdBN inference affine → LIF over ``out_t`` steps
    as one kernel launch. Returns (spikes (out_t, N, H, W, C) uint8 {0,1},
    final membrane (N, H, W, C) f32) — the unfused conv → ``tdbn_apply``
    (eval) → ``lif_over_time`` chain, bit for bit on one device.

    The encode layer hands the kernel its u8 pixel values, the exact fold
    of its 8 bit-serial planes. ``affine``: the precomputed bundle; built
    here from gamma/beta/mean/var when None."""
    bh, bw = cfg.block_hw
    x = quantize_input_u8(x_t) if lp.in_bits == 8 else x_t
    if affine is None:
        affine = kops.affine_bundle(lp.packed, _effective_scale(lp), mean, var, gamma, beta)
    return kops.fused_conv_bn_lif(
        x,
        lp.packed,
        affine,
        v0=v0,
        out_t=out_t,
        bn_scale=1.0 * cfg.threshold,  # tdbn_apply's alpha(=1)·threshold
        threshold=cfg.threshold,
        leak=cfg.leak,
        reset=cfg.reset,
        v_init=cfg.v_init,
        bh=bh,
        bw=bw,
        weights=lp.live,
        tile=lp.tile_for(x),
    )
