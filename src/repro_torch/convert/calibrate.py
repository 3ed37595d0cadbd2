"""Channel-wise threshold calibration for ANN→SNN conversion.

Counterpart of ``repro/convert/calibrate.py``. Spiking-YOLO's channel-norm
insight (arXiv 1903.06530): a rate-coded SNN neuron can only represent
activations in ``[0, λ]`` per time window, so each channel needs its own
normalization constant ``λ_c`` — a PERCENTILE of its observed post-ReLU
activations (the max is an outlier magnet and starves the channel's
firing rate).

This module runs the imported ANN over a calibration split with the exact
conv semantics of the SNN target (u8-quantized input grid, block conv)
and collects per layer:

  * ``lam`` — per-channel percentile of the post-ReLU activation,
  * ``mean``/``var`` — per-channel statistics of the BIAS-FREE conv
    output (what the SNN executor computes), re-derived tdBN running
    statistics come from these,
  * for the encode layer (fires ONCE, in_T=1): the spike-conditional mean
    activation ``spike_value`` — a 1-step binary spike carries this value
    into the next layer, not ``λ``.

The forward runs on ``device`` (the card by default) in full f32 (TF32
off: cuDNN's convs would otherwise round every operand to 10 bits); the
statistics are computed in numpy on host copies, as the JAX package
computes them, so the two packages differ only by their convs' f32
summation order. The reference forward is standalone (pure conv→folded
BN→ReLU) and is pinned against ``snn_yolo.forward(mode="ann")`` by the
tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.backend import resolve_device
from repro_torch.convert import importer as imp
from repro_torch.core import block_conv as bc
from repro_torch.models import snn_yolo as sy


def quantize_images_u8(images) -> torch.Tensor:
    """Snap [0,1] images to the u8 grid the compressed encode layer
    consumes (``core/plan.quantize_input_u8``: 8-bit input) — calibration
    must see the same pixels the SNN will."""
    x = torch.clamp(torch.as_tensor(images, dtype=torch.float32), 0.0, 1.0)
    return torch.round(x * 255.0) / 255.0


@dataclasses.dataclass(frozen=True)
class LayerStats:
    """Per-channel calibration results for one conv+BN layer."""

    lam: np.ndarray  # (C,) percentile of relu(conv + b̃)
    mean: np.ndarray  # (C,) mean of the bias-free conv output
    var: np.ndarray  # (C,)
    spike_value: Optional[np.ndarray] = None  # (C,) encode only
    spike_frac: Optional[np.ndarray] = None  # (C,) encode duty realized


@dataclasses.dataclass(frozen=True)
class CalibrationStats:
    layers: dict  # name -> LayerStats
    head: np.ndarray  # (N, gh, gw, A, 5+C) ANN head outputs (readout fit)
    n_images: int
    percentile: float


def _maxpool(x):
    """2×2 max-pool of an NHWC map, VALID: an odd last row or column is
    dropped, as under ``reduce_window``."""
    return sy._maxpool_t(x[None])[0]


def _conv(x, w, *, use_block_conv: bool, block_hw):
    if use_block_conv and w.shape[0] > 1:
        bh, bw = block_hw
        return bc.block_conv2d(x, w, block_h=bh, block_w=bw)
    return bc.conv2d(x, w)


@torch.no_grad()
def ann_reference_forward(
    ann: imp.AnnDetector,
    images,
    *,
    taps: Optional[dict] = None,
    use_block_conv: Optional[bool] = None,
    block_hw=None,
    quantize_input: bool = True,
    device=None,
):
    """Plain conv→folded-BN→ReLU forward of the imported ANN on ``device``
    (default: the card), TF32 off.

    ``taps``, when given, collects each layer's BIAS-FREE conv output
    (``conv(a_in, w_tilde)``, shape (N, H, W, C)) under its name plus the
    raw head conv output under "head". Conv semantics (block vs SAME,
    input u8 grid) default to the ANN config but should be overridden to
    the CONVERSION TARGET's settings during calibration.

    Returns the head predictions reshaped to (N, gh, gw, A, 5+C) — the
    same contract as ``snn_yolo.forward``.
    """
    dev = resolve_device(device)
    cfg = ann.cfg
    ubc = cfg.use_block_conv if use_block_conv is None else use_block_conv
    bhw = tuple(block_hw or cfg.block_hw)

    a = torch.as_tensor(images, dtype=torch.float32)
    a = (quantize_images_u8(a) if quantize_input else a).to(dev)

    def layer(a_in, name):
        w_t, b_t = ann.folded(name)
        c = _conv(a_in, torch.from_numpy(w_t).to(dev), use_block_conv=ubc, block_hw=bhw)
        if taps is not None:
            taps[name] = c
        return torch.relu(c + torch.from_numpy(b_t).to(dev))

    with sy._no_tf32():
        a = _maxpool(layer(a, "encode"))
        a = _maxpool(layer(a, "conv_block"))
        for i in range(len(cfg.stage_channels)):
            short = layer(a, f"stage{i}/shortcut")
            m = layer(a, f"stage{i}/main_in")
            m = layer(m, f"stage{i}/main_a")
            m = layer(m, f"stage{i}/main_b")
            a = layer(torch.cat([m, short], dim=-1), f"stage{i}/agg")
            if i < cfg.pooled_stages - 1:
                a = _maxpool(a)
        head = _conv(a, torch.from_numpy(ann.head_w).to(dev), use_block_conv=ubc,
                     block_hw=bhw)
    if taps is not None:
        taps["head"] = head
    n, gh, gw, _ = head.shape
    return head.reshape(n, gh, gw, cfg.num_anchors, 5 + cfg.num_classes)


def calibrate(
    ann: imp.AnnDetector,
    images,
    *,
    percentile: float = 99.7,
    encode_duty: float = 0.5,
    batch: int = 8,
    use_block_conv: bool = True,
    block_hw=None,
    device=None,
) -> CalibrationStats:
    """Collect per-channel λ / conv statistics over a calibration set, the
    forward on ``device`` (default: the card), the statistics on the host.

    ``percentile`` ∈ (0, 100]: coverage of the activation distribution one
    full-rate spike train represents (λ is monotone non-decreasing in it).
    ``encode_duty``: the duty point τ of the 1-step encode layer — a
    channel spikes iff its activation ≥ τ·λ_c; the recorded
    ``spike_value`` is the conditional mean activation above that point
    (what the single spike is worth downstream).
    """
    images = np.asarray(images)
    n = images.shape[0]
    names = imp.conv_bn_layer_names(ann.cfg)
    acc: dict[str, list] = {name: [] for name in names}
    heads = []
    for i in range(0, n, batch):
        taps, head = _tapped(ann, images[i : i + batch], use_block_conv, block_hw, device)
        for name in names:
            c = taps[name].cpu().numpy()
            acc[name].append(c.reshape(-1, c.shape[-1]))
        heads.append(head.cpu().numpy())

    layers = {}
    for name in names:
        c = np.concatenate(acc[name], axis=0)  # (samples, C)
        _, b_t = ann.folded(name)
        act = np.maximum(c + b_t, 0.0)  # post-ReLU, ANN units
        lam = np.percentile(act, percentile, axis=0).astype(np.float32)
        stats = dict(
            lam=lam,
            mean=c.mean(axis=0).astype(np.float32),
            var=c.var(axis=0).astype(np.float32),
        )
        if name == "encode":
            thresh = encode_duty * lam  # (C,)
            fired = act >= np.maximum(thresh, 1e-12)
            cnt = fired.sum(axis=0)
            total = np.where(fired, act, 0.0).sum(axis=0)
            stats["spike_value"] = np.where(
                cnt > 0, total / np.maximum(cnt, 1), thresh
            ).astype(np.float32)
            stats["spike_frac"] = (cnt / act.shape[0]).astype(np.float32)
        layers[name] = LayerStats(**stats)
    return CalibrationStats(
        layers=layers,
        head=np.concatenate(heads, axis=0),
        n_images=n,
        percentile=percentile,
    )


def _tapped(ann, imgs, use_block_conv, block_hw, device):
    taps: dict = {}
    head = ann_reference_forward(
        ann, imgs, taps=taps,
        use_block_conv=use_block_conv, block_hw=block_hw, device=device,
    )
    return taps, head
