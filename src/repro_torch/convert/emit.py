"""Emit a converted SNN detector from an imported ANN + calibration stats.

Counterpart of ``repro/convert/emit.py``: the same rescale, defaults and
report, with the emitted tensors on ``device`` (the card unless the caller
asks for the CPU). The per-layer arithmetic (``_condition``,
``_emit_layer``) and every fit's reduction stay in numpy on host arrays,
as in the JAX package, so they are exact functions of their inputs.

The rescale (channel-norm, Spiking-YOLO arXiv 1903.06530, adapted to this
repo's tdBN+LIF stack):

Per hidden conv layer, with folded ANN weights ``w̃/b̃`` and per-channel
norm ``λ_c``, the SNN should drive each LIF step with

    y_c = (θ·g / λ_c) · (a_conv_c + b̃_c)            (g = drive gain)

so a channel at its λ-covered activation fires at full rate. Three pieces
realize that EXACTLY inside the existing executor + tdBN machinery, with
the LIF threshold untouched at the paper's fixed θ=0.5:

  1. **Input scaling** — spikes are worth ``in_value_c`` ANN units (the
     producing layer's λ_c/g; the 1-step encode's conditional mean), so
     the ANN-unit conv output is ``conv(spikes, w̃ · in_value)``.
  2. **Per-output-channel conditioning** — the plan quantizes FXP8
     per-TENSOR; stored weights are pre-scaled by ``d_c = max|W|/max|W_c|``
     so every output channel spans the full int8 range, and ``d_c`` is
     divided back out in the affine. Dead channels (``max|W_c| = 0``)
     keep ``d_c = 1``.
  3. **tdBN as the affine carrier** — with running statistics set to the
     calibrated conv-output stats (μ_c, σ²_c in EXECUTOR units), tdBN's
     eval-time transform ``θ·γ_c·(x−μ_c)·rsqrt(σ²_c+eps)+β_c`` equals the
     target affine when

         γ_c = g·sqrt(σ²_c+eps) / (λ_c·d_c)
         β_c = θ·g·(mean_c + b̃_c) / λ_c

     (mean_c in ANN units).

The encode layer fires once (in_T=1) unless the encode is rate-coded: it
spikes iff activation ≥ τ·λ_c (duty point τ =
``ConvertConfig.encode_duty``), realized as the same affine with
``λ_c → τ·λ_c``; its downstream ``in_value`` is the calibrated
spike-conditional mean. The BN-free head is rescaled by its input values
and divided by the membrane-readout gain ρ(T, leak) — analytic, or
least-squares-fitted against the ANN head on the calibration set
(default).
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from repro_torch.backend import resolve_device
from repro_torch.convert import importer as imp
from repro_torch.convert.calibrate import (
    LayerStats,
    ann_reference_forward,
    calibrate as _calibrate,
)
from repro_torch.core import lif as lifm
from repro_torch.core import plan as cplan
from repro_torch.models import snn_yolo as sy


@dataclasses.dataclass(frozen=True)
class ConvertConfig:
    """Knobs of the conversion; the JAX package's defaults, every one."""

    percentile: float = 99.7  # λ coverage of the activation distribution
    calib_images: int = 32
    calib_batch: int = 8
    split: str = "train"  # calibration split (never the eval split)
    # rate-code resolution of the converted net. Accuracy climbs with T (the
    # rate code quantizes every activation to T levels and deep layers
    # compound the rounding): the committed fixture scores mAP 0.30 at T=64
    # and 0.39 at T=128 on the 48-image synthetic eval split (the JAX
    # package's CPU runs).
    full_t: int = 128
    leak: float = 1.0  # 1.0 = pure integrate-and-fire (classic conversion)
    # LIF reset of the CONVERTED net: "soft" (reset by subtraction) makes
    # the realized rate track clamp(drive/θ) with O(1/T) error; "hard"
    # loses the overshoot on every spike, an attenuation that compounds
    # through depth.
    reset: str = "soft"
    # cold-start membrane as a fraction of θ: 0.5 turns the spike count
    # floor(T·y/θ) into round(T·y/θ), which helps at small T; at T=128 the
    # round-up of near-zero drives seeds background spikes instead, so the
    # default is 0 (set 0.25–0.5 when running at T ≤ 64).
    v_init_frac: float = 0.0
    # pool tdBN drives instead of OR-ing spike trains (SNNDetConfig.
    # pool_drive): only sound when drives are constant over the T loop, so
    # off by default.
    pool_drive: bool = False
    # rate-coded encode (SNNDetConfig.rate_encode): the encode layer emits
    # a spike TRAIN over full_t instead of the paper's 1-step binary plane.
    rate_encode: bool = True
    encode_duty: float = 0.5  # τ: 1-step encode spikes iff act ≥ τ·λ_c
    gain: float = 1.0  # hidden-layer drive gain (hard-reset compensation)
    # value-calibration passes: re-run the CONVERTED net on the calibration
    # images (taps= capture of every layer's LIF drive), reconstruct the
    # spike trains, and least-squares refit each channel's spike value
    # v_c = Σ(a·r)/Σ(r²) against the clipped ANN activation. EXPERIMENTAL,
    # off by default (the joint per-layer refit can diverge).
    calib_passes: int = 0
    # spike max-pool of the converted net (SNNDetConfig.pool_mode): "rate"
    # = rate-gated pooling, so the pooled rate tracks the ANN's max.
    pool_mode: str = "rate"
    # head readout (SNNDetConfig.head_readout): "final" = final membrane /
    # T, weighting every step equally.
    head_readout: str = "final"
    conv_exec: str = "gated"
    head_scale: str = "empirical"  # "empirical" | "analytic"
    dead_eps: float = 1e-6  # λ below this (ANN units) = dead channel


def readout_scale(full_t: int, leak: float, mode: str = "mean") -> float:
    """Gain of the spiking head readout for a CONSTANT per-step input y:
    out = ρ·y. ``mode="mean"`` is ``membrane_readout``'s time-averaged
    membrane, ρ = (1/T)·Σ_{k=1..T} Σ_{j=0..k-1} leak^j; ``mode="final"``
    is final membrane / T, ρ = (1/T)·Σ_{j=0..T-1} leak^j (= 1 at
    leak=1)."""
    vs, v = [], 0.0
    for _ in range(full_t):
        v = v * leak + 1.0
        vs.append(v)
    if mode == "final":
        return float(vs[-1] / full_t)
    return float(np.mean(vs))


@dataclasses.dataclass(frozen=True)
class ConvertedDetector:
    """The emitted bundle: drops into ``compile_detector`` / the detector
    checkpoint format with zero special-casing."""

    cfg: sy.SNNDetConfig
    params: dict
    bn_state: dict
    report: dict

    REPORT_FILE = "conversion_report.json"

    def save(self, root: str, *, step: int = 0) -> str:
        """Commit as a self-describing detector checkpoint (the layout both
        packages restore); the conversion report rides along as an atomic
        sidecar."""
        from repro_torch.eval import harness

        blob = json.dumps(self.report, indent=1, sort_keys=True).encode()
        return harness.save_detector_checkpoint(
            root, step, self.params, self.bn_state, self.cfg,
            extra_files={self.REPORT_FILE: blob},
        )


def target_config(ann_cfg: sy.SNNDetConfig, cc: ConvertConfig) -> sy.SNNDetConfig:
    return dataclasses.replace(
        ann_cfg,
        arch_id=f"{ann_cfg.arch_id}-converted",
        mode="snn",
        weight_bits=8,
        use_block_conv=True,
        mixed_time=True,
        full_t=cc.full_t,
        leak=cc.leak,
        reset=cc.reset,
        v_init=cc.v_init_frac * ann_cfg.threshold,
        pool_drive=cc.pool_drive,
        pool_mode=cc.pool_mode,
        head_readout=cc.head_readout,
        conv_exec=cc.conv_exec,
        rate_encode=cc.rate_encode,
    )


def _condition(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-output-channel conditioning for per-tensor FXP8: returns
    ``(w_scaled, d)`` with ``w_scaled[..., c] = w[..., c]·d_c`` and every
    live channel's max|w| equal to the tensor max."""
    m = np.abs(w).reshape(-1, w.shape[-1]).max(axis=0)  # (cout,)
    big = m.max()
    if big == 0.0:
        return w, np.ones_like(m)
    d = np.where(m > 0, big / np.where(m > 0, m, 1.0), 1.0)
    return (w * d).astype(np.float32), d.astype(np.float32)


def _emit_layer(
    w_tilde: np.ndarray,
    b_tilde: np.ndarray,
    stats: LayerStats,
    in_value: np.ndarray,
    *,
    lam_target: np.ndarray,
    gain: float,
    dead_eps: float,
    threshold: float = 0.5,
    device=None,
):
    """Rescale one conv+BN layer. Returns (layer_params, layer_bn, info,
    dead), the tensors on ``device`` (default: the card).

    ``lam_target``: the λ the affine divides by (τ·λ for encode, λ for
    hidden layers); ``in_value``: ANN-units worth of one input spike.
    γ is derived against tdBN's OWN epsilon (``lif.tdbn_apply`` default) —
    the source ANN's BN eps was already consumed by ``AnnDetector.folded``.
    """
    dev = resolve_device(device)
    eps = 1e-5  # lif.tdbn_apply default — the affine must invert exactly it
    w_in = (w_tilde * in_value[None, None, :, None]).astype(np.float32)
    dead = lam_target <= dead_eps
    w_s, d = _condition(w_in)

    # calibrated stats are ANN-unit conv outputs; executor units are ×d
    mean_x = (d * stats.mean).astype(np.float32)
    var_x = (d * d * stats.var).astype(np.float32)
    lam_safe = np.where(dead, 1.0, lam_target)
    gamma = (gain * np.sqrt(var_x + eps) / (lam_safe * d)).astype(np.float32)
    beta = (threshold * gain * (stats.mean + b_tilde) / lam_safe).astype(
        np.float32
    )
    gamma = np.where(dead, 0.0, gamma).astype(np.float32)
    beta = np.where(dead, 0.0, beta).astype(np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    layer_p = {"w": t(w_s), "gamma": t(gamma), "beta": t(beta)}
    layer_s = {
        "mean": t(mean_x),
        "var": t(var_x),
        "count": torch.ones((), dtype=torch.int32, device=dev),
    }
    info = {
        "lam_min": float(lam_target.min()),
        "lam_max": float(lam_target.max()),
        "dead_channels": int(dead.sum()),
        "cond_max": float(d.max()),
    }
    return layer_p, layer_s, info, dead


def convert_ann(
    ann: imp.AnnDetector,
    *,
    source=None,
    cc: ConvertConfig = ConvertConfig(),
    device=None,
) -> ConvertedDetector:
    """Full pipeline: calibrate → rescale → (optional) head fit → bundle,
    every forward on ``device`` (default: the card).

    ``source``: any :class:`repro_torch.data.detection_datasets.
    DetectionSource` for the calibration split (synthetic generator by
    default). NO training happens anywhere in here.
    """
    from repro_torch.data import detection_datasets as dd
    from repro_torch.eval import harness

    dev = resolve_device(device)
    cfg = target_config(ann.cfg, cc)
    source = source or dd.SyntheticSource()
    images, _ = source.eval_set(
        cc.calib_images, split=cc.split, hw=cfg.input_hw,
        grid_div=harness.grid_div(cfg), num_anchors=cfg.num_anchors,
        num_classes=cfg.num_classes,
    )
    stats = _calibrate(
        ann, images,
        percentile=cc.percentile, encode_duty=cc.encode_duty,
        batch=cc.calib_batch, use_block_conv=cfg.use_block_conv,
        block_hw=cfg.block_hw, device=dev,
    )

    names = imp.conv_bn_layer_names(ann.cfg)
    folded = {n: ann.folded(n) for n in names}
    live = {
        n: np.asarray(stats.layers[n].lam > cc.dead_eps) for n in names
    }
    rho = readout_scale(cfg.full_t, cfg.leak, mode=cc.head_readout)

    # --- initial per-layer OUTPUT spike values: the analytic λ/g (a spike
    # at full rate reconstructs the λ-covered activation); 1-step encode
    # carries the calibrated spike-conditional mean instead
    values: dict = {}
    for n in names:
        st = stats.layers[n]
        values[n] = np.where(live[n], st.lam / cc.gain, 0.0).astype(np.float32)
    if not cc.rate_encode:
        st = stats.layers["encode"]
        values["encode"] = np.where(live["encode"], st.spike_value, 0.0).astype(
            np.float32
        )

    def in_values(vals):
        """Chain output values into each consumer's in_value, matching the
        forward-topology wiring (agg consumes cat=[main_b, shortcut])."""
        iv = {"encode": np.ones(3, np.float32), "conv_block": vals["encode"]}
        prev = "conv_block"
        for i in range(len(ann.cfg.stage_channels)):
            iv[f"stage{i}/shortcut"] = vals[prev]
            iv[f"stage{i}/main_in"] = vals[prev]
            iv[f"stage{i}/main_a"] = vals[f"stage{i}/main_in"]
            iv[f"stage{i}/main_b"] = vals[f"stage{i}/main_a"]
            iv[f"stage{i}/agg"] = np.concatenate(
                [vals[f"stage{i}/main_b"], vals[f"stage{i}/shortcut"]]
            )
            prev = f"stage{i}/agg"
        return iv, vals[prev]

    def emit_all(vals):
        iv, head_in = in_values(vals)
        params: dict = {}
        bn: dict = {}
        rep: dict = {}
        for n in names:
            st = stats.layers[n]
            lam_target, gain = st.lam, cc.gain
            if n == "encode" and not cc.rate_encode:
                # paper-faithful (1, T) topology: encode fires once at
                # duty point τ (spike iff act ≥ τ·λ)
                lam_target, gain = cc.encode_duty * st.lam, 1.0
            p, s, info, _ = _emit_layer(
                folded[n][0], folded[n][1], st,
                np.asarray(iv[n], np.float32),
                lam_target=np.asarray(lam_target, np.float32),
                gain=gain, dead_eps=cc.dead_eps, threshold=cfg.threshold,
                device=dev,
            )
            params[n], bn[n] = p, s
            info["value_mean"] = float(np.asarray(vals[n]).mean())
            rep[n] = info
        # head: input scaling / readout gain; no BN to carry an affine
        head_w = (
            ann.head_w * head_in[None, None, :, None] / rho
        ).astype(np.float32)
        params["head"] = {"w": torch.from_numpy(head_w).to(dev)}
        return params, bn, rep, head_w

    if cc.calib_passes > 0:
        # fit targets: per-sample ANN activations, clipped at λ (a spike
        # train cannot reconstruct past rate 1, so chasing the clipped
        # tail would only inflate every in-coverage pixel)
        taps: dict = {}
        ann_reference_forward(
            ann, images, taps=taps,
            use_block_conv=cfg.use_block_conv, block_hw=cfg.block_hw, device=dev,
        )
        ann_acts = {
            n: np.minimum(
                np.maximum(taps[n].cpu().numpy() + folded[n][1], 0.0),
                np.maximum(np.asarray(stats.layers[n].lam), 1e-12),
            ).astype(np.float32)
            for n in names
        }
        del taps
        for _ in range(int(cc.calib_passes)):
            params, bn, _, _ = emit_all(values)
            rates = _realized_rates(
                cfg, params, bn, images, names, batch=cc.calib_batch
            )
            values = _refit_values(values, rates, ann_acts, live)

    params, bn, report_layers, head_w = emit_all(values)

    alpha = 1.0
    if cc.head_scale == "empirical":
        alpha = _fit_head_scale(cfg, params, bn, images, stats.head)
        params["head"] = {"w": torch.from_numpy(head_w * alpha).to(dev)}
    elif cc.head_scale != "analytic":
        raise ValueError(f"head_scale {cc.head_scale!r}")

    plan = cplan.build_plan(params, cfg)
    report = {
        "convert_config": dataclasses.asdict(cc),
        "source_arch_id": ann.cfg.arch_id,
        "calib_images": int(stats.n_images),
        "readout_scale": rho,
        "head_scale_fit": float(alpha),
        "layers": report_layers,
        "plan_summary": plan.summary(),
    }
    return ConvertedDetector(cfg=cfg, params=params, bn_state=bn, report=report)


def _dense_forward_batches(cfg, params, bn, images, batch: int, fn) -> list:
    """``fn(forward outputs)`` per batch of ``images`` through the ``dense``
    executor's plan on the parameters' device, TF32 off, no autograd."""
    fit_cfg = dataclasses.replace(cfg, conv_exec="dense")
    plan = cplan.build_plan(params, fit_cfg)
    dev = params["encode"]["w"].device
    out = []
    with torch.no_grad(), sy._no_tf32():
        for i in range(0, images.shape[0], batch):
            imgs = torch.from_numpy(np.ascontiguousarray(images[i : i + batch])).to(dev)
            out.append(fn(fit_cfg, plan, imgs))
    return out


def _realized_rates(cfg, params, bn, images, names, *, batch: int) -> dict:
    """Run the CONVERTED detector on the calibration images with drive
    taps and reconstruct each layer's firing rates. The taps ARE the real
    per-step LIF drives of the run, so applying the same LIF dynamics to
    them reproduces the executor's spike trains exactly."""

    def rates(fit_cfg, plan, imgs):
        t: dict = {}
        sy.forward(params, bn, imgs, fit_cfg, train=False, plan=plan, taps=t)
        out = {}
        for n in names:
            init = None
            if fit_cfg.v_init:
                init = lifm.LIFState(
                    v=torch.full(tuple(t[n].shape[1:]), fit_cfg.v_init,
                                 dtype=t[n].dtype, device=t[n].device)
                )
            s, _ = lifm.lif_over_time(
                t[n], threshold=fit_cfg.threshold, leak=fit_cfg.leak,
                reset=fit_cfg.reset, init=init,
            )
            out[n] = s.mean(dim=0).cpu().numpy()  # (N, H, W, C) firing rate
        return out

    per_batch = _dense_forward_batches(cfg, params, bn, images, batch, rates)
    return {n: np.concatenate([r[n] for r in per_batch], axis=0) for n in names}


def _refit_values(values, rates, ann_acts, live) -> dict:
    """Per-channel least squares v_c = Σ(a·r)/Σ(r²): the spike value that
    best reconstructs the clipped ANN activation from the REALIZED rates.
    Channels that never fired on the calibration set keep their previous
    value (nothing to fit against)."""
    out = {}
    for n, v in values.items():
        c = v.shape[0]
        r = rates[n].reshape(-1, c).astype(np.float64)
        a = ann_acts[n].reshape(-1, c).astype(np.float64)
        num = (a * r).sum(axis=0)
        den = (r * r).sum(axis=0)
        ok = live[n] & (den > 1e-8)
        fit = num / np.where(den > 0.0, den, 1.0)
        out[n] = np.where(ok, fit, v).astype(np.float32)
    return out


def _fit_head_scale(cfg, params, bn, images, head_ann) -> float:
    """Least-squares scalar α minimizing ‖α·head_snn − head_ann‖² on the
    calibration images, run through the REAL executor plan (so the fit
    sees FXP quantization) on the ``dense`` executor. Falls back to 1.0 on
    a silent head."""

    def head(fit_cfg, plan, imgs):
        return sy.forward(params, bn, imgs, fit_cfg, train=False, plan=plan)[0].cpu().numpy()

    head_snn = np.concatenate(_dense_forward_batches(cfg, params, bn, images, 8, head),
                              axis=0)
    num = float((head_snn * head_ann).sum())
    den = float((head_snn * head_snn).sum())
    if den <= 0.0:
        return 1.0
    return num / den
