"""Plain reference of the ANN -> SNN conversion (Spiking-YOLO channel
norm, arXiv 1903.06530), as the conversion's documented arithmetic states
it: worked out again from the ANN and the calibration images alone.

1. The ANN (conv -> BatchNorm -> ReLU, BN folded into the conv: w~ = w *
   gamma / sqrt(var + eps), b~ = beta - mean * gamma / sqrt(var + eps))
   runs on the calibration images snapped to the u8 grid, with the SNN's
   block convolution, in float32 (TF32 off). Per layer it records the
   bias-free conv output c.
2. Per channel: lambda = the ``percentile`` of relu(c + b~); mean and
   variance of c (numpy on the host).
3. Emit, per layer: spikes of the layer below are worth its lambda (the
   image's pixels 1); the input-scaled weights are conditioned per output
   channel (d_c = max|W| / max|W_c|) and the tdBN carries the affine:
   mean_x = d * mean, var_x = d^2 * var, gamma = sqrt(var_x + eps) /
   (lambda * d), beta = threshold * (mean + b~) / lambda; a dead channel
   (lambda <= dead_eps) gets gamma = beta = 0.
4. The head: its weights times the input values, over the readout gain
   rho(T, leak); then a least-squares scalar alpha fits the converted
   network's head to the ANN's on the calibration images.

Returns the converted weights in the form ``snn_ref.Net`` takes.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from bench.reference import snn_ref


def _blocks_conv(x: torch.Tensor, w: torch.Tensor, block_hw) -> torch.Tensor:
    """float32 conv of NHWC ``x`` with HWIO ``w``: a 1x1 is a matmul over
    the channels; a 3x3 convolves each block of the map on its own,
    replicate-padded at the block's border."""
    kh, kw, c, k = w.shape
    if kh == 1 and kw == 1:
        return x @ w[0, 0]
    n, h, wd, _ = x.shape
    bh, bw = block_hw
    xb = x.reshape(n, h // bh, bh, wd // bw, bw, c).permute(0, 1, 3, 2, 4, 5)
    flat = xb.reshape(-1, bh, bw, c).permute(0, 3, 1, 2)
    pad = (kh - 1) // 2
    flat = F.pad(flat, (pad, pad, pad, pad), mode="replicate")
    out = F.conv2d(flat, w.permute(3, 2, 0, 1))
    out = out.permute(0, 2, 3, 1).reshape(n, h // bh, wd // bw, bh, bw, k)
    return out.permute(0, 1, 3, 2, 4, 5).reshape(n, h, wd, k)


def _pool(x):
    n, h, w, c = x.shape
    x = x[:, : h - h % 2, : w - w % 2]
    return x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def layer_names(m: dict) -> list:
    return [n for n in snn_ref.layer_shapes(m) if n != "head"]


def folded(layer: dict, eps: float) -> tuple[np.ndarray, np.ndarray]:
    s = layer["gamma"] / np.sqrt(layer["var"] + eps)
    return (layer["w"] * s).astype(np.float32), (layer["beta"] + s * (0.0 - layer["mean"])).astype(
        np.float32)


@torch.no_grad()
def ann_forward(m: dict, ann: dict, images: np.ndarray, device, *, batch: int):
    """The ANN over ``images`` in batches: ({layer: bias-free conv output,
    host (samples, C)}, head (N, gh, gw, A, 5 + C) host)."""
    names = layer_names(m)
    fold = {n: folded(ann["layers"][n], ann["eps"]) for n in names}
    wts = {n: (torch.from_numpy(fold[n][0]).to(device), torch.from_numpy(fold[n][1]).to(device))
           for n in names}
    head_w = torch.from_numpy(ann["head_w"]).to(device)
    taps = {n: [] for n in names}
    heads = []
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for i in range(0, images.shape[0], batch):
            a = torch.clamp(torch.as_tensor(images[i:i + batch], dtype=torch.float32), 0.0, 1.0)
            a = (torch.round(a * 255.0) / 255.0).to(device)

            def layer(x, name):
                c = _blocks_conv(x, wts[name][0], m["block_hw"])
                taps[name].append(c.cpu().numpy().reshape(-1, c.shape[-1]))
                return torch.relu(c + wts[name][1])

            a = _pool(layer(a, "encode"))
            a = _pool(layer(a, "conv_block"))
            for s in range(len(m["stage_channels"])):
                g = f"stage{s}"
                short = layer(a, f"{g}/shortcut")
                x = layer(a, f"{g}/main_in")
                x = layer(x, f"{g}/main_a")
                x = layer(x, f"{g}/main_b")
                a = layer(torch.cat([x, short], dim=-1), f"{g}/agg")
                if s < m["pooled_stages"] - 1:
                    a = _pool(a)
            head = _blocks_conv(a, head_w, m["block_hw"])
            n, gh, gw, _ = head.shape
            heads.append(head.reshape(n, gh, gw, m["num_anchors"], 5 + m["num_classes"])
                         .cpu().numpy())
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    return taps, np.concatenate(heads, axis=0)


def readout_gain(t: int, leak: float, mode: str) -> float:
    """rho: the head readout's gain for a constant per-step input."""
    vs, v = [], 0.0
    for _ in range(t):
        v = v * leak + 1.0
        vs.append(v)
    return float(vs[-1] / t) if mode == "final" else float(np.mean(vs))


def _condition(w):
    m = np.abs(w).reshape(-1, w.shape[-1]).max(axis=0)
    big = m.max()
    if big == 0.0:
        return w, np.ones_like(m)
    d = np.where(m > 0, big / np.where(m > 0, m, 1.0), 1.0)
    return (w * d).astype(np.float32), d.astype(np.float32)


def convert(m: dict, cc: dict, ann: dict, images: np.ndarray, device) -> dict:
    """The converted network's weights ({layer: {"w", "gamma", "beta",
    "mean", "var"}} float32 tensors on ``device``) from the ANN (``ann``:
    {"layers": {name: {"w", "gamma", "beta", "mean", "var"}}, "head_w",
    "eps"}, numpy) and the calibration ``images``. ``m``: the converted
    model's keys; ``cc``: the conversion's knobs."""
    names = layer_names(m)
    taps, head_ann = ann_forward(m, ann, images, device, batch=cc["calib_batch"])
    fold = {n: folded(ann["layers"][n], ann["eps"]) for n in names}
    stats = {}
    for n in names:
        c = np.concatenate(taps.pop(n), axis=0)
        act = np.maximum(c + fold[n][1], 0.0)
        stats[n] = (np.percentile(act, cc["percentile"], axis=0).astype(np.float32),
                    c.mean(axis=0).astype(np.float32), c.var(axis=0).astype(np.float32))
        del c, act
    if not cc["rate_encode"]:
        raise ValueError("the reference converts rate-coded encodes only")
    gain, thr, eps = cc["gain"], m["threshold"], 1e-5
    live = {n: stats[n][0] > cc["dead_eps"] for n in names}
    vals = {n: np.where(live[n], stats[n][0] / gain, 0.0).astype(np.float32) for n in names}
    in_val = {"encode": np.ones(3, np.float32), "conv_block": vals["encode"]}
    prev = "conv_block"
    for s in range(len(m["stage_channels"])):
        g = f"stage{s}"
        in_val[f"{g}/shortcut"] = in_val[f"{g}/main_in"] = vals[prev]
        in_val[f"{g}/main_a"] = vals[f"{g}/main_in"]
        in_val[f"{g}/main_b"] = vals[f"{g}/main_a"]
        in_val[f"{g}/agg"] = np.concatenate([vals[f"{g}/main_b"], vals[f"{g}/shortcut"]])
        prev = f"{g}/agg"
    out = {}
    for n in names:
        lam, mean, var = stats[n]
        w_tilde, b_tilde = fold[n]
        w_in = (w_tilde * in_val[n][None, None, :, None]).astype(np.float32)
        dead = lam <= cc["dead_eps"]
        w_s, d = _condition(w_in)
        mean_x = (d * mean).astype(np.float32)
        var_x = (d * d * var).astype(np.float32)
        lam_safe = np.where(dead, 1.0, lam)
        gamma = (gain * np.sqrt(var_x + eps) / (lam_safe * d)).astype(np.float32)
        beta = (thr * gain * (mean + b_tilde) / lam_safe).astype(np.float32)
        out[n] = {"w": w_s, "gamma": np.where(dead, 0.0, gamma).astype(np.float32),
                  "beta": np.where(dead, 0.0, beta).astype(np.float32),
                  "mean": mean_x, "var": var_x}
    rho = readout_gain(m["full_t"], m["leak"], m["head_readout"])
    head_w = (ann["head_w"] * vals[prev][None, None, :, None] / rho).astype(np.float32)
    out["head"] = {"w": head_w}
    weights = {n: {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                   for k, v in p.items()} for n, p in out.items()}
    net = snn_ref.Net(m, weights)
    heads = []
    for i in range(0, images.shape[0], cc["calib_batch"]):
        x = torch.from_numpy(np.ascontiguousarray(images[i:i + cc["calib_batch"]])).to(device)
        heads.append(net.step(x, net.zero_state(x.shape[0], device))[0].cpu().numpy())
    head_snn = np.concatenate(heads, axis=0)
    num = float((head_snn * head_ann).sum())
    den = float((head_snn * head_snn).sum())
    alpha = 1.0 if den <= 0.0 else num / den
    weights["head"] = {"w": torch.from_numpy(head_w * alpha).to(device)}
    return weights
