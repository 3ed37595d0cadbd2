"""The paper's spiking detector, served by the program's ``serve.Engine``.

Weights are made here from the seed, a frozen copy of
``repro_torch.serve.detector.demo_weights``' recipe: He-normal conv
weights, every 3x3 kernel pruned by magnitude to ``prune_rate``, gamma 1
and beta 0, and tdBN running statistics moved ``bn_iters`` times (momentum
``momentum``, from mean 0 and variance 1) onto the batch statistics of a
train-mode forward over ``calib_frames`` seeded frames (fake-quantized
weights, surrogate-free spikes: the statistics need no gradient). The same
float weights and statistics go to the program and to the reference, which
each work out the int8 weights and the affines from them.
"""
from __future__ import annotations

import math

import torch

from bench.reference import snn_ref
from bench.workload import sub_seed


def program_config(m: dict):
    """The program's ``SNNDetConfig`` for the model keys."""
    from repro_torch.models.snn_yolo import SNNDetConfig

    keys = dict(m)
    for k in ("input_hw", "block_hw"):
        keys[k] = tuple(keys[k])
    keys["stage_channels"] = tuple(tuple(p) for p in keys["stage_channels"])
    return SNNDetConfig(**keys)


def _fake_quant(w):
    scale = torch.clamp(w.abs().amax(), min=1e-8) / 127
    return torch.clamp(torch.round(w / scale), -128, 127) * scale


@torch.no_grad()
def tdbn_statistics(m: dict, weights: dict, frames: torch.Tensor, *, iters: int,
                    momentum: float) -> None:
    """Set each layer's "mean" and "var": the running statistics after
    ``iters`` train-mode passes over ``frames``. A train-mode pass
    normalises by its own batch, so every pass sees the same batch
    statistics and only the running update repeats."""
    geo = snn_ref.layer_geometry(m)
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    def layer(name, x_t, t_out):
        p = weights[name]
        t_in, n = x_t.shape[:2]
        y = snn_ref.conv_int(x_t.reshape(t_in * n, *x_t.shape[2:]).float(),
                             _fake_quant(p["w"]), m["block_hw"])
        y = y.reshape(t_in, n, *y.shape[1:]).expand(t_out, n, *y.shape[1:])
        dims = tuple(range(y.dim() - 1))
        mean_b, var_b = y.mean(dim=dims), y.var(dim=dims, unbiased=False)
        mean_r, var_r = torch.zeros_like(mean_b), torch.ones_like(var_b)
        for _ in range(iters):
            mean_r = momentum * mean_r + (1 - momentum) * mean_b
            var_r = momentum * var_r + (1 - momentum) * var_b
        p["mean"], p["var"] = mean_r, var_r
        d = (m["threshold"] * (y - mean_b) * torch.rsqrt(var_b + snn_ref.EPS)) * p["gamma"] \
            + p["beta"]
        v = torch.zeros_like(d[0])
        out = []
        for t in range(t_out):
            v = v * m["leak"] + d[t]
            s = v >= m["threshold"]
            v = torch.where(s, torch.zeros_like(v), v)
            out.append(s.float())
        return torch.stack(out)

    try:
        s = snn_ref._pool_or(layer("encode", frames[None], geo["encode"][3]))
        s = snn_ref._pool_or(layer("conv_block", s, geo["conv_block"][3]))
        for i in range(len(m["stage_channels"])):
            g = f"stage{i}"
            short = layer(f"{g}/shortcut", s, m["full_t"])
            a = layer(f"{g}/main_in", s, m["full_t"])
            a = layer(f"{g}/main_a", a, m["full_t"])
            a = layer(f"{g}/main_b", a, m["full_t"])
            s = layer(f"{g}/agg", torch.cat([a, short], dim=-1), m["full_t"])
            if i < m["pooled_stages"] - 1:
                s = snn_ref._pool_or(s)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def make_weights(m: dict, w_spec: dict, seed: int, device) -> dict:
    """{layer: {"w", "gamma", "beta", "mean", "var"}} float32 on ``device``."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    shapes = snn_ref.layer_shapes(m)
    flat = torch.randn(sum(math.prod(s) for s in shapes.values()), generator=gen,
                       device=device)
    weights, at = {}, 0
    for name, (kh, kw, cin, cout) in shapes.items():
        size = kh * kw * cin * cout
        w = flat[at:at + size].reshape(kh, kw, cin, cout) * math.sqrt(2.0 / (kh * kw * cin))
        at += size
        if kh > 1 or kw > 1:
            k = int(math.floor(w_spec["prune_rate"] * w.numel()))
            if k:
                thr = torch.sort(w.abs().reshape(-1)).values[k - 1]
                w = torch.where(w.abs() > thr, w, torch.zeros_like(w))
        weights[name] = {"w": w.contiguous()}
        if name != "head":
            weights[name].update(gamma=torch.ones(cout, device=device),
                                 beta=torch.zeros(cout, device=device))
    h, w = m["input_hw"]
    frames = torch.randint(0, 256, (w_spec["calib_frames"], h, w, 3), generator=gen,
                           device=device, dtype=torch.uint8).float() / 255.0
    tdbn_statistics(m, weights, frames, iters=w_spec["bn_iters"], momentum=w_spec["momentum"])
    return weights


class System:
    """One cell's system under test and the inputs the reference needs."""

    def __init__(self, spec: dict, seed: int, device):
        self.spec = spec
        self.m = dict(spec["model"])
        self.device = torch.device(device)
        self.weights = make_weights(self.m, spec["weights"], seed, self.device)

    def compile(self):
        """The program's compiled detector (plan, affines) for the weights."""
        from repro_torch.models.snn_yolo import compile_detector

        params = {n: {k: p[k] for k in ("w", "gamma", "beta") if k in p}
                  for n, p in self.weights.items()}
        bn = {n: {"mean": p["mean"], "var": p["var"],
                  "count": torch.ones((), dtype=torch.int32, device=self.device)}
              for n, p in self.weights.items() if n != "head"}
        s = self.spec["serve"]
        return compile_detector(program_config(self.m), params, bn, device=self.device,
                                anchors=tuple(tuple(a) for a in s["anchors"]),
                                score_threshold=s["score_threshold"],
                                iou_threshold=s["iou_threshold"],
                                max_detections=s["max_detections"])

    def reference(self, *, bits: int = 8, fdtype=torch.float32) -> snn_ref.Net:
        return snn_ref.Net(self.m, self.weights, bits=bits, fdtype=fdtype)
