"""An ANN detector converted to a spiking one by the program's
``convert.convert_ann``, then served by its ``serve.Engine``.

The ANN is made here from the seed: He-normal conv and head weights at the
configuration's widths; BatchNorm with the threshold folded into gamma
(gamma = threshold, beta 0, as the program's ``export_ann_npz`` writes an
ANN-mode detector) and running statistics that a trained BatchNorm would
hold, each layer's conv-output mean and variance over ``bn_frames``
seeded frames, so every layer's activations keep their scale down to the
head; and the calibration images drawn from the seed on the u8 grid. The program
converts them; the reference converts them again
(``bench/reference/convert_ref.py``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from bench.families.snn_det import program_config
from bench.reference import convert_ref, snn_ref
from bench.workload import sub_seed


class _Images:
    """A calibration source handing the program the seeded images."""

    def __init__(self, images: np.ndarray):
        self.images = images

    def eval_set(self, n_images: int, **_):
        if n_images != self.images.shape[0]:
            raise ValueError(f"asked for {n_images} calibration images, made "
                             f"{self.images.shape[0]}")
        return self.images, None


@torch.no_grad()
def ann_statistics(m: dict, ann: dict, frames: torch.Tensor) -> None:
    """Set each ANN layer's BatchNorm "mean" and "var" to its conv output's
    statistics over ``frames`` (TF32 off), layer by layer."""
    dev = frames.device
    eps = ann["eps"]
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    def layer(x, name):
        p = ann["layers"][name]
        c = convert_ref._blocks_conv(x, torch.from_numpy(p["w"]).to(dev), m["block_hw"])
        mean = c.mean(dim=(0, 1, 2))
        var = c.var(dim=(0, 1, 2), unbiased=False)
        p["mean"], p["var"] = mean.cpu().numpy(), var.cpu().numpy()
        g, b = torch.from_numpy(p["gamma"]).to(dev), torch.from_numpy(p["beta"]).to(dev)
        return torch.relu(g * (c - mean) / torch.sqrt(var + eps) + b)

    try:
        a = convert_ref._pool(layer(frames, "encode"))
        a = convert_ref._pool(layer(a, "conv_block"))
        for i in range(len(m["stage_channels"])):
            g = f"stage{i}"
            short = layer(a, f"{g}/shortcut")
            x = layer(layer(layer(a, f"{g}/main_in"), f"{g}/main_a"), f"{g}/main_b")
            a = layer(torch.cat([x, short], dim=-1), f"{g}/agg")
            if i < m["pooled_stages"] - 1:
                a = convert_ref._pool(a)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


class System:
    def __init__(self, spec: dict, seed: int, device):
        self.spec = spec
        self.m = dict(spec["model"])
        self.device = torch.device(device)
        self.cc = dict(spec["convert"])
        gen = torch.Generator(device=self.device).manual_seed(sub_seed(seed, 3))
        shapes = snn_ref.layer_shapes(self.m)
        flat = torch.randn(sum(math.prod(s) for s in shapes.values()), generator=gen,
                           device=self.device)
        layers, at = {}, 0
        thr = np.float32(self.m["threshold"])
        for name, (kh, kw, cin, cout) in shapes.items():
            size = kh * kw * cin * cout
            w = (flat[at:at + size].reshape(kh, kw, cin, cout)
                 * math.sqrt(2.0 / (kh * kw * cin))).cpu().numpy()
            at += size
            layers[name] = {"w": w, "gamma": np.full(cout, thr, np.float32),
                            "beta": np.zeros(cout, np.float32),
                            "mean": np.zeros(cout, np.float32),
                            "var": np.ones(cout, np.float32)}
        head_w = layers.pop("head")["w"]
        self.ann = {"layers": layers, "head_w": head_w, "eps": 1e-5}
        h, w = self.m["input_hw"]
        u8 = torch.randint(0, 256, (spec["weights"]["bn_frames"], h, w, 3), generator=gen,
                           device=self.device, dtype=torch.uint8)
        ann_statistics(self.m, self.ann, u8.float() / 255.0)
        u8 = torch.randint(0, 256, (self.cc["calib_images"], h, w, 3), generator=gen,
                           device=self.device, dtype=torch.uint8)
        self.images = (u8.float() / 255.0).cpu().numpy()

    def compile(self):
        """The program's conversion of the ANN, compiled for serving."""
        from repro_torch import convert as cv
        from repro_torch.convert import importer as imp
        from repro_torch.models.snn_yolo import compile_detector

        ann_cfg = program_config({**self.m, **self.spec["ann"]})
        ann = imp.AnnDetector(
            cfg=ann_cfg,
            layers={n: imp.AnnConvBN(**p) for n, p in self.ann["layers"].items()},
            head_w=self.ann["head_w"], eps=self.ann["eps"])
        cc = cv.ConvertConfig(**self.cc)
        conv = cv.convert_ann(ann, source=_Images(self.images), cc=cc, device=self.device)
        cfg = conv.cfg
        want = program_config(self.m)
        if cfg != dataclasses.replace(want, arch_id=cfg.arch_id):
            raise ValueError(f"the conversion made {cfg}, the configuration states {want}")
        s = self.spec["serve"]
        return compile_detector(cfg, conv.params, conv.bn_state, device=self.device,
                                anchors=tuple(tuple(a) for a in s["anchors"]),
                                score_threshold=s["score_threshold"],
                                iou_threshold=s["iou_threshold"],
                                max_detections=s["max_detections"])

    def reference(self, *, bits: int = 8, fdtype=torch.float32) -> snn_ref.Net:
        if not hasattr(self, "_weights"):
            self._weights = convert_ref.convert(self.m, self.cc, self.ann, self.images,
                                                self.device)
        return snn_ref.Net(self.m, self._weights, bits=bits, fdtype=fdtype)
