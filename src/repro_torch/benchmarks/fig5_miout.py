"""Fig 4 + Fig 5 — the mIoUT metric.

Counterpart of ``benchmarks/fig5_miout.py``. Fig 4: the worked example (4
neurons firing at all steps, 2 at some) must give 0.67. Fig 5: mIoUT of
the spikes each macro layer emits, on synthetic images through the
detector at 144×256 (uniform T=3, plain SAME conv) — the paper's finding is
that the second layer sees near-identical features across time steps
(mIoUT ~1), which justifies the (1, 3) mixed schedule, while deep layers
diverge. The seeded weights differ from the JAX package's, so the per-layer
values differ from its run; the forward runs with TF32 off.

  PYTHONPATH=src python -m repro_torch.benchmarks.fig5_miout [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs.snn_det import CONFIG
from repro_torch.core import miout as mi
from repro_torch.data import synthetic_detection as sd
from repro_torch.models import snn_yolo as sy


def run(device=None) -> dict:
    # --- Fig 4 worked example ---
    t = 3
    spikes = np.zeros((t, 8, 1), np.float32)
    spikes[:, :4] = 1.0  # 4 neurons fire every step
    spikes[0, 4] = 1.0  # 2 neurons fire once each
    spikes[2, 5] = 1.0
    fig4 = float(mi.miout(torch.from_numpy(spikes)))
    print(f"Fig 4 worked example: mIoUT = {fig4:.2f} (paper: 0.67)")

    # --- Fig 5 on the (reduced) detector with synthetic frames ---
    cfg = dataclasses.replace(CONFIG, input_hw=(144, 256), use_block_conv=False,
                              mixed_time=False)
    params, bn = sy.init_params(cfg, seed=0, device=device)
    batch = next(sd.batches(2, hw=cfg.input_hw, steps=1))
    images = torch.from_numpy(batch["image"]).to(params["encode"]["w"].device)
    with torch.no_grad(), sy._no_tf32():
        _, _, aux = sy.forward(params, bn, images, cfg, train=False)
    out = {"fig4": fig4}
    print("Fig 5 — mIoUT per macro layer (T=3, untrained net, synthetic frames)")
    for name, s in aux["spikes"].items():
        if s.shape[0] == 1:
            continue
        v = float(mi.miout(s))
        out[name] = v
        print(f"  {name:12s} mIoUT = {v:.3f}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    run(ap.parse_args().device)
