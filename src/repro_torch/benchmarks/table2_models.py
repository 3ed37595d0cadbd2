"""Table II — model-family comparison: ANN / QNN / BNN / SNN variants of the
same topology.

Counterpart of ``benchmarks/table2_models.py``. The reproducible cells are
model size (Mbits) and parameter counts; with ``train_steps`` a short
synthetic-data training run per mode shows each variant learns (loss
decreases) — the accuracy ordering on IVS 3cls is not reproducible
offline. The training runs the port's train-mode forward, ``yolo_loss``
and plain SGD at lr 5e-3, TF32 off, on ``device`` (default: the card).

  PYTHONPATH=src python -m repro_torch.benchmarks.table2_models [--train-steps 5]
      [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch import tree as tu
from repro_torch.configs.snn_det import CONFIG
from repro_torch.data import synthetic_detection as sd
from repro_torch.eval import harness
from repro_torch.models import snn_yolo as sy

SGD_LR = 5e-3


def model_size_mbits(n_params: float, weight_bits: int) -> float:
    return n_params * weight_bits / 1e6


def run(train_steps: int = 0, device=None) -> dict:
    cfg = CONFIG
    params, _ = sy.init_params(cfg, seed=0, device=device)
    n = sy.param_count(params)
    n_pruned = int(n * 0.30)  # −70% (Table I)

    rows = [
        # name, act, weight_bits, params, block conv
        ("ANN", "Float32", 32, n, False),
        ("QNN-4", "FXP4", 32, n, False),
        ("QNN-3", "FXP3", 32, n, False),
        ("QNN-2", "FXP2", 32, n, False),
        ("BNN", "Binary", 1, n, False),
        ("SNN-a", "Binary(T=1,3)", 32, n, False),
        ("SNN-d", "Binary(T=1,3)", 8, n_pruned, True),
    ]
    print("Table II — model family accounting")
    print(f"{'model':8s} {'act':>14s} {'w_bits':>6s} {'params(M)':>10s} {'size(Mbit)':>11s}")
    out = {}
    for name, act, wb, p, blk in rows:
        sz = model_size_mbits(p, wb)
        out[name] = {"params_M": p / 1e6, "size_mbits": sz}
        print(f"{name:8s} {act:>14s} {wb:6d} {p/1e6:10.2f} {sz:11.2f}")
    print(f"paper: ANN 101.44 Mbit / SNN-d 7.68 Mbit; ours: "
          f"{out['ANN']['size_mbits']:.2f} / {out['SNN-d']['size_mbits']:.2f}")

    if train_steps:
        # one tiny reduced-config training run per mode on synthetic data
        small = dataclasses.replace(
            cfg, input_hw=(96, 160), stem_channels=8, conv_block_channels=16,
            stage_channels=((16, 16), (16, 32), (32, 32)), pooled_stages=3,
            use_block_conv=False,
        )
        for mode in ("snn", "ann", "qnn", "bnn"):
            mcfg = dataclasses.replace(small, mode=mode)
            losses = _short_train(mcfg, train_steps, device=device)
            out.setdefault("learning", {})[mode] = losses
            print(f"  {mode:4s} loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return out


def _short_train(cfg, steps: int, device=None) -> list:
    """``steps`` plain SGD steps on one synthetic batch of 2; the losses."""
    params, bn = sy.init_params(cfg, seed=0, device=device)
    dev = params["encode"]["w"].device
    batch = next(sd.batches(2, hw=cfg.input_hw, steps=1, grid_div=harness.grid_div(cfg)))
    imgs = torch.from_numpy(batch["image"]).to(dev)
    tgts = torch.from_numpy(batch["target"]).to(dev)
    losses = []
    with sy._no_tf32():
        for _ in range(steps):
            loss, grads, bn, _ = harness.loss_and_grads(cfg, params, bn, imgs, tgts)
            params = tu.tree_map(lambda w, g: w - SGD_LR * g, params, grads)
            losses.append(float(loss))
    return losses


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train-steps", type=int, default=5)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = ap.parse_args()
    run(train_steps=a.train_steps, device=a.device)
