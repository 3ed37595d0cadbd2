"""Training launcher for the detector: surrogate-gradient training with AdamW
under ``ft.Supervisor`` restarts, then the SNN-a → SNN-d compression
(prune 80% of the 3×3 kernels, fake-quantize the convs to 8 bits), the
compile-once detector on the result, mAP@0.5 (trained vs pruned+quant) on
the val split, and a detector checkpoint that either package
restores and serves. Counterpart of ``examples/train_snn_detector.py``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train_detector --device cpu \\
      [--steps 300 --batch 4 --ckpt DIR --eval-images 16] [--full-config]

``--full-config`` trains the paper's 576×1024 ``snn-det`` (block conv
18×32) instead of the 96×160 demo configuration; ``--dataset`` takes
``synthetic``, ``coco:<instances.json>`` or ``voc:<dir>`` (letterboxed
annotated frames, for training and the mAP report); ``--eval-shards K``
scores the mAP report through the sharded evaluator (bit-identical to one
shard).
Runs on the card unless ``--device cpu``; exits non-zero when the loss did
not fall.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import tree as tu
from repro_torch.backend import resolve_device
from repro_torch.configs.snn_det import CONFIG
from repro_torch.core import pruning, quant
from repro_torch.data import detection_datasets as dd
from repro_torch.eval import harness
from repro_torch.models import snn_yolo as sy
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import ft
from repro_torch.train import optimizer as opt


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "snn_det_ckpt"),
                    help="checkpoint root: train state, heartbeat, and the detector "
                         "checkpoint under <ckpt>/detector")
    ap.add_argument("--dataset", default="synthetic",
                    help="train/eval data: synthetic | coco:<instances.json> | voc:<dir>")
    ap.add_argument("--eval-images", type=int, default=16,
                    help="val images for the post-training mAP report")
    ap.add_argument("--eval-shards", type=int, default=1,
                    help="shard count of the mAP report (repro_torch.eval.sharded; "
                         "bit-identical to 1 shard)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--full-config", action="store_true",
                    help="the paper's 576x1024 snn-det instead of the demo config")
    args = ap.parse_args(argv)
    source = dd.parse_dataset_spec(args.dataset)
    dev = resolve_device(args.device)

    cfg = CONFIG if args.full_config else harness.demo_config()
    ocfg = opt.AdamWConfig(lr_peak=2e-3, lr_init=2e-4, lr_final=2e-5, warmup_steps=20,
                           total_steps=args.steps, weight_decay=1e-3)

    def init_state():
        params, bn = sy.init_params(cfg, seed=0, device=dev)
        return {"params": params, "bn": bn, "opt": opt.init_state(params, ocfg)}

    grid_div = harness.grid_div(cfg)
    stream = source.batches(args.batch, hw=cfg.input_hw, steps=args.steps, grid_div=grid_div)
    losses = []

    def step_fn(state, step):
        batch = next(stream)
        params, bn, o, loss = harness.train_step(
            cfg, ocfg, state["params"], state["bn"], state["opt"],
            torch.from_numpy(batch["image"]).to(dev), torch.from_numpy(batch["target"]).to(dev))
        losses.append(float(loss))
        if step % 25 == 0:
            lr = float(opt.lr_schedule(ocfg, torch.tensor(step, dtype=torch.int32)))
            print(f"step {step:4d} loss {losses[-1]:8.4f} lr {lr:.2e}")
        return {"params": params, "bn": bn, "opt": o}

    sup = ft.Supervisor(ckpt_root=args.ckpt, save_every=50,
                        heartbeat=ft.Heartbeat(os.path.join(args.ckpt, "heartbeat.json")))
    t0 = time.time()
    with sy._no_tf32():
        state = sup.run(init_state=init_state, state_template=init_state, step_fn=step_fn,
                        n_steps=args.steps)
    if not losses:
        raise SystemExit(f"no step ran: {args.ckpt} already holds step {args.steps - 1}; "
                         "pass another --ckpt")
    print(f"trained {len(losses)} steps in {time.time() - t0:.1f}s; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")

    # SNN-a -> SNN-d: prune 80% of the 3x3 kernels, fake-quantize the convs
    params, bn = state["params"], state["bn"]
    pruned = pruning.prune_tree(params, rate=0.8)
    rep = pruning.tree_sparsity_report(pruned)
    q = tu.tree_map(lambda x: quant.fake_quant_tensor(x, bits=8) if x.dim() == 4 else x, pruned)
    det = sy.compile_detector(cfg, q, bn, device=dev)
    imgs = next(source.batches(2, hw=cfg.input_hw, steps=1, grid_div=grid_div))["image"]
    dets, head = det.detect(torch.from_numpy(imgs))
    print(f"pruned: kept {rep['kept_frac'] * 100:.1f}% of {rep['total_params'] / 1e3:.0f}k "
          f"params (paper SNN-b: 30%)")
    print(f"SNN-d compile_detector OK: head {tuple(head.shape)}, "
          f"finite={bool(torch.isfinite(head).all())}, "
          f"detections/frame {dets.count.tolist()}")

    # mAP@0.5 on the synthetic val split: float weights as trained (no
    # plan) against the pruned and quantized SNN-d
    maps = {}
    for tag, (c, p) in {"trained": (dataclasses.replace(cfg, weight_bits=0), params),
                        "pruned+quant": (cfg, q)}.items():
        r = harness.evaluate_detector(
            harness.compile_eval_detector(c, p, bn, device=dev),
            n_images=args.eval_images, source=source,
            sharded=args.eval_shards if args.eval_shards > 1 else None)
        maps[tag] = r["map"]
        aps = ", ".join(f"{a:.3f}" for a in r["per_class_ap"])
        print(f"mAP@0.5 [{tag}] {r['map']:.3f} (per-class {aps}) "
              f"on {r['n_images']} val images")

    det_ckpt = os.path.join(args.ckpt, "detector")
    harness.save_detector_checkpoint(det_ckpt, args.steps, q, bn, cfg)
    print(f"detector checkpoint committed to {det_ckpt} — serve it with:\n"
          f"  PYTHONPATH=src python -m repro_torch.launch.serve --arch snn-det "
          f"--checkpoint {det_ckpt}")
    ckpt.wait_pending()  # surfaces a failed async checkpoint write
    if losses[-1] >= losses[0]:
        raise SystemExit("loss did not decrease")
    print("train_detector OK")
    return {"losses": losses, "map": maps, "sparsity": rep, "detector_ckpt": det_ckpt,
            "valid": np.asarray(dets.valid.cpu()), "head": head}


if __name__ == "__main__":
    main()
