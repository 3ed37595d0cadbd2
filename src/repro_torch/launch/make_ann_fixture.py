"""Train the ANN-mode demo detector and export it as a pretrained-ANN bundle
for the ANN→SNN conversion. Counterpart of ``scripts/make_ann_fixture.py``,
with its flags and prints, plus ``--device``.

Trains the repo's ANN-mode demo detector (96×160, thinned channels — the
same architecture ``harness.demo_config`` evaluates) on the synthetic
train split, scores it on the val split, and exports it as a format-v1
npz bundle (``repro_torch.convert.export_ann_npz``, which both packages'
``load_ann_npz`` read). Convert it with

  PYTHONPATH=src python -m repro_torch.launch.convert --npz <out>

  PYTHONPATH=src python -m repro_torch.launch.make_ann_fixture [--steps 4000]
      [--batch 6] [--eval-images 48]
      [--out artifacts/ann_torch/ann_tiny_yolo.npz] [--device cpu]

Runs on the card unless ``--device cpu``. It refuses to write over the
committed fixture (``tests/fixtures/ann_detector/ann_tiny_yolo.npz``): the
conversion tests and their 0.39 mAP reference are held to that file, which
the JAX package trained.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

from repro_torch import convert as cv
from repro_torch.backend import resolve_device, synchronize
from repro_torch.eval import harness

DEFAULT_OUT = os.path.join("artifacts", "ann_torch", "ann_tiny_yolo.npz")
COMMITTED_FIXTURE = os.path.join("tests", "fixtures", "ann_detector", "ann_tiny_yolo.npz")


def check_out(path: str) -> None:
    """Raise if ``path`` is the committed fixture of any checkout."""
    real = os.path.realpath(path)
    if real == os.path.realpath(COMMITTED_FIXTURE) or real.endswith(os.sep + COMMITTED_FIXTURE):
        raise ValueError(f"refusing to write over the committed fixture {path}: the "
                         "conversion tests are held to that file; pass another --out")


def run(*, steps: int = 4000, batch: int = 6, eval_images: int = 48, out: str = DEFAULT_OUT,
        device=None, verbose: bool = True) -> dict:
    """Train, score and export; returns the losses, the seconds and ms a
    step of the training, the val report and the written file's path and
    size."""
    check_out(out)
    dev = resolve_device(device)
    cfg = dataclasses.replace(harness.demo_config(), mode="ann", weight_bits=0,
                              conv_exec="dense")
    synchronize(dev)
    t0 = time.perf_counter()
    params, bn, _, losses = harness.train_steps(cfg, steps=steps, batch=batch,
                                                verbose=verbose, device=dev)
    synchronize(dev)
    train_s = time.perf_counter() - t0

    det = harness.compile_eval_detector(cfg, params, bn, device=dev)
    rep = harness.evaluate_detector(det, n_images=eval_images)

    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    cv.export_ann_npz(out, params, bn, cfg)
    return {"losses": losses, "train_s": train_s, "ms_per_step": train_s / steps * 1e3,
            "map": rep["map"], "n_images": rep["n_images"], "out": out,
            "bytes": os.path.getsize(out)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=6)
    ap.add_argument("--eval-images", type=int, default=48)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    r = run(steps=args.steps, batch=args.batch, eval_images=args.eval_images, out=args.out,
            device=args.device)
    print(f"trained {args.steps} ANN steps in {r['train_s']:.0f}s "
          f"(final loss {r['losses'][-1]:.3f})")
    print(f"ANN mAP@0.5 = {r['map']:.4f} on {r['n_images']} val images")
    print(f"wrote {r['out']} ({r['bytes']} bytes)")
    return r


if __name__ == "__main__":
    main()
