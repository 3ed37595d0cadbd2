"""ANN→SNN conversion: import a pretrained dense detector, calibrate
channel-wise thresholds, emit and save the converted spiking detector, and
score it — NO training steps anywhere (Spiking-YOLO-style channel norm,
arXiv 1903.06530, emitted straight into the compressed executor plan).
Counterpart of ``examples/convert_ann_detector.py``, with its flags and
prints, plus ``--device``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.convert \\
      [--npz tests/fixtures/ann_detector/ann_tiny_yolo.npz] \\
      [--out DIR] [--eval-images 48] [--dataset synthetic] \\
      [--conv-exec pallas] [--full-t 128] [--device cpu]

The default bundle is the repo's committed fixture (an ANN-mode demo
detector); any npz-exported tiny YOLO with matching layer shapes works
(``repro_torch/convert/importer.py`` describes the format). ``--dataset``
calibrates and scores on ``synthetic``, ``coco:<instances.json>`` or
``voc:<dir>``. The emitted checkpoint is self-describing; score or serve
it directly:

  PYTHONPATH=src python -m repro_torch.benchmarks.eval_map --checkpoint DIR
  PYTHONPATH=src python -m repro_torch.launch.serve --arch snn-det \\
      --checkpoint DIR --eval-map

Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

from repro_torch import convert as cv
from repro_torch.backend import resolve_device, synchronize
from repro_torch.data import detection_datasets as dd
from repro_torch.eval import harness

DEFAULT_FIXTURE = os.path.join("tests", "fixtures", "ann_detector", "ann_tiny_yolo.npz")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--npz", default=DEFAULT_FIXTURE,
                    help="ANN detector bundle (repro_torch/convert/importer.py "
                         "format; default: the committed fixture)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "converted_det"),
                    help="checkpoint dir for the converted detector")
    ap.add_argument("--dataset", default="synthetic",
                    help="calibration + eval data: synthetic | "
                         "coco:<instances.json> | voc:<dir>")
    ap.add_argument("--calib-images", type=int, default=32)
    ap.add_argument("--percentile", type=float, default=None,
                    help="λ coverage percentile (default: ConvertConfig)")
    ap.add_argument("--full-t", type=int, default=None,
                    help="time steps of the converted net")
    ap.add_argument("--leak", type=float, default=None,
                    help="LIF leak (1.0 = pure integrate-and-fire)")
    ap.add_argument("--gain", type=float, default=None,
                    help="hidden-layer drive gain")
    ap.add_argument("--encode-duty", type=float, default=None,
                    help="encode duty point τ (spike iff act ≥ τ·λ)")
    ap.add_argument("--conv-exec", default=None,
                    choices=("dense", "gated", "pallas"))
    ap.add_argument("--eval-images", type=int, default=48,
                    help="0 skips the mAP evaluation")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    overrides = {
        k: v for k, v in (
            ("percentile", args.percentile), ("full_t", args.full_t),
            ("leak", args.leak), ("gain", args.gain),
            ("encode_duty", args.encode_duty), ("conv_exec", args.conv_exec),
            ("calib_images", args.calib_images),
        ) if v is not None
    }
    cc = cv.ConvertConfig(**overrides)
    source = dd.parse_dataset_spec(args.dataset)

    print(f"importing {args.npz} ...")
    ann = cv.load_ann_npz(args.npz)
    print(f"  arch {ann.cfg.arch_id}: {len(ann.layers)} conv+BN layers, "
          f"input {ann.cfg.input_hw}")

    t0 = time.time()
    out = cv.convert_ann(ann, source=source, cc=cc, device=dev)
    synchronize(dev)
    ps = out.report["plan_summary"]
    print(f"converted in {time.time() - t0:.1f}s on {dev.type}: full_t={out.cfg.full_t} "
          f"leak={out.cfg.leak} exec={out.cfg.conv_exec}")
    print(f"  head readout scale ρ={out.report['readout_scale']:.3f}, "
          f"empirical fit α={out.report['head_scale_fit']:.3f}")
    print(f"  plan: {ps['dense_bytes']} dense → {ps['compressed_bytes']} "
          f"packed bytes ({ps['compression_ratio']}x)")
    dead = sum(l["dead_channels"] for l in out.report["layers"].values())
    if dead:
        print(f"  {dead} dead channels across "
              f"{len(out.report['layers'])} layers")

    path = out.save(args.out)
    print(f"committed converted checkpoint: {path}")
    print(f"  (conversion report: {path}/{cv.ConvertedDetector.REPORT_FILE})")

    rep = None
    if args.eval_images:
        det = harness.compile_eval_detector(out.cfg, out.params, out.bn_state, device=dev)
        rep = harness.evaluate_detector(
            det, n_images=args.eval_images, source=source
        )
        print(f"converted mAP@0.5 = {rep['map']:.4f} on {rep['n_images']} "
              f"val images (per-class "
              f"{[round(a, 3) for a in rep['per_class_ap']]})")
    print("score it again, or serve it, without retraining:")
    print(f"  PYTHONPATH=src python -m repro_torch.benchmarks.eval_map "
          f"--checkpoint {args.out}")
    print(f"  PYTHONPATH=src python -m repro_torch.launch.serve --arch snn-det "
          f"--checkpoint {args.out} --eval-map")
    return {"converted": out, "checkpoint": path, "report": rep}


if __name__ == "__main__":
    main()
