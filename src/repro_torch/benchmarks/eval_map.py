"""Accuracy benchmark: the scaled-down Table I / Fig 15 reproduction on the
port.

Counterpart of ``benchmarks/eval_map.py``. Drives
``repro_torch.eval.harness.run_pipeline`` — train float → prune 80% → QAT
fine-tune → evaluate — and writes ``BENCH_torch_eval.json`` with mAP@0.5
per stage, the mixed (1,3) vs uniform T=3 schedule comparison, and the
worst-case accumulator magnitude against the 16-bit claim. The JAX
package's checked-in ``BENCH_eval.json`` is never written here.

The defaults are the demonstration scale (3500 + 600 steps at batch 6, 48
eval images, ``demo_config``, the dense executor); ``--fast`` runs a
smoke version (60 + 20 steps at batch 4, 8 images) whose mAP is not
representative. Training and evaluation run on ``--device`` (default:
the card; ``cpu`` runs the plain PyTorch path).

``--ckpt-dir`` commits detector checkpoints after the train and QAT
stages for ``repro_torch.launch.serve --checkpoint`` to restore;
``--checkpoint <dir>`` skips training and scores a saved detector
(``BENCH_torch_eval_ckpt.json``) — a converted detector
(``repro_torch.launch.convert``) too. ``--dataset`` takes ``synthetic``,
``coco:<instances.json>`` or ``voc:<dir>`` (letterboxed annotated frames).
``--shards K`` routes every evaluation through the sharded path
(``repro_torch.eval.sharded``) and then re-scores the final weights in one
process, failing the run unless the two reports are bit-identical (the
JAX package's parity gate); it composes with ``--checkpoint``.

  PYTHONPATH=src python -m repro_torch.benchmarks.eval_map [--fast]
      [--ckpt-dir DIR] [--out-json PATH] [--device cpu]
  PYTHONPATH=src python -m repro_torch.benchmarks.eval_map --checkpoint DIR
      [--dataset coco:<instances.json>|voc:<dir>] [--shards 2]
"""
from __future__ import annotations

import argparse
import json

from repro_torch.data import detection_datasets as dd
from repro_torch.distributed import runtime
from repro_torch.eval import harness
from repro_torch.eval.sharded import reports_identical

OUT_JSON = "BENCH_torch_eval.json"
OUT_JSON_CKPT = "BENCH_torch_eval_ckpt.json"


def run_checkpoint(ckpt: str, *, eval_images: int = 48, shards: int = 1,
                   dataset: str = "synthetic", out_json: str = OUT_JSON_CKPT,
                   device=None) -> dict:
    """Score a saved detector checkpoint — no training anywhere."""
    source = dd.parse_dataset_spec(dataset)
    cfg, params, bn, step = harness.restore_detector_checkpoint(ckpt, device=device)
    det = harness.compile_eval_detector(cfg, params, bn, device=device)
    rep = harness.evaluate_detector(det, n_images=eval_images, source=source,
                                    sharded=shards if shards > 1 else None,
                                    ctx=runtime.get_context())
    print(f"  checkpoint {ckpt} (step {step}, arch {cfg.arch_id}): "
          f"mAP@0.5 {rep['map']:.4f} on {rep['n_images']} images")
    results = {
        "config": {
            "checkpoint": ckpt, "step": step, "arch_id": cfg.arch_id,
            "eval_images": eval_images, "eval_shards": shards, "dataset": dataset,
        },
        "map": rep["map"],
        "per_class_ap": rep["per_class_ap"],
        "n_gt": rep["n_gt"],
        "n_images": rep["n_images"],
    }
    if shards > 1:
        results["sharded_parity"] = _parity_gate(
            rep, harness.evaluate_detector(det, n_images=eval_images, source=source), shards)
    if out_json:
        with open(out_json, "w") as f:
            json.dump(results, f, indent=1)
        print(f"  wrote {out_json}")
    return results


def _parity_gate(sharded_rep: dict, single_rep: dict, shards: int) -> dict:
    """The acceptance gate of ``--shards``: the sharded report must be
    bit-identical to a single-process score of the same weights; raises
    SystemExit otherwise."""
    identical = reports_identical(sharded_rep, single_rep)
    print(f"  sharded parity [{shards} shards, {sharded_rep.get('gather')} gather]: "
          f"mAP {sharded_rep['map']:.6f} vs single-process {single_rep['map']:.6f} — "
          f"{'BIT-IDENTICAL' if identical else 'MISMATCH'}")
    if not identical:
        raise SystemExit(f"sharded ({shards}-way) mAP is not bit-identical to the "
                         f"single-process evaluation: {sharded_rep['map']!r} vs "
                         f"{single_rep['map']!r}")
    return {"n_shards": shards, "gather": sharded_rep.get("gather"),
            "map_sharded": sharded_rep["map"], "map_single_host": single_rep["map"],
            "bit_identical": identical}


def run(*, steps: int = 3500, finetune_steps: int = 600, batch: int = 6,
        eval_images: int = 48, shards: int = 1, dataset: str = "synthetic",
        ckpt_dir: str = None, out_json: str = OUT_JSON, device=None) -> dict:
    source = dd.parse_dataset_spec(dataset)
    report = harness.run_pipeline(
        steps=steps, finetune_steps=finetune_steps, batch=batch,
        eval_images=eval_images, eval_shards=shards, source=source, ckpt_dir=ckpt_dir,
        verbose=True, device=device, ctx=runtime.get_context(),
    )
    s = report.summary()
    results = {
        "config": {
            "steps": steps, "finetune_steps": finetune_steps, "batch": batch,
            "eval_images": eval_images, "eval_shards": shards,
            "dataset": dataset, "ckpt_dir": ckpt_dir,
        },
        **s,
        "stages": {
            k: {kk: v[kk] for kk in ("map", "per_class_ap", "n_gt", "n_images")}
            for k, v in report.stages.items()
        },
        "final_loss": {k: v[-1] for k, v in report.losses.items() if v},
    }
    if shards > 1:
        # the sharded stage numbers above against a single-process re-score
        # of the same final weights
        results["sharded_parity"] = _parity_gate(
            report.stages["qat"],
            harness.evaluate_detector(report.final_det, n_images=eval_images, source=source),
            shards)
    if out_json:
        with open(out_json, "w") as f:
            json.dump(results, f, indent=1)
        print(f"  wrote {out_json}")
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true",
                    help="smoke-scale (mAP not representative)")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--shards", type=int, default=1,
                    help="evaluation shard count (sharded mAP; asserts bit-identical "
                         "parity with the single-process evaluation)")
    ap.add_argument("--dataset", default="synthetic",
                    help="train/eval data: synthetic | coco:<instances.json> | voc:<dir>")
    ap.add_argument("--ckpt-dir", default=None,
                    help="commit detector checkpoints (post-train and post-QAT) "
                         "here; repro_torch.launch.serve --checkpoint restores them")
    ap.add_argument("--checkpoint", default=None,
                    help="score this saved detector checkpoint directly (no training)")
    ap.add_argument("--out-json", default=OUT_JSON,
                    help=f"result file (default {OUT_JSON}, or {OUT_JSON_CKPT} "
                         "with --checkpoint; '' skips writing)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.checkpoint:
        out = args.out_json if args.out_json != OUT_JSON else OUT_JSON_CKPT
        return run_checkpoint(args.checkpoint, shards=args.shards, dataset=args.dataset,
                              eval_images=8 if args.fast else 48, out_json=out,
                              device=args.device)
    kw = dict(shards=args.shards, dataset=args.dataset, ckpt_dir=args.ckpt_dir,
              out_json=args.out_json, device=args.device)
    if args.fast:
        return run(steps=args.steps or 60, finetune_steps=20, batch=4, eval_images=8, **kw)
    return run(steps=args.steps or 3500, **kw)


if __name__ == "__main__":
    main()
