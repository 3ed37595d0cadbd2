"""Serving launcher: ``--arch`` picks the architecture, and the Engine's
continuous batching over a fixed slot pool serves both workloads. The
counterpart of ``repro/launch/serve.py``.

* LM token requests (``--arch`` an LM config of the dense, moe, ssm or
  hybrid family): the port's seeded weights
  (``zoo.get_api(cfg).init_params(0)``, a ``torch.Generator`` — not the JAX
  package's ``PRNGKey(0)`` weights), ``--requests`` prompts of 3–31 tokens
  from ``np.random.default_rng(0)`` as in JAX, greedy decoding of
  ``--max-new`` tokens each over ``--slots`` slots of ``--max-seq`` cache
  rows; prints the tokens/s line. The smoke config unless
  ``--full-config``. The vlm and audio families (llava-next-34b,
  whisper-small) are refused with a ValueError (ROADMAP.md R10): a request
  carries no patches or frames; they serve through ``zoo.get_api``.
* snn-det frame streams: the compile-once detector with its membranes
  resident on the device (``--dataset`` takes ``synthetic``,
  ``coco:<instances.json>`` or ``voc:<dir>``). ``--eval-map`` serves the
  val split, one frame per request, and scores the served detections
  (mAP@0.5; ``--eval-shards K`` scores them through the sharded reduction,
  bit-identical to one shard). With
  ``--checkpoint`` the detector is built with the evaluation postprocess
  settings and the score must equal ``harness.evaluate_detector`` on the
  same weights bit for bit: the run prints the parity line and exits
  non-zero on a mismatch. A finite dataset with fewer val images than
  ``--requests`` serves all of them.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b|rwkv6-3b \\
      [--requests 8 --slots 4 --max-new 16 --max-seq 128] [--full-config] \\
      [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch snn-det \\
      --requests 8 --slots 4 --frames 3 [--conv-exec pallas|gated|dense] \\
      [--max-queue 16 --on-full reject|shed-oldest] [--full-config] \\
      [--checkpoint DIR] [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch snn-det --eval-map \\
      --checkpoint DIR [--requests 8] [--dataset coco:<instances.json>|voc:<dir>] \\
      [--eval-shards 2] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch import backend
from repro_torch.configs import ALL_IDS, get_config, smoke_config
from repro_torch.data import detection_datasets as dd
from repro_torch.distributed import runtime
from repro_torch.eval import detection_map as dm
from repro_torch.eval import harness
from repro_torch.eval import sharded as se
from repro_torch.models import snn_yolo as sy
from repro_torch.models import zoo
from repro_torch.serve import AdmissionPolicy, Engine, FrameRequest, Request
from repro_torch.serve.engine import check_servable
from repro_torch.serve.detector import demo_weights, step_latency_ms, synth_streams


def _admission(args):
    if args.max_queue is None:
        return None
    return AdmissionPolicy(max_queue=args.max_queue, on_full=args.on_full)


def _report_rejections(eng):
    if eng.rejected:
        print(f"  rejected {len(eng.rejected)} requests at admission "
              f"(rids {[r.rid for r in eng.rejected]})")


def _serve_lm(cfg, args):
    check_servable(cfg)  # before the weights are drawn
    api = zoo.get_api(cfg)
    params = api.init_params(0, device=args.device)
    eng = Engine(cfg, params, n_slots=args.slots, max_seq=args.max_seq,
                 admission=_admission(args))
    rng = np.random.default_rng(0)
    for r in range(args.requests):
        plen = int(rng.integers(3, 32))
        eng.submit(Request(rid=r, prompt=list(rng.integers(1, cfg.vocab_size, plen)),
                           max_new_tokens=args.max_new))
    _report_rejections(eng)
    t0 = time.time()
    done = eng.run()
    backend.synchronize(eng.core.device)
    dt = time.time() - t0
    if len(done) != args.requests - len(eng.rejected):
        raise SystemExit(f"served {len(done)} of {args.requests - len(eng.rejected)} "
                         f"admitted requests ({done.status})")
    total = args.max_new * len(done)
    print(f"{args.arch}: served {len(done)} requests "
          f"({total} new tokens) in {dt:.1f}s — {total/dt:.1f} tok/s")
    for r in sorted(done, key=lambda r: r.rid)[:3]:
        print(f"  req {r.rid}: {r.out}")
    return done


def _serve_detector(cfg, args):
    source = dd.parse_dataset_spec(args.dataset)
    if args.checkpoint:
        # trained weights: the checkpoint's config sidecar replaces the
        # command line's config; --conv-exec still picks the executor
        cfg, params, bn, step = harness.restore_detector_checkpoint(
            args.checkpoint, device=args.device)
        if args.conv_exec:
            cfg = dataclasses.replace(cfg, conv_exec=args.conv_exec)
        rng = np.random.default_rng(0)
        print(f"restored checkpoint step {step} from {args.checkpoint} "
              f"({cfg.arch_id}, input {cfg.input_hw}, "
              f"conv_exec {cfg.conv_exec}, weight_bits {cfg.weight_bits})")
    else:
        cfg = dataclasses.replace(cfg, conv_exec=args.conv_exec or "pallas")
        params, bn, rng = demo_weights(cfg, device=args.device)
    if args.eval_map and args.checkpoint:
        # real weights: evaluation postprocess settings (low threshold, deep
        # budget), so the served score is the harness's, checked below
        det = harness.compile_eval_detector(cfg, params, bn, device=args.device)
    else:
        det = sy.compile_detector(cfg, params, bn, device=args.device)
    eng = Engine(det, n_slots=args.slots, admission=_admission(args))
    gts = None
    n_requests = args.requests
    if args.eval_map:
        # the val split, one frame per request (each admission cold-starts
        # its slot); the served detections are what gets scored
        cap = source.num_eval_images("val")
        if cap is not None and cap < n_requests:
            print(f"  ({args.dataset} has {cap} val images; serving all of them)")
            n_requests = cap
        images, gts = source.eval_set(
            n_requests, hw=cfg.input_hw, grid_div=harness.grid_div(cfg),
            num_anchors=cfg.num_anchors, num_classes=cfg.num_classes,
        )
        streams = [img[None] for img in images]
    else:
        streams = synth_streams(rng, n_requests, args.frames, cfg.input_hw)
    for r, frames in enumerate(streams):
        eng.submit(FrameRequest(rid=r, frames=frames))
    _report_rejections(eng)
    t0 = time.time()
    with sy._no_tf32():  # the harness evaluates in full f32; so does this run
        done = eng.run()
    dt = time.time() - t0
    if len(done) != n_requests - len(eng.rejected):
        raise SystemExit(f"served {len(done)} of {n_requests - len(eng.rejected)} "
                         f"admitted streams ({done.status})")
    total_frames = sum(len(r.out) for r in done)
    lat = step_latency_ms(eng.core.step_wall)
    print(f"{args.arch}[{cfg.conv_exec}]: served {len(done)} streams "
          f"({total_frames} frames) in {dt:.1f}s — {total_frames/dt:.1f} frames/s, "
          f"step p50 {lat['step_p50_ms']:.1f}ms p95 {lat['step_p95_ms']:.1f}ms "
          f"p99 {lat['step_p99_ms']:.1f}ms")
    for r in sorted(done, key=lambda r: r.rid)[:3]:
        counts = [int(d.valid.sum()) for d in r.out]
        print(f"  req {r.rid}: {len(r.out)} frames, detections/frame {counts}")
    if gts is not None:
        _score_served(det, done, gts, source, eng, args)
    return done


def _score_served(det, done, gts, source, eng, args):
    """mAP@0.5 of the served detections; with ``--checkpoint``, the gate
    against ``harness.evaluate_detector`` on the same weights."""
    if eng.rejected:
        raise SystemExit("--eval-map scores every val image; don't bound --max-queue "
                         "below --requests")
    preds = [r.out[0] for r in sorted(done, key=lambda r: r.rid)]
    if args.eval_shards > 1:
        # the sharded reduction (striped match stats, gathered and
        # re-sorted): bit-identical to the sweep below for any shard count;
        # the context routes shard ownership under a multi-process launch
        rep = se.evaluate_predictions_sharded(
            preds, gts, num_classes=det.cfg.num_classes, iou_threshold=0.5,
            eval_cfg=se.ShardedEvalConfig(n_shards=args.eval_shards),
            ctx=runtime.get_context())
        shard_note = f" ({rep['n_shards']} shards, {rep['gather']} gather)"
    else:
        rep = dm.evaluate_detections(preds, gts, num_classes=det.cfg.num_classes,
                                     iou_threshold=0.5)
        shard_note = ""
    weights_note = (
        "restored trained weights" if args.checkpoint else
        f"at the serving score threshold ({det.score_threshold}) — demo weights are "
        "random-calibrated; pass --checkpoint <dir> for representative accuracy"
    )
    print(f"  served-detections mAP@0.5 {rep['map']:.3f} over {rep['n_images']} val "
          f"frames ({args.dataset}){shard_note} — {weights_note}")
    if args.checkpoint:
        # the end-to-end contract: detections that went through admission
        # and slot batching score exactly as the harness scores the same
        # weights on the same split (a row is independent of its batch)
        ref = harness.evaluate_detector(det, n_images=len(preds), source=source)
        identical = se.reports_identical(rep, ref)
        print(f"  harness parity: served {rep['map']!r} vs harness {ref['map']!r} — "
              f"{'BIT-IDENTICAL' if identical else 'MISMATCH'}")
        if not identical:
            raise SystemExit("served-detections mAP does not match "
                             "harness.evaluate_detector on the restored weights")


def main(argv=None):
    """Parse the command line and serve; returns the finished requests."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=list(ALL_IDS), required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16,
                    help="new tokens per LM request (greedy)")
    ap.add_argument("--max-seq", type=int, default=128,
                    help="KV cache rows per slot (LM)")
    ap.add_argument("--frames", type=int, default=3, help="frames per stream (snn-det)")
    ap.add_argument("--conv-exec", default=None, choices=["dense", "gated", "pallas"],
                    help="conv executor (default: pallas, the kernel executor; with "
                         "--checkpoint the checkpoint's own)")
    ap.add_argument("--checkpoint", default=None, metavar="DIR",
                    help="restore trained params/BN (and config) from a detector "
                         "checkpoint dir written by either package "
                         "(eval/harness.save_detector_checkpoint, run_pipeline's "
                         "ckpt_dir, benchmarks.eval_map --ckpt-dir) instead of "
                         "random calibrated demo weights")
    ap.add_argument("--dataset", default="synthetic",
                    help="--eval-map split: synthetic | coco:<instances.json> | voc:<dir>")
    ap.add_argument("--eval-map", action="store_true",
                    help="serve the val split and report mAP@0.5 of the served "
                         "detections; with --checkpoint the score uses evaluation "
                         "postprocess settings and must equal "
                         "harness.evaluate_detector bit for bit")
    ap.add_argument("--eval-shards", type=int, default=1,
                    help="shard count of the --eval-map reduction (sharded mAP, "
                         "bit-identical to 1 shard)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="admission control: bound the submit queue at this many "
                         "waiting requests (default: unbounded)")
    ap.add_argument("--on-full", default="reject", choices=["reject", "shed-oldest"],
                    help="full-queue policy with --max-queue")
    ap.add_argument("--full-config", action="store_true",
                    help="the published config (snn-det: the paper's 576x1024; an LM: "
                         "its full width, weights drawn by the port's own seeded init, "
                         "not the JAX package's PRNGKey(0) weights); default: the "
                         "smoke config")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = smoke_config(cfg)
    if args.arch == "snn-det":
        return _serve_detector(cfg, args)
    return _serve_lm(cfg, args)


if __name__ == "__main__":
    main()
