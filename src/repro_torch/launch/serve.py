"""Serving launcher for the detector: frame streams through the Engine's
continuous batching over a slot pool, with the compile-once detector and
its membranes resident on the device. Counterpart of the snn-det half of
``repro/launch/serve.py`` (its ``--eval-map``, ``--dataset`` and
``--eval-shards`` flags and the LM architectures are not ported yet).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch snn-det \\
      --requests 8 --slots 4 --frames 3 [--conv-exec pallas|gated|dense] \\
      [--max-queue 16 --on-full reject|shed-oldest] [--full-config] \\
      [--checkpoint DIR] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs.snn_det import CONFIG, smoke_config
from repro_torch.eval import harness
from repro_torch.models import snn_yolo as sy
from repro_torch.serve import AdmissionPolicy, Engine, FrameRequest
from repro_torch.serve.detector import demo_weights, step_latency_ms, synth_streams


def _admission(args):
    if args.max_queue is None:
        return None
    return AdmissionPolicy(max_queue=args.max_queue, on_full=args.on_full)


def _report_rejections(eng):
    if eng.rejected:
        print(f"  rejected {len(eng.rejected)} requests at admission "
              f"(rids {[r.rid for r in eng.rejected]})")


def _serve_detector(cfg, args):
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
    det = sy.compile_detector(cfg, params, bn, device=args.device)
    eng = Engine(det, n_slots=args.slots, admission=_admission(args))
    streams = synth_streams(rng, args.requests, args.frames, cfg.input_hw)
    for r, frames in enumerate(streams):
        eng.submit(FrameRequest(rid=r, frames=frames))
    _report_rejections(eng)
    t0 = time.time()
    done = eng.run()
    dt = time.time() - t0
    if len(done) != args.requests - len(eng.rejected):
        raise SystemExit(f"served {len(done)} of {args.requests - len(eng.rejected)} "
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
    return done


def main(argv=None):
    """Parse the command line and serve; returns the finished requests."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=["snn-det"], required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--frames", type=int, default=3, help="frames per stream")
    ap.add_argument("--conv-exec", default=None, choices=["dense", "gated", "pallas"],
                    help="conv executor (default: pallas, the kernel executor; with "
                         "--checkpoint the checkpoint's own)")
    ap.add_argument("--checkpoint", default=None, metavar="DIR",
                    help="restore trained params/BN (and config) from a detector "
                         "checkpoint dir written by the JAX package "
                         "(eval/harness.save_detector_checkpoint) instead of random "
                         "calibrated demo weights")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="admission control: bound the submit queue at this many "
                         "waiting requests (default: unbounded)")
    ap.add_argument("--on-full", default="reject", choices=["reject", "shed-oldest"],
                    help="full-queue policy with --max-queue")
    ap.add_argument("--full-config", action="store_true",
                    help="the paper's 576x1024 config (default: the smoke config)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = CONFIG if args.full_config else smoke_config(CONFIG)
    return _serve_detector(cfg, args)


if __name__ == "__main__":
    main()
