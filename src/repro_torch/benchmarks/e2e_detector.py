"""End-to-end detector benchmark across conv executors on the port (the
executor pipeline's acceptance harness).

Counterpart of ``benchmarks/e2e_detector.py``. Runs the full ``snn_yolo``
forward — encode, conv block, all five CSP stages, head, at the (1,
full_t) mixed time-step schedule — once per executor (``dense`` oracle,
``gated`` live-tap im2col, ``pallas`` the fused CUDA kernel), asserts
parity against the dense oracle (bit-exact: every executor accumulates in
the integer domain and scales once), and reports per-executor wall time,
accumulate counts (the paper's −47.3% op story), kernel launches per frame
and compressed weight bytes (the −59.1% Fig 17 story), under the JSON keys
of ``BENCH_e2e.json``.

The default config is the reduced-resolution replica of the paper topology
(every layer, tiny spatial extent); ``run(cfg)`` takes any config, the
paper's full-width ``CONFIG`` among them (``chip_smoke.py`` runs it).

  PYTHONPATH=src python -m repro_torch.benchmarks.e2e_detector --device cpu
  PYTHONPATH=src python -m repro_torch.benchmarks.e2e_detector --input-hw 96x128

Weights are seeded (``torch.Generator``, seed 0), images from numpy
``default_rng(0)``; the JAX package's ``jax.random`` weights differ, so
the two benchmarks agree on parity and accounting, not on detections.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import backend
from repro_torch.configs.snn_det import CONFIG, smoke_config
from repro_torch.core import pruning
from repro_torch.models import snn_yolo as sy

PARITY_ATOL = 0.0
EXECUTORS = ("dense", "gated", "pallas")
# wall_s is the MEDIAN of this many timed calls, interleaved round-robin
# across executors so drift lands on every executor equally
N_TIMING_RUNS = 200


def reduced_config(input_hw: tuple[int, int] | None = None) -> sy.SNNDetConfig:
    """Paper topology (all macro layers, 5 CSP stages, mixed (1,3) time
    steps) at the smoke config's spatial scale (24×32, block 6×8).

    ``input_hw`` overrides the spatial extent (e.g. ``(96, 128)``); the 6×8
    block grid divides any multiple of the default 24×32, so the blocked
    executors stay valid unchanged. The paper's full width is ``CONFIG``
    itself (``run(dataclasses.replace(CONFIG, ...))``)."""
    cfg = dataclasses.replace(smoke_config(CONFIG), arch_id="snn-det-e2e", use_block_conv=True)
    if input_hw is not None:
        h, w = input_hw
        bh, bw = cfg.block_hw
        if h % cfg.input_hw[0] or w % cfg.input_hw[1]:
            raise ValueError(
                f"--input-hw {h}x{w} must be a multiple of the reduced base "
                f"{cfg.input_hw[0]}x{cfg.input_hw[1]} so the {bh}x{bw} block "
                "grid keeps dividing every stage's feature map")
        cfg = dataclasses.replace(cfg, input_hw=(h, w))
    return cfg


def _accumulates(cfg, plan, *, sparse: bool) -> int:
    """Accumulate ops per frame under the gated dataflow: nnz × spatial ×
    input time steps × bit-serial planes (dense executors visit every
    weight instead)."""
    total = 0
    for spec in sy.layer_specs(cfg, pruned_density=1.0):
        nnz = plan.layers[spec.name].nnz if sparse else spec.params
        total += nnz * spec.h * spec.w * spec.t_in * spec.bits_in
    return total


def run(cfg: sy.SNNDetConfig | None = None, *, prune_rate: float = 0.8, batch: int = 1,
        out_json: str | None = None, device=None, reps: int = N_TIMING_RUNS,
        params=None) -> dict:
    """Every executor on the same pruned weights and images; raises if any
    head differs from the dense one. ``params``: (already pruned) weights
    to use instead of the seeded ones (``prune_rate`` is then only
    recorded). Writes the JSON to ``out_json`` when given."""
    dev = backend.resolve_device(device)
    cfg = cfg or reduced_config()
    if params is None:
        params, _ = sy.init_params(cfg, seed=0, device=dev)
        # prune ONCE and hand the identical tree to every executor: parity
        # is then purely about the conv dataflow
        params = pruning.prune_tree(params, prune_rate)
    rng = np.random.default_rng(0)
    h, w = cfg.input_hw
    # uint8-grid images: the 8-bit bit-serial encode path is then exact
    imgs = torch.from_numpy((rng.integers(0, 256, (batch, h, w, 3)) / 255.0).astype(
        np.float32)).to(dev)
    # calibrated tdBN stats: fresh (0, 1) stats silence the deep layers of
    # an untrained net, and the parity sweep would be vacuous past them
    bn = sy.calibrate_bn_state(params, sy.default_bn_state(params), imgs, cfg)

    results: dict = {
        "config": {
            "input_hw": list(cfg.input_hw),
            "block_hw": list(cfg.block_hw),
            "full_t": cfg.full_t,
            "prune_rate": prune_rate,
            "batch": batch,
        },
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "executors": {},
    }
    heads, outs, launches, detectors = {}, {}, {}, {}
    for ex in EXECUTORS:
        det = sy.compile_detector(dataclasses.replace(cfg, conv_exec=ex), params, bn,
                                  device=dev)
        detectors[ex] = det
        det.detect(imgs)  # warm up
        backend.synchronize(dev)
        before = dict(backend.launches)
        outs[ex], heads[ex] = det.detect(imgs)
        backend.synchronize(dev)
        launches[ex] = {k: n - before.get(k, 0) for k, n in backend.launches.items()
                        if n > before.get(k, 0)}
    walls: dict = {ex: [] for ex in EXECUTORS}
    for _ in range(reps):
        for ex, det in detectors.items():
            t0 = time.perf_counter()
            det.detect(imgs)
            backend.synchronize(dev)
            walls[ex].append(time.perf_counter() - t0)
    for ex in EXECUTORS:
        diff = float((heads[ex] - heads["dense"]).abs().max())
        results["executors"][ex] = {
            "wall_s": float(np.median(walls[ex])) if reps else None,
            "max_abs_diff_vs_dense": diff,
            "accumulates": _accumulates(cfg, detectors[ex].plan, sparse=ex != "dense"),
            "detections": [int(c) for c in outs[ex].count.cpu()],
            "launches_per_frame": launches[ex],
        }
        row = results["executors"][ex]
        wall = "not timed" if row["wall_s"] is None else f"{row['wall_s'] * 1e3:9.3f} ms"
        print(f"  {ex:7s}  wall {wall}  max|Δ| vs dense {diff:.2e}  "
              f"accumulates {row['accumulates']:,}  launches {launches[ex]}")
        if not diff <= PARITY_ATOL:
            raise AssertionError(f"{ex} diverges from dense oracle: {diff}")

    plan = detectors["pallas"].plan
    dense_b, comp_b = plan.dense_bytes, plan.compressed_bytes
    results["weight_bytes"] = {
        "dense": dense_b,
        "compressed": comp_b,
        "saving_frac": 1.0 - comp_b / max(dense_b, 1),
    }
    acc_d = results["executors"]["dense"]["accumulates"]
    acc_s = results["executors"]["pallas"]["accumulates"]
    results["accumulate_saving_frac"] = 1.0 - acc_s / max(acc_d, 1)
    print(f"  weight traffic: {comp_b}/{dense_b} B "
          f"(−{100 * results['weight_bytes']['saving_frac']:.1f}%)  "
          f"accumulates −{100 * results['accumulate_saving_frac']:.1f}%  on {results['device']}")
    if out_json:
        with open(out_json, "w") as f:
            json.dump(results, f, indent=1)
        print(f"  wrote {out_json}")
    return results


def _parse_hw(text: str) -> tuple[int, int]:
    parts = text.replace(",", "x").lower().split("x")
    if len(parts) != 2:
        raise argparse.ArgumentTypeError(f"expected HxW, got {text!r}")
    return int(parts[0]), int(parts[1])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--input-hw", type=_parse_hw, default=None, metavar="HxW",
                    help="input resolution override, e.g. 96x128 "
                    "(default: the reduced 24x32 config)")
    ap.add_argument("--prune-rate", type=float, default=0.8)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--reps", type=int, default=N_TIMING_RUNS,
                    help="timed calls per executor (wall_s is their median)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=None,
                    help="output JSON path (default BENCH_torch_e2e.json, or "
                    "BENCH_torch_e2e_<HxW>.json when --input-hw is given)")
    args = ap.parse_args(argv)
    out = args.out
    if out is None:
        out = ("BENCH_torch_e2e.json" if args.input_hw is None else
               "BENCH_torch_e2e_{}x{}.json".format(*args.input_hw))
    return run(reduced_config(args.input_hw), prune_rate=args.prune_rate, batch=args.batch,
               out_json=out, device=args.device, reps=args.reps)


if __name__ == "__main__":
    main()
