"""Roofline table: the dry-run artifacts collated per (arch × shape) cell —
three terms in seconds a step, the dominant one, the useful-FLOPs ratio,
and one lever per cell.

Counterpart of ``benchmarks/roofline.py``. Reads
``artifacts/dryrun_torch/*.json`` (``python -m repro_torch.launch.dryrun
--all``); the terms are on the NVIDIA H100 SXM's data-sheet peaks (989
TFLOP/s dense bf16, 3.35 TB/s HBM, 450 GB/s NVLink each way, 700 W) and
counted on ``meta`` tensors, so no card is needed to print it.

    python -m repro_torch.benchmarks.roofline [--mesh h100] [--dir DIR]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch.dryrun import OUT_DIR

LEVERS = {
    ("train", "compute_s"): "raise arithmetic intensity: fuse, cut remat recompute",
    ("train", "memory_s"): "fuse the eager elementwise passes (attention scores, norms, "
                           "casts) into the matmuls' epilogues; bf16 stashes",
    ("train", "collective_s"): "overlap the data-parallel all-reduce with the backward; "
                               "int8 gradient compression; hierarchical psum",
    ("prefill", "compute_s"): "at the compute roofline: larger attention chunks for the "
                              "tensor cores",
    ("prefill", "memory_s"): "a fused attention kernel (the online softmax in one pass); "
                             "keep KV bf16; avoid reshape copies",
    ("prefill", "collective_s"): "shard the sequence (ring attention) instead of gathering "
                                 "KV; all-to-all MoE dispatch",
    ("decode", "compute_s"): "decode is never compute-bound at batch <= 128: check the count",
    ("decode", "memory_s"): "the KV cache read dominates: shard KV over more cards, "
                            "quantize KV, GQA",
    ("decode", "collective_s"): "split-K combine traffic: larger decode steps per launch, "
                                "KV-local layout",
}


def load(out_dir: str = OUT_DIR, mesh: str = "h100") -> list:
    rows = []
    for f in sorted(glob.glob(os.path.join(out_dir, f"*__{mesh}.json"))):
        with open(f) as fh:
            rows.append(json.load(fh))
    return rows


def kind_of(shape: str) -> str:
    return {"train_4k": "train", "prefill_32k": "prefill",
            "decode_32k": "decode", "long_500k": "decode"}[shape]


def run(out_dir: str = OUT_DIR, mesh: str = "h100") -> dict:
    rows = load(out_dir, mesh)
    if not rows:
        print(f"no dry-run artifacts under {out_dir} for mesh {mesh} (run python -m "
              "repro_torch.launch.dryrun --all first): skipped")
        return {}
    print(f"Roofline — mesh {mesh}, per-card terms (s/step), H100 SXM data-sheet peaks")
    hdr = (f"{'arch':18s} {'shape':12s} {'compute':>9s} {'memory':>9s} {'collect':>9s} "
           f"{'dominant':>12s} {'useful':>7s} {'static GB':>9s}")
    print(hdr)
    print("-" * len(hdr))
    table = {}
    for r in rows:
        if r.get("status") == "skipped":
            print(f"{r['arch']:18s} {r['shape']:12s} {'—':>9s} {'—':>9s} {'—':>9s} "
                  f"{'skipped':>12s}")
            continue
        t = r["roofline"]
        table[(r["arch"], r["shape"])] = t
        gb = r["static_bytes_per_device"]["total"] / 1e9
        print(f"{r['arch']:18s} {r['shape']:12s} {t['compute_s']:9.2e} {t['memory_s']:9.2e} "
              f"{t['collective_s']:9.2e} {t['dominant'][:-2]:>12s} "
              f"{t['useful_flops_ratio']:7.3f} {gb:9.2f}{'' if r['fits'] else ' !fit'}")
    print("\nper-cell roofline fraction + dominant-term lever:")
    for (arch, shape), t in sorted(table.items(), key=lambda kv: -kv[1]["bound_s"]):
        lever = LEVERS.get((kind_of(shape), t["dominant"]), "")
        frac = t["compute_s"] / max(t["bound_s"], 1e-30)
        print(f"  {arch} x {shape}: {frac:5.1%} — {lever}")
    return {f"{a}__{s}": t for (a, s), t in table.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="h100")
    ap.add_argument("--dir", default=OUT_DIR)
    args = ap.parse_args(argv)
    return run(args.dir, args.mesh)


if __name__ == "__main__":
    main()
