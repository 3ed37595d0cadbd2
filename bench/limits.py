"""Readings that a comparison limit is set from: the program's numbers on
many seeds and the control's on the same requests.

    python3 bench/limits.py --workload <cell> --seeds 1,2,3 --seconds 3 \
        [--control-seeds 3] [--out limits.jsonl]

For each seed, one run of the cell (a short window at the cell's own
load), then the comparison's numbers for the program and, on the first
``--control-seeds`` seeds, for the control: the reference at the next
precision down (int4 weights, bfloat16 arithmetic and postprocess) in the
program's place, on the same sampled requests. One JSON line per seed.
The benchmark's own runs do not run this.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:] = [ROOT, os.path.join(ROOT, "src")] + [
    p for p in sys.path if os.path.abspath(p or ".") != os.path.join(ROOT, "bench")]


def control(system, ref, config, sampled, dev, traffic):
    import torch

    from bench import check

    ctrl = system.reference(bits=4, fdtype=torch.bfloat16)
    outs = check.control_outputs(ctrl, config, sampled, dev, batch=traffic.reference_batch)
    return check.compare(ref, config, outs, dev, batch=traffic.reference_batch)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from bench import harness

    seeds = [int(s) for s in args.seeds.split(",")]
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        result, lines = harness.run_cell(
            args.workload, seed, args.seconds, False,
            after=control if i < args.control_seeds else None)
        row = {"workload": args.workload, "seed": seed, "correct": result["correct"],
               "program": {k: c["value"] for k, c in result["checks"].items()},
               "control": result.get("after"), "frames": result["attempted"],
               "run_s": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
