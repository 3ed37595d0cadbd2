"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on the card.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` on the machine it is started on: sets
up the cell's system from the seed, serves the cell's traffic for
``--seconds`` seconds, compares a sample of what was served with the plain
reference, and prints one JSON object as the last line of standard output
(the end-to-end metrics with ``--trace 0``, the per-layer ones with
``--trace 1``); the numbers compared, each beside its limit, are the last
lines of standard error. Exits non-zero without a result when there is no
CUDA device, when the program cannot be imported, or when JAX or the JAX
package has been loaded.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench import harness

    spec = harness.load_spec(ROOT)
    cell = {w["name"]: w for w in spec["workloads"]}.get(args.workload)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, lines = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                     device="cuda", t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {found}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
