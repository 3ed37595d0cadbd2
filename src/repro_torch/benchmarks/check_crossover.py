"""Large-input crossover gate: pallas must beat dense at scale.

The port's copy of ``scripts/check_crossover.py``, over the port's
``e2e_detector`` results (``BENCH_torch_e2e.json``, the same keys as
``BENCH_e2e.json``). The fused kernel executor (``pallas``) exists to
carry the detector at large inputs; this gate keeps it from silently
regressing: it fails when the pallas executor's wall-clock exceeds dense's
(beyond ``--tolerance`` headroom for shared-runner noise) in a freshly
regenerated benchmark file, and also re-asserts the bit-exactness contract
(``max_abs_diff_vs_dense`` must be 0.0 for every executor — a
fast-but-wrong kernel is worse than a slow one).

Both walls come from the SAME interleaved median run, so the comparison is
relative and much less noisy than cross-machine absolute thresholds — but
sub-``--min-seconds`` walls are still timer noise and skip the check
rather than flake it.

    PYTHONPATH=src python -m repro_torch.benchmarks.check_crossover \\
        [--file BENCH_torch_e2e.json]

It reads a file and launches nothing, so it takes no ``--device``; gate a
run at the paper's 576x1024 on the card (at small inputs the card is
host-bound and the ratio says little).
"""
from __future__ import annotations

import argparse
import json


def check(data: dict, *, tolerance: float, min_seconds: float) -> tuple[bool, str]:
    """(ok, message) for one BENCH_e2e-style payload."""
    execs = data.get("executors", {})
    for ex, r in execs.items():
        diff = r.get("max_abs_diff_vs_dense")
        if diff is None or diff != 0.0:
            return False, f"{ex}: max_abs_diff_vs_dense={diff!r}, expected 0.0"
    dense = execs.get("dense", {}).get("wall_s")
    pallas = execs.get("pallas", {}).get("wall_s")
    if not dense or not pallas:
        return False, f"missing dense/pallas wall_s (dense={dense}, pallas={pallas})"
    if dense < min_seconds and pallas < min_seconds:
        return True, (f"skipped: walls below timing resolution "
                      f"(dense={dense*1e3:.3f}ms, pallas={pallas*1e3:.3f}ms "
                      f"< {min_seconds*1e3:.0f}ms)")
    ratio = pallas / dense
    msg = (f"dense={dense*1e3:.3f}ms pallas={pallas*1e3:.3f}ms "
           f"(pallas/dense={ratio:.3f}x, tolerance {1 + tolerance:.2f}x)")
    if ratio > 1 + tolerance:
        return False, "pallas slower than dense: " + msg
    return True, "crossover holds: " + msg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--file", default="BENCH_torch_e2e.json",
                    help="freshly regenerated large-input benchmark JSON")
    ap.add_argument("--tolerance", type=float, default=0.05,
                    help="fractional headroom before pallas > dense fails "
                    "(same-run medians still jitter a few %% on shared "
                    "runners)")
    ap.add_argument("--min-seconds", type=float, default=0.001,
                    help="skip the wall comparison when BOTH walls are "
                    "below this (sub-ms medians are timer noise)")
    args = ap.parse_args(argv)

    try:
        with open(args.file) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"crossover gate: cannot read {args.file}: {e}")
        return 1
    ok, msg = check(data, tolerance=args.tolerance,
                    min_seconds=args.min_seconds)
    print(f"crossover gate [{args.file}]: {msg}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
