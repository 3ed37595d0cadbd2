"""Benchmark runner: one module per paper table/figure, the kernel and
serving benchmarks, and the accuracy pipeline.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--fast] [--json PATH]
        [--device cpu]

Counterpart of ``benchmarks/run.py``: the same suites in the same order,
each on ``--device`` (default: the card). ``--fast`` skips Table II's
training cells and runs ``eval_map`` at smoke scale (its mAP is then not
representative). The JAX suite's ``roofline`` collation is not here: it
and ``benchmarks/detector_dryrun.py`` read TPU dry-run HLO artifacts, and
their torch analogue waits for ROADMAP queue 1 item 9. A suite that raises
is reported and the run goes on; the runner then prints ``FAILED suites:
[...]`` and exits 1.
"""
from __future__ import annotations

import argparse
import json
import sys
import traceback


def suites(fast: bool, device) -> list:
    """(name, thunk) per suite, in the order of the JAX package's runner."""
    from repro_torch.benchmarks import (
        e2e_detector,
        eval_map,
        fig3_density,
        fig5_miout,
        fig6_parallelism,
        fig15_mixed_t,
        fig17_dram,
        kernel_bench,
        serve_bench,
        table1_ablation,
        table2_models,
        table3_hw,
    )

    return [
        ("table1_ablation", lambda: table1_ablation.run(device)),
        ("table2_models", lambda: table2_models.run(train_steps=0 if fast else 5,
                                                    device=device)),
        ("fig3_density", lambda: fig3_density.run(device=device)),
        ("fig5_miout", lambda: fig5_miout.run(device)),
        ("fig6_parallelism", lambda: fig6_parallelism.run()),
        ("fig15_mixed_t", lambda: fig15_mixed_t.run()),
        ("fig17_dram", lambda: fig17_dram.run()),
        ("table3_hw", lambda: table3_hw.run()),
        ("kernel_bench", lambda: kernel_bench.run(device)),
        ("e2e_detector", lambda: e2e_detector.run(device=device)),
        ("eval_map", lambda: eval_map.run(
            steps=60 if fast else 3500,
            finetune_steps=20 if fast else 600,
            batch=4 if fast else 6,
            eval_images=8 if fast else 48,
            device=device,
        )),
        ("serve_bench", lambda: serve_bench.run(device=device)),
    ]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true",
                    help="skip the training cells; smoke-scale eval_map")
    ap.add_argument("--json", default=None, help="dump all results to a JSON file")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    todo = suites(args.fast, args.device)
    results, failed = {}, []
    for name, fn in todo:
        print(f"\n{'=' * 70}\n{name}\n{'=' * 70}", flush=True)
        try:
            results[name] = fn()
        except Exception:  # a failing suite is reported, and the others still run
            traceback.print_exc()
            failed.append(name)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1, default=str)
    print(f"\n{'=' * 70}")
    if failed:
        print(f"FAILED suites: {failed}")
        sys.exit(1)
    print(f"all {len(todo)} benchmark suites completed")
    return results


if __name__ == "__main__":
    main()
