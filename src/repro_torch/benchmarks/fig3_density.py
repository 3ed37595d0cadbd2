"""Fig 3 — per-layer density of the pruned weights.

Counterpart of ``benchmarks/fig3_density.py``. Runs real magnitude pruning
(80% global on 3x3 kernels, ``core/pruning.py``) on the initialized
detector and reports per-layer density; the qualitative shape must match
the paper: early small layers keep most weights, late large layers are
pruned hardest. The seeded weights (``torch.Generator``) are not the JAX
package's ``jax.random`` ones, so the densities differ from its run.

  PYTHONPATH=src python -m repro_torch.benchmarks.fig3_density [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs.snn_det import CONFIG
from repro_torch.core import pruning
from repro_torch.models import snn_yolo as sy


def run(rate: float = 0.8, device=None) -> dict:
    params, _ = sy.init_params(CONFIG, seed=0, device=device)
    pruned = pruning.prune_tree(params, rate=rate)
    print(f"Fig 3 — post-pruning 3x3 density per layer (global rate {rate:.0%})")
    out = {}
    for name in params:
        w = params[name]["w"]
        if w.dim() != 4 or w.shape[0] != 3:
            continue
        d = pruning.density(pruned[name]["w"])
        out[name] = d
        bar = "#" * int(d * 40)
        print(f"  {name:22s} {d*100:5.1f}%  {bar}")
    first = [v for k, v in out.items() if "encode" in k or "conv_block" in k or "stage0" in k]
    last = [v for k, v in out.items() if "stage3" in k or "stage4" in k]
    out["_monotone"] = bool(np.mean(first) > np.mean(last))
    print(f"early-vs-late density: {np.mean(first):.2f} vs {np.mean(last):.2f} "
          f"(paper Fig 3 shape: early >> late) -> {'OK' if out['_monotone'] else 'MISMATCH'}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    run(device=ap.parse_args().device)
