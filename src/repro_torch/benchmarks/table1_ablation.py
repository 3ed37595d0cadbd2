"""Table I — ablation of the SNN detector: parameters and operation counts
for SNN-a (baseline) → SNN-b (pruned) → SNN-c (+quant) → SNN-d (+block conv).

Counterpart of ``benchmarks/table1_ablation.py``. The accuracy cells need
the IVS 3cls dataset (not redistributable; ``eval_map`` reproduces the
pipeline on the synthetic split); the reproducible cells are the
parameter/op accounting, against the paper's numbers:
  * SNN-a: 3.17 M params
  * SNN-b/c/d: 0.96 M params (−70%)
  * zero-weight skipping: −47.3 % operation count (§IV-E)

  PYTHONPATH=src python -m repro_torch.benchmarks.table1_ablation [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.configs.snn_det import CONFIG
from repro_torch.models import snn_yolo as sy


def run(device=None) -> dict:
    cfg = CONFIG
    params, _ = sy.init_params(cfg, seed=0, device=device)
    n_params = sy.param_count(params)

    dense = sy.layer_specs(cfg, pruned_density=1.0)
    pruned = sy.layer_specs(cfg)  # Fig 3 profile

    def tot_params(specs, density=True):
        return sum(s.nnz if density else s.params for s in specs)

    p_a = tot_params(dense, density=False)
    p_b = tot_params(pruned)
    ops_dense = sum(s.ops(sparse=False) for s in pruned)
    ops_sparse = sum(s.ops(sparse=True) for s in pruned)

    rows = [
        ("SNN-a", p_a / 1e6, ops_dense / 1e9, "baseline"),
        ("SNN-b", p_b / 1e6, ops_sparse / 1e9, "fine-grained pruning (3x3 @ 80%)"),
        ("SNN-c", p_b / 1e6, ops_sparse / 1e9, "+ 8-bit quantization"),
        ("SNN-d", p_b / 1e6, ops_sparse / 1e9, "+ block convolution 32x18"),
    ]
    out = {
        "init_params_M": n_params / 1e6,
        "snn_a_params_M": p_a / 1e6,
        "snn_d_params_M": p_b / 1e6,
        "param_reduction": 1 - p_b / p_a,
        "ops_reduction": 1 - ops_sparse / ops_dense,
        "paper": {"snn_a_params_M": 3.17, "snn_d_params_M": 0.96,
                  "param_reduction": 0.70, "ops_reduction": 0.473},
    }
    print("Table I — SNN model ablation (accounting cells)")
    print(f"{'model':7s} {'params(M)':>10s} {'GOps/frame':>11s}  notes")
    for name, p, g, note in rows:
        print(f"{name:7s} {p:10.2f} {g:11.2f}  {note}")
    print(f"reproduced: init {out['init_params_M']:.2f}M vs paper 3.17M | "
          f"param cut {out['param_reduction']*100:.1f}% (paper 70%) | "
          f"op cut {out['ops_reduction']*100:.1f}% (paper 47.3%)")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    run(ap.parse_args().device)
