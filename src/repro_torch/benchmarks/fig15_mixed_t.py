"""Fig 15 — effect of mixed time steps on operation count (and the paper's
C1/C2/C2BX schedule family).

Counterpart of ``benchmarks/fig15_mixed_t.py``; pure accounting, no device.
Cx = first x conv layers take 1-time-step input; C2BX additionally sets the
first X basic blocks to in_T=1. The paper selects C2: −4.13 GOps (−17%)
against the all-3-time-step baseline. The accuracy cells need IVS 3cls
(``eval_map`` measures the mixed-vs-uniform delta on the synthetic split).

  PYTHONPATH=src python -m repro_torch.benchmarks.fig15_mixed_t
"""
from __future__ import annotations

from repro_torch.configs.snn_det import CONFIG
from repro_torch.models import snn_yolo as sy


def _sched_ops(cfg, one_t_layers: int, one_t_blocks: int = 0) -> float:
    """Total GOps with the first `one_t_layers` standalone conv layers
    (encode, conv_block) and the first `one_t_blocks` basic blocks at
    in_T=1; everything else runs at the full T=3 (the paper's original
    pre-mixed-time-step schedule)."""
    total = 0.0
    conv_seen = 0
    for s in sy.layer_specs(cfg):
        t_in = cfg.full_t  # base: every layer convolves once per time step
        if "/" not in s.name and s.name != "head":  # encode / conv_block
            conv_seen += 1
            if conv_seen <= one_t_layers:
                t_in = 1
        elif "/" in s.name:
            idx = int(s.name[5])  # stageN/...
            if idx < one_t_blocks:
                t_in = 1
        total += 2 * s.h * s.w * s.nnz * t_in * s.bits_in
    return total / 1e9


def run() -> dict:
    cfg = CONFIG
    rows = {
        "base(3T)": _sched_ops(cfg, 0),
        "C1": _sched_ops(cfg, 1),
        "C2": _sched_ops(cfg, 2),
        "C2B1": _sched_ops(cfg, 2, 1),
        "C2B2": _sched_ops(cfg, 2, 2),
        "C2B3": _sched_ops(cfg, 2, 3),
    }
    c2_saving = rows["base(3T)"] - rows["C2"]
    print("Fig 15 — mixed-time-step schedules, GOps/frame")
    for k, v in rows.items():
        print(f"  {k:9s} {v:7.2f} GOps")
    print(f"C2 saves {c2_saving:.2f} GOps ({c2_saving / rows['base(3T)'] * 100:.1f}%) "
          f"— paper: 4.13 GOps (17%)")
    return {**rows, "c2_saving_gops": c2_saving,
            "c2_saving_frac": c2_saving / rows["base(3T)"]}


if __name__ == "__main__":
    run()
