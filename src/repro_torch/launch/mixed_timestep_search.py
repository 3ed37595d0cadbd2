"""The paper's mIoUT-driven mixed-time-step schedule search (§II-D, Fig 15)
as a reusable tool: run the detector on sample frames, measure mIoUT per
macro layer, propose the schedule (layers above the threshold drop to
in_T=1), and report the operation savings — the C1/C2/C2BX family.
Counterpart of ``examples/mixed_timestep_search.py``, with its prints,
plus ``--threshold``, ``--full-config`` and ``--device``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.mixed_timestep_search \\
      [--threshold 0.9] [--full-config] [--device cpu]

The frames run through the paper topology at 144x256 (``--full-config``:
576x1024), every layer at T=3, batch 2. The operation count is always the
full-size ``snn-det``'s (``layer_specs``). Runs on the card unless
``--device cpu``; the weights are the port's own, seeded (``run`` takes
carried-across ``params``/``bn``).
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.backend import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import miout as mi
from repro_torch.data import synthetic_detection as sd
from repro_torch.models import snn_yolo as sy

BATCH = 2


def search_config(*, full_config: bool = False) -> sy.SNNDetConfig:
    """Every layer at full T, plain SAME conv; 144x256 unless ``full_config``."""
    cfg = get_config("snn-det")
    hw = cfg.input_hw if full_config else (144, 256)
    return dataclasses.replace(cfg, input_hw=hw, use_block_conv=False, mixed_time=False)


def ops_gops(specs, in_t_of) -> float:
    """GOps of the layer specs when macro layer m runs at ``in_t_of(m)``."""
    tot = 0.0
    for sp in specs:
        tot += 2 * sp.h * sp.w * sp.nnz * in_t_of(sp.name.split("/")[0]) * sp.bits_in
    return tot / 1e9


def run(cfg: sy.SNNDetConfig | None = None, *, threshold: float = 0.9, params=None, bn=None,
        device=None) -> dict:
    """mIoUT per macro layer (None for the encoding layer), the proposed
    schedule, and the GOps all-3T and proposed."""
    cfg = cfg or search_config()
    dev = resolve_device(device)
    if params is None:
        params, bn = sy.init_params(cfg, seed=0, device=dev)
    # the model's own grid divisor: the targets (unused) then fit any input size
    batch = next(sd.batches(BATCH, hw=cfg.input_hw, steps=1,
                            grid_div=2 ** (cfg.pooled_stages + 1)))
    with torch.no_grad(), sy._no_tf32():
        _, _, aux = sy.forward(params, bn, torch.from_numpy(batch["image"]).to(dev), cfg)

    schedule, values = {}, {}
    for name, s in aux["spikes"].items():
        if s.shape[0] == 1:  # the encoding layer
            schedule[name], values[name] = 1, None
            continue
        values[name] = float(mi.miout(s))
        schedule[name] = 1 if values[name] >= threshold else cfg.full_t

    # operation accounting for the proposed schedule vs all-3T
    specs = sy.layer_specs(get_config("snn-det"))
    base = ops_gops(specs, lambda m: cfg.full_t)
    prop = ops_gops(specs, lambda m: schedule.get(m, cfg.full_t))
    return {"threshold": threshold, "miout": values, "schedule": schedule,
            "base_gops": base, "proposed_gops": prop, "input_hw": tuple(cfg.input_hw)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threshold", type=float, default=0.9)
    ap.add_argument("--full-config", action="store_true",
                    help="the paper's 576x1024 input instead of 144x256")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    r = run(search_config(full_config=args.full_config), threshold=args.threshold,
            device=args.device)
    print(f"mIoUT per macro layer (threshold {r['threshold']} -> in_T=1):")
    for name, v in r["miout"].items():
        if v is None:
            print(f"  {name:12s} (encoding layer)            in_T = 1")
        else:
            print(f"  {name:12s} mIoUT = {v:.3f}  ->  in_T = {r['schedule'][name]}")
    base, prop = r["base_gops"], r["proposed_gops"]
    print(f"\nops: all-3T {base:.2f} GOps -> proposed {prop:.2f} GOps "
          f"(-{(1 - prop / base) * 100:.1f}%)  [paper C2: -17%]")
    print("mixed_timestep_search OK")
    return r


if __name__ == "__main__":
    main()
