"""Table III + Fig 16 + §IV-D/E — throughput / bandwidth / energy accounting
of the accelerator, from the analytic hardware model (core/energy.py):

  * peak 576 GOPS dense, 1093 GOPS effective with weight sparsity,
  * −47.3% computing latency from zero-weight skipping → 29 fps @1024×576,
  * DRAM bandwidth 5.6 GB/s (within DDR3's 12.8),
  * DRAM traffic 188.9/3.3/1.3 MB per frame (36 KB input SRAM) →
    5.456 MB input with 81 KB SRAM; 108.38 → 5.64 mJ DRAM energy,
  * core 1.05 mJ/frame.

Counterpart of ``benchmarks/table3_hw.py``; pure accounting, no device.

  PYTHONPATH=src python -m repro_torch.benchmarks.table3_hw
"""
from __future__ import annotations

from repro_torch.configs.snn_det import CONFIG
from repro_torch.core import energy as en
from repro_torch.models import snn_yolo as sy


def run() -> dict:
    specs = sy.layer_specs(CONFIG)

    lat_dense = en.network_latency_s(specs, sparse=False)
    lat_sparse = en.network_latency_s(specs, sparse=True)
    fps = 1.0 / lat_sparse
    t36 = en.network_traffic(specs, sram_bits_per_pixel=en.SRAM_36KB_BITS_PER_PIXEL)
    t81 = en.network_traffic(specs, sram_bits_per_pixel=en.SRAM_81KB_BITS_PER_PIXEL)
    bw = t36.total_mb * 1e6 * fps / 1e9  # GB/s at the achieved frame rate
    core_mj = en.core_energy_mj_per_frame(specs)

    out = {
        "peak_gops_dense": en.peak_gops(),
        "peak_gops_sparse": en.peak_gops(sparse_speedup=1 / (1 - 0.473)),
        "latency_saving": 1 - lat_sparse / lat_dense,
        "fps": fps,
        "dram_mb_36k": {"input": t36.input_mb, "output": t36.output_mb, "param": t36.param_mb},
        "dram_mb_81k_input": t81.input_mb,
        "dram_energy_mj_36k": t36.dram_energy_mj(),
        "dram_energy_mj_81k": t81.dram_energy_mj(),
        "bandwidth_gbps": bw,
        "core_mj_per_frame": core_mj,
        "paper": {
            "peak_gops": (576, 1093), "latency_saving": 0.473, "fps": 29,
            "dram_mb": (188.928, 3.327, 1.292), "input_81k": 5.456,
            "dram_mj": (108.38, 5.64), "bandwidth_gbps": 5.6, "core_mj": 1.05,
        },
    }
    print("Table III / Fig 16 / §IV-D-E — hardware accounting")
    print(f"  peak GOPS      : {out['peak_gops_dense']:.0f} dense / "
          f"{out['peak_gops_sparse']:.0f} effective (paper 576 / 1093)")
    print(f"  latency saving : {out['latency_saving']*100:.1f}% (paper 47.3%)")
    print(f"  frame rate     : {out['fps']:.1f} fps (paper 29)")
    d = out["dram_mb_36k"]
    print(f"  DRAM/frame 36KB: in {d['input']:.1f} / out {d['output']:.2f} / "
          f"par {d['param']:.2f} MB (paper 188.9/3.3/1.3)")
    print(f"  input @81KB    : {out['dram_mb_81k_input']:.2f} MB (paper 5.456)")
    print(f"  DRAM energy    : {out['dram_energy_mj_36k']:.1f} -> "
          f"{out['dram_energy_mj_81k']:.2f} mJ (paper 108.38 -> 5.64)")
    print(f"  bandwidth      : {out['bandwidth_gbps']:.1f} GB/s (paper 5.6)")
    print(f"  core energy    : {out['core_mj_per_frame']:.2f} mJ/frame (paper 1.05)")
    return out


if __name__ == "__main__":
    run()
