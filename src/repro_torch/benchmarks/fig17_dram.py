"""Fig 17 — DRAM access amount of the network parameters, by storage format
(original dense / CSR / bit-mask). Paper: bit-mask saves 59.1% vs dense and
16.4% vs CSR at the pruned network's sparsity.

Counterpart of ``benchmarks/fig17_dram.py``; pure accounting, no device.

  PYTHONPATH=src python -m repro_torch.benchmarks.fig17_dram
"""
from __future__ import annotations

from repro_torch.configs.snn_det import CONFIG
from repro_torch.core import energy as en
from repro_torch.models import snn_yolo as sy


def run() -> dict:
    specs = sy.layer_specs(CONFIG)
    fmt_mb = {
        fmt: sum(en.param_dram_bytes(s, fmt) for s in specs) / 1e6
        for fmt in ("dense", "csr", "bitmask")
    }
    vs_dense = 1 - fmt_mb["bitmask"] / fmt_mb["dense"]
    vs_csr = 1 - fmt_mb["bitmask"] / fmt_mb["csr"]
    print("Fig 17 — parameter DRAM traffic by format (MB/frame)")
    for fmt, v in fmt_mb.items():
        print(f"  {fmt:8s} {v:6.3f} MB")
    print(f"bitmask vs dense: -{vs_dense*100:.1f}% (paper -59.1%) | "
          f"vs CSR: -{vs_csr*100:.1f}% (paper -16.4%)")
    return {**fmt_mb, "vs_dense": vs_dense, "vs_csr": vs_csr}


if __name__ == "__main__":
    run()
