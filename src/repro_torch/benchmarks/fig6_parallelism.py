"""Fig 6 — analysis of design parallelism under weight sparsity.

Discrete cycle simulation of the three PE organizations the paper compares
(576 PEs total), driven by per-channel nonzero-weight counts drawn from the
pruned network's density profile:

  (a) input-channel parallelism (C, H, W) = (8, 9, 8): channels race ahead
      independently; a FIFO of depth d absorbs imbalance, deeper FIFOs cost
      area. Latency is simulated with a bounded-queue producer model.
  (b) output-channel parallelism: all K-lanes share the input stream and
      must ALL finish an input pixel block before advancing -> latency is
      sum over blocks of max-over-lane work.
  (c) spatial parallelism (paper's choice): every PE handles one pixel of a
      32x18 tile; identical weight stream -> zero imbalance, latency = nnz.

Reproduces the paper's qualitative result: (a) needs deep FIFOs to approach
(c) and never beats it; (b) degrades as more PEs go to K; (c) is optimal
with no extra hardware.

Counterpart of ``benchmarks/fig6_parallelism.py``: a numpy copy that
imports nothing of the model.

  PYTHONPATH=src python -m repro_torch.benchmarks.fig6_parallelism
"""
from __future__ import annotations

import numpy as np


def _nnz_per_channel(rng, cin: int, k2: int = 9, density: float = 0.3):
    """Nonzero taps per input channel for one output channel's kernel."""
    return rng.binomial(k2, density, size=cin)


def spatial_latency(nnz_c: np.ndarray) -> int:
    """(c): all 576 PEs process the same (channel, tap) stream: cycles =
    total nnz taps across channels (one tap/cycle, paper §III-C)."""
    return int(nnz_c.sum())


def input_parallel_latency(nnz_c: np.ndarray, c_par: int, fifo_depth: int) -> int:
    """(a): c_par channel lanes, each owning cin/c_par channels; a lane's
    output must be merged in channel order into the accumulator; a FIFO of
    `fifo_depth` per lane lets fast lanes run ahead. Simulated per tap."""
    lanes = [nnz_c[i::c_par] for i in range(c_par)]
    # each lane is a work list of per-channel tap counts, merged round-robin
    queues = [0] * c_par  # occupancy of each lane's output FIFO
    work = [list(l) for l in lanes]
    t = 0
    done = [sum(l) == 0 for l in work]
    progress = [0] * c_par  # taps finished in current channel
    merged = 0
    total = sum(sum(l) for l in work)
    while merged < total:
        t += 1
        # lanes execute one tap if FIFO has room
        for i in range(c_par):
            if not work[i]:
                continue
            if queues[i] < fifo_depth + 1:
                progress[i] += 1
                if progress[i] >= work[i][0]:
                    work[i].pop(0)
                    progress[i] = 0
                queues[i] += 1
        # merge drains one entry per cycle (single accumulator port)
        for i in range(c_par):
            if queues[i] > 0:
                queues[i] -= 1
                merged += 1
                break
    return t


def output_parallel_latency(nnz_k: np.ndarray, k_par: int) -> int:
    """(b): k_par output-channel lanes share one input stream; the stream
    advances when the SLOWEST lane finishes its kernel for this input."""
    groups = [nnz_k[i : i + k_par] for i in range(0, len(nnz_k), k_par)]
    return int(sum(g.max() for g in groups))


def run() -> dict:
    rng = np.random.default_rng(0)
    cin, cout, density = 256, 256, 0.3
    # one output channel processed against all input channels (inner loop)
    nnz_c = _nnz_per_channel(rng, cin, density=density)
    base = spatial_latency(nnz_c)

    print("Fig 6(a) — input-channel parallelism vs FIFO depth (relative latency)")
    rel_in = {}
    for depth in (0, 1, 2, 4, 8, 16):
        lat = input_parallel_latency(nnz_c, c_par=8, fifo_depth=depth)
        rel_in[depth] = lat / base
        print(f"  FIFO depth {depth:3d}: {lat / base:5.2f}x spatial")

    print("Fig 6(b) — output-channel parallelism (relative latency)")
    nnz_k = np.array([
        _nnz_per_channel(rng, cin, density=density).sum() for _ in range(cout)
    ])
    rel_out = {}
    for k_par in (1, 2, 4, 8, 16):
        # K lanes split the PE budget; fewer spatial PEs -> proportionally
        # more passes: latency_rel = (sum of per-group max)/(sum) * k_par-way
        lat = output_parallel_latency(nnz_k, k_par) / nnz_k.sum() * k_par
        rel_out[k_par] = lat
        print(f"  K-par {k_par:3d}: {lat:5.2f}x spatial")

    ok = min(rel_in.values()) >= 0.999 and all(v >= 0.999 for v in rel_out.values())
    print(f"spatial parallelism optimal (paper's choice): {'OK' if ok else 'MISMATCH'}")
    return {"input_par_rel": rel_in, "output_par_rel": rel_out, "spatial_optimal": ok}


if __name__ == "__main__":
    run()
