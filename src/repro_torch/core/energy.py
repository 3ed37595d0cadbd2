"""Analytic DRAM-traffic / energy / latency model (paper §IV-D, §IV-E).

Counterpart of ``repro/core/energy.py``: the same layer spec, constants
and formulas, with ``param_dram_bytes`` reading the storage formats from
:mod:`repro_torch.core.bitmask`.

The paper's energy story is accounting, and the accounting reproduces on any
platform: bytes moved × pJ/bit + ops × pJ/op. This module implements that
model generically over a layer list so benchmarks can reproduce:

  * §IV-D input/output/param DRAM traffic per frame
      (paper: 188.928 MB input / 3.327 MB output / 1.292 MB params with a
       36 KB input SRAM; input drops to 5.456 MB with 81 KB),
  * Fig 17 parameter-traffic comparison (dense vs CSR vs bitmask,
      −59.1% / −16.4%),
  * Table III / Fig 16 throughput (576 PEs @ 500 MHz, zero-weight skipping
      → −47.3% latency, 29 fps) and energy (1.05 mJ/frame core,
      70 pJ/bit DDR3).

The refetch model (paper §IV-D): the Input SRAM holds `sram_bits_per_pixel`
bits for every pixel of a 32×18 tile (36 KB ⇒ 512 bits/pixel ⇒ 512 channels
× 1 time step of 1-bit spikes). A layer whose input needs Cin × T_in ×
bits_in > capacity must re-stream its input from DRAM once per output
channel (KTBC loop order: K is outermost).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

# -- hardware constants (paper values) --------------------------------------
FREQ_HZ = 500e6
NUM_PES = 576  # 32×18 spatial tile, one accumulator per pixel
DRAM_PJ_PER_BIT = 70.0  # DDR3 [35]
TILE_PIXELS = 32 * 18
CORE_POWER_W = 30.5e-3  # measured core power (paper Fig 16)

# input SRAM configurations discussed in §IV-D
SRAM_36KB_BITS_PER_PIXEL = 512  # 512 ch × 1 T × 1 bit
SRAM_81KB_BITS_PER_PIXEL = 1152  # 384 ch × 3 T × 1 bit


@dataclass
class ConvLayerSpec:
    """One convolution layer as the accelerator sees it."""

    name: str
    h: int  # output spatial height
    w: int
    cin: int
    cout: int
    k: int = 3  # kernel size (1 or 3)
    t_in: int = 3  # input time steps
    t_out: int = 3
    bits_in: int = 1  # 1 for spikes, 8 for the RGB encoding layer
    bits_out: int = 1
    density: float = 1.0  # nonzero weight fraction after pruning

    @property
    def params(self) -> int:
        return self.k * self.k * self.cin * self.cout

    @property
    def nnz(self) -> int:
        return int(round(self.params * self.density))

    @property
    def macs_dense_1t(self) -> int:
        return self.h * self.w * self.params

    def macs(self, *, sparse: bool = True) -> int:
        """MACs per frame: conv executed once per input time step (mixed
        time steps: t_in=1 layers compute once), per bit plane."""
        per_t = self.h * self.w * (self.nnz if sparse else self.params)
        return per_t * self.t_in * self.bits_in

    def ops(self, *, sparse: bool = True) -> int:
        return 2 * self.macs(sparse=sparse)


def input_dram_bytes(layer: ConvLayerSpec, sram_bits_per_pixel: int) -> float:
    """DRAM bytes read for this layer's input per frame (refetch model)."""
    bits_needed = layer.cin * layer.t_in * layer.bits_in
    base_bits = layer.h * layer.w * bits_needed
    refetch = layer.cout if bits_needed > sram_bits_per_pixel else 1
    return base_bits * refetch / 8.0


def output_dram_bytes(layer: ConvLayerSpec) -> float:
    return layer.h * layer.w * layer.cout * layer.t_out * layer.bits_out / 8.0


def param_dram_bytes(layer: ConvLayerSpec, fmt: str = "bitmask", weight_bits: int = 8) -> float:
    """Parameter traffic per frame in a given storage format (Fig 17).

    1×1 layers are kept dense (unpruned per §II-C) in every format.
    """
    from repro_torch.core import bitmask as bm

    if layer.k == 1 or layer.density >= 1.0:
        return layer.params * weight_bits / 8.0
    shape = (layer.cout, layer.cin * layer.k * layer.k)
    return bm.format_bits(shape, layer.nnz, weight_bits=weight_bits, fmt=fmt) / 8.0


@dataclass
class TrafficReport:
    input_mb: float
    output_mb: float
    param_mb: float

    @property
    def total_mb(self) -> float:
        return self.input_mb + self.output_mb + self.param_mb

    def dram_energy_mj(self) -> float:
        return self.total_mb * 8e6 * DRAM_PJ_PER_BIT * 1e-12 * 1e3


def network_traffic(
    layers: Sequence[ConvLayerSpec],
    *,
    sram_bits_per_pixel: int = SRAM_36KB_BITS_PER_PIXEL,
    param_fmt: str = "bitmask",
) -> TrafficReport:
    mb = 1.0 / 1e6
    return TrafficReport(
        input_mb=sum(input_dram_bytes(l, sram_bits_per_pixel) for l in layers) * mb,
        output_mb=sum(output_dram_bytes(l) for l in layers) * mb,
        param_mb=sum(param_dram_bytes(l, param_fmt) for l in layers) * mb,
    )


def network_latency_s(layers: Sequence[ConvLayerSpec], *, sparse: bool = True) -> float:
    """Cycle model: each PE performs one accumulate per cycle; a layer's
    cycles = MACs / NUM_PES (spatial parallelism is perfectly balanced —
    the paper's Fig 6 argument). Zero-weight skipping ⇒ MACs counts nnz."""
    total_macs = sum(l.macs(sparse=sparse) for l in layers)
    return total_macs / NUM_PES / FREQ_HZ


def fps(layers: Sequence[ConvLayerSpec], *, sparse: bool = True) -> float:
    return 1.0 / network_latency_s(layers, sparse=sparse)


def peak_gops(*, sparse_speedup: float = 1.0) -> float:
    """576 adders × 2 ops × 500 MHz = 576 GOPS dense; 'considering weight
    sparsity' the paper quotes effective 1093 GOPS = 576 / (1 − 0.473)."""
    return NUM_PES * 2 * FREQ_HZ / 1e9 * sparse_speedup


def core_energy_mj_per_frame(layers: Sequence[ConvLayerSpec]) -> float:
    """Core energy per frame = power × latency (paper: 30.5 mW, 34.5 ms
    ⇒ 1.05 mJ/frame)."""
    return CORE_POWER_W * network_latency_s(layers, sparse=True) * 1e3
