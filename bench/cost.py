"""Operations and bytes of the detector's convs on logical shapes, and the
card's peaks.

A frozen copy of ``chip_smoke.py``'s ``layer_bound`` (each byte read once,
each written once; 2 int8 operations a nonzero weight, input step and
pixel) and of ``repro_torch.benchmarks.e2e_detector._accumulates``, counted
on the layers' logical shapes rather than the program's packing: spikes
and u8 pixels at 1 byte of their true channels, the nonzero int8 weights
plus a 1-bit mask of the dense kernel, the f32 affine (5 rows) and
membranes, the output spikes once; no bit-serial planes.
"""
from __future__ import annotations

import math

from bench.reference import snn_ref

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12


def fused_layers(m: dict) -> list:
    """The layers one fused launch each runs: every conv but the head."""
    return [n for n in snn_ref.layer_shapes(m) if n != "head"]


def launch_bytes(shape, geo, nnz: int, batch: int) -> int:
    kh, kw, cin, kout = shape
    h, w, t_in, t_out = geo
    pix = batch * h * w
    return (t_in * pix * cin + nnz + math.ceil(kh * kw * cin * kout / 8) + 5 * kout * 4
            + 2 * pix * kout * 4 + t_out * pix * kout)


def launch_ops(geo, nnz: int, batch: int) -> int:
    h, w, t_in, _ = geo
    return 2 * t_in * batch * h * w * nnz


def least_s(shape, geo, nnz: int, batch: int) -> float:
    """The least time of one fused launch: bytes or operations at peak."""
    return max(launch_bytes(shape, geo, nnz, batch) / HBM_BYTES_PER_S,
               launch_ops(geo, nnz, batch) / INT8_OPS_PER_S)


def tick_least_s(m: dict, nnz: dict, batch: int) -> float:
    """Σ least time of one tick's fused launches at capacity ``batch``."""
    shapes, geo = snn_ref.layer_shapes(m), snn_ref.layer_geometry(m)
    return sum(least_s(shapes[n], geo[n], nnz[n], batch) for n in fused_layers(m))


def frame_ops(m: dict, nnz: dict) -> int:
    """int8 operations one frame needs in all its convs, the head included."""
    geo = snn_ref.layer_geometry(m)
    return sum(launch_ops(geo[n], nnz[n], 1) for n in snn_ref.layer_shapes(m))
