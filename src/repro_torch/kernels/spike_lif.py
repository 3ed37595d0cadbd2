"""Fused LIF over T: the whole time loop with the membrane kept on chip (the
ASIC keeps Vmem in PE registers across the time loop).

Counterpart of ``repro/kernels/spike_lif.py`` (``fused_lif_pallas``).
:func:`fused_lif` is the wrapper: on a CUDA tensor it launches
``csrc/spike_lif.cu`` (built with ``nvcc`` for ``sm_90a``, see
:mod:`repro_torch.backend`), which keeps each element's membrane in a
register across every step; on a CPU tensor it runs
:func:`fused_lif_reference`, the plain PyTorch version beside it. There is
no other route: a CUDA tensor never falls back to the plain version, and a
failed build or launch raises.

Unfused, T LIF steps cost 2·T round trips of the membrane through device
memory; fused they cost one read of the synaptic inputs and one write of
the spikes. The plain version takes the same float steps one eager op at a
time (``v·leak``, ``+ x``, ``v·(1 − s)``), each rounded on its own; the
kernel pins the same roundings, so the two agree bit for bit on the card.
The TPU kernel's ``mblk`` row tiling has no counterpart: the CUDA kernel
walks the flattened M·C axis with no padding.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import backend

KERNEL = "spike_lif"  # the library, and its launch count
DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the C entry point's dtype codes


def fused_lif_reference(psum_t: torch.Tensor, *, threshold: float = 0.5,
                        leak: float = 0.25) -> torch.Tensor:
    """The plain PyTorch version of the kernel; same arguments and result as
    :func:`fused_lif`. A Python loop over T of eager ops in the kernel's
    order: LIF from v=0, ``v = v·leak + x``, spike ``v ≥ θ``, hard reset
    ``v·(1 − s)``."""
    v = torch.zeros(psum_t.shape[1:], dtype=torch.float32, device=psum_t.device)
    out = torch.empty(psum_t.shape, dtype=torch.int8, device=psum_t.device)
    for t in range(psum_t.shape[0]):
        v = v * leak + psum_t[t].float()
        s = (v >= threshold).float()
        out[t] = s.to(torch.int8)
        v = v * (1.0 - s)
    return out


def _check(psum_t: torch.Tensor) -> None:
    if psum_t.dim() != 3 or psum_t.dtype not in DTYPES:
        raise ValueError(f"psum_t must be (T, M, C) float32 or bfloat16, got "
                         f"{tuple(psum_t.shape)} {psum_t.dtype}")
    if not psum_t.is_contiguous():
        raise ValueError("psum_t must be contiguous")
    if psum_t.device.type == "cuda" and psum_t.data_ptr() % 16:
        raise ValueError("psum_t must be 16-byte aligned for vector loads")


def fused_lif(psum_t: torch.Tensor, *, threshold: float = 0.5,
              leak: float = 0.25) -> torch.Tensor:
    """One launch for LIF over all T steps. psum_t: (T, M, C) float32 or
    bfloat16 synaptic inputs (any T, M, C). Returns int8 spikes (T, M, C)."""
    _check(psum_t)
    if psum_t.device.type == "cpu":
        return fused_lif_reference(psum_t, threshold=threshold, leak=leak)
    if psum_t.device.type != "cuda":
        raise ValueError(f"fused_lif runs on cuda or cpu, not {psum_t.device}")
    t, m, c = psum_t.shape
    out = torch.empty((t, m, c), dtype=torch.int8, device=psum_t.device)
    with torch.cuda.device(psum_t.device):
        err = _launcher()(
            psum_t.data_ptr(), out.data_ptr(), t, m * c, DTYPES[psum_t.dtype],
            float(threshold), float(leak), torch.cuda.current_stream().cuda_stream,
        )
    backend.check_launch(err, KERNEL)
    backend.launches[KERNEL] += 1
    return out


@functools.cache
def _launcher():
    """The C entry point, its signature declared once: two pointers, T, the
    element count per step, the dtype code, threshold, leak, the stream."""
    fn = backend.load_kernels()[KERNEL].fused_lif_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    return fn
