"""PyTorch/CUDA port of the compressed SNN detector (``repro``'s serving
path on an NVIDIA H100).

Module names mirror the JAX package so counterparts are easy to find:
``repro_torch.core.plan`` ↔ ``repro.core.plan`` and so on. The package
imports ``torch`` and numpy only — never ``jax`` and nothing of ``repro``.
Entry points run on the card unless the caller passes ``device="cpu"``;
on the CPU every kernel wrapper runs its plain PyTorch version.
"""
from repro_torch.backend import launches, resolve_device

__all__ = ["launches", "resolve_device"]
