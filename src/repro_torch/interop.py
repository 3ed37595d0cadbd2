"""Bring the JAX package's detector state into the port.

:func:`params_from_numpy` takes the JAX parameter, tdBN-state and
(optionally) fused-kernel affine-bundle pytrees as numpy arrays — e.g.
``jax.tree_util.tree_map(np.asarray, params)``, or the leaves of a detector
checkpoint — and returns the port's. The affine bundle carries
``rsqrt(var + eps)`` as the JAX package rounded it; handing it to
``compile_detector(..., affines=...)`` keeps every spike decision bit-equal
to the reference, where recomputing it with ``torch.rsqrt`` would not be.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.backend import resolve_device


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)


def affine_rows(bundle: np.ndarray, kout: int) -> np.ndarray:
    """JAX (KB, 5, KBLK) bundle → (5, kout) per-channel rows."""
    b = np.asarray(bundle, np.float32)
    return b.transpose(1, 0, 2).reshape(b.shape[1], -1)[:, :kout]


def params_from_numpy(params_np: dict, bn_np: dict, affines_np: dict | None = None,
                      *, device=None):
    """(params, bn_state, affines) on ``device`` (default: the card).
    ``affines`` is {layer: (5, kout) f32} or None when no bundles are given."""
    dev = resolve_device(device)
    params = {n: {k: _tensor(v, dev) for k, v in p.items()} for n, p in params_np.items()}
    bn = {n: {k: _tensor(v, dev) for k, v in s.items()} for n, s in bn_np.items()}
    affines = None
    if affines_np is not None:
        affines = {
            n: _tensor(affine_rows(b, params[n]["w"].shape[-1]), dev)
            for n, b in affines_np.items()
        }
    return params, bn, affines
