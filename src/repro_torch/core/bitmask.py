"""Bit-mask sparse weight compression (paper §III-B.2, Fig 10, Fig 17), and
CSR for the comparison.

Counterpart of ``repro/core/bitmask.py``. A pruned tensor is stored as a
``mask`` (one 0/1 per weight position) and ``values``, its nonzeros packed
in scan order (optionally zero-padded to a fixed length). Encoding is
host-side numpy; :func:`decode` is the cumulative-sum gather the kernels
replicate.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class BitmaskWeights(NamedTuple):
    mask: torch.Tensor  # uint8 0/1, the dense shape
    values: torch.Tensor  # 1-D, nnz entries (+ zero padding)
    nnz: int

    @property
    def shape(self):
        return self.mask.shape


def encode(dense, pad_to: int | None = None) -> BitmaskWeights:
    """Dense → (mask, packed values)."""
    dense = np.asarray(dense)
    mask = (dense != 0).astype(np.uint8)
    values = dense[dense != 0].ravel()
    nnz = int(values.size)
    if pad_to is not None:
        if pad_to < nnz:
            raise ValueError(f"pad_to={pad_to} < nnz={nnz}")
        values = np.pad(values, (0, pad_to - nnz))
    return BitmaskWeights(mask=torch.from_numpy(mask), values=torch.from_numpy(values),
                          nnz=nnz)


def decode(cw: BitmaskWeights, dtype=None) -> torch.Tensor:
    """(mask, values) → dense: position i reads values[cumsum(mask)[i] − 1]
    where mask[i] is set, else 0 (the cumsum counted in int64, so it never
    wraps)."""
    mask = cw.mask.reshape(-1)
    if cw.values.shape[0] == 0:  # fully pruned
        dense = torch.zeros(mask.shape, dtype=cw.values.dtype, device=mask.device)
    else:
        idx = (torch.cumsum(mask.long(), 0) - 1).clamp(0, cw.values.shape[0] - 1)
        vals = cw.values[idx]
        dense = torch.where(mask.bool(), vals, torch.zeros_like(vals))
    if dtype is not None:
        dense = dense.to(dtype)
    return dense.reshape(cw.mask.shape)


class CSRWeights(NamedTuple):
    indptr: torch.Tensor  # (rows + 1,) int32
    indices: torch.Tensor  # (nnz,) int32
    values: torch.Tensor  # (nnz,)
    shape: tuple


def encode_csr(dense) -> CSRWeights:
    """Kernel-sparse CSR as in the paper's Fig 10: per output row pointers
    and column indices into the flattened remaining axes."""
    dense = np.asarray(dense)
    rows = dense.shape[0]
    flat = dense.reshape(rows, -1)
    indptr, indices, values = [0], [], []
    for r in range(rows):
        (nz,) = np.nonzero(flat[r])
        indices.append(nz)
        values.append(flat[r, nz])
        indptr.append(indptr[-1] + nz.size)
    return CSRWeights(
        indptr=torch.from_numpy(np.asarray(indptr, np.int32)),
        indices=torch.from_numpy(
            np.concatenate(indices).astype(np.int32) if indices else np.zeros(0, np.int32)),
        values=torch.from_numpy(
            np.concatenate(values) if values else np.zeros(0, dense.dtype)),
        shape=dense.shape,
    )


def decode_csr(cw: CSRWeights) -> torch.Tensor:
    indptr = cw.indptr.numpy()
    indices = cw.indices.numpy()
    values = cw.values.numpy()
    rows = cw.shape[0]
    flat = np.zeros((rows, int(np.prod(cw.shape[1:]))), values.dtype)
    for r in range(rows):
        flat[r, indices[indptr[r]:indptr[r + 1]]] = values[indptr[r]:indptr[r + 1]]
    return torch.from_numpy(flat.reshape(cw.shape))


def format_bits(dense_shape, nnz: int, *, weight_bits: int = 8, fmt: str = "bitmask",
                index_bits: int | None = None) -> int:
    """Bits to store a pruned tensor: ``dense`` (every position),
    ``bitmask`` (1 bit per position + the nonzeros), ``csr`` (an index per
    nonzero + row pointers, paper Fig 10)."""
    n = int(np.prod(dense_shape))
    rows = int(dense_shape[0]) if len(dense_shape) > 1 else 1
    cols = n // max(rows, 1)
    if fmt == "dense":
        return n * weight_bits
    if fmt == "bitmask":
        return n + nnz * weight_bits
    if fmt == "csr":
        ib = index_bits if index_bits is not None else max(int(np.ceil(np.log2(max(cols, 2)))), 1)
        pb = max(int(np.ceil(np.log2(max(nnz + 1, 2)))), 1)
        return nnz * (weight_bits + ib) + (rows + 1) * pb
    raise ValueError(f"unknown format {fmt!r}")
