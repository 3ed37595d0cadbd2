"""Bitmask-compressed sparse-weight matmul: the paper's weight format
(§III-B.2) applied to a dense layer's weights (e.g. a transformer FFN).

Counterpart of ``repro/kernels/bitmask_matmul.py`` (``PackedMatmulWeights``,
``pack_weights``, ``bitmask_matmul_pallas``). W (K, N) with fine-grained
pruning is stored as a bit-packed mask and its nonzero values per (KBLK,
NBLK) block, byte-equal to the JAX package's packing. :func:`bitmask_matmul`
is the wrapper: on CUDA tensors it launches ``csrc/bitmask_matmul.cu``
(built with ``nvcc`` for ``sm_90a``, see :mod:`repro_torch.backend`), which
decodes the weights slice by slice in shared memory; on CPU tensors it runs
:func:`bitmask_matmul_reference`, the plain PyTorch version beside it.
There is no other route: a CUDA tensor never falls back to the plain
version, and a failed build or launch raises.

Both compute f32 products with f32 sums (no TF32), in different orders, so
they agree to rounding, not bit for bit. The TPU kernel's ``mblk`` row
tiling has no counterpart: x is not padded, the kernel guards its edges.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch import backend

KERNEL = "bitmask_matmul"  # the library, and its launch count
X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the C entry point's dtype codes
V_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
MAX_KBLK = 4096  # the kernel keeps one int per K-block row in shared memory


class PackedMatmulWeights(NamedTuple):
    maskp: torch.Tensor  # (KB, NB, KBLK//8, NBLK) uint8, bits packed over K
    vals: torch.Tensor  # (KB, NB, VPAD) — same dtype as the original weights
    shape: tuple  # (K, N) original
    kblk: int
    nblk: int

    @property
    def compressed_bytes(self) -> int:
        return self.maskp.numel() + self.vals.numel() * self.vals.element_size()

    def to(self, device) -> "PackedMatmulWeights":
        """The same packed weights with maskp and vals on ``device``."""
        return self._replace(maskp=self.maskp.to(device), vals=self.vals.to(device))


def pack_weights(w, *, kblk: int = 512, nblk: int = 256) -> PackedMatmulWeights:
    """W (K, N) — a tensor or numpy array, zeros = pruned — → the packed
    form on the CPU. K and N are zero-padded to whole blocks; each block's
    nonzeros are kept in row-major order, zero-padded to VPAD = the largest
    block's count (at least 1), in W's dtype."""
    w = torch.as_tensor(w).cpu()
    if w.dim() != 2 or kblk < 8 or kblk % 8 or nblk < 1:
        raise ValueError(f"need W (K, N) and KBLK a multiple of 8, got {tuple(w.shape)}, "
                         f"kblk={kblk}, nblk={nblk}")
    k, n = w.shape
    k_p = -(-k // kblk) * kblk
    n_p = -(-n // nblk) * nblk
    kb_t, nb_t = k_p // kblk, n_p // nblk
    wp = torch.zeros((k_p, n_p), dtype=w.dtype)
    wp[:k, :n] = w
    blocks = wp.reshape(kb_t, kblk, nb_t, nblk).permute(0, 2, 1, 3)  # (KB, NB, KBLK, NBLK)
    nz = blocks != 0
    shifts = torch.arange(8, dtype=torch.uint8).view(1, 1, 1, 8, 1)
    maskp = (nz.reshape(kb_t, nb_t, kblk // 8, 8, nblk).to(torch.uint8) << shifts).sum(
        dim=3, dtype=torch.uint8)
    flat = nz.reshape(kb_t * nb_t, -1)
    vpad = max(int(flat.sum(dim=1).max()) if flat.numel() else 0, 1)
    vals = torch.zeros((kb_t * nb_t, vpad), dtype=w.dtype)
    rank = flat.long().cumsum(dim=1) - 1
    rows = torch.arange(kb_t * nb_t).view(-1, 1).expand_as(flat)
    vals[rows[flat], rank[flat]] = blocks.reshape(kb_t * nb_t, -1)[flat]
    return PackedMatmulWeights(maskp=maskp.contiguous(), vals=vals.reshape(kb_t, nb_t, vpad),
                               shape=(k, n), kblk=kblk, nblk=nblk)


def decode_dense(maskp: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """(maskp, vals) → the padded dense W (KB·KBLK, NB·NBLK) in f32, on
    their device: a set bit at row-major position i of its block reads
    vals[cumsum(bits)[i] − 1], as the TPU kernel decodes each tile."""
    kb_t, nb_t, k8, nblk = maskp.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=maskp.device).view(1, 1, 1, 8, 1)
    bits = ((maskp.unsqueeze(3) >> shifts) & 1).reshape(kb_t * nb_t, -1).long()
    idx = (bits.cumsum(dim=1) - 1).clamp(0, vals.shape[-1] - 1)
    got = torch.gather(vals.reshape(kb_t * nb_t, -1).float(), 1, idx)
    dense = torch.where(bits > 0, got, got.new_zeros(()))
    dense = dense.reshape(kb_t, nb_t, k8 * 8, nblk).permute(0, 2, 1, 3)
    return dense.reshape(kb_t * k8 * 8, nb_t * nblk)


def bitmask_matmul_reference(x: torch.Tensor, packed: PackedMatmulWeights) -> torch.Tensor:
    """The plain PyTorch version of the kernel; same arguments and result as
    :func:`bitmask_matmul`: decode W to dense f32, then one f32 product.
    On the card the product is full f32 only with
    ``torch.backends.cuda.matmul.allow_tf32`` False (PyTorch's default)."""
    k, n = packed.shape
    return x.float() @ decode_dense(packed.maskp, packed.vals)[:k, :n]


def _check(x: torch.Tensor, packed: PackedMatmulWeights) -> None:
    maskp, vals = packed.maskp, packed.vals
    if x.dim() != 2 or x.dtype not in X_DTYPES:
        raise ValueError(f"x must be (M, K) float32 or bfloat16, got {tuple(x.shape)} {x.dtype}")
    if maskp.dtype != torch.uint8 or maskp.dim() != 4 or vals.dim() != 3 \
            or vals.dtype not in V_DTYPES or tuple(vals.shape[:2]) != tuple(maskp.shape[:2]) \
            or vals.shape[2] < 1:
        raise ValueError(f"maskp {tuple(maskp.shape)} {maskp.dtype} / vals {tuple(vals.shape)} "
                         f"{vals.dtype} (float32, bfloat16 or int8) are not packed weights")
    kb_t, nb_t, k8, nblk = maskp.shape
    k, n = packed.shape
    if k8 * 8 != packed.kblk or nblk != packed.nblk or not 0 <= k <= kb_t * packed.kblk \
            or not 0 <= n <= nb_t * nblk or kb_t < 1 or nb_t < 1:
        raise ValueError(f"maskp {tuple(maskp.shape)} does not hold W {packed.shape} in "
                         f"({packed.kblk}, {packed.nblk}) blocks")
    if x.shape[1] != k:
        raise ValueError(f"x has K={x.shape[1]}, W has K={k}")
    for name, t in (("x", x), ("maskp", maskp), ("vals", vals)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.device.type == "cuda" and packed.kblk > MAX_KBLK:
        raise ValueError(f"KBLK {packed.kblk} > {MAX_KBLK}: the kernel ranks a K-block's "
                         "rows in shared memory")


def bitmask_matmul(x: torch.Tensor, packed: PackedMatmulWeights) -> torch.Tensor:
    """One launch: x (M, K) float32/bfloat16 × bitmask-compressed W (K, N)
    → (M, N) float32. ``packed``: :func:`pack_weights`'s arrays on x's
    device (``packed.to(device)``)."""
    _check(x, packed)
    if x.device.type == "cpu":
        return bitmask_matmul_reference(x, packed)
    if x.device.type != "cuda":
        raise ValueError(f"bitmask_matmul runs on cuda or cpu, not {x.device}")
    m = x.shape[0]
    k, n = packed.shape
    kb_t, nb_t, _, _ = packed.maskp.shape
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _launcher()(
            x.data_ptr(), packed.maskp.data_ptr(), packed.vals.data_ptr(), out.data_ptr(),
            m, k, n, kb_t, nb_t, packed.kblk, packed.nblk, packed.vals.shape[2],
            X_DTYPES[x.dtype], V_DTYPES[packed.vals.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    backend.check_launch(err, KERNEL)
    backend.launches[KERNEL] += 1
    return out


@functools.cache
def _launcher():
    """The C entry point, its signature declared once: four pointers, ten
    ints, the stream."""
    fn = backend.load_kernels()[KERNEL].bitmask_matmul_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    return fn
