"""AdamW with the paper's training recipe (§IV-A: warmup, cosine decay to a
floor, weight decay 1e-3), int8 optimizer moments and error-feedback int8
gradient compression.

Counterpart of ``repro/train/optimizer.py`` on trees of tensors (nested
dicts, as :mod:`repro_torch.tree` walks them). The schedule and the bias
corrections are computed on f32 tensors as JAX computes them: with Python
floats they would be f64 and drift from the reference by ulps.

Int8 moments keep the parameter's shape with one f32 scale per last-dim
row; the second moment is stored in the sqrt domain, and the eps floor is
raised to the quantization noise level (1e-5).

Sharded state (``apply_updates(splits=, ctx=)``, ``distributed/fsdp.py``):
each process updates its own slices. The global norm is the sum of squares
over every process's slices, all-reduced, plus the whole leaves' counted
once; an int8 moment whose row spans processes (the leaf split along its
last dimension: the ``wo`` leaves and ``tok``) takes the whole row's max,
all-reduced, as its scale, so its payload and scales are those of the
whole leaf bit for bit. The error-feedback compression of a sharded
gradient (:func:`compress_tree_`) takes its rows' scales the same way.

Memory: a leaf of more than ``SLICE_ELEMS`` elements is updated (and its
share of the global norm summed) in slices along dim 0, so no more than one
slice's f32 temporaries are alive at once — an expert leaf of olmoe-1b-7b
is 8.6 GB in f32. Every step of the update is elementwise or per last-dim
row, so the slices give the whole-leaf numbers bit for bit. With
``donate=True`` the new parameters and moments are written into the old
state's storage, as JAX's jitted step reuses its donated state.
"""
from __future__ import annotations

import functools
import math
from typing import Any, NamedTuple

import torch

from repro_torch import tree as tu
from repro_torch.distributed import fsdp

_F32 = torch.float32
SLICE_ELEMS = 1 << 25  # elements of a leaf taken at once by the update and the norm


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to f32, as a 0-d tensor on ``like``'s device. A fill,
    not a copy from the host: a host-to-device copy from pageable memory
    would wait for the device's queue, and the step would stop the host."""
    return torch.full((), x, dtype=_F32, device=like.device)


# ------------------------------------------------------- int8 moment codec --


def _q8_pack(x: torch.Tensor, row_max=None):
    """f32 leaf -> (int8 payload, same shape; f32 scale per last-dim row).
    ``row_max``: the rows' max |x| made whole (a row split over processes),
    applied to this slice's."""
    if x.dim():
        amax = x.abs().amax(dim=-1)
        scale = (amax if row_max is None else row_max(amax)) / 127.0
        q = torch.round(x / torch.clamp(scale[..., None], min=1e-12))
    else:
        scale = x.abs() / 127.0
        q = torch.round(x / torch.clamp(scale, min=1e-12))
    return q.to(torch.int8), scale


def _q8_unpack(q: torch.Tensor, scale: torch.Tensor, dtype=_F32) -> torch.Tensor:
    return q.to(dtype) * (scale[..., None] if q.dim() else scale)


class Q8Leaf(NamedTuple):
    q: torch.Tensor  # int8, same shape as the parameter
    scale: torch.Tensor  # f32, param shape minus the last dim


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: Any  # tree of f32 leaves or Q8Leaf
    v: Any


class AdamWConfig(NamedTuple):
    lr_peak: float = 1e-4
    lr_init: float = 1e-5
    lr_final: float = 1e-6
    warmup_steps: int = 500
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 1e-3
    grad_clip: float = 1.0
    int8_moments: bool = False


def _is_q8(x) -> bool:
    return isinstance(x, Q8Leaf)


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup lr_init → lr_peak, then cosine decay → lr_final; f32."""
    step = step.to(_F32)
    f = lambda x: _f32(x, step)  # noqa: E731
    warm = f(cfg.lr_init) + f(cfg.lr_peak - cfg.lr_init) * step / f(max(cfg.warmup_steps, 1))
    t = torch.clamp((step - f(cfg.warmup_steps))
                    / f(max(cfg.total_steps - cfg.warmup_steps, 1)), 0.0, 1.0)
    decay = f(cfg.lr_final) + f(0.5 * (cfg.lr_peak - cfg.lr_final)) * (
        f(1.0) + torch.cos(f(math.pi) * t))
    return torch.where(step < f(cfg.warmup_steps), warm, decay)


def state_axes(param_axes_tree: Any, cfg: AdamWConfig) -> AdamWState:
    """Logical axes of the optimizer state: each moment takes its
    parameter's axes (an int8 moment's payload the same; its per-row scale
    drops the last axis), so the state is sharded wherever the parameter
    is, with no cross-shard reshapes."""
    from repro_torch.distributed.sharding import is_axes

    def mom_axes(axes):
        if cfg.int8_moments:
            return Q8Leaf(q=axes, scale=axes[:-1] if len(axes) else axes)
        return axes

    leaves = tu.tree_map(mom_axes, param_axes_tree, is_leaf=is_axes)
    return AdamWState(step=(), m=leaves, v=leaves)


def init_state(params: Any, cfg: AdamWConfig) -> AdamWState:
    def zero_like(p):
        if cfg.int8_moments:
            return Q8Leaf(
                torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                torch.zeros(p.shape[:-1] if p.dim() else p.shape, dtype=_F32, device=p.device),
            )
        return torch.zeros(p.shape, dtype=_F32, device=p.device)

    step = torch.zeros((), dtype=torch.int32, device=tu.leaves(params)[0].device)
    # m and v are separate tensors: an update with donate=True writes into them
    return AdamWState(step=step, m=tu.tree_map(zero_like, params),
                      v=tu.tree_map(zero_like, params))


def _slices(x: torch.Tensor) -> list:
    """Index ranges along dim 0 that split a leaf of ≥ 2 dims into pieces of
    at most ``SLICE_ELEMS`` elements (one row at least); the whole leaf
    otherwise. An int8 moment's scales (one per last-dim row) split with it."""
    if x.dim() < 2 or x.numel() <= SLICE_ELEMS:
        return [...]
    rows = max(1, SLICE_ELEMS // (x.numel() // x.shape[0]))
    return [slice(i, i + rows) for i in range(0, x.shape[0], rows)]


def global_norm(tree: Any, *, splits: Any = None, ctx=None) -> torch.Tensor:
    """The f32 norm of every leaf. ``splits``: the tree's layout
    (``fsdp.Shard`` per leaf; None: every leaf whole) over the processes of
    ``ctx``: the split leaves' squares summed over the processes, the whole
    ones once."""
    leaves = tu.leaves(tree)
    layout = [fsdp.WHOLE] * len(leaves) if splits is None else tu.leaves(splits)
    whole = torch.zeros((), dtype=_F32, device=leaves[0].device)
    split = torch.zeros_like(whole)
    for leaf, s in zip(leaves, layout):
        for sl in _slices(leaf):
            sq = torch.sum(torch.square(leaf[sl].to(_F32)))
            if s.split:
                split = split + sq
            else:
                whole = whole + sq
    if splits is not None:
        whole = fsdp.allreduce_(split, ctx, "sum") + whole
    return torch.sqrt(whole)


@torch.no_grad()
def apply_updates(params: Any, grads: Any, state: AdamWState, cfg: AdamWConfig, *,
                  donate: bool = False, splits: Any = None, ctx=None):
    """One AdamW step with the global-norm grad clip. Returns (new_params,
    new_state). ``donate``: the caller gives up ``params`` and ``state``,
    and the new values are written into their tensors. ``splits``: the
    params' layout over the processes of ``ctx`` (``fsdp.Shard`` per leaf;
    None: every leaf whole), the params, grads and moments this process's
    slices."""
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    f = lambda x: _f32(x, lr)  # noqa: E731
    gnorm = global_norm(grads, splits=splits, ctx=ctx)
    clip = torch.minimum(f(1.0), f(cfg.grad_clip) / torch.clamp(gnorm, min=1e-12))
    b1c = f(1.0) - torch.pow(f(cfg.b1), step.to(_F32))
    b2c = f(1.0) - torch.pow(f(cfg.b2), step.to(_F32))
    eps = max(cfg.eps, 1e-5) if cfg.int8_moments else cfg.eps
    b1, nb1, b2, nb2 = f(cfg.b1), f(1 - cfg.b1), f(cfg.b2), f(1 - cfg.b2)
    wd, eps_t = f(cfg.weight_decay), f(eps)

    def upd(p, g, m_leaf, v_leaf, row_max=None):
        g = g.to(_F32) * clip
        if cfg.int8_moments:
            m = _q8_unpack(m_leaf.q, m_leaf.scale)
            v = torch.square(_q8_unpack(v_leaf.q, v_leaf.scale))
        else:
            m, v = m_leaf, v_leaf
        m = b1 * m + nb1 * g
        v = b2 * v + nb2 * g * g
        mhat = m / b1c
        vhat = v / b2c
        delta = mhat / (torch.sqrt(vhat) + eps_t) + wd * p.to(_F32)
        new_p = (p.to(_F32) - lr * delta).to(p.dtype)
        if cfg.int8_moments:
            return (new_p, Q8Leaf(*_q8_pack(m, row_max)),
                    Q8Leaf(*_q8_pack(torch.sqrt(v), row_max)))
        return new_p, m, v

    def sliced(p, g, m_leaf, v_leaf, s=None):
        """``upd`` over dim-0 slices, each written into the output leaves:
        the old ones (donate) or new ones of the same shapes. ``s``: the
        leaf's layout; split along its last dimension, each row's int8
        scale is the max over every process's part of the row."""
        row_max = None
        if cfg.int8_moments and s is not None and s.split and s.dim == p.dim() - 1:
            row_max = lambda a: fsdp.allreduce_(a, ctx, "max")  # noqa: E731
        upd_ = functools.partial(upd, row_max=row_max)
        parts = _slices(p)
        if len(parts) == 1 and not donate:
            return upd_(p, g, m_leaf, v_leaf)
        out = (p, m_leaf, v_leaf)
        if not donate:
            out = tu.tree_map(torch.empty_like, out)
        for sl in parts:
            new = upd_(*(tu.tree_map(lambda x: x[sl], a) for a in (p, g, m_leaf, v_leaf)))
            for dst, src in zip(tu.leaves(out), tu.leaves(new)):
                dst[sl].copy_(src)
        return out

    rest = () if splits is None else (splits,)
    out = tu.tree_map(sliced, params, grads, state.m, state.v, *rest, is_leaf=_is_q8)
    is_out = lambda x: type(x) is tuple  # noqa: E731
    pick = lambda i: tu.tree_map(lambda o: o[i], out, is_leaf=is_out)  # noqa: E731
    if donate:
        state.step.copy_(step)
        step = state.step
    return pick(0), AdamWState(step=step, m=pick(1), v=pick(2))


# --------------------------------------- int8 error-feedback grad compress --


class EFState(NamedTuple):
    """Error-feedback residual for int8 gradient compression."""

    residual: Any  # tree like grads, f32


def ef_init(params: Any) -> EFState:
    return EFState(residual=tu.tree_map(
        lambda p: torch.zeros(p.shape, dtype=_F32, device=p.device), params))


def compress_decompress(g: torch.Tensor, res: torch.Tensor, row_max=None):
    """Simulated int8 all-reduce payload with error feedback: the value the
    collective would move is int8; the quantization error is carried to
    the next step. Returns (g_hat, new_res). ``row_max``: as for
    :func:`_q8_pack`, the rows' max |x| made whole where a row is split
    over processes (a leaf split along its last dimension), so that the
    payload, scales and residual are those of the whole leaf."""
    x = g.to(_F32) + res
    q, scale = _q8_pack(x, row_max)
    x_hat = _q8_unpack(q, scale)
    return x_hat, x - x_hat


def compress_tree_(grads: Any, ef: EFState, *, splits: Any = None, ctx=None) -> Any:
    """:func:`compress_decompress` over every leaf, in dim-0 slices (rows
    stay whole, so the numbers are the whole leaf's): the new residual is
    written into ``ef``'s tensors, the compressed gradient into an f32
    gradient's own tensor (a new f32 one for a bf16 gradient). Returns the
    compressed gradient tree. ``splits``: the leaves' layout over the
    processes of ``ctx`` (``fsdp.Shard`` per leaf, this process's slices);
    a leaf split along its last dimension takes each row's max over every
    process's part of the row."""
    leaves = tu.leaves(grads)
    layout = [fsdp.WHOLE] * len(leaves) if splits is None else tu.leaves(splits)
    out = []
    for g, res, s in zip(leaves, tu.leaves(ef.residual), layout):
        row_max = None
        if s.split and s.dim == g.dim() - 1:
            row_max = lambda a: fsdp.allreduce_(a, ctx, "max")  # noqa: E731
        dst = g if g.dtype == _F32 else torch.empty(g.shape, dtype=_F32, device=g.device)
        for sl in _slices(g):
            g_hat, r = compress_decompress(g[sl], res[sl], row_max)
            dst[sl].copy_(g_hat)
            res[sl].copy_(r)
        out.append(dst)
    return tu.unflatten_like(grads, out)
