"""Sharded (ZeRO-3) training state over the processes of a job: the
counterpart of the JAX launcher's ``default_rules(mesh, fsdp=True)``, under
which GSPMD splits every parameter, gradient and optimizer moment with a
``d_model`` (``embed``) axis over the data devices and gathers each weight
where it is used.

Here the data axis is the process group: process ``r`` of ``n`` holds
slice ``r`` of each split leaf along its ``embed`` dimension, laid out as
``sharding.shard_shape`` gives it (a dimension that ``n`` does not divide
is rounded up, the last slice padded with zeros). Every other leaf (norms,
QKV biases, the step counter, the per-row scales of an int8 moment whose
parameter is split along its last dimension) stays whole in every process.

* :func:`local_specs` — a tree of :class:`Shard` (the split dimension, its
  whole size, this process's slice) for any axes tree and its shapes;
* :func:`shard_tree` / :func:`gather_tree` — whole ↔ local, for the
  initial state, checkpoints and tests;
* :func:`gather` — an autograd function whose forward all-gathers a local
  slice along its split dimension and whose backward reduce-scatters the
  gradient (SUM, then ÷ n, as ``collectives.allreduce_mean_`` averages);
* :class:`Gathered` — a params subtree whose split leaves are gathered when
  the model reads them, so only the layer being computed is whole (under
  remat its block, and so its gather, runs again in the backward).

The collectives go over ``collectives``' wire: under gloo (processes
sharing a card, or the CPU) staged through pinned host buffers, a large one
cut into pieces over several groups of the same processes, all in flight
at once; under NCCL on the card in one call. :data:`STATS` counts the bytes
each process sends and receives and, while :data:`TIMED` is set, the host
wall time of every gather and reduce-scatter (the card synchronised around
each).
"""
from __future__ import annotations

import dataclasses
import time
from collections.abc import Mapping
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch import tree as tu
from repro_torch.distributed import collectives as cl
from repro_torch.distributed import sharding as shd

DATA = "data"  # the mesh axis the processes span


@dataclasses.dataclass(frozen=True)
class Shard:
    """One leaf's layout: ``dim`` None for a leaf whole in every process;
    else the split dimension, its size in the whole leaf, and this
    process's rank among ``n``."""

    dim: Optional[int] = None
    whole: int = 0
    n: int = 1
    rank: int = 0

    @property
    def split(self) -> bool:
        return self.dim is not None

    @property
    def chunk(self) -> int:
        """The local size of the split dimension (padded)."""
        return -(-self.whole // self.n)

    @property
    def start(self) -> int:
        return min(self.rank * self.chunk, self.whole)

    @property
    def stop(self) -> int:
        return min(self.start + self.chunk, self.whole)

    def inner(self, lead: int) -> "Shard":
        """The layout of one entry of the ``lead`` leading (layer) axes."""
        if not self.split:
            return self
        if self.dim < lead:
            raise ValueError(f"split dimension {self.dim} is a leading layer axis")
        return dataclasses.replace(self, dim=self.dim - lead)


WHOLE = Shard()


def mesh_for(ctx) -> shd.MeshShape:
    """The launcher's mesh: every process on the data axis, a model axis of
    one (JAX's ``make_host_mesh(n_data=n_dev, n_model=1)``)."""
    return shd.MeshShape(("data", "model"), (ctx.n_hosts, 1))


def local_specs(axes_tree: Any, shapes_tree: Any, rules: Mapping, ctx) -> Any:
    """The :class:`Shard` of every leaf of ``shapes_tree`` (tensors, meta
    ones included) under ``rules``, from its logical axes in ``axes_tree``
    (the same structure, tuples of axis names as leaves). A dimension is
    split where its spec names the data axis and the job has more than one
    process; its local size is ``sharding.shard_shape``'s (rounded up)."""
    axes_l = tu.leaves(axes_tree, is_leaf=shd.is_axes)
    shapes = tu.leaves(shapes_tree)
    if len(axes_l) != len(shapes):
        raise ValueError(f"{len(axes_l)} axes leaves for {len(shapes)} tensors")
    out = []
    for axes, leaf in zip(axes_l, shapes):
        shape = tuple(leaf.shape)
        spec = shd.spec_for(axes, rules)
        dims = [i for i, part in enumerate(spec) if part is not None and ctx.n_hosts > 1
                and DATA in ((part,) if isinstance(part, str) else part)]
        if len(dims) > 1:
            raise ValueError(f"the data axis splits dimensions {dims} of one leaf ({axes})")
        if not dims:
            out.append(WHOLE)
            continue
        out.append(Shard(dim=dims[0], whole=shape[dims[0]], n=ctx.n_hosts, rank=ctx.host_id))
    return tu.unflatten_like(axes_tree, out, is_leaf=shd.is_axes)


def local_shape(shape, s: Shard) -> tuple:
    if not s.split:
        return tuple(shape)
    return tuple(s.chunk if i == s.dim else d for i, d in enumerate(shape))


def shard_leaf(x: torch.Tensor, s: Shard) -> torch.Tensor:
    """This process's slice of a whole leaf (a new tensor, zero-padded to
    the chunk); the leaf itself for a whole one."""
    if not s.split:
        return x
    out = x.new_zeros(local_shape(x.shape, s))
    n = s.stop - s.start
    if n:
        out.narrow(s.dim, 0, n).copy_(x.narrow(s.dim, s.start, n))
    return out


def shard_tree(tree: Any, specs: Any) -> Any:
    """Whole → this process's slices (``specs`` from :func:`local_specs`)."""
    return tu.tree_map(shard_leaf, tree, specs)


# ---------------------------------------------------------- the collectives --

STATS = {"gather_calls": 0, "gather_bytes": 0, "gather_ms": 0.0,
         "reduce_scatter_calls": 0, "reduce_scatter_bytes": 0, "reduce_scatter_ms": 0.0}
TIMED = False  # time each collective on the host clock, the card synchronised


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0.0 if k.endswith("_ms") else 0


def _sync(t: torch.Tensor) -> None:
    if TIMED and t.is_cuda:
        torch.cuda.synchronize(t.device)


def all_gather_leaf(local: torch.Tensor, s: Shard, ctx) -> torch.Tensor:
    """Every process's slice of a split leaf, joined: the whole leaf on
    ``local``'s device."""
    _sync(local)
    t0 = time.perf_counter()
    w = cl._to_wire(local.detach().contiguous(), ctx).view(-1)
    got = cl._empty_wire((s.n, w.numel()), w.dtype, ctx, local.is_cuda)
    cl._wait([dist.all_gather([got[r, a:b] for r in range(s.n)], w[a:b], group=g,
                              async_op=True)
              for (a, b), g in cl._pieces(w.numel(), w.element_size(), ctx)])
    out = torch.empty(tuple(s.whole if i == s.dim else d for i, d in enumerate(local.shape)),
                      dtype=local.dtype, device=local.device)
    for r in range(s.n):
        n = min(s.chunk, s.whole - r * s.chunk)
        if n > 0:
            out.narrow(s.dim, r * s.chunk, n).copy_(got[r].view(local.shape).narrow(s.dim, 0, n))
    _sync(out)
    STATS["gather_calls"] += 1
    STATS["gather_bytes"] += got.numel() * got.element_size()  # received, own slice included
    if TIMED:
        STATS["gather_ms"] += (time.perf_counter() - t0) * 1e3
    return out


def reduce_scatter_leaf(whole: torch.Tensor, s: Shard, ctx) -> torch.Tensor:
    """This process's slice of the mean over the processes of ``whole``
    (one gradient per process): SUM, then ÷ n."""
    _sync(whole)
    t0 = time.perf_counter()
    pad = s.chunk * s.n - s.whole
    if pad:
        shape = list(whole.shape)
        shape[s.dim] = pad
        whole = torch.cat([whole, whole.new_zeros(shape)], dim=s.dim)
    parts = whole.split(s.chunk, dim=s.dim)
    mine = local_shape(whole.shape, s)
    numel = parts[0].numel()
    buf = cl._empty_wire((s.n, numel), whole.dtype, ctx, whole.is_cuda)
    for r, part in enumerate(parts):
        buf[r].view(mine).copy_(part)
    out = cl._empty_wire((numel,), whole.dtype, ctx, whole.is_cuda)
    cl._wait([dist.reduce_scatter(out[a:b], [buf[r, a:b] for r in range(s.n)],
                                  op=dist.ReduceOp.SUM, group=g, async_op=True)
              for (a, b), g in cl._pieces(numel, out.element_size(), ctx)])
    out = out.view(mine).to(whole.device).div_(s.n)
    _sync(out)
    STATS["reduce_scatter_calls"] += 1
    STATS["reduce_scatter_bytes"] += buf.numel() * buf.element_size()  # sent, own part included
    if TIMED:
        STATS["reduce_scatter_ms"] += (time.perf_counter() - t0) * 1e3
    return out


def allreduce_(t: torch.Tensor, ctx, op: str) -> torch.Tensor:
    """``t`` summed (``op`` "sum") or maxed ("max") over the processes:
    the optimizer's norm and its int8 rows split over processes."""
    w = cl._all_reduce_(cl._to_wire(t.contiguous(), ctx), ctx,
                        dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX)
    return w.to(t.device)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, local, s: Shard, ctx):
        fctx.s, fctx.ctx = s, ctx
        return all_gather_leaf(local, s, ctx)

    @staticmethod
    def backward(fctx, grad):
        return reduce_scatter_leaf(grad, fctx.s, fctx.ctx), None, None


def gather(local: torch.Tensor, s: Shard, ctx) -> torch.Tensor:
    """The whole leaf; under autograd its gradient is reduce-scattered back
    to ``local``. A whole leaf is returned as it is."""
    if not s.split:
        return local
    return _Gather.apply(local, s, ctx)


def gather_tree(tree: Any, specs: Any, ctx) -> Any:
    """Local → whole, on every process (a collective per split leaf: every
    process walks the leaves in the same order)."""
    with torch.no_grad():
        return tu.tree_map(lambda x, s: all_gather_leaf(x, s, ctx) if s.split else x,
                           tree, specs)


class Gathered(Mapping):
    """A params subtree (nested dicts) that the model reads as the whole
    tree: a split leaf is gathered (:func:`gather`) each time it is read,
    a whole leaf comes back as it is."""

    def __init__(self, tree: dict, specs: dict, ctx):
        self._tree, self._specs, self._ctx = tree, specs, ctx

    def __getitem__(self, k):
        v, s = self._tree[k], self._specs[k]
        if isinstance(v, dict):
            return Gathered(v, s, self._ctx)
        return gather(v, s, self._ctx)

    def __iter__(self):
        return iter(self._tree)

    def __len__(self):
        return len(self._tree)


def whole_numel(t: torch.Tensor, s: Shard) -> int:
    """The element count of the whole leaf of which ``t`` is a slice."""
    return t.numel() // s.chunk * s.whole if s.split else t.numel()
