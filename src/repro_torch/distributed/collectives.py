"""Collectives over ``torch.distributed``: counterpart of
``repro/distributed/collectives.py``.

* :func:`eval_stats_allgather` — the sharded-mAP reduction: every host's
  padded row of match records gathered to every host, the per-class
  ground-truth counts summed as integers. Exact: int32 and float32 travel
  as they are, bool as uint8.
* :func:`device_allgather` — the same reduction inside one process, over
  the rows placed one per visible card (the JAX package's single-process
  mesh gather).
* :func:`allreduce_mean_` — the data-parallel gradient reduction: a list
  of tensors summed over the hosts and divided by their count, in place,
  through a few flat buffers per dtype.
* :func:`int8_psum` — int8 error-feedback all-reduce: quantize per row,
  scatter rows with ``all_to_all_single``, sum locally, quantize again and
  all-gather (a quarter of the f32 bytes on the wire).
* :func:`hierarchical_psum` — reduce-scatter within a pod, all-reduce the
  partials across pods, all-gather within the pod.

The wire: under the gloo backend, tensors on a card are staged through
pinned host buffers (``_to_wire`` / ``_empty_wire``, copy back), which the
copies cross at the bus's rate where pageable memory takes a CPU copy;
under NCCL they travel from the card. A large transfer over every host
(``_pieces``) is cut into pieces of :data:`PIECE_BYTES` spread over
:data:`GLOO_GROUPS` groups of the same processes, all in flight at once
(one TCP stream each); under NCCL it is one call. gloo in the torch
versions this runs on implements every op and dtype used here
(``all_gather``, ``all_reduce``, ``reduce_scatter``, ``all_to_all_single``
on bool, uint8, int8, int32, float32, bfloat16).

* :func:`overlap_allgather_matmul` — ``x @ w`` with ``w`` row-sharded over
  a mesh axis: a ring of ``batch_isend_irecv`` transfers, each in flight
  while the matmul of the shard in hand runs.
"""
from __future__ import annotations

import datetime
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import runtime

# elements per flat buffer of allreduce_mean_: 256 MB of f32 a call
FLAT_ELEMS = 1 << 26
# under gloo a transfer larger than PIECE_BYTES is cut into pieces spread
# over GLOO_GROUPS groups of the same processes
PIECE_BYTES = 32 << 20
GLOO_GROUPS = 8
_GROUPS: dict = {}


def _empty_wire(shape, dtype, ctx, on_card: bool) -> torch.Tensor:
    """A buffer a collective fills: on this process's card under NCCL;
    under gloo on the host, pinned when the data comes from a card
    (``on_card``)."""
    if ctx.backend == "nccl":
        return torch.empty(shape, dtype=dtype, device=ctx.device)
    return torch.empty(shape, dtype=dtype, pin_memory=on_card)


def _to_wire(t: torch.Tensor, ctx) -> torch.Tensor:
    """The tensor a collective sends: on this process's card under NCCL;
    under gloo a host tensor as it is, a card's copied into a pinned host
    buffer (:func:`_empty_wire`)."""
    if ctx.backend == "nccl":
        return t.to(ctx.device)
    if not t.is_cuda:
        return t
    w = _empty_wire(t.shape, t.dtype, ctx, True)
    w.copy_(t)
    return w


def _groups(ctx) -> list:
    """The groups a transfer over every host is spread over: the default
    group and ``GLOO_GROUPS - 1`` more of the same processes, made at the
    first transfer that needs them (every process reaches it in the same
    order, since every process makes the same collectives)."""
    world = dist.group.WORLD
    if _GROUPS.get("world") is not world:
        timeout = datetime.timedelta(seconds=runtime.TIMEOUT_S)
        _GROUPS.update(world=world, groups=[None] + [
            dist.new_group(list(range(ctx.n_hosts)), timeout=timeout)
            for _ in range(GLOO_GROUPS - 1)])
    return _GROUPS["groups"]


def _pieces(numel: int, elsize: int, ctx) -> list:
    """([start, stop) element ranges, group) pairs of one transfer over
    every host: one piece under NCCL or when it fits :data:`PIECE_BYTES`,
    else pieces of that size over :func:`_groups`."""
    if ctx.backend != "gloo" or numel * elsize <= PIECE_BYTES:
        return [((0, numel), None)]
    groups, step = _groups(ctx), max(1, PIECE_BYTES // elsize)
    return [((a, min(a + step, numel)), groups[i % len(groups)])
            for i, a in enumerate(range(0, numel, step))]


def _wait(works: list) -> None:
    for wk in works:
        wk.wait()


def _all_reduce_(w: torch.Tensor, ctx, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``w`` (a contiguous wire tensor) reduced over every host in place,
    piece by piece (:func:`_pieces`), all pieces in flight at once."""
    flat = w.view(-1)
    _wait([dist.all_reduce(flat[a:b], op=op, group=g, async_op=True)
           for (a, b), g in _pieces(flat.numel(), flat.element_size(), ctx)])
    return w


def _all_gather_rows(t: torch.Tensor, ctx, group=None) -> torch.Tensor:
    """(r, ...) on every host -> (n·r, ...) in host order, on the host."""
    n = dist.get_world_size(group)
    w = _to_wire(t.contiguous(), ctx)
    out = [torch.empty_like(w) for _ in range(n)]
    dist.all_gather(out, w, group=group)
    return torch.cat(out).cpu()


def eval_stats_allgather(rows: dict, counts: np.ndarray, ctx) -> tuple[dict, np.ndarray]:
    """``rows``: {field: (1, cap) numpy array} — this host's padded match
    records (any equal-leading-dim dict); ``counts``: (1, C) int32 per-class
    ground-truth counts. Returns ({field: (n_hosts, cap)} gathered in host
    order, (C,) int32 total counts), the same on every host. bool fields
    travel as uint8 and come back bool."""
    g = {}
    for f, v in rows.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        wire = t.to(torch.uint8) if t.dtype == torch.bool else t
        got = _all_gather_rows(wire, ctx)
        g[f] = (got.bool() if t.dtype == torch.bool else got).numpy()
    total = _to_wire(torch.from_numpy(np.ascontiguousarray(counts, np.int32)), ctx)
    dist.all_reduce(total, op=dist.ReduceOp.SUM)
    return g, total.cpu().numpy()[0]


def device_allgather(rows: dict, counts: np.ndarray, n_devices: int) -> tuple[dict, np.ndarray]:
    """The single-process reduction over ``n_devices`` cards: row s of
    every ``rows`` field (k = ``n_devices`` rows) and of ``counts`` placed
    on card s, the rows gathered onto card 0 and the counts summed there
    (``torch.cuda.comm``). Same return as :func:`eval_stats_allgather`."""
    from torch.cuda import comm

    devs = list(range(n_devices))
    g = {}
    for f, v in rows.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        wire = t.to(torch.uint8) if t.dtype == torch.bool else t
        got = comm.gather([wire[s:s + 1].to(f"cuda:{s}") for s in devs], dim=0, destination=0)
        g[f] = (got.bool() if t.dtype == torch.bool else got).cpu().numpy()
    c = torch.from_numpy(np.ascontiguousarray(counts, np.int32))
    total = comm.reduce_add([c[s].to(f"cuda:{s}") for s in devs], destination=0)
    return g, total.cpu().numpy()


def allreduce_mean_(tensors: Sequence[torch.Tensor], ctx) -> int:
    """Replace every tensor by its mean over the hosts (SUM, then ÷
    ``n_hosts``), in place. The tensors are grouped by dtype and packed into
    flat buffers of at most :data:`FLAT_ELEMS` elements, one collective per
    buffer: a few calls, not one per tensor. Each tensor must be
    contiguous. Returns the bytes each host sent in this call."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t.view(-1))
    sent = 0
    for dtype, flats in by_dtype.items():
        total = sum(f.numel() for f in flats)
        dev = flats[0].device
        buf = torch.empty(min(total, FLAT_ELEMS), dtype=dtype, device=dev)
        pending, fill = [], 0  # (flat, start, length, offset in buf)

        def flush():
            nonlocal pending, fill, sent
            wire = _all_reduce_(_to_wire(buf[:fill], ctx), ctx)
            wire.div_(ctx.n_hosts)
            sent += wire.numel() * wire.element_size()
            out = wire.to(dev)
            for flat, start, length, off in pending:
                flat[start:start + length].copy_(out[off:off + length])
            pending, fill = [], 0

        for flat in flats:
            start = 0
            while start < flat.numel():
                length = min(flat.numel() - start, buf.numel() - fill)
                buf[fill:fill + length].copy_(flat[start:start + length])
                pending.append((flat, start, length, fill))
                fill += length
                start += length
                if fill == buf.numel():
                    flush()
        if fill:
            flush()
    return sent


def subgroups(ctx, n_pods: int) -> tuple:
    """(pod group, data group) of this host on a (pod, data) grid of
    ``n_pods`` × ``n_hosts / n_pods``, rank = pod · n_data + data (JAX's
    row-major mesh order). Every host must call it (``dist.new_group`` is
    collective); returns this host's two groups."""
    n = ctx.n_hosts
    if n % n_pods:
        raise ValueError(f"{n} hosts do not form {n_pods} equal pods")
    nd = n // n_pods
    mine = {}
    for p in range(n_pods):  # the data groups: one per pod
        g = dist.new_group(list(range(p * nd, (p + 1) * nd)))
        if ctx.host_id // nd == p:
            mine["data"] = g
    for d in range(nd):  # the pod groups: one per data index
        g = dist.new_group(list(range(d, n, nd)))
        if ctx.host_id % nd == d:
            mine["pod"] = g
    return mine["pod"], mine["data"]


def _q8(x: torch.Tensor, dim: int = -1):
    scale = x.abs().amax(dim=dim, keepdim=True) / 127.0
    q = torch.round(x / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return q, scale


def _rows(x: torch.Tensor, n: int) -> torch.Tensor:
    flat = x.reshape(-1)
    return torch.nn.functional.pad(flat, (0, (-flat.numel()) % n)).reshape(n, -1)


def _all_to_all_rows(t: torch.Tensor, ctx, group) -> torch.Tensor:
    """Row i of every member lands on member i: (n, c) -> (n, c), row j of
    the result from member j."""
    w = _to_wire(t.contiguous(), ctx)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=group)
    return out.to(t.device)


def int8_psum(ctx, group=None):
    """Returns ``f(x)`` that sums a replicated-shape f32 tensor over
    ``group`` (default: every host) while moving int8 on the wire:
    quantize per row → ``all_to_all_single`` → local f32 sum → quantize →
    all-gather → dequantize. Two rounding steps against the exact sum
    (error feedback at the optimizer absorbs them)."""
    n = dist.get_world_size(group)

    def f(x: torch.Tensor) -> torch.Tensor:
        q, s = _q8(_rows(x, n))
        qs = _all_to_all_rows(q, ctx, group)
        ss = _all_to_all_rows(s, ctx, group)
        local = (qs.float() * ss).sum(0)  # my row, summed over members
        q2, s2 = _q8(local[None])
        qg = _all_gather_rows(q2, ctx, group).to(x.device)
        sg = _all_gather_rows(s2, ctx, group).to(x.device)
        return (qg.float() * sg).reshape(-1)[: x.numel()].reshape(x.shape)

    return f


def hierarchical_psum(ctx, pod_group, data_group):
    """Returns ``f(x)``: the sum of a replicated-shape tensor over every
    host, as reduce-scatter within the pod (``data_group``) → all-reduce of
    the 1/n_data slice across pods (``pod_group``) → all-gather within the
    pod. The inter-pod hop moves 1/n_data of the bytes."""
    nd = dist.get_world_size(data_group)

    def f(x: torch.Tensor) -> torch.Tensor:
        mine = _all_to_all_rows(_rows(x, nd), ctx, data_group).sum(0)
        part = _to_wire(mine, ctx)
        dist.all_reduce(part, op=dist.ReduceOp.SUM, group=pod_group)
        out = _all_gather_rows(part[None], ctx, data_group).to(x.device)
        return out.reshape(-1)[: x.numel()].reshape(x.shape)

    return f



def overlap_allgather_matmul(mesh, axis_name: str = "model"):
    """Returns ``f(x, w)`` = ``x @ all_gather(w)`` for ``w`` row-sharded over
    ``axis_name`` of the DeviceMesh ``mesh`` (a DTensor sharded on dim 0
    there, or this rank's (k/n, out) shard) and ``x`` (m, k) whole on every
    rank. Step i multiplies the shard in hand — rank r holds shard
    (r − i) mod n — while the next one travels around the ring (send to
    r + 1, receive from r − 1). The n partial products are summed in shard
    order, so every rank returns the same bits."""
    group = mesh.get_group(axis_name)
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (r + 1) % n)
    prv = dist.get_global_rank(group, (r - 1) % n)

    def f(x: torch.Tensor, w) -> torch.Tensor:
        from torch.distributed.tensor import DTensor

        w_cur = (w.to_local() if isinstance(w, DTensor) else w).contiguous()
        k = w_cur.shape[0]
        gloo = dist.get_backend(group) == "gloo"
        parts: list = [None] * n
        for i in range(n):
            src = (r - i) % n
            reqs, w_nxt = [], None
            if i < n - 1:
                send = w_cur.cpu() if gloo else w_cur
                w_nxt = torch.empty_like(send)
                reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, nxt, group),
                                               dist.P2POp(dist.irecv, w_nxt, prv, group)])
            parts[src] = x[:, src * k:(src + 1) * k] @ w_cur
            for q in reqs:
                q.wait()
            if w_nxt is not None:
                w_cur = w_nxt.to(w_cur.device)
        return torch.stack(parts).sum(0)

    return f
