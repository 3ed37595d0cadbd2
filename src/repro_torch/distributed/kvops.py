"""Sequence-sharded KV-cache writes over a ``DeviceMesh``.

Counterpart of ``repro/distributed/kvops.py``. A decode step writes a few
token rows at position ``pos`` of a cache whose sequence axis is sharded
over the rules' ``kv_seq`` mesh axis (a DTensor). Each rank of that axis
compares the written rows with its own range and writes only the rows that
fall in it, in place, in its local shard: no rank touches another's rows,
and nothing the size of the cache is copied or masked.

Falls back to the plain indexed write (in place, as the port's caches are
written) with no mesh context, a per-slot ``pos`` (not a scalar), a cache
that is not a DTensor, or a sequence the ``kv_seq`` axis does not divide.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import sharding as shd


def _scalar(pos):
    if isinstance(pos, torch.Tensor):
        return int(pos) if pos.dim() == 0 else None
    return int(pos)


def cache_write(buf, val, layer, pos):
    """buf (L, B, S, ...) with S possibly sharded; val (B, s_new, ...);
    ``layer`` the layer index; ``pos`` the write offset. Writes
    ``buf[layer, :, pos:pos + s_new] = val`` and returns ``buf``."""
    from torch.distributed.tensor import DTensor, Shard

    mesh, rules = shd.current_mesh(), shd.current_rules()
    s_new = val.shape[1]
    p = _scalar(pos)
    seq_axis = None if rules is None else rules.get("kv_seq")
    if (mesh is None or isinstance(mesh, shd.MeshShape) or p is None
            or not isinstance(buf, DTensor) or seq_axis not in shd.axis_names(mesh)):
        if isinstance(buf, DTensor):
            raise ValueError("a DTensor cache is written under use_rules(rules, mesh=...) "
                             "with a scalar pos")
        buf[int(layer), :, pos:pos + s_new] = val.to(buf.dtype)
        return buf
    dim = shd.axis_names(mesh).index(seq_axis)
    n, s = mesh.size(dim), buf.shape[2]
    if s % n or buf.placements[dim] != Shard(2):
        raise ValueError(f"the cache's sequence ({s}) is not split evenly over "
                         f"{seq_axis!r}: placements {buf.placements}")
    local = buf.to_local()
    v = val.to_local() if isinstance(val, DTensor) else val
    rows = local.shape[1]
    for d, pl in enumerate(buf.placements):  # a whole val into a batch-sharded cache
        if pl == Shard(1) and v.shape[0] != rows:
            v = v[mesh.get_local_rank(d) * rows:(mesh.get_local_rank(d) + 1) * rows]
    local_len = s // n
    lo = mesh.get_local_rank(dim) * local_len
    a, b = max(p, lo), min(p + s_new, lo + local_len)
    if a < b:  # this rank owns rows [a, b) of the write
        local[int(layer), :, a - lo:b - lo] = v[:, a - p:b - p].to(local.dtype)
    return buf
