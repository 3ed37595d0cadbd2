"""Sharded embedding lookup and LM head over a ``DeviceMesh``.

Counterpart of ``repro/distributed/embedding.py``. The table (vocab ×
d_model) is a DTensor laid out by the rules (vocab → 'model', embed →
'data' under fsdp). Written per shard, the gradients arrive SHARDED by
construction — on every rank the table's gradient has the table's layout,
and no rank ever holds the whole (vocab × d_model) gradient:

  lookup:  each vocab shard all-gathers its slice's d_model shards over
           'data' (small: V/n_model × D), serves the tokens it owns, and
           the rows are summed over 'model'. Backward: a scatter-add into
           the shard's rows, then each rank keeps the d_model columns it
           owns of the sum over 'data' (a reduce-scatter).
  lm_head: gather W's d_model shards over 'data', a local (D, V/n_model)
           matmul → logits vocab-sharded, nothing summed. Backward: dW as
           above; dx summed over 'model'.

The route is local shards with explicit ``torch.autograd.Function`` s
around each collective, not DTensor's operator rules: the rules would
redistribute the gathered-row product as they see fit (a gather into a
vocab-sharded table is not one of their sharding strategies), while the
point here is which collective each pass runs. DTensor carries the layout
at the edges only: the table and weight come in as DTensors, their
gradients come back as DTensors of the same placements (``to_local``'s
backward), and the outputs leave as DTensors.

Without a mesh context (``sharding.use_rules(rules, mesh=device_mesh)``)
both fall back to the plain gather and matmul, as JAX's do outside a mesh.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as shd


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """The tensor a collective of ``group`` takes: on the host under gloo."""
    return t.cpu() if dist.get_backend(group) == "gloo" else t


class _GatherCols(torch.autograd.Function):
    """Forward: all-gather of the local shard along ``dim`` over ``group``.
    Backward: the gradient summed over ``group``, this rank's slice kept
    (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, dim: int, group):
        ctx.dim, ctx.group = dim, group
        n = dist.get_world_size(group)
        w = _wire(x.contiguous(), group)
        parts = [torch.empty_like(w) for _ in range(n)]
        dist.all_gather(parts, w, group=group)
        return torch.cat(parts, dim=dim).to(x.device)

    @staticmethod
    def backward(ctx, g):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        w = _wire(g.contiguous(), ctx.group)
        dist.all_reduce(w, op=dist.ReduceOp.SUM, group=ctx.group)
        return w.chunk(n, dim=ctx.dim)[r].to(g.device).contiguous(), None, None


class _SumReplicated(torch.autograd.Function):
    """Forward: the sum over ``group`` (every rank then holds it).
    Backward: the identity — each rank's term gets the replicated
    output's gradient."""

    @staticmethod
    def forward(ctx, x, group):
        w = _wire(x.contiguous(), group)
        dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group)
        return w.to(x.device)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToGroup(torch.autograd.Function):
    """Forward: the identity (an input every rank of ``group`` holds).
    Backward: the gradients summed over ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        w = _wire(g.contiguous(), ctx.group)
        dist.all_reduce(w, op=dist.ReduceOp.SUM, group=ctx.group)
        return w.to(g.device), None


def _mesh_rules(table):
    """(mesh, rules) when the sharded path applies, else (None, None)."""
    from torch.distributed.tensor import DTensor

    mesh, rules = shd.current_mesh(), shd.current_rules()
    if (mesh is None or rules is None or isinstance(mesh, shd.MeshShape)
            or "model" not in shd.axis_names(mesh) or not isinstance(table, DTensor)
            or rules.get("vocab") is None):
        return None, None
    return mesh, rules


def _local_rows(x, mesh):
    """(this rank's rows of ``x``, the batch placement on each mesh dim):
    a DTensor gives its local shard, a plain tensor is every row."""
    from torch.distributed.tensor import DTensor, Replicate

    names = shd.axis_names(mesh)
    if isinstance(x, DTensor):
        return x.to_local(), list(x.placements)
    return x, [Replicate() for _ in names]


def _check_layout(t, spec, mesh, what):
    want = shd.to_placements(spec, mesh)
    if tuple(t.placements) != want:
        raise ValueError(f"{what} is laid out {tuple(t.placements)}; the rules give {want}")


def embed_lookup(tokens, table):
    """tokens (B, S) integers, table (V, D) → (B, S, D).

    Sharded path under ``use_rules(rules, mesh=device_mesh)`` with the
    table a DTensor laid out (vocab, embed) by the rules: returns a
    DTensor replicated over 'model' (and row-sharded where ``tokens`` is a
    row-sharded DTensor). Otherwise the plain gather."""
    from torch.distributed.tensor import DTensor

    mesh, rules = _mesh_rules(table)
    if mesh is None or table.shape[0] % mesh.size(shd.axis_names(mesh).index(rules["vocab"])):
        return table[tokens]
    v_axis, d_axis = rules["vocab"], rules.get("embed")
    _check_layout(table, (v_axis, d_axis), mesh, "the table")
    tok, placements = _local_rows(tokens, mesh)
    tab = table.to_local()  # (V/nv, D/nd): its gradient comes back in the table's layout
    if d_axis is not None:
        tab = _GatherCols.apply(tab, 1, mesh.get_group(d_axis))
    v_shard = tab.shape[0]
    rel = tok.long() - mesh.get_local_rank(v_axis) * v_shard
    ok = (rel >= 0) & (rel < v_shard)
    rows = tab[rel.clamp(0, v_shard - 1)] * ok[..., None].to(tab.dtype)
    out = _SumReplicated.apply(rows, mesh.get_group(v_axis))
    return DTensor.from_local(out, mesh, placements, run_check=False)


def lm_head(x, w):
    """x (B, S, D) @ w (D, V) → logits (B, S, V) f32.

    Sharded path (w a DTensor laid out (embed, vocab) by the rules): the
    logits come back vocab-sharded over 'model', a DTensor; x's gradient
    is summed over 'model'. Otherwise the plain product, cast to f32."""
    from torch.distributed.tensor import DTensor, Shard

    mesh, rules = _mesh_rules(w)
    names = None if mesh is None else shd.axis_names(mesh)
    if mesh is None or w.shape[1] % mesh.size(names.index(rules["vocab"])):
        return (x @ w).float()
    v_axis, d_axis = rules["vocab"], rules.get("embed")
    _check_layout(w, (d_axis, v_axis), mesh, "the LM head")
    xl, placements = _local_rows(x, mesh)
    xl = _CopyToGroup.apply(xl, mesh.get_group(v_axis))
    wl = w.to_local()
    if d_axis is not None:
        wl = _GatherCols.apply(wl, 0, mesh.get_group(d_axis))
    placements[names.index(v_axis)] = Shard(xl.dim() - 1)
    return DTensor.from_local((xl @ wl).float(), mesh, placements, run_check=False)
