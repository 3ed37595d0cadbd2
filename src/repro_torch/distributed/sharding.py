"""Logical-axis sharding rules → per-dimension mesh-axis specs.

Counterpart of ``repro/distributed/sharding.py``. Every model names the
axes of its parameters, caches and inputs LOGICALLY (``param_axes``,
``cache_axes``, ``batch_axes``); one rules table per deployment maps them
onto mesh axes. A spec is a tuple with one part per tensor dimension: None
(replicated), a mesh axis name, or a tuple of them — what JAX's
``PartitionSpec`` holds, so the two compare part for part.

A mesh is either a :class:`MeshShape` (axis names and sizes, no devices:
what the dry-run needs to lay out 256 or 512 devices it does not have) or
a ``torch.distributed.device_mesh.DeviceMesh`` (what the sharded ops of
:mod:`repro_torch.distributed.embedding` and ``kvops`` run over).

:func:`shard_shape` gives a leaf's per-device shape under a spec (the
dry-run's static bytes), :func:`to_placements` the DTensor placements of
a spec on a ``DeviceMesh``. :func:`constrain` and :func:`constrain_act`
are the identity on a plain tensor, as JAX's are outside a mesh; the
port's models never run inside one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Mapping, Optional, Sequence

from repro_torch import tree as tu


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh without devices: its axis names and their sizes."""

    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def axis_names(mesh) -> tuple:
    if isinstance(mesh, MeshShape):
        return tuple(mesh.axis_names)
    return tuple(mesh.mesh_dim_names)


def axis_size(mesh, name: str) -> int:
    if isinstance(mesh, MeshShape):
        return int(mesh.shape[name])
    return int(mesh.size(axis_names(mesh).index(name)))


# logical axis -> mesh axis (or tuple of mesh axes, or None = replicated)
# 'pod' composes with 'data' for the batch so the multi-pod mesh shards
# batch hierarchically.
def default_rules(mesh, *, fsdp: bool = False, kv_seq_shard: bool = True) -> dict:
    """The one rules table, JAX's entry for entry:

    * ``kv_seq`` → 'model': decode-time KV caches are sharded along the
      sequence (GQA-safe: 8 KV heads cannot split 16 ways), which divides
      the per-device KV bytes by the model-axis size;
    * ``opt_state`` → every axis (ZeRO across the whole mesh);
    * ``embed`` under fsdp → 'data' (ZeRO-3 weight sharding).
    """
    axes = axis_names(mesh)
    batch = tuple(a for a in ("pod", "data") if a in axes)
    batch_axis = batch if len(batch) > 1 else (batch[0] if batch else None)
    all_axes = tuple(a for a in ("pod", "data", "model") if a in axes)
    return {
        "batch": batch_axis,
        "seq": None,
        "embed": "data" if fsdp else None,
        "embed2": None,
        "act_embed": None,
        "act_seq": "model",
        "heads": "model",
        "kv_heads": None if kv_seq_shard else "model",
        "kv_seq": "model" if kv_seq_shard else None,
        "qkv": "model",
        "mlp": "model",
        "vocab": "model",
        "experts": "model",
        "expert_mlp": None,
        "expert_cap": None,
        "layers": None,
        "conv_k": None,
        "ssm_heads": "model",
        "ssm_state": None,
        "spatial_blocks": "model",
        "channels": None,
        "opt_state": all_axes,
    }


def spec_for(axes: Sequence[Optional[str]], rules: Mapping[str, Any]) -> tuple:
    """Logical axis names → spec via the rules table."""
    return tuple(None if a is None else rules.get(a) for a in axes)


def is_axes(x) -> bool:
    """A leaf of an axes tree: a tuple of axis names (or None)."""
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None))) for a in x)


def is_spec(x) -> bool:
    """A leaf of a spec tree: a tuple of parts, each None, a mesh axis name
    or a tuple of them."""
    return isinstance(x, tuple) and all(
        p is None or isinstance(p, str) or (isinstance(p, tuple) and all(
            isinstance(a, str) for a in p)) for p in x)


def _part_size(mesh, part) -> int:
    if part is None:
        return 1
    if isinstance(part, str):
        return axis_size(mesh, part)
    n = 1
    for p in part:
        n *= axis_size(mesh, p)
    return n


def sanitize_spec(mesh, spec: tuple, shape) -> tuple:
    """Drop partitions that do not evenly divide their dimension:
    replicating a small dim is always legal, the big tensors keep their
    sharding."""
    return tuple(
        None if part is not None and (i >= len(shape) or shape[i] % _part_size(mesh, part))
        else part
        for i, part in enumerate(spec)
    )


def _shape_of(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def tree_specs(axes_tree: Any, rules: Mapping[str, Any]) -> Any:
    """An axes tree → the same tree of specs."""
    return tu.tree_map(lambda axes: spec_for(axes, rules), axes_tree, is_leaf=is_axes)


def tree_specs_for(mesh, axes_tree: Any, shapes_tree: Any, rules: Mapping[str, Any]) -> Any:
    """Like :func:`tree_specs`, each spec sanitized against its leaf's
    shape (``shapes_tree``: the matching tree of tensors, ``meta`` ones
    included). The counterpart of JAX's ``tree_shardings_for``."""
    specs, shapes = tu.leaves(axes_tree, is_leaf=is_axes), tu.leaves(shapes_tree)
    if len(specs) != len(shapes):
        raise ValueError(f"{len(specs)} axes leaves for {len(shapes)} tensors")
    it = iter(shapes)
    return tu.tree_map(lambda axes: sanitize_spec(mesh, spec_for(axes, rules),
                                                  _shape_of(next(it))),
                       axes_tree, is_leaf=is_axes)


def shard_shape(shape, spec: tuple, mesh) -> tuple:
    """The per-device shape of a tensor of ``shape`` laid out by ``spec``
    (a dimension a partition does not divide is rounded up, as the last
    device's padded shard)."""
    out = list(shape)
    for i, part in enumerate(spec):
        if part is not None and i < len(out):
            n = _part_size(mesh, part)
            out[i] = -(-out[i] // n)
    return tuple(out)


def to_placements(spec: tuple, device_mesh) -> tuple:
    """DTensor placements of ``spec`` on ``device_mesh``: ``Shard(d)`` on
    every mesh dimension that shards tensor dimension d, ``Replicate()`` on
    the others. A mesh axis may shard one tensor dimension only."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(device_mesh)
    out: list = [Replicate() for _ in names]
    for dim, part in enumerate(spec):
        for a in (() if part is None else (part,) if isinstance(part, str) else part):
            i = names.index(a)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {a!r} shards two dimensions in {spec}")
            out[i] = Shard(dim)
    return tuple(out)


def constrain(x, axes: Sequence[Optional[str]], rules: Mapping[str, Any]):
    """The layout hint by logical names: the identity on a plain tensor (as
    JAX's ``with_sharding_constraint`` is outside a mesh); a DTensor is
    redistributed to the spec's placements over its own mesh."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    spec = sanitize_spec(x.device_mesh, spec_for(axes, rules), tuple(x.shape))
    return x.redistribute(x.device_mesh, to_placements(spec, x.device_mesh))


# ------------------------------------------------ the deployment's rules --
# use_rules() installs a rules table (and the DeviceMesh the sharded ops
# run over) for the code inside it; constrain_act() and the sharded ops
# read it, so model code never imports mesh state.

_ACT = threading.local()


@contextlib.contextmanager
def use_rules(rules: Mapping[str, Any], mesh=None):
    prev, prev_mesh = getattr(_ACT, "rules", None), getattr(_ACT, "mesh", None)
    _ACT.rules, _ACT.mesh = rules, mesh
    try:
        yield
    finally:
        _ACT.rules, _ACT.mesh = prev, prev_mesh


def current_rules():
    return getattr(_ACT, "rules", None)


def current_mesh():
    return getattr(_ACT, "mesh", None)


def constrain_act(x, axes: Sequence[Optional[str]]):
    """:func:`constrain` under the installed rules; the identity without
    them, and on a dimension of size 1 (a decode step), where the hint
    would be dropped in JAX too."""
    rules = current_rules()
    if rules is None:
        return x
    for dim, part in enumerate(spec_for(axes, rules)):
        if part is not None and x.shape[dim] == 1:
            return x
    return constrain(x, axes, rules)


def num_devices(mesh) -> int:
    n = 1
    for a in axis_names(mesh):
        n *= axis_size(mesh, a)
    return n
