"""Operation-level cost accounting of a step run on ``meta`` tensors.

Counterpart of ``repro/launch/hlo_cost.py``. HLO text has no meaning in
PyTorch; what a torch step executes is its sequence of ATen operations, so
this module counts them as they are dispatched — on the ``meta`` device,
where they cost nothing and allocate nothing — with a
``TorchDispatchMode``:

* **FLOPs**: exact for mm / bmm / addmm / baddbmm / convolution /
  scaled-dot-product attention (and their backward) through
  ``torch.utils.flop_counter``'s formulas (``product_flops``); one per
  output element for pointwise ops and one per input element for
  reductions and softmax, the convention of ``hlo_cost._ELEMWISE_FLOP_OPS``.
* **bytes**: operands plus result of every operation. The eager operation
  is the memory-traffic boundary here, as XLA's fusion is in JAX, so —
  unlike ``hlo_cost``'s "perfectly fused" elementwise chains — every
  eager elementwise pass pays its bytes. Views move nothing and count 0;
  an ``empty`` allocates without traffic.
* **collective bytes by kind**: the calls the step makes to
  ``repro_torch.distributed.collectives``, recorded by stand-ins
  (:func:`counting_collectives`) that move nothing: an all-reduce's bytes
  are its tensors' bytes (the result, as ``hlo_cost`` counts a
  collective's result).

Python loops are executed, so a scanned layer stack, microbatches or
chunked attention are counted as many times as they run — no trip-count
correction. :func:`extrapolate` instead counts a model at two depths:
per-layer work is the same at every depth, so FLOPs and collective bytes
extrapolate exactly; bytes within a fraction of a percent in a train
step, where autograd copies an arriving gradient into its leaf or takes it
as it is depending on reference counts (tests/test_torch_op_cost.py holds
both against the full walk).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

# one flop per INPUT element (a reduction, softmax's passes)
_REDUCTIONS = {
    aten.sum, aten.mean, aten.amax, aten.amin, aten.max, aten.min, aten.prod,
    aten._softmax, aten._log_softmax, aten.logsumexp, aten.cumsum, aten.var_mean,
    aten.linalg_vector_norm, aten.norm, aten.any, aten.all, aten.argmax, aten.topk,
    aten.sort,
}
_NO_TRAFFIC = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
               aten.new_empty_strided}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    product_flops: float = 0.0  # matmul / conv / attention: the exact part
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_kind: dict = dataclasses.field(default_factory=dict)
    coll_calls: int = 0
    ops: int = 0

    def add_collective(self, kind: str, nbytes: float) -> None:
        self.coll_bytes += nbytes
        self.coll_by_kind[kind] = self.coll_by_kind.get(kind, 0.0) + nbytes
        self.coll_calls += 1

    def __add__(self, other: "Cost") -> "Cost":
        kinds = dict(self.coll_by_kind)
        for k, v in other.coll_by_kind.items():
            kinds[k] = kinds.get(k, 0.0) + v
        return Cost(self.flops + other.flops, self.product_flops + other.product_flops,
                    self.bytes + other.bytes, self.coll_bytes + other.coll_bytes, kinds,
                    self.coll_calls + other.coll_calls, self.ops + other.ops)

    def scaled(self, m: float) -> "Cost":
        return Cost(self.flops * m, self.product_flops * m, self.bytes * m,
                    self.coll_bytes * m, {k: v * m for k, v in self.coll_by_kind.items()},
                    int(round(self.coll_calls * m)), int(round(self.ops * m)))

    def as_dict(self) -> dict:
        """The keys of ``hlo_cost.analyze_text``'s result, and the rest."""
        return {"flops": self.flops, "bytes": self.bytes,
                "collective_bytes": self.coll_bytes,
                "collective_by_kind": dict(self.coll_by_kind),
                "product_flops": self.product_flops, "collective_calls": self.coll_calls,
                "ops": self.ops}


def _tensors(tree) -> list:
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)

    walk(tree)
    return out


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class CostMode(TorchDispatchMode):
    """Counts every ATen operation dispatched inside it into ``self.cost``."""

    def __init__(self, cost: Cost | None = None):
        super().__init__()
        self.cost = cost if cost is not None else Cost()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = self.cost
        c.ops += 1
        packet = func.overloadpacket
        if func.is_view or packet in _NO_TRAFFIC:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        c.bytes += _nbytes(ins) + _nbytes(outs)
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            c.flops += f
            c.product_flops += f
        elif packet in _REDUCTIONS:
            c.flops += sum(t.numel() for t in ins[:1])
        elif torch.Tag.pointwise in func.tags:
            c.flops += sum(t.numel() for t in outs)
        return out


@contextlib.contextmanager
def counting_collectives(cost: Cost):
    """Replace the collectives of :mod:`repro_torch.distributed.collectives`
    a train step calls (the data-parallel mean, the int8 sum) with
    stand-ins that record their kind and bytes in ``cost`` and move
    nothing (the tensors keep their values; on ``meta`` there are none)."""
    from repro_torch.distributed import collectives as C

    def allreduce_mean_(tensors, ctx):
        n = _nbytes(list(tensors))
        cost.add_collective("all-reduce", n)
        return n

    def int8_psum(ctx, group=None):
        def f(x):
            cost.add_collective("all-to-all", x.numel())  # int8 rows out
            cost.add_collective("all-gather", x.numel())  # int8 sums back
            return x.clone()
        return f

    stand_ins = {"allreduce_mean_": allreduce_mean_, "int8_psum": int8_psum}
    saved = {k: getattr(C, k) for k in stand_ins}
    for k, v in stand_ins.items():
        setattr(C, k, v)
    try:
        yield cost
    finally:
        for k, v in saved.items():
            setattr(C, k, v)


def count(fn: Callable, *args, **kwargs) -> tuple:
    """(fn's result, its :class:`Cost`): ``fn(*args, **kwargs)`` run under
    :class:`CostMode` with the collectives counted."""
    cost = Cost()
    with counting_collectives(cost), CostMode(cost):
        out = fn(*args, **kwargs)
    return out, cost


def extrapolate(cost_at: Callable[[int], Cost], depth: int) -> Cost:
    """The cost at ``depth`` repeated units from the costs at 1 and 2
    units: ``c(1) + (depth − 1)·(c(2) − c(1))``, exact when every unit does
    the same work (a model's stacked layers)."""
    if depth <= 2:
        return cost_at(depth)
    c1, c2 = cost_at(1), cost_at(2)
    return c1 + (c2 + c1.scaled(-1)).scaled(depth - 1)
