"""Multi-controller runtime: one context object owns the process topology.

Counterpart of ``repro/distributed/runtime.py`` over ``torch.distributed``.
Every layer that runs as one process of a job (the sharded evaluator, the
training launcher, checkpointing, the Supervisor) consumes a
:class:`DistributedContext` instead of asking ``torch.distributed`` ad hoc.
The context owns

* ``(host_id, n_hosts)`` — this process's rank and the world size,
* :attr:`~DistributedContext.device` — the card this process computes on
  (``cuda:(host_id % device_count)``), or the CPU when the caller asks,
* :attr:`~DistributedContext.backend` — the process group's backend, chosen
  by a rule (:func:`choose_backend`), never by catching a failure,
* the **striping contract**: :meth:`~DistributedContext.owned_shards` makes
  process ``i`` own shards ``i, i+P, i+2P, ...`` — the interleaving
  ``lm_data.batch_at(host_id, n_hosts)`` already uses for data.

The JAX package's meshes (``data_mesh``, ``stripe_mesh``, the global and
local device lists) have no counterpart: the process group is the stripe
mesh, one member per host, and every collective names it.

:func:`initialize` calls ``dist.init_process_group`` when launched as one
process of a job, with a timeout so that a crashed peer raises instead of
hanging; :func:`get_context` returns the installed context, or the identity
context ``(0, 1)`` when :func:`initialize` was never called.
"""
from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.backend import resolve_device

# how long a collective (and the rendezvous) waits for a peer before raising:
# a crashed peer fails the job instead of hanging it
TIMEOUT_S = 120.0


def choose_backend(n_processes: int, device_type: str) -> str:
    """``nccl`` when every process has a card of its own (the job computes
    on cards and there are at least as many visible cards as processes:
    rank ``r`` takes card ``r % count``, so no two ranks share one);
    ``gloo`` otherwise — on the CPU, and where processes share a card,
    which NCCL refuses. Under gloo, tensors on a card are staged through
    the host (``collectives``)."""
    if device_type == "cuda" and torch.cuda.device_count() >= n_processes:
        return "nccl"
    return "gloo"


@dataclass(frozen=True)
class DistributedContext:
    """This process's coordinates in the job. The identity context is
    ``(0, 1)`` with no process group (``backend`` None)."""

    host_id: int
    n_hosts: int
    backend: Optional[str] = None
    device_type: str = "cuda"

    def __post_init__(self):
        if not 0 <= self.host_id < self.n_hosts:
            raise ValueError(f"host_id {self.host_id} out of range for {self.n_hosts} hosts")

    @property
    def is_multi_controller(self) -> bool:
        return self.n_hosts > 1

    @property
    def device(self) -> torch.device:
        """The device this process computes on: ``cuda:(host_id % count)``,
        or the CPU for a context built with ``device="cpu"``. Raises where
        a card is asked for and none is present."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        resolve_device("cuda")
        return torch.device("cuda", self.host_id % torch.cuda.device_count())

    def owned_shards(self, n_shards: int) -> list:
        """Shard ids THIS host walks: ``host_id, host_id+P, ...``.
        Single-controller: every shard."""
        return list(range(self.host_id, n_shards, self.n_hosts))

    def validate_shard_count(self, n_shards: int) -> None:
        """Refuse shard counts that don't divide evenly across hosts: an
        uneven count skews ownership (some hosts walk one shard more), and
        ``n_shards < n_hosts`` leaves whole hosts idle while looking
        healthy."""
        if self.is_multi_controller and (n_shards < self.n_hosts
                                         or n_shards % self.n_hosts != 0):
            raise ValueError(
                f"n_shards={n_shards} does not stripe evenly over {self.n_hosts} hosts — "
                "pass a multiple of n_hosts so every host owns the same number of shards "
                "(shard s belongs to host s % n_hosts)"
            )

    def global_batch(self, batch: Any) -> Any:
        """Each host's rows stay its own: in PyTorch the cross-process sum
        of a data-parallel step is explicit (``collectives.allreduce_mean_``
        in ``trainer.make_train_step(ctx=)``), so the global batch is never
        assembled. The identity on the local rows."""
        return batch

    def barrier(self, tag: str) -> None:
        """Block until every host reaches this point (no-op single-host).
        ``tag`` names the point for a reader of the code; the group's
        timeout bounds the wait."""
        if self.is_multi_controller:
            if self.backend == "nccl":
                dist.barrier(device_ids=[self.device.index])
            else:
                dist.barrier()

    def describe(self) -> str:
        if self.backend is None:
            return f"host {self.host_id}/{self.n_hosts}"
        return f"host {self.host_id}/{self.n_hosts}, {self.backend}"


_CTX: Optional[DistributedContext] = None


def initialize(*, coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None, process_id: Optional[int] = None,
               device=None) -> DistributedContext:
    """Build (and install as process-wide) the runtime context.

    With a ``coordinator_address`` (``host:port`` of process 0, which hosts
    the rendezvous): joins the process group of ``num_processes`` as rank
    ``process_id``, over the backend :func:`choose_backend` picks for
    ``device`` (``None``: the card; ``"cpu"``). Without one: the identity
    context."""
    global _CTX
    dev_type = torch.device("cuda" if device is None else device).type
    if coordinator_address is None:
        _CTX = DistributedContext(0, 1, device_type=dev_type)
        return _CTX
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator address needs num_processes and process_id")
    backend = choose_backend(num_processes, dev_type)
    ctx = DistributedContext(process_id, num_processes, backend=backend, device_type=dev_type)
    if dev_type == "cuda":
        torch.cuda.set_device(ctx.device)
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    _CTX = ctx
    return _CTX


def get_context() -> DistributedContext:
    """The process-wide context: the one :func:`initialize` installed, or
    the identity context ``(0, 1)``."""
    return _CTX if _CTX is not None else DistributedContext(0, 1)


def shutdown() -> None:
    """Leave the process group (if this process joined one) and fall back
    to the identity context."""
    global _CTX
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _CTX = None
