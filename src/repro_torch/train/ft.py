"""Fault tolerance for the training loop: a heartbeat file, a straggler
monitor, and a supervisor that restarts from the last committed checkpoint.

Counterpart of ``repro/train/ft.py``:

* :class:`Heartbeat` — a progress file (step + wall time), replaced
  atomically; a stalled heartbeat marks a hung or dead worker.
* :class:`Supervisor` — runs the step function, checkpoints every
  ``save_every`` steps and at the end, and on any exception restores the
  last committed step and carries on; it gives up after ``max_restarts``.
  Under a multi-controller context it saves through the striped protocol
  (``checkpoint.save(ctx=)``), only host 0 collects old steps, and a run
  that gives up names the host it failed on.
* :class:`StragglerMonitor` — an EWMA of step times; a step slower than
  ``threshold`` × the EWMA is flagged.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from repro_torch.distributed import runtime
from repro_torch.train import checkpoint as ckpt


class Heartbeat:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def beat(self, step: int, **extra):
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "time": time.time(), **extra}, f)
        os.replace(tmp, self.path)

    def last(self) -> Optional[dict]:
        try:
            with open(self.path) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def stalled(self, timeout_s: float) -> bool:
        last = self.last()
        return last is None or (time.time() - last["time"]) > timeout_s


@dataclass
class StragglerMonitor:
    """EWMA step-time tracker; flags steps slower than threshold × EWMA."""

    alpha: float = 0.1
    threshold: float = 2.0
    ewma: Optional[float] = None
    flagged: list = field(default_factory=list)

    def observe(self, step: int, duration_s: float) -> bool:
        is_straggler = self.ewma is not None and duration_s > self.threshold * self.ewma
        self.ewma = (
            duration_s
            if self.ewma is None
            else (1 - self.alpha) * self.ewma + self.alpha * duration_s
        )
        if is_straggler:
            self.flagged.append((step, duration_s, self.ewma))
        return is_straggler


@dataclass
class Supervisor:
    """Bounded-retry restart-from-last-good training supervisor.

    ``ctx``: the :class:`repro_torch.distributed.runtime.DistributedContext`
    (default: the process-wide one)."""

    ckpt_root: str
    max_restarts: int = 3
    save_every: int = 50
    keep: int = 3
    heartbeat: Optional[Heartbeat] = None
    straggler: StragglerMonitor = field(default_factory=StragglerMonitor)
    restarts: int = 0
    ctx: Any = None

    def _context(self):
        if self.ctx is None:
            self.ctx = runtime.get_context()
        return self.ctx

    def _give_up(self, e: Exception):
        """Re-raise with this host's coordinates prepended, keeping the
        original exception type where its constructor allows."""
        msg = (f"[{self._context().describe()}] training gave up after "
               f"{self.restarts - 1} restarts: {e}")
        try:
            exc = type(e)(msg)
        except Exception:  # noqa: BLE001 — exotic exception signature
            exc = RuntimeError(msg)
        raise exc from e

    def run(
        self,
        *,
        init_state: Callable[[], Any],
        state_template: Callable[[], Any],
        step_fn: Callable[[Any, int], Any],  # (state, step) -> state
        n_steps: int,
        specs: Any = None,
    ):
        """Run steps up to ``n_steps`` with checkpoint/restart: ``step_fn``
        raising is a node failure; the state is restored (into
        ``state_template()``'s structure, devices and dtypes) and the run
        continues until ``max_restarts`` is exhausted. ``specs``: the
        state's layout over the hosts (``fsdp.Shard`` per leaf), passed to
        every save and restore, as JAX's ``run(shardings=)``."""
        start = ckpt.latest_step(self.ckpt_root)
        if start is not None:
            state, start = ckpt.restore(self.ckpt_root, state_template(), specs=specs)
            start += 1
        else:
            state, start = init_state(), 0

        step = start
        while step < n_steps:
            try:
                t0 = time.time()
                state = step_fn(state, step)
                self.straggler.observe(step, time.time() - t0)
                if self.heartbeat:
                    self.heartbeat.beat(step)
                if (step + 1) % self.save_every == 0 or step + 1 == n_steps:
                    ctx = self._context()
                    ckpt.save(self.ckpt_root, step, state, ctx=ctx, specs=specs)
                    if ctx.host_id == 0:
                        ckpt.gc_old(self.ckpt_root, keep=self.keep)
                step += 1
            except Exception as e:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    self._give_up(e)
                # settle in-flight async saves before picking the restore
                # point; a failed write re-raises here
                ckpt.wait_pending()
                last = ckpt.latest_step(self.ckpt_root)
                if last is None:
                    state, step = init_state(), 0
                else:
                    state, last = ckpt.restore(self.ckpt_root, state_template(), specs=specs)
                    step = last + 1
        # the run is done once its checkpoints are committed: join every
        # async writer and re-raise the first failed write
        ckpt.wait_pending()
        return state
