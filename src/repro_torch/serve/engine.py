"""The serving engine: a slot pool with continuous batching and admission
control. Counterpart of ``repro/serve/engine.py``, detector side.

:class:`Engine` owns the queue, the slot occupancy and the run loop, and
leaves the model work to an :class:`EngineAPI` backend. The port's backend
is :class:`repro_torch.serve.detector.DetectorEngineCore`: slot i is one
frame stream, and each step advances every active stream by one frame as
one megabatch. The JAX package's ``LMEngineCore`` (token serving) is not
ported yet (ROADMAP.md, queue 1).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Protocol, runtime_checkable


@dataclass
class Request:
    """An LM token request (the shape the JAX package's LM core serves)."""

    rid: int
    prompt: list  # token ids
    max_new_tokens: int = 32
    eos_id: int = -1  # -1 = never
    out: list = field(default_factory=list)
    done: bool = False


# ------------------------------------------------------ admission control --


@dataclass(frozen=True)
class AdmissionPolicy:
    """Backpressure contract for :meth:`Engine.submit`.

    ``max_queue`` bounds the number of queued (not yet admitted) requests;
    ``None`` leaves the queue unbounded. When the queue is full,
    ``on_full`` decides:

    * ``"reject"`` — refuse the new request;
    * ``"shed-oldest"`` — evict queued requests from the front until the
      new one fits (the freshest frames win).

    Either way the caller gets a :class:`SubmitResult`, and every refused or
    evicted request lands in ``Engine.rejected`` with ``done=False``."""

    max_queue: Optional[int] = None
    on_full: str = "reject"

    def __post_init__(self):
        if self.on_full not in ("reject", "shed-oldest"):
            raise ValueError(f"on_full={self.on_full!r}: want 'reject' or 'shed-oldest'")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")


@dataclass(frozen=True)
class SubmitResult:
    """Outcome of one :meth:`Engine.submit`: truthy iff accepted;
    ``reason`` says why not (``"queue-full"`` / ``"invalid: ..."``), or
    ``"shed-oldest"`` with the evicted requests in ``shed``."""

    accepted: bool
    reason: Optional[str] = None
    shed: tuple = ()

    def __bool__(self) -> bool:
        return self.accepted


class EngineRunResult(list):
    """:meth:`Engine.run`'s result: the finished requests (it is a list)
    plus ``status`` — ``"drained"`` or ``"truncated"`` (``max_steps`` ran
    out with work left) — and ``pending``: the in-flight occupants, then
    the queued tail, each with ``done=False``."""

    def __init__(self, finished, status: str, pending):
        super().__init__(finished)
        self.status = status
        self.pending = list(pending)

    @property
    def drained(self) -> bool:
        return self.status == "drained"


@runtime_checkable
class EngineAPI(Protocol):
    """Backend contract for the slot/admission loop. ``admit`` loads one
    request into a slot; ``step`` advances every active slot by one unit of
    work and returns the slot indices that finished; ``n_slots`` sizes the
    pool."""

    n_slots: int

    def admit(self, req: Any, slot_idx: int) -> None: ...

    def step(self, active: dict[int, Any]) -> list[int]: ...


def _resolve_core(cfg, params, *, n_slots: int, device=None) -> EngineAPI:
    from repro_torch.models.snn_yolo import SNNDetConfig, compile_detector
    from repro_torch.serve.detector import CompiledDetector, DetectorEngineCore

    if isinstance(cfg, CompiledDetector):  # a compiled handle, on its own device
        return DetectorEngineCore(cfg, n_slots=n_slots)
    if isinstance(cfg, SNNDetConfig):
        p, bn = params if isinstance(params, tuple) else (params, None)
        return DetectorEngineCore(compile_detector(cfg, p, bn, device=device),
                                  n_slots=n_slots)
    raise TypeError(
        f"don't know how to serve {type(cfg).__name__}: pass an SNNDetConfig, a "
        "CompiledDetector, or an explicit core= (LM serving is not ported yet)"
    )


class Engine:
    """The slot/admission loop over an EngineAPI core.

    ``Engine(det)`` serves a :class:`~repro_torch.serve.detector.
    CompiledDetector`; ``Engine(cfg, params_or_(params, bn))`` compiles one
    on ``device`` (default: the card). ``admission`` bounds the queue;
    ``submit`` returns a :class:`SubmitResult`, ``run`` an
    :class:`EngineRunResult`."""

    def __init__(self, cfg=None, params=None, *, n_slots: int = 8,
                 core: Optional[EngineAPI] = None,
                 admission: Optional[AdmissionPolicy] = None, device=None):
        self.core = core if core is not None else _resolve_core(
            cfg, params, n_slots=n_slots, device=device
        )
        self.cfg = cfg
        self.admission = admission if admission is not None else AdmissionPolicy()
        self.n_slots = self.core.n_slots
        self.slots: list[Optional[Any]] = [None] * self.n_slots
        self.queue: list[Any] = []
        self.finished: list[Any] = []
        self.rejected: list[Any] = []  # refused or evicted requests (done=False)

    def submit(self, req) -> SubmitResult:
        # a malformed request is refused here, before it can abort a run
        # (cores validate again at admit time for direct callers)
        validate = getattr(self.core, "validate", None)
        if validate is not None:
            err = validate(req)
            if err is not None:
                self.rejected.append(req)
                return SubmitResult(False, reason=f"invalid: {err}")
        pol = self.admission
        if pol.max_queue is not None and len(self.queue) >= pol.max_queue:
            if pol.on_full == "reject":
                self.rejected.append(req)
                return SubmitResult(False, reason="queue-full")
            shed = []
            while len(self.queue) >= pol.max_queue:
                shed.append(self.queue.pop(0))
            self.rejected.extend(shed)
            self.queue.append(req)
            return SubmitResult(True, reason="shed-oldest", shed=tuple(shed))
        self.queue.append(req)
        return SubmitResult(True)

    def _active(self) -> dict[int, Any]:
        return {i: r for i, r in enumerate(self.slots) if r is not None}

    def run(self, max_steps: int = 10_000) -> EngineRunResult:
        """Admit from the queue into free slots, then step every active slot
        together; repeat until drained or ``max_steps`` (then ``status`` is
        ``"truncated"``; occupants keep their slot state, so a later
        ``run()`` resumes them)."""
        steps = 0
        while (self.queue or any(r is not None for r in self.slots)) and steps < max_steps:
            for i in range(self.n_slots):
                if self.slots[i] is None and self.queue:
                    req = self.queue.pop(0)
                    self.core.admit(req, i)
                    self.slots[i] = req
            active = self._active()
            if active:
                for i in self.core.step(active):
                    self.slots[i].done = True
                    self.finished.append(self.slots[i])
                    self.slots[i] = None
            steps += 1
        pending = [r for r in self.slots if r is not None] + list(self.queue)
        return EngineRunResult(self.finished, "truncated" if pending else "drained", pending)
