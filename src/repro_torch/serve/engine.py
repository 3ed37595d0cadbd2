"""The serving engine: a slot pool with continuous batching and admission
control. Counterpart of ``repro/serve/engine.py``.

:class:`Engine` owns the queue, the slot occupancy and the run loop, and
leaves the model work to an :class:`EngineAPI` backend:

* :class:`LMEngineCore` — LM token serving. One shared cache over the
  pool: each request is prefilled and its rows (or, for the recurrent
  ssm and hybrid families, its state) copied into its slot; each step
  decodes one token for every active slot, each at its own cache position.
  The dense and moe families prefill at bucketed lengths, the recurrent
  ones at the exact length. The vlm and audio families are refused
  (ROADMAP R10): a ``Request`` carries no patches or frames, and the JAX
  package's ``Engine`` cannot serve them either; they serve through the
  ``zoo`` API.
* :class:`repro_torch.serve.detector.DetectorEngineCore` — detection
  serving: slot i is one frame stream, and each step advances every active
  stream by one frame as one megabatch.

``Engine(cfg, params)`` picks the backend by the config's type (LMConfig
or SNNDetConfig), so ``launch/serve.py --arch`` drives both workloads
through one loop.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.models import zoo


def _bucket(n: int) -> int:
    b = 16
    while b < n:
        b *= 2
    return b


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


# families whose prefill takes more than tokens: Request has nothing to give it
UNSERVED_FAMILIES = ("vlm", "audio")


def check_servable(cfg: LMConfig) -> None:
    """Raise ValueError (ROADMAP R10) for a family the Engine cannot serve."""
    if cfg.family in UNSERVED_FAMILIES:
        raise ValueError(
            f"{cfg.arch_id}: the {cfg.family} family's prefill needs "
            f"{'patches' if cfg.family == 'vlm' else 'frames'}, which a Request does not "
            "carry; the JAX package's Engine fails on it too (ROADMAP.md R10). Serve it "
            "through zoo.get_api(cfg): prefill_fn with them, then decode_fn")


class LMEngineCore:
    """EngineAPI backend for LM token serving over one shared cache, on the
    device that holds ``params``. Sampling is greedy (``greedy`` is kept as
    the JAX package keeps it)."""

    def __init__(self, cfg: LMConfig, params, *, n_slots: int = 8,
                 max_seq: int = 512, greedy: bool = True):
        check_servable(cfg)
        self.cfg = cfg
        self.api = zoo.get_api(cfg)
        self.params = params
        self.device = params["embed"]["tok"].device
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.greedy = greedy
        self.pos = [0] * n_slots  # next cache write position per slot
        self.cache = self.api.init_cache(n_slots, max_seq, device=self.device)
        self._decode = self.api.decode_fn
        self._prefill_cache = {}
        # bucketed prefill (pad + valid_len): the causal mask keeps positions
        # < plen blind to the pad, and _scatter_kv copies only rows [:plen].
        # The recurrent families (ssm, hybrid) would fold the pad into their
        # state, and an int8 cache keeps exact-length prefill: as in JAX.
        self._kv_family = cfg.family in ("dense", "moe")
        self._bucketed = self._kv_family and not cfg.kv_quant

    def validate(self, req: Request) -> Optional[str]:
        """Why ``req`` cannot be served, or None: its prompt must leave at
        least one cache row for a decoded token."""
        if not 0 < len(req.prompt) < self.max_seq:
            return f"prompt of {len(req.prompt)} tokens; want 1..{self.max_seq - 1}"
        return None

    # ------------------------------------------------------------ prefill --
    def _prefill_fn(self, length: int):
        """The prefill for prompts padded to ``length``: one entry per
        bucket (or exact length), keyed as JAX's engine keys its compiled
        prefills. A KV family's entry holds the serve_fast path's scratch
        cache of that length, reused by every request of the bucket; the
        recurrent families build a new state per prefill, so theirs is the
        API's prefill itself and the key only records the length served."""
        if length not in self._prefill_cache:
            if not self._kv_family:
                self._prefill_cache[length] = self.api.prefill_fn
                return self.api.prefill_fn
            scratch = (self.api.init_cache(1, length, device=self.device)
                       if self.cfg.serve_fast else None)
            self._prefill_cache[length] = (
                lambda params, tokens, valid_len=None, _c=scratch:
                self.api.prefill_fn(params, tokens, valid_len=valid_len, cache=_c))
        return self._prefill_cache[length]

    def admit(self, req: Request, slot_idx: int):
        err = self.validate(req)
        if err is not None:
            raise ValueError(f"request {req.rid}: {err}")
        plen = len(req.prompt)
        prompt = np.asarray(req.prompt, np.int64)
        if self._bucketed:
            blen = _bucket(plen)
            padded = np.zeros((1, blen), np.int64)
            padded[0, :plen] = prompt
            logits, pcache = self._prefill_fn(blen)(
                self.params, torch.from_numpy(padded).to(self.device), valid_len=plen)
        else:
            logits, pcache = self._prefill_fn(plen)(
                self.params, torch.from_numpy(prompt[None]).to(self.device))
        req.out.append(int(torch.argmax(logits[0])))
        self._scatter_kv(pcache, slot_idx, plen)
        self.pos[slot_idx] = plen

    def _scatter_kv(self, pcache, slot_idx: int, plen: int):
        """Copy the request's prefill into its slot of the shared cache:
        rows [:plen] of k and v (and an int8 cache's scales); for the
        recurrent families each state along its batch axis (1 for rwkv6's
        and the hybrid's tail, 2 for the hybrid's (n_super, attn_every)
        stack), and the hybrid's shared-attention rows [:plen]."""
        def put_kv(dst, src):
            dst[:, slot_idx, :plen] = src[:, 0, :plen].to(dst.dtype)

        def put_state(dst, src, axis: int):
            idx = (slice(None),) * axis
            dst[idx + (slot_idx,)] = src[idx + (0,)].to(dst.dtype)

        c = self.cache
        if self.cfg.family == "ssm":
            for dst, src in zip(c, pcache):
                put_state(dst, src, 1)
        elif self.cfg.family == "hybrid":
            for dst, src in zip(c.mamba, pcache.mamba):
                put_state(dst, src, 2)
            if c.tail is not None:
                for dst, src in zip(c.tail, pcache.tail):
                    put_state(dst, src, 1)
            put_kv(c.attn_k, pcache.attn_k)
            put_kv(c.attn_v, pcache.attn_v)
        else:
            for dst, src in zip(c, pcache):
                put_kv(dst, src)

    # ------------------------------------------------------------- decode --
    def step(self, active: dict[int, Request]) -> list[int]:
        toks = np.zeros((self.n_slots,), np.int64)
        pos = np.zeros((self.n_slots,), np.int64)  # idle slots sit at 0
        for i, req in active.items():
            toks[i] = req.out[-1]
            pos[i] = self.pos[i]
        logits, self.cache = self._decode(
            self.params, self.cache, torch.from_numpy(toks).to(self.device),
            torch.from_numpy(pos).to(self.device))
        nxt = torch.argmax(logits, dim=-1).tolist()
        finished = []
        for i, req in active.items():
            self.pos[i] += 1
            tok = nxt[i]
            req.out.append(tok)
            if (
                tok == req.eos_id
                or len(req.out) >= req.max_new_tokens
                or self.pos[i] + 1 >= self.max_seq
            ):
                finished.append(i)
        return finished


def _resolve_core(cfg, params, *, n_slots: int, max_seq: int = 512, greedy: bool = True,
                  device=None) -> EngineAPI:
    if isinstance(cfg, LMConfig):  # params already live on their device
        return LMEngineCore(cfg, params, n_slots=n_slots, max_seq=max_seq, greedy=greedy)
    from repro_torch.models.snn_yolo import SNNDetConfig, compile_detector
    from repro_torch.serve.detector import CompiledDetector, DetectorEngineCore

    if isinstance(cfg, CompiledDetector):  # a compiled handle, on its own device
        return DetectorEngineCore(cfg, n_slots=n_slots)
    if isinstance(cfg, SNNDetConfig):
        p, bn = params if isinstance(params, tuple) else (params, None)
        return DetectorEngineCore(compile_detector(cfg, p, bn, device=device),
                                  n_slots=n_slots)
    raise TypeError(
        f"don't know how to serve {type(cfg).__name__}: pass an LMConfig, an "
        "SNNDetConfig, a CompiledDetector, or an explicit core="
    )


class Engine:
    """The slot/admission loop over an EngineAPI core.

    ``Engine(cfg, params)`` with an :class:`LMConfig` serves tokens on the
    device of ``params`` (``n_slots`` slots of ``max_seq`` cache rows).
    ``Engine(det)`` serves a :class:`~repro_torch.serve.detector.
    CompiledDetector`; ``Engine(cfg, params_or_(params, bn))`` with an
    SNNDetConfig compiles one on ``device`` (default: the card).
    ``admission`` bounds the queue;
    ``submit`` returns a :class:`SubmitResult`, ``run`` an
    :class:`EngineRunResult`."""

    def __init__(self, cfg=None, params=None, *, n_slots: int = 8,
                 max_seq: int = 512, greedy: bool = True,
                 core: Optional[EngineAPI] = None,
                 admission: Optional[AdmissionPolicy] = None, device=None):
        self.core = core if core is not None else _resolve_core(
            cfg, params, n_slots=n_slots, max_seq=max_seq, greedy=greedy, device=device
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
