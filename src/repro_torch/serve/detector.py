"""Compile-once detector serving: the handle, the streaming session and
the megabatched engine core.

Counterpart of ``repro/serve/detector.py``, for every executor
(``dense``, ``gated``, ``pallas``):

* :class:`CompiledDetector` builds the compression plan and the fused
  kernel's affine bundles once, on its device, and refuses to run
  (:class:`StalePlanError`) when a weight, gamma/beta or BN statistic it
  was built from has been swapped or changed in place since. Its
  :meth:`~CompiledDetector.masked_step` is one megabatched serving tick.
* :class:`DetectorSession` carries every LIF membrane (and the head
  accumulator) from frame to frame for a batch of independent streams.
* :class:`FrameRequest` + :class:`DetectorEngineCore` — the detector
  backend of :class:`repro_torch.serve.engine.Engine`: every tick advances
  all active streams as one megabatch, the membranes resident on the
  device, in power-of-two capacity buckets.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.backend import resolve_device
from repro_torch.core import plan as cplan
from repro_torch.core import pruning
from repro_torch.kernels import ops as kops
from repro_torch.models import snn_yolo as sy
from repro_torch.models.postprocess import Detections, postprocess


class StalePlanError(RuntimeError):
    """The handle's params changed after compile — its plan no longer
    describes the weights. Re-run ``compile_detector`` on the new params."""


def _fingerprint(tensors) -> tuple:
    """Identity and in-place version of each tensor: a swapped leaf or an
    in-place write both change it."""
    return tuple((id(t), t._version) for t in tensors)


def _weight_leaves(params) -> tuple:
    return tuple(layer_p["w"] for layer_p in params.values())


def _affine_input_leaves(params, bn_state) -> tuple:
    leaves = []
    for name in sorted(params):
        p = params[name]
        if "gamma" not in p or name not in (bn_state or {}):
            continue
        st = bn_state[name]
        leaves += [p["gamma"], p["beta"], st["mean"], st["var"]]
    return tuple(leaves)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class SessionStep(NamedTuple):
    detections: Detections
    head: torch.Tensor  # (N, gh, gw, A, 5+C) raw predictions


class CompiledDetector:
    """Compile-once handle around the detector; build it through
    :func:`repro_torch.models.snn_yolo.compile_detector`.

    ``device`` defaults to the card (raises if there is none); params and
    bn_state are moved there. ``affines``: optional {layer: (5, kout)}
    per-channel bundles to use instead of computing them — how a bundle
    built elsewhere (e.g. by the JAX package, see :mod:`repro_torch.
    interop`) is carried over bit for bit. ``tile_cache``: the fused
    kernel's tiles per layer shape (:func:`repro_torch.core.plan.
    build_plan`; None: the packaged autotune cache, {}: the shape rule)."""

    def __init__(
        self,
        cfg: sy.SNNDetConfig,
        params,
        bn_state=None,
        *,
        device=None,
        anchors=sy.DEFAULT_ANCHORS,
        score_threshold: float = 0.25,
        iou_threshold: float = 0.5,
        max_detections: int = 32,
        affines: dict | None = None,
        tile_cache: dict | None = None,
    ):
        self.device = resolve_device(device)
        params = _to_device(params, self.device)
        self.cfg = cfg
        self.params = params
        self.bn_state = (
            _to_device(bn_state, self.device) if bn_state is not None
            else sy.default_bn_state(params)
        )
        self.anchors = tuple(anchors)
        # on the device once: a copy per frame would make the host wait
        self._anchors_dev = torch.tensor(self.anchors, dtype=torch.float32, device=self.device)
        self.score_threshold = float(score_threshold)
        self.iou_threshold = float(iou_threshold)
        self.max_detections = int(max_detections)
        if cfg.conv_exec != "dense" and not cfg.weight_bits:
            raise ValueError(
                f"conv_exec={cfg.conv_exec!r} requires weight_bits > 0; "
                "float weights only run through the dense oracle"
            )
        if cfg.conv_exec not in cplan.CONV_EXECUTORS:
            raise ValueError(
                f"unknown conv_exec={cfg.conv_exec!r}; registered: "
                f"{sorted(cplan.CONV_EXECUTORS)}"
            )
        self._plan = (cplan.build_plan(params, cfg, tile_cache=tile_cache)
                      if cfg.weight_bits else None)
        self._compiled = _fingerprint(_weight_leaves(params))
        self._affines = None
        self._affine_compiled: tuple = ()
        # the kernel executor precomputes its bundles; a bundle handed in is
        # used by every executor (its rsqrt row feeds the unfused tdBN too)
        if self._plan is not None and (cfg.conv_exec == "pallas" or affines is not None):
            if affines is None:
                self._affines = cplan.precompute_affines(
                    self._plan, params, self.bn_state, cfg
                )
            else:
                self._affines = {
                    name: kops.pad_affine(
                        torch.as_tensor(rows, dtype=torch.float32, device=self.device),
                        self._plan.layers[name].packed.kp,
                    )
                    for name, rows in affines.items()
                }
            self._affine_compiled = _fingerprint(
                _affine_input_leaves(params, self.bn_state)
            )

    @property
    def plan(self):
        """The DetectorPlan built at compile time (None for float weights)."""
        return self._plan

    def check_plan(self) -> None:
        """Raise :class:`StalePlanError` if params changed after compile."""
        if _fingerprint(_weight_leaves(self.params)) != self._compiled:
            raise StalePlanError(
                "detector params changed after compile: the owned plan no "
                "longer matches the weights — call "
                "snn_yolo.compile_detector(cfg, params) again"
            )
        if self._affines is not None and _fingerprint(
            _affine_input_leaves(self.params, self.bn_state)
        ) != self._affine_compiled:
            raise StalePlanError(
                "detector BN/affine parameters changed after compile: the "
                "precomputed fused-kernel affine bundles no longer match "
                "gamma/beta/mean/var — call "
                "snn_yolo.compile_detector(cfg, params, bn_state) again"
            )

    @torch.no_grad()
    def _step(self, frames, mem):
        head, _, aux = sy.forward(
            self.params, self.bn_state, frames, self.cfg, train=False,
            plan=self._plan, membrane=mem, affines=self._affines,
        )
        dets = postprocess(
            head, self._anchors_dev, score_threshold=self.score_threshold,
            iou_threshold=self.iou_threshold, max_detections=self.max_detections,
        )
        return head, aux["membrane"], dets

    def _frames(self, frames) -> torch.Tensor:
        return torch.as_tensor(frames, dtype=torch.float32, device=self.device)

    def __call__(self, frames) -> Detections:
        """frames: (N, H, W, 3) in [0, 1] → Detections (cold membranes)."""
        dets, _ = self.detect(frames)
        return dets

    def detect(self, frames) -> tuple[Detections, torch.Tensor]:
        """Like ``__call__`` but also returns the raw head."""
        self.check_plan()
        head, _, dets = self._step(self._frames(frames), None)
        return dets, head

    @torch.no_grad()
    def masked_step(self, frames, mem: dict, active, cold=None):
        """One megabatched serving tick over a capacity bucket of streams.

        ``frames``: (C, H, W, 3); ``mem``: membrane dict with C rows;
        ``active``: (C,) bool — rows where it is False are padding lanes
        whose outputs are discarded and whose membrane is kept exactly as it
        was; ``cold``: (C,) bool — rows joining this tick, whose membrane is
        zeroed inside the step (a masked cold start: admission touches no
        device state), or None when no row is. Both masks are applied with
        ``torch.where`` on the device: no per-row scatter, no read back to
        the host. An inactive row keeps the membrane after the cold
        blanking, so a row that is cold and inactive comes out zeroed.
        Returns ``(head, new_mem, detections)``."""
        self.check_plan()
        frames = self._frames(frames)
        active = torch.as_tensor(active, dtype=torch.bool, device=self.device)

        def rows(m, v):  # a (C,) mask broadcast over a leaf's trailing dims
            return m.reshape((-1,) + (1,) * (v.dim() - 1))

        mem0 = mem
        if cold is not None:
            cold = torch.as_tensor(cold, dtype=torch.bool, device=self.device)
            mem0 = {k: torch.where(rows(cold, v), 0.0, v) for k, v in mem.items()}
        head, new_mem, dets = self._step(frames, mem0)
        kept = {k: torch.where(rows(active, v), v, mem0[k]) for k, v in new_mem.items()}
        return head, kept, dets

    def zero_state(self, batch: int) -> dict:
        """Cold-start membrane dict for a ``batch``-stream session, each
        layer at its membrane's resolution (:func:`snn_yolo.membrane_hw`:
        pooled before the LIF under ``pool_drive``)."""
        shapes = sy.layer_shapes(self.cfg)
        return {
            name: torch.zeros((batch, *hw, shapes[name][-1]), device=self.device)
            for name, hw in sy.membrane_hw(self.cfg).items()
        }

    def new_session(self, batch: int = 1) -> "DetectorSession":
        return DetectorSession(self, batch)


class DetectorSession:
    """Streaming handle: membrane potentials persist across ``step`` calls.

    ``batch`` independent streams step together; row i's state only mixes
    with row i's frames. A fresh or reset session starts from zero
    membranes, and its first step equals the stateless ``detector(frames)``
    when ``v_init`` is 0."""

    def __init__(self, det: CompiledDetector, batch: int = 1):
        self.det = det
        self.batch = int(batch)
        self._mem = det.zero_state(self.batch)
        self.frames_seen = 0

    @property
    def state(self) -> dict:
        return self._mem

    def step(self, frames) -> SessionStep:
        frames = self.det._frames(frames)
        if frames.dim() != 4 or frames.shape[0] != self.batch:
            raise ValueError(
                f"session batch is {self.batch}; got frames {tuple(frames.shape)} "
                "(want (batch, H, W, 3))"
            )
        self.det.check_plan()
        head, self._mem, dets = self.det._step(frames, self._mem)
        self.frames_seen += 1
        return SessionStep(detections=dets, head=head)

    def reset(self, index: int | None = None) -> None:
        """Zero the membranes of every stream, or of stream ``index``."""
        if index is None:
            self._mem = {k: torch.zeros_like(v) for k, v in self._mem.items()}
            self.frames_seen = 0
            return
        if not -self.batch <= index < self.batch:
            raise IndexError(f"stream index {index} out of range for batch {self.batch}")
        mem = {}
        for k, v in self._mem.items():
            v = v.clone()
            v[index] = 0.0
            mem[k] = v
        self._mem = mem


# ------------------------------------------------- demo / benchmark setup --


def demo_weights(cfg: sy.SNNDetConfig, *, prune_rate: float = 0.8, seed: int = 0,
                 calib_batch: int = 2, device=None):
    """Pruned, tdBN-calibrated random weights for demos and smoke runs.
    Returns (params, bn_state, rng); the numpy rng continues the stream the
    calibration frames came from, so callers draw matching frames."""
    params, bn = sy.init_params(cfg, seed=seed, device=device)
    params = pruning.prune_tree(params, prune_rate)
    rng = np.random.default_rng(seed)
    h, w = cfg.input_hw
    calib = (rng.integers(0, 256, (calib_batch, h, w, 3)) / 255.0).astype(np.float32)
    dev = params["encode"]["w"].device
    bn = sy.calibrate_bn_state(params, bn, torch.from_numpy(calib).to(dev), cfg)
    return params, bn, rng


def synth_streams(rng, n_streams: int, n_frames: int, hw) -> list:
    """Uint8-grid synthetic frame streams (exact under the 8-bit encode):
    n_streams arrays of (n_frames, H, W, 3)."""
    h, w = hw
    return [
        (rng.integers(0, 256, (n_frames, h, w, 3)) / 255.0).astype(np.float32)
        for _ in range(n_streams)
    ]


def step_latency_ms(step_wall: list) -> dict:
    """p50/p95/p99 of the engine's per-tick latency in ms, the first tick
    (warm-up) left out."""
    wall = np.asarray(step_wall[1:] or step_wall)
    return {
        "step_p50_ms": float(np.percentile(wall, 50) * 1e3),
        "step_p95_ms": float(np.percentile(wall, 95) * 1e3),
        "step_p99_ms": float(np.percentile(wall, 99) * 1e3),
    }


# ------------------------------------------------------------ engine core --


@dataclass
class FrameRequest:
    """A video-clip detection request: F consecutive frames of one stream."""

    rid: int
    frames: Any  # (F, H, W, 3) float array in [0, 1]
    out: list = field(default_factory=list)  # per-frame Detections of numpy arrays
    heads: list = field(default_factory=list)  # per-frame raw head (numpy)
    done: bool = False


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


class DetectorEngineCore:
    """EngineAPI backend: megabatched continuous-stream detector serving.

    Every engine tick advances all active streams as one megabatch through
    :meth:`CompiledDetector.masked_step`:

    * The membrane dict lives on the device across ticks, never staged
      through the host.
    * The pool is sized in power-of-two capacity buckets (``min_bucket`` up
      to ``n_slots``), so the step sees O(log n_slots) batch shapes.
    * Join and leave do no device work: admission claims the lowest free
      row and marks it cold (zeroed inside the next step); retirement frees
      the row (its stale membrane is invisible behind the active mask).
      Only the rare bucket changes touch the device: grow pads every leaf,
      shrink compacts the surviving rows with one ``index_select`` per
      leaf.
    * Detections and heads cross to the host once per field per tick.
    * Once a tick's step is queued, the next tick's frames are assembled
      into one of two pinned host buffers and copied on a side CUDA stream
      while the device runs; the next tick's step waits for that copy (an
      event), and a pinned buffer is refilled only after its last copy has
      completed. Steady state only: a stream that finishes remaps the rows.

    ``step_wall`` holds each tick's host seconds (upload, step, sync);
    ``upload_wall`` the host seconds of each upload (assembly and copy
    issue); ``step_device_ms`` the device time between CUDA events recorded
    around :meth:`~CompiledDetector.masked_step` (on the card only)."""

    def __init__(self, det: CompiledDetector, *, n_slots: int = 8, min_bucket: int = 8):
        self.det = det
        self.device = det.device
        self.n_slots = n_slots
        self.min_bucket = min(min_bucket, n_slots)
        self._hw = tuple(det.cfg.input_hw)
        # the row table: _rows[row] -> engine slot or None (a free lane),
        # _row_of[slot] -> row, _cursor[slot] -> next frame index, _cold ->
        # rows the next step zeroes
        self._row_of: dict[int, int] = {}
        self._cursor: dict[int, int] = {}
        self._cold: set[int] = set()
        self.cap = self._bucket_for(0)
        self._rows: list[Optional[int]] = [None] * self.cap
        self._mem = det.zero_state(self.cap)
        self._staged = None  # (device frames, copy event, signature): the next tick's upload
        cuda = self.device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self.device) if cuda else None
        self._pinned: list = [None, None]  # [(pinned host tensor, its last copy's event)]
        self._flip = 0
        self.step_wall: list[float] = []
        self.upload_wall: list[float] = []
        self.step_device_ms: list[float] = []

    def _bucket_for(self, n: int) -> int:
        return min(self.n_slots, max(self.min_bucket, _pow2(max(n, 1))))

    # ---------------------------------------------------------- admission --
    def validate(self, req: FrameRequest) -> Optional[str]:
        """None if ``req`` is servable, else why not — checked by
        ``Engine.submit`` and again by :meth:`admit` before any slot or
        membrane state is touched."""
        frames = np.asarray(req.frames)
        h, w = self._hw
        if frames.ndim != 4 or frames.shape[0] < 1:
            return (f"FrameRequest.frames must be (F, H, W, 3) with F >= 1; "
                    f"got {frames.shape}")
        if frames.shape[1:] != (h, w, 3):
            return (f"FrameRequest.frames must be (F, {h}, {w}, 3) to match the "
                    f"compiled detector's cfg.input_hw={self._hw}; got {frames.shape}")
        return None

    def admit(self, req: FrameRequest, slot_idx: int) -> None:
        req.frames = np.asarray(req.frames, np.float32)
        err = self.validate(req)
        if err is not None:  # reject before touching any session state
            raise ValueError(err)
        if len(self._row_of) == self.cap:
            self._grow(self._bucket_for(len(self._row_of) + 1))
        row = self._rows.index(None)  # the lowest free lane
        self._rows[row] = slot_idx
        self._row_of[slot_idx] = row
        self._cursor[slot_idx] = 0
        self._cold.add(row)  # zeroed inside the next step

    # --------------------------------------------------------- row plumbing --
    def _grow(self, new_cap: int) -> None:
        pad = new_cap - self.cap
        self._mem = {
            k: torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])
            for k, v in self._mem.items()
        }
        self._rows.extend([None] * pad)
        self.cap = new_cap

    def _shrink(self, new_cap: int) -> None:
        """Compact the surviving rows below ``new_cap`` with one
        ``index_select`` per membrane leaf."""
        perm = list(range(new_cap))
        free = [r for r in range(new_cap) if self._rows[r] is None]
        for r in range(new_cap, self.cap):
            slot = self._rows[r]
            if slot is None:
                continue
            dst = free.pop(0)
            perm[dst] = r
            self._rows[dst] = slot
            self._row_of[slot] = dst
        idx = torch.as_tensor(perm, dtype=torch.long, device=self.device)
        self._mem = {k: v.index_select(0, idx) for k, v in self._mem.items()}
        self._rows = self._rows[:new_cap]
        self.cap = new_cap

    def _retire(self, slot: int) -> None:
        """Free ``slot``'s row; no device work."""
        row = self._row_of.pop(slot)
        self._rows[row] = None
        self._cold.discard(row)
        del self._cursor[slot]

    def _occupied(self):
        return [(r, s) for r, s in enumerate(self._rows) if s is not None]

    def _signature(self, cursor_offset: int = 0):
        """Identity of one tick's frame batch: the capacity and (row, slot,
        frame index) per occupied lane. A staged upload is used only by the
        tick whose signature it was staged for."""
        return (self.cap, tuple((r, s, self._cursor[s] + cursor_offset)
                                for r, s in self._occupied()))

    def _assemble(self, active: dict, offset: int = 0, out=None) -> torch.Tensor:
        """One tick's (cap, H, W, 3) frame batch in host memory (into
        ``out`` if given); free lanes are zeros. Rows are copied by
        ``Tensor.copy_``, which spreads a copy over the host's threads (a
        numpy assignment copies on one)."""
        h, w = self._hw
        batch = torch.empty((self.cap, h, w, 3), dtype=torch.float32) if out is None else out
        for row, slot in enumerate(self._rows):
            if slot is None:
                batch[row].zero_()
            else:
                batch[row].copy_(torch.from_numpy(active[slot].frames[self._cursor[slot] + offset]))
        return batch

    def _upload(self, active: dict, offset: int = 0):
        """(frames on the device, the copy's event or None). On the card:
        assembled into the pinned buffer whose last copy has completed,
        then copied on the side stream into memory allocated there (and
        marked in use by the current stream)."""
        t0 = time.perf_counter()
        if self._copy_stream is None:
            frames, copied = self._assemble(active, offset), None
        else:
            h, w = self._hw
            self._flip ^= 1
            buf = self._pinned[self._flip]
            if buf is None or buf[0].shape[0] != self.cap:
                host = torch.empty((self.cap, h, w, 3), dtype=torch.float32, pin_memory=True)
            else:
                host, done = buf
                done.synchronize()  # its previous copy has read it
            self._assemble(active, offset, out=host)
            with torch.cuda.stream(self._copy_stream):
                frames = torch.empty((self.cap, h, w, 3), dtype=torch.float32,
                                     device=self.device)
                frames.copy_(host, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(self._copy_stream)
            frames.record_stream(torch.cuda.current_stream(self.device))
            self._pinned[self._flip] = (host, copied)
        self.upload_wall.append(time.perf_counter() - t0)
        return frames, copied

    # --------------------------------------------------------------- tick --
    def step(self, active: dict) -> list[int]:
        if not self._row_of:  # a drained pool: nothing to run
            return []
        t0 = time.perf_counter()
        sig = self._signature()
        if self._staged is not None and self._staged[2] == sig:
            frames, copied = self._staged[:2]  # uploaded during the last tick
        else:
            frames, copied = self._upload(active)
        self._staged = None
        mask = np.zeros((self.cap,), bool)
        for row, _ in self._occupied():
            mask[row] = True
        mask_t = torch.from_numpy(mask).to(self.device)
        cold_t = None  # no row joins: the step skips the blanking pass
        if self._cold:
            cold = np.zeros((self.cap,), bool)
            cold[list(self._cold)] = True
            cold_t = torch.from_numpy(cold).to(self.device)
            self._cold.clear()
        cuda = self._copy_stream is not None
        if cuda:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(copied)
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record(stream)
        head, new_mem, dets = self.det.masked_step(frames, self._mem, mask_t, cold_t)
        if cuda:
            stop.record(stream)
        # stage the next tick's upload while the device runs this one;
        # steady state only (a finishing stream remaps the rows)
        if all(self._cursor[s] + 1 < len(active[s].frames) for s in self._row_of):
            self._staged = (*self._upload(active, offset=1), self._signature(cursor_offset=1))
        if cuda:
            stop.synchronize()
        self.step_wall.append(time.perf_counter() - t0)
        if cuda:
            self.step_device_ms.append(start.elapsed_time(stop))

        head_np = head.cpu().numpy()
        dets_np = type(dets)(*(f.cpu().numpy() for f in dets))  # one transfer per field
        self._mem = new_mem
        finished = []
        for row, slot in self._occupied():
            req = active[slot]
            req.out.append(dets_np.row(row))
            req.heads.append(head_np[row])
            self._cursor[slot] += 1
            if self._cursor[slot] >= len(req.frames):
                finished.append(slot)
        for slot in finished:
            self._retire(slot)
        new_cap = self._bucket_for(len(self._row_of))
        if new_cap < self.cap:
            self._shrink(new_cap)
        return finished
