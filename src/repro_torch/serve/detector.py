"""Compile-once detector serving: the handle and the streaming session.

Counterpart of ``repro/serve/detector.py`` (``CompiledDetector``,
``DetectorSession``, ``demo_weights``, ``synth_streams``), for every
executor (``dense``, ``gated``, ``pallas``). Still to port:
``masked_step`` and ``DetectorEngineCore`` (ROADMAP.md, queue 1).

* :class:`CompiledDetector` builds the compression plan and the fused
  kernel's affine bundles once, on its device, and refuses to run
  (:class:`StalePlanError`) when a weight, gamma/beta or BN statistic it
  was built from has been swapped or changed in place since.
* :class:`DetectorSession` carries every LIF membrane (and the head
  accumulator) from frame to frame for a batch of independent streams.
"""
from __future__ import annotations

from typing import NamedTuple

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
    interop`) is carried over bit for bit."""

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
        self._plan = cplan.build_plan(params, cfg) if cfg.weight_bits else None
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
            head, self.anchors, score_threshold=self.score_threshold,
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
