"""Dense ANN detector import/export: the ``.npz`` interchange format.

Counterpart of ``repro/convert/importer.py``, numpy only: the same keys,
dtypes and ``__meta__`` JSON, so either package reads the other's bundles.
One file carries a full pretrained conv+BN YOLO detector with the repo's
topology (``snn_yolo.layer_shapes``):

  * ``__meta__`` — JSON blob: ``{"format": "repro-ann-detector/1",
    "config": snn_yolo.config_to_dict(cfg), "eps": <bn epsilon>}``. The
    embedded config makes the bundle self-describing — the importer
    rebuilds the exact ``SNNDetConfig`` and checks every array against the
    shapes its widths give (``snn_yolo.layer_shapes``, nothing allocated).
  * ``<layer>/w|gamma|beta|mean|var`` — STANDARD BatchNorm parameters per
    conv layer (``encode``, ``conv_block``, ``stage{i}/{shortcut,main_in,
    main_a,main_b,agg}``): ``y = gamma·(conv(x)+bias−mean)/sqrt(var+eps)+
    beta`` followed by ReLU. The repo's own tdBN-trained ANN mode exports
    via :func:`export_ann_npz` (tdBN's ``alpha·threshold`` factor folds
    into the standard gamma).
  * ``<layer>/bias`` — optional conv bias (repo-trained ANNs have none).
  * ``head/w`` — the 1×1 YOLOv2 head kernel (no BN, no bias: the SNN head
    is a pure membrane-readout conv, so a biased head cannot convert).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np

from repro_torch.models import snn_yolo as sy

FORMAT = "repro-ann-detector/1"
META_KEY = "__meta__"
BN_KEYS = ("w", "gamma", "beta", "mean", "var")


def conv_bn_layer_names(cfg: sy.SNNDetConfig) -> list[str]:
    """Conv+BN layer names in forward (topological) order — every layer of
    the detector except the BN-free head."""
    names = ["encode", "conv_block"]
    for i in range(len(cfg.stage_channels)):
        names += [
            f"stage{i}/shortcut", f"stage{i}/main_in",
            f"stage{i}/main_a", f"stage{i}/main_b", f"stage{i}/agg",
        ]
    return names


@dataclasses.dataclass(frozen=True)
class AnnConvBN:
    """One dense conv layer with standard (already-θ-folded) BatchNorm."""

    w: np.ndarray  # (kh, kw, cin, cout) HWIO
    gamma: np.ndarray  # (cout,)
    beta: np.ndarray
    mean: np.ndarray
    var: np.ndarray
    bias: Optional[np.ndarray] = None  # (cout,) conv bias, usually absent


@dataclasses.dataclass(frozen=True)
class AnnDetector:
    """A validated imported ANN detector, ready for calibration."""

    cfg: sy.SNNDetConfig  # the source architecture (mode forced to "ann")
    layers: dict  # name -> AnnConvBN, forward order
    head_w: np.ndarray  # (1, 1, cin, head_channels)
    eps: float = 1e-5

    def folded(self, name: str) -> tuple[np.ndarray, np.ndarray]:
        """BN folded into the conv: returns ``(w_tilde, b_tilde)`` with
        ``BN(conv(x, w) + bias) == conv(x, w_tilde) + b_tilde`` exactly
        (eval-mode running statistics)."""
        l = self.layers[name]
        s = l.gamma / np.sqrt(l.var + self.eps)  # (cout,)
        w_tilde = (l.w * s).astype(np.float32)
        bias = l.bias if l.bias is not None else 0.0
        b_tilde = (l.beta + s * (bias - l.mean)).astype(np.float32)
        return w_tilde, b_tilde


def _host(t) -> np.ndarray:
    """A parameter leaf (tensor on any device, or array) as f32 numpy."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


def export_ann_npz(path: str, params, bn_state, cfg: sy.SNNDetConfig, *,
                   eps: float = 1e-5) -> str:
    """Export a repo-trained ANN-mode detector (``snn_yolo`` trees, tensors
    on any device) as a format-v1 npz bundle.

    The repo's ANN mode normalizes with tdBN, whose eval-time affine is
    ``y = θ·γ·(x−mean)·rsqrt(var+eps) + β`` (alpha=1) — a standard BN with
    ``gamma_std = θ·γ``; the threshold factor folds in here (in f32 on the
    host, as the JAX package does) so importers see plain BatchNorm.
    """
    arrays: dict[str, np.ndarray] = {}
    for name in conv_bn_layer_names(cfg):
        arrays[f"{name}/w"] = _host(params[name]["w"])
        arrays[f"{name}/gamma"] = (
            np.float32(cfg.threshold) * _host(params[name]["gamma"])
        ).astype(np.float32)
        arrays[f"{name}/beta"] = _host(params[name]["beta"])
        arrays[f"{name}/mean"] = _host(bn_state[name]["mean"])
        arrays[f"{name}/var"] = _host(bn_state[name]["var"])
    arrays["head/w"] = _host(params["head"]["w"])
    meta = {
        "format": FORMAT,
        "config": sy.config_to_dict(dataclasses.replace(cfg, mode="ann")),
        "eps": eps,
    }
    arrays[META_KEY] = np.frombuffer(
        json.dumps(meta, sort_keys=True).encode(), dtype=np.uint8
    )
    np.savez(path, **arrays)
    return path


def load_ann_npz(path: str) -> AnnDetector:
    """Load + validate a format-v1 bundle into an :class:`AnnDetector`.

    Raises ``ValueError`` with the full missing-vs-unexpected key lists or
    the first shape mismatch — a bundle either loads completely or not at
    all (no partially-imported detectors).
    """
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    if META_KEY not in arrays:
        raise ValueError(f"{path}: not an ANN detector bundle ({META_KEY} missing)")
    meta = json.loads(arrays.pop(META_KEY).astype(np.uint8).tobytes())
    if meta.get("format") != FORMAT:
        raise ValueError(
            f"{path}: format {meta.get('format')!r}, expected {FORMAT!r}"
        )
    cfg = dataclasses.replace(
        sy.config_from_dict(meta["config"]), mode="ann"
    )
    eps = float(meta.get("eps", 1e-5))

    names = conv_bn_layer_names(cfg)
    expected = {f"{n}/{k}" for n in names for k in BN_KEYS} | {"head/w"}
    optional = {f"{n}/bias" for n in names}
    got = set(arrays)
    missing = sorted(expected - got)
    unexpected = sorted(got - expected - optional)
    if missing or unexpected:
        raise ValueError(
            f"{path}: bad key set — missing {missing or 'none'}, "
            f"unexpected {unexpected or 'none'}"
        )

    # shape-check every array against the architecture the meta declares:
    # the shapes init_params would allocate, from the config's widths
    shapes = sy.layer_shapes(cfg)

    def check(key, want):
        have = arrays[key].shape
        if tuple(have) != tuple(want):
            raise ValueError(
                f"{path}: {key} has shape {tuple(have)}, "
                f"config expects {tuple(want)}"
            )
    layers = {}
    for n in names:
        check(f"{n}/w", shapes[n])
        cout = (shapes[n][-1],)
        for k in ("gamma", "beta", "mean", "var"):
            check(f"{n}/{k}", cout)
        bias = arrays.get(f"{n}/bias")
        if bias is not None:
            check(f"{n}/bias", cout)
        layers[n] = AnnConvBN(
            w=np.asarray(arrays[f"{n}/w"], np.float32),
            gamma=np.asarray(arrays[f"{n}/gamma"], np.float32),
            beta=np.asarray(arrays[f"{n}/beta"], np.float32),
            mean=np.asarray(arrays[f"{n}/mean"], np.float32),
            var=np.asarray(arrays[f"{n}/var"], np.float32),
            bias=None if bias is None else np.asarray(bias, np.float32),
        )
    check("head/w", shapes["head"])
    return AnnDetector(
        cfg=cfg, layers=layers,
        head_w=np.asarray(arrays["head/w"], np.float32), eps=eps,
    )
