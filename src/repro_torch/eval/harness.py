"""Restore a detector checkpoint the JAX package wrote
(``repro/eval/harness.py::save_detector_checkpoint``): the
``{"params", "bn"}`` leaves plus the ``detector_config.json`` sidecar that
makes it self-describing. Counterpart of ``restore_detector_checkpoint``,
read side only.
"""
from __future__ import annotations

import json
import os

import numpy as np

from repro_torch import interop
from repro_torch.models import snn_yolo as sy
from repro_torch.train import checkpoint as ckpt

DETECTOR_CONFIG_FILE = "detector_config.json"


def checkpoint_template(cfg: sy.SNNDetConfig) -> dict:
    """The leaves a detector checkpoint of ``cfg`` holds, as (shape, dtype)."""
    params, bn = {}, {}
    for name, shape in sy.layer_shapes(cfg).items():
        params[name] = {"w": (shape, np.float32)}
        if name != "head":
            cout = shape[-1]
            params[name]["gamma"] = ((cout,), np.float32)
            params[name]["beta"] = ((cout,), np.float32)
            bn[name] = {"mean": ((cout,), np.float32), "var": ((cout,), np.float32),
                        "count": ((), np.int32)}
    return {"params": params, "bn": bn}


def restore_detector_checkpoint(root: str, *, step: int | None = None,
                                cfg: sy.SNNDetConfig | None = None, device=None):
    """(cfg, params, bn, step) from a detector checkpoint, the tensors on
    ``device`` (default: the card). ``step`` defaults to the latest
    committed one; ``cfg`` to the checkpoint's own sidecar (pass it to
    restore a bare train-state checkpoint, which has none)."""
    d, step = ckpt.step_dir(root, step)
    if cfg is None:
        path = os.path.join(d, DETECTOR_CONFIG_FILE)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} missing — step {step} is not a detector checkpoint; "
                "pass cfg= to restore anyway"
            )
        with open(path) as f:
            cfg = sy.config_from_dict(json.load(f))
    state, step = ckpt.restore(root, checkpoint_template(cfg), step=step)
    params, bn, _ = interop.params_from_numpy(state["params"], state["bn"], device=device)
    return cfg, params, bn, step
