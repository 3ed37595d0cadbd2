"""Read checkpoints the JAX package wrote (``repro/train/checkpoint.py``'s
layout), with numpy alone::

    root/step_000000042/
        manifest.json       {"step", "leaves": [{"path", "file", "shape", "dtype"}]}
        leaf_00000.npy ...

A leaf's path is the JAX pytree key path, e.g. ``['params']/['encode']/['w']``.
A committed step is a ``step_*`` directory (not ``.tmp``) that holds its
manifest. Single-host and striped (multi-host) checkpoints share this
layout once committed. Writing checkpoints is not ported yet.
"""
from __future__ import annotations

import json
import os
import re

import numpy as np

_KEY = re.compile(r"\['([^']*)'\]")


def _committed_steps(root: str) -> list[int]:
    if not os.path.isdir(root):
        return []
    steps = []
    for d in os.listdir(root):
        if not d.startswith("step_") or d.endswith(".tmp"):
            continue
        try:
            step = int(d.split("_")[1])
        except (IndexError, ValueError):
            continue
        if os.path.exists(os.path.join(root, d, "manifest.json")):
            steps.append(step)
    return sorted(steps)


def latest_step(root: str) -> int | None:
    steps = _committed_steps(root)
    return max(steps) if steps else None


def step_dir(root: str, step: int | None = None) -> tuple[str, int]:
    """(directory, step) of ``step``, the latest committed one by default."""
    step = step if step is not None else latest_step(root)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint under {root}")
    return os.path.join(root, f"step_{step:09d}"), step


def parse_path(path: str) -> tuple:
    """``['params']/['stage0/agg']/['w']`` → ("params", "stage0/agg", "w")."""
    keys = tuple(_KEY.findall(path))
    if "/".join(f"['{k}']" for k in keys) != path:
        raise ValueError(f"unsupported leaf path {path!r}: only string dict keys are read")
    return keys


def _flatten(template, prefix=()):
    if isinstance(template, dict):
        for k in sorted(template):
            yield from _flatten(template[k], prefix + (k,))
    else:
        yield prefix, template


def restore(root: str, template: dict, *, step: int | None = None):
    """Restore into the structure of ``template``, a nested dict whose
    leaves are ``(shape, dtype)``. Returns (nested dict of numpy arrays,
    step). Raises on a leaf missing from the checkpoint (naming what each
    side has that the other lacks) or a shape that differs."""
    d, step = step_dir(root, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_keys = {parse_path(e["path"]): e for e in manifest["leaves"]}
    want = dict(_flatten(template))
    missing = [k for k in want if k not in by_keys]
    if missing:
        extra = sorted(set(by_keys) - set(want))
        raise ValueError(
            f"checkpoint {d} does not match the restore template: template leaves "
            f"missing from the checkpoint: {missing}; checkpoint leaves absent from "
            f"the template: {extra or '[]'}"
        )
    out: dict = {}
    for keys, (shape, dtype) in want.items():
        arr = np.load(os.path.join(d, by_keys[keys]["file"]))
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"shape mismatch at {keys}: checkpoint {arr.shape} vs "
                             f"template {tuple(shape)}")
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = arr.astype(dtype)
    return out, step
