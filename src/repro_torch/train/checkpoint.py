"""Atomic, async checkpoints in the JAX package's layout
(``repro/train/checkpoint.py``), written and read with numpy::

    root/step_000000042.tmp/    staging — never read
    root/step_000000042/        rename-commit: readers only see whole steps
        manifest.json       {"step", "leaves": [{"path", "file", "shape", "dtype"}]}
        leaf_00000.npy ...

A leaf's path is the JAX pytree key path, e.g. ``['params']/['encode']/['w']``
or ``['opt']/.m/['encode']/['w']`` (:mod:`repro_torch.tree`), so the JAX
package's ``restore`` reads what the port writes and the other way round;
each leaf is stored whole, its dtype as numpy spells it (a bf16 leaf, which
numpy has no type for, widened to f32 — exact; either package's restore
casts it back to its template's dtype). A committed step is
a ``step_*`` directory (not ``.tmp``) that holds its manifest.

* :func:`save` stages, fsyncs the manifest and renames: a crash mid-save
  never corrupts the latest step. ``extra_files`` sidecars commit with it.
* :func:`save_async` copies every leaf to the host first, then writes on a
  thread; :func:`wait_pending` joins the writers and re-raises the first
  failed write, and :func:`gc_old` joins a writer before deleting its step.
* :func:`restore` fills a template tree, checking every leaf's shape.

Single-controller only: the multi-host striped save (JAX's
``_write_sharded``) is ROADMAP queue 1 item 7; a striped checkpoint, once
committed, reads as any other.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from dataclasses import dataclass
from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch import tree as tu

_RESERVED_FILES = ("manifest.json", "shard_manifest.json", "staging.json")


@dataclass(frozen=True)
class ShapeDtype:
    """A template leaf that restores as a numpy array of this shape/dtype."""

    shape: tuple
    dtype: Any


def _host_array(leaf) -> np.ndarray:
    """A host copy of a leaf, detached from anything that may later change
    it in place."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            return leaf.float().cpu().numpy()
        return leaf.to("cpu", copy=True).numpy()
    return np.array(leaf)


def save(root: str, step: int, tree: Any, *,
         extra_files: Optional[Mapping[str, bytes]] = None) -> str:
    """Synchronous atomic save. Returns the committed directory.

    ``extra_files``: {filename: bytes} sidecars (e.g. a config json) written
    into the staging dir before the rename, so they commit with the
    checkpoint."""
    paths, leaves = tu.flatten_with_paths(tree)
    return _write(root, step, paths, [_host_array(l) for l in leaves], extra_files)


@dataclass
class _PendingSave:
    """One in-flight async write: the (root, step) its thread commits, and
    the exception it died with, if any (a thread's exception is otherwise
    lost, and with it the checkpoint)."""

    root: str
    step: int
    thread: threading.Thread
    error: Optional[BaseException] = None


_PENDING: list[_PendingSave] = []


def save_async(root: str, step: int, tree: Any, *,
               extra_files: Optional[Mapping[str, bytes]] = None) -> threading.Thread:
    """Copy every leaf to the host (card tensors included, before the thread
    starts), then commit on a background thread. A failed write is recorded
    and re-raised by the next :func:`wait_pending` — call it before exit."""
    paths, leaves = tu.flatten_with_paths(tree)
    host = [_host_array(l) for l in leaves]
    pending = _PendingSave(root=os.path.abspath(root), step=step, thread=None)

    def _run():
        try:
            _write(root, step, paths, host, extra_files)
        except BaseException as e:  # noqa: BLE001 — recorded, re-raised later
            pending.error = e

    t = threading.Thread(target=_run, daemon=True)
    pending.thread = t
    t.start()
    _PENDING.append(pending)
    return t


def wait_pending():
    """Join every in-flight async save; re-raise the FIRST write failure
    (in submission order) after all writers have stopped."""
    first: Optional[_PendingSave] = None
    for p in _PENDING:
        p.thread.join()
        if p.error is not None and first is None:
            first = p
    _PENDING.clear()
    if first is not None:
        raise first.error


def _write(root: str, step: int, paths, host_leaves, extra_files=None) -> str:
    final = os.path.join(root, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for i, (p, arr) in enumerate(zip(paths, host_leaves)):
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"path": p, "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)}
        )
    _write_extras(tmp, extra_files)
    _json_atomic(os.path.join(tmp, "manifest.json"), manifest)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # commit
    return final


def _write_extras(tmp: str, extra_files) -> None:
    for fname, blob in (extra_files or {}).items():
        if (fname in _RESERVED_FILES or fname.startswith("leaf_")
                or fname.startswith("host_")):
            raise ValueError(f"extra_files name {fname!r} collides with checkpoint layout")
        with open(os.path.join(tmp, fname), "wb") as f:
            f.write(blob)


def _json_atomic(path: str, obj) -> None:
    swap = path + ".swap"
    with open(swap, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(swap, path)


def _committed_steps(root: str) -> list[int]:
    """Step numbers of committed checkpoints: a ``step_*`` dir that is not a
    ``.tmp`` staging dir, parses as a step and holds a manifest — the one
    predicate :func:`latest_step` and :func:`gc_old` share."""
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


def read_extra_file(root: str, fname: str, *, step: int | None = None) -> bytes:
    """An ``extra_files`` sidecar of a committed checkpoint (latest step by
    default). Raises FileNotFoundError if the step or the sidecar is
    missing."""
    d, _ = step_dir(root, step)
    with open(os.path.join(d, fname), "rb") as f:
        return f.read()


def restore(root: str, template: Any, *, step: int | None = None):
    """Restore into the structure of ``template`` (dicts, NamedTuples,
    tuples, lists). A :class:`ShapeDtype` leaf comes back as a numpy array
    of its dtype; a tensor leaf as a tensor of its dtype on its device.
    Returns (tree, step). Raises on a leaf missing from the checkpoint
    (naming what each side has that the other lacks) or a shape that
    differs; leaves the template lacks are ignored."""
    d, step = step_dir(root, step)
    with open(os.path.join(d, "manifest.json")) as f:
        by_path = {e["path"]: e for e in json.load(f)["leaves"]}
    paths, _ = tu.flatten_with_paths(template)
    missing = [p for p in paths if p not in by_path]
    if missing:
        extra = sorted(set(by_path) - set(paths))
        raise ValueError(
            f"checkpoint {d} does not match the restore template: template leaves "
            f"missing from the checkpoint: {missing}; checkpoint leaves absent from "
            f"the template: {extra or '[]'} — the config that built the template "
            "differs from the one that saved the checkpoint"
        )

    def load(keys, tmpl):
        p = tu.keystr(keys)
        arr = np.load(os.path.join(d, by_path[p]["file"]))
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(f"shape mismatch at {p}: checkpoint {arr.shape} vs "
                             f"template {tuple(tmpl.shape)}")
        if isinstance(tmpl, torch.Tensor):
            return torch.from_numpy(arr).to(device=tmpl.device, dtype=tmpl.dtype)
        return arr.astype(tmpl.dtype)

    return tu.map_with_keys(load, template), step


def gc_old(root: str, keep: int = 3):
    """Keep the newest ``keep`` committed checkpoints and delete the rest.
    Uncommitted dirs neither count nor get deleted; an in-flight
    :func:`save_async` writer of a doomed step is joined first, so the
    delete cannot race its rename-commit."""
    committed = _committed_steps(root)
    doomed = committed[:-keep] if keep > 0 else committed
    if not doomed:
        return
    doomed_set = set(doomed)
    root_abs = os.path.abspath(root)
    for p in list(_PENDING):
        if p.root == root_abs and p.step in doomed_set:
            p.thread.join()
    for step in doomed:
        shutil.rmtree(os.path.join(root, f"step_{step:09d}"), ignore_errors=True)
