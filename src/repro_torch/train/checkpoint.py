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
* Multi-controller: ``save(..., ctx=)`` under a multi-process launch
  stripes LEAF OWNERSHIP over the hosts (leaf i -> host i % n_hosts). Every
  host writes only the leaves it owns into the shared staging directory and
  posts a token-stamped ``host_N.done`` receipt; host 0, once it holds
  every receipt, writes the manifest and the ``shard_manifest.json``
  sidecar (who wrote what) and performs the one rename-commit. Leaves stay
  whole (a data-parallel state is the same on every host), so a striped
  checkpoint restores through :func:`restore` in one process, and in the
  JAX package's, like any other.
* Sharded state (``save(..., specs=)``, ``distributed/fsdp.py``): every
  host gathers each split leaf (a collective per leaf, in leaf order) and
  its owner writes it whole, as JAX's ``_full_host_array`` replicates a
  sharded leaf before writing, so the layout stays the one above.
  ``restore(..., specs=)`` reads only this process's slice of each split
  leaf (the file memory-mapped), so a checkpoint written by any number of
  processes resumes at any other — JAX's ``restore(shardings=)``.
"""
from __future__ import annotations

import json
import os
import secrets
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch import tree as tu
from repro_torch.distributed import fsdp, runtime

_RESERVED_FILES = ("manifest.json", "shard_manifest.json", "staging.json")

# how long one host waits on the others during a striped save before
# declaring the job wedged (a crashed peer, not a slow disk)
_HANDSHAKE_TIMEOUT_S = float(os.environ.get("REPRO_CKPT_HANDSHAKE_TIMEOUT", "120"))


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


def _leaf_meta(leaf) -> tuple[list, str]:
    """(shape, dtype) as the manifest records the leaf :func:`_host_array`
    would write, without copying it."""
    if isinstance(leaf, torch.Tensor):
        dt = torch.float32 if leaf.dtype == torch.bfloat16 else leaf.dtype
        return list(leaf.shape), str(torch.empty((), dtype=dt).numpy().dtype)
    arr = np.asarray(leaf)
    return list(arr.shape), str(arr.dtype)


def save(root: str, step: int, tree: Any, *,
         extra_files: Optional[Mapping[str, bytes]] = None, ctx=None, specs=None) -> str:
    """Synchronous atomic save. Returns the committed directory.

    ``extra_files``: {filename: bytes} sidecars (e.g. a config json) written
    into the staging dir before the rename, so they commit with the
    checkpoint.

    ``ctx``: the :class:`repro_torch.distributed.runtime.DistributedContext`
    (default: the process-wide one). Multi-controller: EVERY host calls save
    with the same arguments; each copies to the host and writes only the
    leaves it owns, and host 0 commits (:func:`_write_sharded`).

    ``specs``: ``tree``'s layout over the hosts (``fsdp.Shard`` per leaf);
    each split leaf is gathered and written whole."""
    ctx = ctx or runtime.get_context()
    paths, leaves = tu.flatten_with_paths(tree)
    if ctx.is_multi_controller:
        splits = tu.leaves(specs) if specs is not None else [fsdp.WHOLE] * len(leaves)
        return _write_sharded(root, step, paths, leaves, splits, extra_files, ctx)
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
    and re-raised by the next :func:`wait_pending` — call it before exit.

    Single-controller only: the striped save's cross-host handshake must
    not run on a background thread beside the step loop's collectives.
    Multi-controller jobs use :func:`save`."""
    if runtime.get_context().is_multi_controller:
        raise NotImplementedError(
            "save_async is single-controller only — multi-controller jobs must use the "
            "synchronous save(..., ctx=ctx) striped protocol")
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


def _read_json(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return None


def _wait_for(pred, desc: str, ctx) -> None:
    deadline = time.monotonic() + _HANDSHAKE_TIMEOUT_S
    while not pred():
        if time.monotonic() > deadline:
            raise RuntimeError(
                f"[{ctx.describe()}] striped-checkpoint handshake timed out after "
                f"{_HANDSHAKE_TIMEOUT_S:.0f}s waiting for {desc}")
        time.sleep(0.05)


def _write_sharded(root: str, step: int, paths, leaves, splits, extra_files, ctx) -> str:
    """Multi-controller save over a SHARED filesystem, the JAX package's
    protocol (token-stamped, so a retried save never consumes an earlier
    attempt's receipts):

      1. host 0 resets the staging dir and posts ``staging.json`` with a
         fresh token; the peers wait for it.
      2. every host writes the leaves it OWNS (leaf i -> host i % n_hosts;
         a split leaf gathered whole first, by every host) and posts a
         ``host_N.done`` receipt echoing the token.
      3. host 0 collects every receipt, writes ``shard_manifest.json``, the
         extra sidecars and ``manifest.json``, then rename-commits.
      4. the peers wait for the committed dir to carry their token.

    Each wait gives up after REPRO_CKPT_HANDSHAKE_TIMEOUT (default 120 s),
    naming the waiting host."""
    final = os.path.join(root, f"step_{step:09d}")
    tmp = final + ".tmp"
    h, n = ctx.host_id, ctx.n_hosts
    staging = os.path.join(tmp, "staging.json")

    if h == 0:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        token = secrets.token_hex(8)
        _json_atomic(staging, {"step": step, "token": token, "n_hosts": n})
    else:
        _wait_for(lambda: (_read_json(staging) or {}).get("step") == step,
                  f"host 0 to open staging for step {step}", ctx)
        token = _read_json(staging)["token"]

    owned_files, metas = [], []
    for i, (leaf, s) in enumerate(zip(leaves, splits)):
        if s.split:
            leaf = fsdp.all_gather_leaf(leaf, s, ctx)
        metas.append(_leaf_meta(leaf))
        if i % n != h:
            continue
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), _host_array(leaf))
        owned_files.append(fname)
        del leaf
    _json_atomic(os.path.join(tmp, f"host_{h}.done"),
                 {"token": token, "host": h, "files": owned_files})

    if h == 0:
        def receipts():
            got = [_read_json(os.path.join(tmp, f"host_{p}.done")) for p in range(n)]
            return all(r is not None and r.get("token") == token for r in got)

        _wait_for(receipts, "peer hosts' leaf receipts", ctx)
        _json_atomic(os.path.join(tmp, "shard_manifest.json"), {
            "token": token,
            "n_hosts": n,
            "striping": "leaf i -> host i % n_hosts",
            "hosts": {str(p): _read_json(os.path.join(tmp, f"host_{p}.done"))["files"]
                      for p in range(n)},
        })
        _write_extras(tmp, extra_files)
        manifest = {"step": step, "n_hosts": n, "leaves": []}
        for i, (p, (shape, dtype)) in enumerate(zip(paths, metas)):
            manifest["leaves"].append({"path": p, "file": f"leaf_{i:05d}.npy", "shape": shape,
                                       "dtype": dtype, "host": i % n})
        _json_atomic(os.path.join(tmp, "manifest.json"), manifest)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # the commit barrier: the peers unblock on it
    else:
        _wait_for(lambda: (_read_json(os.path.join(final, "shard_manifest.json")) or {})
                  .get("token") == token, f"host 0 to commit step {step}", ctx)
    return final


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


def restore(root: str, template: Any, *, step: int | None = None, specs: Any = None):
    """Restore into the structure of ``template`` (dicts, NamedTuples,
    tuples, lists). A :class:`ShapeDtype` leaf comes back as a numpy array
    of its dtype; a tensor leaf as a tensor of its dtype on its device.
    Returns (tree, step). Raises on a leaf missing from the checkpoint
    (naming what each side has that the other lacks) or a shape that
    differs; leaves the template lacks are ignored.

    ``specs``: the template's layout (``fsdp.Shard`` per leaf, this
    process's rank in each): a split leaf is read as this process's slice of
    the whole one the checkpoint holds, whatever the number of processes
    that wrote it."""
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

    splits = iter(tu.leaves(specs) if specs is not None else [])

    def load(keys, tmpl):
        p = tu.keystr(keys)
        s = next(splits, fsdp.WHOLE)
        arr = np.load(os.path.join(d, by_path[p]["file"]), mmap_mode="r" if s.split else None)
        if (fsdp.local_shape(arr.shape, s) != tuple(tmpl.shape)
                or (s.split and arr.shape[s.dim] != s.whole)):
            raise ValueError(f"shape mismatch at {p}: checkpoint {arr.shape} vs "
                             f"template {tuple(tmpl.shape)}" + (f" ({s})" if s.split else ""))
        if s.split:
            mine = np.zeros(tmpl.shape, arr.dtype)
            n = s.stop - s.start
            idx = (slice(None),) * s.dim
            mine[idx + (slice(0, n),)] = arr[idx + (slice(s.start, s.stop),)]
            arr = mine
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
