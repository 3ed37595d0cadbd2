"""Device choice, kernel launch counts and the CUDA kernel build.

* :func:`resolve_device` — entry points default to ``cuda`` and raise when
  no card is present; the CPU is used only when the caller asks for it.
* :data:`launches` — one count per kernel, bumped by each wrapper where it
  launches its kernel and nowhere else (the stand-in for
  ``repro.kernels.backend.count_pallas_calls``: "one launch per fused
  layer" is asserted with it).
* :func:`load_kernels` — builds every ``kernels/csrc/*.cu`` with ``nvcc``
  for ``sm_90a`` into a shared library with a plain C interface (one
  ``nvcc`` per source, all started together) and loads it with ``ctypes``.
  The build goes to ``_build/`` beside this file, keyed by a hash of the
  source, every ``csrc/*.cuh`` header and the flags, so an edited source
  or header rebuilds and an unchanged one is loaded as it is.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

CSRC = os.path.join(os.path.dirname(__file__), "kernels", "csrc")
BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # the kernels pin every float product with __fmul_rn & co.; no
    # contraction anywhere keeps them bit-equal to the eager plain versions
    "-fmad=false",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

# kernel name -> launches since the last reset
launches: collections.Counter = collections.Counter()

_libs: dict[str, ctypes.CDLL] = {}
_build_log: dict[str, str] = {}
_lock = threading.Lock()


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Raises when a CUDA device is asked for and
    none is present — nothing falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch versions on the CPU"
        )
    return dev


def reset_launches() -> None:
    launches.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> dict[str, str]:
    return {
        f[: -len(".cu")]: os.path.join(CSRC, f)
        for f in sorted(os.listdir(CSRC))
        if f.endswith(".cu")
    }


def _target(name: str, src: str) -> str:
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, f) for f in headers]:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def load_kernels() -> dict[str, ctypes.CDLL]:
    """Build (where needed) and load every kernel library. Returns
    {source name: CDLL}. Raises with nvcc's output if a build fails."""
    with _lock:
        todo = {
            name: (src, _target(name, src))
            for name, src in _sources().items()
            if name not in _libs
        }
        if not todo:
            return dict(_libs)
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        for name, (src, out) in todo.items():
            if os.path.exists(out):
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            procs[name] = (
                subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                ),
                tmp, out,
            )
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            _build_log[name] = log
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"{name}:\n{log}")
            else:
                os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        if failed:
            raise RuntimeError("CUDA kernel build failed\n" + "\n".join(failed))
        for name, (_, out) in todo.items():
            _libs[name] = ctypes.CDLL(out)
        return dict(_libs)


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) for
    a library built in this process; empty when it was loaded from disk."""
    return _build_log.get(name, "")


def check_launch(err: int, what: str) -> None:
    """Raise on the ``cudaGetLastError()`` value a C launcher returned."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
