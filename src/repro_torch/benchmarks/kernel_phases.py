"""Where a block's cycles go, in the two tensor-core kernels, on the card.

    PYTHONPATH=src python -m repro_torch.benchmarks.kernel_phases

Builds instrumented copies of ``csrc/fused_pipeline.cu`` and
``csrc/bitmask_matmul.cu`` (into a temporary directory, the sources in the
checkout untouched): thread 0 of every block reads ``clock64()`` around the
phases of its main loop and writes the sums to a device array. Each case
runs once on random seeded operands at the detector's and qwen1.5-0.5b's
FFN shapes; a line per case gives the mean and the largest count over the
blocks, in thousands of SM cycles:

* fused pipeline: ``setup`` (tap tables and the resident weights),
  ``issue`` (the next items' gathers), ``wait`` (their arrival and the
  barrier), ``mma`` (the tensor-core products), ``epi`` (drives, LIF,
  stores);
* bitmask matmul: ``prologue`` (the first ranks and slices), ``store_x``
  (decoded values to shared memory, x slices in flight), ``gather`` (ranks
  at K-block edges, value gathers), ``mma`` (products and slice sums),
  ``wait`` (x slices and the barrier).

The instrumented copies differ from the kernels only by the counters; a
source edit that moves an anchor makes the build stop with its name.
Needs a CUDA card and ``nvcc``; nothing of JAX.
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

from repro_torch import backend
from repro_torch.kernels import bitmask_matmul as bmm
from repro_torch.kernels import fused_pipeline as fp
from repro_torch.kernels import ops

N_BLOCKS = 4096  # counter rows; blocks past it are not counted
TAIL = """
extern "C" int phases_read(void* h) { return (int)cudaMemcpyFromSymbol(h, g_phases, sizeof(g_phases)); }
extern "C" int phases_clear() {
  static long long z[4096][6];
  return (int)cudaMemcpyToSymbol(g_phases, z, sizeof(z));
}
"""
DECL = "namespace {\n__device__ long long g_phases[4096][6];\n"
FUSED_PHASES = ("total", "setup", "issue", "wait", "mma", "epi")
MATMUL_PHASES = ("total", "prologue", "store_x", "gather", "mma", "wait")
# (kh, C, Kout, t_in, t_out, (H, W)) at batch 2, 80% of the weights pruned
FUSED_CASES = {
    "encode": (3, 8, 16, 1, 1, (576, 1024)),
    "conv_block": (3, 16, 32, 1, 3, (288, 512)),
    "stage0 1x1": (1, 32, 32, 3, 3, (144, 256)),
    "stage0 3x3": (3, 32, 32, 3, 3, (144, 256)),
    "stage2 3x3": (3, 128, 128, 3, 3, (36, 64)),
    "stage3 3x3": (3, 256, 256, 3, 3, (18, 32)),
    "stage3 3x3 T=16": (3, 256, 256, 16, 16, (18, 32)),
}
MATMUL_CASES = ((2048, 1024, 2816), (2048, 2816, 1024), (16, 1024, 2816))  # M, K, N


def _edit(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"anchor not found once: {old[:60]!r}")
        src = src.replace(old, new)
    return src.replace("namespace {\n", DECL, 1) + TAIL


def fused_source() -> str:
    src = open(os.path.join(backend.CSRC, "fused_pipeline.cu")).read()
    return _edit(src, [
        ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
         "  const long long c_start = clock64();\n"
         "  long long c_issue = 0, c_wait = 0, c_mma = 0, c_epi = 0, c_q;\n"
         "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"),
        ("      load_weights<BN>(p, wsm, n0);\n  }\n  __syncthreads();\n",
         "      load_weights<BN>(p, wsm, n0);\n  }\n  __syncthreads();\n"
         "  const long long c_setup = clock64() - c_start;\n"),
        ("    issue_next();\n    cp_async_wait<kStages - 1>();  // item it has landed\n"
         "    __syncthreads();\n",
         "    c_q = clock64();\n    issue_next();\n    c_issue += clock64() - c_q;\n"
         "    c_q = clock64();\n    cp_async_wait<kStages - 1>();\n    __syncthreads();\n"
         "    c_wait += clock64() - c_q;\n"),
        ("    // the tensor-core products of this item's k-steps\n    {",
         "    c_q = clock64();\n    {"),
        ("          if (ks + 1 < nks) mul(a1, b1);\n        }\n      }\n    }\n\n",
         "          if (ks + 1 < nks) mul(a1, b1);\n        }\n      }\n    }\n"
         "    c_mma += clock64() - c_q;\n    c_q = clock64();\n\n"),
        ("    __syncthreads();  // this item's buffer is free for item it + kStages\n  }\n}",
         "    __syncthreads();\n    c_epi += clock64() - c_q;\n  }\n"
         "  const int b = blockIdx.x + blockIdx.y * gridDim.x;\n"
         "  if (threadIdx.x == 0 && b < 4096) {\n"
         "    const long long v[6] = {clock64() - c_start, c_setup, c_issue, c_wait, c_mma, c_epi};\n"
         "    for (int i = 0; i < 6; ++i) g_phases[b][i] = v[i];\n  }\n}"),
    ])


def matmul_source() -> str:
    src = open(os.path.join(backend.CSRC, "bitmask_matmul.cu")).read()
    return _edit(src, [
        ("  if (s_lo < s_hi) {\n    uint32_t v[2][4], mb[4];",
         "  const long long c_start = clock64();\n"
         "  long long c_pro = 0, c_st = 0, c_ga = 0, c_mu = 0, c_wa = 0, c_q = clock64();\n"
         "  if (s_lo < s_hi) {\n    uint32_t v[2][4], mb[4];"),
        ("    cp_async_wait_all();\n    __syncthreads();\n    for (int s = s_lo; s < s_hi; ++s) {",
         "    cp_async_wait_all();\n    __syncthreads();\n    c_pro = clock64() - c_q;\n"
         "    for (int s = s_lo; s < s_hi; ++s) {\n      c_q = clock64();"),
        ("        load_x(s + 1, cur ^ 1);\n      }\n",
         "        load_x(s + 1, cur ^ 1);\n      }\n      c_st += clock64() - c_q;\n"
         "      c_q = clock64();\n"),
        ("        if (s + 3 < s_hi) load_mask(s + 3, mb);\n      }\n",
         "        if (s + 3 < s_hi) load_mask(s + 3, mb);\n      }\n      c_ga += clock64() - c_q;\n"
         "      c_q = clock64();\n"),
        ("      cp_async_wait_all();\n      __syncthreads();\n    }\n  }\n",
         "      c_mu += clock64() - c_q;\n      c_q = clock64();\n      cp_async_wait_all();\n"
         "      __syncthreads();\n      c_wa += clock64() - c_q;\n    }\n  }\n"
         "  const int b = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);\n"
         "  if (threadIdx.x == 0 && b < 4096) {\n"
         "    const long long v[6] = {clock64() - c_start, c_pro, c_st, c_ga, c_mu, c_wa};\n"
         "    for (int i = 0; i < 6; ++i) g_phases[b][i] = v[i];\n  }\n"),
    ])


def build(out_dir: str) -> dict:
    """{library name: CDLL} of the instrumented copies."""
    shutil.copy(os.path.join(backend.CSRC, "common.cuh"), out_dir)
    procs = {}
    for name, src in (("fused_pipeline", fused_source()), ("bitmask_matmul", matmul_source())):
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        so = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (subprocess.Popen([backend._nvcc(), *backend.NVCC_FLAGS, "-o", so, path],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"instrumented {name} did not build:\n{log}")
        libs[name] = ctypes.CDLL(so)
    return libs


def phases(lib, fn, names) -> dict:
    """Run ``fn`` once (after a warm-up) and return, per phase, the mean and
    the largest count over the blocks that ran, in thousands of cycles."""
    fn()
    torch.cuda.synchronize()
    lib.phases_clear()
    fn()
    torch.cuda.synchronize()
    counts = np.zeros((N_BLOCKS, 6), np.int64)
    lib.phases_read(counts.ctypes.data_as(ctypes.c_void_p))
    ran = counts[counts[:, 0] > 0]
    return {"blocks": len(ran), **{n: [round(ran[:, i].mean() / 1e3, 1),
                                       round(ran[:, i].max() / 1e3, 1)]
                                   for i, n in enumerate(names)}}


def run(seed: int = 0) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(tmp)
        saved = dict(backend.load_kernels())
        try:
            backend._libs.update(libs)
            bmm._launcher.cache_clear()
            fp._launcher.cache_clear()
            for m, k, n in MATMUL_CASES:
                w = torch.randn((k, n), generator=gen, device=dev)
                w[torch.rand((k, n), generator=gen, device=dev) >= 0.2] = 0
                x = torch.randn((m, k), generator=gen, device=dev)
                pw = ops.pack_matmul_weights(w).to(dev)
                rows[f"matmul {m}x{k}x{n}"] = phases(
                    libs["bitmask_matmul"], lambda: bmm.bitmask_matmul(x, pw), MATMUL_PHASES)
            for name, (kh, cin, kout, t_in, t_out, hw) in FUSED_CASES.items():
                wq = torch.randint(-127, 128, (kh, kh, cin, kout), generator=gen, device=dev)
                wq[torch.rand(wq.shape, generator=gen, device=dev) < 0.8] = 0
                pw = ops.pack_conv_weights(wq.to(torch.int8).cpu().numpy())
                live = ops.predecode(pw, dev)
                x = torch.randint(0, 256 if name == "encode" else 2, (t_in, 2, *hw, pw.cin),
                                  generator=gen, device=dev).to(torch.uint8)
                aff = ops.pad_affine(torch.rand((5, kout), generator=gen, device=dev), pw.kp)
                kw = dict(kout=kout, kh=kh, kw=kh, bh=18, bw=32, t_out=t_out, bn_scale=0.5,
                          threshold=0.5, leak=0.25)
                rows[f"fused {name}"] = phases(
                    libs["fused_pipeline"],
                    lambda: fp.fused_pipeline(x, live.w, live.taps, aff, None, **kw),
                    FUSED_PHASES)
        finally:
            backend._libs.update(saved)
            bmm._launcher.cache_clear()
            fp._launcher.cache_clear()
    return {"device": torch.cuda.get_device_name(0), "kcycles_mean_max": rows}


def main() -> int:
    backend.resolve_device("cuda")  # raises without a card: there is no CPU mode
    result = run()
    for case, row in result["kcycles_mean_max"].items():
        print(f"{case:28s} " + ", ".join(f"{k} {v[0]}/{v[1]}" if isinstance(v, list)
                                         else f"{k} {v}" for k, v in row.items()))
    print(json.dumps({"phase": "kernel_phases", **result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
