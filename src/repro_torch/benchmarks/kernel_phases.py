"""Where a block's cycles go, in the three tensor-core kernels, on the card.

    PYTHONPATH=src python -m repro_torch.benchmarks.kernel_phases

Builds instrumented copies of ``csrc/fused_pipeline.cu``,
``csrc/gated_one_to_all.cu`` (both on an instrumented copy of their shared
conv loop, ``csrc/igemm_conv.cuh``) and ``csrc/bitmask_matmul.cu`` (into a
temporary directory, the sources in the checkout untouched): thread 0 of
every block reads ``clock64()`` around the phases of its main loop and
writes the sums to a device array. Each case runs once on random seeded
operands at the detector's and qwen1.5-0.5b's FFN shapes; a line per case
gives the mean and the largest count over the blocks, in thousands of SM
cycles:

* fused pipeline: ``setup`` (tap tables and the resident weights),
  ``issue`` (the next items' gathers), ``wait`` (their arrival and the
  barrier), ``mma`` (the tensor-core products), ``epi`` (drives, LIF,
  stores);
* gated one-to-all: ``setup`` (the live taps, the ranks and the decode of
  the block's weights), then ``issue``, ``wait``, ``mma`` as above and
  ``epi`` (the int32 stores), at the converted detector's conv_block,
  stage0 and stage3/4 3×3 shapes at M = 32;
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
from repro_torch.kernels import gated_one_to_all as g2a
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
CONV_DECL = "namespace igemm {\n__device__ long long g_phases[4096][6];\n"
BLOCK = "const int b = blockIdx.x + blockIdx.y * gridDim.x;\n"
FUSED_PHASES = ("total", "setup", "issue", "wait", "mma", "epi")
GATED_PHASES = FUSED_PHASES
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
# (kh, C, kout, (M, H, W)) at 80% of the weights pruned: the converted
# detector's conv_block, stage0 and stage3/4 3x3 at T=16, batch 2
GATED_CASES = {
    "conv_block": (3, 16, 32, (32, 288, 512)),
    "stage0 3x3": (3, 32, 32, (32, 144, 256)),
    "stage3 3x3": (3, 256, 256, (32, 18, 32)),
}


def _edit(src: str, edits, decl: str = DECL, tail: str = TAIL) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"anchor not found once: {old[:60]!r}")
        src = src.replace(old, new)
    return src.replace(decl.split("\n")[0] + "\n", decl, 1) + tail


def conv_source() -> str:
    """The shared conv loop with the loop phases counted: its issue, wait,
    mma and epi counts are added into the block's row (a kernel may run the
    loop more than once); the kernels count set-up and total."""
    src = open(os.path.join(backend.CSRC, "igemm_conv.cuh")).read()
    return _edit(src, [
        ("  const bool pair = kHalo1 && halo && p.cc == 16;  // two taps per k-step\n",
         "  const bool pair = kHalo1 && halo && p.cc == 16;  // two taps per k-step\n"
         "  long long c_issue = 0, c_wait = 0, c_mma = 0, c_epi = 0, c_q;\n"),
        ("    issue_next();\n    cp_async_wait<kStages - 1>();  // item it has landed\n"
         "    __syncthreads();\n",
         "    c_q = clock64();\n    issue_next();\n    c_issue += clock64() - c_q;\n"
         "    c_q = clock64();\n    cp_async_wait<kStages - 1>();\n    __syncthreads();\n"
         "    c_wait += clock64() - c_q;\n"),
        ("    // the tensor-core products of this item's k-steps\n    {",
         "    c_q = clock64();\n    {"),
        ("    if (ch == gm.nch - 1) epi(acc, ps, ntb, rp);  // the pass's convs are complete\n",
         "    c_mma += clock64() - c_q;\n    c_q = clock64();\n"
         "    if (ch == gm.nch - 1) epi(acc, ps, ntb, rp);\n"),
        ("    __syncthreads();  // this item's buffer is free for item it + kStages\n  }\n}",
         "    __syncthreads();\n    c_epi += clock64() - c_q;\n  }\n"
         "  " + BLOCK +
         "  if (threadIdx.x == 0 && b < 4096) {\n"
         "    g_phases[b][2] += c_issue;\n    g_phases[b][3] += c_wait;\n"
         "    g_phases[b][4] += c_mma;\n    g_phases[b][5] += c_epi;\n  }\n}"),
    ], decl=CONV_DECL, tail="")


def _record(setup: str) -> str:
    """Thread 0 writes the block's total and set-up counts."""
    return ("  {\n    " + BLOCK + "    if (threadIdx.x == 0 && b < 4096) {\n"
            "      g_phases[b][0] = clock64() - c_start;\n"
            f"      g_phases[b][1] = {setup};\n    }}\n  }}\n}}")


TAIL_CONV = TAIL.replace("g_phases", "igemm::g_phases")


def fused_source() -> str:
    src = open(os.path.join(backend.CSRC, "fused_pipeline.cu")).read()
    return _edit(src, [
        ("  const int tid = threadIdx.x;\n  const int n0 = blockIdx.y * BN;\n",
         "  const long long c_start = clock64();\n"
         "  const int tid = threadIdx.x;\n  const int n0 = blockIdx.y * BN;\n"),
        ("smem + p.off_partial));\n  }\n  __syncthreads();\n",
         "smem + p.off_partial));\n  }\n  __syncthreads();\n"
         "  const long long c_setup = clock64() - c_start;\n"),
        ("  conv_tiles<T, kStream>(p, gm, smem, n0, epilogue);\n}",
         "  conv_tiles<T, kStream>(p, gm, smem, n0, epilogue);\n" + _record("c_setup")),
    ], decl="namespace {\n", tail=TAIL_CONV)


def gated_source() -> str:
    src = open(os.path.join(backend.CSRC, "gated_one_to_all.cu")).read()
    return _edit(src, [
        ("  const int tid = threadIdx.x;\n  const int n0 = blockIdx.y * BN;\n",
         "  const long long c_start = clock64();\n"
         "  const int tid = threadIdx.x;\n  const int n0 = blockIdx.y * BN;\n"),
        ("  const int n_live = *live_n, kreal = n_live * p.c;\n",
         "  const int n_live = *live_n, kreal = n_live * p.c;\n"
         "  long long c_setup = clock64() - c_start;\n"),
        ("    fill_tables(p, gm, halo, tdh, tdw, toff, units);\n",
         "    const long long c_s = clock64();\n"
         "    fill_tables(p, gm, halo, tdh, tdw, toff, units);\n"),
        ("    const bool add = kbase > 0;\n",
         "    c_setup += clock64() - c_s;\n    const bool add = kbase > 0;\n"),
        ("      store(acc[0], ps, rp, add);\n    });\n  }\n}",
         "      store(acc[0], ps, rp, add);\n    });\n  }\n" + _record("c_setup")),
    ], decl="namespace {\n", tail=TAIL_CONV)


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
    with open(os.path.join(out_dir, "igemm_conv.cuh"), "w") as f:
        f.write(conv_source())
    procs = {}
    for name, src in (("fused_pipeline", fused_source()), ("gated_one_to_all", gated_source()),
                      ("bitmask_matmul", matmul_source())):
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
            g2a._launcher.cache_clear()
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
            for name, (kh, cin, kout, (m, h, w)) in GATED_CASES.items():
                wq = torch.randint(-127, 128, (kh, kh, cin, kout), generator=gen, device=dev)
                wq[torch.rand(wq.shape, generator=gen, device=dev) < 0.8] = 0
                pw = ops.pack_conv_weights(wq.to(torch.int8).cpu().numpy(),
                                           kblk=min(128, -(-kout // 8) * 8))
                dev_w = ops.packed_tensors(pw, dev)
                x = torch.randint(0, 2, (m, h, w, pw.cin), generator=gen,
                                  device=dev).to(torch.uint8)
                kw = dict(kout=kout, kh=kh, kw=kh, bh=18, bw=32)
                rows[f"gated {name}"] = phases(
                    libs["gated_one_to_all"], lambda: g2a.gated_one_to_all(x, *dev_w, **kw),
                    GATED_PHASES)
                rows[f"gated {name}"]["plan"] = g2a.last_plan()
        finally:
            backend._libs.update(saved)
            bmm._launcher.cache_clear()
            fp._launcher.cache_clear()
            g2a._launcher.cache_clear()
    return {"device": torch.cuda.get_device_name(0), "kcycles_mean_max": rows}


def main() -> int:
    backend.resolve_device("cuda")  # raises without a card: there is no CPU mode
    result = run()
    for case, row in result["kcycles_mean_max"].items():
        print(f"{case:28s} " + ", ".join(f"{k} {v[0]}/{v[1]}" if isinstance(v, list)
                                         else f"{k} {v}" for k, v in row.items()
                                         if k != "plan"))
    print(json.dumps({"phase": "kernel_phases", **result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
