"""Kernel microbenchmarks (§III) on the port: the gated one-to-all conv, the
fused LIF and the bitmask matmul, each checked against its
:mod:`repro_torch.kernels.ref` oracle, with the accounting the ASIC
exposes in hardware:

  * cycle model: taps executed = nnz weights (zero-weight skipping),
  * compressed weight bytes read vs dense (bit-mask format),
  * fused LIF: the membrane never round-trips device memory between steps.

Counterpart of ``benchmarks/kernel_bench.py``. The gated and LIF checks are
exact (int32, int8 spikes); the matmul is held to |Δ| ≤ 1e-5·(|x|@|W|) +
1e-6 elementwise (f32 sums in another order than the oracle's). Any check
that fails raises.

``--fast`` runs only the fused layer-pipeline gate: the kernel executor's
head equal to the dense executor's bit for bit at the reduced e2e scale,
and the encoding layer's 8 bit-serial planes folded into ONE launch of the
fused kernel (counted by :data:`repro_torch.backend.launches` on the card,
by calls of the wrapper on the CPU, where the wrapper runs its plain
version).

  PYTHONPATH=src python -m repro_torch.benchmarks.kernel_bench [--fast] --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch import backend
from repro_torch.kernels import fused_pipeline as fp
from repro_torch.kernels import ops, ref

GATED_SHAPE = (1, 18, 32, 32)  # spikes (N, H, W, Cin), one 18×32 block
GATED_KOUT, GATED_DENSITY, SPIKE_RATE = 64, 0.2, 0.25
LIF_SHAPE = (4, 512, 32)  # (T, M, C)
LIF_THRESHOLD, LIF_LEAK = 0.5, 0.25
MATMUL_SHAPE = (64, 512, 256)  # (M, K, N)
MATMUL_CUT = 1.2  # |w| below it is pruned: ~77% sparse (paper's weight regime)
MATMUL_RTOL, MATMUL_ATOL = 1e-5, 1e-6  # of |x| @ |W|, elementwise


def make_inputs(seed: int = 0) -> dict:
    """The benchmark's inputs as numpy arrays, from ``default_rng(seed)``:
    spikes and pruned int8 conv weights, LIF synaptic currents, pruned f32
    matmul weights and activations."""
    rng = np.random.default_rng(seed)
    cin = GATED_SHAPE[-1]
    spikes = (rng.random(GATED_SHAPE) < SPIKE_RATE).astype(np.int8)
    w_conv = rng.integers(-127, 127, (3, 3, cin, GATED_KOUT)).astype(np.int8)
    w_conv[rng.random(w_conv.shape) > GATED_DENSITY] = 0
    psum = rng.standard_normal(LIF_SHAPE).astype(np.float32)
    m, k, nn = MATMUL_SHAPE
    w_mm = rng.standard_normal((k, nn)).astype(np.float32)
    w_mm[np.abs(w_mm) < MATMUL_CUT] = 0.0
    x_mm = rng.standard_normal((m, k)).astype(np.float32)
    return {"spikes": spikes, "w_conv": w_conv, "psum": psum, "w_mm": w_mm, "x_mm": x_mm}


def matmul_within(y: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                  want: torch.Tensor) -> bool:
    """|y − want| ≤ 1e-5·(|x| @ |W|) + 1e-6 elementwise, the scale in f64."""
    scale = x.double().abs() @ w.double().abs()
    return bool(((y.double() - want.double()).abs() <= MATMUL_RTOL * scale + MATMUL_ATOL).all())


def _timed(fn, dev: torch.device):
    """(result, wall seconds) of one call, the device synchronised around it."""
    backend.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    backend.synchronize(dev)
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def _counting_calls(module, name: str):
    """Count the calls of ``module.name`` inside the block: yields a list
    whose one entry is the count."""
    real, calls = getattr(module, name), [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    setattr(module, name, counted)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def run_fused(device=None) -> dict:
    """Fused layer-pipeline gate at the reduced e2e scale: dense-oracle
    parity (bit-exact) and the single-launch bit-serial encode."""
    from repro_torch.benchmarks.e2e_detector import reduced_config
    from repro_torch.core import plan as cplan
    from repro_torch.core import pruning
    from repro_torch.models import snn_yolo as sy

    dev = backend.resolve_device(device)
    cfg = reduced_config()
    params, bn = sy.init_params(cfg, seed=0, device=dev)
    params = pruning.prune_tree(params, 0.8)
    rng = np.random.default_rng(0)
    h, w_ = cfg.input_hw
    imgs = torch.from_numpy((rng.integers(0, 256, (1, h, w_, 3)) / 255.0).astype(
        np.float32)).to(dev)
    bn = sy.calibrate_bn_state(params, bn, imgs, cfg)

    heads = {}
    det = None
    for ex in ("dense", "pallas"):
        det = sy.compile_detector(dataclasses.replace(cfg, conv_exec=ex), params, bn,
                                  device=dev)
        _, heads[ex] = det.detect(imgs)
    err = float((heads["pallas"] - heads["dense"]).abs().max())
    print(f"fused_pipeline   : err={err:.2e} (kernel executor vs dense oracle)")
    if err != 0.0:
        raise AssertionError(f"fused pipeline diverges from dense oracle: {err}")

    # the encoding layer must be ONE launch: 8 bit planes folded by conv
    # linearity into a single fused kernel, not 8 serial sweeps
    pcfg = dataclasses.replace(cfg, conv_exec="pallas")
    spec = next(s for s in sy.layer_specs(pcfg) if s.name == "encode")
    before = backend.launches[fp.KERNEL]
    with _counting_calls(fp, "fused_pipeline") as calls:
        cplan.run_fused(
            imgs[None], det.plan.layers["encode"], pcfg,
            gamma=det.params["encode"]["gamma"], beta=det.params["encode"]["beta"],
            mean=det.bn_state["encode"]["mean"], var=det.bn_state["encode"]["var"],
            v0=None, out_t=spec.t_out)
    backend.synchronize(dev)
    launched = backend.launches[fp.KERNEL] - before
    # on the card every call launches the kernel; on the CPU none does
    n = launched if dev.type == "cuda" else calls[0]
    print(f"encode launches  : {n} (8 bit planes, one fused kernel; "
          f"{'kernel launches' if dev.type == 'cuda' else 'wrapper calls on the cpu'})")
    if n != 1 or calls[0] != 1:
        raise AssertionError(f"bit-serial encode must be 1 launch, got {n} "
                             f"({calls[0]} wrapper calls)")
    return {"fused_pipeline": {"max_err": err, "encode_dispatches": n}}


def run(device=None) -> dict:
    dev = backend.resolve_device(device)
    if dev.type == "cuda":
        backend.load_kernels()  # build (or load) before anything is timed
    inp = make_inputs(0)
    out: dict = {"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}

    # --- gated one-to-all product (sparse spike conv) ---
    wd = inp["w_conv"]
    x = torch.from_numpy(inp["spikes"].astype(np.uint8)).to(dev)
    packed = ops.pack_conv_weights(wd)
    weights = ops.packed_tensors(packed, dev)
    y, t_k = _timed(lambda: ops.gated_conv(x, packed, bh=18, bw=32, weights=weights), dev)
    y_ref = ref.gated_conv_ref(x, torch.from_numpy(wd).to(dev), bh=18, bw=32)
    err = int((y.long() - y_ref.long()).abs().max())
    nnz = int((wd != 0).sum())
    out["gated_one_to_all"] = {
        "max_err": err,
        "nnz_taps": nnz,
        "dense_taps": int(wd.size),
        "cycle_saving": 1 - nnz / wd.size,
        "weight_bytes_dense": int(wd.size),
        "weight_bytes_compressed": int(packed.compressed_bytes),
        "wall_s": t_k,
    }
    print(f"gated_one_to_all : err={err} cycle_saving="
          f"{out['gated_one_to_all']['cycle_saving'] * 100:.1f}% "
          f"bytes {packed.compressed_bytes}/{wd.size}")
    if err != 0:
        raise AssertionError(f"gated kernel must be exact vs oracle, max |Δ| {err}")

    # --- fused LIF ---
    cur = torch.from_numpy(inp["psum"]).to(dev)
    s_k, t_k = _timed(lambda: ops.fused_lif(cur, threshold=LIF_THRESHOLD, leak=LIF_LEAK), dev)
    s_r = ref.fused_lif_ref(cur, threshold=LIF_THRESHOLD, leak=LIF_LEAK)
    lif_err = float((s_k.float() - s_r.float()).abs().max())
    out["fused_lif"] = {"max_err": lif_err, "spike_rate": float(s_k.float().mean()),
                        "wall_s": t_k}
    print(f"fused_lif        : err={lif_err} rate={out['fused_lif']['spike_rate']:.3f}")
    if lif_err != 0.0:
        raise AssertionError(f"fused LIF spikes differ from the oracle: max |Δ| {lif_err}")

    # --- bitmask matmul ---
    w2 = inp["w_mm"]
    xs = torch.from_numpy(inp["x_mm"]).to(dev)
    w2_t = torch.from_numpy(w2).to(dev)
    pw = ops.pack_matmul_weights(w2).to(dev)
    y2, t_k = _timed(lambda: ops.bitmask_matmul(xs, pw), dev)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the oracle in full f32
    try:
        y2_ref = ref.bitmask_matmul_ref(xs, w2_t)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    mm_err = float((y2 - y2_ref).abs().max())
    within = matmul_within(y2, xs, w2_t, y2_ref)
    out["bitmask_matmul"] = {
        "max_err": mm_err,
        "within_tolerance": within,
        "density": float((w2 != 0).mean()),
        "compressed_bytes": int(pw.compressed_bytes),
        "dense_bytes": int(w2.size * 4),
        "wall_s": t_k,
    }
    print(f"bitmask_matmul   : err={mm_err:.2e} density={out['bitmask_matmul']['density']:.2f} "
          f"bytes {pw.compressed_bytes}/{int(w2.size * 4)}")
    if not within:
        raise AssertionError(f"bitmask matmul outside 1e-5·(|x|@|W|) + 1e-6: max |Δ| {mm_err}")
    out.update(run_fused(dev))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true",
                    help="fused-pipeline gate only (parity + launch count)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run_fused(args.device) if args.fast else run(args.device)


if __name__ == "__main__":
    main()
