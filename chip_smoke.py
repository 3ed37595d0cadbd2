"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and the last line is never printed):

1. Device: require CUDA, print the card's name and power limit, build the
   CUDA kernels from ``src/repro_torch/kernels/csrc`` and time the build.
2. Kernel vs plain version at every fused layer shape of the full-width
   ``snn-det`` config (576×1024, block 18×32, channels 3→16 … 256, (1, 3)
   mixed time), hard reset from a cold membrane and soft reset from a warm
   one, in both weight modes (predecoded, and packed with the decode in
   the kernel): spikes and membranes must be bit-equal.
3. The serving slice at full width: seeded ``demo_weights`` (pruned 0.8,
   tdBN-calibrated, TF32 off), ``compile_detector`` with the kernel
   executor, a ``DetectorSession`` over batch 2 × 3 frames. 27 kernel
   launches per frame; the head equal to the dense executor's on the card;
   detections equal; spikes flowing in stage4; every layer's real inputs
   replayed through the kernel and its plain version, bit-equal.
4. Times (CUDA events): per layer (kernel, plain version, cuDNN conv
   yardstick, byte/op bound) and per frame, each with the card's name and
   power limit.

The unfused kernel executor (the ANN→SNN conversion's operating point):

a. The gated one-to-all kernel against its plain version at every encode
   and 3×3 layer shape of ``CONFIG`` (12 shapes; T·N = 16·2 for the spike
   layers), random weights pruned 0.8, plus a layer whose taps are all
   dead: int32 bit-equal. Times per shape: kernel, plain version, one
   ``F.conv2d`` (f32, TF32 off) over the replicate-padded blocks, bound.
b. The fused kernel at T=16 (its streamed time loop) at every fused shape,
   hard/cold and soft/warm, bit-equal to its plain version, with times.
c. ``CONFIG`` at ``repro.convert.emit.target_config``'s settings (soft
   reset, v_init 0.25, leak 1, rate encode, rate pool, final readout,
   T=16, pool_drive) over batch 2 × 3 frames: 22 fused and 2 gated
   launches per frame, head, detections and every membrane bit-equal to
   the dense executor on the card, spikes reaching stage4; then one
   ``forward(..., taps=)``: 12 gated launches, 0 fused, every tap
   bit-equal to the dense executor's. The main path's gated layers are
   replayed through kernel and plain version, and timed; one frame of
   each session is timed.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists each kernel with its launches, error and times.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, data sheet
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak, data sheet
BATCH, N_FRAMES, SEED = 2, 3, 0
CONVERTED_T = 16  # the converted detector's T (target_config: 64-128), cut to fit the run


def card() -> dict:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    return {"nvidia_smi": out, "name": torch.cuda.get_device_name(0)}


def device_ms(fn, reps: int = 20) -> tuple[float, float]:
    """(device ms, host ms) per call of ``fn``. The calls are queued behind
    a spin kernel, so the events around them time the device alone even
    where the host takes longer to issue a call than the device to run it;
    the host time per call is measured while it queues them."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for cycles in (2e8, 1e9, 5e9):
        torch.cuda._sleep(int(cycles))
        start.record()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        host = (time.perf_counter() - t) / reps * 1e3
        stop.record()
        ahead = not start.query()  # the device was still spinning: all calls queued
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(stop) / reps, host
    raise AssertionError("the host could not queue the calls ahead of the device")


def elapsed_ms(fn, reps: int = 3) -> float:
    """Device-timeline ms per call of ``fn`` by CUDA events, for the plain
    versions: they synchronise with the host inside (a ``.tolist()``), so
    the gaps the device waits for the host are part of their time."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def layer_bound(args: dict) -> tuple[float, str]:
    """Least time for one layer on the card: each input byte read once,
    each output byte written once, against the int8 operations the
    layer's nonzero weights need on this input (2 per MAC)."""
    x, w, v0, kout, t_out = args["x"], args["w"], args["v0"], args["kout"], args["t_out"]
    t_in, n, h, wd, _ = x.shape
    npix = n * h * wd
    nbytes = (x.numel() + w.numel() + args["affine"].numel() * 4
              + (0 if v0 is None else v0.numel() * 4) + t_out * npix * kout + npix * kout * 4)
    ops = 2 * t_in * npix * int(torch.count_nonzero(w))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def random_fused_layer(gen, dev, name: str, shape, hw, t_in: int):
    """A fused layer at full width from ``gen``: random int8 weights (3×3
    pruned 0.8), random spikes (u8 pixels for encode, channels past 3
    zero), an affine bundle scaled to the layer's fan-in. Returns
    (x, packed, predecoded, affine)."""
    from repro_torch.kernels import ops

    kh, kw, cin, kout = shape
    wq = torch.randint(-127, 128, (kh, kw, cin, kout), generator=gen, device=dev)
    if kh > 1:
        wq[torch.rand(wq.shape, generator=gen, device=dev) < 0.8] = 0
    pw = ops.pack_conv_weights(wq.to(torch.int8).cpu().numpy())
    x = torch.randint(0, 256 if name == "encode" else 2, (t_in, BATCH, *hw, pw.cin),
                      generator=gen, device=dev).to(torch.uint8)
    x[..., cin:] = 0
    fan = kh * kw * cin * (127.0 if name == "encode" else 1.0)
    rows = torch.stack([
        torch.full((kout,), 1.0 / fan, device=dev),
        torch.randn(kout, generator=gen, device=dev) * 2,
        torch.rand(kout, generator=gen, device=dev) + 0.5,
        torch.randn(kout, generator=gen, device=dev),
        torch.randn(kout, generator=gen, device=dev) * 0.5,
    ])
    return x, pw, ops.predecode(pw, dev), ops.pad_affine(rows, pw.kp)


def gated_bound(x, dev_w, kout: int, nnz: int) -> tuple[float, str]:
    """Least time for one gated conv: the u8 input read once, the int32
    output written once, the compressed weights read once, against the int8
    operations of the layer's nonzero weights on every pixel (2 per MAC)."""
    m, h, w, _ = x.shape
    npix = m * h * w
    nbytes = x.numel() + npix * kout * 4 + sum(t.numel() * t.element_size() for t in dev_w)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * npix * nnz / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def gated_library(x, dense_w, bh: int, bw: int):
    """(fn, check): one ``F.conv2d`` in f32 (TF32 off) over the replicate-
    padded blocks, computing the gated conv's integers; ``check(out)`` says
    whether its result equals the kernel's int32 ``out``."""
    from repro_torch.core import block_conv as bc

    kh = dense_w.shape[0]
    pad = (kh - 1) // 2
    m, h, w, c = x.shape
    xb = bc.to_blocks(x.float(), bh, bw).reshape(-1, bh, bw, c).permute(0, 3, 1, 2)
    if pad:
        xb = torch.nn.functional.pad(xb, (pad, pad, pad, pad), mode="replicate")
    xb = xb.contiguous(memory_format=torch.channels_last)
    wf = dense_w.float().permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    def fn():
        return torch.nn.functional.conv2d(xb, wf)

    def check(out):
        y = fn().permute(0, 2, 3, 1).reshape(m, h // bh, w // bw, bh, bw, -1)
        return bool(torch.equal(bc.from_blocks(y), out.float()))

    return fn, check


def phase_gated(dev, cfg, tag) -> dict:
    """(a) the gated kernel against its plain version at full width."""
    from repro_torch.kernels import gated_one_to_all as g2a
    from repro_torch.kernels import ops
    from repro_torch.models import snn_yolo as sy

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    shapes = sy.layer_shapes(cfg)
    bh, bw = cfg.block_hw
    names = ["encode", "conv_block"] + [
        f"stage{i}/main_{ab}" for i in range(len(cfg.stage_channels)) for ab in "ab"]
    rows, max_err = [], 0.0
    for name in names + ["conv_block (all taps dead)"]:
        layer = name.split(" ")[0]
        lh, lw = sy.layer_hw(cfg)[layer]
        kh, kw, cin, kout = shapes[layer]
        wq = torch.randint(-127, 128, (kh, kw, cin, kout), generator=gen, device=dev)
        wq[torch.rand(wq.shape, generator=gen, device=dev) < 0.8] = 0
        if "dead" in name:
            wq.zero_()
        wq = wq.to(torch.int8)
        pw = ops.pack_conv_weights(wq.cpu().numpy(), kblk=min(128, -(-kout // 8) * 8))
        dev_w = ops.packed_tensors(pw, dev)
        m = BATCH if layer == "encode" else BATCH * CONVERTED_T
        x = torch.randint(0, 256 if layer == "encode" else 2, (m, lh, lw, pw.cin),
                          generator=gen, device=dev).to(torch.uint8)
        x[..., cin:] = 0
        kwargs = dict(kout=kout, kh=kh, kw=kw, bh=bh, bw=bw)
        out = g2a.gated_one_to_all(x, *dev_w, **kwargs)
        want = g2a.gated_one_to_all_reference(x, *dev_w, **kwargs)
        torch.cuda.synchronize()
        err = float((out.double() - want.double()).abs().max())
        max_err = max(max_err, err)
        if not bits_equal(out, want):
            raise AssertionError(f"gated kernel != plain version at {name}: max |Δ| {err}")
        ms, host_ms = device_ms(lambda: g2a.gated_one_to_all(x, *dev_w, **kwargs))
        plain_ms = elapsed_ms(lambda: g2a.gated_one_to_all_reference(x, *dev_w, **kwargs))
        lib, lib_check = gated_library(x[..., :cin], wq, bh, bw)
        with sy._no_tf32():
            lib_ms, _ = device_ms(lib)
            lib_exact = lib_check(out)
        nnz = int(torch.count_nonzero(wq))
        bound, by = gated_bound(x, dev_w, kout, nnz)
        row = {"layer": name, "x": list(x.shape), "kout": kout, "nnz": nnz,
               "live_taps": len(pw.tap_alive), "bit_equal": True, "max_abs_err": err,
               "ms": ms, "host_ms": host_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "library_equal": lib_exact, "bound_ms": bound, "bound_by": by}
        rows.append(row)
        print(json.dumps({"phase": "gated_vs_plain", **row, **tag}), flush=True)
    return {"rows": rows, "max_abs_err": max_err}


def phase_fused_t16(dev, cfg, tag) -> dict:
    """(b) the fused kernel at T=16 (its streamed time loop), every shape."""
    from repro_torch.kernels import fused_pipeline as fp
    from repro_torch.models import snn_yolo as sy

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    shapes = sy.layer_shapes(cfg)
    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    max_err, n_checked = 0.0, 0
    for name, (lh, lw) in sy.layer_hw(cfg).items():
        if name == "head":
            continue
        kh, kw, cin, kout = shapes[name]
        t_in = 1 if name == "encode" else CONVERTED_T
        x, pw, live, affine = random_fused_layer(gen, dev, name, shapes[name], (lh, lw), t_in)
        for reset, warm in (("hard", False), ("soft", True)):
            v0 = torch.randn((BATCH, lh, lw, kout), generator=gen, device=dev) if warm else None
            a = dict(kout=kout, kh=kh, kw=kw, bh=cfg.block_hw[0], bw=cfg.block_hw[1],
                     t_out=CONVERTED_T, bn_scale=cfg.threshold, threshold=cfg.threshold,
                     leak=1.0 if warm else cfg.leak, reset=reset, v_init=0.25)
            spk, mem = fp.fused_pipeline(x, live.w, live.taps, affine, v0, **a)
            rspk, rmem = fp.fused_pipeline_reference(x, live.w, live.taps, affine, v0, **a)
            torch.cuda.synchronize()
            err = float((mem - rmem).abs().max())
            max_err = max(max_err, err)
            if not (bits_equal(spk, rspk) and bits_equal(mem, rmem)):
                raise AssertionError(
                    f"fused kernel != plain version at {name}, T={CONVERTED_T} ({reset}): "
                    f"max |Δmem| {err}, spike mismatches {int((spk != rspk).sum())}")
            n_checked += 1
        ms, _ = device_ms(lambda: fp.fused_pipeline(x, live.w, live.taps, affine, v0, **a))
        plain_ms = elapsed_ms(
            lambda: fp.fused_pipeline_reference(x, live.w, live.taps, affine, v0, **a), reps=2)
        bound, _ = layer_bound(dict(x=x, w=live.w, v0=v0, kout=kout, t_out=CONVERTED_T,
                                    affine=affine))
        total["ms"] += ms
        total["plain_ms"] += plain_ms
        total["bound_ms"] += bound
        print(json.dumps({"phase": "fused_t16", "layer": name, "x": list(x.shape),
                          "kout": kout, "bit_equal": True, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound, "spike_rate": float(rspk.float().mean())}))
    out = {"checks": n_checked, "max_abs_err": max_err, "t": CONVERTED_T,
           **{f"{k}_per_frame": v for k, v in total.items()}}
    print(json.dumps({"phase": "fused_t16", **out, **tag}), flush=True)
    return out


def phase_converted(dev, tag) -> dict:
    """(c) the conversion's operating point at full width, through the
    unfused kernel executor."""
    from repro_torch import backend
    from repro_torch.configs.snn_det import CONFIG
    from repro_torch.kernels import fused_pipeline as fp
    from repro_torch.kernels import gated_one_to_all as g2a
    from repro_torch.models import snn_yolo as sy
    from repro_torch.serve.detector import demo_weights, synth_streams

    cfg = dataclasses.replace(
        CONFIG, reset="soft", v_init=0.25, leak=1.0, rate_encode=True,
        pool_mode="rate", head_readout="final", full_t=CONVERTED_T, pool_drive=True,
        conv_exec="pallas")
    t0 = time.perf_counter()
    params, bn, rng = demo_weights(cfg, prune_rate=0.8, seed=SEED, calib_batch=BATCH, device=dev)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    frames = torch.from_numpy(np.stack(synth_streams(rng, BATCH, N_FRAMES, cfg.input_hw),
                                       axis=1)).to(dev)
    det = sy.compile_detector(cfg, params, bn, device=dev)
    oracle = sy.compile_detector(dataclasses.replace(cfg, conv_exec="dense"), params, bn,
                                 device=dev)

    captured = []  # the gated kernel's real inputs on frame 0, for replay below
    real_g = g2a.gated_one_to_all

    def capture(*args, **kwargs):
        if len(captured) < 2:
            captured.append((tuple(a.clone() for a in args), dict(kwargs)))
        return real_g(*args, **kwargs)

    sess = det.new_session(batch=BATCH)
    steps = []
    g2a.gated_one_to_all = capture
    try:
        backend.reset_launches()
        torch.cuda.synchronize()
        for k in range(N_FRAMES):
            steps.append(sess.step(frames[k]))
        torch.cuda.synchronize()
        launches = {"fused": backend.launches[fp.KERNEL], "gated": backend.launches[g2a.KERNEL]}
    finally:
        g2a.gated_one_to_all = real_g
    if launches != {"fused": 22 * N_FRAMES, "gated": 2 * N_FRAMES}:
        raise AssertionError(f"converted session launches {launches} in {N_FRAMES} frames; "
                             "want 22 fused and 2 gated per frame")
    osess = oracle.new_session(batch=BATCH)
    for k in range(N_FRAMES):
        o, s_ = osess.step(frames[k]), steps[k]
        if not torch.isfinite(s_.head).all():
            raise AssertionError(f"converted session: non-finite head at frame {k}")
        if not bits_equal(s_.head, o.head):
            raise AssertionError(f"converted session head != dense head at frame {k}: "
                                 f"max |Δ| {float((s_.head - o.head).abs().max())}")
        for f in ("valid", "classes"):
            if not torch.equal(getattr(s_.detections, f), getattr(o.detections, f)):
                raise AssertionError(f"converted session detections.{f} differ at frame {k}")
    for name in sess.state:
        if tuple(sess.state[name].shape) != tuple(osess.state[name].shape) or not bits_equal(
                sess.state[name], osess.state[name]):
            raise AssertionError(f"converted session membrane {name} differs from dense")
    if tuple(sess.state["encode"].shape[1:3]) != (cfg.input_hw[0] // 2, cfg.input_hw[1] // 2):
        raise AssertionError(f"pool_drive: encode membrane {tuple(sess.state['encode'].shape)}")

    taps, otaps = {}, {}
    backend.reset_launches()
    _, _, aux = sy.forward(det.params, det.bn_state, frames[0], cfg, plan=det.plan,
                           affines=det._affines, taps=taps)
    torch.cuda.synchronize()
    taps_launches = {"fused": backend.launches[fp.KERNEL], "gated": backend.launches[g2a.KERNEL]}
    if taps_launches != {"fused": 0, "gated": 12}:
        raise AssertionError(f"taps= forward launches {taps_launches}; want 12 gated, 0 fused")
    sy.forward(oracle.params, oracle.bn_state, frames[0], oracle.cfg, plan=oracle.plan,
               taps=otaps)
    if set(taps) != set(otaps) or not all(bits_equal(taps[k], otaps[k]) for k in taps):
        bad = [k for k in taps if not bits_equal(taps[k], otaps.get(k, taps[k] + 1))]
        raise AssertionError(f"taps differ from the dense executor's: {bad}")
    rates = {k: float(v.float().mean()) for k, v in aux["spikes"].items()}
    if not rates["stage4"] > 0:
        raise AssertionError(f"converted: no spikes reach stage4: rates {rates}")
    print(json.dumps({"phase": "converted", "calibration_s": calib_s, "t": CONVERTED_T,
                      "launches": launches, "launches_per_frame": {
                          k: v / N_FRAMES for k, v in launches.items()},
                      "taps_launches": taps_launches, "taps": len(taps),
                      "head_equal_dense": True, "membranes_equal_dense": True,
                      "taps_equal_dense": True,
                      "valid_per_frame": [int(s_.detections.valid.sum()) for s_ in steps],
                      "spike_rates": rates, **tag}), flush=True)

    # (d) the main path's gated layers replayed: kernel vs plain, and times
    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    max_err, bound_by, lib_equal = 0.0, {"bytes": 0.0, "operations": 0.0}, True
    for name, (args, kwargs) in zip(("encode", "conv_block"), captured):
        out = g2a.gated_one_to_all(*args, **kwargs)
        want = g2a.gated_one_to_all_reference(*args, **kwargs)
        torch.cuda.synchronize()
        max_err = max(max_err, float((out.double() - want.double()).abs().max()))
        if not bits_equal(out, want):
            raise AssertionError(f"gated kernel != plain version on the main path's {name}")
        ms, host_ms = device_ms(lambda: g2a.gated_one_to_all(*args, **kwargs))
        plain_ms = elapsed_ms(lambda: g2a.gated_one_to_all_reference(*args, **kwargs))
        w = det.plan.layers[name].w_q
        lib, lib_check = gated_library(args[0][..., : w.shape[2]], w, *cfg.block_hw)
        with sy._no_tf32():
            lib_ms, _ = device_ms(lib)
            lib_equal = lib_equal and lib_check(out)
        bound, by = gated_bound(args[0], args[1:], kwargs["kout"], det.plan.layers[name].nnz)
        bound_by[by] += bound
        for k_, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound),
                      ("library_ms", lib_ms)):
            total[k_] += v
        print(json.dumps({"phase": "gated_layer_time", "layer": name,
                          "x": list(args[0].shape), "kout": kwargs["kout"], "ms": ms,
                          "host_ms": host_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                          "bound_ms": bound, "bound_by": by, **tag}))
    return {"det": det, "frames": frames, "launches": launches, "taps_launches": taps_launches,
            "total": total, "bound_by": max(bound_by, key=bound_by.get),
            "library_equal": lib_equal, "max_abs_err": max_err}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — needs a CUDA card",
              file=sys.stderr)
        return 2
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: {src}/repro_torch not found — run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch import backend
    from repro_torch.configs.snn_det import CONFIG
    from repro_torch.kernels import fused_pipeline as fp
    from repro_torch.models import snn_yolo as sy
    from repro_torch.serve.detector import demo_weights, synth_streams

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    info = card()
    print(info["nvidia_smi"], flush=True)
    tag = {"card": info["name"], "nvidia_smi": info["nvidia_smi"]}

    # ---------------------------------------------------- 1. build kernels
    t0 = time.perf_counter()
    libs = backend.load_kernels()
    build_s = time.perf_counter() - t0
    print(json.dumps({"phase": "build", "seconds": build_s, "libraries": sorted(libs), **tag}))
    for name in libs:
        log = backend.build_log(name)
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(json.dumps({"phase": "ptxas", "library": name, "lines": regs}))

    # ------------------------------------ 2. kernel vs plain, full width
    cfg = dataclasses.replace(CONFIG, conv_exec="pallas")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shapes = sy.layer_shapes(cfg)
    max_err, n_checked, packed_total = 0.0, 0, 0.0
    for name, (lh, lw) in sy.layer_hw(cfg).items():
        if name == "head":  # the head is a plain matmul, not the kernel
            continue
        kh, kw, cin, kout = shapes[name]
        t_in = 1 if name in ("encode", "conv_block") else cfg.full_t
        t_out = 1 if name == "encode" else cfg.full_t
        x, pw, live, affine = random_fused_layer(gen, dev, name, shapes[name], (lh, lw), t_in)
        maskp = torch.from_numpy(pw.maskp).to(dev)
        vals = torch.from_numpy(pw.vals).to(dev)
        for reset, warm in (("hard", False), ("soft", True)):
            v0 = torch.randn((BATCH, lh, lw, kout), generator=gen, device=dev) if warm else None
            kw_args = dict(kout=kout, kh=kh, kw=kw, bh=cfg.block_hw[0], bw=cfg.block_hw[1],
                           t_out=t_out, bn_scale=cfg.threshold, threshold=cfg.threshold,
                           leak=cfg.leak, reset=reset, v_init=cfg.v_init)
            rspk, rmem = fp.fused_pipeline_reference(x, live.w, live.taps, affine, v0, **kw_args)
            # the packed mode against its own plain version: decode, then the same chain
            pspk, pmem = fp.fused_pipeline_reference(
                x, fp.decode_packed(maskp, vals, live.taps), live.taps, affine, v0, **kw_args)
            for mode, (spk, mem), (want_spk, want_mem) in (
                ("predecoded", fp.fused_pipeline(x, live.w, live.taps, affine, v0, **kw_args),
                 (rspk, rmem)),
                ("packed", fp.fused_pipeline_packed(x, maskp, vals, live.taps, affine, v0,
                                                    **kw_args), (pspk, pmem)),
            ):
                torch.cuda.synchronize()
                err = float((mem - want_mem).abs().max())
                max_err = max(max_err, err,
                              float((spk.float() - want_spk.float()).abs().max()))
                if not (bits_equal(spk, want_spk) and bits_equal(mem, want_mem)):
                    raise AssertionError(
                        f"{mode} kernel != plain version at {name} ({reset}, warm={warm}): "
                        f"max |Δmem| {err}, spike mismatches "
                        f"{int((spk != want_spk).sum())} of {spk.numel()}"
                    )
                n_checked += 1
            rate = float(rspk.float().mean())
        packed_ms, _ = device_ms(
            lambda: fp.fused_pipeline_packed(x, maskp, vals, live.taps, affine, v0, **kw_args))
        packed_total += packed_ms
        print(json.dumps({"phase": "kernel_vs_plain", "layer": name,
                          "x": list(x.shape), "kout": kout, "live_taps": len(live.taps),
                          "spike_rate": rate, "bit_equal": True, "packed_ms": packed_ms}))
    print(json.dumps({"phase": "kernel_vs_plain", "checks": n_checked,
                      "max_abs_err": max_err, "packed_ms_per_frame": packed_total, **tag}),
          flush=True)

    # ------------------- a, b. the gated kernel; the fused kernel at T=16
    gated = phase_gated(dev, cfg, tag)
    fused16 = phase_fused_t16(dev, cfg, tag)
    print(json.dumps({"phase": "elapsed", "after": "a, b", "s": time.perf_counter() - t_start}),
          flush=True)

    # --------------------------------------- 3. the serving slice, full width
    t0 = time.perf_counter()
    params, bn, rng = demo_weights(cfg, prune_rate=0.8, seed=SEED, calib_batch=BATCH, device=dev)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    streams = synth_streams(rng, BATCH, N_FRAMES, cfg.input_hw)
    frames = torch.from_numpy(np.stack(streams, axis=1)).to(dev)
    det = sy.compile_detector(cfg, params, bn, device=dev)
    oracle = sy.compile_detector(dataclasses.replace(cfg, conv_exec="dense"), params, bn,
                                 device=dev)
    n_fused = len([n for n in det.plan.layers if n != "head"])

    captured = []  # the kernel's real inputs on frame 0, for replay below
    real_fp = fp.fused_pipeline

    def capture(*args, **kwargs):
        out = real_fp(*args, **kwargs)
        if len(captured) < n_fused:
            x, w_, taps, affine, v0 = args
            captured.append(dict(x=x.clone(), w=w_, taps=taps, affine=affine,
                                 v0=None if v0 is None else v0.clone(), **kwargs))
        return out

    sess = det.new_session(batch=BATCH)
    steps = []
    fp.fused_pipeline = capture
    try:
        backend.reset_launches()
        torch.cuda.synchronize()
        for k in range(N_FRAMES):
            steps.append(sess.step(frames[k]))
        torch.cuda.synchronize()
        launches = backend.launches[fp.KERNEL]
    finally:
        fp.fused_pipeline = real_fp
    if launches != n_fused * N_FRAMES or n_fused != 27:
        raise AssertionError(f"{launches} kernel launches for {N_FRAMES} frames; "
                             f"want {n_fused} (27) per frame")
    osess = oracle.new_session(batch=BATCH)
    for k in range(N_FRAMES):
        o = osess.step(frames[k])
        s = steps[k]
        head = s.head
        if tuple(head.shape) != (BATCH, *cfg.grid_hw, cfg.num_anchors, 5 + cfg.num_classes):
            raise AssertionError(f"head shape {tuple(head.shape)}")
        if not torch.isfinite(head).all():
            raise AssertionError(f"non-finite head at frame {k}")
        if not bits_equal(head, o.head):
            raise AssertionError(f"kernel-executor head != dense head at frame {k}: "
                                 f"max |Δ| {float((head - o.head).abs().max())}")
        for f in ("valid", "classes"):
            if not torch.equal(getattr(s.detections, f), getattr(o.detections, f)):
                raise AssertionError(f"detections.{f} differ from the dense executor at frame {k}")
    for name in sess.state:
        if not bits_equal(sess.state[name], osess.state[name]):
            raise AssertionError(f"membrane {name} differs from the dense executor")
    _, _, aux = sy.forward(det.params, det.bn_state, frames[0], cfg, plan=det.plan)
    rates = {k: float(v.float().mean()) for k, v in aux["spikes"].items()}
    if not rates["stage4"] > 0:
        raise AssertionError(f"no spikes reach stage4: rates {rates}")
    n_valid = [int(s.detections.valid.sum()) for s in steps]
    print(json.dumps({"phase": "slice", "calibration_s": calib_s, "launches": launches,
                      "launches_per_frame": launches / N_FRAMES,
                      "head_equal_dense": True, "valid_per_frame": n_valid,
                      "spike_rates": rates, **tag}), flush=True)

    # replay the main path's real per-layer inputs: kernel vs plain, and times
    names = [n for n in det.plan.layers if n != "head"]
    layers, totals = [], dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    bound_by = {"bytes": 0.0, "operations": 0.0}
    for name, args in zip(names, captured):
        a = dict(args)
        x, w_, taps, affine, v0 = (a.pop(k) for k in ("x", "w", "taps", "affine", "v0"))
        spk, mem = fp.fused_pipeline(x, w_, taps, affine, v0, **a)
        rspk, rmem = fp.fused_pipeline_reference(x, w_, taps, affine, v0, **a)
        torch.cuda.synchronize()
        if not (bits_equal(spk, rspk) and bits_equal(mem, rmem)):
            raise AssertionError(f"kernel != plain version on the main path's {name} inputs")
        ms, host_ms = device_ms(lambda: fp.fused_pipeline(x, w_, taps, affine, v0, **a))
        plain_ms, plain_host_ms = device_ms(
            lambda: fp.fused_pipeline_reference(x, w_, taps, affine, v0, **a), reps=5)
        kh = a["kh"]
        cin = x.shape[-1]
        xf = x.reshape((-1,) + tuple(x.shape[2:])).permute(0, 3, 1, 2).half()
        xf = xf.contiguous(memory_format=torch.channels_last)
        wf = torch.randn((a["kout"], cin, kh, kh), device=dev).half()
        wf = wf.contiguous(memory_format=torch.channels_last)
        lib_ms, _ = device_ms(lambda: torch.nn.functional.conv2d(xf, wf, padding=(kh - 1) // 2))
        bound, by = layer_bound({**args})
        bound_by[by] += bound
        row = {"layer": name, "x": list(x.shape), "kout": a["kout"], "live_taps": len(taps),
               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound,
               "bound_by": by, "host_ms": host_ms, "plain_host_ms": plain_host_ms}
        layers.append(row)
        for k in totals:
            totals[k] += row[k]
        print(json.dumps({"phase": "layer_time", **row, **tag}))

    def frame_ms(d, frames_, n=10):
        s_ = d.new_session(batch=BATCH)
        walls = []
        for k in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            s_.step(frames_[k % N_FRAMES])
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        return statistics.median(walls[1:])

    frame = {"kernel_executor_ms": frame_ms(det, frames),
             "dense_executor_ms": frame_ms(oracle, frames),
             "kernel_executor_ms_again": frame_ms(det, frames), "batch": BATCH,
             "input_hw": list(cfg.input_hw)}
    print(json.dumps({"phase": "frame_time", **frame, "sum_layer_kernel_ms": totals["ms"],
                      **tag}), flush=True)
    print(json.dumps({"phase": "elapsed", "after": "3, 4", "s": time.perf_counter() - t_start}),
          flush=True)

    # -------------- c, d. the conversion's operating point, unfused executor
    conv = phase_converted(dev, tag)
    conv_frame = {"converted_ms": frame_ms(conv["det"], conv["frames"]),
                  "serving_ms": frame_ms(det, frames), "batch": BATCH,
                  "input_hw": list(cfg.input_hw), "t": CONVERTED_T}
    print(json.dumps({"phase": "frame_time_converted", **conv_frame,
                      "sum_gated_kernel_ms": conv["total"]["ms"], **tag}), flush=True)
    print(json.dumps({"phase": "elapsed", "after": "c, d", "s": time.perf_counter() - t_start}),
          flush=True)

    kernels = [{
        "name": "fused_pipeline",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_pipeline.cu",
        "replaces": "src/repro/kernels/fused_pipeline.py:264",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": max(bound_by, key=bound_by.get),
        "library_ms": totals["library_ms"],
        "per": f"one frame of batch {BATCH}: sum over the {len(layers)} fused layers",
        "check": "bit-equal to the plain version, predecoded and packed weight modes",
        # the packed (in-kernel decode) mode is off the serving path: timed
        # at the same shapes on random pruned weights, never launched there
        "packed_mode_ms": packed_total,
        "t16_ms": fused16["ms_per_frame"],
        "t16_plain_ms": fused16["plain_ms_per_frame"],
        "t16_bound_ms": fused16["bound_ms_per_frame"],
        "launches_converted": conv["launches"]["fused"],
    }, {
        "name": "gated_one_to_all",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gated_one_to_all.cu",
        "replaces": "src/repro/kernels/gated_one_to_all.py:107",
        "launches": conv["launches"]["gated"],
        "max_abs_err": max(gated["max_abs_err"], conv["max_abs_err"]),
        "ms": conv["total"]["ms"],
        "plain_ms": conv["total"]["plain_ms"],
        "bound_ms": conv["total"]["bound_ms"],
        "bound_by": conv["bound_by"],
        "library_ms": conv["total"]["library_ms"],
        "per": f"one frame of batch {BATCH} of the converted detector (T={CONVERTED_T}, "
               "pool_drive): sum over its 2 gated layers, encode and conv_block",
        "check": "int32 bit-equal to the plain version at the 12 encode/3x3 shapes, an "
                 "all-dead layer and the main path's inputs",
        "library": "F.conv2d f32, TF32 off, over the replicate-padded blocks",
        "library_equal": conv["library_equal"],
        "launches_taps_forward": conv["taps_launches"]["gated"],
        "ms_12_shapes": sum(r["ms"] for r in gated["rows"][:12]),
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
