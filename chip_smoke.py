"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and the last line is never printed):

1. Device: require CUDA, print the card's name and power limit, build the
   CUDA kernels from ``src/repro_torch/kernels/csrc`` and time the build.
2. Kernel vs plain version at every fused layer shape of the full-width
   ``snn-det`` config (576×1024, block 18×32, channels 3→16 … 256, (1, 3)
   mixed time), hard reset from a cold membrane and soft reset from a warm
   one, in both weight modes (predecoded, and packed with the decode in
   the kernel): spikes and membranes must be bit-equal. Then a 7×7 layer
   at C = 256 (T=3, soft reset, warm) whose weight slice exceeds shared
   memory, so both modes stream it in K-chunks (packed: decoded chunk by
   chunk in the kernel): bit-equal, with times.
3. The serving slice at full width: seeded ``demo_weights`` (pruned 0.8,
   tdBN-calibrated, TF32 off), ``compile_detector`` with the kernel
   executor, a ``DetectorSession`` over batch 2 × 3 frames. 27 kernel
   launches per frame; the head equal to the dense executor's on the card;
   detections equal; spikes flowing in stage4; every layer's real inputs
   replayed through the kernel and its plain version, bit-equal.
4. Times (CUDA events): per layer (kernel, plain version, cuDNN conv
   yardstick, byte/op bound, the kernel's tile plan) and per frame, each
   with the card's name and power limit.

The unfused kernel executor (the ANN→SNN conversion's operating point):

a. The gated one-to-all kernel against its plain version at every encode
   and 3×3 layer shape of ``CONFIG`` (12 shapes; T·N = 16·2 for the spike
   layers), random weights pruned 0.8, plus a layer whose taps are all
   dead: int32 bit-equal. Times per shape: kernel, plain version, one
   ``F.conv2d`` (f32, TF32 off) over the replicate-padded blocks, bound,
   the kernel's tiling (``g2a.last_plan()``).
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

The kernel benchmarks (the two kernels off the detector paths):

e. The fused LIF kernel against its plain version (int8 spikes equal) at
   ``kernel_bench``'s (4, 512, 32) and at the detector's LIF volumes:
   stage0's at T=3 and batch 2, the converted detector's pooled conv_block
   and encode drives at T=16. Times per shape: kernel, plain version,
   byte bound (no single PyTorch call computes LIF).
f. The bitmask matmul kernel against its plain version and a float64
   product (|Δ| ≤ 1e-5·(|x|@|W|) + 1e-6) at ``kernel_bench``'s (64, 512) ×
   (512, 256) and at qwen1.5-0.5b's FFN (d_model 1024, d_ff 2816, weight
   density 0.2), up and down, on 2048 tokens and on 16 (a decode step,
   where the compressed weights' bytes bound it). Times per shape: kernel,
   plain version, dense f32 ``torch.matmul`` (TF32 off), byte/op bound.
g. ``repro_torch.benchmarks.kernel_bench.run()`` on the card (every kernel
   against its oracle, and the fused-pipeline gate ``--fast`` runs), then
   ``e2e_detector.run`` at full width (``CONFIG``, 576×1024, batch 1): every
   executor bit-equal to dense, 27 fused launches per frame, wall ms each.

The megabatched engine (``repro_torch.serve``), at ``CONFIG`` with the
kernel executor and the seeded weights of 3:

h. Join and leave: 10 ``FrameRequest`` streams of staggered lengths through
   ``Engine(det, n_slots=4)``: drained, 27 fused launches per tick, every
   served head bit-equal to a solo ``DetectorSession`` replay, ``valid``
   and ``classes`` equal. ``masked_step``: garbage in dead lanes leaves the
   active rows' heads and membranes bit-equal and the dead lanes' membranes
   frozen; a cold row equals an explicitly zeroed one, and a cold inactive
   row comes out zeroed. Buckets 2→4→8→2 with the resident rows equal to
   solo replays. ``serve_bench.run_load`` at 8 and 64 streams × 4 frames
   (frames/s, tick percentiles, host and device ms, peak memory; 3 streams
   against solo replays). The serve CLI once at full width.

Training (``repro_torch.eval.harness``, ``repro_torch.train``), no kernel on
its path:

i. Three train steps of ``CONFIG`` at batch 2 under ``ft.Supervisor`` and a
   ``Heartbeat`` (checkpoints every 2 steps): per step the device ms (CUDA
   events), the wall ms and a finite loss; the peak memory; the save and
   ``save_async`` ms; no kernel launched. One step on the card against the
   same step on the CPU at ``harness.demo_config()`` (spikes equal; loss,
   gradients, parameters and tdBN state within the CPU parity tests'
   bounds). The trained weights pruned 0.8 and fake-quantized, saved as a
   detector checkpoint and restored bit-equal, then served by
   ``compile_detector`` with the kernel executor: 27 fused launches, head,
   spikes, ``valid`` and ``classes`` equal to the dense executor's. The
   training CLI (``python -m repro_torch.launch.train_detector --steps 4
   --eval-images 4``) exits 0.

The paper's pipeline (``repro_torch.eval.harness.run_pipeline``), the fused
kernel on its quantized evaluations:

j. ``run_pipeline(CONFIG, conv_exec="pallas")`` at 576×1024 with its steps
   and images cut to the time limit (3 float steps and 2 QAT steps at batch
   2, 8 eval images; the mAP is then not meaningful): no kernel in the
   train steps or the float evaluations, 27 fused launches per ``detect()``
   of the qat (mixed (1, 3)) and uniform T=3 evaluations, the uniform
   evaluation's real layer inputs (conv_block at t_in = 3) bit-equal
   through kernel and plain version; both quantized evaluations'
   reports identical to the dense executor's on the same weights, heads
   bit-equal, ``valid`` and ``classes`` equal; every weight pruning zeroed
   still 0 after QAT; the accumulator report (max |acc|, within 16 bits);
   each stage's seconds and each evaluation's images/s, per executor. Then
   ``python -m repro_torch.launch.serve --arch snn-det --eval-map
   --checkpoint <the QAT checkpoint> --requests 8`` prints its
   BIT-IDENTICAL harness parity line through the kernel executor and exits
   0, and ``python -m repro_torch.benchmarks.run --fast`` completes every
   suite, each in a subprocess on the card.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists each kernel with its launches, error and times.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, data sheet
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak, data sheet
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores: the bound of the f32 function
BATCH, N_FRAMES, SEED = 2, 3, 0
CONVERTED_T = 16  # the converted detector's T (target_config: 64-128), cut to fit the run
# the detector's LIF volumes (T, M, C): stage0 at T=3 (M = N·H·W, batch 2), the
# converted detector's pooled conv_block and encode drives at T=16
LIF_SHAPES = ((3, 73728, 32), (16, 294912, 32), (16, 1179648, 16))
# qwen1.5-0.5b's FFN (src/repro/configs/qwen1_5_0_5b.py: d_model 1024, d_ff
# 2816) on 2048 tokens, weights pruned to the paper's 80%
FFN_TOKENS, FFN_D, FFN_FF, FFN_DENSITY = 2048, 1024, 2816, 0.2
FFN_DECODE_TOKENS = 16  # a decode step: the format's use, bound by the weights' bytes
E2E_REPS = 100  # timed detect() calls per executor at 576x1024 (~10 s in all)
ENGINE_LENGTHS = (1, 4, 2, 5, 3, 1, 2, 6, 1, 3)  # frames per stream, the join/leave run
LOAD_STREAMS, LOAD_FRAMES = (8, 64), 4
TRAIN_STEPS, TRAIN_BATCH = 3, 2  # phase i: full-width train steps under the Supervisor
# phase j: the paper's pipeline at full width, cut from 3500 + 600 steps at
# batch 6 on 48 images (eval_map's demonstration scale) to the time limit
PIPE_STEPS, PIPE_FINETUNE, PIPE_BATCH, PIPE_IMAGES = 3, 2, 2, 8


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
        want = g2a.gated_one_to_all_reference(x, *dev_w, **kwargs)
        out = g2a.gated_one_to_all(x, *dev_w, **kwargs)
        torch.cuda.synchronize()
        err = float((out.double() - want.double()).abs().max())
        max_err = max(max_err, err)
        if not bits_equal(out, want):
            raise AssertionError(f"gated kernel != plain version at {name}: max |Δ| {err}")
        ms, host_ms = device_ms(lambda: g2a.gated_one_to_all(x, *dev_w, **kwargs))
        plan = g2a.last_plan()
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
               "library_equal": lib_exact, "bound_ms": bound, "bound_by": by, "plan": plan}
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
        plan = fp.last_plan()
        plain_ms = elapsed_ms(
            lambda: fp.fused_pipeline_reference(x, live.w, live.taps, affine, v0, **a), reps=2)
        bound, _ = layer_bound(dict(x=x, w=live.w, v0=v0, kout=kout, t_out=CONVERTED_T,
                                    affine=affine))
        total["ms"] += ms
        total["plain_ms"] += plain_ms
        total["bound_ms"] += bound
        print(json.dumps({"phase": "fused_t16", "layer": name, "x": list(x.shape),
                          "kout": kout, "bit_equal": True, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound, "spike_rate": float(rspk.float().mean()),
                          "plan": plan}))
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
    plans = {}
    for name, (args, kwargs) in zip(("encode", "conv_block"), captured):
        out = g2a.gated_one_to_all(*args, **kwargs)
        want = g2a.gated_one_to_all_reference(*args, **kwargs)
        torch.cuda.synchronize()
        max_err = max(max_err, float((out.double() - want.double()).abs().max()))
        if not bits_equal(out, want):
            raise AssertionError(f"gated kernel != plain version on the main path's {name}")
        ms, host_ms = device_ms(lambda: g2a.gated_one_to_all(*args, **kwargs))
        plan = g2a.last_plan()
        plans[name] = plan
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
                          "bound_ms": bound, "bound_by": by, "plan": plan, **tag}))
    return {"det": det, "frames": frames, "launches": launches, "taps_launches": taps_launches,
            "total": total, "bound_by": max(bound_by, key=bound_by.get),
            "library_equal": lib_equal, "max_abs_err": max_err, "plans": plans}


def phase_lif(dev, tag) -> dict:
    """(e) the fused LIF kernel against its plain version, with times."""
    from repro_torch.benchmarks import kernel_bench as kb
    from repro_torch.kernels import spike_lif as sl

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    rows = []
    for shape in (kb.LIF_SHAPE,) + LIF_SHAPES:
        x = torch.randn(shape, generator=gen, device=dev)
        a = dict(threshold=kb.LIF_THRESHOLD, leak=kb.LIF_LEAK)
        got, want = sl.fused_lif(x, **a), sl.fused_lif_reference(x, **a)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"fused LIF kernel != plain version at {shape}: "
                                 f"{int((got != want).sum())} spikes differ")
        ms, host_ms = device_ms(lambda: sl.fused_lif(x, **a))
        plain_ms, _ = device_ms(lambda: sl.fused_lif_reference(x, **a), reps=5)
        bound = x.numel() * (x.element_size() + 1) / HBM_BYTES_PER_S * 1e3
        row = {"shape": list(shape), "bit_equal": True, "max_abs_err": err, "ms": ms,
               "host_ms": host_ms, "plain_ms": plain_ms, "bound_ms": bound,
               "bound_by": "bytes", "spike_rate": float(got.float().mean())}
        rows.append(row)
        print(json.dumps({"phase": "lif_vs_plain", **row, **tag}), flush=True)
    return {"rows": rows, "max_abs_err": max(r["max_abs_err"] for r in rows)}


def matmul_bound(x, pw, nnz: int) -> tuple[float, str]:
    """Least time for one bitmask matmul: x, the compressed weights and the
    f32 output each moved once, against 2 f32 operations per nonzero weight
    and row of x."""
    m = x.shape[0]
    nbytes = (x.numel() * x.element_size() + pw.compressed_bytes + m * pw.shape[1] * 4)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * m * nnz / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_matmul(dev, tag) -> dict:
    """(f) the bitmask matmul kernel against its plain version and float64."""
    from repro_torch.benchmarks import kernel_bench as kb
    from repro_torch.kernels import bitmask_matmul as bmm
    from repro_torch.kernels import ops
    from repro_torch.models import snn_yolo as sy

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    inp = kb.make_inputs(SEED)
    cases = [("kernel_bench", torch.from_numpy(inp["x_mm"]).to(dev),
              torch.from_numpy(inp["w_mm"]).to(dev))]
    for name, (k, n) in (("qwen_ffn_up", (FFN_D, FFN_FF)), ("qwen_ffn_down", (FFN_FF, FFN_D))):
        w = torch.randn((k, n), generator=gen, device=dev)
        w[torch.rand((k, n), generator=gen, device=dev) >= FFN_DENSITY] = 0.0
        cases.append((name, torch.randn((FFN_TOKENS, k), generator=gen, device=dev), w))
        cases.append((f"{name}_{FFN_DECODE_TOKENS}tok",
                      torch.randn((FFN_DECODE_TOKENS, k), generator=gen, device=dev), w))
    rows = []
    with sy._no_tf32():  # the plain version, float64 and torch.matmul in full f32
        for name, x, w in cases:
            pw = ops.pack_matmul_weights(w).to(dev)
            got, plain = bmm.bitmask_matmul(x, pw), bmm.bitmask_matmul_reference(x, pw)
            f64 = x.double() @ w.double()
            torch.cuda.synchronize()
            err64 = float((got.double() - f64).abs().max())
            err_plain = float((got - plain).abs().max())
            if not (kb.matmul_within(got, x, w, f64) and kb.matmul_within(got, x, w, plain)):
                raise AssertionError(f"bitmask matmul outside 1e-5·(|x|@|W|) + 1e-6 at {name}: "
                                     f"max |Δ| {err64} vs float64, {err_plain} vs plain")
            ms, host_ms = device_ms(lambda: bmm.bitmask_matmul(x, pw))
            plan = bmm.last_plan()
            plain_ms, _ = device_ms(lambda: bmm.bitmask_matmul_reference(x, pw), reps=5)
            lib_ms, _ = device_ms(lambda: torch.matmul(x, w))
            nnz = int(torch.count_nonzero(w))
            bound, by = matmul_bound(x, pw, nnz)
            row = {"case": name, "m_k_n": [x.shape[0], *w.shape], "density": nnz / w.numel(),
                   "splits": bmm.kernel_splits(x.shape[0], pw),
                   "max_abs_err_f64": err64, "max_abs_err_plain": err_plain,
                   "within_tolerance": True, "ms": ms, "host_ms": host_ms,
                   "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound,
                   "bound_by": by, "compressed_bytes": pw.compressed_bytes,
                   "dense_bytes": w.numel() * 4, "plan": plan}
            rows.append(row)
            print(json.dumps({"phase": "bitmask_matmul_vs_plain", **row, **tag}), flush=True)
    return {"rows": rows, "max_abs_err": max(r["max_abs_err_plain"] for r in rows),
            "max_abs_err_f64": max(r["max_abs_err_f64"] for r in rows)}


def phase_streamed_packed(dev, tag) -> dict:
    """(2, last row) a 7×7 layer at C = 256 whose 64-channel weight slice
    (784 KB) exceeds shared memory: both weight modes stream it in K-chunks,
    the packed mode decoding each chunk in the kernel."""
    from repro_torch.kernels import fused_pipeline as fp
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    kh, cin, kout, t, hw = 7, 256, 64, 3, (18, 32)
    wq = torch.randint(-127, 128, (kh, kh, cin, kout), generator=gen, device=dev)
    wq[torch.rand(wq.shape, generator=gen, device=dev) > 0.2] = 0
    pw = ops.pack_conv_weights(wq.to(torch.int8).cpu().numpy())
    live = ops.predecode(pw, dev)
    maskp, vals = torch.from_numpy(pw.maskp).to(dev), torch.from_numpy(pw.vals).to(dev)
    x = torch.randint(0, 2, (t, BATCH, *hw, cin), generator=gen, device=dev).to(torch.uint8)
    rows = torch.stack([torch.full((kout,), 1.0 / (kh * kh * cin), device=dev),
                        torch.randn(kout, generator=gen, device=dev),
                        torch.rand(kout, generator=gen, device=dev) + 0.5,
                        torch.randn(kout, generator=gen, device=dev),
                        torch.randn(kout, generator=gen, device=dev)])
    affine = ops.pad_affine(rows, pw.kp)
    v0 = torch.randn((BATCH, *hw, kout), generator=gen, device=dev)
    a = dict(kout=kout, kh=kh, kw=kh, bh=hw[0], bw=hw[1], t_out=t, bn_scale=0.5,
             threshold=0.5, leak=0.25, reset="soft", v_init=0.25)

    def packed():
        return fp.fused_pipeline_packed(x, maskp, vals, live.taps, affine, v0, **a)

    def predecoded():
        return fp.fused_pipeline(x, live.w, live.taps, affine, v0, **a)

    def plain():
        return fp.fused_pipeline_reference(x, fp.decode_packed(maskp, vals, live.taps),
                                           live.taps, affine, v0, **a)

    rspk, rmem = plain()
    err = 0.0
    for mode, fn in (("packed", packed), ("predecoded", predecoded)):
        spk, mem = fn()
        torch.cuda.synchronize()
        err = max(err, float((mem - rmem).abs().max()))
        if not (bits_equal(spk, rspk) and bits_equal(mem, rmem)):
            raise AssertionError(f"{mode} kernel != plain version at the streamed 7x7 layer: "
                                 f"max |Δmem| {err}")
    ms, host_ms = device_ms(packed)
    plan = fp.last_plan()
    if not plan["tile_channels"] * kh * kh * cin > plan["smem_bytes"]:
        raise AssertionError(f"the 7x7 layer's weights fit after all: {plan}")
    pre_ms, _ = device_ms(predecoded)
    plain_ms = elapsed_ms(plain)
    npix = BATCH * hw[0] * hw[1]
    nbytes = (x.numel() + maskp.numel() + vals.numel() + affine.numel() * 4 + v0.numel() * 4
              + t * npix * kout + npix * kout * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * t * npix * int(torch.count_nonzero(wq)) / INT8_OPS_PER_S
    row = {"layer": "7x7 C=256 (streamed weights)", "x": list(x.shape), "kout": kout,
           "bit_equal": True, "max_abs_err": err, "ms": ms, "host_ms": host_ms,
           "predecoded_ms": pre_ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
           "bound_by": "bytes" if t_bytes >= t_ops else "operations", "plan": plan}
    print(json.dumps({"phase": "streamed_packed", **row, **tag}), flush=True)
    return row


def phase_engine(dev, det, tag) -> dict:
    """(h) the megabatched engine at full width on ``det`` (``CONFIG``, the
    kernel executor); the join/leave run driven with the launch counts set
    to 0 just before it and read just after."""
    from repro_torch import backend
    from repro_torch.benchmarks import serve_bench
    from repro_torch.kernels import fused_pipeline as fp
    from repro_torch.launch import serve as launch
    from repro_torch.serve import DetectorEngineCore, Engine, FrameRequest
    from repro_torch.serve.detector import synth_streams

    rng = np.random.default_rng(SEED + 16)
    hw = det.cfg.input_hw

    def equal_solo(reqs, what):
        for fr in reqs:
            solo = det.new_session(batch=1)
            for k, f in enumerate(fr.frames):
                step = solo.step(f[None])
                if not np.array_equal(fr.heads[k], step.head[0].cpu().numpy()):
                    raise AssertionError(f"{what}: stream {fr.rid} frame {k}: served head != "
                                         "solo DetectorSession replay")
                for name in ("valid", "classes"):
                    if not np.array_equal(getattr(fr.out[k], name),
                                          getattr(step.detections, name)[0].cpu().numpy()):
                        raise AssertionError(f"{what}: stream {fr.rid} frame {k}: {name} "
                                             "!= solo replay")

    # join and leave, 4 slots
    reqs = [FrameRequest(rid=r, frames=synth_streams(rng, 1, n, hw)[0])
            for r, n in enumerate(ENGINE_LENGTHS)]
    eng = Engine(det, n_slots=4)
    for fr in reqs:
        if not eng.submit(fr):
            raise AssertionError(f"stream {fr.rid} refused")
    torch.cuda.synchronize()
    backend.reset_launches()
    out = eng.run()
    torch.cuda.synchronize()
    launches = dict(backend.launches)
    ticks = len(eng.core.step_wall)
    if out.status != "drained" or len(out) != len(reqs):
        raise AssertionError(f"engine served {len(out)} of {len(reqs)}: {out.status}")
    if launches != {fp.KERNEL: 27 * ticks}:
        raise AssertionError(f"{launches} launches over {ticks} ticks; want 27 fused per tick")
    equal_solo(reqs, "join/leave")
    join = {"ticks": ticks, "launches": launches, "launches_per_tick": 27,
            "tick_host_ms": [w * 1e3 for w in eng.core.step_wall],
            "tick_device_ms": eng.core.step_device_ms}
    print(json.dumps({"phase": "engine_join_leave", **join, **tag}), flush=True)

    # masked_step: dead lanes, cold rows
    x = torch.from_numpy(np.concatenate(synth_streams(rng, 4, 1, hw))).to(dev)
    on = torch.ones(4, dtype=torch.bool, device=dev)
    _, mem, _ = det.masked_step(x, det.zero_state(4), on)  # a warm membrane in every row
    active = torch.tensor([True, True, False, False], device=dev)
    h1, m1, _ = det.masked_step(x, mem, active)
    garbage = x.clone()
    garbage[2:] = torch.rand(garbage[2:].shape, device=dev)
    dirty = {k: v.clone() for k, v in mem.items()}
    for v in dirty.values():
        v[2:] = torch.randn(v[2:].shape, device=dev) * 4
    h2, m2, _ = det.masked_step(garbage, dirty, active)
    if not bits_equal(h1[:2], h2[:2]):
        raise AssertionError("active rows' heads depend on the dead lanes")
    for k in m1:
        if not (bits_equal(m1[k][:2], m2[k][:2]) and bits_equal(m2[k][2:], dirty[k][2:])
                and bits_equal(m1[k][2:], mem[k][2:])):
            raise AssertionError(f"dead lanes leak into {k}, or their membrane moved")
    cold = torch.tensor([False, True, True, False], device=dev)
    active = torch.tensor([True, True, False, True], device=dev)
    hc, mc, _ = det.masked_step(x, mem, active, cold)
    zeroed = {k: v.clone() for k, v in mem.items()}
    for v in zeroed.values():
        v[1:3] = 0.0
    hz, mz, _ = det.masked_step(x, zeroed, active, torch.zeros(4, dtype=torch.bool, device=dev))
    if not (bits_equal(hc, hz) and all(bits_equal(mc[k], mz[k]) for k in mc)):
        raise AssertionError("a cold row differs from an explicitly zeroed one")
    if any(bool(mc[k][2].any()) for k in mc):
        raise AssertionError("a cold inactive row did not come out zeroed")
    del mem, m1, m2, dirty, mc, mz, zeroed

    # capacity buckets 2 -> 4 -> 8 -> 2
    core = DetectorEngineCore(det, n_slots=16, min_bucket=2)
    breqs = [FrameRequest(rid=r, frames=s) for r, s in enumerate(synth_streams(rng, 5, 4, hw))]
    caps = [core.cap]
    core.admit(breqs[0], 0)
    core.admit(breqs[1], 1)
    bactive = {0: breqs[0], 1: breqs[1]}
    core.step(bactive)
    for slot in (2, 3, 4):
        core.admit(breqs[slot], slot)
        bactive[slot] = breqs[slot]
        caps.append(core.cap)
    while bactive:
        for slot in core.step(bactive):
            del bactive[slot]
    caps.append(core.cap)
    if caps != [2, 4, 4, 8, 2]:
        raise AssertionError(f"capacity went {caps}; want 2 -> 4 -> 8 -> 2")
    equal_solo(breqs, "buckets")
    print(json.dumps({"phase": "engine_checks", "masked_step": "dead lanes frozen, cold == "
                      "zeroed", "bucket_caps": caps, **tag}), flush=True)
    del core

    # load: N resident streams, one tick per frame
    load = {}
    for n in LOAD_STREAMS:
        torch.cuda.empty_cache()
        load[n] = serve_bench.run_load(det, n_streams=n, frames=LOAD_FRAMES, parity_streams=3)
        print(json.dumps({"phase": "engine_load", **load[n], **tag}), flush=True)

    # the serve CLI, full width
    t0 = time.perf_counter()
    done = launch.main(["--arch", "snn-det", "--full-config", "--conv-exec", "pallas",
                        "--requests", "8", "--slots", "4", "--frames", "3"])
    if len(done) != 8 or any(len(r.heads) != 3 for r in done):
        raise AssertionError(f"the serve CLI served {len(done)} of 8 streams")
    print(json.dumps({"phase": "serve_cli", "seconds": time.perf_counter() - t0, **tag}),
          flush=True)
    return {"join": join, "load": load}


def phase_benchmarks(dev, tag) -> dict:
    """(g) the port's kernel_bench and, at full width, e2e_detector; each
    driven with the launch counts set to 0 just before it and read after."""
    from repro_torch import backend
    from repro_torch.benchmarks import e2e_detector, kernel_bench
    from repro_torch.configs.snn_det import CONFIG

    t0 = time.perf_counter()
    backend.reset_launches()
    bench = kernel_bench.run(dev)
    torch.cuda.synchronize()
    bench_launches = dict(backend.launches)
    missing = [k for k in ("gated_one_to_all", "spike_lif", "bitmask_matmul", "fused_pipeline")
               if not bench_launches.get(k)]
    if missing:
        raise AssertionError(f"kernel_bench launched no {missing}: {bench_launches}")
    print(json.dumps({"phase": "kernel_bench", "seconds": time.perf_counter() - t0,
                      "launches": bench_launches, "result": bench, **tag}), flush=True)

    t0 = time.perf_counter()
    backend.reset_launches()
    e2e = e2e_detector.run(dataclasses.replace(CONFIG, arch_id="snn-det-e2e"), batch=1,
                           device=dev, reps=E2E_REPS)
    torch.cuda.synchronize()
    e2e_launches = dict(backend.launches)
    per_frame = {ex: r["launches_per_frame"] for ex, r in e2e["executors"].items()}
    if per_frame != {"dense": {}, "gated": {}, "pallas": {"fused_pipeline": 27}}:
        raise AssertionError(f"e2e launches per frame {per_frame}; want 27 fused for pallas")
    if any(r["max_abs_diff_vs_dense"] != 0.0 for r in e2e["executors"].values()):
        raise AssertionError(f"e2e executors differ from dense: {e2e['executors']}")
    print(json.dumps({"phase": "e2e_detector", "seconds": time.perf_counter() - t0,
                      "launches": e2e_launches, "reps": E2E_REPS, "result": e2e, **tag}),
          flush=True)
    return {"bench": bench, "bench_launches": bench_launches, "e2e": e2e,
            "e2e_launches": e2e_launches}

def train_step_on(dev, cfg, ocfg, params, bn, batch) -> dict:
    """One train step (loss and gradients, then AdamW) on ``dev`` from the
    host tensors ``params``/``bn`` and a numpy batch; results on the host."""
    from repro_torch import tree as tu
    from repro_torch.eval import harness
    from repro_torch.models import snn_yolo as sy
    from repro_torch.train import optimizer as opt

    p = tu.tree_map(lambda t: t.to(dev), params)
    b = tu.tree_map(lambda t: t.to(dev), bn)
    with sy._no_tf32():
        loss, grads, new_bn, aux = harness.loss_and_grads(
            cfg, p, b, torch.from_numpy(batch["image"]).to(dev),
            torch.from_numpy(batch["target"]).to(dev))
        new_p, _ = opt.apply_updates(p, grads, opt.init_state(p, ocfg), ocfg)
    host = lambda tree: tu.tree_map(lambda t: t.detach().cpu(), tree)  # noqa: E731
    return {"loss": float(loss), "grads": host(grads), "bn": host(new_bn),
            "params": host(new_p), "spikes": host(aux["spikes"])}


def compare_train_steps(ref: dict, got: dict, lr: float, grad_clip: float) -> dict:
    """The card's train step against the CPU's, to the tolerances of
    ``tests/test_torch_train.py``: spikes equal (a flip is reported with
    its layer), loss within 1e-5 relative, each gradient leaf within
    1e-4·max|g| + 1e-7, the new tdBN state within 1e-6 (a mean against the
    larger of max|mean| and max sqrt(var)), updated parameters within
    1e-6·max|p| where the clipped gradient |ĝ| ≥ 1e-6 (Adam's ĝ/(|ĝ| + eps)
    is well conditioned there) and within 2·lr elsewhere. Returns the worst
    error of each, as a fraction of its bound."""
    from repro_torch import tree as tu

    flips = {k: int((got["spikes"][k] != v).sum()) for k, v in ref["spikes"].items()}
    if any(flips.values()):
        raise AssertionError(f"card and CPU spikes differ, flips per layer: {flips}")
    worst = {"loss": abs(got["loss"] - ref["loss"]) / abs(ref["loss"]) / 1e-5}
    gnorm = float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in tu.leaves(ref["grads"]))))
    clip = min(1.0, grad_clip / max(gnorm, 1e-12))
    worst["grads"] = worst["params"] = worst["bn"] = 0.0
    for g, g_ref, p, p_ref in zip(tu.leaves(got["grads"]), tu.leaves(ref["grads"]),
                                  tu.leaves(got["params"]), tu.leaves(ref["params"])):
        worst["grads"] = max(worst["grads"], float((g - g_ref).abs().max())
                             / (1e-4 * float(g_ref.abs().max()) + 1e-7))
        scale = 1e-6 * float(p_ref.abs().max())
        tol = torch.where(g_ref.abs() * clip >= 1e-6, scale, 2 * lr + scale)
        worst["params"] = max(worst["params"], float(((p - p_ref).abs() / tol).max()))
    for name, st in ref["bn"].items():
        scale = max(float(st["mean"].abs().max()), float(st["var"].sqrt().max()))
        worst["bn"] = max(worst["bn"],
                          float((got["bn"][name]["mean"] - st["mean"]).abs().max()) / scale / 1e-6,
                          float((got["bn"][name]["var"] - st["var"]).abs().max())
                          / float(st["var"].abs().max()) / 1e-6)
    if any(v > 1 for v in worst.values()):
        raise AssertionError(f"card step differs from the CPU step past its bounds: {worst}")
    return {"flips": flips, "worst_over_bound": worst}


def phase_train(dev, tag) -> dict:
    """(i) Training on the card. Three ``train_step``s of the full-width
    ``CONFIG`` (576×1024, block 18×32, FXP8 STE weights, mixed (1, 3) T) at
    batch TRAIN_BATCH under ``ft.Supervisor`` + ``Heartbeat`` (save_every
    2), each step's device ms (CUDA events) and wall ms, the loss (finite),
    peak memory, and the Supervisor's ``save`` and a ``save_async`` ms.
    Then: one step on the card against the same step on the CPU at
    ``demo_config``; the trained weights pruned 0.8, fake-quantized, saved
    as a detector checkpoint and restored bit-equal; served through
    ``compile_detector(pallas)`` (27 fused launches) with spikes, ``valid``
    and ``classes`` equal to the dense executor's; the training CLI at
    ``demo_config``."""
    import tempfile

    from repro_torch import backend
    from repro_torch import tree as tu
    from repro_torch.benchmarks import serve_bench
    from repro_torch.configs.snn_det import CONFIG
    from repro_torch.core import pruning, quant
    from repro_torch.data import synthetic_detection as sd
    from repro_torch.eval import harness
    from repro_torch.kernels import fused_pipeline as fp
    from repro_torch.models import snn_yolo as sy
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import ft
    from repro_torch.train import optimizer as opt

    cfg = dataclasses.replace(CONFIG, arch_id="snn-det-train")
    ocfg = harness.train_config(TRAIN_STEPS)
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    stream = sd.batches(TRAIN_BATCH, hw=cfg.input_hw, steps=TRAIN_STEPS,
                        grid_div=harness.grid_div(cfg))
    batches = list(stream)  # made before the timed steps: set-up, not training
    rows = []
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def init_state():
        params, bn = sy.init_params(cfg, seed=SEED, device=dev)
        return {"params": params, "bn": bn, "opt": opt.init_state(params, ocfg)}

    def step_fn(state, step):
        b = batches[step]
        images = torch.from_numpy(b["image"]).to(dev)
        targets = torch.from_numpy(b["target"]).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        params, bn, o, loss = harness.train_step(cfg, ocfg, state["params"], state["bn"],
                                                 state["opt"], images, targets)
        stop.record()
        torch.cuda.synchronize()
        rows.append({"step": step, "device_ms": start.elapsed_time(stop),
                     "wall_ms": (time.perf_counter() - t0) * 1e3, "loss": float(loss)})
        if not np.isfinite(rows[-1]["loss"]):
            raise AssertionError(f"non-finite loss at step {step}")
        print(json.dumps({"phase": "train_step", **rows[-1], **tag}), flush=True)
        return {"params": params, "bn": bn, "opt": o}

    real_save, save_ms = ckpt.save, []

    def timed_save(*a, **k):
        t0 = time.perf_counter()
        out = real_save(*a, **k)
        save_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    backend.reset_launches()
    sup = ft.Supervisor(ckpt_root=os.path.join(root, "state"), save_every=2,
                        heartbeat=ft.Heartbeat(os.path.join(root, "state", "heartbeat.json")))
    ckpt.save = timed_save
    try:
        with sy._no_tf32():
            state = sup.run(init_state=init_state, state_template=init_state, step_fn=step_fn,
                            n_steps=TRAIN_STEPS)
    finally:
        ckpt.save = real_save
    torch.cuda.synchronize()
    train_launches = dict(backend.launches)
    if any(train_launches.values()):
        raise AssertionError(f"the train steps launched kernels: {train_launches}")
    peak = torch.cuda.max_memory_allocated()
    if (sup.restarts or sup.heartbeat.last()["step"] != TRAIN_STEPS - 1
            or len(rows) != TRAIN_STEPS):
        raise AssertionError(f"supervised run ended at {sup.heartbeat.last()}")
    # one more step on the last batch, outside the run: its device time by
    # kernel. (A step issues thousands of launches, more than the device's
    # launch queue holds, so it cannot be queued whole behind a spin kernel
    # as device_ms does: the profiler's kernel times are its device time.)
    b = batches[-1]
    images, targets = torch.from_numpy(b["image"]).to(dev), torch.from_numpy(b["target"]).to(dev)

    def one_step():
        return harness.train_step(cfg, ocfg, state["params"], state["bn"], state["opt"],
                                  images, targets)

    with sy._no_tf32():
        by_kernel = serve_bench.kernel_breakdown(one_step, dev)
    steady = min(r["device_ms"] for r in rows[1:])  # the steadiest supervised step
    t0 = time.perf_counter()
    ckpt.save_async(os.path.join(root, "async"), TRAIN_STEPS, state)
    async_return_ms = (time.perf_counter() - t0) * 1e3
    ckpt.wait_pending()
    async_ms = (time.perf_counter() - t0) * 1e3
    train = {"config": cfg.arch_id, "input_hw": list(cfg.input_hw), "batch": TRAIN_BATCH,
             "steps": rows, "peak_memory_bytes": peak,
             "peak_memory_gib": peak / 2**30, "save_ms": save_ms,
             "save_async_return_ms": async_return_ms, "save_async_committed_ms": async_ms,
             "kernel_launches": train_launches, "by_kernel": by_kernel,
             "device_idle_share": None if by_kernel is None
             else 1 - by_kernel["total_ms"] / steady}
    print(json.dumps({"phase": "train", **train, **tag}), flush=True)

    # 1. the card's step against the CPU's, demo_config, the same inputs
    dcfg = harness.demo_config()
    dparams, dbn = sy.init_params(dcfg, seed=SEED, device="cpu")
    dbatch = next(sd.batches(2, hw=dcfg.input_hw, steps=1, grid_div=harness.grid_div(dcfg)))
    docfg = harness.train_config(1)
    lr = float(opt.lr_schedule(docfg, torch.tensor(1, dtype=torch.int32)))
    parity = compare_train_steps(
        train_step_on(torch.device("cpu"), dcfg, docfg, dparams, dbn, dbatch),
        train_step_on(dev, dcfg, docfg, dparams, dbn, dbatch), lr, docfg.grad_clip)
    print(json.dumps({"phase": "train_card_vs_cpu", **parity, **tag}), flush=True)

    # 2. prune, quantize, save, restore: bit-equal
    pruned = pruning.prune_tree(state["params"], 0.8)
    q = tu.tree_map(lambda x: quant.fake_quant_tensor(x, 8) if x.dim() == 4 else x, pruned)
    det_root = os.path.join(root, "detector")
    harness.save_detector_checkpoint(det_root, TRAIN_STEPS, q, state["bn"], cfg)
    rcfg, rp, rbn, _ = harness.restore_detector_checkpoint(det_root, device=dev)
    if rcfg != cfg:
        raise AssertionError("the restored config differs")
    for a, b in zip(tu.leaves({"p": q, "b": state["bn"]}), tu.leaves({"p": rp, "b": rbn})):
        if a.dtype != b.dtype or not bits_equal(a, b):
            raise AssertionError("a restored leaf differs from the saved one")

    # 3. serve the restored weights: the fused kernel against the dense executor
    pcfg = dataclasses.replace(rcfg, conv_exec="pallas")
    det = harness.compile_eval_detector(pcfg, rp, rbn, device=dev)
    oracle = harness.compile_eval_detector(dataclasses.replace(pcfg, conv_exec="dense"), rp,
                                           rbn, device=dev)
    frames = torch.from_numpy((np.random.default_rng(SEED).integers(
        0, 256, (BATCH, *cfg.input_hw, 3)) / 255.0).astype(np.float32)).to(dev)
    backend.reset_launches()
    dets, head = det.detect(frames)
    torch.cuda.synchronize()
    serve_launches = backend.launches[fp.KERNEL]
    odets, ohead = oracle.detect(frames)
    if serve_launches != 27:
        raise AssertionError(f"{serve_launches} fused launches serving the trained weights")
    for f in ("valid", "classes"):
        if not torch.equal(getattr(dets, f), getattr(odets, f)):
            raise AssertionError(f"trained weights: detections.{f} differ from dense")
    if not bits_equal(head, ohead):
        raise AssertionError("trained weights: the kernel executor's head differs from dense")
    _, _, aux = sy.forward(det.params, det.bn_state, frames, pcfg, plan=det.plan)
    _, _, oaux = sy.forward(oracle.params, oracle.bn_state, frames, oracle.cfg,
                            plan=oracle.plan)
    for k, v in oaux["spikes"].items():
        if not torch.equal(aux["spikes"][k].float(), v.float()):
            raise AssertionError(f"trained weights: {k} spikes differ from dense")
    served = {"launches": serve_launches, "valid": int(dets.valid.sum()),
              "spike_rates": {k: float(v.float().mean()) for k, v in aux["spikes"].items()}}
    print(json.dumps({"phase": "train_served", **served, **tag}), flush=True)

    # 4. the training CLI at demo_config, on the card
    t0 = time.perf_counter()
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train_detector", "--steps", "4",
         "--eval-images", "4", "--ckpt", os.path.join(root, "cli")],
        env={**os.environ, "PYTHONPATH": src}, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    print(json.dumps({"phase": "train_cli", "rc": cli.returncode, "seconds": cli_s,
                      "tail": cli.stdout.splitlines()[-6:], **tag}), flush=True)
    if cli.returncode != 0:
        raise AssertionError(f"the training CLI exited {cli.returncode}: {cli.stderr[-2000:]}")
    shutil.rmtree(root)
    return {"train": train, "parity": parity, "served": served, "cli_s": cli_s}


def phase_pipeline(dev, tag) -> dict:
    """(j) The paper's pipeline, ``harness.run_pipeline(CONFIG,
    conv_exec="pallas")``, at full width (576×1024, block 18×32, T=(1,3),
    FXP8), its steps and images cut to the run's time limit (its mAP then
    means nothing): float train, prune 0.8, QAT under the mask, the four
    evaluations (trained and pruned on the dense executor in f32, qat and
    uniform_t3 through the fused kernel), driven with the launch counts set
    to 0 just before it and read just after. Then: each quantized
    evaluation's 27 fused launches per ``detect()``; the uniform T=3
    evaluation's real layer inputs (conv_block at t_in = 3) replayed through
    the kernel and its plain version; the qat and uniform_t3 weights
    re-evaluated on the dense executor, reports identical and heads
    bit-equal; the pruned support exactly 0 after QAT; the accumulator
    report; every stage's time and each evaluation's images/s; the serve
    CLI's ``--eval-map --checkpoint`` gate and the benchmark runner
    (``run --fast``), each in a subprocess on the card."""
    import math
    import tempfile

    from repro_torch import backend
    from repro_torch import tree as tu
    from repro_torch.configs.snn_det import CONFIG
    from repro_torch.core import pruning
    from repro_torch.data import synthetic_detection as sd
    from repro_torch.eval import harness
    from repro_torch.eval import sharded as se
    from repro_torch.kernels import fused_pipeline as fp
    from repro_torch.models import snn_yolo as sy

    root = tempfile.mkdtemp(prefix="chip_smoke_pipeline_")
    ckpt_dir = os.path.join(root, "ckpt")
    cfg = CONFIG
    rows, captured = [], []
    eval_tags = iter(["trained", "pruned", "qat", "uniform_t3", "qat_dense",
                      "uniform_t3_dense"])
    real = {"train_steps": harness.train_steps, "evaluate_detector": harness.evaluate_detector,
            "prune_tree": pruning.prune_tree, "mask_tree": pruning.mask_tree,
            "fused_pipeline": fp.fused_pipeline}
    train_tags = iter(["train", "qat_train"])

    def timed(stage, fn, *a, **k):
        torch.cuda.synchronize()
        before = backend.launches[fp.KERNEL]
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        row = {"stage": stage, "s": time.perf_counter() - t0,
               "fused_launches": backend.launches[fp.KERNEL] - before}
        rows.append(row)
        return out, row

    def train_steps(c, **k):
        tag_ = next(train_tags)
        out, row = timed(tag_, real["train_steps"], c, **k)
        row.update(steps=k["steps"], batch=k["batch"], ms_per_step=row["s"] * 1e3 / k["steps"],
                   losses=out[3])
        print(json.dumps({"phase": "pipeline_stage", **row, **tag}), flush=True)
        return out

    def evaluate_detector(det, **k):
        tag_ = next(eval_tags)
        capture = tag_ == "uniform_t3"
        if capture:
            fp.fused_pipeline = capture_fused
        try:
            out, row = timed(tag_, real["evaluate_detector"], det, **k)
        finally:
            fp.fused_pipeline = real["fused_pipeline"]
        detects = math.ceil(out["n_images"] / 8)  # evaluate_detector's batch
        row.update(executor=det.cfg.conv_exec, weight_bits=det.cfg.weight_bits,
                   mixed_time=det.cfg.mixed_time, images=out["n_images"],
                   images_per_s=out["n_images"] / row["s"],
                   fused_launches_per_detect=row["fused_launches"] / detects,
                   map=out["map"], n_pred=out["n_pred"])
        print(json.dumps({"phase": "pipeline_stage", **row, **tag}), flush=True)
        return out

    def prune_tree(params, rate):
        pruning.prune_tree = real["prune_tree"]  # it recurses: time the outer call only
        try:
            out, row = timed("prune", real["prune_tree"], params, rate)
        finally:
            pruning.prune_tree = prune_tree
        print(json.dumps({"phase": "pipeline_stage", **row, **tag}), flush=True)
        return out

    def mask_tree(params, rate):
        out, row = timed("mask", real["mask_tree"], params, rate)
        print(json.dumps({"phase": "pipeline_stage", **row, **tag}), flush=True)
        return out

    def capture_fused(*args, **kwargs):
        out = real["fused_pipeline"](*args, **kwargs)
        if len(captured) < 27:
            x, w_, taps, affine, v0 = args
            captured.append(dict(x=x.clone(), w=w_, taps=taps, affine=affine,
                                 v0=None if v0 is None else v0.clone(), **kwargs))
        return out

    harness.train_steps, harness.evaluate_detector = train_steps, evaluate_detector
    pruning.prune_tree, pruning.mask_tree = prune_tree, mask_tree
    try:
        torch.cuda.synchronize()
        backend.reset_launches()
        t0 = time.perf_counter()
        rep = harness.run_pipeline(cfg=cfg, conv_exec="pallas", steps=PIPE_STEPS,
                                   finetune_steps=PIPE_FINETUNE, batch=PIPE_BATCH,
                                   eval_images=PIPE_IMAGES, ckpt_dir=ckpt_dir, device=dev)
        torch.cuda.synchronize()
        pipe_s = time.perf_counter() - t0
        launches = dict(backend.launches)

        # 2. the same weights on the dense executor: reports and heads equal
        det = rep.final_det
        dets = {"qat": det, "uniform_t3": harness.compile_eval_detector(
            dataclasses.replace(det.cfg, mixed_time=False), det.params, det.bn_state,
            device=dev)}
        images, _ = sd.eval_set(PIPE_IMAGES, hw=cfg.input_hw, grid_div=harness.grid_div(cfg),
                                num_anchors=cfg.num_anchors, num_classes=cfg.num_classes)
        frames = torch.from_numpy(images).to(dev)
        equal = {}
        for name, kdet in dets.items():
            dense = harness.compile_eval_detector(
                dataclasses.replace(kdet.cfg, conv_exec="dense"), kdet.params,
                kdet.bn_state, device=dev)
            want = harness.evaluate_detector(dense, n_images=PIPE_IMAGES)
            got = rep.stages["qat"] if name == "qat" else rep.schedules["uniform_t3"]
            if not se.reports_identical(got, want):
                raise AssertionError(f"{name}: the kernel's report differs from the dense "
                                     f"executor's: {got} vs {want}")
            with sy._no_tf32():
                kd, kh = kdet.detect(frames)
                dd_, dh = dense.detect(frames)
            if not bits_equal(kh, dh):
                raise AssertionError(f"{name}: kernel head != dense head: max |Δ| "
                                     f"{float((kh - dh).abs().max())}")
            for f in ("valid", "classes"):
                if not torch.equal(getattr(kd, f), getattr(dd_, f)):
                    raise AssertionError(f"{name}: detections.{f} differ from dense")
            equal[name] = {"report_identical": True, "head_bit_equal": True,
                           "valid": int(kd.valid.sum())}
    finally:
        harness.train_steps, harness.evaluate_detector = (real["train_steps"],
                                                          real["evaluate_detector"])
        pruning.prune_tree, pruning.mask_tree = real["prune_tree"], real["mask_tree"]
        fp.fused_pipeline = real["fused_pipeline"]
    by_stage = {r["stage"]: r for r in rows}
    per_detect = {k: by_stage[k]["fused_launches_per_detect"] for k in ("qat", "uniform_t3")}
    if per_detect != {"qat": 27, "uniform_t3": 27}:
        raise AssertionError(f"fused launches per detect() {per_detect}; want 27 each")
    if launches != {fp.KERNEL: 2 * 27 * math.ceil(PIPE_IMAGES / 8)}:
        raise AssertionError(f"run_pipeline launched {launches}")
    if any(by_stage[k]["fused_launches"] for k in ("train", "qat_train", "trained", "pruned")):
        raise AssertionError(f"a float or training stage launched the kernel: {rows}")

    # 1b. the uniform T=3 evaluation's layers: kernel against plain version
    if len(captured) != 27 or captured[1]["x"].shape[0] != 3:
        raise AssertionError(f"uniform T=3: captured {len(captured)} layers, conv_block "
                             f"t_in {captured[1]['x'].shape[0] if len(captured) > 1 else None}")
    uniform_ms, uniform_plain_ms, max_err = 0.0, 0.0, 0.0
    for args in captured:
        a = dict(args)
        x, w_, taps, affine, v0 = (a.pop(k) for k in ("x", "w", "taps", "affine", "v0"))
        spk, mem = fp.fused_pipeline(x, w_, taps, affine, v0, **a)
        rspk, rmem = fp.fused_pipeline_reference(x, w_, taps, affine, v0, **a)
        torch.cuda.synchronize()
        max_err = max(max_err, float((mem - rmem).abs().max()))
        if not (bits_equal(spk, rspk) and bits_equal(mem, rmem)):
            raise AssertionError(f"uniform T=3: kernel != plain version at layer input "
                                 f"{tuple(x.shape)}")
        uniform_ms += device_ms(lambda: fp.fused_pipeline(x, w_, taps, affine, v0, **a))[0]
        uniform_plain_ms += elapsed_ms(
            lambda: fp.fused_pipeline_reference(x, w_, taps, affine, v0, **a), reps=1)
    del captured[:]

    # 3. the pruned support: every entry pruning zeroed is still exactly 0
    _, fparams, _, _ = harness.restore_detector_checkpoint(ckpt_dir, step=PIPE_STEPS,
                                                           device=dev)
    mask = pruning.mask_tree(fparams, 0.8)
    leaked = sum(int((w[m == 0] != 0).sum())
                 for m, w in zip(tu.leaves(mask), tu.leaves(det.params)))
    kept = sum(int(m.sum()) for m in tu.leaves(mask))
    if leaked:
        raise AssertionError(f"{leaked} pruned weights are nonzero after QAT")
    acc = rep.accumulator
    out = {"config": "CONFIG", "input_hw": list(cfg.input_hw), "steps": PIPE_STEPS,
           "finetune_steps": PIPE_FINETUNE, "batch": PIPE_BATCH, "eval_images": PIPE_IMAGES,
           "note": "steps and images cut to the time limit: the mAP is not meaningful",
           "pipeline_s": pipe_s, "launches": launches, "fused_launches_per_detect": per_detect,
           "summary": rep.summary(), "kernel_vs_dense": equal,
           "pruned_support_preserved": True, "kept_weights": kept,
           "accumulator_max_abs": acc["max_abs"], "accumulator_within_16b": acc["within_16b"],
           "uniform_t3_kernel_ms": uniform_ms, "uniform_t3_plain_ms": uniform_plain_ms,
           "uniform_t3_max_abs_err": max_err, "stages": rows}
    print(json.dumps({"phase": "pipeline", **out, **tag}), flush=True)
    del rep, det, dets, frames
    torch.cuda.empty_cache()

    # 6, 7. the serve CLI's gate and the benchmark runner, on the card
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    env = {**os.environ, "PYTHONPATH": src}
    for name, argv in (
        ("serve_eval_map", ["-m", "repro_torch.launch.serve", "--arch", "snn-det",
                            "--eval-map", "--checkpoint", ckpt_dir, "--requests", "8"]),
        ("benchmarks_run", ["-m", "repro_torch.benchmarks.run", "--fast", "--json",
                            os.path.join(root, "run.json")]),
    ):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, *argv], env=env, cwd=root, capture_output=True,
                           text=True, timeout=300 if name == "serve_eval_map" else 600)
        lines = r.stdout.splitlines()
        out[name] = {"rc": r.returncode, "seconds": time.perf_counter() - t0,
                     "tail": lines[-8:] if name == "benchmarks_run" else
                     [ln for ln in lines if "parity" in ln or "served" in ln or
                      "restored" in ln]}
        print(json.dumps({"phase": name, **out[name], **tag}), flush=True)
        if r.returncode != 0:
            raise AssertionError(f"{name} exited {r.returncode}: {r.stdout[-3000:]}"
                                 f"{r.stderr[-3000:]}")
    if not any("BIT-IDENTICAL" in ln for ln in out["serve_eval_map"]["tail"]) or not any(
            "conv_exec pallas" in ln for ln in out["serve_eval_map"]["tail"]):
        raise AssertionError(f"serve --eval-map: no BIT-IDENTICAL parity line through the "
                             f"kernel executor: {out['serve_eval_map']['tail']}")
    done = [ln for ln in out["benchmarks_run"]["tail"] if "benchmark suites completed" in ln]
    if not done or not done[0].startswith("all "):
        raise AssertionError(f"run --fast did not complete: {out['benchmarks_run']['tail']}")
    shutil.rmtree(root)
    return out


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
    ptxas = {}  # library -> ptxas's registers / shared memory / spill lines
    for name in libs:
        log = backend.build_log(name)
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
        print(json.dumps({"phase": "ptxas", "library": name, "lines": ptxas[name]}))

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
    streamed = phase_streamed_packed(dev, tag)

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
        plan = fp.last_plan()
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
               "bound_by": by, "host_ms": host_ms, "plain_host_ms": plain_host_ms,
               "plan": plan}
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

    # ---------------- e, f, g. the two kernels off the detector; the benchmarks
    lif = phase_lif(dev, tag)
    mm = phase_matmul(dev, tag)
    print(json.dumps({"phase": "elapsed", "after": "e, f", "s": time.perf_counter() - t_start}),
          flush=True)
    benches = phase_benchmarks(dev, tag)
    print(json.dumps({"phase": "elapsed", "after": "g", "s": time.perf_counter() - t_start}),
          flush=True)

    # ------------------------------------------------------------ h. the engine
    conv.pop("det")  # the converted detector's weights and frames: not needed any more
    conv.pop("frames")
    torch.cuda.empty_cache()
    engine = phase_engine(dev, det, tag)
    print(json.dumps({"phase": "elapsed", "after": "h", "s": time.perf_counter() - t_start}),
          flush=True)

    # ---------------------------------------------------------- i. training
    trained = phase_train(dev, tag)
    print(json.dumps({"phase": "elapsed", "after": "i", "s": time.perf_counter() - t_start}),
          flush=True)

    # ------------------------------------------------ j. the paper's pipeline
    torch.cuda.empty_cache()
    pipeline = phase_pipeline(dev, tag)
    print(json.dumps({"phase": "elapsed", "after": "j", "s": time.perf_counter() - t_start}),
          flush=True)
    train_launches = trained["train"]["kernel_launches"]
    bl, el = benches["bench_launches"], benches["e2e_launches"]
    lif0, mm0 = lif["rows"][0], mm["rows"][0]  # kernel_bench's own shapes

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
        "packed_streamed_7x7": {k: streamed[k] for k in ("ms", "predecoded_ms", "plain_ms",
                                                         "bound_ms", "bound_by", "plan")},
        "launches_engine": engine["join"]["launches"][fp.KERNEL],
        "launches_engine_per_tick": engine["join"]["launches_per_tick"],
        "engine_ticks": engine["join"]["ticks"],
        "t16_ms": fused16["ms_per_frame"],
        "t16_plain_ms": fused16["plain_ms_per_frame"],
        "t16_bound_ms": fused16["bound_ms_per_frame"],
        "launches_converted": conv["launches"]["fused"],
        "ptxas": ptxas.get("fused_pipeline", []),
        "smem_bytes": sorted({r["plan"]["smem_bytes"] for r in layers}),
        "launches_kernel_bench": bl["fused_pipeline"],
        "launches_e2e": el["fused_pipeline"],
        "e2e_wall_ms": {ex: r["wall_s"] * 1e3
                        for ex, r in benches["e2e"]["executors"].items()},
        "launches_train_steps": train_launches.get("fused_pipeline", 0),
        "launches_serving_trained_weights": trained["served"]["launches"],
        "launches_pipeline": pipeline["launches"].get("fused_pipeline", 0),
        "launches_pipeline_per_detect": pipeline["fused_launches_per_detect"],
        "pipeline_uniform_t3_ms": pipeline["uniform_t3_kernel_ms"],
        "pipeline_uniform_t3_plain_ms": pipeline["uniform_t3_plain_ms"],
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
        "design": "int8 mma.sync m16n8k32 (u8 x s8 -> s32) on the compressed weights decoded "
                  "per block into shared memory over the live taps; the fused kernel's conv "
                  "loop (csrc/igemm_conv.cuh: halo A tiles where C % 32 == 0 or C == 16, else "
                  "im2col gathers; the M images folded into the pixel tiles); int32 sums "
                  "staged for 16-byte stores",
        "plans": conv["plans"],
        "ptxas": ptxas.get("gated_one_to_all", []),
        "check": "int32 bit-equal to the plain version at the 12 encode/3x3 shapes, an "
                 "all-dead layer and the main path's inputs",
        "library": "F.conv2d f32, TF32 off, over the replicate-padded blocks",
        "library_equal": conv["library_equal"],
        "launches_taps_forward": conv["taps_launches"]["gated"],
        "ms_12_shapes": sum(r["ms"] for r in gated["rows"][:12]),
        "launches_kernel_bench": bl["gated_one_to_all"],
        "launches_train_steps": train_launches.get("gated_one_to_all", 0),
        "launches_pipeline": pipeline["launches"].get("gated_one_to_all", 0),
    }, {
        "name": "fused_lif",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/spike_lif.cu",
        "replaces": "src/repro/kernels/spike_lif.py:29",
        "launches": bl["spike_lif"],
        "max_abs_err": lif["max_abs_err"],
        "ms": lif0["ms"],
        "plain_ms": lif0["plain_ms"],
        "bound_ms": lif0["bound_ms"],
        "bound_by": lif0["bound_by"],
        "library_ms": None,
        "library": "none: no single PyTorch call computes LIF over T",
        "per": f"one call at kernel_bench's {tuple(lif0['shape'])}; launches: one "
               "kernel_bench run (0 per detector frame)",
        "check": "int8 spikes equal to the plain version at every shape",
        "shapes": [{k: r[k] for k in ("shape", "ms", "plain_ms", "bound_ms")}
                   for r in lif["rows"]],
        "launches_train_steps": train_launches.get("spike_lif", 0),
        "launches_pipeline": pipeline["launches"].get("spike_lif", 0),
    }, {
        "name": "bitmask_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bitmask_matmul.cu",
        "replaces": "src/repro/kernels/bitmask_matmul.py:96",
        "launches": bl["bitmask_matmul"],
        "max_abs_err": mm["max_abs_err"],
        "max_abs_err_f64": mm["max_abs_err_f64"],
        "ms": mm0["ms"],
        "plain_ms": mm0["plain_ms"],
        "bound_ms": mm0["bound_ms"],
        "bound_by": mm0["bound_by"],
        "library_ms": mm0["library_ms"],
        "library": "torch.matmul f32 on the dense W, TF32 off",
        "per": f"one call at kernel_bench's {tuple(mm0['m_k_n'])}; launches: one "
               "kernel_bench run (0 per detector frame)",
        "check": "within 1e-5·(|x|@|W|) + 1e-6 of float64 and of the plain version",
        "shapes": [{k: r[k] for k in ("case", "m_k_n", "splits", "ms", "plain_ms", "library_ms",
                                      "bound_ms", "bound_by")} for r in mm["rows"]],
        "ptxas": ptxas.get("bitmask_matmul", []),
        "smem_bytes": sorted({r["plan"]["smem_bytes"] for r in mm["rows"]}),
        "launches_train_steps": train_launches.get("bitmask_matmul", 0),
        "launches_pipeline": pipeline["launches"].get("bitmask_matmul", 0),
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
