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

ANN→SNN conversion (``repro_torch.convert``), the fused kernel serving
converted detectors at T=128 and T=64 with unpruned weights:

k. The committed ANN fixture (``tests/fixtures/ann_detector``, 96×160, 3 CSP
   stages) converted at ``ConvertConfig()`` (T=128, 32 calibration images,
   soft reset, rate encode, rate pool) on the card and on the CPU: λ, γ, β
   and α compared, and the plans' int8 weights (a difference only at a
   rounding half). 48 val images evaluated through the kernel and the
   dense executor: reports identical, heads bit-equal, ``valid`` and
   ``classes`` equal, 17 fused launches per ``detect()`` (the fixture's
   fused layers); the first ``detect()``'s layers replayed bit for bit
   against the plain version at T=128; the mAP@0.5 beside the JAX
   package's 0.39. Then a seeded ANN-mode ``CONFIG`` (576×1024) exported
   and loaded back, converted on the committed COCO fixture's 4 images at
   T=64 (cut from 128), evaluated likewise (27 fused launches per
   ``detect()``, spikes reaching stage4, each layer's plan and whether its
   weights stay resident in shared memory). Then the CLIs in subprocesses:
   ``launch.convert --conv-exec pallas``, the serve CLI's ``--eval-map``
   gate on its checkpoint (BIT-IDENTICAL), ``eval_map --checkpoint`` on
   the COCO fixture. Times: calibration, emit, head fit; images/s per
   executor; the fused kernel's ms per ``detect()`` beside its bound; peak
   memory.

LM token serving (``repro_torch.serve.Engine`` over ``LMEngineCore``), no
hand-written kernel on its path:

l. qwen1.5-0.5b (16 requests) and olmoe-1b-7b (8 requests) at their
   published widths in bf16, seeded weights drawn on the card, through
   ``Engine(n_slots=8, max_seq=512)``, 32 new tokens a request, prompts of
   3–200 tokens so prefill buckets 16 to 256 all occur (after a warm-up
   request per bucket): tokens/s over the run, prefill device ms per
   bucket and decode-step device and host ms (CUDA events), one steady
   8-slot decode step's kernel time (``torch.profiler``) over its wall
   time (the busy share), peak memory; for the MoE the entries dropped at
   capacity in its largest prefill bucket. The card against the port's CPU
   run at ``smoke_config`` of qwen1.5-0.5b, olmoe-1b-7b and
   deepseek-moe-16b (f32, TF32 off), and 8 requests served in 8 slots
   against each served alone (qwen1.5-0.5b full width, f32): logits within
   4e-3 of the largest |logit| at every step and tokens equal, up to the
   first step whose top-2 margin is below that bound (reported). The
   launch counts, set to 0 before the phase, read 0 after it. The serve
   CLI (``--arch qwen1.5-0.5b --requests 8``) prints its tokens/s line, and
   ``--arch whisper-small`` exits non-zero naming ROADMAP R10 (the Engine
   does not serve the vlm and audio families).

LM training (``repro_torch.train.trainer``, ``repro_torch.launch.train``),
no hand-written kernel on its path:

m. One ``make_train_step`` step of qwen1.5-0.5b and olmoe-1b-7b at
   ``smoke_config`` (f32, TF32 off) on the card and on the CPU from the same
   seeded parameters and ``lm_data.batch_at`` batch, with 1 and 2
   microbatches and once with int8 gradient compression and int8 moments:
   loss, gradient norm, gradients and new parameters within
   ``tests/test_torch_lm_train.py``'s bounds. Then ``launch.train.main`` at
   full width in bf16 with remat: qwen1.5-0.5b at seq 4096, batch 8 in 4
   microbatches, 6 steps; olmoe-1b-7b at seq 2048, batch 4 in 2
   microbatches, int8 moments (each run's cuts on its line): the step time
   by CUDA events (median after the first step), tokens/s, peak memory and
   the state's bytes by part, one step's kernel time and launches by
   ``torch.profiler`` (its busy share), the first and last loss (the
   launcher's own gate: the loss falls), and for the MoE the entries
   dropped at capacity in layer 0. A ``--ckpt`` run of qwen1.5-0.5b at full
   width, resumed by a second invocation: the restored state bit-equal to
   the first run's final state, the step count continuing. The launch
   counts, set to 0 before the phase, read 0 after it.

Multi-process execution (``repro_torch.distributed``), two processes sharing
the card (each its own CUDA context; gloo, tensors staged through the host:
NCCL refuses two ranks on one card):

n. The parent saves ``demo_weights(CONFIG)`` (576×1024, pruned 0.8) as a
   detector checkpoint and scores 16 val images in one process; two
   processes (``python -c``, a free port, every wait bounded) each restore
   it on their card, load the kernels the parent built (a rebuild fails the
   phase), and run ``evaluate_detector(sharded=ShardedEvalConfig(4,
   batch=4), ctx=)`` on their 2 shards: each report identical to the
   parent's, ``gather == "process"``, 27 fused launches per ``detect()``,
   ``n_shards=3`` refused ("stripe evenly"); per process the wall time,
   images/s, the gather's ms, the backend and peak memory. Then
   ``launch.serve --eval-map --eval-shards 2`` and ``eval_map --shards 2``
   on that checkpoint print BIT-IDENTICAL. Data-parallel ``launch.train``:
   qwen1.5-0.5b at ``smoke_config`` (f32, batch 8, seq 16, 11 steps) in two
   processes within rtol 2e-4 of one process; at full width (bf16, remat,
   seq 1024, global batch 8, 6 steps) two processes at microbatch 1 against
   one at microbatch 2: per process the step ms (CUDA events), the
   all-reduce's ms and bytes, peak memory; tokens/s; first losses within
   1e-3 relative (the largest difference over the run printed, not gated:
   the runs group the rows differently in bf16). Finally the two-process
   full-width run with ``--ckpt`` for 4 steps (a striped save, its ms), its
   ``shard_manifest.json`` listing both hosts, resumed by one process to
   step 8: the restored state's per-leaf checksums equal to both hosts'
   final state's.

The other LM families (``repro_torch.models``: rwkv6, mamba2 and the
hybrid, whisper, llava), no hand-written kernel on their path:

o. At ``smoke_config`` (f32, TF32 off) the card against the port's CPU run
   for rwkv6-3b and zamba2-7b through ``Engine`` (4 slots, 7 requests) and
   for whisper-small and llava-next-34b through their API (prefill with
   seeded frames or patches, then greedy ``decode_fn`` steps): tokens
   equal, logits within 4e-3 of the largest |logit| (phase l's bound for
   paths through the bf16 cache; the reading is printed).
   At full width in bf16 with seeded weights: rwkv6-3b and zamba2-7b
   through ``Engine`` with phase l's traffic (8 slots × 512 rows, 16
   requests of 3–200 prompt tokens, 32 new tokens; exact-length prefill,
   the entries kept reported); whisper-small through its API (batch 8,
   frames (8, 1500, 768), 4-token prompts, 32 new tokens; the encoder and
   ``cross_kv`` ms); llava-next-34b through its API (batch 1, 2880 patches
   of width 1024, a 64-token prompt, 16 new tokens) at its 60 layers when
   they fit beside the run's headroom, else with ``n_layers`` cut (printed
   with the measured peak). Each row: tokens/s, prefill ms, the decode
   step's host and device ms and busy share (``torch.profiler``), peak
   memory, the bytes of the params (beside ``n_params()``'s count) and of
   the cache or state. The launch counts, set to 0 before the phase, read
   0 after it.
p. The fused kernel's tile autotuner at 576×1024, T = (1, 3), batch 2:
   every candidate tile (``autotune.candidates``) of every distinct fused
   layer shape on seeded inputs, bit-equal to the shape rule's tile and to
   the plain version, its launch plan's shared memory equal to the
   library's plan query (``fp.tile_plan``); each shape's candidate times
   (CUDA events, launches queued behind a spin) and winner beside the
   rule's tile. The committed ``kernels/autotune_cache.json`` must name
   this card and the current kernel hash and cover every shape at batches
   2, 8 and 64 (the frame's, and the engine's at 8 and 64 streams, which
   phase h ran with), and the serving plan must carry its batch-2 tiles;
   the 27 launches of frame 0 are timed at the plan's
   tiles and at the rule's, and a frame of a tuned and of an untuned
   session (27 launches each), in turns.
q. ``launch.dryrun`` for every ``h100`` cell of qwen1.5-0.5b, olmoe-1b-7b,
   rwkv6-3b, zamba2-7b and llava-next-34b (meta tensors): each parameter
   tree's bytes equal to phases l, m and o's real trees; the roofline
   table; phase m's qwen step's counted FLOPs over its measured time
   (achieved TFLOP/s beside the 989 TFLOP/s data-sheet peak; printed, not
   gated); ``detector_dryrun``'s 576×1024 roofline terms and its shard
   check on the card (4 column shards of 8 input block columns): every
   layer before the first whose map a shard cuts inside a block bit-equal
   to the whole forward's columns, and that layer the one reported.

The developer entry points (``repro_torch.launch.quickstart``,
``mixed_timestep_search``, ``serve_lm``, ``make_ann_fixture``;
``repro_torch.benchmarks.check_crossover``), each as a user calls it:

r. The quickstart at 144x256 on the card: its step 5 is one gated launch
   on a (1, 18, 32, 256) spike tile, bit-equal to the plain version (and
   timed beside it and its bound); every figure it prints equal to its
   CPU run on the same seeded weights (the f32 spike rates and mIoUT,
   means reduced in another order, within 1e-6). The mixed-time-step search
   at 144x256 and 576x1024: schedule and GOps equal on the card and the
   CPU. ``serve_burst`` for qwen1.5-0.5b, olmoe-1b-7b, rwkv6-3b and
   zamba2-7b at their smoke configs (12 requests, 4 slots; CPU weights
   moved to the card): 12 streams equal on the card and the CPU, tokens/s.
   ``make_ann_fixture`` on the card (120 of its 4000 steps, 8 val
   images): the loss falls (mean of the last 20 steps below the first
   20's), ms a step, no kernel launched; its bundle converted by
   ``launch.convert --conv-exec pallas --eval-images 8`` in a subprocess:
   exit 0, 17 fused launches per ``detect()``. ``check_crossover`` on phase
   g's 576x1024 result must hold (and its CLI exit 0); at 96x128 (the JAX
   package's gate file's size) the ratio is printed as a reading. The
   search and the LM bursts launch no kernel.

Sharded training state (``repro_torch.distributed.fsdp``):

s. qwen1.5-32b at full width (d_model 5120, 40 heads, d_ff 27392, vocab
   152064, bf16, remat), 2 of its 64 layers, through the launcher's own
   training function (``launch.train.train``, the config its ``fsdp``
   keeps): two processes sharing the card over gloo, each holding its
   slices of every ``embed``-axis leaf, seq 1024, global batch 2, int8
   moments, 3 steps; then the same run replicated in this process. Per
   process: state bytes by part beside the whole state's (at most 0.52 of
   the one-process state), peak memory (the init's and the steps'), each
   step's ms (CUDA events), the gathers' and reduce-scatters' bytes each
   step and their host ms in the last step (timed with the card
   synchronised around each). The two loss series equal within rtol
   2e-4, atol 1e-5, and each step's gradient norm in both processes that
   of the one process within rtol 1e-2; no kernel launched.

The audio and vlm families' train step (``make_train_step(api.loss_fn)``
on the frames or patches batch), and compression over the sharded state:

t. whisper-small and llava-next-34b at their smoke configs: one step on
   the card against the CPU (phase m's three cases, its bounds).
   whisper-small at full width (12 + 12 layers, d_model 768, vocab 51865,
   1500 frames, bf16, remat), seq 4096, global batch 4 in 2 microbatches,
   f32 moments, 4 steps: each step's ms (CUDA events), tokens/s, peak
   memory, state bytes. llava-next-34b at full width (d_model 7168, 56
   heads, 8 kv, d_ff 20480, vocab 64000, 2880 patches), 1 of its 60 layers,
   1024 text tokens, global batch 2 in microbatches of one row, int8
   moments, error-feedback compression, remat, under its config's
   ``fsdp``: two processes sharing the card over gloo, each holding its
   slices of every ``embed``-axis leaf and of the residual, 2 steps; then
   the same run replicated in this process. Per process: state bytes by
   part (residual included) and each part's share of the whole (at most
   0.52 of the whole state), peaks, step ms, the gathers' and
   reduce-scatters' bytes each step and their host ms in the second. The
   loss series equal within rtol 2e-4, atol 1e-5, each step's gradient
   norm within rtol 1e-2; no kernel launched.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists each kernel with its launches, error and times.
"""
from __future__ import annotations

import dataclasses
import gc
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
# phase k: the committed ANN fixture converted at ConvertConfig()'s defaults
# (T=128, 32 calibration images) and scored on 48 val images; a full-width
# conversion calibrated on the committed COCO fixture, T cut from 128 to 64
FIXTURE_NPZ = ("tests", "fixtures", "ann_detector", "ann_tiny_yolo.npz")
COCO_JSON = ("tests", "fixtures", "coco_fixture", "instances.json")
CONVERT_FIXTURE_CC: dict = {}  # ConvertConfig overrides for step 1: none
CONVERT_EVAL_IMAGES, CONVERT_FULL_T = 48, 64


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
    rows = []
    eval_tags = iter(["trained", "pruned", "qat", "uniform_t3", "qat_dense",
                      "uniform_t3_dense"])
    real = {"train_steps": harness.train_steps, "evaluate_detector": harness.evaluate_detector,
            "prune_tree": pruning.prune_tree, "mask_tree": pruning.mask_tree,
            "fused_pipeline": fp.fused_pipeline}
    record, captured = fused_recorder(fp, 27)  # the uniform T=3 evaluation's launches
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
            fp.fused_pipeline = record
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
    uniform, _ = replay_fused([n for n in det.plan.layers if n != "head"], captured, tag,
                              phase="pipeline_uniform_t3", plain_ms=True)
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
           "uniform_t3_kernel_ms": uniform["ms"], "uniform_t3_plain_ms": uniform["plain_ms"],
           "stages": rows}
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


def fused_recorder(fp, limit: int):
    """(stand-in, captured): a stand-in for ``fp.fused_pipeline`` that calls
    it and keeps the first ``limit`` launches' inputs (cloned), for the
    replay against the plain version."""
    real = fp.fused_pipeline
    captured = []

    def record(*args, **kwargs):
        out = real(*args, **kwargs)
        if len(captured) < limit:
            x, w_, taps, affine, v0 = args
            captured.append(dict(x=x.clone(), w=w_, taps=taps, affine=affine,
                                 v0=None if v0 is None else v0.clone(), **kwargs))
        return out

    return record, captured


def replay_fused(names, captured, tag, *, phase: str, plain_ms: bool) -> tuple[dict, list]:
    """Each captured launch through the kernel and its plain version, bit for
    bit (the plain version one image at a time: a batch's rows are
    independent, and its im2col at T=64 and full width would not fit at
    once), with the kernel's device ms, its tile plan (``resident``: the
    tile's weights kept in shared memory, 0 if streamed), the spike rate and
    the layer's bound. Returns (totals per pass, rows)."""
    from repro_torch.kernels import fused_pipeline as fp

    tot = {"ms": 0.0, "plain_ms": 0.0 if plain_ms else None, "bound_ms": 0.0}
    bound_by = {"bytes": 0.0, "operations": 0.0}
    rows = []
    for name, args in zip(names, captured):
        a = dict(args)
        x, w_, taps, affine, v0 = (a.pop(k) for k in ("x", "w", "taps", "affine", "v0"))
        spk, mem = fp.fused_pipeline(x, w_, taps, affine, v0, **a)
        plan = fp.last_plan()
        rate = int(spk.sum(dtype=torch.int64)) / spk.numel()
        for i in range(x.shape[1]):
            rspk, rmem = fp.fused_pipeline_reference(
                x[:, i : i + 1], w_, taps, affine, None if v0 is None else v0[i : i + 1], **a)
            torch.cuda.synchronize()
            if not (bits_equal(spk[:, i : i + 1].contiguous(), rspk)
                    and bits_equal(mem[i : i + 1], rmem)):
                raise AssertionError(f"{phase}: kernel != plain version at {name}, image {i}, "
                                     f"input {tuple(x.shape)}")
            del rspk, rmem
        del spk, mem
        ms, _ = device_ms(lambda: fp.fused_pipeline(x, w_, taps, affine, v0, **a), reps=3)
        row = {"layer": name, "x": list(x.shape), "t_out": a["t_out"], "kout": a["kout"],
               "live_taps": len(taps), "spike_rate": rate, "ms": ms}
        if plain_ms:
            row["plain_ms"] = elapsed_ms(
                lambda: fp.fused_pipeline_reference(x, w_, taps, affine, v0, **a), reps=1)
            tot["plain_ms"] += row["plain_ms"]
        row["bound_ms"], row["bound_by"] = layer_bound(args)
        row["resident"], row["plan"] = plan["resident"], plan
        bound_by[row["bound_by"]] += row["bound_ms"]
        tot["ms"] += ms
        tot["bound_ms"] += row["bound_ms"]
        rows.append(row)
        print(json.dumps({"phase": f"{phase}_layer", **row, **tag}), flush=True)
    tot["bound_by"] = max(bound_by, key=bound_by.get)
    return tot, rows


def evaluate_both(cfg, params, bn, dev, *, n_images: int, source, n_fused: int,
                  label: str, tag) -> dict:
    """The converted detector evaluated on one split through the kernel
    executor (the launch counts set to 0 just before, read just after; the
    first ``detect()``'s fused launches captured) and through the dense
    executor. Gates: the reports identical, every batch's head bit-equal,
    ``valid`` and ``classes`` equal, ``n_fused`` fused launches per
    ``detect()`` and none on the dense executor."""
    import math

    from repro_torch import backend
    from repro_torch.eval import harness
    from repro_torch.eval import sharded as se
    from repro_torch.kernels import fused_pipeline as fp

    real = fp.fused_pipeline
    record, captured = fused_recorder(fp, n_fused)
    out = {}
    for ex in ("pallas", "dense"):
        det = harness.compile_eval_detector(dataclasses.replace(cfg, conv_exec=ex), params, bn,
                                            device=dev)
        seen = []
        real_detect = det.detect

        def detect(frames, _real=real_detect, _seen=seen):
            d, h = _real(frames)
            _seen.append((d, h))
            return d, h

        det.detect = detect
        fp.fused_pipeline = record if ex == "pallas" else real
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            backend.reset_launches()
            t0 = time.perf_counter()
            rep = harness.evaluate_detector(det, n_images=n_images, source=source)
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            launches = dict(backend.launches)
        finally:
            fp.fused_pipeline = real
        detects = math.ceil(rep["n_images"] / 8)  # evaluate_detector's batch
        want = {fp.KERNEL: n_fused * detects} if ex == "pallas" else {}
        if {k: v for k, v in launches.items() if v} != want:
            raise AssertionError(f"{label} [{ex}]: launches {launches}; want {want} "
                                 f"({n_fused} fused per detect())")
        out[ex] = {"report": rep, "s": s, "images_per_s": rep["n_images"] / s,
                   "launches": launches, "detects": detects, "seen": seen,
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del det
    k, d = out["pallas"], out["dense"]
    if not se.reports_identical(k["report"], d["report"]):
        raise AssertionError(f"{label}: the kernel's report differs from the dense executor's: "
                             f"{k['report']} vs {d['report']}")
    for b, ((kd, kh), (dd_, dh)) in enumerate(zip(k.pop("seen"), d.pop("seen"))):
        if not torch.isfinite(kh).all():
            raise AssertionError(f"{label}: non-finite head in batch {b}")
        if not bits_equal(kh, dh):
            raise AssertionError(f"{label}: kernel head != dense head in batch {b}: max |Δ| "
                                 f"{float((kh - dh).abs().max())}")
        for f in ("valid", "classes"):
            if not torch.equal(getattr(kd, f), getattr(dd_, f)):
                raise AssertionError(f"{label}: detections.{f} differ from dense in batch {b}")
    if len(captured) != n_fused:
        raise AssertionError(f"{label}: captured {len(captured)} fused launches, want {n_fused}")
    return {"executors": out, "captured": captured}


def timed_convert(cv, emit, ann, cc, *, source, device) -> tuple:
    """convert_ann with its calibration and head fit timed apart (the rest is
    the emit: rescale, conditioning, plan). Returns (out, stats, times)."""
    real_cal, real_fit = emit._calibrate, emit._fit_head_scale
    got, times = {}, {}

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    def cal(*a, **k):
        t = time.perf_counter()
        got["stats"] = real_cal(*a, **k)
        sync()
        times["calibration_s"] = time.perf_counter() - t
        return got["stats"]

    def fit(*a, **k):
        t = time.perf_counter()
        alpha = real_fit(*a, **k)
        sync()
        times["head_fit_s"] = time.perf_counter() - t
        return alpha

    emit._calibrate, emit._fit_head_scale = cal, fit
    try:
        sync()
        t0 = time.perf_counter()
        out = cv.convert_ann(ann, source=source, cc=cc, device=device)
        sync()
        times["total_s"] = time.perf_counter() - t0
    finally:
        emit._calibrate, emit._fit_head_scale = real_cal, real_fit
    times["emit_s"] = times["total_s"] - times["calibration_s"] - times["head_fit_s"]
    return out, got["stats"], times


def int8_compare(plan_a, plan_b, params_a) -> dict:
    """The two plans' int8 weights: how many differ, by how much, and how many
    of those sit on a rounding half of ``params_a``'s float weight over its
    scale (the two devices' f32 sums in another order; any other difference
    is a fault)."""
    n = other = worst = 0
    for name, lp in plan_a.layers.items():
        a, b = lp.w_q.cpu().numpy(), plan_b.layers[name].w_q.cpu().numpy()
        diff = a != b
        if not diff.any():
            continue
        q = params_a[name]["w"].cpu().numpy() / float(lp.scale)
        half = np.abs(np.abs(q - np.trunc(q)) - 0.5) <= 2e-3
        n += int(diff.sum())
        other += int((diff & ~half).sum())
        worst = max(worst, int(np.abs(a.astype(np.int32) - b).max()))
    return {"int8_differ": n, "int8_max_abs_diff": worst, "int8_not_at_a_half": other}


def phase_conversion(dev, tag) -> dict:
    """(k) ANN→SNN conversion (``repro_torch.convert``) on the card, its
    converted detectors served by the fused kernel at T=128 and T=64.

    1. The committed fixture at ``ConvertConfig()`` (T=128, 32 calibration
       images of the synthetic train split), converted on the card and on
       the CPU: the largest relative differences of λ, γ, β and α, and the
       plans' int8 weights compared. 48 val images evaluated through the
       kernel and the dense executor (reports identical, heads bit-equal,
       one fused launch per fused layer per ``detect()``: 17 at the
       fixture's 3 stages), the first ``detect()``'s launches replayed
       against the plain version; the mAP beside the JAX package's 0.39.
    2. A seeded ANN-mode ``CONFIG`` (576×1024, block 18×32) exported and
       loaded back, converted on the 4 images of the committed COCO
       fixture at T=64, its 4 letterboxed images evaluated likewise (27
       fused launches per ``detect()``, spikes reaching stage4, every
       layer's plan and resident weights printed).
    3. The converted checkpoint through the CLIs, in subprocesses: convert,
       the serve CLI's ``--eval-map`` gate, ``eval_map --checkpoint`` on the
       COCO fixture.
    4. The stage times, images/s per executor, the fused kernel's device ms
       per ``detect()`` beside its bound, and peak memory, each printed."""
    import tempfile

    from repro_torch import convert as cv
    from repro_torch.configs.snn_det import CONFIG
    from repro_torch.convert import emit
    from repro_torch.core import plan as cplan
    from repro_torch.data import detection_datasets as dd
    from repro_torch.models import snn_yolo as sy

    here = os.path.dirname(os.path.abspath(__file__))
    fixture = os.path.join(here, *FIXTURE_NPZ)
    coco = os.path.join(here, *COCO_JSON)
    root = tempfile.mkdtemp(prefix="chip_smoke_convert_")
    out = {}

    def fused_names(plan):
        return [n for n in plan.layers if n != "head"]

    # ----------------------------------------- 1. the fixture at T=128
    ann = cv.load_ann_npz(fixture)
    cc = dataclasses.replace(cv.ConvertConfig(), **CONVERT_FIXTURE_CC)
    conv, stats, times = timed_convert(cv, emit, ann, cc, source=None, device=dev)
    cpu, cpu_stats, cpu_times = timed_convert(cv, emit, ann, cc, source=None, device="cpu")

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))

    names = cv.conv_bn_layer_names(ann.cfg)
    card_vs_cpu = {
        "lambda": max(rel(stats.layers[n].lam, cpu_stats.layers[n].lam) for n in names),
        "gamma": max(rel(conv.params[n]["gamma"].cpu(), cpu.params[n]["gamma"]) for n in names),
        "beta": max(rel(conv.params[n]["beta"].cpu(), cpu.params[n]["beta"]) for n in names),
        "alpha": rel(conv.report["head_scale_fit"], cpu.report["head_scale_fit"]),
        **int8_compare(cplan.build_plan(conv.params, conv.cfg),
                       cplan.build_plan(cpu.params, cpu.cfg), conv.params),
    }
    del cpu
    print(json.dumps({"phase": "conversion_fixture", "t": conv.cfg.full_t,
                      "calib_images": cc.calib_images, "card_times": times, "cpu_times": cpu_times,
                      "card_vs_cpu": card_vs_cpu, "alpha": conv.report["head_scale_fit"],
                      **tag}), flush=True)
    plan = cplan.build_plan(conv.params, conv.cfg)
    ev = evaluate_both(conv.cfg, conv.params, conv.bn_state, dev, n_images=CONVERT_EVAL_IMAGES,
                       source=None, n_fused=len(fused_names(plan)), label="fixture", tag=tag)
    rep = ev["executors"]["pallas"]["report"]
    fixture_map = {"map": rep["map"], "per_class_ap": rep["per_class_ap"],
                   "n_images": rep["n_images"], "jax_cpu_map_t128": 0.39,
                   "jax_cpu_map_t64": 0.30,
                   "finding_below_0_30": bool(rep["map"] < 0.30)}
    tot, rows = replay_fused(fused_names(plan), ev.pop("captured"), tag,
                             phase="conversion_fixture", plain_ms=True)
    ex = ev["executors"]
    out["fixture"] = {
        "t": conv.cfg.full_t, "times": times, "cpu_times": cpu_times,
        "card_vs_cpu": card_vs_cpu, "mAP": fixture_map,
        "launches": ex["pallas"]["launches"], "detects": ex["pallas"]["detects"],
        "fused_launches_per_detect": len(fused_names(plan)),
        "images_per_s": {k: v["images_per_s"] for k, v in ex.items()},
        "eval_s": {k: v["s"] for k, v in ex.items()},
        "peak_gib": {k: v["peak_gib"] for k, v in ex.items()},
        "fused_ms_per_detect": tot, "batch": rows[1]["x"][1],
        "resident": {r["layer"]: r["resident"] for r in rows},
    }
    print(json.dumps({"phase": "conversion_fixture_eval", **out["fixture"], **tag}), flush=True)
    del conv, ev, rows
    torch.cuda.empty_cache()

    # -------------------------- 2. full width, calibrated on the COCO fixture
    acfg = dataclasses.replace(CONFIG, arch_id="snn-det-ann", mode="ann", weight_bits=0,
                               conv_exec="dense")
    params, bn = sy.init_params(acfg, seed=SEED, device=dev)
    npz = os.path.join(root, "ann_full.npz")
    t0 = time.perf_counter()
    cv.export_ann_npz(npz, params, bn, acfg)
    full = cv.load_ann_npz(npz)
    io_s = time.perf_counter() - t0
    if not all(np.array_equal(full.layers[n].w, params[n]["w"].cpu().numpy())
               for n in full.layers):
        raise AssertionError("export_ann_npz -> load_ann_npz changed a weight")
    del params, bn
    source = dd.parse_dataset_spec(f"coco:{coco}")
    cc2 = dataclasses.replace(cv.ConvertConfig(), calib_images=4, full_t=CONVERT_FULL_T)
    torch.cuda.reset_peak_memory_stats()
    conv2, _, times2 = timed_convert(cv, emit, full, cc2, source=source, device=dev)
    convert_peak = torch.cuda.max_memory_allocated() / 2**30
    plan2 = cplan.build_plan(conv2.params, conv2.cfg)
    n2 = len(fused_names(plan2))
    if n2 != 27:
        raise AssertionError(f"full width: {n2} fused layers, want 27")
    ev2 = evaluate_both(conv2.cfg, conv2.params, conv2.bn_state, dev, n_images=4,
                        source=source, n_fused=n2, label="full_width", tag=tag)
    tot2, rows2 = replay_fused(fused_names(plan2), ev2.pop("captured"), tag,
                               phase="conversion_full", plain_ms=False)
    rates = {r["layer"]: r["spike_rate"] for r in rows2}
    if not rates["stage4/agg"] > 0:
        raise AssertionError(f"full width: no spikes reach stage4: rates {rates}")
    ex2 = ev2["executors"]
    rep2 = ex2["pallas"]["report"]
    out["full_width"] = {
        "input_hw": list(conv2.cfg.input_hw), "t": conv2.cfg.full_t, "calib_images": 4,
        "cuts": {"t": f"{CONVERT_FULL_T} of ConvertConfig's 128: the dense oracle's f32 drives "
                      "at T=128 would hold ~10 GB at conv_block alone",
                 "calib_images": "4: all the COCO fixture has"},
        "export_load_s": io_s, "times": times2, "convert_peak_gib": convert_peak,
        "launches": ex2["pallas"]["launches"], "fused_launches_per_detect": n2,
        "map": rep2["map"], "n_images": rep2["n_images"],
        "images_per_s": {k: v["images_per_s"] for k, v in ex2.items()},
        "eval_s": {k: v["s"] for k, v in ex2.items()},
        "peak_gib": {k: v["peak_gib"] for k, v in ex2.items()},
        "fused_ms_per_detect": tot2, "batch": rows2[0]["x"][1],
        "resident": {r["layer"]: r["resident"] for r in rows2},
        "spike_rates": rates,
    }
    print(json.dumps({"phase": "conversion_full_width", **out["full_width"], **tag}), flush=True)
    del conv2, ev2, rows2, full
    torch.cuda.empty_cache()

    # ------------------------------- 3. the converted checkpoint through the CLIs
    ckpt_dir = os.path.join(root, "converted")
    env = {**os.environ, "PYTHONPATH": os.path.join(here, "src")}
    for name, argv, cwd in (
        ("convert_cli", ["-m", "repro_torch.launch.convert", "--out", ckpt_dir,
                         "--conv-exec", "pallas", "--eval-images", "48"], here),
        ("convert_serve_eval_map", ["-m", "repro_torch.launch.serve", "--arch", "snn-det",
                                    "--checkpoint", ckpt_dir, "--conv-exec", "pallas",
                                    "--eval-map", "--requests", "8"], root),
        ("convert_eval_map", ["-m", "repro_torch.benchmarks.eval_map", "--checkpoint", ckpt_dir,
                              "--dataset", f"coco:{coco}"], root),
    ):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, *argv], env=env, cwd=cwd, capture_output=True,
                           text=True, timeout=600)
        lines = r.stdout.splitlines()
        out[name] = {"rc": r.returncode, "seconds": time.perf_counter() - t0,
                     "tail": [ln for ln in lines if any(
                         s in ln for s in ("mAP", "parity", "served", "restored", "converted in",
                                           "wrote"))]}
        print(json.dumps({"phase": name, **out[name], **tag}), flush=True)
        if r.returncode != 0:
            raise AssertionError(f"{name} exited {r.returncode}: {r.stdout[-3000:]}"
                                 f"{r.stderr[-3000:]}")
    if not any(ln.startswith("converted mAP@0.5 = ") for ln in out["convert_cli"]["tail"]):
        raise AssertionError(f"convert CLI: no mAP line: {out['convert_cli']['tail']}")
    tail = out["convert_serve_eval_map"]["tail"]
    if not any("BIT-IDENTICAL" in ln for ln in tail) or not any(
            "conv_exec pallas" in ln for ln in tail):
        raise AssertionError(f"serve --eval-map on the converted checkpoint: no BIT-IDENTICAL "
                             f"parity line through the kernel executor: {tail}")
    if not os.path.exists(os.path.join(root, "BENCH_torch_eval_ckpt.json")) or os.path.exists(
            os.path.join(root, "BENCH_eval.json")):
        raise AssertionError(f"eval_map --checkpoint wrote {sorted(os.listdir(root))}")
    shutil.rmtree(root)

    # ----------------------------------------------------------- 4. the times
    h, w = out["full_width"]["input_hw"]
    for key, label in (("fixture", "the ANN fixture, 96x160"), ("full_width", f"CONFIG, {h}x{w}")):
        o = out[key]
        print(json.dumps({"phase": "conversion_time", "cell": label, "t": o["t"], **o["times"],
                          "images_per_s": o["images_per_s"],
                          "fused_ms_per_detect": o["fused_ms_per_detect"]["ms"],
                          "fused_bound_ms_per_detect": o["fused_ms_per_detect"]["bound_ms"],
                          "bound_by": o["fused_ms_per_detect"]["bound_by"],
                          "batch": o["batch"], "peak_gib": o["peak_gib"], **tag}), flush=True)
    return out



# phase l: LM token serving at full width, bf16 (qwen1.5-0.5b: 16 requests;
# olmoe-1b-7b: 8), 8 slots of 512 cache rows, 32 new tokens a request
LM_SERVE = (("qwen1.5-0.5b", 16), ("olmoe-1b-7b", 8))
LM_SLOTS, LM_MAX_SEQ, LM_NEW = 8, 512, 32
LM_BUCKETS = (16, 32, 64, 128, 256)  # prompts of 3..200 tokens reach each
LM_PARITY = ("qwen1.5-0.5b", "olmoe-1b-7b", "deepseek-moe-16b")  # at smoke_config
LM_SOLO_REQUESTS = 8  # batched vs solo, qwen1.5-0.5b full width f32
LM_RUNS = 2  # measured runs of the same requests per model
# tests/test_torch_lm.py's bound for paths through the bf16 KV cache: max
# |Δ| of logits within 4e-3 of the largest |logit|
LM_LOGITS_TOL = 4e-3


def lm_prompt_lengths(rng, n: int) -> list:
    """n prompt lengths over 3..200: one in each bucket's range (b/2, b],
    then uniform, shuffled — every bucket 16..256 occurs."""
    out = [int(rng.integers(max(3, b // 2 + 1), min(b, 200) + 1)) for b in LM_BUCKETS]
    out += [int(rng.integers(3, 201)) for _ in range(n - len(out))]
    rng.shuffle(out)
    return out


def lm_requests(rng, cfg, lengths, max_new: int) -> list:
    from repro_torch.serve import Request

    return [Request(rid=r, prompt=[int(t) for t in rng.integers(1, cfg.vocab_size, n)],
                    max_new_tokens=max_new) for r, n in enumerate(lengths)]


def lm_logits_recorder(core) -> dict:
    """Wrap an ``LMEngineCore`` so each request's logits (its prefill's, then
    one row per decode step it took part in) land on the host, by rid."""
    rec, cur = {}, {}
    admit, step, decode, prefill_fn = core.admit, core.step, core._decode, core._prefill_fn

    def pre(length):
        fn = prefill_fn(length)

        def call(*a, **k):
            out = fn(*a, **k)
            rec.setdefault(cur["rid"], []).append(out[0][0].float().cpu())
            return out

        return call

    def adm(req, i):
        cur["rid"] = req.rid
        admit(req, i)

    def dec(*a):
        out = decode(*a)
        cur["logits"] = out[0]
        return out

    def stp(active):
        finished = step(active)
        lg = cur["logits"].float().cpu()
        for i, req in active.items():
            rec[req.rid].append(lg[i])
        return finished

    core.admit, core._prefill_fn, core.step, core._decode = adm, pre, stp, dec
    return rec


def lm_compare(got: dict, want: dict, got_out: dict, want_out: dict,
               tol: float = LM_LOGITS_TOL) -> dict:
    """Two runs' logits and tokens, request by request. Tokens are compared
    up to the first step whose top-2 margin (in the reference run) is below
    the tolerance, logits up to and including it; that step is reported."""
    worst, low_margin = 0.0, {}
    for rid, rows in want.items():
        scale = max(float(r.abs().max()) for r in rows)
        bound = tol * scale
        for k, (a, b) in enumerate(zip(got[rid], rows)):
            err = float((a - b).abs().max())
            worst = max(worst, err / scale)
            if err > bound:
                raise AssertionError(f"request {rid} step {k}: max |Δ logits| {err} > {bound}")
            top2 = torch.topk(b, 2).values
            if float(top2[0] - top2[1]) < bound:
                low_margin[rid] = k
                break
            if got_out[rid][k] != want_out[rid][k]:
                raise AssertionError(f"request {rid} step {k}: token {got_out[rid][k]} != "
                                     f"{want_out[rid][k]} at a margin above the tolerance")
        else:
            if got_out[rid] != want_out[rid]:
                raise AssertionError(f"request {rid}: tokens differ")
    return {"max_rel_err": worst, "tol": tol,
            "first_low_margin_step": low_margin or None,
            "tokens_equal": all(got_out[r] == want_out[r] for r in want_out)}


def lm_serve_run(dev, arch: str, n_requests: int, tag) -> dict:
    """One full-width bf16 model served by ``Engine``: tokens/s over the run,
    prefill device ms per bucket (per prompt length where prefill is
    exact-length, the recurrent families) and decode-step device/host ms by
    CUDA events, the busy share of a steady 8-slot decode step
    (``torch.profiler`` kernel time over the step's wall time), peak memory
    while serving (and while drawing the weights), the bytes of the params
    and of the cache or state; for an MoE the capacity overflow of its
    largest prefill bucket."""
    import copy

    from repro_torch.benchmarks import serve_bench
    from repro_torch.configs import get_config
    from repro_torch.models import moe, zoo
    from repro_torch.serve import Engine

    cfg = get_config(arch)
    api = zoo.get_api(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(SEED + 20)
    eng = Engine(cfg, params, n_slots=LM_SLOTS, max_seq=LM_MAX_SEQ)
    core = eng.core
    # warm-up: one request per bucket, 2 tokens each (first-call library set-up)
    for r in lm_requests(rng, cfg, [b for b in LM_BUCKETS], 2):
        eng.submit(r)
    eng.run()
    eng.finished.clear()
    lengths = lm_prompt_lengths(rng, n_requests)
    reqs = lm_requests(rng, cfg, lengths, LM_NEW)

    prefill_ev, decode_ev, step_rows = [], [], []
    prefill_fn, decode, step = core._prefill_fn, core._decode, core.step

    def timed_prefill(length):
        fn = prefill_fn(length)

        def call(*a, **k):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **k)
            e1.record()
            prefill_ev.append((length, e0, e1))
            return out

        return call

    def timed_decode(*a):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = decode(*a)
        e1.record()
        decode_ev.append((e0, e1))
        return out

    def timed_step(active):
        t = time.perf_counter()
        finished = step(active)  # ends in a .tolist(): synchronised
        step_rows.append((len(active), (time.perf_counter() - t) * 1e3))
        return finished

    dispatched, admitting = [], {}
    real_dispatch, admit = moe.dispatch_group, core.admit

    def recording_dispatch(ids, n_tokens, cfg_):
        out = real_dispatch(ids, n_tokens, cfg_)
        dispatched.append((n_tokens, out[1], out[2], admitting.get("plen")))
        return out

    def recording_admit(req, i):  # marks the prefill's prompt rows
        admitting["plen"] = len(req.prompt)
        try:
            admit(req, i)
        finally:
            admitting.clear()

    runs = []  # the same requests served LM_RUNS times: the spread
    core._prefill_fn, core._decode, core.step = timed_prefill, timed_decode, timed_step
    core.admit = recording_admit
    moe.dispatch_group = recording_dispatch
    try:
        for _ in range(LM_RUNS):
            step_rows.clear()
            decode_ev.clear()
            dispatched.clear()
            eng.finished.clear()
            for r in copy.deepcopy(reqs):
                if not eng.submit(r):
                    raise AssertionError(f"request {r.rid} refused")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            done = eng.run()
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            if done.status != "drained" or len(done) != n_requests:
                raise AssertionError(f"{arch}: served {len(done)} of {n_requests}: "
                                     f"{done.status}")
            for r in done:
                if len(r.out) != LM_NEW or not all(0 <= t < cfg.vocab_size for t in r.out):
                    raise AssertionError(f"{arch}: request {r.rid} gave {len(r.out)} tokens")
            tokens = sum(len(r.out) for r in done)
            full = [ms for (n, ms) in step_rows if n == LM_SLOTS]
            full_dev = [e0.elapsed_time(e1) for (e0, e1), (n, _) in zip(decode_ev, step_rows)
                        if n == LM_SLOTS]
            runs.append({"run_s": run_s, "tokens": tokens, "tokens_per_s": tokens / run_s,
                         "decode_steps": len(step_rows), "decode_steps_8_active": len(full),
                         "decode_step_host_ms_p50_8_active": statistics.median(full),
                         "decode_step_device_ms_p50_8_active": statistics.median(full_dev)})
    finally:
        core._prefill_fn, core._decode, core.step, core.admit = prefill_fn, decode, step, admit
        moe.dispatch_group = real_dispatch
    peak = torch.cuda.max_memory_allocated()
    per_bucket = {}
    for length, e0, e1 in prefill_ev:
        per_bucket.setdefault(length, []).append(e0.elapsed_time(e1))
    if core._bucketed and sorted(per_bucket) != list(LM_BUCKETS):
        raise AssertionError(f"{arch}: prefill buckets {sorted(per_bucket)}")
    if not core._bucketed and sorted(per_bucket) != sorted(set(lengths)):
        raise AssertionError(f"{arch}: exact-length prefill entries {sorted(per_bucket)}")

    # one steady 8-slot decode step: its wall ms (synchronised) and its
    # kernels by torch.profiler. (A step issues hundreds of launches, which
    # need not fit the launch queue behind a spin kernel as device_ms
    # needs: the profiler's kernel times are its busy time.)
    toks = torch.tensor([r.out[-1] for r in done[:LM_SLOTS]], device=dev)
    pos = torch.full((LM_SLOTS,), LM_MAX_SEQ // 2, dtype=torch.int64, device=dev)

    def one_step():
        logits, _ = api.decode_fn(params, core.cache, toks, pos)
        return torch.argmax(logits, dim=-1)

    walls = []
    for _ in range(10):
        torch.cuda.synchronize()
        t = time.perf_counter()
        one_step().tolist()
        walls.append((time.perf_counter() - t) * 1e3)
    wall_ms = statistics.median(walls)
    by_kernel = serve_bench.kernel_breakdown(one_step, dev)
    out = {"arch": arch, "dtype": cfg.dtype, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "n_params": cfg.n_params(), "init_s": init_s, "requests": n_requests,
           "slots": LM_SLOTS, "max_seq": LM_MAX_SEQ, "new_tokens": LM_NEW,
           "prompt_lengths": lengths, **runs[0], "runs": runs,
           "prefill_device_ms_by_bucket": {str(b): v for b, v in sorted(per_bucket.items())},
           "prefill_device_ms_median_by_bucket": {str(b): statistics.median(v)
                                                  for b, v in sorted(per_bucket.items())},
           "decode_step_wall_ms": wall_ms,
           "decode_step_kernel_ms": None if by_kernel is None else by_kernel["total_ms"],
           "decode_step_kernel_launches": None if by_kernel is None
           else by_kernel["kernel_launches"],
           "decode_step_busy_share": None if by_kernel is None
           else by_kernel["total_ms"] / wall_ms,
           "decode_step_top_kernels": None if by_kernel is None else by_kernel["kernels"][:8],
           "init_peak_memory_gib": init_peak / 2**30, "peak_memory_gib": peak / 2**30,
           "param_bytes": tree_bytes(params), "cache_bytes": tree_bytes(core.cache),
           "bucketed_prefill": core._bucketed,
           "prefill_entries_kept": len(core._prefill_cache)}
    if cfg.family == "moe":
        # each prefill of the largest bucket, layer by layer: the entries
        # dropped at capacity, from the prompt's rows and from the pad rows
        largest = max(n for n, _, _, plen in dispatched if plen is not None)
        rows = [(es, c, plen) for n, es, c, plen in dispatched
                if n == largest and plen is not None]
        out["largest_prefill_bucket"] = {
            "tokens": largest, "capacity": rows[0][1], "entries_per_layer": largest * cfg.top_k,
            "prompt_lengths": sorted({plen for _, _, plen in rows}),
            "overflow_prompt_rows_per_layer": [int((es[:plen] < 0).sum()) for es, _, plen in rows],
            "overflow_pad_rows_per_layer": [int((es[plen:] < 0).sum()) for es, _, plen in rows],
            "overflow_total": sum(int((es < 0).sum()) for es, _, _ in rows)}
    print(json.dumps({"phase": "lm_serve", **out, **tag}), flush=True)
    del eng, core, params
    return out


def tree_bytes(tree) -> int:
    from repro_torch import tree as tu

    return sum(x.numel() * x.element_size() for x in tu.leaves(tree))


def lm_engine_run(cfg, params, reqs, *, n_slots: int, max_seq: int):
    from repro_torch.serve import Engine

    eng = Engine(cfg, params, n_slots=n_slots, max_seq=max_seq)
    rec = lm_logits_recorder(eng.core)
    for r in reqs:
        eng.submit(r)
    done = eng.run()
    if done.status != "drained" or len(done) != len(reqs):
        raise AssertionError(f"served {len(done)} of {len(reqs)}: {done.status}")
    return rec, {r.rid: r.out for r in done}


def phase_lm(dev, tag) -> dict:
    """(l) LM token serving on the card: qwen1.5-0.5b and olmoe-1b-7b at
    full width in bf16 through ``Engine``; the card against the port's CPU
    run at the smoke configs; a request served among 8 slots against the
    same request served alone (qwen1.5-0.5b full width, f32); the serve
    CLI. No hand-written kernel runs on this path: the launch counts are set
    to 0 before the phase and must read 0 after it."""
    import copy

    from repro_torch import backend
    from repro_torch import tree as tu
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import snn_yolo as sy
    from repro_torch.models import zoo

    backend.reset_launches()
    out = {"serve": {}}
    for arch, n in LM_SERVE:
        out["serve"][arch] = lm_serve_run(dev, arch, n, tag)
    torch.cuda.empty_cache()

    # the card against the CPU at smoke_config, f32, TF32 off
    out["card_vs_cpu"] = {}
    with sy._no_tf32():
        for arch in LM_PARITY:
            cfg = smoke_config(get_config(arch))
            cpu_params = zoo.get_api(cfg).init_params(SEED, device="cpu")
            card_params = tu.tree_map(lambda x: x.to(dev), cpu_params)
            rng = np.random.default_rng(SEED + 21)
            reqs = lm_requests(rng, cfg, [int(rng.integers(3, 41)) for _ in range(7)], 8)
            runs = [lm_engine_run(cfg, p, copy.deepcopy(reqs), n_slots=4, max_seq=96)
                    for p in (cpu_params, card_params)]
            row = {"arch": arch, "requests": len(reqs), "slots": 4,
                   **lm_compare(runs[1][0], runs[0][0], runs[1][1], runs[0][1])}
            out["card_vs_cpu"][arch] = row
            print(json.dumps({"phase": "lm_card_vs_cpu", **row, **tag}), flush=True)

        # batched (8 slots) against solo, full width f32
        cfg = dataclasses.replace(get_config("qwen1.5-0.5b"), dtype="float32")
        params = zoo.get_api(cfg).init_params(SEED, device=dev)
        rng = np.random.default_rng(SEED + 22)
        reqs = lm_requests(rng, cfg, lm_prompt_lengths(rng, LM_SOLO_REQUESTS), LM_NEW)
        batched = lm_engine_run(cfg, params, copy.deepcopy(reqs), n_slots=LM_SLOTS,
                                max_seq=LM_MAX_SEQ)
        solo_rec, solo_out = {}, {}
        for r in reqs:
            rec, o = lm_engine_run(cfg, params, [copy.deepcopy(r)], n_slots=1,
                                   max_seq=LM_MAX_SEQ)
            solo_rec.update(rec)
            solo_out.update(o)
        row = {"arch": cfg.arch_id, "dtype": cfg.dtype, "requests": len(reqs),
               "slots": LM_SLOTS, "steps_per_request": LM_NEW,
               **lm_compare(batched[0], solo_rec, batched[1], solo_out)}
        out["batched_vs_solo"] = row
        print(json.dumps({"phase": "lm_batched_vs_solo", **row, **tag}), flush=True)
        del params
    torch.cuda.synchronize()
    launches = sum(backend.launches.values())
    print(json.dumps({"phase": "lm_kernel_launches", "hand_written_kernel_launches": launches,
                      "by_kernel": dict(backend.launches), **tag}), flush=True)
    if launches:
        raise AssertionError(f"LM serving launched hand-written kernels: {dict(backend.launches)}")
    out["kernel_launches"] = launches

    # the CLI: qwen1.5-0.5b at its smoke config, and a family the Engine refuses
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    env = {**os.environ, "PYTHONPATH": src}
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                          "qwen1.5-0.5b", "--requests", "8"], env=env, capture_output=True,
                         text=True, timeout=600)
    line = next((ln for ln in cli.stdout.splitlines() if "tok/s" in ln), None)
    if cli.returncode != 0 or line is None:
        raise AssertionError(f"the serve CLI exited {cli.returncode}: {cli.stderr[-2000:]}")
    refused = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                              "whisper-small"], env=env, capture_output=True, text=True,
                             timeout=600)
    if refused.returncode == 0 or "ROADMAP.md R10" not in refused.stderr:
        raise AssertionError(f"--arch whisper-small exited {refused.returncode}: "
                             f"{refused.stderr[-2000:]}")
    out["cli"] = {"line": line, "seconds": time.perf_counter() - t0,
                  "whisper_rc": refused.returncode,
                  "whisper_error": refused.stderr.strip().splitlines()[-1]}
    print(json.dumps({"phase": "lm_cli", **out["cli"], **tag}), flush=True)
    return out


# ------------------------------------------------------------ m. LM training

# card vs CPU at smoke_config: (n_microbatch, grad_compress, int8_moments)
LM_TRAIN_PARITY = ((1, False, False), (2, False, False), (1, True, True))
LM_TRAIN_PARITY_BATCH, LM_TRAIN_PARITY_SEQ = 8, 32
# tests/test_torch_lm_train.py's bounds: loss and gradient norm relative,
# gradients × the leaf's largest |g|, parameters × the leaf's largest |p| where
# the applied |ĝ| ≥ 100·eps (R6; 1e4·eps for a leaf that starts at 0, R8),
# within 2·lr elsewhere
LM_TRAIN_TOL = {"loss_rtol": 1e-5, "grad_norm_rtol": 1e-5, "grad_tol": 1e-5,
                "state_rtol": 1e-6}
# the archs of phase m: card vs CPU at smoke_config, then full width through
# launch.train.main; the train_4k global batch of 256 cut to these, olmoe's
# sequence cut from 4096 to 2048; the moments are the dry-run's
# TRAIN_PRESETS' (int8 for olmoe-1b-7b and zamba2-7b)
LM_TRAIN = (
    ("qwen1.5-0.5b", ["--seq", "4096", "--batch", "8", "--microbatch", "4", "--steps", "6"],
     "train_4k global batch 256 -> 8 (2 per microbatch), 6 steps"),
    ("olmoe-1b-7b", ["--seq", "2048", "--batch", "4", "--microbatch", "2", "--steps", "6",
                     "--int8-moments"],
     "train_4k global batch 256 -> 4 (2 per microbatch), seq 4096 -> 2048, 6 steps"),
    ("rwkv6-3b", ["--seq", "4096", "--batch", "4", "--microbatch", "2", "--steps", "6"],
     "train_4k global batch 256 -> 4 (2 per microbatch), 6 steps"),
    # two sequences a microbatch run out of the card's memory (PERF.md §6)
    ("zamba2-7b", ["--seq", "4096", "--batch", "2", "--microbatch", "2", "--steps", "6",
                   "--int8-moments"],
     "train_4k global batch 256 -> 2 (1 per microbatch: 2 do not fit), 6 steps"),
)
LM_TRAIN_PROFILE_STEP = 2  # the step traced by torch.profiler (not in the event times)
# the --ckpt run: qwen1.5-0.5b at full width, one invocation of LM_CKPT_STEPS[0]
# steps, then a second to LM_CKPT_STEPS[1] that resumes from its checkpoint
LM_CKPT_FLAGS = ["--seq", "1024", "--batch", "8", "--microbatch", "2"]
LM_CKPT_STEPS = (6, 12)


def lm_train_step_both(dev, arch: str, n_mb: int, compress: bool, int8: bool) -> dict:
    """One ``make_train_step`` step at ``smoke_config`` on the CPU and on
    the card from the same seeded parameters and ``batch_at`` batch (with
    frames or patches for the audio and vlm families; f32, TF32 off), held
    to the CPU tests' bounds."""
    from repro_torch import tree as tu
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import zoo
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainer

    cfg = smoke_config(get_config(arch))
    api = zoo.get_api(cfg)
    ocfg = opt.AdamWConfig(warmup_steps=2, total_steps=20, int8_moments=int8)
    params0 = api.init_params(SEED, device="cpu")
    out = {}
    for name, d in (("cpu", torch.device("cpu")), ("card", dev)):
        p = tu.tree_map(lambda x: x.to(d, copy=True), params0)
        batch = modal_batch(cfg, 0, LM_TRAIN_PARITY_BATCH, LM_TRAIN_PARITY_SEQ, d)
        _, grads = trainer.loss_and_grads(api.loss_fn, p, batch, n_microbatch=n_mb)
        state = trainer.init_train_state(p, ocfg, grad_compress=compress)
        new, m = trainer.make_train_step(api.loss_fn, ocfg, n_microbatch=n_mb,
                                         grad_compress=compress)(state, batch)
        out[name] = {"grads": tu.tree_map(lambda x: x.cpu(), grads),
                     "params": tu.tree_map(lambda x: x.cpu(), new.params),
                     "m": {k: v.cpu() for k, v in m.items()}}
    cpu, crd = out["cpu"], out["card"]

    def rel(k):
        return abs(float(crd["m"][k]) - float(cpu["m"][k])) / abs(float(cpu["m"][k]))

    grad_err = max(float((a - c).abs().max() / a.abs().max().clamp_min(1e-30))
                   for a, c in zip(tu.leaves(cpu["grads"]), tu.leaves(crd["grads"])))
    applied = cpu["grads"]
    if compress:
        applied = tu.tree_map(lambda g: opt.compress_decompress(g, torch.zeros_like(g))[0],
                              applied)
    clip = min(1.0, ocfg.grad_clip / max(float(cpu["m"]["grad_norm"]), 1e-12))
    lr = float(cpu["m"]["lr"])
    eps = max(ocfg.eps, 1e-5) if int8 else ocfg.eps
    worst, off = 0.0, []
    paths, want_leaves = tu.flatten_with_paths(cpu["params"])
    for path, want, got, g, p0 in zip(paths, want_leaves, tu.leaves(crd["params"]),
                                      tu.leaves(applied), tu.leaves(params0)):
        factor = 1e4 if not bool(p0.any()) else 100
        well = g.abs() * clip >= factor * eps
        scale = float(want.abs().max())
        err = (got.double() - want.double()).abs()
        tol = torch.where(well, LM_TRAIN_TOL["state_rtol"] * scale,
                          2 * lr + LM_TRAIN_TOL["state_rtol"] * scale)
        if bool((err > tol).any()):
            off.append(f"{path}: {int((err > tol).sum())} elements, worst {float(err.max()):.3e}")
        if bool(well.any()):
            worst = max(worst, float(err[well].max()) / scale)
    row = {"arch": arch, "n_microbatch": n_mb, "grad_compress": compress, "int8_moments": int8,
           "loss_rel_err": rel("loss"), "grad_norm_rel_err": rel("grad_norm"),
           "grads_worst_rel": grad_err, "params_worst_rel_well_conditioned": worst,
           "lr_equal": float(crd["m"]["lr"]) == lr,
           "step_equal": int(crd["m"]["step"]) == int(cpu["m"]["step"]) == 1,
           "params_off": off, **LM_TRAIN_TOL}
    if (row["loss_rel_err"] > LM_TRAIN_TOL["loss_rtol"]
            or row["grad_norm_rel_err"] > LM_TRAIN_TOL["grad_norm_rtol"]
            or grad_err > LM_TRAIN_TOL["grad_tol"] or off or not row["lr_equal"]
            or not row["step_equal"]):
        raise AssertionError(f"LM train step, card vs CPU, outside the bounds: {row}")
    return row


def lm_state_bytes(state, n_mb: int) -> dict:
    """Bytes of each part of a train state, and of the gradients a step
    holds (f32 accumulators over microbatches, else the parameters' dtype)."""
    from repro_torch import tree as tu

    size = lambda t: t.numel() * t.element_size()  # noqa: E731
    params = tu.leaves(state.params)
    return {"params": sum(map(size, params)),
            "moments": sum(map(size, tu.leaves(state.opt.m) + tu.leaves(state.opt.v))),
            "grads": sum(p.numel() * (4 if n_mb > 1 else p.element_size()) for p in params)}


def lm_train_run(dev, arch: str, argv: list, cuts: str, tag) -> dict:
    """``launch.train.main`` at full width on the card: each step's device
    ms by CUDA events (the median after the first step), one step traced by
    ``torch.profiler`` (kernel time over that step's median time: the busy
    share; its launches), tokens/s, peak memory and the state's bytes by
    part beside the dry-run's static bytes of the arch's train_4k cell
    (parameters and optimizer state); what the peak holds beyond the
    earlier phases' tensors, the state and the gradients is the step's
    activations and temporaries. For the MoE, the entries dropped at
    capacity in the first layer's dispatch of each step."""
    from repro_torch.benchmarks import serve_bench
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as launch_train
    from repro_torch.models import moe
    from repro_torch.train import trainer

    events, dropped, prof = [], [], {}
    real_make, real_dispatch = trainer.make_train_step, moe.dispatch_group

    def make(*a, **k):
        step = real_make(*a, **k)

        def timed(state, batch):
            prof["first_dispatch"] = True
            if len(events) == LM_TRAIN_PROFILE_STEP and "trace" not in prof:
                out = []
                torch.cuda.synchronize()
                t = time.perf_counter()
                prof["trace"] = serve_bench.kernel_breakdown(
                    lambda: out.append(step(state, batch)), dev)
                prof["wall_ms"] = (time.perf_counter() - t) * 1e3
                return out[0]
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = step(state, batch)
            e1.record()
            events.append((e0, e1))
            return out

        return timed

    def dispatch(ids, n_tokens, cfg_):
        out = real_dispatch(ids, n_tokens, cfg_)
        if prof.get("first_dispatch"):
            prof["first_dispatch"] = False
            dropped.append(((out[1] < 0).sum(), n_tokens * cfg_.top_k, out[2]))
        return out

    n_mb = int(argv[argv.index("--microbatch") + 1])
    gc.collect()  # earlier phases' unreachable tensors, so the peak is this run's
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()  # what earlier phases still hold
    trainer.make_train_step, moe.dispatch_group = make, dispatch
    try:
        res = launch_train.main(["--arch", arch, "--full-config", *argv])
    except torch.cuda.OutOfMemoryError as e:
        print(json.dumps({"phase": "lm_train_out_of_memory", "arch": arch,
                          "peak_bytes": torch.cuda.max_memory_allocated(),
                          "allocated_bytes": torch.cuda.memory_allocated(),
                          "error": str(e)[:2000], **tag}), flush=True)
        raise AssertionError(f"{arch} at full width does not fit: {e}") from e
    finally:
        trainer.make_train_step, moe.dispatch_group = real_make, real_dispatch
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    step_ms = [e0.elapsed_time(e1) for e0, e1 in events]
    median = statistics.median(step_ms[1:])
    seq = int(argv[argv.index("--seq") + 1])
    batch = int(argv[argv.index("--batch") + 1])
    trace = prof.get("trace")
    losses = res["losses"]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{arch}: non-finite loss {losses}")
    state_bytes = lm_state_bytes(res["state"], n_mb)
    static = dryrun.static_bytes(get_config(arch), SHAPES["train_4k"], dryrun.MESHES["h100"])
    beyond = peak - before - sum(state_bytes.values())
    out = {"arch": arch, "argv": argv, "cuts": cuts, "steps": len(losses),
           "loss_first": losses[0], "loss_last": losses[-1], "losses": losses,
           "step_ms_median": median, "step_ms": step_ms,
           "tokens_per_s_median_step": batch * seq / median * 1e3,
           "tokens_per_s_launcher": res["tok_per_s"],
           "profiled_step_wall_ms": prof.get("wall_ms"),
           "step_kernel_ms": None if trace is None else trace["total_ms"],
           "step_launches": None if trace is None else trace["kernel_launches"],
           "step_busy_share": None if trace is None else trace["total_ms"] / median,
           "step_top_kernels": None if trace is None else trace["kernels"][:8],
           "peak_memory_gib": peak / 2**30, "allocated_before_gib": before / 2**30,
           "state_bytes": state_bytes, "dryrun_static_bytes": static,
           "activations_gib": beyond / 2**30,
           "activation_share_of_peak": beyond / max(peak - before, 1)}
    if dropped:
        out["dropped_layer0_per_step"] = [int(n) for n, _, _ in dropped]
        out["entries_layer0"], out["capacity"] = dropped[0][1], dropped[0][2]
    print(json.dumps({"phase": "lm_train", **out, **tag}), flush=True)
    del res
    return out


def lm_train_resume(dev, tag) -> dict:
    """A ``--ckpt`` run of qwen1.5-0.5b at full width, then a second
    invocation on the same directory: the state it restores is bit-equal to
    the first run's final state, and its steps continue the count."""
    import tempfile

    from repro_torch import tree as tu
    from repro_torch.launch import train as launch_train
    from repro_torch.train import checkpoint as ckpt

    root = tempfile.mkdtemp(prefix="chip_smoke_lm_ckpt_")
    args = ["--arch", "qwen1.5-0.5b", "--full-config", *LM_CKPT_FLAGS, "--ckpt", root]
    n1, n2 = LM_CKPT_STEPS
    seen = {}
    real = ckpt.restore
    try:
        first = launch_train.main(args + ["--steps", str(n1)])

        def recording(*a, **k):
            state, step = real(*a, **k)
            seen["step"] = step
            seen["bit_equal"] = all(x.dtype == y.dtype and torch.equal(x, y) for x, y in
                                    zip(tu.leaves(first["state"]), tu.leaves(state)))
            return state, step

        ckpt.restore = recording
        second = launch_train.main(args + ["--steps", str(n2)])
    finally:
        ckpt.restore = real
        shutil.rmtree(root, ignore_errors=True)
    row = {"arch": "qwen1.5-0.5b", "argv": LM_CKPT_FLAGS, "first_steps": first["steps_run"],
           "restored_step": seen.get("step"), "restored_bit_equal": seen.get("bit_equal"),
           "second_steps": second["steps_run"], "opt_step_after": int(second["state"].opt.step),
           "losses_first": first["losses"], "losses_second": second["losses"],
           "seconds": [first["seconds"], second["seconds"]]}
    print(json.dumps({"phase": "lm_train_resume", **row, **tag}), flush=True)
    if not (row["restored_bit_equal"] and row["restored_step"] == n1 - 1
            and row["second_steps"] == list(range(n1, n2)) and row["opt_step_after"] == n2):
        raise AssertionError(f"the --ckpt run did not resume bit-equal: {row}")
    return row


def phase_lm_train(dev, tag) -> dict:
    """(m) LM training on the card: one train step of qwen1.5-0.5b,
    olmoe-1b-7b, rwkv6-3b and zamba2-7b at their smoke configs on the card
    against the CPU; each at full width through ``launch.train.main`` (bf16,
    remat); a ``--ckpt`` run resumed bit-equal. No hand-written kernel runs
    on this path: the launch counts, set to 0 before the phase, must read 0
    after it."""
    from repro_torch import backend
    from repro_torch.models import snn_yolo as sy

    backend.reset_launches()
    out = {"card_vs_cpu": []}
    with sy._no_tf32():
        for arch, _, _ in LM_TRAIN:
            for n_mb, compress, int8 in LM_TRAIN_PARITY:
                row = lm_train_step_both(dev, arch, n_mb, compress, int8)
                out["card_vs_cpu"].append(row)
                print(json.dumps({"phase": "lm_train_card_vs_cpu", **row, **tag}), flush=True)
    out["train"] = {arch: lm_train_run(dev, arch, argv, cuts, tag)
                    for arch, argv, cuts in LM_TRAIN}
    torch.cuda.empty_cache()
    out["resume"] = lm_train_resume(dev, tag)
    torch.cuda.synchronize()
    launches = sum(backend.launches.values())
    print(json.dumps({"phase": "lm_train_kernel_launches",
                      "hand_written_kernel_launches": launches,
                      "by_kernel": dict(backend.launches), **tag}), flush=True)
    if launches:
        raise AssertionError(f"LM training launched hand-written kernels: "
                             f"{dict(backend.launches)}")
    out["kernel_launches"] = launches
    return out


# ------------------------------------------------- n. multi-process execution

# phase n: two processes sharing the card (gloo: one card, so not NCCL)
SHARD_IMAGES, SHARD_SHARDS, SHARD_BATCH = 16, 4, 4  # 2 shards of 4 images per process
DP_SMOKE = ["--arch", "qwen1.5-0.5b", "--steps", "11", "--batch", "8", "--seq", "16"]
DP_FULL = ["--arch", "qwen1.5-0.5b", "--full-config", "--seq", "1024", "--batch", "8"]
DP_FULL_STEPS = 6
DP_CKPT_STEPS = (4, 8)  # two processes save at step 3; one process resumes to step 8
CHILD_TIMEOUT_S = 420

# one process of the sharded evaluation (n1): restore the checkpoint on this
# process's card, the kernel executor, evaluate its own shards twice (the
# second run timed), then the uneven shard count
_EVAL_CHILD = r"""
import json, sys, time
import torch
from repro_torch import backend
from repro_torch.distributed import runtime
from repro_torch.eval import harness
from repro_torch.eval import sharded as se
a = json.loads(sys.argv[1])
ctx = runtime.initialize(coordinator_address=a["addr"], num_processes=a["n"],
                         process_id=a["pid"])
libs = backend.load_kernels()
rebuilt = [name for name in libs if backend.build_log(name)]
cfg, p, b, _ = harness.restore_detector_checkpoint(a["ckpt"], device=ctx.device)
det = harness.compile_eval_detector(cfg, p, b, device=ctx.device)
n_detect, gather_ms = [0], []
real_detect, real_gather = det.detect, se._gather_process
def detect(x):
    n_detect[0] += 1
    return real_detect(x)
def gather(local, c):
    t = time.perf_counter()
    out = real_gather(local, c)
    gather_ms.append((time.perf_counter() - t) * 1e3)
    return out
det.detect, se._gather_process = detect, gather
sharded = se.ShardedEvalConfig(n_shards=a["shards"], batch=a["batch"])
walls = []
for run in range(2):
    if run == 1:
        backend.reset_launches()
        n_detect[0] = 0
        torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    rep = harness.evaluate_detector(det, n_images=a["images"], sharded=sharded, ctx=ctx)
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t)
launches = dict(backend.launches)
try:
    harness.evaluate_detector(det, n_images=a["images"], ctx=ctx,
                              sharded=se.ShardedEvalConfig(n_shards=3, batch=a["batch"]))
    refused = "no error"
except ValueError as e:
    refused = str(e)
print("CHILD=" + json.dumps({
    "host": ctx.host_id, "describe": ctx.describe(), "backend": ctx.backend,
    "device": str(ctx.device), "report": rep, "launches": launches, "detects": n_detect[0],
    "owned_shards": ctx.owned_shards(a["shards"]), "wall_s": walls,
    "images": a["images"] // a["n"], "images_per_s": a["images"] / a["n"] / walls[1],
    "gather_ms": gather_ms[-1], "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
    "rebuilt": rebuilt, "uneven_refused": refused}), flush=True)
runtime.shutdown()
"""

# one process of an LM training run (n3, n4): launch.train.main with its
# steps timed by CUDA events, each all-reduce and striped save timed on the
# host clock (gloo stages through the host, so both end synchronised), and
# the final (or the restored) state's per-leaf checksums
_TRAIN_CHILD = r"""
import hashlib, json, sys, time
import torch
from repro_torch import tree as tu
from repro_torch.distributed import collectives
from repro_torch.launch import train as launch_train
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import trainer
a = json.loads(sys.argv[1])

def checksums(state):
    out = {}
    for path, t in zip(*tu.flatten_with_paths(state)):
        t = t.detach().cpu().contiguous().reshape(-1)
        raw = t.view(torch.uint8) if t.numel() else t
        out[path] = hashlib.sha256(str(t.dtype).encode() + raw.numpy().tobytes()).hexdigest()
    return out

events, allreduce, saves, restored = [], [], [], {}
real_make, real_ar = trainer.make_train_step, collectives.allreduce_mean_
real_save, real_restore = ckpt.save, ckpt.restore
def make(*args, **kw):
    step = real_make(*args, **kw)
    def timed(state, batch):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = step(state, batch)
        e1.record()
        events.append((e0, e1))
        return out
    return timed
def timed_ar(tensors, ctx):
    torch.cuda.synchronize()
    t = time.perf_counter()
    sent = real_ar(tensors, ctx)
    torch.cuda.synchronize()
    allreduce.append({"ms": (time.perf_counter() - t) * 1e3, "bytes": sent})
    return sent
def timed_save(*args, **kw):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = real_save(*args, **kw)
    saves.append((time.perf_counter() - t) * 1e3)
    return out
def recording_restore(*args, **kw):
    state, step = real_restore(*args, **kw)
    restored["step"], restored["checksums"] = step, checksums(state)
    return state, step
trainer.make_train_step, collectives.allreduce_mean_ = make, timed_ar
ckpt.save, ckpt.restore = timed_save, recording_restore
torch.cuda.reset_peak_memory_stats()
res = launch_train.main(a["argv"])
torch.cuda.synchronize()
print("CHILD=" + json.dumps({
    "losses": res["losses"], "steps_run": res["steps_run"], "seconds": res["seconds"],
    "tok_per_s": res["tok_per_s"], "step_ms": [e0.elapsed_time(e1) for e0, e1 in events],
    "allreduce": allreduce, "save_ms": saves, "restored": restored,
    "checksums": checksums(res["state"]),
    "peak_gib": torch.cuda.max_memory_allocated() / 2**30}), flush=True)
"""


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_children(argvs: list, *, cwd=None) -> list:
    """Start one ``python`` per argv at once, wait for all (each within
    ``CHILD_TIMEOUT_S``), kill any left running, and return their parsed
    ``CHILD=`` lines; raises if any exited non-zero."""
    env = {**os.environ, "PYTHONPATH": os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                    "src")}
    procs = [subprocess.Popen([sys.executable, *argv], env=env, cwd=cwd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for argv in argvs]
    outs, failed = [], []
    try:
        for i, p in enumerate(procs):
            out, err = p.communicate(timeout=CHILD_TIMEOUT_S)
            if p.returncode != 0:
                failed.append(f"child {i} exited {p.returncode}:\n{out[-2000:]}\n{err[-4000:]}")
            lines = [ln for ln in out.splitlines() if ln.startswith("CHILD=")]
            outs.append(json.loads(lines[-1][len("CHILD="):]) if lines else None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise AssertionError("\n".join(failed))
    return outs


def train_argvs(argv: list, n: int) -> list:
    """The ``python`` argvs of ``launch.train`` as ``n`` processes of one
    job (``n`` = 1: one process, no coordinator) through ``_TRAIN_CHILD``."""
    if n == 1:
        return [["-c", _TRAIN_CHILD, json.dumps({"argv": argv})]]
    addr = f"127.0.0.1:{free_port()}"
    return [["-c", _TRAIN_CHILD, json.dumps({"argv": argv + [
        "--coordinator", addr, "--num-processes", str(n), "--process-id", str(pid)]})]
        for pid in range(n)]


def train_children(argv: list, n: int) -> list:
    """:func:`train_argvs` run (:func:`run_children`)."""
    return run_children(train_argvs(argv, n))


def train_row(tag_: str, runs: list, n_procs: int) -> dict:
    """One run's numbers: per process the step ms (the first step apart),
    all-reduce ms and bytes, peak memory; the run's losses and tokens/s."""
    r0 = runs[0]
    row = {"run": tag_, "processes": n_procs, "losses": r0["losses"],
           "tok_per_s": r0["tok_per_s"], "seconds": r0["seconds"],
           "per_process": [{
               "step_ms": r["step_ms"],
               "step_ms_median_after_first": statistics.median(r["step_ms"][1:])
               if len(r["step_ms"]) > 1 else None,
               "allreduce_ms": [x["ms"] for x in r["allreduce"]],
               "allreduce_bytes": sorted({x["bytes"] for x in r["allreduce"]}),
               "save_ms": r["save_ms"], "peak_gib": r["peak_gib"]} for r in runs]}
    return row


def phase_multiprocess(dev, tag, fused_kernel: str) -> dict:
    """(n) Multi-process execution on the one card: the sharded detector
    evaluation at full width in two processes (the fused kernel in each),
    the CLIs' shard gates, data-parallel LM training in two processes
    against one, and a striped checkpoint resumed by one process."""
    import tempfile

    from repro_torch.configs.snn_det import CONFIG
    from repro_torch.eval import harness
    from repro_torch.eval import sharded as se
    from repro_torch.serve.detector import demo_weights

    root = tempfile.mkdtemp(prefix="chip_smoke_multiprocess_")
    out = {}
    try:
        # n1. the sharded evaluation at 576x1024, two processes on the card
        cfg = dataclasses.replace(CONFIG, conv_exec="pallas")
        params, bn, _ = demo_weights(cfg, prune_rate=0.8, seed=SEED, calib_batch=BATCH,
                                     device=dev)
        det_ckpt = os.path.join(root, "detector")
        harness.save_detector_checkpoint(det_ckpt, 0, params, bn, cfg)
        del params, bn
        _, rp, rb, _ = harness.restore_detector_checkpoint(det_ckpt, device=dev)
        single_det = harness.compile_eval_detector(cfg, rp, rb, device=dev)
        harness.evaluate_detector(single_det, n_images=SHARD_BATCH, batch=SHARD_BATCH)  # warm
        torch.cuda.synchronize()
        t = time.perf_counter()
        single = harness.evaluate_detector(single_det, n_images=SHARD_IMAGES, batch=SHARD_BATCH)
        torch.cuda.synchronize()
        single_s = time.perf_counter() - t
        del single_det, rp, rb
        torch.cuda.empty_cache()
        addr = f"127.0.0.1:{free_port()}"
        kids = run_children([["-c", _EVAL_CHILD, json.dumps({
            "addr": addr, "n": 2, "pid": pid, "ckpt": det_ckpt, "images": SHARD_IMAGES,
            "shards": SHARD_SHARDS, "batch": SHARD_BATCH})] for pid in range(2)])
        rows = []
        for k in kids:
            per_detect = k["launches"].get(fused_kernel, 0) / max(k["detects"], 1)
            row = {key: k[key] for key in ("host", "describe", "backend", "device", "launches",
                                           "detects", "owned_shards", "wall_s", "images",
                                           "images_per_s", "gather_ms", "peak_gib",
                                           "rebuilt", "uneven_refused")}
            row.update(identical_to_single=se.reports_identical(k["report"], single),
                       gather=k["report"]["gather"], map=k["report"]["map"],
                       fused_per_detect=per_detect)
            rows.append(row)
            print(json.dumps({"phase": "sharded_eval", **row, **tag}), flush=True)
            if not (row["identical_to_single"] and row["gather"] == "process"
                    and per_detect == 27 and "stripe evenly" in row["uneven_refused"]
                    and not row["rebuilt"] and k["report"]["n_images"] == SHARD_IMAGES):
                raise AssertionError(f"sharded evaluation process {k['host']}: {row}")
        out["sharded_eval"] = {
            "processes": rows, "single_process_s": single_s,
            "single_process_images_per_s": SHARD_IMAGES / single_s,
            "single_map": single["map"], "n_pred": single["n_pred"],
            "launches": {name: sum(k["launches"].get(name, 0) for k in kids)
                         for name in set().union(*(k["launches"] for k in kids))},
            "detects": sum(k["detects"] for k in kids)}
        print(json.dumps({"phase": "sharded_eval_single", "seconds": single_s,
                          "images": SHARD_IMAGES, "map": single["map"], **tag}), flush=True)

        # n2. the CLIs' shard gates, one process each, both at once (each one's
        # seconds run from the common start to when its output is read)
        env = {**os.environ, "PYTHONPATH": os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "src")}
        t0 = time.perf_counter()
        clis = [(name, subprocess.Popen([sys.executable, *argv], cwd=root, env=env, text=True,
                                        stdout=subprocess.PIPE, stderr=subprocess.PIPE))
                for name, argv in (
                    ("serve_eval_shards", ["-m", "repro_torch.launch.serve", "--arch", "snn-det",
                                           "--eval-map", "--eval-shards", "2", "--checkpoint",
                                           det_ckpt, "--requests", "8"]),
                    ("eval_map_shards", ["-m", "repro_torch.benchmarks.eval_map",
                                         "--checkpoint", det_ckpt, "--shards", "2",
                                         "--out-json", ""]))]
        try:
            for name, proc in clis:
                stdout, stderr = proc.communicate(timeout=CHILD_TIMEOUT_S)
                lines = [ln for ln in stdout.splitlines()
                         if "parity" in ln or "shards" in ln or "mAP" in ln]
                out[name] = {"rc": proc.returncode, "seconds": time.perf_counter() - t0,
                             "lines": lines}
                print(json.dumps({"phase": name, **out[name], **tag}), flush=True)
                if proc.returncode != 0 or not any("BIT-IDENTICAL" in ln for ln in lines):
                    raise AssertionError(f"{name} exited {proc.returncode} without its parity "
                                         f"line: {stdout[-3000:]}{stderr[-3000:]}")
        finally:
            for _, proc in clis:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()

        # n3. data-parallel LM training: the smoke trajectory (two processes and
        # one, all three at once), then full width
        runs = run_children(train_argvs(DP_SMOKE, 2) + train_argvs(DP_SMOKE, 1))
        smoke2, smoke1 = runs[:2], runs[2:]
        a, b = np.asarray(smoke2[0]["losses"]), np.asarray(smoke1[0]["losses"])
        smoke = {"losses_two": a.tolist(), "losses_one": b.tolist(),
                 "max_rel_diff": float(np.max(np.abs(a - b) / np.abs(b))),
                 "within_rtol_2e-4": bool(np.all(np.abs(a - b) <= 1e-5 + 2e-4 * np.abs(b)))}
        print(json.dumps({"phase": "dp_train_smoke", **smoke, **tag}), flush=True)
        if len(a) != len(b) or not smoke["within_rtol_2e-4"]:
            raise AssertionError(f"two-process smoke trajectory off the one-process one: {smoke}")
        steps = ["--steps", str(DP_FULL_STEPS)]
        two = train_row("two_processes", train_children(
            DP_FULL + steps + ["--microbatch", "1"], 2), 2)
        one = train_row("one_process", train_children(
            DP_FULL + steps + ["--microbatch", "2"], 1), 1)
        la, lb = np.asarray(two["losses"]), np.asarray(one["losses"])
        full = {"argv": DP_FULL + steps, "two": two, "one": one,
                "first_loss_rel_diff": float(abs(la[0] - lb[0]) / abs(lb[0])),
                "max_loss_rel_diff": float(np.max(np.abs(la - lb) / np.abs(lb)))}
        for row in (two, one):
            print(json.dumps({"phase": "dp_train", **row, **tag}), flush=True)
        print(json.dumps({"phase": "dp_train_compare", "first_loss_rel_diff":
                          full["first_loss_rel_diff"], "max_loss_rel_diff":
                          full["max_loss_rel_diff"], **tag}), flush=True)
        if not full["first_loss_rel_diff"] <= 1e-3:
            raise AssertionError(f"full-width first losses differ: {la[0]} vs {lb[0]}")

        # n4. a striped checkpoint at full width, resumed by one process
        ck = os.path.join(root, "lm_ckpt")
        n1, n2 = DP_CKPT_STEPS
        first = train_children(DP_FULL + ["--steps", str(n1), "--microbatch", "1",
                                          "--ckpt", ck], 2)
        with open(os.path.join(ck, f"step_{n1 - 1:09d}", "shard_manifest.json")) as f:
            manifest = json.load(f)
        resumed = train_children(DP_FULL + ["--steps", str(n2), "--microbatch", "2",
                                            "--ckpt", ck], 1)[0]
        striped = {"hosts_in_manifest": sorted(manifest["hosts"]),
                   "files_per_host": {h: len(v) for h, v in manifest["hosts"].items()},
                   "save_ms": [r["save_ms"] for r in first],
                   "hosts_agree": first[0]["checksums"] == first[1]["checksums"],
                   "restored_step": resumed["restored"].get("step"),
                   "restored_bit_equal": resumed["restored"].get("checksums")
                   == first[0]["checksums"],
                   "leaves": len(first[0]["checksums"]),
                   "steps_resumed": resumed["steps_run"], "losses_first": first[0]["losses"],
                   "losses_resumed": resumed["losses"]}
        print(json.dumps({"phase": "striped_checkpoint", **striped, **tag}), flush=True)
        if not (striped["hosts_in_manifest"] == ["0", "1"] and striped["hosts_agree"]
                and striped["restored_bit_equal"] and striped["restored_step"] == n1 - 1
                and striped["steps_resumed"] == list(range(n1, n2))):
            raise AssertionError(f"the striped checkpoint did not resume bit-equal: {striped}")
        out.update(dp_smoke=smoke, dp_full=full, striped=striped)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out

# ------------------------------------------------- s. sharded training state

# 2 of its 64 layers: at 4 the script reached 1199 s of its 1200 s limit on
# the slowest machine seen (phase s 89 s there)
FSDP_ARCH, FSDP_LAYERS = "qwen1.5-32b", 2
FSDP_ARGV = ["--arch", FSDP_ARCH, "--full-config", "--seq", "1024", "--batch", "2",
             "--int8-moments", "--steps", "3"]
FSDP_TIMED_STEP = 2  # the step whose gathers and reduce-scatters are timed
FSDP_STATE_SHARE = 0.52
FSDP_LOSS_RTOL, FSDP_LOSS_ATOL = 2e-4, 1e-5
# each step's gradient norm, two processes against one: bf16 gradients of
# batch 1 summed against those of batch 2 round apart by a bf16 ulp
# (2^-8) of some elements; a lost mean (x2 on the split leaves) or a layer's
# gradient counted twice under the remat moves the norm by far more
FSDP_GNORM_RTOL = 1e-2

def fsdp_train_run(a: dict) -> dict:
    """One run of phase s: the launcher's training function at the cut
    depth (``a``: its ``argv`` and ``layers``), each step timed by CUDA
    events with fsdp's counters read after it (the collectives' host ms in
    step ``timed_step``). A process of the two-process job runs it in a
    child (``_FSDP_CHILD``), the one-process reference in this process:
    peaks are counted beyond what the process held before, and the
    hand-written kernels' launches from a count set to 0 at its start."""
    from repro_torch import backend
    from repro_torch import tree as tu
    from repro_torch.backend import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.distributed import fsdp, runtime
    from repro_torch.launch import train as launch_train
    from repro_torch.train import trainer

    args = launch_train.parse_args(a["argv"])
    cfg = dataclasses.replace(get_config(args.arch), n_layers=a["layers"])
    steps, peaks = [], {}
    real_make = trainer.make_train_step

    def make(*args_, **kw):
        step = real_make(*args_, **kw)

        def timed(state, batch):
            if not steps:  # the init is over
                torch.cuda.synchronize()
                peaks["init"] = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            fsdp.TIMED = len(steps) == a["timed_step"]
            fsdp.reset_stats()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = step(state, batch)
            e1.record()
            torch.cuda.synchronize()
            steps.append({"ms": e0.elapsed_time(e1), "timed_collectives": fsdp.TIMED,
                          **fsdp.STATS})
            fsdp.TIMED = False
            return out

        return timed

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    backend.reset_launches()
    trainer.make_train_step = make
    try:
        if args.coordinator:
            ctx = runtime.initialize(coordinator_address=args.coordinator,
                                     num_processes=args.num_processes,
                                     process_id=args.process_id, device=args.device)
            dev = ctx.device
        else:
            ctx, dev = runtime.get_context(), resolve_device(args.device)
        res = launch_train.train(args, ctx, dev, cfg=cfg)
        torch.cuda.synchronize()
        specs = res["specs"]
        out = {"host": ctx.host_id, "n": ctx.n_hosts, "backend": ctx.backend,
               "device": str(dev), "losses": res["losses"], "grad_norms": res["grad_norms"],
               "steps": steps, "state_bytes": res["state_bytes"],
               "split_leaves": 0 if specs is None else sum(s.split for s in tu.leaves(specs)),
               "seconds": res["seconds"], "tok_per_s": res["tok_per_s"],
               "peak_init_gib": (peaks["init"] - before) / 2**30,
               "peak_steps_gib": (torch.cuda.max_memory_allocated() - before) / 2**30,
               "kernel_launches": sum(backend.launches.values())}
    finally:
        trainer.make_train_step = real_make
        fsdp.TIMED = False
        if args.coordinator:
            runtime.shutdown()
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return out


# a process of phase s's two-process job: argv[1] the run, argv[2] the
# directory of this script
_FSDP_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[2])
import chip_smoke
print("CHILD=" + json.dumps(chip_smoke.fsdp_train_run(json.loads(sys.argv[1]))), flush=True)
"""


def sharded_row(k: dict, timed_step: int) -> dict:
    """A process's row of a sharded run (phases s and t) from its run's
    dict: layout, state bytes, peaks, each step's ms and collectives, the
    collectives' host ms in ``timed_step``, losses, launches."""
    return {"host": k["host"], "processes": k["n"], "backend": k["backend"],
            "device": k["device"], "split_leaves": k["split_leaves"],
            "state_bytes": k["state_bytes"],
            "peak_init_gib": k["peak_init_gib"], "peak_steps_gib": k["peak_steps_gib"],
            "step_ms": [st["ms"] for st in k["steps"]],
            "gather_bytes": [st["gather_bytes"] for st in k["steps"]],
            "reduce_scatter_bytes": [st["reduce_scatter_bytes"] for st in k["steps"]],
            "gather_calls": [st["gather_calls"] for st in k["steps"]],
            "reduce_scatter_calls": [st["reduce_scatter_calls"] for st in k["steps"]],
            "timed_step": timed_step, "gather_ms": k["steps"][timed_step]["gather_ms"],
            "reduce_scatter_ms": k["steps"][timed_step]["reduce_scatter_ms"],
            "losses": k["losses"], "grad_norms": k["grad_norms"],
            "kernel_launches": k["kernel_launches"]}


def sharded_compare(two: list, one: dict, seconds: dict, phase: str, tag) -> dict:
    """Two processes' loss and gradient-norm series against one process's
    (phases s and t): printed, then held to FSDP_LOSS_RTOL/ATOL and
    FSDP_GNORM_RTOL, every value finite."""
    a, b = np.asarray(two[0]["losses"]), np.asarray(one["losses"])
    ga, gb = np.asarray([k["grad_norms"] for k in two]), np.asarray(one["grad_norms"])
    compare = {"losses_two": a.tolist(), "losses_one": b.tolist(),
               "max_rel_diff": float(np.max(np.abs(a - b) / np.abs(b))),
               "within_bound": bool(len(a) == len(b) and np.all(
                   np.abs(a - b) <= FSDP_LOSS_ATOL + FSDP_LOSS_RTOL * np.abs(b))),
               "grad_norms_two": ga.tolist(), "grad_norms_one": gb.tolist(),
               "grad_norm_max_rel_diff": float(np.max(np.abs(ga - gb) / np.abs(gb))),
               "grad_norms_within_bound": bool(ga.shape == (2, len(gb)) and np.all(
                   np.abs(ga - gb) <= FSDP_GNORM_RTOL * np.abs(gb))), **seconds}
    print(json.dumps({"phase": phase, **compare, **tag}), flush=True)
    if not (np.all(np.isfinite(a)) and np.all(np.isfinite(b)) and compare["within_bound"]):
        raise AssertionError(f"{phase}: sharded losses off the one-process ones: {compare}")
    if not (np.all(np.isfinite(ga)) and np.all(np.isfinite(gb))
            and compare["grad_norms_within_bound"]):
        raise AssertionError(f"{phase}: sharded gradient norms off the one-process ones: "
                             f"{compare}")
    return compare


def phase_fsdp(dev, tag) -> dict:
    """(s) The sharded state on the card: two processes against one."""
    def total(b):
        return b["params"] + b["grads"] + b["moments"]

    addr = f"127.0.0.1:{free_port()}"
    job = {"layers": FSDP_LAYERS, "timed_step": FSDP_TIMED_STEP}
    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    two = run_children([["-c", _FSDP_CHILD, json.dumps({**job, "argv": FSDP_ARGV + [
        "--coordinator", addr, "--num-processes", "2", "--process-id", str(pid)]}), here]
        for pid in range(2)])
    two_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = fsdp_train_run({**job, "argv": FSDP_ARGV})  # in this process
    one_s = time.perf_counter() - t0
    whole = total(one["state_bytes"])
    rows = []
    for k in two + [one]:
        row = {**sharded_row(k, FSDP_TIMED_STEP),
               "state_share_of_one_process": total(k["state_bytes"]) / whole,
               "tok_per_s": k["tok_per_s"]}
        rows.append(row)
        print(json.dumps({"phase": "fsdp_train", "arch": FSDP_ARCH, "layers": FSDP_LAYERS,
                          "argv": FSDP_ARGV, **row, **tag}), flush=True)
    compare = sharded_compare(two, one, {"two_process_s": two_s, "one_process_s": one_s},
                              "fsdp_compare", tag)
    for r in rows[:2]:
        if not (r["backend"] == "gloo" and r["split_leaves"] > 0
                and r["state_share_of_one_process"] <= FSDP_STATE_SHARE
                and all(g > 0 for g in r["gather_bytes"])
                and all(x > 0 for x in r["reduce_scatter_bytes"])):
            raise AssertionError(f"process {r['host']} of the sharded run: {r}")
    if rows[2]["split_leaves"] or rows[2]["gather_bytes"][0]:
        raise AssertionError(f"the one-process reference is not replicated: {rows[2]}")
    launches = sum(r["kernel_launches"] for r in rows)
    if launches:
        raise AssertionError(f"{launches} kernel launches in LM training")
    return {"rows": rows, "compare": compare, "kernel_launches": launches}


# -------------------------------- t. the audio and vlm families' train step

# whisper-small at full width: the train_4k shape (seq 4096; global batch 256
# cut to 4) in the dry-run preset's 2 microbatches, f32 moments
WHISPER_TRAIN = {"seq": 4096, "batch": 4, "microbatch": 2, "steps": 4}
# llava-next-34b at full width under its config's fsdp: 1 of its 60 layers,
# 1024 text tokens after the 2880 patches, global batch 2 in microbatches of
# one row (one process: 2; each of two processes: 1), int8 moments,
# error-feedback compression
LLAVA_TRAIN = {"layers": 1, "seq": 1024, "batch": 2, "microbatch": 2, "steps": 2,
               "timed_step": 1}
MODAL_PARITY = ("whisper-small", "llava-next-34b")  # card vs CPU at smoke_config
MODAL_STATE_SHARE = 0.52  # a process's state of the whole state's, each of two


def modal_batch(cfg, step: int, local_batch: int, seq: int, dev, host_id: int = 0,
                n_hosts: int = 1) -> dict:
    """This host's rows of global step ``step`` on ``dev``:
    ``lm_data.batch_at``'s tokens and labels and, for the audio and vlm
    families, the stub frontend's frames (encoder_seq, d_model) or patches
    (n_patches, D_VISION) of each row drawn from numpy's generator seeded
    with (SEED, the row's global index), so that any split of the batch
    over hosts sees the same rows."""
    from repro_torch.data import lm_data
    from repro_torch.models import llava

    b = lm_data.batch_at(step, batch_size=local_batch, seq_len=seq, vocab=cfg.vocab_size,
                         host_id=host_id, n_hosts=n_hosts)
    if cfg.family not in ("audio", "vlm"):
        return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
    shape = ((cfg.encoder_seq, cfg.d_model) if cfg.family == "audio"
             else (cfg.n_patches, llava.D_VISION))
    rows = [np.random.default_rng((SEED, (step * local_batch + i) * n_hosts + host_id))
            .standard_normal(shape, dtype=np.float32) for i in range(local_batch)]
    return {**{k: torch.from_numpy(v).to(dev) for k, v in b.items()},
            "frames" if cfg.family == "audio" else "patches": torch.from_numpy(
                np.stack(rows)).to(dev)}


def whisper_train_run(dev, tag) -> dict:
    """whisper-small at full width (bf16, remat) through
    ``make_train_step(api.loss_fn, ...)`` on the frames batch: each step's
    device ms (CUDA events, the median after the first), tokens/s, peak
    memory beyond what the process held before, the state's bytes by
    part."""
    from repro_torch.configs import get_config
    from repro_torch.models import zoo
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainer

    w = WHISPER_TRAIN
    cfg = get_config("whisper-small")
    api = zoo.get_api(cfg)
    ocfg = opt.AdamWConfig(total_steps=w["steps"], warmup_steps=1)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    state = trainer.init_train_state(api.init_params(SEED, device=dev), ocfg)
    step = trainer.make_train_step(api.loss_fn, ocfg, n_microbatch=w["microbatch"])
    ms, losses, gnorms = [], [], []
    for t in range(w["steps"]):
        batch = modal_batch(cfg, t, w["batch"], w["seq"], dev)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        state, m = step(state, batch)
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    median = statistics.median(ms[1:])
    row = {"arch": "whisper-small", **w, "d_model": cfg.d_model,
           "layers": [cfg.encoder_layers, cfg.n_layers], "vocab": cfg.vocab_size,
           "frames": cfg.encoder_seq, "dtype": cfg.dtype, "remat": cfg.remat,
           "moments": "f32", "cuts": "train_4k global batch 256 -> 4 (2 per microbatch), "
                                     f"{w['steps']} steps",
           "step_ms": ms, "step_ms_median": median,
           "tokens_per_s_median_step": w["batch"] * w["seq"] / median * 1e3,
           "losses": losses, "grad_norms": gnorms,
           "peak_memory_gib": (peak - before) / 2**30,
           "state_bytes": lm_state_bytes(state, w["microbatch"])}
    print(json.dumps({"phase": "modal_train", **row, **tag}), flush=True)
    if not (np.all(np.isfinite(losses)) and np.all(np.isfinite(gnorms))):
        raise AssertionError(f"whisper-small at full width: non-finite losses {losses}")
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return row


def llava_train_run(a: dict) -> dict:
    """One run of phase t's llava-next-34b training at the cut depth:
    ``a["coordinator"]`` set, this process is ``a["pid"]`` of
    ``a["n"]`` (its slices of every ``embed``-axis leaf, ``state_specs(
    grad_compress=True)``); else one replicated process. Each step timed by
    CUDA events with fsdp's counters read after it (the collectives' host
    ms in step ``timed_step``); the state's bytes by part, the residual
    included, beside the whole state's; peaks beyond what the process held
    before (the init's, the steps'); the hand-written kernels' launches
    from a count set to 0 at its start."""
    from repro_torch import backend
    from repro_torch import tree as tu
    from repro_torch.backend import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.distributed import fsdp, runtime
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import train as launch_train
    from repro_torch.models import zoo
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainer

    if a.get("coordinator"):
        ctx = runtime.initialize(coordinator_address=a["coordinator"], num_processes=a["n"],
                                 process_id=a["pid"], device=a.get("device"))
        dev = ctx.device
    else:
        ctx, dev = runtime.get_context(), resolve_device(a.get("device"))
    try:
        cfg = dataclasses.replace(get_config("llava-next-34b"), n_layers=a["layers"])
        api = zoo.get_api(cfg)
        ocfg = opt.AdamWConfig(total_steps=a["steps"], warmup_steps=1, int8_moments=True)
        local = a["batch"] // ctx.n_hosts
        n_mb = local * a["microbatch"] // a["batch"]  # microbatches of batch / microbatch rows
        specs = None
        if ctx.is_multi_controller:
            specs = trainer.state_specs(api.param_axes(), api.init_params(0, device="meta"),
                                        ocfg, shd.default_rules(fsdp.mesh_for(ctx), fsdp=True),
                                        ctx, grad_compress=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        backend.reset_launches()
        params = api.init_params(SEED, device=dev, specs=None if specs is None else specs.params)
        state = trainer.init_train_state(params, ocfg, grad_compress=True, specs=specs)
        del params
        torch.cuda.synchronize()
        peak_init = torch.cuda.max_memory_allocated() - before
        torch.cuda.reset_peak_memory_stats()
        step = trainer.make_train_step(api.loss_fn, ocfg, n_microbatch=n_mb, grad_compress=True,
                                       ctx=ctx, specs=specs)
        steps, losses, gnorms = [], [], []
        for t in range(a["steps"]):
            batch = modal_batch(cfg, t, local, a["seq"], dev, ctx.host_id, ctx.n_hosts)
            fsdp.TIMED = t == a["timed_step"]
            fsdp.reset_stats()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            state, m = step(state, batch)
            e1.record()
            torch.cuda.synchronize()
            steps.append({"ms": e0.elapsed_time(e1), "timed_collectives": fsdp.TIMED,
                          **fsdp.STATS})
            fsdp.TIMED = False
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        sizes = launch_train.state_bytes(state, specs, n_mb)
        out = {"host": ctx.host_id, "n": ctx.n_hosts, "backend": ctx.backend,
               "device": str(dev), "n_microbatch": n_mb, "local_batch": local,
               "losses": losses, "grad_norms": gnorms, "steps": steps, "state_bytes": sizes,
               "split_leaves": 0 if specs is None else sum(s.split for s in tu.leaves(specs)),
               "residual_split_leaves": 0 if specs is None else sum(
                   s.split for s in tu.leaves(specs.ef)),
               "peak_init_gib": peak_init / 2**30,
               "peak_steps_gib": (torch.cuda.max_memory_allocated() - before) / 2**30,
               "kernel_launches": sum(backend.launches.values())}
        del state, step
    finally:
        fsdp.TIMED = False
        if a.get("coordinator"):
            runtime.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    return out


# a process of phase t's two-process job: argv[1] the run, argv[2] the
# directory of this script
_LLAVA_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[2])
import chip_smoke
print("CHILD=" + json.dumps(chip_smoke.llava_train_run(json.loads(sys.argv[1]))), flush=True)
"""


def phase_modal_train(dev, tag) -> dict:
    """(t) The audio and vlm families' train step on the card: one step of
    whisper-small and llava-next-34b at their smoke configs on the card
    against the CPU; whisper-small at full width; llava-next-34b at full
    width (depth and text cut) sharded over two processes sharing the card,
    with compression, against one replicated process. No hand-written
    kernel runs on this path: the launch counts, set to 0 before each run,
    must read 0 after it."""
    from repro_torch import backend
    from repro_torch.models import snn_yolo as sy

    def total(b):
        return sum(v for k, v in b.items() if k != "whole")

    backend.reset_launches()
    out = {"card_vs_cpu": []}
    with sy._no_tf32():
        for arch in MODAL_PARITY:
            for n_mb, compress, int8 in LM_TRAIN_PARITY:
                row = lm_train_step_both(dev, arch, n_mb, compress, int8)
                out["card_vs_cpu"].append(row)
                print(json.dumps({"phase": "modal_train_card_vs_cpu", **row, **tag}),
                      flush=True)
    out["whisper"] = whisper_train_run(dev, tag)
    parent_launches = sum(backend.launches.values())

    addr = f"127.0.0.1:{free_port()}"
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    two = run_children([["-c", _LLAVA_CHILD, json.dumps(
        {**LLAVA_TRAIN, "coordinator": addr, "n": 2, "pid": pid}), here] for pid in range(2)])
    two_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = llava_train_run(dict(LLAVA_TRAIN))  # in this process
    one_s = time.perf_counter() - t0
    rows = []
    for k in two + [one]:
        whole = k["state_bytes"]["whole"]
        row = {**sharded_row(k, LLAVA_TRAIN["timed_step"]), "n_microbatch": k["n_microbatch"],
               "local_batch": k["local_batch"],
               "residual_split_leaves": k["residual_split_leaves"],
               "state_share_of_whole": total(k["state_bytes"]) / total(whole),
               "share_by_part": {p: k["state_bytes"][p] / whole[p] for p in whole},
               "state_share_of_one_process": total(k["state_bytes"]) / total(
                   one["state_bytes"])}
        rows.append(row)
        print(json.dumps({"phase": "modal_fsdp_train", "arch": "llava-next-34b", **LLAVA_TRAIN,
                          "cuts": "depth 60 -> 1, text 4096 -> 1024 tokens, global batch "
                                  "256 -> 2", **row, **tag}), flush=True)
    compare = sharded_compare(two, one, {"two_process_s": two_s, "one_process_s": one_s},
                              "modal_fsdp_compare", tag)
    for r in rows[:2]:
        if not (r["backend"] == "gloo" and r["split_leaves"] > 0
                and r["residual_split_leaves"] > 0
                and r["state_share_of_whole"] <= MODAL_STATE_SHARE
                and all(g > 0 for g in r["gather_bytes"])
                and all(x > 0 for x in r["reduce_scatter_bytes"])):
            raise AssertionError(f"process {r['host']} of the sharded llava run: {r}")
    if rows[2]["split_leaves"] or rows[2]["gather_bytes"][0]:
        raise AssertionError(f"the one-process llava run is not replicated: {rows[2]}")
    launches = parent_launches + sum(r["kernel_launches"] for r in rows)
    print(json.dumps({"phase": "modal_train_kernel_launches",
                      "hand_written_kernel_launches": launches, **tag}), flush=True)
    if launches:
        raise AssertionError(f"{launches} kernel launches in the modal LM training")
    out.update(llava=rows, compare=compare, kernel_launches=launches)
    return out


# --------------------------------------------------- o. the other LM families

# at smoke_config, the card against the CPU: rwkv6 and zamba2 through Engine,
# whisper and llava through their API
LM_FAMILY_ENGINE = ("rwkv6-3b", "zamba2-7b")
LM_FAMILY_API = ("whisper-small", "llava-next-34b")
# f32 logits, card against CPU: within 8e-5 of the largest |logit| where no
# bf16 cache lies on the path (rwkv6's and mamba2's state is f32; zamba2's
# shared attention, and every prefill, read back the f32 K/V they computed).
# whisper's and llava's decode steps read their K/V from the bf16 cache,
# where f32 values an ulp apart on the card and the CPU can round to bf16
# values 2^-8 apart: those steps are held to phase l's LM_LOGITS_TOL
LM_FAMILY_F32_TOL = 8e-5
LM_FAMILY_SERVE = 16  # requests at full width through Engine (phase l's traffic)
WHISPER_FULL = {"batch": 8, "prompt": 4, "new": 32}
LLAVA_FULL = {"batch": 1, "prompt": 64, "new": 16}
LLAVA_HEADROOM_GIB = 10.0  # the prefill's f32 scores over 2944 rows and the cache


def family_extra(cfg, batch: int, rng, dev, dtype=torch.float32) -> torch.Tensor:
    """The stub frontend's output drawn with numpy: whisper's frames
    (B, encoder_seq, d_model), llava's patches (B, n_patches, D_VISION)."""
    from repro_torch.models import llava

    shape = ((batch, cfg.encoder_seq, cfg.d_model) if cfg.family == "audio"
             else (batch, cfg.n_patches, llava.D_VISION))
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)


def api_greedy(api, params, toks, extra, n: int, *, on_call=None):
    """whisper or llava through its API: prefill with ``extra`` into a bf16
    cache of ``T + n`` rows (llava's ``P + T + n``), then ``n`` greedy
    ``decode_fn`` steps, the batch at one position. Returns (tokens
    (B, n + 1) on the host, logits per call on the host, the cache).
    ``on_call(kind, f)`` runs the prefill (kind "prefill") and each decode
    step ("decode"), for timing."""
    b, t = toks.shape
    rows = t + (extra.shape[1] if api.cfg.family == "vlm" else 0)
    cache = api.init_cache(b, rows + n, device=toks.device)
    call = on_call or (lambda kind, f: f())
    logits, cache = call("prefill", lambda: api.prefill_fn(params, toks, extra, cache=cache))
    seq, calls = [logits.argmax(-1)], [logits.float().cpu()]
    for i in range(n):
        logits, cache = call("decode", lambda c=cache, tok=seq[-1], pos=rows + i:
                             api.decode_fn(params, c, tok, pos))
        seq.append(logits.argmax(-1))
        calls.append(logits.float().cpu())
    return torch.stack(seq, 1).cpu(), calls, cache


def family_card_vs_cpu(dev, tag) -> dict:
    """The four families at smoke_config on the card against the CPU (f32,
    TF32 off): streams equal; logits within LM_FAMILY_F32_TOL, except the
    decode steps of whisper and llava (bf16 cache): LM_LOGITS_TOL."""
    import copy

    from repro_torch import tree as tu
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import zoo

    out = {}
    for arch in LM_FAMILY_ENGINE + LM_FAMILY_API:
        cfg = smoke_config(get_config(arch))
        api = zoo.get_api(cfg)
        cpu_params = api.init_params(SEED, device="cpu")
        card_params = tu.tree_map(lambda x: x.to(dev), cpu_params)
        rng = np.random.default_rng(SEED + 30)
        if arch in LM_FAMILY_ENGINE:
            reqs = lm_requests(rng, cfg, [int(rng.integers(3, 41)) for _ in range(7)], 8)
            runs = [lm_engine_run(cfg, p, copy.deepcopy(reqs), n_slots=4, max_seq=96)
                    for p in (cpu_params, card_params)]
            row = {"arch": arch, "path": "Engine", "requests": len(reqs), "slots": 4,
                   **lm_compare(runs[1][0], runs[0][0], runs[1][1], runs[0][1],
                                tol=LM_FAMILY_F32_TOL)}
        else:
            toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 5)))
            extra = family_extra(cfg, 2, rng, "cpu")
            cpu_seq, cpu_calls, _ = api_greedy(api, cpu_params, toks, extra, 8)
            card_seq, card_calls, _ = api_greedy(api, card_params, toks.to(dev),
                                                 extra.to(dev), 8)
            errs = [float((a - b).abs().max()) / float(b.abs().max())
                    for a, b in zip(card_calls, cpu_calls)]
            for k, (err, tol) in enumerate(zip(errs, [LM_FAMILY_F32_TOL]
                                               + [LM_LOGITS_TOL] * (len(errs) - 1))):
                if err > tol:
                    raise AssertionError(f"{arch} call {k}: card logits {err:.3e} of the "
                                         f"largest from the CPU's (> {tol})")
            if not torch.equal(card_seq, cpu_seq):
                raise AssertionError(f"{arch}: card tokens {card_seq.tolist()} != CPU "
                                     f"{cpu_seq.tolist()}")
            row = {"arch": arch, "path": "api", "batch": 2, "steps": 8,
                   "prefill_rel_err": errs[0], "prefill_tol": LM_FAMILY_F32_TOL,
                   "decode_max_rel_err": max(errs[1:]), "decode_tol": LM_LOGITS_TOL,
                   "tokens_equal": True}
        if not row["tokens_equal"]:
            raise AssertionError(f"{arch}: card against CPU {row}")
        out[arch] = row
        print(json.dumps({"phase": "lm_family_card_vs_cpu", **row, **tag}), flush=True)
    return out


def llava_layers_that_fit(cfg) -> tuple[int, float]:
    """The most layers (≤ ``cfg.n_layers``) whose bf16 weights fit in the
    card's free memory beside LLAVA_HEADROOM_GIB, and that free memory."""
    from repro_torch.models import llava

    d, f, nh, nkv, hd = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    per_layer = (d * nh * hd + 2 * d * nkv * hd + nh * hd * d + 3 * d * f + 2 * d) * 2
    fixed = (2 * cfg.vocab_size * d + d + llava.D_VISION * d + d * d) * 2
    free = torch.cuda.mem_get_info()[0]
    room = free - LLAVA_HEADROOM_GIB * 2**30 - fixed
    return max(1, min(cfg.n_layers, int(room // per_layer))), free / 2**30


def events_ms(fn, reps: int = 5) -> float:
    """Median ms of ``fn`` between CUDA events around each call, after one
    warm-up: device time where the device is the slower side, host gaps
    included where the host is (``device_ms`` needs calls the host can
    queue ahead of a spin kernel; these make hundreds of launches)."""
    fn()
    out = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1))
    return statistics.median(out)


def api_serve_run(dev, arch: str, tag) -> dict:
    """whisper-small or llava-next-34b at full width in bf16 through its
    API: prefill ms (and whisper's encoder and ``cross_kv`` ms), the decode
    steps' host and device ms, one steady step's busy share, tokens/s, peak
    memory, the params' and the cache's bytes."""
    from repro_torch.benchmarks import serve_bench
    from repro_torch.configs import get_config
    from repro_torch.models import whisper, zoo

    cfg = get_config(arch)
    run = WHISPER_FULL if cfg.family == "audio" else LLAVA_FULL
    cut = None
    gc.collect()
    torch.cuda.empty_cache()
    if cfg.family == "vlm":
        fit, free_gib = llava_layers_that_fit(cfg)
        if fit < cfg.n_layers:
            cut = {"n_layers": [cfg.n_layers, fit], "free_gib_before": free_gib,
                   "headroom_gib": LLAVA_HEADROOM_GIB}
            cfg = dataclasses.replace(cfg, n_layers=fit)
    api = zoo.get_api(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    rng = np.random.default_rng(SEED + 31)
    b, t, n = run["batch"], run["prompt"], run["new"]
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (b, t))).to(dev)
    extra = family_extra(cfg, b, rng, dev, cfg.param_dtype)
    parts = {}
    if cfg.family == "audio":  # the prefill's two parts on their own
        enc = whisper.encode(params, extra, cfg)
        parts = {"encoder_ms": events_ms(lambda: whisper.encode(params, extra, cfg)),
                 "cross_kv_ms": events_ms(lambda: whisper.cross_kv(params, enc, cfg))}
        del enc
    api_greedy(api, params, toks, extra, 2)  # warm-up: first-call library set-up
    torch.cuda.reset_peak_memory_stats()
    events, walls = {"prefill": [], "decode": []}, {"prefill": [], "decode": []}

    def timed(kind, call):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t_ = time.perf_counter()
        e0.record()
        r = call()
        e1.record()
        r[0].argmax(-1).tolist()  # the host waits for the token, as a server does
        walls[kind].append((time.perf_counter() - t_) * 1e3)
        events[kind].append((e0, e1))
        return r

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq, calls, cache = api_greedy(api, params, toks, extra, n, on_call=timed)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    prefill_ms = events["prefill"][0][0].elapsed_time(events["prefill"][0][1])
    dec_dev = [a.elapsed_time(z) for a, z in events["decode"]]
    peak = torch.cuda.max_memory_allocated()
    if seq.shape != (b, n + 1) or not all(bool(torch.isfinite(c).all()) for c in calls):
        raise AssertionError(f"{arch}: {tuple(seq.shape)} tokens, finite "
                             f"{[bool(torch.isfinite(c).all()) for c in calls]}")
    if not ((seq >= 0) & (seq < cfg.vocab_size)).all():
        raise AssertionError(f"{arch}: a token outside the vocabulary")
    rows = cache[0].shape[2]
    tok = seq[:, -1].to(dev)

    def one_step():
        logits, _ = api.decode_fn(params, cache, tok, rows - 1)
        return torch.argmax(logits, dim=-1)

    by_kernel = serve_bench.kernel_breakdown(one_step, dev)
    step_wall = statistics.median(walls["decode"][1:])
    out = {"arch": arch, "family": cfg.family, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "depth_cut": cut, "batch": b, "prompt_tokens": t,
           "extra": list(extra.shape), "new_tokens": n, "init_s": init_s,
           "n_params": get_config(arch).n_params(), "param_bytes": tree_bytes(params),
           "cache_bytes": tree_bytes(cache), "run_s": run_s,
           "tokens_per_s": b * (n + 1) / run_s, "prefill_device_ms": prefill_ms,
           "prefill_host_ms": walls["prefill"][0], **parts,
           "decode_step_host_ms_p50": step_wall,
           "decode_step_device_ms_p50": statistics.median(dec_dev),
           "decode_step_kernel_ms": None if by_kernel is None else by_kernel["total_ms"],
           "decode_step_kernel_launches": None if by_kernel is None
           else by_kernel["kernel_launches"],
           "decode_step_busy_share": None if by_kernel is None
           else by_kernel["total_ms"] / step_wall,
           "decode_step_top_kernels": None if by_kernel is None else by_kernel["kernels"][:8],
           "init_peak_memory_gib": init_peak / 2**30, "peak_memory_gib": peak / 2**30}
    print(json.dumps({"phase": "lm_family_serve", **out, **tag}), flush=True)
    del params, cache, extra
    return out


def phase_lm_families(dev, tag) -> dict:
    """(o) The ssm, hybrid, audio and vlm families on the card: smoke-config
    parity against the CPU, then each model at full width in bf16 (rwkv6-3b
    and zamba2-7b through ``Engine``, whisper-small and llava-next-34b
    through their API). No hand-written kernel runs on this path: the
    launch counts are set to 0 before the phase and must read 0 after it."""
    from repro_torch import backend
    from repro_torch.configs import get_config
    from repro_torch.models import snn_yolo as sy

    backend.reset_launches()
    out = {}
    with sy._no_tf32():
        out["card_vs_cpu"] = family_card_vs_cpu(dev, tag)
    out["serve"] = {}
    for arch in LM_FAMILY_ENGINE:
        gc.collect()
        torch.cuda.empty_cache()
        row = lm_serve_run(dev, arch, LM_FAMILY_SERVE, tag)
        row["n_params_bytes_bf16"] = get_config(arch).n_params() * 2
        print(json.dumps({"phase": "lm_family_bytes", "arch": arch,
                          "n_params": row["n_params"], "param_bytes": row["param_bytes"],
                          "n_params_bytes_bf16": row["n_params_bytes_bf16"],
                          "cache_bytes": row["cache_bytes"], **tag}), flush=True)
        out["serve"][arch] = row
    for arch in LM_FAMILY_API:
        out["serve"][arch] = api_serve_run(dev, arch, tag)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    launches = sum(backend.launches.values())
    print(json.dumps({"phase": "lm_family_kernel_launches",
                      "hand_written_kernel_launches": launches,
                      "by_kernel": dict(backend.launches), **tag}), flush=True)
    if launches:
        raise AssertionError(f"the LM families launched hand-written kernels: "
                             f"{dict(backend.launches)}")
    out["kernel_launches"] = launches
    return out


AUTOTUNE_ITERS = 5  # batches of 10 timed launches per candidate tile (the median is kept)


def phase_autotune(dev, det, frames, captured, tag) -> dict:
    """(p) The fused kernel's tile autotuner at 576×1024, T=(1, 3), batch 2.
    Every candidate tile of every distinct fused layer shape runs seeded
    inputs (``autotune.synthetic_layer``) bit-equal to the shape rule's
    tile and to the plain version, its plan's shared memory equal to the
    library's query (``fp.tile_plan``) and the rule's launch to
    ``fp.rule_tile``; each shape's candidate times and winner are printed.
    The committed cache must name this card and the current kernel hash
    and cover every shape at ``autotune.TUNE_BATCHES``; the serving plan
    must carry its tiles. Then the main path's 27 launches (frame 0's captured inputs)
    timed at the plan's tiles and at the shape rule's, and one frame of the
    tuned and of an untuned session (27 launches each)."""
    from repro_torch import backend
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import fused_pipeline as fp
    from repro_torch.models import snn_yolo as sy

    cfg = det.cfg
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = at.detector_layer_shapes(cfg)
    winners, n_checked = {}, 0
    for name, shape in shapes.items():
        if at.cache_key(shape, BATCH) in winners:
            continue
        x, live, affine = at.synthetic_layer(shape, batch=BATCH, device=dev)
        kw = dict(kout=shape.kout, kh=shape.kh, kw=shape.kw, bh=shape.bh, bw=shape.bw,
                  t_out=shape.t_out, bn_scale=cfg.threshold, threshold=cfg.threshold,
                  leak=cfg.leak)
        want = fp.fused_pipeline_reference(x, live.w, live.taps, affine, None, **kw)
        at_rule = at.layer_call(shape, x, live, affine, None, threshold=cfg.threshold,
                                leak=cfg.leak)()
        rule_plan = fp.last_plan()
        rule = at.rule(shape, BATCH, sms)
        if (rule_plan["steps_per_pass"], rule_plan["tile_pixels"], rule_plan["tile_channels"]) \
                != (rule.tb, 16 * rule.wm, 8 * rule.ni * rule.wn):
            raise AssertionError(f"p: the kernel's rule ran {rule_plan} at {name}; "
                                 f"autotune.rule says {rule}")
        walls = {}
        for tile in at.candidates(shape):
            run = at.layer_call(shape, x, live, affine, tile, threshold=cfg.threshold,
                                leak=cfg.leak)
            spk, mem = run()
            plan = fp.last_plan()
            torch.cuda.synchronize()
            for ref, what in ((at_rule, "the rule's tile"), (want, "the plain version")):
                if not (bits_equal(spk, ref[0]) and bits_equal(mem, ref[1])):
                    raise AssertionError(f"p: tile {tile} != {what} at {name} {shape.key}")
            smem, _ = fp.tile_plan(tile, c=x.shape[-1], kp=live.w.shape[2],
                                   n_live=len(live.taps), kh=shape.kh, bh=shape.bh,
                                   bw=shape.bw)
            if (plan["smem_bytes"], plan["steps_per_pass"], plan["tile_pixels"],
                    plan["tile_channels"]) != (smem, tile.tb, 16 * tile.wm,
                                               8 * tile.ni * tile.wn):
                raise AssertionError(f"p: tile {tile} at {name} ran plan {plan}; the "
                                     f"library's plan query says {smem} bytes")
            n_checked += 1
            walls[tile] = at.measure(run, iters=AUTOTUNE_ITERS)
        win = winners[at.cache_key(shape, BATCH)] = at.pick(walls, rule)
        print(json.dumps({"phase": "autotune_shape", "layer": name, "key": shape.key,
                          "rule": at.tile_name(rule),
                          "ms": {at.tile_name(t): v for t, v in walls.items()},
                          "rule_ms": walls[rule], "winner": at.tile_name(win),
                          "winner_ms": walls[rule if win is None else win], **tag}),
              flush=True)
        del x, live, affine, want, at_rule
    committed = at.load_cache()
    missing = at.check_cache([cfg])
    if missing:
        raise AssertionError(f"p: the committed cache {at.cache_path()} lacks {missing} "
                             f"(or names another card / kernel hash)")
    plan_tiles = {n: {b: det.plan.layers[n].tiles.get((b, s.h, s.w)) for b in at.TUNE_BATCHES}
                  for n, s in shapes.items()}
    want_tiles = {n: {b: at.lookup(s, committed, b) for b in at.TUNE_BATCHES}
                  for n, s in shapes.items()}
    if plan_tiles != want_tiles:
        raise AssertionError(f"p: the serving plan's tiles {plan_tiles} are not the "
                             f"committed cache's {want_tiles}")
    agree = sum(committed[k] == w for k, w in winners.items())

    # the main path's launches at the plan's tiles and at the rule's
    names = [n for n in det.plan.layers if n != "head"]
    sums = {"tuned": 0.0, "untuned": 0.0}
    for name, args in zip(names, captured):
        a = dict(args)
        x, w_, taps, affine, v0 = (a.pop(k) for k in ("x", "w", "taps", "affine", "v0"))
        if a["tile"] != det.plan.layers[name].tile_for(x):
            raise AssertionError(f"p: {name} launched at {a['tile']}, its plan holds "
                                 f"{det.plan.layers[name].tile_for(x)}")
        for label, tile in (("tuned", a["tile"]), ("untuned", None)):
            ms, _ = device_ms(lambda: fp.fused_pipeline(x, w_, taps, affine, v0,
                                                        **{**a, "tile": tile}))
            sums[label] += ms
    untuned_det = sy.compile_detector(cfg, det.params, det.bn_state, device=dev, tile_cache={})
    if any(lp.tiles for lp in untuned_det.plan.layers.values()):
        raise AssertionError("p: tile_cache={} left a tuned tile in the plan")

    def session_ms(d):
        s_ = d.new_session(batch=BATCH)
        backend.reset_launches()
        walls_ = []
        for k in range(10):
            torch.cuda.synchronize()
            t = time.perf_counter()
            s_.step(frames[k % N_FRAMES])
            torch.cuda.synchronize()
            walls_.append((time.perf_counter() - t) * 1e3)
        if backend.launches[fp.KERNEL] != 27 * 10:
            raise AssertionError(f"p: {backend.launches[fp.KERNEL]} fused launches in 10 "
                                 "frames, want 27 a frame")
        return statistics.median(walls_[1:])

    frame = {"tuned_ms": session_ms(det), "untuned_ms": session_ms(untuned_det)}
    frame["tuned_ms_again"] = session_ms(det)
    frame["untuned_ms_again"] = session_ms(untuned_det)
    out = {"shapes": len(winners), "candidates_checked": n_checked,
           "moved_off_rule": sum(w is not None for w in winners.values()),
           "committed_agrees": agree, "sum_27_tuned_ms": sums["tuned"],
           "sum_27_untuned_ms": sums["untuned"], "frame": frame,
           "cache": {"path": os.path.relpath(at.cache_path()), "device": at.device_name(),
                     "kernel": at.kernel_version()},
           "plan_tiles": {n: {b: at.tile_name(t) for b, t in bt.items()}
                          for n, bt in plan_tiles.items()}}
    print(json.dumps({"phase": "autotune", **out, "batch": BATCH,
                      "input_hw": list(cfg.input_hw), **tag}), flush=True)
    return out


DRYRUN_ARCHS = ("qwen1.5-0.5b", "olmoe-1b-7b", "rwkv6-3b", "zamba2-7b", "llava-next-34b")
# parameter bytes of the full-width bf16 trees that phase o builds on the card
# (tree_bytes of the real tensors, as phase o prints them)
FAMILY_PARAM_BYTES = {"rwkv6-3b": 6_146_954_240, "zamba2-7b": 13_501_134_144,
                      "llava-next-34b": 68_895_275_008}
DETECTOR_SHARDS = 4  # column shards of 8 input block columns each


def phase_dryrun(dev, det, frames, lm, lm_train, families, tag) -> dict:
    """(q) The dry-run on the card's machine: ``launch.dryrun`` for every
    ``h100`` cell of five configs (meta tensors, no card work), each
    parameter tree's bytes held equal to what phases l, m and o measured on
    real tensors; the FLOPs of phase m's qwen1.5-0.5b step (seq 4096, batch
    8 in 4 microbatches, remat) over its measured step time (achieved
    TFLOP/s, a share of the 989 TFLOP/s data-sheet peak; printed, not
    gated); the roofline table; and ``detector_dryrun``'s shard check at
    576×1024 on the card: the shards' fused forwards equal the whole
    forward's columns bit for bit up to the first layer whose map no longer
    holds whole blocks in a shard, which must be the one the block grid
    predicts."""
    from repro_torch.benchmarks import detector_dryrun, roofline
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun

    out_dir = os.path.join("artifacts", "dryrun_torch")
    measured = {a: r["param_bytes"] for a, r in lm["serve"].items()}
    measured.update({a: r["param_bytes"] for a, r in families["serve"].items()
                     if "param_bytes" in r})
    measured.update({a: r["state_bytes"]["params"] for a, r in lm_train["train"].items()})
    t0 = time.perf_counter()
    cells = {}
    for arch in DRYRUN_ARCHS:
        for shape in SHAPES:
            rec = dryrun.run_cell(arch, shape, "h100", out_dir)
            cells[f"{arch}__{shape}"] = rec
            if rec["status"] != "ok":
                continue
            got = rec["static_bytes_per_device"]["params"]
            for want in (measured.get(arch), FAMILY_PARAM_BYTES.get(arch)):
                if want is not None and got != want:
                    raise AssertionError(f"q: {arch}'s dry-run parameter bytes {got} != "
                                         f"{want} measured on the card")
    sweep_s = time.perf_counter() - t0
    table = roofline.run(out_dir, "h100")
    cfg = get_config("qwen1.5-0.5b")
    step_shape = ShapeSpec("phase_m", 4096, 8, "train")
    cost, meta = dryrun.step_cost(cfg, step_shape, n_microbatch=4)
    step_ms = lm_train["train"]["qwen1.5-0.5b"]["step_ms_median"]
    achieved = cost.flops / (step_ms / 1e3) / 1e12
    mfu = {"flops": cost.flops, "product_flops": cost.product_flops, "bytes": cost.bytes,
           "step_ms_median": step_ms, "achieved_tflops": achieved,
           "share_of_989": achieved / 989.0,
           "product_tflops": cost.product_flops / (step_ms / 1e3) / 1e12,
           "bytes_per_s_share_of_3_35e12": cost.bytes / (step_ms / 1e3) / 3.35e12,
           "remat": cfg.remat, **meta}
    print(json.dumps({"phase": "dryrun_phase_m_step", **mfu, **tag}), flush=True)
    roof = detector_dryrun.run(det.cfg)
    shards = detector_dryrun.shard_check(det, frames[0], DETECTOR_SHARDS)
    from repro_torch.models import snn_yolo as sy

    # the first layer (in launch order) whose map a shard cuts inside a block
    hw = sy.layer_hw(det.cfg)
    order = [n for n in det.plan.layers if n != "head"]
    predicted = next((n for n in order
                      if (hw[n][1] // DETECTOR_SHARDS) % det.cfg.block_hw[1]), None)
    before = order if predicted is None else order[:order.index(predicted)]
    if (shards["first_differing_layer"] != predicted
            or any(n not in shards["layers_equal"] for n in before)
            or shards["head_bit_equal"] != (predicted is None)):
        raise AssertionError(f"q: shard check {shards}; the block grid predicts the first "
                             f"differing layer {predicted}")
    print(json.dumps({"phase": "detector_shards", **shards, "predicted_first": predicted,
                      "roofline": roof, **tag}), flush=True)
    out = {"cells": len(cells), "sweep_s": sweep_s, "phase_m_step": mfu,
           "detector_roofline": roof, "detector_shards": shards, "table": table}
    print(json.dumps({"phase": "dryrun", "cells": len(cells), "sweep_s": sweep_s,
                      "params_held": sorted(set(measured) | set(FAMILY_PARAM_BYTES)), **tag}),
          flush=True)
    return out


# phase r: the developer entry points (launch.quickstart, mixed_timestep_search,
# serve_lm, make_ann_fixture; benchmarks.check_crossover) on the card
EXAMPLE_TRAIN_STEPS = 120  # make_ann_fixture's 4000 steps, cut to the time limit
EXAMPLE_EVAL_IMAGES = 8  # the trained ANN's val images (48 by default), and the convert CLI's
CROSSOVER_SMALL_HW, CROSSOVER_SMALL_REPS = (96, 128), 20  # the JAX gate's file: a reading only
# the quickstart's figures that must be equal on the card and the CPU; its f32
# means (spike rates, mIoUT) reduce in another order there: within EXAMPLE_F32_TOL
QUICKSTART_KEYS = ("param_count", "head_shape", "spike_count", "stage4/main_a", "in_t",
                   "kernel", "detections", "score_threshold", "session_counts")
EXAMPLE_F32_TOL = 1e-6

_CONVERT_CHILD = r"""
import json, sys
from repro_torch import backend
from repro_torch.launch import convert
from repro_torch.serve import detector as sd

real, per = sd.CompiledDetector.detect, []
def detect(self, frames):
    before = backend.launches["fused_pipeline"]
    out = real(self, frames)
    per.append([self.cfg.conv_exec, backend.launches["fused_pipeline"] - before])
    return out
sd.CompiledDetector.detect = detect
r = convert.main(sys.argv[1:])
print(json.dumps({"detects": per, "map": r["report"]["map"]}))
"""


def gated_recorder(g2a):
    """(stand-in, captured): a stand-in for ``g2a.gated_one_to_all`` that calls
    it and keeps each launch's inputs, for the check against the plain version."""
    real = g2a.gated_one_to_all
    captured = []

    def record(*args, **kwargs):
        captured.append((args, kwargs))
        return real(*args, **kwargs)

    return record, captured


def phase_examples(dev, e2e_full, tag) -> dict:
    """(r) the developer entry points, each driven as a user calls it: the
    quickstart (its gated launch held to the plain version, every figure
    equal on the CPU), the mixed-time-step search at 144x256 and 576x1024
    (card ≡ CPU), the LM burst of the four families (streams card ≡ CPU),
    the ANN trainer on the card and its bundle converted and served by the
    convert CLI, and the crossover gate on phase g's full-width result."""
    import tempfile

    from repro_torch import backend
    from repro_torch import tree as tu
    from repro_torch.benchmarks import check_crossover, e2e_detector
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.kernels import gated_one_to_all as g2a
    from repro_torch.launch import make_ann_fixture, quickstart, serve_lm
    from repro_torch.launch import mixed_timestep_search as search
    from repro_torch.models import zoo

    out = {}
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.path.join(here, "src")}

    # ---------------------------------------------------- 1. the quickstart
    t0 = time.perf_counter()
    real_gated = g2a.gated_one_to_all
    record, captured = gated_recorder(g2a)
    g2a.gated_one_to_all = record
    try:
        backend.reset_launches()
        card = quickstart.run(device=dev)
        torch.cuda.synchronize()
        launches = dict(backend.launches)
    finally:
        g2a.gated_one_to_all = real_gated
    card_s = time.perf_counter() - t0
    if launches != {g2a.KERNEL: 1} or card["kernel_launches"] != 1 or len(captured) != 1:
        raise AssertionError(f"quickstart launched {launches}; want one gated launch")
    (x, maskp, vals, tap_any), kw = captured[0]
    y = g2a.gated_one_to_all(x, maskp, vals, tap_any, **kw)
    want = g2a.gated_one_to_all_reference(x, maskp, vals, tap_any, **kw)
    torch.cuda.synchronize()
    if not bits_equal(y, want):
        raise AssertionError(f"quickstart's gated launch != plain version: max |Δ| "
                             f"{int((y - want).abs().max())}")
    ms, _ = device_ms(lambda: g2a.gated_one_to_all(x, maskp, vals, tap_any, **kw))
    plain_ms = elapsed_ms(lambda: g2a.gated_one_to_all_reference(x, maskp, vals, tap_any,
                                                                 **kw), reps=5)
    bound, bound_by = gated_bound(x, (maskp, vals, tap_any), kw["kout"],
                                  card["kernel"]["taps_executed"])
    t0 = time.perf_counter()
    cpu = quickstart.run(device="cpu")
    cpu_s = time.perf_counter() - t0
    differ = [k for k in QUICKSTART_KEYS if card[k] != cpu[k]]
    f32_diff = max(abs(card[k][n] - cpu[k][n]) for k in ("spike_rate", "miout") for n in card[k])
    if differ or f32_diff > EXAMPLE_F32_TOL:
        raise AssertionError(f"quickstart card != CPU in {differ} (f32 means within "
                             f"{f32_diff}): {[(card[k], cpu[k]) for k in differ]}")
    out["quickstart"] = {"launches": launches[g2a.KERNEL], "max_abs_err": 0.0,
                         "tile": list(x.shape), "kout": kw["kout"], "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                         "card_s": card_s, "cpu_s": cpu_s,
                         "figures_equal_cpu": True, "f32_max_abs_diff_cpu": f32_diff,
                         **{k: card[k] for k in (*QUICKSTART_KEYS, "spike_rate", "miout")
                            if k != "head_shape"}}
    print(json.dumps({"phase": "example_quickstart", **out["quickstart"], **tag}), flush=True)

    # ------------------------------------- 2. the mixed-time-step search
    backend.reset_launches()
    out["search"] = {}
    for full in (False, True):
        cfg = search.search_config(full_config=full)
        t0 = time.perf_counter()
        got = search.run(cfg, device=dev)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref_ = search.run(cfg, device="cpu")
        cpu_s = time.perf_counter() - t0
        for k in ("schedule", "base_gops", "proposed_gops"):
            if got[k] != ref_[k]:
                raise AssertionError(f"search at {cfg.input_hw}: card {k} {got[k]} != CPU "
                                     f"{ref_[k]}")
        dm = max(abs(v - ref_["miout"][n]) for n, v in got["miout"].items() if v is not None)
        if dm > EXAMPLE_F32_TOL:
            raise AssertionError(f"search at {cfg.input_hw}: mIoUT card vs CPU {dm}")
        row = {"input_hw": list(cfg.input_hw), "schedule": got["schedule"],
               "miout": got["miout"], "miout_max_abs_diff_cpu": dm,
               "base_gops": got["base_gops"], "proposed_gops": got["proposed_gops"],
               "card_s": card_s, "cpu_s": cpu_s}
        out["search"]["x".join(map(str, cfg.input_hw))] = row
        print(json.dumps({"phase": "example_search", **row, **tag}), flush=True)

    # --------------------------------------------------- 3. the LM burst
    out["serve_lm"] = {}
    for arch in serve_lm.ARCHS:
        cpu_params = zoo.get_api(smoke_config(get_config(arch))).init_params(SEED, device="cpu")
        card_params = tu.tree_map(lambda t: t.to(dev), cpu_params)
        runs = {name: serve_lm.serve_burst(arch, params=p, device=d)
                for name, p, d in (("cpu", cpu_params, "cpu"), ("card", card_params, dev))}
        streams = {name: {r.rid: [int(t) for t in r.out] for r in run["done"]}
                   for name, run in runs.items()}
        if streams["card"] != streams["cpu"] or len(streams["card"]) != 12:
            raise AssertionError(f"{arch}: card streams != CPU streams")
        row = {"arch": arch, "requests": 12, "slots": 4, "new_tokens": runs["card"]["new_tokens"],
               "tokens_per_s": runs["card"]["tokens_per_s"], "seconds": runs["card"]["seconds"],
               "cpu_tokens_per_s": runs["cpu"]["tokens_per_s"], "streams_equal_cpu": True}
        out["serve_lm"][arch] = row
        print(json.dumps({"phase": "example_serve_lm", **row, **tag}), flush=True)
        del runs, cpu_params, card_params
    lm_launches = sum(backend.launches.values())
    if lm_launches:
        raise AssertionError(f"the search and the LM bursts launched {dict(backend.launches)}")

    # ------------------- 4. the ANN trainer; its bundle through the convert CLI
    root = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    npz = os.path.join(root, "ann_tiny_yolo.npz")
    backend.reset_launches()
    r = make_ann_fixture.run(steps=EXAMPLE_TRAIN_STEPS, eval_images=EXAMPLE_EVAL_IMAGES,
                             out=npz, device=dev, verbose=False)
    losses = r["losses"]
    first, last = statistics.mean(losses[:20]), statistics.mean(losses[-20:])
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"make_ann_fixture: loss did not fall ({first} -> {last})")
    train_launches = sum(backend.launches.values())
    if train_launches:
        raise AssertionError(f"ANN training launched {dict(backend.launches)}")
    train = {"kernel_launches": train_launches, "steps": EXAMPLE_TRAIN_STEPS, "batch": 6,
             "ms_per_step": r["ms_per_step"], "train_s": r["train_s"],
             "loss_first": losses[0], "loss_last": losses[-1], "loss_first20_mean": first,
             "loss_last20_mean": last, "map": r["map"], "eval_images": r["n_images"],
             "bytes": r["bytes"]}
    print(json.dumps({"phase": "example_make_ann_fixture", **train, **tag}), flush=True)
    t0 = time.perf_counter()
    argv = ["--npz", npz, "--out", os.path.join(root, "converted"), "--conv-exec", "pallas",
            "--eval-images", str(EXAMPLE_EVAL_IMAGES)]
    proc = subprocess.run([sys.executable, "-c", _CONVERT_CHILD, *argv], env=env, cwd=here,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"convert of the card-trained ANN exited {proc.returncode}: "
                             f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    per = [n for ex, n in child["detects"] if ex == "pallas"]
    if not per or any(n != 17 for n in per):
        raise AssertionError(f"convert CLI: fused launches per detect() {child['detects']}; "
                             "want 17")
    convert = {"rc": 0, "seconds": time.perf_counter() - t0, "detects": len(per),
               "fused_launches": sum(per), "fused_launches_per_detect": 17,
               "converted_map": child["map"], "eval_images": EXAMPLE_EVAL_IMAGES}
    print(json.dumps({"phase": "example_convert_cli", **convert, **tag}), flush=True)
    out["ann"] = {"train": train, "convert": convert}

    # ------------------------------------------------- 5. the crossover gate
    ok, msg = check_crossover.check(e2e_full, tolerance=0.05, min_seconds=0.001)
    if not ok:
        raise AssertionError(f"crossover gate at 576x1024: {msg}")
    path = os.path.join(root, "BENCH_torch_e2e.json")
    with open(path, "w") as f:
        json.dump(e2e_full, f)
    proc = subprocess.run([sys.executable, "-m", "repro_torch.benchmarks.check_crossover",
                           "--file", path], env=env, cwd=here, capture_output=True, text=True,
                          timeout=120)
    shutil.rmtree(root)
    if proc.returncode != 0:
        raise AssertionError(f"check_crossover CLI exited {proc.returncode}: {proc.stdout}")
    small = e2e_detector.run(e2e_detector.reduced_config(CROSSOVER_SMALL_HW), batch=1,
                             device=dev, reps=CROSSOVER_SMALL_REPS)
    small_ok, small_msg = check_crossover.check(small, tolerance=0.05, min_seconds=0.001)
    walls = lambda d: {ex: r["wall_s"] * 1e3 for ex, r in d["executors"].items()}  # noqa: E731
    out["crossover"] = {
        "full": {"input_hw": [576, 1024], "ok": ok, "message": msg, "wall_ms": walls(e2e_full),
                 "ratio": e2e_full["executors"]["pallas"]["wall_s"]
                 / e2e_full["executors"]["dense"]["wall_s"], "cli": proc.stdout.strip()},
        "small": {"input_hw": list(CROSSOVER_SMALL_HW), "reading_only": True,
                  "would_pass": small_ok, "message": small_msg, "wall_ms": walls(small),
                  "reps": CROSSOVER_SMALL_REPS, "ratio": small["executors"]["pallas"]["wall_s"]
                  / small["executors"]["dense"]["wall_s"]}}
    print(json.dumps({"phase": "example_crossover", **out["crossover"], **tag}), flush=True)
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

    real_fp = fp.fused_pipeline
    capture, captured = fused_recorder(fp, n_fused)  # frame 0's inputs, for the replay below
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

    # ------------------------------------------------ k. ANN→SNN conversion
    torch.cuda.empty_cache()
    conversion = phase_conversion(dev, tag)
    print(json.dumps({"phase": "elapsed", "after": "k", "s": time.perf_counter() - t_start}),
          flush=True)

    # ---------------------------------------------------- l. LM token serving
    torch.cuda.empty_cache()
    lm = phase_lm(dev, tag)
    print(json.dumps({"phase": "elapsed", "after": "l", "s": time.perf_counter() - t_start}),
          flush=True)

    # -------------------------------------------------------- m. LM training
    torch.cuda.empty_cache()
    lm_train = phase_lm_train(dev, tag)
    print(json.dumps({"phase": "elapsed", "after": "m", "s": time.perf_counter() - t_start}),
          flush=True)

    # ------------------------------------------ n. multi-process execution
    gc.collect()
    torch.cuda.empty_cache()
    multi = phase_multiprocess(dev, tag, fp.KERNEL)
    print(json.dumps({"phase": "elapsed", "after": "n", "s": time.perf_counter() - t_start}),
          flush=True)

    # ------------------------------------------------ o. the other LM families
    gc.collect()
    torch.cuda.empty_cache()
    families = phase_lm_families(dev, tag)
    print(json.dumps({"phase": "elapsed", "after": "o", "s": time.perf_counter() - t_start}),
          flush=True)

    # ------------------------------------------------ p. the tile autotuner
    gc.collect()
    torch.cuda.empty_cache()
    tuned = phase_autotune(dev, det, frames, captured, tag)
    print(json.dumps({"phase": "elapsed", "after": "p", "s": time.perf_counter() - t_start}),
          flush=True)

    # ------------------------------------------------------- q. the dry-run
    dry = phase_dryrun(dev, det, frames, lm, lm_train, families, tag)
    print(json.dumps({"phase": "elapsed", "after": "q", "s": time.perf_counter() - t_start}),
          flush=True)

    # ------------------------------------------ r. the developer entry points
    gc.collect()
    torch.cuda.empty_cache()
    examples = phase_examples(dev, benches["e2e"], tag)
    print(json.dumps({"phase": "elapsed", "after": "r", "s": time.perf_counter() - t_start}),
          flush=True)

    # ------------------------------------------------ s. sharded training state
    gc.collect()
    torch.cuda.empty_cache()
    sharded = phase_fsdp(dev, tag)
    print(json.dumps({"phase": "elapsed", "after": "s", "s": time.perf_counter() - t_start}),
          flush=True)

    # ------------------------------- t. the audio and vlm families' train step
    gc.collect()
    torch.cuda.empty_cache()
    phase_modal_train(dev, tag)
    print(json.dumps({"phase": "elapsed", "after": "t", "s": time.perf_counter() - t_start}),
          flush=True)
    sharded_launches = multi["sharded_eval"]["launches"]
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
        "per": f"one frame of batch {BATCH}: sum over the {len(layers)} fused layers, each "
               "at its plan's tile (the committed autotune cache)",
        "tile_argument": "launch_named: one of 6 tiles by index, -1 = the shape rule",
        "sum_27_tuned_ms": tuned["sum_27_tuned_ms"],
        "sum_27_untuned_ms": tuned["sum_27_untuned_ms"],
        "autotune_frame_ms": tuned["frame"],
        "autotune_candidates_bit_equal": tuned["candidates_checked"],
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
        "launches_lm_serving": lm["kernel_launches"],
        "launches_lm_training": lm_train["kernel_launches"],
        "launches_lm_families": families["kernel_launches"],
        "launches_fsdp_training": sharded["kernel_launches"],
        "launches_pipeline_per_detect": pipeline["fused_launches_per_detect"],
        "pipeline_uniform_t3_ms": pipeline["uniform_t3_kernel_ms"],
        "pipeline_uniform_t3_plain_ms": pipeline["uniform_t3_plain_ms"],
        "launches_conversion_fixture": conversion["fixture"]["launches"].get(fp.KERNEL, 0),
        "launches_conversion_fixture_per_detect":
            conversion["fixture"]["fused_launches_per_detect"],
        "conversion_t128_ms": conversion["fixture"]["fused_ms_per_detect"]["ms"],
        "conversion_t128_plain_ms": conversion["fixture"]["fused_ms_per_detect"]["plain_ms"],
        "conversion_t128_bound_ms": conversion["fixture"]["fused_ms_per_detect"]["bound_ms"],
        "conversion_t128_per": f"one detect() of the converted fixture, batch "
                               f"{conversion['fixture']['batch']}, 96x160: sum over its "
                               f"{conversion['fixture']['fused_launches_per_detect']} fused layers",
        "launches_conversion_full_width": conversion["full_width"]["launches"].get(fp.KERNEL, 0),
        "conversion_t64_ms": conversion["full_width"]["fused_ms_per_detect"]["ms"],
        "conversion_t64_bound_ms": conversion["full_width"]["fused_ms_per_detect"]["bound_ms"],
        "conversion_t64_per": f"one detect() of the COCO-calibrated CONFIG conversion, batch "
                              f"{conversion['full_width']['batch']}, 576x1024: sum over its 27 "
                              "fused layers",
        "launches_sharded_eval": sharded_launches.get(fp.KERNEL, 0),
        "launches_sharded_eval_per_detect":
            sharded_launches.get(fp.KERNEL, 0) / multi["sharded_eval"]["detects"],
        "sharded_eval_per": f"both processes of the sharded evaluation ({SHARD_IMAGES} images, "
                            f"{SHARD_SHARDS} shards, 576x1024), their timed run",
        "launches_example_convert_cli": examples["ann"]["convert"]["fused_launches"],
        "launches_example_convert_cli_per_detect":
            examples["ann"]["convert"]["fused_launches_per_detect"],
        "example_convert_cli_per": "launch.convert --conv-exec pallas in a subprocess on the "
                                   f"ANN make_ann_fixture trained on the card "
                                   f"({EXAMPLE_TRAIN_STEPS} steps), {EXAMPLE_EVAL_IMAGES} val "
                                   "images",
        "launches_example_train": examples["ann"]["train"]["kernel_launches"],
        "crossover_576x1024": examples["crossover"]["full"]["message"],
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
        "launches_lm_serving": lm["kernel_launches"],
        "launches_lm_training": lm_train["kernel_launches"],
        "launches_lm_families": families["kernel_launches"],
        "launches_fsdp_training": sharded["kernel_launches"],
        "launches_sharded_eval": sharded_launches.get("gated_one_to_all", 0),
        "launches_quickstart": examples["quickstart"]["launches"],
        "quickstart_ms": examples["quickstart"]["ms"],
        "quickstart_plain_ms": examples["quickstart"]["plain_ms"],
        "quickstart_bound_ms": examples["quickstart"]["bound_ms"],
        "quickstart_per": f"launch.quickstart's step 5: one launch on "
                          f"{tuple(examples['quickstart']['tile'])} spikes, stage4/main_a's "
                          "pruned int8 weights",
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
        "launches_lm_serving": lm["kernel_launches"],
        "launches_lm_training": lm_train["kernel_launches"],
        "launches_lm_families": families["kernel_launches"],
        "launches_fsdp_training": sharded["kernel_launches"],
        "launches_sharded_eval": sharded_launches.get("spike_lif", 0),
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
        "launches_lm_serving": lm["kernel_launches"],
        "launches_lm_training": lm_train["kernel_launches"],
        "launches_lm_families": families["kernel_launches"],
        "launches_fsdp_training": sharded["kernel_launches"],
        "launches_sharded_eval": sharded_launches.get("bitmask_matmul", 0),
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
