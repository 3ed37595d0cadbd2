"""Detection-serving benchmark: frame streams through the megabatched Engine.
Counterpart of ``benchmarks/serve_bench.py``; two sections:

* ``executors`` — for each conv executor, compiles the detector once,
  serves a fixed set of concurrent :class:`FrameRequest` streams through
  the Engine's continuous-batching loop and records frames/s and the
  per-tick latency percentiles (first tick left out). Every executor's
  served heads must equal the dense executor's exactly.

* ``load`` — N fully resident concurrent streams, one engine tick per
  frame, through the kernel executor: frames/s, per-stream fps, tick
  p50/p95/p99 (host wall). The port adds, per row: the host ms of each
  tick and of each frame upload (assembly into pinned memory and the
  copy's issue); the device ms between CUDA events around each tick's
  ``masked_step``; the device ms of one steady ``masked_step`` (every row
  active, none joining) queued behind a spin kernel (the device alone, the
  host's issue time hidden), and that step's device time by kernel
  (``torch.profiler``); the peak device memory. A sample of served streams
  must be bit-identical to solo ``DetectorSession`` replays.

Any failed check raises. On the CPU (``--device cpu``) the kernels run
their plain versions and no device time is recorded.

  PYTHONPATH=src python -m repro_torch.benchmarks.serve_bench [--device cpu]
      [--streams 64 256] [--frames N] [--fast] [--out BENCH_torch_serve.json]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import backend
from repro_torch.configs.snn_det import smoke_config
from repro_torch.models import snn_yolo as sy
from repro_torch.serve import AdmissionPolicy, Engine, FrameRequest
from repro_torch.serve.detector import demo_weights, step_latency_ms, synth_streams

# served heads must equal the dense executor's bit for bit: every executor
# accumulates integers and scales them the same way
PARITY_ATOL = 0.0
EXECUTORS = ("dense", "gated", "pallas")
LOAD_EXECUTOR = "pallas"  # the kernel executor: the fused kernel does the convs
TOP_KERNELS = 15  # kernels listed in a load row's device-time breakdown


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def queued_device_ms(fn, dev: torch.device) -> float:
    """Device ms of one call of ``fn`` with the host out of the way: the
    call is queued behind a spin kernel, and the CUDA events around it time
    the device alone. ``fn`` must not wait for the device."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for cycles in (2e8, 1e9, 5e9):
        torch.cuda._sleep(int(cycles))
        start.record()
        fn()
        stop.record()
        ahead = not start.query()  # still spinning: the whole call was queued
        torch.cuda.synchronize(dev)
        if ahead:
            return start.elapsed_time(stop)
    raise AssertionError("the host could not queue one masked_step ahead of the device")


def kernel_breakdown(fn, dev: torch.device) -> dict | None:
    """Device time of one call of ``fn`` by kernel, from ``torch.profiler``
    (CUPTI): the total, the ``TOP_KERNELS`` kernels by time, as [name, ms,
    launches], and the fused pipeline kernel's ms over all its tiles. None
    when the profiler recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    rows = []
    for avg in prof.key_averages():
        us = getattr(avg, "self_device_time_total", None)
        if us is None:  # older releases name it after CUDA
            us = getattr(avg, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append([avg.key[:160], us / 1e3, avg.count])
    if not rows:
        return None
    rows.sort(key=lambda r: -r[1])
    return {"total_ms": sum(r[1] for r in rows), "kernels": rows[:TOP_KERNELS],
            "kernel_launches": sum(r[2] for r in rows),
            "fused_pipeline_ms": sum(r[1] for r in rows if "fused_pipeline_kernel" in r[0])}


def run_executors(cfg, params, bn, streams, *, slots: int, device) -> dict:
    """The ``executors`` section (see the module docstring)."""
    out, heads = {}, {}
    for ex in EXECUTORS:
        det = sy.compile_detector(dataclasses.replace(cfg, conv_exec=ex), params, bn,
                                  device=device)
        eng = Engine(det, n_slots=slots)
        reqs = [FrameRequest(rid=r, frames=s) for r, s in enumerate(streams)]
        for fr in reqs:
            eng.submit(fr)
        t0 = time.perf_counter()
        done = eng.run()
        dt = time.perf_counter() - t0
        if len(done) != len(streams) or done.status != "drained":
            raise AssertionError(f"{ex}: {len(done)} of {len(streams)} served, {done.status}")
        heads[ex] = {fr.rid: np.stack(fr.heads) for fr in reqs}
        diff = max(float(np.abs(heads[ex][rid] - heads["dense"][rid]).max())
                   for rid in heads[ex])
        if not diff <= PARITY_ATOL:
            raise AssertionError(f"{ex} served heads diverge from dense: {diff}")
        frames = sum(len(s) for s in streams)
        out[ex] = {"frames_per_s": frames / dt, "wall_s": dt,
                   **step_latency_ms(eng.core.step_wall), "max_abs_diff_vs_dense": diff}
        r = out[ex]
        print(f"  {ex:7s} {r['frames_per_s']:9.1f} frames/s  p50 {r['step_p50_ms']:8.2f}ms  "
              f"p95 {r['step_p95_ms']:8.2f}ms  p99 {r['step_p99_ms']:8.2f}ms  "
              f"max|Δ| vs dense {diff:.2e}", flush=True)
    return out


def run_load(det, *, n_streams: int, frames: int, parity_streams: int) -> dict:
    """The ``load`` section for one N: ``det`` (a compiled detector, the
    kernel executor) serves N resident streams of ``frames`` frames."""
    dev = det.device
    rng = np.random.default_rng(1234 + n_streams)
    streams = synth_streams(rng, n_streams, frames, det.cfg.input_hw)
    eng = Engine(det, n_slots=n_streams, admission=AdmissionPolicy(max_queue=n_streams))
    reqs = [FrameRequest(rid=r, frames=s) for r, s in enumerate(streams)]
    for fr in reqs:
        if not eng.submit(fr):
            raise AssertionError(f"stream {fr.rid} refused at submit")
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    done = eng.run()
    dt = time.perf_counter() - t0
    if len(done) != n_streams or done.status != "drained":
        raise AssertionError(f"load {n_streams}: {len(done)} served, {done.status}")
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None

    # megabatched streams against independent per-stream session replays
    for fr in reqs[:parity_streams]:
        solo = det.new_session(batch=1)
        for k, f in enumerate(fr.frames):
            ref = solo.step(f[None]).head[0].cpu().numpy()
            diff = float(np.abs(fr.heads[k] - ref).max())
            if not diff <= PARITY_ATOL:
                raise AssertionError(f"stream {fr.rid} frame {k}: megabatched head diverges "
                                     f"from a solo DetectorSession replay by {diff}")

    busy_ms = by_kernel = None
    if cuda:  # one steady full-bucket masked_step (every row active, none cold)
        x = torch.from_numpy(np.stack([s[0] for s in streams])).to(dev)
        mem = det.zero_state(n_streams)
        on = torch.ones((n_streams,), dtype=torch.bool, device=dev)
        det.masked_step(x, mem, on)
        torch.cuda.synchronize(dev)
        busy_ms = queued_device_ms(lambda: det.masked_step(x, mem, on), dev)
        by_kernel = kernel_breakdown(lambda: det.masked_step(x, mem, on), dev)
        del x, mem

    lat = step_latency_ms(eng.core.step_wall)
    dev_ms = eng.core.step_device_ms[1:] or eng.core.step_device_ms
    rec = {
        "n_streams": n_streams,
        "frames_per_stream": frames,
        "wall_s": dt,
        "frames_per_s": n_streams * frames / dt,
        "per_stream_fps": frames / dt,
        "tick_p50_ms": lat["step_p50_ms"],
        "tick_p95_ms": lat["step_p95_ms"],
        "tick_p99_ms": lat["step_p99_ms"],
        "tick_host_ms": [w * 1e3 for w in eng.core.step_wall],
        "upload_host_ms": [w * 1e3 for w in eng.core.upload_wall],
        "tick_device_ms": list(eng.core.step_device_ms) if cuda else None,
        "tick_device_p50_ms": float(np.percentile(dev_ms, 50)) if cuda else None,
        "masked_step_device_ms": busy_ms,
        "masked_step_by_kernel": by_kernel,
        "peak_memory_bytes": peak,
        "parity_streams": parity_streams,
        "max_abs_diff_vs_session": 0.0,
        "device": _device_name(dev),
    }
    dev_note = ("" if not cuda else f"  device p50 {rec['tick_device_p50_ms']:8.2f}ms  "
                f"alone {busy_ms:8.2f}ms  peak {peak / 2**30:6.2f} GiB")
    print(f"  load {n_streams:5d} streams  {rec['frames_per_s']:8.1f} frames/s "
          f"({rec['per_stream_fps']:6.2f} fps/stream)  tick p50 {rec['tick_p50_ms']:8.2f}ms  "
          f"p95 {rec['tick_p95_ms']:8.2f}ms  p99 {rec['tick_p99_ms']:8.2f}ms  upload p50 "
          f"{float(np.median(rec['upload_host_ms'])):7.2f}ms{dev_note}", flush=True)
    return rec


def run(cfg=None, *, device=None, requests: int = 8, slots: int = 4, frames: int = 2,
        load_streams=(64, 256), load_frames: int = 4, parity_streams: int = 3,
        out_json: str | None = None) -> dict:
    """Both sections at ``cfg`` (default: ``smoke_config()``, as the JAX
    benchmark) on ``device`` (default: the card)."""
    dev = backend.resolve_device(device)
    cfg = smoke_config() if cfg is None else cfg
    params, bn, rng = demo_weights(cfg, device=dev)
    streams = synth_streams(rng, requests, frames, cfg.input_hw)
    results: dict = {
        "config": {"requests": requests, "slots": slots, "frames_per_stream": frames,
                   "input_hw": list(cfg.input_hw), "load_streams": list(load_streams),
                   "load_frames": load_frames, "load_executor": LOAD_EXECUTOR},
        "device": _device_name(dev),
        "executors": run_executors(cfg, params, bn, streams, slots=slots, device=dev),
        "load": {},
    }
    det = sy.compile_detector(dataclasses.replace(cfg, conv_exec=LOAD_EXECUTOR), params, bn,
                              device=dev)
    for n in load_streams:
        results["load"][str(n)] = run_load(det, n_streams=n, frames=load_frames,
                                           parity_streams=parity_streams)
    if out_json:
        with open(out_json, "w") as f:
            json.dump(results, f, indent=1)
        print(f"  wrote {out_json}")
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--streams", type=int, nargs="*", default=None,
                    help="concurrent-stream counts for the load section (default: 64 256)")
    ap.add_argument("--frames", type=int, default=None,
                    help="frames per stream in the load section")
    ap.add_argument("--fast", action="store_true",
                    help="smoke sizes: 64 streams of 2 frames, 2 parity samples")
    ap.add_argument("--out", default="BENCH_torch_serve.json", help="output JSON path")
    args = ap.parse_args(argv)
    kw: dict = {"out_json": args.out, "device": args.device}
    if args.fast:
        kw.update(load_streams=(64,), load_frames=2, parity_streams=2)
    if args.streams is not None:
        kw["load_streams"] = tuple(args.streams)
    if args.frames is not None:
        kw["load_frames"] = args.frames
    return run(**kw)


if __name__ == "__main__":
    main()
