"""The traced run: spans around the calls into the program's layers, the
profiler over the card, and what the trace says.

Spans are recorded from here, around the calls (``torch.profiler.
record_function``): the engine's tick, admission, the frame upload, the
compiled detector's step and the postprocess. The device's activity comes
from the profiler's chrome trace, written to ``TMPDIR`` and deleted once
read: each kernel, copy and fill with its start and length.
"""
from __future__ import annotations

import functools
import json
import os
import tempfile

import torch

# the program's hand-written CUDA kernels, by the names they launch under
PORT_KERNELS = ("fused_pipeline_kernel", "gated_one_to_all_kernel", "fused_lif_kernel",
                "bitmask_matmul_kernel", "split_sum_kernel")
FUSED_KERNEL = "fused_pipeline_kernel"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10  # entries of each breakdown list


def _spanned(name, fn, on_call=None):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if on_call is not None:
            on_call(*args, **kwargs)
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapper


class Spans:
    """Wraps the engine core's and the detector's entry points with spans
    for the traced run, and records each step's capacity."""

    def __init__(self, det, core):
        from repro_torch.serve import detector as sd

        self.batches: list = []
        self._module = sd
        self._post = sd.postprocess
        self._patched = []
        for obj, attr, name, rec in (
                (core, "admit", "engine.admit", None),
                (core, "step", "engine.step", None),
                (core, "_upload", "core.upload", None),
                (det, "masked_step", "detector.masked_step",
                 lambda frames, *a, **k: self.batches.append(int(frames.shape[0])))):
            setattr(obj, attr, _spanned(name, getattr(obj, attr), rec))
            self._patched.append((obj, attr))
        sd.postprocess = _spanned("postprocess", self._post)

    def remove(self):
        for obj, attr in self._patched:
            delattr(obj, attr)
        self._module.postprocess = self._post


def start(cuda: bool):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


def halt(prof) -> None:
    """Stop recording; :func:`read` reads what was recorded."""
    prof.__exit__(None, None, None)


def read(prof) -> "Trace":
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return Trace(events)


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """Device intervals and host spans of a traced slice (times in us)."""

    def __init__(self, events: list):
        dev, spans = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            ts, dur = float(e["ts"]), float(e["dur"])
            if e.get("cat") in DEVICE_CATS:
                dev.append((e["name"], e.get("cat"), ts, dur))
            elif e.get("cat") == "user_annotation":
                spans.append((e["name"], ts, ts + dur))
        ticks = [s for s in spans if s[0] == "engine.step"]
        if ticks:
            self.t0 = min(s[1] for s in spans)
            self.t1 = max(s[2] for s in spans)
        else:
            self.t0 = min((d[2] for d in dev), default=0.0)
            self.t1 = max((d[2] + d[3] for d in dev), default=0.0)
        self.device = dev
        self.spans = spans

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def _busy(self):
        return _union((max(ts, self.t0), min(ts + d, self.t1)) for _, _, ts, d in self.device
                      if ts + d > self.t0 and ts < self.t1)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._busy()) * 1e-6

    def kernel_s(self, match=None, exclude=()) -> float:
        """Device seconds of kernels whose name contains ``match`` (all
        kernels when None) and none of ``exclude``."""
        return sum(d for name, cat, _, d in self.device if cat == "kernel"
                   and (match is None or match in name)
                   and not any(x in name for x in exclude)) * 1e-6

    def breakdown(self) -> dict:
        by_op: dict = {}
        for name, _, _, d in self.device:
            by_op[name] = by_op.get(name, 0.0) + d * 1e-6
        gaps: dict = {}
        busy = self._busy()
        edges = [self.t0] + [x for s, e in busy for x in (s, e)] + [self.t1]
        # one sweep over span edges and gap starts; host spans nest, so the
        # innermost open span is the top of a stack
        points = [(s, 1, i) for i, (_, s, _) in enumerate(self.spans)]
        points += [(e, 0, i) for i, (_, _, e) in enumerate(self.spans)]
        points += [(s, 2, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
        stack: list = []
        for t, kind, x in sorted(points):
            if kind == 1:
                stack.append(x)
            elif kind == 0:
                if x in stack:
                    stack.remove(x)
            else:
                name = self.spans[stack[-1]][0] if stack else "between ticks"
                gaps[name] = gaps.get(name, 0.0) + (x - t) * 1e-6
        top = lambda d: [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(by_op), "idle_gaps": top(gaps)}
