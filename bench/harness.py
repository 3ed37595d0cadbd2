"""One run of one cell: set-up, the measured window, the trace, the
comparison with the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by its name in ``BENCHMARK.json``: the configuration's
file (its ``family`` names the module under ``bench/families/`` that
builds the system and its reference), ``bench/traffic/<traffic>.json``
and ``bench/metrics/<metric>.py``.
"""
from __future__ import annotations

import gc
import importlib
import json
import os
import random
import time
from dataclasses import dataclass, field

import torch

from bench import check, stats, trace as tracing
from bench.workload import ClosedLoop, Traffic, frame_pool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names
TRACE_SECONDS = 5.0  # the traced slice at the start of a traced window


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find_cell(spec: dict, workload: str, root: str = ROOT) -> dict:
    """The cell's entries, its configuration's file and its traffic file."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "bench", "traffic", f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)

    def reported(metric):
        return "workloads" not in metric or workload in metric["workloads"]

    return {"cell": cell, "config": config, "traffic": Traffic.from_json(traffic),
            "end_to_end": [m for m in spec["end_to_end"] if reported(m)],
            "per_layer": [m for m in spec["per_layer"] if reported(m)]}


def metric_reader(name: str):
    return importlib.import_module(f"bench.metrics.{name}").read


def forbidden_modules() -> list:
    import sys

    return sorted({k.split(".")[0] for k in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Window:
    """What a measured (or traced) window read: the readers' input."""

    seconds: float
    ticks: list  # host wall of each tick, s
    frames: int
    step_wall: list = field(default_factory=list)
    upload_wall: list = field(default_factory=list)
    step_device_ms: list = field(default_factory=list)
    launches: dict = field(default_factory=dict)
    batches: list = field(default_factory=list)  # capacity of each tick's step
    model: dict = field(default_factory=dict)
    nnz: dict = field(default_factory=dict)
    trace: object = None  # tracing.Trace
    prepare_s: float = 0.0  # the program's conversion and compile, host seconds


class Clients:
    """The closed loop over the program's engine: each finished request's
    client submits its next."""

    def __init__(self, engine, traffic: Traffic, pool, seed: int):
        from repro_torch.serve.detector import FrameRequest

        self.engine = engine
        self.loop = ClosedLoop(traffic, pool, seed)
        self.make = FrameRequest
        self.requests = {}  # rid -> (client, request)
        self.seen = 0  # engine.finished entries handled
        for rid, client, frames in self.loop.first():
            self._submit(rid, client, frames)

    def _submit(self, rid, client, frames):
        req = self.make(rid=rid, frames=frames)
        self.requests[rid] = (client, req)
        if not self.engine.submit(req):
            raise RuntimeError(f"request {rid} refused: {self.engine.rejected[-1:]}")

    def tick(self) -> float:
        """One engine tick; returns its host wall in seconds."""
        t0 = time.perf_counter()
        self.engine.run(max_steps=1)
        wall = time.perf_counter() - t0
        done = self.engine.finished
        for req in done[self.seen:]:
            self._submit(*self.loop.next(self.requests[req.rid][0]))
        self.seen = len(done)
        return wall

    def frames_delivered(self) -> int:
        return sum(len(req.out) for _, req in self.requests.values())


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device="cuda",
             t_start: float | None = None, config_override=None,
             fault=None, after=None) -> tuple[dict, list]:
    """Run one cell; returns (the result object, the checks' lines).

    ``config_override``: a function of the configuration's dict that returns
    the one to run (tests shrink it); ``fault``: a function of the compiled
    detector that breaks its timed path (tests); ``after``: a function of
    (system, reference, configuration, sampled outputs, device, traffic)
    whose value the result keeps under "after" (the control's readings)."""
    from repro_torch import backend
    from repro_torch.serve.detector import FrameRequest
    from repro_torch.serve.engine import Engine

    t_start = time.perf_counter() if t_start is None else t_start
    found = find_cell(load_spec(), workload)
    config, traffic = found["config"], found["traffic"]
    if config_override is not None:
        config = config_override(config)
    family = importlib.import_module(f"bench.families.{config['family']}")
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    t_system = time.perf_counter()
    system = family.System(config, seed, dev)
    t_prepare = time.perf_counter()
    det = system.compile()
    backend.synchronize(dev)
    prepare_s = time.perf_counter() - t_prepare
    if fault is not None:
        fault(det)
    t_pool = time.perf_counter()
    pool = frame_pool(traffic.pool_frames, system.m["input_hw"], seed, dev)
    t_warm = time.perf_counter()
    engine = Engine(det, n_slots=traffic.n_slots)
    if traffic.warmup_frames:  # one wave that joins, runs and leaves
        loop = ClosedLoop(traffic, pool, seed)
        for rid, _, frames in loop.first():
            engine.submit(FrameRequest(rid=-1 - rid, frames=frames[:traffic.warmup_frames]))
        engine.run()
        engine.finished.clear()
    clients = Clients(engine, traffic, pool, seed)
    for _ in range(traffic.warmup_ticks):
        clients.tick()
    backend.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    phases = {"imports": t_system - t_start, "weights": t_prepare - t_system,
              "prepare": prepare_s, "pool": t_warm - t_pool,
              "warm-up": t_start + setup_s - t_warm}

    core = engine.core
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    def snapshot(n_ticks, t):
        return {"ticks": n_ticks, "frames": clients.frames_delivered(), "t": t,
                "walls": (len(core.step_wall), len(core.upload_wall), len(core.step_device_ms)),
                "launches": dict(backend.launches),
                "batches": len(spans.batches) if spans else 0}

    spans = tracing.Spans(det, core) if trace else None
    before = {rid: len(req.out) for rid, (_, req) in clients.requests.items()}
    prof = tracing.start(cuda) if trace else None
    tracing_on = prof is not None
    ticks, t0 = [], time.perf_counter()
    first = snapshot(0, 0.0)
    last = None
    while time.perf_counter() - t0 < seconds:
        ticks.append(clients.tick())
        if tracing_on and time.perf_counter() - t0 >= TRACE_SECONDS:
            last = snapshot(len(ticks), time.perf_counter() - t0)
            tracing.halt(prof)
            tracing_on = False
    window_s = time.perf_counter() - t0
    if tracing_on:  # the window ended before the traced slice did
        last = snapshot(len(ticks), window_s)
        tracing.halt(prof)
    frames = clients.frames_delivered() - first["frames"]
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if spans is not None:
        spans.remove()

    result = {"correct": False, "attempted": frames, "failed": 0, "metrics": {}}
    if trace:
        (a, b, c), (a1, b1, c1) = first["walls"], last["walls"]
        w = Window(seconds=last["t"], ticks=ticks[:last["ticks"]],
                   frames=last["frames"] - first["frames"],
                   step_wall=core.step_wall[a:a1], upload_wall=core.upload_wall[b:b1],
                   step_device_ms=core.step_device_ms[c:c1],
                   launches={k: v - first["launches"].get(k, 0)
                             for k, v in last["launches"].items()},
                   batches=spans.batches[:last["batches"]], model=system.m,
                   trace=tracing.read(prof), prepare_s=prepare_s)
    else:
        w = Window(seconds=window_s, ticks=ticks, frames=frames)
    e2e = {"frames_per_s": lambda: stats.rate(frames, window_s),
           "tick_p95_ms": lambda: stats.percentile_ms(ticks, 95),
           "peak_mem_gib": lambda: peak / 2**30,
           "setup_s": lambda: setup_s}

    # the program's outputs; then its state goes before the reference runs
    outputs = {rid: (req.frames, list(req.out), list(req.heads))
               for rid, (_, req) in clients.requests.items() if req.out}
    in_window = sorted(rid for rid, (_, req) in clients.requests.items()
                       if len(req.out) > before.get(rid, 0))
    del engine, clients, core, det, pool
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    rng = random.Random(seed)
    sample = sorted(rng.sample(in_window, min(traffic.compare_requests, len(in_window))))
    ref = system.reference()
    w.nnz = ref.nnz()
    if trace:
        for m in found["per_layer"]:
            value = metric_reader(m["name"])(w)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = w.trace.breakdown()
    else:
        for m in found["end_to_end"]:
            result["metrics"][m["name"]] = {"value": e2e[m["name"]](), "unit": m["unit"]}
    sampled = [outputs[r] for r in sample]
    readings = check.compare(ref, config, sampled, dev, batch=traffic.reference_batch)
    if after is not None:
        result["after"] = after(system, ref, config, sampled, dev, traffic)
    checks = check.judge(readings, config["limits"])
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        result["device"].update(busy_s=w.trace.busy_s, window_s=w.trace.window_s)
    result["checks"] = checks
    # diagnostics first: where set-up went, and the window's ticks
    lines = ["set-up s: " + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())]
    if len(ticks) >= 4:
        q = [stats.percentile_ms(ticks, p) for p in (50, 90, 95, 99, 100)]
        lines.append(f"ticks {len(ticks)}, ms p50/p90/p95/p99/max: "
                     + " ".join(f"{v:.2f}" for v in q))
    lines.append(f"compared {sum(len(h) for _, _, h in sampled)} frames of {len(sampled)} requests")
    lines += [f"{k} {c['value']!r} limit {c['limit']!r}" for k, c in checks.items()]
    return result, lines
