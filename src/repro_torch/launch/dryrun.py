"""Dry-run: the cost of every (architecture × input-shape) cell's step on a
mesh, counted on ``meta`` tensors, with its roofline terms on the H100.

Counterpart of ``repro/launch/dryrun.py``. Where JAX lowers and compiles
each cell against 256 or 512 placeholder devices and reads the HLO, the
port builds the same step (the train step with the preset's microbatches
and int8 moments, the prefill, or the decode) on the ``meta`` device and
counts the operations it dispatches (:mod:`repro_torch.launch.op_cost`) at
the per-device batch (global batch ÷ the batch axes). For each cell:

  1. FLOPs, bytes and collective bytes per device; a model's stacked
     layers are counted at two depths and extrapolated
     (``op_cost.extrapolate``) — every layer does the same work, so FLOPs
     are exact and a train step's bytes within 1% — and the train step's
     update (sliced by the depth) at full depth;
  2. the static bytes per device (parameters, optimizer state, cache),
     exact, from the logical-axis specs (``sharding.shard_shape``), and
     whether they fit in 80 GB (the card's own memory where it runs on
     one); activations are not counted;
  3. the roofline terms on the H100's published peaks (989 TFLOP/s dense
     bf16, 3.35 TB/s HBM, 450 GB/s NVLink each way; SXM part at 700 W), the
     dominant term and the useful-FLOPs ratio (MODEL_FLOPS = 6·N·D train,
     2·N·D prefill/decode, over the FLOPs counted on every device).

Meshes: ``h100`` (one card), ``h100x4`` (four cards of one host, a data
axis), and the reference's ``single`` (data 16 × model 16) and ``multi``
(pod 2 × 16 × 16) shapes for the configs no four cards hold. The port runs
no tensor-parallel step: on a mesh with a model axis, FLOPs and bytes are
split evenly over it, and the artifact says so. The JAX package's
``launch/mesh.py`` builds device meshes and has no counterpart: these are
:class:`~repro_torch.distributed.sharding.MeshShape` constants.

    python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k --mesh h100
    python -m repro_torch.launch.dryrun --all [--mesh all]

Each cell writes ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``
(or a ``skipped`` record) for ``repro_torch.benchmarks.roofline``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch

from repro_torch import tree as tu
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed import sharding as shd
from repro_torch.launch import op_cost
from repro_torch.models import zoo
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer

# NVIDIA H100 SXM, data sheet, at its 700 W power limit (roofline denominators)
PEAK_FLOPS = 989e12  # dense bf16 FLOP/s per card
HBM_BW = 3.35e12  # bytes/s per card
LINK_BW = 450e9  # NVLink bytes/s per card, each way
HBM_BYTES = 80e9  # bytes per card

MESHES = {
    "h100": shd.MeshShape(("data", "model"), (1, 1)),
    "h100x4": shd.MeshShape(("data", "model"), (4, 1)),
    "single": shd.MeshShape(("data", "model"), (16, 16)),
    "multi": shd.MeshShape(("pod", "data", "model"), (2, 16, 16)),
}
OUT_DIR = os.path.join("artifacts", "dryrun_torch")

# per-arch training presets (the JAX package's): microbatches at
# global_batch=256 and whether the optimizer moments are int8
TRAIN_PRESETS = {
    "qwen1.5-0.5b": (2, False),
    "whisper-small": (2, False),
    "rwkv6-3b": (4, False),
    "olmoe-1b-7b": (4, True),
    "deepseek-moe-16b": (4, True),
    "zamba2-7b": (4, True),
    "qwen1.5-32b": (4, True),
    "llava-next-34b": (4, True),
    "qwen1.5-110b": (4, True),
    "llama3-405b": (4, True),
}
EXTRAPOLATED = ("dense", "moe", "vlm", "ssm", "hybrid")  # families counted at two depths


def exact_param_count(cfg) -> int:
    params = zoo.get_api(cfg).init_params(0, device="meta")
    return sum(t.numel() for t in tu.leaves(params))


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE); D = tokens the
    step processes (decode: one token per sequence)."""
    n = exact_param_count(cfg)
    if cfg.family == "moe":
        n = int(n * cfg.n_active_params() / max(cfg.n_params(), 1))
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def batch_shards(mesh: shd.MeshShape, global_batch: int) -> int:
    """Devices the batch is split over (the rules' 'batch' axes), or 1 where
    they do not divide it (long_500k's batch of 1 stays whole)."""
    n = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            n *= mesh.shape[a]
    return n if global_batch % n == 0 else 1


def model_shards(mesh: shd.MeshShape) -> int:
    return mesh.shape.get("model", 1)


class _DataParallel:
    """The multi-controller context a data-parallel step sees; its
    all-reduce is the counting stand-in's."""

    is_multi_controller = True
    backend = "nccl"

    def __init__(self, n: int):
        self.n_hosts = n


def _train_parts(cfg, shape: ShapeSpec, n_data: int, n_microbatch: int | None = None):
    """The train step's pieces on meta tensors: (the whole step as
    ``make_train_step`` builds it, its gradient part, its update part —
    ``trainer.finish_step`` on zero gradients —, meta). ``n_microbatch``:
    the preset's count unless given."""
    api = zoo.get_api(cfg)
    params = api.init_params(0, device="meta")
    batch = zoo.input_specs(cfg, shape)["batch"]
    n_mb, int8 = TRAIN_PRESETS.get(cfg.arch_id, (8, False))
    n_mb = min(n_microbatch or n_mb, shape.global_batch)
    ocfg = opt.AdamWConfig(int8_moments=int8)
    ctx = _DataParallel(n_data) if n_data > 1 else None
    grad_specs = shd.tree_specs(api.param_axes(), shd.default_rules(
        shd.MeshShape(("data", "model"), (n_data, 1)), fsdp=cfg.fsdp))
    step = trainer.make_train_step(api.loss_fn, ocfg, n_microbatch=n_mb,
                                   grad_shardings=grad_specs, ctx=ctx)

    state = trainer.init_train_state(params, ocfg)  # built before counting: not the step's
    dt = (lambda p: torch.float32) if n_mb > 1 else (lambda p: p.dtype)
    zero_grads = tu.tree_map(lambda p: torch.empty(p.shape, dtype=dt(p), device="meta"), params)
    loss = torch.empty((), dtype=torch.float32, device="meta")

    def whole():
        return step(state, batch)

    def grads():
        return trainer.loss_and_grads(api.loss_fn, params, batch, n_microbatch=n_mb)

    def update():
        return trainer.finish_step(state, loss, zero_grads, ocfg, ctx=ctx)

    return whole, grads, update, {"step": "train_step", "n_microbatch": n_mb,
                                  "int8_moments": int8}


def _serve_step(cfg, shape: ShapeSpec):
    """(fn, meta): ``fn()`` runs the cell's prefill or decode on meta tensors."""
    api = zoo.get_api(cfg)
    params = api.init_params(0, device="meta")
    specs = zoo.input_specs(cfg, shape)
    if shape.kind == "prefill":
        return (lambda: api.prefill_fn(params, *specs["args"])), {"step": "prefill"}
    # the write position as the port's engines pass it, a host int: the
    # last row of the populated cache
    pos = shape.seq_len - 1
    return (lambda: api.decode_fn(params, specs["cache"], specs["token"], pos)), {
        "step": "serve_step(decode)"}


def _with_depth(cfg, units: int):
    """``cfg`` cut to ``units`` repeated units: layers, or the hybrid's
    super-layers (its tail kept)."""
    if cfg.family == "hybrid":
        tail = cfg.n_layers % cfg.attn_every
        return dataclasses.replace(cfg, n_layers=units * cfg.attn_every + tail)
    return dataclasses.replace(cfg, n_layers=units)


def _units(cfg) -> int:
    return cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else cfg.n_layers


def step_cost(cfg, shape: ShapeSpec, n_data: int = 1, *, walk: bool = False,
              n_microbatch: int | None = None) -> tuple:
    """(Cost of one step at ``shape``'s batch, data-parallel over ``n_data``
    hosts, meta). The layer stack is counted at depths 1 and 2 and
    extrapolated (the train step's update, whose slicing depends on the
    depth, at full depth); ``walk``: count every layer of the whole step."""
    extrapolated = not walk and cfg.family in EXTRAPOLATED
    if shape.kind == "train":
        whole, _, update, meta = _train_parts(cfg, shape, n_data, n_microbatch)
        if not extrapolated:
            return op_cost.count(whole)[1], {**meta, "counted": "every layer"}
        grads = op_cost.extrapolate(
            lambda u: op_cost.count(
                _train_parts(_with_depth(cfg, u), shape, n_data, n_microbatch)[1])[1],
            _units(cfg))
        return grads + op_cost.count(update)[1], {
            **meta, "counted": "gradients at depths 1 and 2, extrapolated; the update whole"}
    fn, meta = _serve_step(cfg, shape)
    with torch.no_grad():
        if not extrapolated:
            return op_cost.count(fn)[1], {**meta, "counted": "every layer"}
        cost = op_cost.extrapolate(
            lambda u: op_cost.count(_serve_step(_with_depth(cfg, u), shape)[0])[1], _units(cfg))
    return cost, {**meta, "counted": "depths 1 and 2, extrapolated"}


def _tree_bytes(mesh, axes, tree, rules) -> int:
    specs = tu.leaves(shd.tree_specs_for(mesh, axes, tree, rules), is_leaf=shd.is_spec)
    total = 0
    for spec, t in zip(specs, tu.leaves(tree)):
        n = 1
        for d in shd.shard_shape(tuple(t.shape), spec, mesh):
            n *= d
        total += n * t.element_size()
    return total


def static_bytes(cfg, shape: ShapeSpec, mesh: shd.MeshShape) -> dict:
    """Per-device bytes of what the step keeps: parameters, optimizer state
    (train) and the cache (prefill's output, decode's input), each leaf
    laid out by its logical axes under ``default_rules``."""
    api = zoo.get_api(cfg)
    rules = shd.default_rules(mesh, fsdp=cfg.fsdp)
    params = api.init_params(0, device="meta")
    out = {"params": _tree_bytes(mesh, api.param_axes(), params, rules)}
    if shape.kind == "train":
        _, int8 = TRAIN_PRESETS.get(cfg.arch_id, (8, False))
        ocfg = opt.AdamWConfig(int8_moments=int8)
        state = trainer.init_train_state(params, ocfg)
        axes = trainer.train_state_axes(api.param_axes(), ocfg)
        out["opt_state"] = _tree_bytes(mesh, axes.opt, state.opt, rules)
    else:
        cache = api.init_cache(shape.global_batch, shape.seq_len, device="meta")
        out["cache"] = _tree_bytes(mesh, api.cache_axes(shape.global_batch, shape.seq_len),
                                   cache, rules)
    out["total"] = sum(out.values())
    return out


def card_memory() -> float:
    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return HBM_BYTES


def analyze_cell(arch: str, shape_name: str, mesh_name: str) -> dict:
    cfg, shape, mesh = get_config(arch), SHAPES[shape_name], MESHES[mesh_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "mesh_shape": mesh.shape}
    if shape_name in cfg.skip_shapes:
        return {**rec, "status": "skipped",
                "reason": "full-attention arch: no sub-quadratic path for 500k decode"}
    n_chips = shd.num_devices(mesh)
    n_batch, n_model = batch_shards(mesh, shape.global_batch), model_shards(mesh)
    pd = dataclasses.replace(shape, global_batch=shape.global_batch // n_batch)
    n_data = n_batch if shape.kind == "train" else 1
    t0 = time.perf_counter()
    cost, meta = step_cost(cfg, pd, n_data)
    cost = cost.scaled(1.0 / n_model)
    static = static_bytes(cfg, shape, mesh)
    hbm = card_memory()
    terms = {"compute_s": cost.flops / PEAK_FLOPS, "memory_s": cost.bytes / HBM_BW,
             "collective_s": cost.coll_bytes / LINK_BW}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    return {
        **rec, "status": "ok", **meta, "n_chips": n_chips,
        "per_device_batch": pd.global_batch,
        "model_axis": "even split, not executed" if n_model > 1 else None,
        "count_s": time.perf_counter() - t0,
        "flops_per_device": cost.flops,
        "product_flops_per_device": cost.product_flops,
        "hbm_bytes_per_device": cost.bytes,
        "collective_bytes_per_device": {**cost.coll_by_kind, "total": cost.coll_bytes,
                                        "count": cost.coll_calls},
        "ops_per_device": cost.ops,
        "static_bytes_per_device": static,
        "hbm_bytes_per_card": hbm,
        "fits": static["total"] <= hbm,
        "fits_counts": "parameters, optimizer state and cache; not activations",
        "roofline": {**terms, "dominant": dominant, "bound_s": max(terms.values()),
                     "model_flops_total": mf,
                     "useful_flops_ratio": mf / max(cost.flops * n_chips, 1.0)},
        "peaks": {"flops_per_s": PEAK_FLOPS, "hbm_bytes_per_s": HBM_BW,
                  "link_bytes_per_s": LINK_BW,
                  "source": "NVIDIA H100 SXM data sheet, dense bf16, 700 W"},
    }


def run_cell(arch: str, shape_name: str, mesh_name: str, out_dir: str = OUT_DIR, *,
             verbose: bool = True) -> dict:
    rec = analyze_cell(arch, shape_name, mesh_name)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    if verbose:
        if rec["status"] == "skipped":
            print(f"== {arch} x {shape_name} x {mesh_name}: skipped ({rec['reason']})")
        else:
            t = rec["roofline"]
            print(f"== {arch} x {shape_name} x {mesh_name}: {rec['flops_per_device']:.3e} FLOP, "
                  f"{rec['hbm_bytes_per_device']:.3e} B, collectives "
                  f"{rec['collective_bytes_per_device']['total']:.3e} B per device; static "
                  f"{rec['static_bytes_per_device']['total'] / 1e9:.2f} GB (fits "
                  f"{rec['fits']}); dominant {t['dominant']} {t['bound_s']:.3e} s; useful "
                  f"{t['useful_flops_ratio']:.3f} [{rec['count_s']:.1f} s]", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=list(ARCH_IDS))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=[*MESHES, "all"], default="h100")
    ap.add_argument("--all", action="store_true", help="every (arch x shape) cell")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)
    meshes = list(MESHES) if args.mesh == "all" else [args.mesh]
    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    elif args.arch:
        cells = [(args.arch, s) for s in SHAPES]
    else:
        ap.error("--arch [--shape] or --all")
    failures = []
    for arch, shape in cells:
        for m in meshes:
            try:
                run_cell(arch, shape, m, args.out)
            except Exception:
                traceback.print_exc()
                failures.append((arch, shape, m))
    if failures:
        print("FAILED cells:", failures)
        return 1
    print(f"all {len(cells) * len(meshes)} cells written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
