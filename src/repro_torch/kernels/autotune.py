"""Per-layer tile autotuning for the fused pipeline kernel.

Counterpart of ``repro/kernels/autotune.py``. The TPU kernel's knobs (the
packed K-block width, macro-tiles, MXU dot groups) do not exist on the
card: the serving path hands the kernel predecoded, resident weights, and
what the CUDA kernel can vary is its tile — one of the six instantiations
of ``csrc/fused_pipeline.cu`` (:data:`repro_torch.kernels.fused_pipeline.
TILES`: steps per pass × pixels × output channels of a block). Without a
tuned tile the kernel picks one by shape (``launch()``, mirrored by
:func:`rule`). A tile never changes numerics (integer sums are exact in any
order, the epilogue is element-wise), so tuning is a pure timing search.

This module times every legal tile per LAYER SHAPE and BATCH
(:func:`candidates`: the kernel's own legality — four steps a pass only
where the layer runs a conv per step, and a shared-memory plan that fits,
asked of the built library, :func:`repro_torch.kernels.fused_pipeline.
tile_plan`), keeps the winners in a deterministic JSON cache, and
``core/plan.build_plan`` hands each fused layer its cached tiles, one per
tuned batch. The shape rule depends on the batch (its pixel count is
N·H·W), so a tile tuned at one batch is never applied at another: a
launch at an untuned batch keeps the rule.

    python -m repro_torch.kernels.autotune                 # tune (on the card)
    python -m repro_torch.kernels.autotune --full-config   # and 576x1024
    python -m repro_torch.kernels.autotune --check         # the cache covers them

Cache contract (tests/test_torch_autotune.py):
  * deterministic — the same entries serialize to byte-identical files
    (sorted keys, fixed separators, no times);
  * keyed at top level by the card's name and the kernel's build hash
    (:func:`repro_torch.backend.source_hash`): a file written for another
    card or another kernel source, a stale version or a corrupt file loads
    as {} with one RuntimeWarning per path per process, and a missing file
    loads as {} silently; one bad entry is dropped alone;
  * an entry, keyed by the layer shape's key (the JAX package's) and the
    batch (:func:`cache_key`), is a tile, or ``null``: the shape rule won
    (within :data:`TIE_MARGIN` of the fastest tile, the rule's own tile is
    kept, so noise never moves a layer off the default).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import statistics
import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import backend
from repro_torch.kernels import fused_pipeline as fp

DEFAULT_CACHE_PATH = os.path.join(os.path.dirname(__file__), "autotune_cache.json")
CACHE_ENV_VAR = "REPRO_TORCH_AUTOTUNE_CACHE"
CACHE_VERSION = 2  # 2: entries per (layer shape, batch)
KERNEL = fp.KERNEL  # the library whose build hash keys the cache
# times within this fraction of the fastest tile count as a tie, and a tie
# keeps the shape rule's own tile
TIE_MARGIN = 0.05
TUNE_BATCH = 2  # the serving frame's batch (chip_smoke's slice)
# the batches the packaged cache is tuned at: the serving frame's, and the
# engine's capacity buckets at 8 and 64 resident streams
TUNE_BATCHES = (2, 8, 64)


class TileConfig(NamedTuple):
    """One instantiation of the fused kernel: ``tb`` steps per pass, ``ni``
    n8 tiles per warp, ``wm`` × ``wn`` warps over 16·wm pixels ×
    8·ni·wn output channels."""

    tb: int
    ni: int
    wm: int
    wn: int


DEFAULT_TILE = None  # the kernel's shape rule


class LayerShape(NamedTuple):
    """Everything the tuner needs to rebuild a layer's launch — and the
    cache key, spelled as the JAX package spells it."""

    kh: int
    kw: int
    cin: int  # true (unpadded) input channels
    kout: int  # true output channels
    in_bits: int  # 1 = binary spikes, 8 = u8 encode input
    t_in: int
    t_out: int
    h: int  # feature-map resolution the layer runs at
    w: int
    bh: int  # conv block shape
    bw: int

    @property
    def key(self) -> str:
        return (
            f"conv{self.kh}x{self.kw}_ci{self.cin}_co{self.kout}"
            f"_ib{self.in_bits}_t{self.t_in}-{self.t_out}"
            f"_hw{self.h}x{self.w}_blk{self.bh}x{self.bw}"
        )

    @property
    def n_blocks(self) -> int:
        return (self.h // self.bh) * (self.w // self.bw)

    @property
    def cin_padded(self) -> int:  # the channels the kernel sees (pack_conv_weights)
        return -(-self.cin // 8) * 8

    @property
    def kp(self) -> int:  # the padded output width (build_layer_plan's K-block)
        kblk = min(128, -(-self.kout // 8) * 8)
        return -(-self.kout // kblk) * kblk


def cache_key(shape: LayerShape, batch: int) -> str:
    """The cache entry of ``shape`` launched at ``batch`` frames."""
    return f"{shape.key}_n{batch}"


# ------------------------------------------------------------------ cache --


def cache_path(path: str | None = None) -> str:
    return path or os.environ.get(CACHE_ENV_VAR) or DEFAULT_CACHE_PATH


def kernel_version() -> str:
    """The fused kernel's build hash: any edit to its source, a header or
    the flags makes every cached tile stale."""
    return backend.source_hash(KERNEL)


def device_name() -> str | None:
    """The card this process tunes or runs on; None without one."""
    return torch.cuda.get_device_name() if torch.cuda.is_available() else None


# a stale or foreign cache is consulted once per layer at plan-build time;
# one warning per path per process is enough
_warned_paths: set[str] = set()


def _warn_once(path: str, detail: str) -> None:
    if path in _warned_paths:
        return
    _warned_paths.add(path)
    warnings.warn(
        f"autotune cache {path!r} ignored ({detail}); every layer keeps the fused "
        "kernel's shape rule — numerics are unaffected, only speed. Regenerate "
        "with `python -m repro_torch.kernels.autotune` on the card.",
        RuntimeWarning,
        stacklevel=3,
    )


_UNSET = object()


def load_cache(path: str | None = None, *, device=_UNSET, kernel=_UNSET) -> dict:
    """Load the shape-key → tile cache (a :class:`TileConfig`, or None for
    the shape rule). ``device``: the card the tiles must have been tuned on
    (default: this process's card; None, as on the CPU, accepts any);
    ``kernel``: the build hash they must have been tuned with (default: the
    current source's). A missing file is {} silently; a corrupt file, a
    stale version, another card or another kernel hash is {} with one
    RuntimeWarning per path; an entry that does not parse is dropped."""
    p = cache_path(path)
    device = device_name() if device is _UNSET else device
    kernel = kernel_version() if kernel is _UNSET else kernel
    try:
        with open(p) as f:
            raw = json.load(f)
    except FileNotFoundError:
        return {}
    except (OSError, json.JSONDecodeError) as e:
        _warn_once(p, f"corrupt: {e}")
        return {}
    if not isinstance(raw, dict) or raw.get("version") != CACHE_VERSION:
        found = raw.get("version") if isinstance(raw, dict) else type(raw).__name__
        _warn_once(p, f"version mismatch: found {found!r}, expected {CACHE_VERSION!r}")
        return {}
    if device is not None and raw.get("device") != device:
        _warn_once(p, f"tuned on {raw.get('device')!r}, this card is {device!r}")
        return {}
    if kernel is not None and raw.get("kernel") != kernel:
        _warn_once(p, f"kernel hash {raw.get('kernel')!r}, the current source is {kernel!r}")
        return {}
    out = {}
    entries = raw.get("entries")
    for key, t in (entries if isinstance(entries, dict) else {}).items():
        if t is None:
            out[key] = None
            continue
        try:
            tile = TileConfig(int(t["tb"]), int(t["ni"]), int(t["wm"]), int(t["wn"]))
        except (KeyError, TypeError, ValueError):
            continue  # one bad entry falls back; the rest stay usable
        if tuple(tile) in fp.TILES:
            out[key] = tile
    return out


def save_cache(entries: dict, path: str | None = None, *, device: str | None = None,
               kernel: str | None = None) -> str:
    """Serialize deterministically: sorted keys, fixed separators, only the
    chosen tiles (never a time). ``device``/``kernel`` default to this
    process's card and the current build hash."""
    p = cache_path(path)
    payload = {
        "version": CACHE_VERSION,
        "device": device if device is not None else device_name(),
        "kernel": kernel if kernel is not None else kernel_version(),
        "entries": {key: None if t is None else dict(TileConfig(*t)._asdict())
                    for key, t in sorted(entries.items())},
    }
    with open(p, "w") as f:
        f.write(json.dumps(payload, indent=1, sort_keys=True) + "\n")
    return p


@functools.lru_cache(maxsize=4)
def _cached_load(path: str, mtime: float, device: str | None) -> tuple:
    return tuple(load_cache(path, device=device).items())


def packaged_cache() -> dict:
    """The cache :func:`cache_path` names, loaded once per file version."""
    p = cache_path()
    try:
        mtime = os.path.getmtime(p)
    except OSError:
        return {}
    return dict(_cached_load(p, mtime, device_name()))


def lookup(shape: LayerShape, cache: dict | None = None, batch: int = TUNE_BATCH):
    """A layer shape's tuned tile at ``batch``; None (the shape rule) when
    untuned. ``cache=None`` reads the packaged cache."""
    if cache is None:
        cache = packaged_cache()
    return cache.get(cache_key(shape, batch), DEFAULT_TILE)


def tiles_for(shape: LayerShape, cache: dict | None = None) -> dict:
    """{batch: tile} of every batch the cache tuned ``shape`` at where a
    tile beat the rule (the plan's per-layer table)."""
    if cache is None:
        cache = packaged_cache()
    prefix = shape.key + "_n"
    return {int(k[len(prefix):]): t for k, t in cache.items()
            if k.startswith(prefix) and k[len(prefix):].isdigit() and t is not None}


# ------------------------------------------------------------- candidates --


def rule(shape: LayerShape, batch: int = TUNE_BATCH, sms: int | None = None) -> TileConfig:
    """The tile the kernel's shape rule picks for ``shape`` at ``batch``."""
    if sms is None:
        sms = (torch.cuda.get_device_properties(0).multi_processor_count
               if torch.cuda.is_available() else fp.DEFAULT_SMS)
    return TileConfig(*fp.rule_tile(shape.t_in, batch * shape.h * shape.w, shape.kout, sms))


def candidates(shape: LayerShape, device=None) -> list:
    """The tiles the kernel accepts for ``shape``, in :data:`fp.TILES`
    order (:func:`fp.check_tile`): four steps a pass only where there is a
    conv per step (t_in > 1), and, on the card, a shared-memory plan that
    fits with every tap live (a pruned tap only shrinks the plan), asked
    of the kernel's library. ``device``: where the tiles will run (default:
    the card if there is one); on the CPU there is no library to ask, and
    the plain version runs any tile."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    on_card = torch.device(device).type == "cuda"
    out = []
    for tile in fp.TILES:
        try:
            fp.check_tile(tile, t_in=shape.t_in, c=shape.cin_padded, kp=shape.kp,
                          n_live=shape.kh * shape.kw, kh=shape.kh, bh=shape.bh, bw=shape.bw,
                          on_card=on_card)
        except ValueError:
            continue
        out.append(TileConfig(*tile))
    return out


# -------------------------------------------------------------- measuring --


SPIN_CYCLES = 50_000_000  # ~30 ms of the device held while the host queues a batch


def measure(fn: Callable, *, iters: int = 5, warmup: int = 1, batch: int = 10) -> float:
    """Device time of one ``fn()`` in ms: the median over ``iters`` batches
    of the mean of ``batch`` calls between two CUDA events, after
    ``warmup`` calls. Each batch is queued behind a spin kernel, so the
    events time the device alone, not the host issuing a launch of a few
    tens of µs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return float(statistics.median(times))


def synthetic_layer(shape: LayerShape, *, batch: int = TUNE_BATCH, device=None, seed: int = 0):
    """Seeded weights and inputs at the layer's shape and the paper's
    sparsity (80% of the 3×3 weights pruned): (x, live weights, affine)
    on ``device``."""
    from repro_torch.kernels import ops  # lazy: ops imports the plan's kernels

    dev = backend.resolve_device(device)
    rng = np.random.default_rng(seed)
    w = rng.integers(-127, 128, (shape.kh, shape.kw, shape.cin, shape.kout))
    w[rng.random(w.shape) > (0.2 if shape.kh > 1 else 0.6)] = 0
    pw = ops.pack_conv_weights(w.astype(np.int8), kblk=min(128, -(-shape.kout // 8) * 8))
    hi = 256 if shape.in_bits == 8 else 2
    x = rng.integers(0, hi, (shape.t_in, batch, shape.h, shape.w, pw.cin), dtype=np.uint8)
    x[..., shape.cin:] = 0
    rows = np.stack([np.full(shape.kout, 1.0 / 128), rng.normal(0, 4, shape.kout),
                     rng.uniform(0.02, 0.2, shape.kout), rng.uniform(0.5, 1.5, shape.kout),
                     rng.normal(0, 0.2, shape.kout)]).astype(np.float32)
    affine = ops.pad_affine(torch.from_numpy(rows).to(dev), pw.kp)
    return torch.from_numpy(x).to(dev), ops.predecode(pw, dev), affine


def layer_call(shape: LayerShape, x, live, affine, tile, *, threshold: float = 0.5,
               leak: float = 0.25) -> Callable:
    """A closure that launches the layer once at ``tile`` (None: the rule)
    and returns (spikes, membrane); nothing runs until it is called."""
    kw = dict(kout=shape.kout, kh=shape.kh, kw=shape.kw, bh=shape.bh, bw=shape.bw,
              t_out=shape.t_out, bn_scale=threshold, threshold=threshold, leak=leak,
              tile=None if tile is None else tuple(tile))
    return lambda: fp.fused_pipeline(x, live.w, live.taps, affine, None, **kw)


def pick(walls: dict, rule_tile: TileConfig):
    """The winner of ``walls`` ({tile: ms}): None (the shape rule) when the
    rule's tile is within :data:`TIE_MARGIN` of the fastest, else the
    fastest tile (the first of equals, in :data:`fp.TILES` order)."""
    best = min(walls.values())
    if rule_tile in walls and walls[rule_tile] <= best * (1 + TIE_MARGIN):
        return None
    return min(walls, key=lambda t: (walls[t], fp.TILES.index(tuple(t))))


def tune_layer(
    shape: LayerShape,
    *,
    threshold: float = 0.5,
    leak: float = 0.25,
    measure_fn: Callable | None = None,
    iters: int = 5,
    batch: int = TUNE_BATCH,
    device=None,
) -> tuple:
    """Time every candidate tile of one layer shape; returns (winner — a
    :class:`TileConfig`, or None for the shape rule —, {tile name: ms}).
    ``measure_fn(tile, run) -> ms`` is injectable, so tests drive the
    choice without a card; ``run`` launches nothing until it is called."""
    x, live, affine = synthetic_layer(shape, batch=batch, device=device)
    sms = None if x.device.type == "cuda" else fp.DEFAULT_SMS
    walls = {}
    for tile in candidates(shape, x.device):
        run = layer_call(shape, x, live, affine, tile, threshold=threshold, leak=leak)
        walls[tile] = measure_fn(tile, run) if measure_fn is not None else measure(run,
                                                                                  iters=iters)
    record = {tile_name(t): ms for t, ms in walls.items()}
    return pick(walls, rule(shape, batch, sms)), record


def tile_name(tile) -> str:
    if tile is None:
        return "rule"
    tb, ni, wm, wn = tile
    return f"tb{tb}_px{16 * wm}_ch{8 * ni * wn}"


def detector_layer_shapes(cfg) -> dict:
    """Every fused conv layer of an ``SNNDetConfig`` as a :class:`LayerShape`
    (the head is a plain matmul, not the kernel)."""
    from repro_torch.models import snn_yolo as sy  # lazy: snn_yolo builds plans

    bh, bw = cfg.block_hw
    return {
        spec.name: LayerShape(kh=spec.k, kw=spec.k, cin=spec.cin, kout=spec.cout,
                              in_bits=spec.bits_in, t_in=spec.t_in, t_out=spec.t_out,
                              h=spec.h, w=spec.w, bh=bh, bw=bw)
        for spec in sy.layer_specs(cfg)
        if spec.name != "head"
    }


def tune_detector(cfg, *, measure_fn: Callable | None = None, iters: int = 5,
                  batch: int = TUNE_BATCH, device=None, verbose: bool = True) -> dict:
    """Tune every distinct fused layer shape of a detector config at
    ``batch``; returns cache entries (:func:`cache_key` → tile or None)."""
    entries: dict = {}
    for name, shape in sorted(detector_layer_shapes(cfg).items()):
        key = cache_key(shape, batch)
        if key in entries:
            continue
        tile, record = tune_layer(shape, threshold=cfg.threshold, leak=cfg.leak,
                                  measure_fn=measure_fn, iters=iters, batch=batch,
                                  device=device)
        entries[key] = tile
        if verbose:
            times = ", ".join(f"{k}={v:.4f}ms" for k, v in record.items())
            print(f"  {name:18s} {key}\n    -> {tile_name(tile)}   ({times})")
    return entries


def check_cache(cfgs, path: str | None = None, batches=TUNE_BATCHES, **load_kw) -> list:
    """The cache keys ``cfgs`` need at ``batches`` that the cache lacks
    ([] = covered). A stale, foreign or corrupt cache loads as {} and so
    lacks them all."""
    cache = load_cache(path, **load_kw)
    missing = []
    for cfg in cfgs:
        for shape in detector_layer_shapes(cfg).values():
            for batch in batches:
                key = cache_key(shape, batch)
                if key not in cache and key not in missing:
                    missing.append(key)
    return missing


def bench_configs(*, full_config: bool = False, input_hw: str | None = None) -> list:
    """The configs the CLI tunes and checks: the e2e benchmark's reduced
    config, optionally at ``input_hw`` ("HxW"), and the 576×1024 ``CONFIG``."""
    from repro_torch.benchmarks.e2e_detector import reduced_config
    from repro_torch.configs.snn_det import CONFIG

    cfgs = [reduced_config()]
    if input_hw:
        h, w = (int(v) for v in input_hw.lower().split("x"))
        cfgs.append(reduced_config((h, w)))
    if full_config:
        cfgs.append(dataclasses.replace(CONFIG, conv_exec="pallas"))
    return cfgs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full-config", action="store_true",
                    help="also the paper's 576x1024 detector")
    ap.add_argument("--input-hw", default=None,
                    help="HxW of one more reduced config (a multiple of 24x32)")
    ap.add_argument("--out", default=None, help="cache path (default: the packaged one)")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--batches", default=",".join(map(str, TUNE_BATCHES)),
                    help="comma-separated batches to tune (and --check) each shape at")
    ap.add_argument("--check", action="store_true",
                    help="do not tune: exit 1 unless the cache is current (this source's "
                         "kernel hash; this card's name where there is one) and covers "
                         "every fused layer shape of the configs")
    args = ap.parse_args(argv)
    cfgs = bench_configs(full_config=args.full_config, input_hw=args.input_hw)
    batches = tuple(int(b) for b in args.batches.split(","))
    p = cache_path(args.out)

    if args.check:
        missing = check_cache(cfgs, args.out, batches)
        if missing:
            print(f"autotune cache {p} is missing {len(missing)} "
                  f"entr{'y' if len(missing) == 1 else 'ies'}:")
            for key in missing:
                print(f"  {key}")
            print("regenerate on the card with: python -m repro_torch.kernels.autotune"
                  + (" --full-config" if args.full_config else ""))
            return 1
        with open(p) as f:
            raw = json.load(f)
        print(f"autotune cache {p} covers all {len(cfgs)} config(s) at batches "
              f"{list(batches)}: tuned on {raw['device']}, kernel {raw['kernel']}")
        return 0

    backend.resolve_device("cuda")  # timing needs the card: there is no CPU mode
    entries = load_cache(args.out)
    for cfg in cfgs:
        for batch in batches:
            print(f"tuning {cfg.arch_id} @ {cfg.input_hw[0]}x{cfg.input_hw[1]}, batch {batch}")
            entries.update(tune_detector(cfg, iters=args.iters, batch=batch))
            torch.cuda.empty_cache()
    path = save_cache(entries, args.out)
    print(f"wrote {len(entries)} entries -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
