"""Quickstart: the paper's pipeline end to end on a reduced detector.
Counterpart of ``examples/quickstart.py``, with its steps and prints, plus
``--device``.

1. Build a reduced SNN detector (same family as the paper's 1024x576 model).
2. Run a forward pass on a synthetic cityscape frame; look at spike sparsity.
3. Fine-grained-prune (80% on 3x3), bitmask-compress, and compare formats.
4. Compute mIoUT and pick the mixed-time-step schedule.
5. Run the pruned stage-4 conv through the gated one-to-all kernel on one
   18x32 tile of spikes and check it against the oracle: one launch of
   ``csrc/gated_one_to_all.cu`` on the card, its plain version on the CPU.
6. Compile-once serving: ``compile_detector`` -> Detections, then stream
   frames through a DetectorSession (membrane state carries across frames).

Usage:  PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]

Runs on the card unless ``--device cpu``. The weights are the port's own,
seeded (``torch.Generator``, seed 0); the JAX example draws from
``jax.random.PRNGKey(0)``, so the two print other figures. ``run`` takes
carried-across arrays (``params``, ``bn``, the calibrated ``calibrated_bn``
and its ``affines``) to reproduce the JAX figures.
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import backend
from repro_torch.backend import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import bitmask, miout, pruning
from repro_torch.data import synthetic_detection as sd
from repro_torch.kernels import gated_one_to_all as g2a
from repro_torch.kernels import ops, ref
from repro_torch.models import snn_yolo as sy

SPIKE_RATE = 0.23  # the paper's ~77% sparsity
TILE = (18, 32)  # one PE-array tile of spikes, the gated kernel's block
MIOUT_LAYERS = ("conv_block", "stage3")
SESSION_FRAMES = 3


def quickstart_config() -> sy.SNNDetConfig:
    """The example's reduced detector: the paper topology at 144x256, plain
    SAME conv, mixed (1, 3) time steps, the dense executor."""
    return dataclasses.replace(get_config("snn-det"), input_hw=(144, 256),
                               use_block_conv=False, mixed_time=True)


def run(cfg: sy.SNNDetConfig | None = None, *, params=None, bn=None, calibrated_bn=None,
        affines=None, device=None) -> dict:
    """The six steps; returns the figures ``main`` prints.

    ``params``/``bn``: initial weights and tdBN state (default: the port's
    seeded ``init_params``). ``calibrated_bn``: step 6's tdBN state after
    calibration on the pruned weights (default: ``calibrate_bn_state`` here);
    ``affines``: its per-layer bundles for ``compile_detector`` (default:
    computed from it)."""
    cfg = cfg or quickstart_config()
    dev = resolve_device(device)
    if params is None:
        params, bn = sy.init_params(cfg, seed=0, device=dev)
    out = {"param_count": sy.param_count(params)}

    # 2. forward on a synthetic frame
    # the model's own grid divisor: the targets (unused) then fit any input size
    batch = next(sd.batches(1, hw=cfg.input_hw, steps=1,
                            grid_div=2 ** (cfg.pooled_stages + 1)))
    frame = torch.from_numpy(batch["image"]).to(dev)
    with torch.no_grad(), sy._no_tf32():
        head, _, aux = sy.forward(params, bn, frame, cfg)
    out["head_shape"] = tuple(head.shape)
    out["spike_rate"] = {name: float(s.float().mean()) for name, s in aux["spikes"].items()}
    out["spike_count"] = {name: int(s.sum()) for name, s in aux["spikes"].items()}

    # 3. prune + compress
    pruned = pruning.prune_tree(params, rate=0.8)
    w = pruned["stage4/main_a"]["w"].cpu().numpy()
    nnz = int((w != 0).sum())
    out["stage4/main_a"] = {"density": float((w != 0).mean()), **{
        f"{fmt}_bytes": bitmask.format_bits((w.shape[3], w.size // w.shape[3]), nnz,
                                            weight_bits=8, fmt=fmt) // 8
        for fmt in ("dense", "csr", "bitmask")}}

    # 4. mIoUT -> mixed schedule
    out["miout"] = {name: float(miout.miout(aux["spikes"][name])) for name in MIOUT_LAYERS}
    out["in_t"] = {name: 1 if v > 0.9 else cfg.full_t for name, v in out["miout"].items()}

    # 5. the gated one-to-all kernel on the pruned stage-4 conv weights,
    # over one 32x18 hardware tile of spikes (paper's PE array geometry)
    rng = np.random.default_rng(0)
    spikes = (rng.random((1, *TILE, w.shape[2])) < SPIKE_RATE).astype(np.int8)
    wq = np.asarray(np.clip(np.round(w * 127), -127, 127), np.int8)
    packed = ops.pack_conv_weights(wq)
    x = torch.from_numpy(spikes).to(dev)
    before = backend.launches[g2a.KERNEL]
    y = ops.gated_conv(x, packed)
    out["kernel_launches"] = backend.launches[g2a.KERNEL] - before
    y_ref = ref.gated_conv_ref(x, torch.from_numpy(wq).to(dev))
    err = int((y.to(torch.int64) - y_ref.to(torch.int64)).abs().max())
    out["kernel"] = {"max_err": err, "taps_executed": int((wq != 0).sum()), "taps": wq.size}
    if err != 0:
        raise AssertionError(f"gated one-to-all kernel vs oracle: max err {err}")

    # 6. compile-once serving: the handle owns plan + postprocess — no
    # plan/config/state plumbing at the call site
    if calibrated_bn is None:
        calibrated_bn = sy.calibrate_bn_state(pruned, bn, frame, cfg)
    det = sy.compile_detector(cfg, pruned, calibrated_bn, device=dev, affines=affines)
    with sy._no_tf32():
        dets = det(frame)
        out["detections"] = int(dets.count[0])
        out["score_threshold"] = det.score_threshold
        sess = det.new_session(batch=1)
        out["session_counts"] = [int(sess.step(frame).detections.count[0])
                                 for _ in range(SESSION_FRAMES)]
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = quickstart_config()
    r = run(cfg, device=args.device)
    print(f"model: {r['param_count'] / 1e6:.2f}M params (full-size paper model: 3.17M)")
    print(f"head: {r['head_shape']} (grid x anchors x (5+classes))")
    for name, rate in r["spike_rate"].items():
        print(f"  {name:12s} spike rate {rate:.3f} (paper: ~77% sparsity -> rate ~0.23)")
    f = r["stage4/main_a"]
    print(f"stage4/main_a: density {f['density']:.2f} | dense {f['dense_bytes']}B "
          f"csr {f['csr_bytes']}B bitmask {f['bitmask_bytes']}B")
    for name, v in r["miout"].items():
        print(f"mIoUT[{name}] = {v:.3f} -> in_T = {r['in_t'][name]}")
    k = r["kernel"]
    print(f"gated one-to-all kernel vs oracle: max err {k['max_err']} "
          f"(taps executed: {k['taps_executed']}/{k['taps']})")
    print(f"compile_detector: {r['detections']} detections "
          f"(score_threshold {r['score_threshold']}, class-aware NMS)")
    print(f"streaming session over {SESSION_FRAMES} frames: detections {r['session_counts']} "
          f"(membrane potentials carry across frames; reset() cold-starts)")
    print("quickstart OK")
    return r


if __name__ == "__main__":
    main()
