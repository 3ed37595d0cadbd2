"""The paper's own architecture as a distribution scheme: spatial-parallel
block convolution, and its roofline terms on the H100.

Counterpart of ``benchmarks/detector_dryrun.py``. The paper picks 576-PE
spatial parallelism because block convolution makes spatial tiles
independent: each block sees replicate padding at its own border, so no
partial sum crosses a block edge. Split along the block grid, a shard of
whole blocks would need no halo from its neighbours. The JAX package
shows this by lowering the 576×1024 forward with W sharded over 16
devices and counting zero collective-permute bytes in the HLO. The port
shows it by computation (:func:`shard_check`): W is split into column
shards of whole input block columns, each shard runs the fused executor's
forward alone, and every fused layer's spikes and membrane, and the head,
must equal the matching columns of the whole forward bit for bit. Where a
layer's map no longer holds whole blocks in a shard (the deep layers,
whose 18×32 blocks span the shards), the check reports it as the first
layer that differs — the limit of the no-halo property.

:func:`run` gives the 576×1024 forward's roofline terms from a ``meta``
pass (:mod:`repro_torch.launch.op_cost`) of the dense executor, the
reference every executor is held to.

    PYTHONPATH=src python -m repro_torch.benchmarks.detector_dryrun [--shards 4]
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch import backend
from repro_torch.configs.snn_det import CONFIG
from repro_torch.kernels import fused_pipeline as fp
from repro_torch.launch import op_cost
from repro_torch.launch.dryrun import HBM_BW, LINK_BW, PEAK_FLOPS
from repro_torch.models import snn_yolo as sy


def run(cfg=None, *, batch: int = 16) -> dict:
    """The detector forward's FLOPs, bytes and roofline terms on one card,
    counted on ``meta`` tensors (``batch`` frames: the JAX package's data
    axis of 16)."""
    cfg = dataclasses.replace(cfg or CONFIG, conv_exec="dense")
    params, bn = sy.init_params(cfg, device="cpu")
    to_meta = lambda t: t.to("meta")  # noqa: E731
    params = {k: {n: to_meta(v) for n, v in p.items()} for k, p in params.items()}
    bn = {k: {n: to_meta(v) for n, v in s.items()} for k, s in bn.items()}
    imgs = torch.empty((batch, *cfg.input_hw, 3), device="meta")
    with torch.no_grad():
        _, cost = op_cost.count(lambda: sy.forward(params, bn, imgs, cfg)[0])
    out = {"input_hw": list(cfg.input_hw), "batch": batch, "flops": cost.flops,
           "product_flops": cost.product_flops, "bytes": cost.bytes,
           "compute_s": cost.flops / PEAK_FLOPS, "memory_s": cost.bytes / HBM_BW,
           "collective_s": cost.coll_bytes / LINK_BW}
    print(f"detector @{cfg.input_hw[1]}x{cfg.input_hw[0]}, batch {batch}, dense executor, "
          f"one H100 (data-sheet peaks): compute {out['compute_s']:.2e} s, memory "
          f"{out['memory_s']:.2e} s")
    return out


def _recording():
    """(stand-in for ``fp.fused_pipeline``, outputs): each launch's
    (spikes, membrane), in launch order."""
    real, outs = fp.fused_pipeline, []

    def record(*args, **kwargs):
        spk, mem = real(*args, **kwargs)
        outs.append((spk, mem))
        return spk, mem

    return real, record, outs


def _forward(det, frames):
    """(head, [(layer, spikes, membrane)] of the fused launches, or the
    error that stopped the forward)."""
    names = [n for n in det.plan.layers if n != "head"]
    real, record, outs = _recording()
    fp.fused_pipeline = record
    try:
        head, err = det.detect(frames)[1], None
    except ValueError as e:
        head, err = None, str(e)
    finally:
        fp.fused_pipeline = real
    return head, [(n, s, m) for n, (s, m) in zip(names, outs)], err


def _bits_equal(a, b) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return tuple(a.shape) == tuple(b.shape) and torch.equal(a, b)


def shard_check(det, frames, n_shards: int = 4) -> dict:
    """Split W into ``n_shards`` column shards of whole input block columns
    and run each through the fused executor alone (the same weights, tdBN
    state and tiles). Returns whether the concatenated heads equal the
    whole forward's bit for bit, each layer's verdict in launch order, and
    the first layer that differs (None when every layer and the head
    match)."""
    cfg = det.cfg
    h, w = cfg.input_hw
    bw = cfg.block_hw[1]
    if w % (n_shards * bw):
        raise ValueError(f"W={w} does not split into {n_shards} shards of whole {bw}-wide "
                         "block columns")
    ws = w // n_shards
    head, layers, err = _forward(det, frames)
    if err is not None:
        raise RuntimeError(f"the whole forward failed: {err}")
    cfg_s = dataclasses.replace(cfg, input_hw=(h, ws))
    det_s = sy.compile_detector(cfg_s, det.params, det.bn_state, device=det.device)
    verdict = {name: True for name, _, _ in layers}
    first, heads, errors = None, [], {}
    for s in range(n_shards):
        hs, ls, e = _forward(det_s, frames[:, :, s * ws:(s + 1) * ws])
        if e is not None:
            errors[s] = e
        done = {name: (spk, mem) for name, spk, mem in ls}
        for name, spk, mem in layers:
            wl = mem.shape[-2] // n_shards
            got = done.get(name)
            ok = got is not None and _bits_equal(
                got[0], spk[..., s * wl:(s + 1) * wl, :].contiguous()) and _bits_equal(
                got[1], mem[..., s * wl:(s + 1) * wl, :].contiguous())
            verdict[name] &= bool(ok)
        heads.append(hs)
    for name, _, _ in layers:
        if not verdict[name]:
            first = name
            break
    head_equal = all(x is not None for x in heads) and _bits_equal(
        torch.cat(heads, dim=2), head)
    return {"input_hw": [h, w], "shards": n_shards, "shard_w": ws, "block_hw": list(cfg.block_hw),
            "head_bit_equal": head_equal, "first_differing_layer": first,
            "layers_equal": [n for n, _, _ in layers if verdict[n]],
            "layers_differing": [n for n, _, _ in layers if not verdict[n]],
            "shard_errors": errors}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    from repro_torch.serve.detector import demo_weights, synth_streams

    cfg = dataclasses.replace(CONFIG, conv_exec="pallas")
    out = {"roofline": run(cfg)}
    dev = backend.resolve_device(args.device)
    params, bn, rng = demo_weights(cfg, seed=0, device=dev)
    frames = torch.from_numpy(np.stack(synth_streams(rng, 2, 1, cfg.input_hw), axis=1)[0])
    det = sy.compile_detector(cfg, params, bn, device=dev)
    out["shards"] = shard_check(det, frames.to(dev), args.shards)
    print(json.dumps(out["shards"]))
    return out


if __name__ == "__main__":
    main()
