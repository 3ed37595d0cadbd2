"""Train, checkpoint and evaluate the detector: counterpart of
``repro/eval/harness.py``.

The paper's Table I walks the detector through a compression pipeline
(train float → fine-grained prune 80% → FXP8 quantize → fine-tune), and
Fig 15 shows the mixed (1, 3) time-step schedule costs almost no mAP
against uniform T=3. :func:`run_pipeline` reproduces both at a trainable
demo scale on the synthetic IVS-3cls-like split:

  stage "trained"  float weights, fresh from ``train_steps``
  stage "pruned"   80% magnitude pruning on 3×3 kernels, no retraining
  stage "qat"      FXP8 fake-quant + mask-preserving fine-tune
  schedules        the final weights evaluated mixed (1, 3) vs uniform T=3

On a static frame the two schedules are mathematically identical through
the first two macro layers (convolving one step and broadcasting equals
convolving three identical steps), so the mAP delta is exactly 0 while the
op count drops; it is measured all the same. Every run also reports the
worst-case conv accumulator against the ASIC's 16-bit claim
(:func:`accumulator_report`).

* :func:`demo_config` — the trainable-size detector (96×160, thinned
  channels, 3 CSP stages, grid /16) the training launcher and the JAX
  package's harness share.
* :func:`train_steps` — AdamW on the synthetic split (or any
  :class:`~repro_torch.data.detection_datasets.DetectionSource`), with
  pruning masks for a mask-preserving fine-tune; :func:`train_step` is one
  step of it and :func:`loss_and_grads` its differentiable half. TF32 stays
  off throughout.
* :func:`evaluate_detector` — mAP@IoU of a compiled detector on an eval
  split, TF32 off, in one process or sharded across shards and processes
  (:mod:`repro_torch.eval.sharded`).
* :func:`run_pipeline` — train → prune → QAT → evaluate, returning an
  :class:`EvalReport`; :func:`accumulator_report` — the 16-bit claim.
* :func:`save_detector_checkpoint` / :func:`restore_detector_checkpoint` —
  ``{"params", "bn"}`` plus the ``detector_config.json`` sidecar that makes
  a checkpoint self-describing, in the layout both packages read.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch import interop
from repro_torch import tree as tu
from repro_torch.configs.snn_det import CONFIG
from repro_torch.core import pruning, quant
from repro_torch.data import detection_datasets as dd
from repro_torch.eval import detection_map as dm
from repro_torch.models import snn_yolo as sy
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt

# Evaluation-time postprocess settings: a low score threshold and a deep
# detection budget — mAP integrates the whole precision-recall curve, so
# the serving default (0.25) would clip the low-confidence tail.
EVAL_SCORE_THRESHOLD = 0.01
EVAL_MAX_DETECTIONS = 64

# sidecar inside each committed step dir; makes a detector checkpoint
# self-describing (restore rebuilds the matching SNNDetConfig from it)
DETECTOR_CONFIG_FILE = "detector_config.json"


def demo_config(*, conv_exec: str = "dense", weight_bits: int = 8) -> sy.SNNDetConfig:
    """The trainable-size detector: 96×160 input, thinned channels, 3 CSP
    stages (grid /16), mixed (1, 3) time steps, plain SAME conv; block
    (6, 10) divides every feature map, for block-conv evaluation."""
    return dataclasses.replace(
        CONFIG,
        arch_id="snn-det-eval",
        input_hw=(96, 160), stem_channels=8, conv_block_channels=16,
        stage_channels=((16, 16), (16, 32), (32, 64)), pooled_stages=3,
        use_block_conv=False, block_hw=(6, 10),
        weight_bits=weight_bits, conv_exec=conv_exec,
    )


def grid_div(cfg: sy.SNNDetConfig) -> int:
    """Dataset grid divisor matching the model's pooling depth."""
    return 2 ** (cfg.pooled_stages + 1)


# ---------------------------------------------------------------- evaluate --


def accumulator_report(det) -> dict:
    """Worst-case conv accumulator magnitude per layer (binary-spike
    inputs: max over output channels of Σ|w_q|) vs the 16-bit claim."""
    plan = det.plan
    if plan is None:  # float weights: no FXP accumulator to bound
        return {"acc_bits": quant.ACC_BITS, "layers": {}, "max_abs": 0,
                "within_16b": True}
    per_layer = {name: quant.conv_acc_worst_case(lp.w_q) for name, lp in plan.layers.items()}
    worst = max(per_layer.values())
    return {
        "acc_bits": quant.ACC_BITS,
        "layers": per_layer,
        "max_abs": int(worst),
        "within_16b": bool(worst < 2 ** (quant.ACC_BITS - 1)),
    }


def predictions(det, images: np.ndarray, batch: int) -> list:
    """Per-image prediction dicts of ``det`` on host ``images``, detected
    ``batch`` at a time with TF32 off (float weights score on the card as
    on the CPU)."""
    preds = []
    with sy._no_tf32():
        for i in range(0, len(images), batch):
            dets, _ = det.detect(torch.from_numpy(images[i : i + batch]))
            preds.extend(dm.detections_to_predictions(
                type(dets)(*(t.cpu().numpy() for t in dets))))
    return preds


def evaluate_detector(det, *, n_images: int = 32, split: str = "val", batch: int = 8,
                      iou_threshold: float = 0.5, sharded=None,
                      source: Optional[dd.DetectionSource] = None, ctx=None) -> dict:
    """mAP@iou of a :class:`~repro_torch.serve.detector.CompiledDetector` on
    an eval split of ``source`` (the synthetic generator by default;
    ``n_images`` clamps to a finite source's split). The handle's own
    postprocess settings are used: build it with
    :func:`compile_eval_detector` for evaluation thresholds.

    ``sharded``: a :class:`repro_torch.eval.sharded.ShardedEvalConfig` (or
    a bare shard count) routes the evaluation through the sharded path —
    striped split, per-shard forward→decode→NMS, an exact reduction of the
    pooled match stats — bit-identical to this path for any shard count.
    ``ctx``: a :class:`repro_torch.distributed.runtime.DistributedContext`;
    under a multi-controller launch each process walks only the shards it
    owns and the stats are gathered across processes (requires
    ``sharded``)."""
    source = source or dd.SyntheticSource()
    cap = source.num_eval_images(split)
    if cap is not None:
        n_images = min(n_images, cap)
    if sharded is not None:
        from repro_torch.eval import sharded as se

        eval_cfg = (se.ShardedEvalConfig(n_shards=sharded, batch=batch)
                    if isinstance(sharded, int) else sharded)
        return se.evaluate_detector_sharded(det, n_images=n_images, split=split,
                                            iou_threshold=iou_threshold, eval_cfg=eval_cfg,
                                            source=source, ctx=ctx)
    cfg = det.cfg
    images, gts = source.eval_set(
        n_images, split=split, hw=cfg.input_hw, grid_div=grid_div(cfg),
        num_anchors=cfg.num_anchors, num_classes=cfg.num_classes,
    )
    report = dm.evaluate_detections(
        predictions(det, images, batch), gts, num_classes=cfg.num_classes,
        iou_threshold=iou_threshold
    )
    report["split"] = split
    return report


def compile_eval_detector(cfg, params, bn, **kw):
    """compile_detector with evaluation postprocess settings."""
    kw.setdefault("score_threshold", EVAL_SCORE_THRESHOLD)
    kw.setdefault("max_detections", EVAL_MAX_DETECTIONS)
    return sy.compile_detector(cfg, params, bn, **kw)


# ------------------------------------------------------------- checkpoints --


def save_detector_checkpoint(root: str, step: int, params, bn, cfg, *,
                             extra_files=None) -> str:
    """Commit ``{"params", "bn"}`` plus the full config as an atomic
    detector checkpoint under ``root``; the config sidecar commits with the
    weights. ``extra_files``: more {filename: bytes} sidecars (the config's
    name is reserved). Returns the committed directory."""
    blob = json.dumps(sy.config_to_dict(cfg), indent=1).encode()
    files = dict(extra_files or {})
    if DETECTOR_CONFIG_FILE in files:
        raise ValueError(f"extra_files may not shadow {DETECTOR_CONFIG_FILE!r}")
    files[DETECTOR_CONFIG_FILE] = blob
    return ckpt.save(root, step, {"params": params, "bn": bn}, extra_files=files)


def checkpoint_template(cfg: sy.SNNDetConfig) -> dict:
    """The leaves a detector checkpoint of ``cfg`` holds, as ShapeDtype."""
    sd = ckpt.ShapeDtype
    params, bn = {}, {}
    for name, shape in sy.layer_shapes(cfg).items():
        params[name] = {"w": sd(shape, np.float32)}
        if name != "head":
            cout = shape[-1]
            params[name]["gamma"] = sd((cout,), np.float32)
            params[name]["beta"] = sd((cout,), np.float32)
            bn[name] = {"mean": sd((cout,), np.float32), "var": sd((cout,), np.float32),
                        "count": sd((), np.int32)}
    return {"params": params, "bn": bn}


def restore_detector_checkpoint(root: str, *, step: int | None = None,
                                cfg: sy.SNNDetConfig | None = None, device=None):
    """(cfg, params, bn, step) from a detector checkpoint either package
    wrote, the tensors on ``device`` (default: the card). ``step`` defaults
    to the latest committed one; ``cfg`` to the checkpoint's own sidecar
    (pass it to restore a bare train-state checkpoint, which has none; its
    optimizer leaves are ignored)."""
    d, step = ckpt.step_dir(root, step)
    if cfg is None:
        path = os.path.join(d, DETECTOR_CONFIG_FILE)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} missing — step {step} is not a detector checkpoint; "
                "pass cfg= to restore anyway"
            )
        with open(path) as f:
            cfg = sy.config_from_dict(json.load(f))
    state, step = ckpt.restore(root, checkpoint_template(cfg), step=step)
    params, bn, _ = interop.params_from_numpy(state["params"], state["bn"], device=device)
    return cfg, params, bn, step


# ------------------------------------------------------------------- train --


def train_config(steps: int, lr_peak: float = 2e-3) -> opt.AdamWConfig:
    """:func:`train_steps`' optimizer settings for a run of ``steps``."""
    return opt.AdamWConfig(
        lr_peak=lr_peak, lr_init=lr_peak / 10, lr_final=lr_peak / 100,
        warmup_steps=max(steps // 15, 1), total_steps=steps, weight_decay=1e-3,
    )


def loss_and_grads(cfg: sy.SNNDetConfig, params, bn, images, targets):
    """The YOLO loss of one batch through the train-mode forward, and its
    gradients. Returns (loss, grads like params, new bn state, aux)."""
    live = [p.detach().requires_grad_(True) for p in tu.leaves(params)]
    head, new_bn, aux = sy.forward(tu.unflatten_like(params, live), bn, images, cfg, train=True)
    loss = sy.yolo_loss(head, targets)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, live)]
    return loss.detach(), tu.unflatten_like(params, grads), new_bn, aux


def train_step(cfg: sy.SNNDetConfig, ocfg: opt.AdamWConfig, params, bn, opt_state,
               images, targets, *, grad_mask=None):
    """One AdamW step. ``grad_mask``: a tree of {0, 1} masks like params
    (:func:`repro_torch.core.pruning.mask_tree`) — masked entries get zero
    gradient and are zeroed again after the update. Returns (params, bn,
    opt_state, loss)."""
    loss, grads, new_bn, _ = loss_and_grads(cfg, params, bn, images, targets)
    if grad_mask is not None:
        grads = tu.tree_map(lambda g, m: g * m, grads, grad_mask)
    new_p, new_o = opt.apply_updates(params, grads, opt_state, ocfg)
    if grad_mask is not None:
        new_p = tu.tree_map(lambda w, m: w * m, new_p, grad_mask)
    return new_p, new_bn, new_o, loss


def train_steps(cfg: sy.SNNDetConfig, *, steps: int, batch: int = 4, seed: int = 0,
                lr_peak: float = 2e-3, params=None, bn=None, opt_state=None,
                grad_mask=None, start_index: int = 0, log_every: int = 50,
                verbose: bool = True, source: Optional[dd.DetectionSource] = None,
                device=None):
    """Train (or fine-tune) the detector on a train split, TF32 off.

    ``params``/``bn`` default to :func:`snn_yolo.init_params` at ``seed`` on
    ``device`` (default: the card); given, they set the device.
    ``grad_mask``: see :func:`train_step`. ``start_index``: first dataset
    sample index — a fine-tune passes the samples an earlier stage consumed
    so it sees fresh data. Returns (params, bn, opt_state, losses)."""
    ocfg = train_config(steps, lr_peak)
    if params is None:
        params, bn = sy.init_params(cfg, seed=seed, device=device)
    dev = tu.leaves(params)[0].device
    if opt_state is None:
        opt_state = opt.init_state(params, ocfg)
    source = source or dd.SyntheticSource()
    stream = source.batches(batch, hw=cfg.input_hw, steps=steps,
                            grid_div=grid_div(cfg), num_anchors=cfg.num_anchors,
                            num_classes=cfg.num_classes, start_index=start_index)
    losses = []
    with sy._no_tf32():
        for k, b in enumerate(stream):
            params, bn, opt_state, loss = train_step(
                cfg, ocfg, params, bn, opt_state, torch.from_numpy(b["image"]).to(dev),
                torch.from_numpy(b["target"]).to(dev), grad_mask=grad_mask,
            )
            losses.append(float(loss))
            if verbose and k % log_every == 0:
                print(f"    step {k:4d} loss {losses[-1]:8.4f}")
    return params, bn, opt_state, losses


# ---------------------------------------------------------------- pipeline --


@dataclass
class EvalReport:
    """Pipeline output: per-stage mAP, schedule comparison, accumulator."""

    stages: dict  # stage name -> evaluate_detections report
    schedules: dict  # "mixed_1_3" / "uniform_t3" -> report
    accumulator: dict
    losses: dict  # stage -> loss curve
    wall_s: float
    # the final (qat-stage) compile_eval_detector handle, kept so callers
    # can re-score the same weights without retraining
    final_det: Optional[object] = None

    @property
    def map_by_stage(self) -> dict:
        return {k: v["map"] for k, v in self.stages.items()}

    @property
    def schedule_delta(self) -> float:
        """mAP(T=3) − mAP(mixed): Fig 15 says this stays small."""
        return self.schedules["uniform_t3"]["map"] - self.schedules["mixed_1_3"]["map"]

    def summary(self) -> dict:
        return {
            "map_by_stage": self.map_by_stage,
            "per_class_ap_final": self.stages["qat"]["per_class_ap"],
            "schedule_map": {k: v["map"] for k, v in self.schedules.items()},
            "schedule_delta_map": self.schedule_delta,
            "accumulator_max_abs": self.accumulator["max_abs"],
            "accumulator_within_16b": self.accumulator["within_16b"],
            "wall_s": self.wall_s,
        }


def run_pipeline(
    cfg: Optional[sy.SNNDetConfig] = None,
    *,
    steps: int = 400,
    finetune_steps: int = 80,
    batch: int = 4,
    eval_images: int = 32,
    prune_rate: float = 0.8,
    seed: int = 0,
    conv_exec: str = "dense",
    eval_shards: int = 1,
    source: Optional[dd.DetectionSource] = None,
    ckpt_dir: Optional[str] = None,
    verbose: bool = True,
    device=None,
    ctx=None,
) -> EvalReport:
    """The scaled-down Table I / Fig 15 reproduction on ``device`` (default:
    the card), which trains and runs every evaluation.

    Trains float, prunes, QAT-fine-tunes under the pruning mask, and
    evaluates mAP@0.5 after each stage; then compares the mixed (1, 3)
    schedule against uniform T=3 on the final weights. ``conv_exec``
    selects the executor of the quantized evaluations (``"pallas"``: the
    fused kernel). The executors agree exactly only under
    ``use_block_conv=True``, since the compressed ones always use block-conv
    borders, so a compressed ``conv_exec`` requires a block-conv config.

    ``eval_shards > 1`` routes every stage evaluation through the sharded
    path (:mod:`repro_torch.eval.sharded`, under ``ctx``'s processes when
    it is a multi-controller context); the reduction is exact, so the
    reports are bit-identical to ``eval_shards=1``'s. ``source`` swaps the
    dataset for training and evaluation (synthetic by default). ``ckpt_dir``
    commits a detector checkpoint after the float stage (step ``steps``) and
    after QAT (step ``steps + finetune_steps``), which ``launch/serve.py
    --checkpoint`` restores and serves.
    """
    t0 = time.time()
    base = cfg if cfg is not None else demo_config()
    if conv_exec != "dense" and not base.use_block_conv:
        raise ValueError(
            f"conv_exec={conv_exec!r} evaluates with block-conv border "
            "semantics, but the float training stages would use plain SAME "
            "conv (use_block_conv=False) — the stage deltas would mix "
            "executor semantics with compression effects. Pass a config "
            "with use_block_conv=True (demo_config's block_hw=(6, 10) "
            "divides every feature map) or keep conv_exec='dense'"
        )
    float_cfg = dataclasses.replace(base, weight_bits=0, conv_exec="dense")
    quant_cfg = dataclasses.replace(base, weight_bits=8, conv_exec=conv_exec)
    stages: dict = {}
    losses: dict = {}
    sharded_cfg = eval_shards if eval_shards > 1 else None
    source = source or dd.SyntheticSource()

    def _eval(tag, c, p, b):
        det = compile_eval_detector(c, p, b, device=device)
        stages[tag] = evaluate_detector(det, n_images=eval_images, sharded=sharded_cfg,
                                        source=source, ctx=ctx)
        if verbose:
            aps = ", ".join(f"{a:.3f}" for a in stages[tag]["per_class_ap"])
            print(f"  [{tag}] mAP@0.5 {stages[tag]['map']:.3f}  (per-class {aps})")
        return det

    if verbose:
        print(f"  train {steps} steps (float, mixed (1,{base.full_t}), "
              f"dataset {source.name})")
    params, bn, _, losses["train"] = train_steps(
        float_cfg, steps=steps, batch=batch, seed=seed, verbose=verbose,
        source=source, device=device,
    )
    if ckpt_dir:
        save_detector_checkpoint(ckpt_dir, steps, params, bn, float_cfg)
        if verbose:
            print(f"  saved float checkpoint (step {steps}) to {ckpt_dir}")
    _eval("trained", float_cfg, params, bn)

    pruned = pruning.prune_tree(params, prune_rate)
    _eval("pruned", float_cfg, pruned, bn)

    # QAT fine-tune: STE fake-quant weights, gradients masked to the
    # pruned support (the paper fine-tunes 5 epochs after prune+quantize)
    mask = pruning.mask_tree(params, prune_rate)
    qat_train_cfg = dataclasses.replace(base, weight_bits=8, conv_exec="dense")
    if verbose:
        print(f"  QAT fine-tune {finetune_steps} steps (FXP8, masked grads)")
    qp, qbn, _, losses["qat"] = train_steps(
        qat_train_cfg, steps=finetune_steps, batch=batch, params=pruned, bn=bn,
        grad_mask=mask, lr_peak=3e-4, start_index=steps * batch,
        verbose=verbose, source=source,
    )
    if ckpt_dir:
        save_detector_checkpoint(ckpt_dir, steps + finetune_steps, qp, qbn, quant_cfg)
        if verbose:
            print(f"  saved QAT checkpoint (step {steps + finetune_steps}) to {ckpt_dir}")
    det = _eval("qat", quant_cfg, qp, qbn)

    # Fig 15: the same final weights under both time-step schedules
    schedules = {
        "mixed_1_3": stages["qat"],
        "uniform_t3": evaluate_detector(
            compile_eval_detector(dataclasses.replace(quant_cfg, mixed_time=False), qp, qbn,
                                  device=device),
            n_images=eval_images, sharded=sharded_cfg, source=source, ctx=ctx,
        ),
    }
    report = EvalReport(
        stages=stages,
        schedules=schedules,
        accumulator=accumulator_report(det),
        losses=losses,
        wall_s=time.time() - t0,
        final_det=det,
    )
    if verbose:
        s = report.summary()
        print(f"  schedules: mixed {s['schedule_map']['mixed_1_3']:.3f} vs "
              f"T=3 {s['schedule_map']['uniform_t3']:.3f} "
              f"(delta {s['schedule_delta_map']:+.3f})")
        print(f"  accumulator max |acc| {s['accumulator_max_abs']} "
              f"(16b ok: {s['accumulator_within_16b']})  "
              f"wall {s['wall_s']:.0f}s")
    return report
