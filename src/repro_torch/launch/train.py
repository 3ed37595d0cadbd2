"""LM training launcher: ``--arch <id>`` picks the architecture (a family
whose batch is tokens alone: dense, MoE, ssm or hybrid; the vlm and audio
families, whose batches also carry patches or frames, train through the
train step API, ``trainer.make_train_step(api.loss_fn, ...)``, as in the
JAX package, whose launcher feeds token batches too), the ``lm_data``
pipeline feeds it, and ``ft.Supervisor`` gives checkpoint/restart fault
tolerance with ``--ckpt``. Counterpart of
``repro/launch/train.py``: the same flags, the same step lines and the same
final ``loss a -> b, N tok/s`` line. Without ``--full-config`` it trains
the arch's smoke config.

Usage (one process):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --steps 50 --batch 8 --seq 64 [--microbatch 2] [--int8-moments] \\
      [--full-config] [--ckpt DIR] [--losses-out FILE] [--device cpu]

Data parallel (one invocation PER process, the same coordinator):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --coordinator 127.0.0.1:9876 --num-processes 2 --process-id <i> ...

``--batch`` is the GLOBAL batch; each host feeds ``batch / n_hosts`` rows
striped by the ``lm_data`` (host_id, n_hosts) contract, and the step
averages the gradients over the hosts (``trainer.make_train_step(ctx=)``).
Process ``i`` computes on card ``i % count`` (gloo where processes share a
card, NCCL where each has its own; ``--device cpu``: gloo on the CPU). Only
host 0 prints and writes ``--losses-out``; with ``--ckpt`` the checkpoints
are striped over the hosts and each writes ``hb_host{i}.json``.

Sharded state: where the arch's config sets ``fsdp`` (qwen1.5-32b,
qwen1.5-110b, llama3-405b here; llava-next-34b sets it too, and is trained
sharded through the train step API only: ``trainer.state_specs`` and
``make_train_step(ctx=, specs=)``), a multi-process launch builds
``sharding.default_rules(mesh, fsdp=True)`` on a (data = processes, model
= 1) mesh, as JAX's launcher does, and each process keeps only its slices
of every leaf with an ``embed`` axis (``repro_torch.distributed.fsdp``):
drawn a layer at a time and sliced (the whole tree is never held),
stepped, saved whole (the leaves gathered) and resumed slice by slice from
a checkpoint written by any number of processes. Each process prints its
state's bytes by part beside the whole state's. The smoke config keeps
the arch's ``fsdp``: sharding is the deployment's choice, not a width.

Runs on the card unless ``--device cpu``; exits non-zero when the loss did
not decrease.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from repro_torch import tree as tu
from repro_torch.backend import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.data import lm_data
from repro_torch.distributed import fsdp, runtime
from repro_torch.distributed import sharding as shd
from repro_torch.models import zoo
from repro_torch.train import ft
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=list(ARCH_IDS), required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8,
                    help="GLOBAL batch size (split across hosts)")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--full-config", action="store_true",
                    help="the full-size config instead of the smoke config")
    ap.add_argument("--int8-moments", action="store_true")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 — enables the multi-process launch")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--losses-out", default=None,
                    help="host 0 writes the per-step loss series here (json)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Returns :func:`train`'s dict; exits non-zero when the loss did not
    decrease."""
    args = parse_args(argv)
    if args.coordinator:
        ctx = runtime.initialize(coordinator_address=args.coordinator,
                                 num_processes=args.num_processes,
                                 process_id=args.process_id, device=args.device)
        try:
            res = train(args, ctx, ctx.device)
        finally:
            runtime.shutdown()
    else:
        res = train(args, runtime.get_context(), resolve_device(args.device))
    if res["losses"][-1] >= res["losses"][0]:
        raise SystemExit("loss did not decrease")
    return res


def launch_config(args):
    """The arch's config, or its smoke config with the arch's ``fsdp``."""
    cfg = get_config(args.arch)
    if args.full_config:
        return cfg
    return dataclasses.replace(smoke_config(cfg), fsdp=cfg.fsdp)


def state_bytes(state, specs, n_microbatch: int) -> dict:
    """This process's train state by part (the gradients: the step's, of
    the params' shapes, f32 under microbatching; the error-feedback
    ``residual`` where the state has one), and under ``"whole"`` the same
    parts made whole (``specs`` None: the state is whole)."""
    if specs is None:
        specs = tu.tree_map(lambda _: fsdp.WHOLE, state)
    grad_size = (lambda t: 4) if n_microbatch > 1 else (lambda t: t.element_size())

    def parts(numel):
        def total(tree, sp, size=lambda t: t.element_size()):
            return sum(numel(t, s) * size(t) for t, s in zip(tu.leaves(tree), tu.leaves(sp)))

        out = {"params": total(state.params, specs.params),
               "grads": total(state.params, specs.params, grad_size),
               "moments": total((state.opt.m, state.opt.v), (specs.opt.m, specs.opt.v))}
        if state.ef is not None:
            out["residual"] = total(state.ef.residual, specs.ef.residual)
        return out

    return {**parts(lambda t, s: t.numel()), "whole": parts(fsdp.whole_numel)}


def train(args, ctx, dev, cfg=None) -> dict:
    """The launcher's run on ``ctx``'s process (``cfg``: the launcher's
    config unless given). Returns {"losses", "grad_norms", "state",
    "specs", "steps_run", "seconds", "tok_per_s", "state_bytes"}; ``specs``
    is the state's layout (None when it is whole)."""
    if args.batch % ctx.n_hosts != 0:
        raise SystemExit(f"--batch {args.batch} is the GLOBAL batch and must divide over "
                         f"{ctx.n_hosts} hosts")
    local_batch = args.batch // ctx.n_hosts
    lead = ctx.host_id == 0

    cfg = cfg or launch_config(args)
    api = zoo.get_api(cfg)
    ocfg = opt.AdamWConfig(total_steps=args.steps, warmup_steps=max(args.steps // 10, 1),
                           int8_moments=args.int8_moments)
    specs = None
    if cfg.fsdp and ctx.is_multi_controller:
        rules = shd.default_rules(fsdp.mesh_for(ctx), fsdp=True)
        specs = trainer.state_specs(api.param_axes(), api.init_params(0, device="meta"), ocfg,
                                    rules, ctx)
    step_fn = trainer.make_train_step(api.loss_fn, ocfg, n_microbatch=args.microbatch, ctx=ctx,
                                      specs=specs)

    def init_state():
        params = api.init_params(0, device=dev, specs=None if specs is None else specs.params)
        return trainer.init_train_state(params, ocfg, specs=specs)

    losses, gnorms, ran = [], [], []  # loss, gradient norm, index of each step run here

    def run_step(state, t):
        local = lm_data.batch_at(t, batch_size=local_batch, seq_len=args.seq,
                                 vocab=cfg.vocab_size, host_id=ctx.host_id,
                                 n_hosts=ctx.n_hosts)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in local.items()}
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        ran.append(t)
        if lead and t % 10 == 0:
            print(f"step {t:5d} loss {losses[-1]:.4f} lr {float(m['lr']):.2e} "
                  f"gnorm {gnorms[-1]:.3f}", flush=True)
        return state

    t0 = time.time()
    if args.ckpt:
        hb = f"hb_host{ctx.host_id}.json" if ctx.is_multi_controller else "hb.json"
        sup = ft.Supervisor(ckpt_root=args.ckpt, save_every=20,
                            heartbeat=ft.Heartbeat(os.path.join(args.ckpt, hb)), ctx=ctx)
        state = sup.run(init_state=init_state, state_template=init_state, step_fn=run_step,
                        n_steps=args.steps, specs=specs)
    else:
        state = init_state()
        for t in range(args.steps):
            state = run_step(state, t)
    dt = time.time() - t0
    if not losses:
        raise SystemExit(f"{args.ckpt} already holds step {args.steps - 1}: nothing to run")
    toks = len(losses) * args.batch * args.seq
    sizes = state_bytes(state, specs, args.microbatch)
    if specs is not None:
        local, whole = (sum(v for k, v in d.items() if k != "whole")
                        for d in (sizes, sizes["whole"]))
        print(f"host {ctx.host_id}/{ctx.n_hosts}: state {local} of {whole} bytes whole "
              f"({local / whole:.3f}): " + ", ".join(
                  f"{k} {sizes[k]} of {sizes['whole'][k]}" for k in ("params", "grads",
                                                                     "moments")), flush=True)
    if lead:
        print(f"{args.arch}: {len(losses)} steps, loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
              f"{toks / dt:.0f} tok/s", flush=True)
    if args.losses_out and lead:
        with open(args.losses_out, "w") as f:
            json.dump(losses, f)
    return {"losses": losses, "grad_norms": gnorms, "state": state, "specs": specs,
            "steps_run": ran, "seconds": dt, "tok_per_s": toks / dt, "state_bytes": sizes}


if __name__ == "__main__":
    main()
