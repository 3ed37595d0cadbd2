"""LM training launcher: ``--arch <id>`` picks the architecture (a family
whose batch is tokens alone: dense, MoE, ssm or hybrid), the ``lm_data``
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

Runs on the card unless ``--device cpu``; exits non-zero when the loss did
not decrease.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.backend import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, smoke_config
from repro_torch.data import lm_data
from repro_torch.distributed import runtime
from repro_torch.models import zoo
from repro_torch.train import ft
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer


def main(argv=None) -> dict:
    """Returns {"losses", "state", "steps_run", "seconds", "tok_per_s"}."""
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
    args = ap.parse_args(argv)
    if args.coordinator:
        ctx = runtime.initialize(coordinator_address=args.coordinator,
                                 num_processes=args.num_processes,
                                 process_id=args.process_id, device=args.device)
        try:
            return _train(args, ctx, ctx.device)
        finally:
            runtime.shutdown()
    return _train(args, runtime.get_context(), resolve_device(args.device))


def _train(args, ctx, dev) -> dict:
    if args.batch % ctx.n_hosts != 0:
        raise SystemExit(f"--batch {args.batch} is the GLOBAL batch and must divide over "
                         f"{ctx.n_hosts} hosts")
    local_batch = args.batch // ctx.n_hosts
    lead = ctx.host_id == 0

    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = smoke_config(cfg)
    api = zoo.get_api(cfg)
    ocfg = opt.AdamWConfig(total_steps=args.steps, warmup_steps=max(args.steps // 10, 1),
                           int8_moments=args.int8_moments)
    step_fn = trainer.make_train_step(api.loss_fn, ocfg, n_microbatch=args.microbatch, ctx=ctx)

    def init_state():
        return trainer.init_train_state(api.init_params(0, device=dev), ocfg)

    losses, ran = [], []  # the loss and index of each step this invocation ran

    def run_step(state, t):
        local = lm_data.batch_at(t, batch_size=local_batch, seq_len=args.seq,
                                 vocab=cfg.vocab_size, host_id=ctx.host_id,
                                 n_hosts=ctx.n_hosts)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in local.items()}
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        ran.append(t)
        if lead and t % 10 == 0:
            print(f"step {t:5d} loss {losses[-1]:.4f} lr {float(m['lr']):.2e} "
                  f"gnorm {float(m['grad_norm']):.3f}", flush=True)
        return state

    t0 = time.time()
    if args.ckpt:
        hb = f"hb_host{ctx.host_id}.json" if ctx.is_multi_controller else "hb.json"
        sup = ft.Supervisor(ckpt_root=args.ckpt, save_every=20,
                            heartbeat=ft.Heartbeat(os.path.join(args.ckpt, hb)), ctx=ctx)
        state = sup.run(init_state=init_state, state_template=init_state, step_fn=run_step,
                        n_steps=args.steps)
    else:
        state = init_state()
        for t in range(args.steps):
            state = run_step(state, t)
    dt = time.time() - t0
    if not losses:
        raise SystemExit(f"{args.ckpt} already holds step {args.steps - 1}: nothing to run")
    toks = len(losses) * args.batch * args.seq
    if lead:
        print(f"{args.arch}: {len(losses)} steps, loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
              f"{toks / dt:.0f} tok/s", flush=True)
    if args.losses_out and lead:
        with open(args.losses_out, "w") as f:
            json.dump(losses, f)
    if losses[-1] >= losses[0]:
        raise SystemExit("loss did not decrease")
    return {"losses": losses, "state": state, "steps_run": ran, "seconds": dt,
            "tok_per_s": toks / dt}


if __name__ == "__main__":
    main()
