"""LM training launcher, single controller: ``--arch <id>`` picks the
architecture (dense or MoE), the ``lm_data`` pipeline feeds it, and
``ft.Supervisor`` gives checkpoint/restart fault tolerance with ``--ckpt``.
Counterpart of ``repro/launch/train.py``'s single-controller branch: the
same flags, the same step lines and the same final ``loss a -> b, N tok/s``
line. Without ``--full-config`` it trains the arch's smoke config.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --steps 50 --batch 8 --seq 64 [--microbatch 2] [--int8-moments] \\
      [--full-config] [--ckpt DIR] [--losses-out FILE] [--device cpu]

Runs on the card unless ``--device cpu``; exits non-zero when the loss did
not decrease. ``--coordinator``, ``--num-processes`` and ``--process-id``
(the multi-controller launch) are ROADMAP queue 1 item 7.
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
from repro_torch.models import zoo
from repro_torch.train import ft
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer


def main(argv=None) -> dict:
    """Returns {"losses", "state", "steps_run", "seconds", "tok_per_s"}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=list(ARCH_IDS), required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8, help="GLOBAL batch size")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--full-config", action="store_true",
                    help="the full-size config instead of the smoke config")
    ap.add_argument("--int8-moments", action="store_true")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 (multi-controller: ROADMAP item 7)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--losses-out", default=None,
                    help="write the per-step loss series here (json)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.coordinator or args.num_processes is not None or args.process_id is not None:
        raise NotImplementedError(
            "--coordinator/--num-processes/--process-id: the multi-controller launch is not "
            "ported yet (ROADMAP.md queue 1 item 7); run one process without them")
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = smoke_config(cfg)
    api = zoo.get_api(cfg)
    ocfg = opt.AdamWConfig(total_steps=args.steps, warmup_steps=max(args.steps // 10, 1),
                           int8_moments=args.int8_moments)
    step_fn = trainer.make_train_step(api.loss_fn, ocfg, n_microbatch=args.microbatch)

    def init_state():
        return trainer.init_train_state(api.init_params(0, device=dev), ocfg)

    losses, ran = [], []  # the loss and index of each step this invocation ran

    def run_step(state, t):
        local = lm_data.batch_at(t, batch_size=args.batch, seq_len=args.seq,
                                 vocab=cfg.vocab_size)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in local.items()}
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        ran.append(t)
        if t % 10 == 0:
            print(f"step {t:5d} loss {losses[-1]:.4f} lr {float(m['lr']):.2e} "
                  f"gnorm {float(m['grad_norm']):.3f}", flush=True)
        return state

    t0 = time.time()
    if args.ckpt:
        sup = ft.Supervisor(ckpt_root=args.ckpt, save_every=20,
                            heartbeat=ft.Heartbeat(os.path.join(args.ckpt, "hb.json")))
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
    print(f"{args.arch}: {len(losses)} steps, loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
          f"{toks / dt:.0f} tok/s", flush=True)
    if args.losses_out:
        with open(args.losses_out, "w") as f:
            json.dump(losses, f)
    if losses[-1] >= losses[0]:
        raise SystemExit("loss did not decrease")
    return {"losses": losses, "state": state, "steps_run": ran, "seconds": dt,
            "tok_per_s": toks / dt}


if __name__ == "__main__":
    main()
