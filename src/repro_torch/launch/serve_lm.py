"""Batched LM serving with continuous batching: a reduced qwen-family model
behind the Engine, a burst of requests with mixed prompt lengths, and
throughput accounting. Also demos the recurrent-state families (rwkv6 /
zamba2) behind the SAME serving API — their O(1) state is why they run the
long_500k cell. Counterpart of ``examples/serve_lm.py``, with its prints,
plus ``--device``.

Usage:  PYTHONPATH=src python -m repro_torch.launch.serve_lm [--device cpu]

Each arch serves at ``smoke_config``: 12 requests (prompts of 3–23 tokens,
4–16 new tokens, from numpy ``default_rng(0)`` as in the JAX example) in 4
slots of 128 cache rows. Runs on the card unless ``--device cpu``; the
weights are the port's own, seeded (``serve_burst`` takes carried-across
``params``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.backend import resolve_device, synchronize
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import zoo
from repro_torch.serve import Engine, Request

ARCHS = ("qwen1.5-0.5b", "olmoe-1b-7b", "rwkv6-3b", "zamba2-7b")
MAX_SEQ = 128


def serve_burst(arch: str, n_requests: int = 12, n_slots: int = 4, *, params=None,
                device=None) -> dict:
    """Serve the burst through ``Engine``; returns the finished requests
    (``done``, each with its ``out`` tokens), the new tokens, the seconds
    and the tokens per second."""
    cfg = smoke_config(get_config(arch))
    dev = resolve_device(device)
    if params is None:
        params = zoo.get_api(cfg).init_params(0, device=dev)
    eng = Engine(cfg, params, n_slots=n_slots, max_seq=MAX_SEQ)
    rng = np.random.default_rng(0)
    total_new = 0
    for r in range(n_requests):
        plen = int(rng.integers(3, 24))
        n_new = int(rng.integers(4, 17))
        total_new += n_new
        eng.submit(Request(rid=r, prompt=[int(t) for t in rng.integers(1, cfg.vocab_size, plen)],
                           max_new_tokens=n_new))
    synchronize(dev)
    t0 = time.perf_counter()
    done = eng.run()
    synchronize(dev)
    dt = time.perf_counter() - t0
    if len(done) != n_requests:
        raise AssertionError(f"{arch}: {len(done)} of {n_requests} requests finished")
    return {"arch": arch, "done": list(done), "n_requests": n_requests, "n_slots": n_slots,
            "new_tokens": total_new, "seconds": dt, "tokens_per_s": total_new / dt,
            "device": dev.type}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = {}
    for arch in ARCHS:
        r = out[arch] = serve_burst(arch, device=args.device)
        print(f"{arch:14s} {r['n_requests']} reqs / {r['n_slots']} slots: "
              f"{r['new_tokens']} tokens in {r['seconds']:5.1f}s "
              f"({r['tokens_per_s']:6.1f} tok/s {r['device'].upper()}, continuous batching)")
    print("serve_lm OK")
    return out


if __name__ == "__main__":
    main()
