"""Traffic: the frame pool and the closed-loop clients, read from a traffic
file's parameters.

The pool is a copy of ``repro_torch.serve.detector.synth_streams``'s
frames (u8-grid values k / 255, exact under the 8-bit encode), drawn on the
device from the seed in a few large calls and kept in host memory: every
request's frames are a view into it, so admission copies nothing.

Closed loop: each client has one request in flight and submits its next
when the last one finishes; every request has ``frames_per_request``
frames. The warm-up may start with a wave of one request
a client of ``warmup_frames`` frames, run until every one has left (so a
join, a step, a leave and the buckets' regrowth have run before the
window). Request ``j`` of client ``i`` starts at an offset
drawn from (seed, i, j) alone, so a seed gives the same inputs whatever
order the requests finish in, and every seed the same sizes.
"""
from __future__ import annotations

import random
from dataclasses import dataclass

import numpy as np
import torch

POOL_CHUNK = 16  # frames drawn per call on the device


def sub_seed(seed: int, stream: int) -> int:
    """A generator seed of its own for each use of the run's seed."""
    return (int(seed) * 1_000_003 + stream) % (1 << 63)


def frame_pool(n_frames: int, hw, seed: int, device) -> np.ndarray:
    """(n_frames, H, W, 3) float32 frames on the u8 grid, in host memory."""
    h, w = hw
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    pool = np.empty((n_frames, h, w, 3), np.float32)
    for i in range(0, n_frames, POOL_CHUNK):
        k = min(POOL_CHUNK, n_frames - i)
        u8 = torch.randint(0, 256, (k, h, w, 3), generator=gen, device=device,
                           dtype=torch.uint8)
        pool[i:i + k] = (u8.float() / 255.0).cpu().numpy()
    return pool


@dataclass(frozen=True)
class Traffic:
    """A traffic file's parameters (see ``bench/traffic/*.json``)."""

    n_slots: int
    clients: int
    frames_per_request: int
    pool_frames: int
    warmup_ticks: int
    compare_requests: int
    reference_batch: int
    warmup_frames: int = 0  # frames of a first wave of requests run to its end

    @classmethod
    def from_json(cls, d: dict) -> "Traffic":
        if d.get("loop") != "closed":
            raise ValueError(f"traffic loop {d.get('loop')!r}: only 'closed' is generated")
        t = cls(n_slots=d["n_slots"], clients=d["clients"],
                frames_per_request=d["frames_per_request"],
                pool_frames=d["pool_frames"], warmup_ticks=d["warmup_ticks"],
                compare_requests=d["compare_requests"], reference_batch=d["reference_batch"],
                warmup_frames=d.get("warmup_frames", 0))
        if t.frames_per_request > t.pool_frames:
            raise ValueError("a request is longer than the frame pool")
        return t


class ClosedLoop:
    """The clients: ``first()`` gives every client's first request,
    ``next(client)`` its next one, each as (rid, client, frames view)."""

    def __init__(self, traffic: Traffic, pool: np.ndarray, seed: int):
        self.t = traffic
        self.pool = pool
        self.seed = int(seed)
        self.sent = [0] * traffic.clients
        self.rid = 0

    def _make(self, client: int):
        j = self.sent[client]
        self.sent[client] += 1
        t = self.t
        n = t.frames_per_request
        rng = random.Random(sub_seed(self.seed, 1_000 + client * 1_000_003 + j))
        off = rng.randrange(0, t.pool_frames - n + 1)
        self.rid += 1
        return self.rid - 1, client, self.pool[off:off + n]

    def first(self) -> list:
        return [self._make(c) for c in range(self.t.clients)]

    def next(self, client: int):
        return self._make(client)
