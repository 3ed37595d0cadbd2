"""Deterministic, host-striped LM token pipeline over a synthetic corpus.
A numpy copy of ``repro/data/lm_data.py``: the same generator calls in the
same order, so every batch is bit-equal to the JAX package's.

Batches are next-token pairs ``{"tokens", "labels"}`` (int32, (B, S)) drawn
from a Zipfian unigram mixture with a sticky bigram rule, so the loss is
learnable.

* Host-striped: host h of n takes document indices ``(step·B + b)·n + h``;
  the global batch is the union over hosts, with no coordination.
* Deterministic and restartable: batch t is a pure function of (seed,
  split, host, t); a restore sets ``start_step`` and the stream carries on.
* Prefetching: a background thread keeps ``prefetch`` batches ready; it
  ends when the stream is exhausted or its consumer stops reading.
"""
from __future__ import annotations

import queue
import threading
import zlib
from typing import Iterator, Optional

import numpy as np


def _doc(rng: np.random.Generator, length: int, vocab: int) -> np.ndarray:
    """Zipf unigrams + a sticky bigram chain → compressible structure."""
    base = rng.zipf(1.3, size=length).clip(1, vocab - 1)
    out = base.copy()
    stick = rng.random(length) < 0.35
    out[1:][stick[1:]] = (out[:-1][stick[1:]] * 7 + 11) % vocab  # bigram rule
    return out.astype(np.int32)


def batch_at(
    step: int,
    *,
    batch_size: int,
    seq_len: int,
    vocab: int,
    seed: int = 0,
    split: str = "train",
    host_id: int = 0,
    n_hosts: int = 1,
) -> dict:
    """The (host-local) batch for global step ``step``: a pure function."""
    rows = []
    for b in range(batch_size):
        idx = (step * batch_size + b) * n_hosts + host_id
        # crc32, not hash(): str hashing is salted per process
        rng = np.random.default_rng((zlib.crc32(split.encode()) & 0xFFFF, seed, idx))
        rows.append(_doc(rng, seq_len + 1, vocab))
    arr = np.stack(rows)
    return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}


def stream(
    *,
    batch_size: int,
    seq_len: int,
    vocab: int,
    start_step: int = 0,
    steps: Optional[int] = None,
    prefetch: int = 2,
    **kw,
) -> Iterator[dict]:
    """Prefetching, restartable stream of :func:`batch_at` results from
    ``start_step`` (``steps`` of them, or without end). The producer thread
    is joined when the stream ends or the generator is closed."""
    done = object()
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        t = start_step
        while steps is None or t < start_step + steps:
            if not put(batch_at(t, batch_size=batch_size, seq_len=seq_len, vocab=vocab, **kw)):
                return
            t += 1
        put(done)

    th = threading.Thread(target=producer, name="lm_data.stream", daemon=True)
    th.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            yield item
    finally:
        stop.set()
        th.join()
