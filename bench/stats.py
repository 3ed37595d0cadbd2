"""Rate and percentile arithmetic over a whole measured window.

The percentile is ``repro_torch.serve.detector.step_latency_ms``'s
(numpy's linear interpolation), taken over every tick of the window: the
window starts after the warm-up, so no tick is left out here."""
from __future__ import annotations

import numpy as np


def percentile_ms(walls_s: list, q: float) -> float:
    """The q-th percentile of host walls in seconds, in ms."""
    if not walls_s:
        raise ValueError("no ticks in the window")
    return float(np.percentile(np.asarray(walls_s, np.float64), q) * 1e3)


def rate(count: float, seconds: float) -> float:
    """Work per second over the window."""
    if seconds <= 0:
        raise ValueError("empty window")
    return float(count) / float(seconds)


def mean_per(total: float, count: int) -> float | None:
    """total / count, or None where nothing was counted."""
    return None if count <= 0 else float(total) / count
