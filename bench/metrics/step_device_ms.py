"""Device ms of the compiled detector's ``masked_step`` per tick, between
the CUDA events the engine core records around it."""
from bench import stats


def read(w):
    return stats.mean_per(sum(w.step_device_ms), len(w.step_device_ms))
