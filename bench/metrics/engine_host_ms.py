"""Host ms a tick spends outside the compiled detector's device step: the
engine core's own tick wall (``step_wall``) less the device time between
the events around ``masked_step`` (``step_device_ms``), per tick."""
from bench import stats


def read(w):
    if not w.step_device_ms:
        return None
    host = sum(s * 1e3 for s in w.step_wall) - sum(w.step_device_ms)
    return stats.mean_per(host, len(w.step_device_ms))
