"""Device ms per tick of every kernel that is not one of the program's
hand-written CUDA kernels (the forward's eager passes, the postprocess,
the masks), from the profiler's trace."""
from bench import stats, trace


def read(w):
    if w.trace is None or not w.trace.device:
        return None
    return stats.mean_per(w.trace.kernel_s(exclude=trace.PORT_KERNELS) * 1e3, len(w.step_wall))
