"""The fused kernel's share of its roofline: the least time of every fused
launch in the traced slice (``bench/cost.py``, logical shapes, each step's
capacity) over the kernel's device time in the trace, in %."""
from bench import cost, trace


def read(w):
    if w.trace is None or not w.batches or not w.nnz:
        return None
    spent = w.trace.kernel_s(trace.FUSED_KERNEL)
    if spent <= 0:
        return None
    least = sum(cost.tick_least_s(w.model, w.nnz, b) for b in w.batches)
    return 100.0 * least / spent
