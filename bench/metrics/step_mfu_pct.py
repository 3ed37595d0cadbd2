"""The whole step's share of the card's int8 peak: the operations every
frame served in the traced slice needs in its 28 convs (2 per nonzero
weight, input step and pixel; ``bench/cost.py``), over the slice's wall
seconds at 1979 TOP/s, in %. The count does not depend on what computes
it."""
from bench import cost


def read(w):
    if not w.nnz or w.frames <= 0 or w.seconds <= 0:
        return None
    return 100.0 * w.frames * cost.frame_ops(w.model, w.nnz) / (w.seconds * cost.INT8_OPS_PER_S)
