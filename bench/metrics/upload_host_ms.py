"""Host ms of frame upload (assembly into pinned memory and the start of
the copy, the engine core's ``upload_wall``) per tick."""
from bench import stats


def read(w):
    return stats.mean_per(sum(u * 1e3 for u in w.upload_wall), len(w.step_wall))
