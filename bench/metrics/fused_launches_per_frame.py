"""Launches of the fused conv-tdBN-LIF kernel per frame served (the
program's ``backend.launches`` counter)."""
from bench import stats


def read(w):
    return stats.mean_per(w.launches.get("fused_pipeline", 0), w.frames)
