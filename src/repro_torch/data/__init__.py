"""Data sources (numpy only): port-owned copies of ``repro.data`` — the
detection datasets and the LM token pipeline (:mod:`.lm_data`)."""
from repro_torch.data import lm_data

__all__ = ["lm_data"]
