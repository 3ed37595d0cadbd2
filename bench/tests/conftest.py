"""The benchmark's CPU tests: ``python -m pytest bench/tests`` from the
repository's root. They run the program's plain versions at the detector's
smoke size; the ``gpu`` tests skip without a card."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

# the detector's smoke size (the program's configs/snn_det.py smoke_config)
SMOKE = {"input_hw": [24, 32], "stem_channels": 8, "conv_block_channels": 8,
         "stage_channels": [[8, 8], [8, 8], [8, 16], [16, 16], [16, 16]],
         "pooled_stages": 1, "block_hw": [6, 8]}


def smoke(config: dict) -> dict:
    config = dict(config)
    config["model"] = {**config["model"], **SMOKE}
    return config
