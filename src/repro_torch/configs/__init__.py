"""Architecture registry of the PyTorch port: ``get_config("<arch-id>")``
resolves every architecture the JAX package configures (the ten LM cells
plus the paper's own snn-det) to the same config, as
``repro/configs/__init__.py`` does. ``--arch`` flags look up here."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, LMConfig, ShapeSpec, smoke_config

# arch-id -> module holding CONFIG
_MODULES = {
    "qwen1.5-0.5b": "repro_torch.configs.qwen1_5_0_5b",
    "qwen1.5-32b": "repro_torch.configs.qwen1_5_32b",
    "qwen1.5-110b": "repro_torch.configs.qwen1_5_110b",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "llava-next-34b": "repro_torch.configs.llava_next_34b",
    "whisper-small": "repro_torch.configs.whisper_small",
    "snn-det": "repro_torch.configs.snn_det",
}

ARCH_IDS = tuple(k for k in _MODULES if k != "snn-det")  # the 10 LM cells
ALL_IDS = tuple(_MODULES)


def get_config(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id]).CONFIG


def cells(include_skipped: bool = False):
    """All assigned (arch, shape) cells. Skipped cells (see each config's
    skip_shapes) are excluded unless include_skipped."""
    out = []
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPES.values():
            if s.name in cfg.skip_shapes and not include_skipped:
                continue
            out.append((a, s.name))
    return out


__all__ = [
    "ARCH_IDS",
    "ALL_IDS",
    "SHAPES",
    "LMConfig",
    "ShapeSpec",
    "cells",
    "get_config",
    "smoke_config",
]
