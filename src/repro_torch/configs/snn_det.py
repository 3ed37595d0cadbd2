"""The paper's detector configuration (TCSI 2022): 1024×576 RGB input,
CSP backbone, YOLOv2 head, (1, 3) mixed time steps, FXP8 weights, 32×18
block convolution. A copy of ``repro/configs/snn_det.py``'s ``CONFIG``."""
from __future__ import annotations

import dataclasses

from repro_torch.models.snn_yolo import SNNDetConfig

CONFIG = SNNDetConfig(
    arch_id="snn-det",
    input_hw=(576, 1024),
    num_classes=3,
    num_anchors=5,
    full_t=3,
    threshold=0.5,
    leak=0.25,
    mode="snn",
    weight_bits=8,
    use_block_conv=True,
    mixed_time=True,
)


def smoke_config(cfg: SNNDetConfig = CONFIG) -> SNNDetConfig:
    """The JAX package's ``smoke_config`` for the detector: 24×32 input,
    narrow channels, block 6×8 — every macro layer and the (1, T) mixed
    schedule kept."""
    return dataclasses.replace(
        cfg,
        input_hw=(24, 32),
        stem_channels=8,
        conv_block_channels=8,
        stage_channels=((8, 8), (8, 8), (8, 16), (16, 16), (16, 16)),
        pooled_stages=1,
        block_hw=(6, 8),
    )
