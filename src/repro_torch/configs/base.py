"""Config schema for the LM architectures and the shape sets assigned to
them (train_4k / prefill_32k / decode_32k / long_500k). A copy of
``repro/configs/base.py``: the same fields and defaults, so a config
written for one package reads the same in the other.

``param_dtype`` is a ``torch.dtype``. ``remat`` is read by the training
forward (each layer's block recomputed in the backward,
``torch.utils.checkpoint``; numbers unchanged). ``fsdp`` is read by the
training launcher: a multi-process launch of such a config keeps each
process's slices of every ``embed``-axis leaf of the train state
(``repro_torch.distributed.fsdp``), as JAX's launcher shards it over its
data devices. ``scan_layers`` is an XLA compile choice; the port keeps it
as data (its layers are always stacked (L, ...), as a scanned JAX model's
are, so parameters cross between the packages leaf for leaf).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Literal

import torch

Family = Literal["dense", "moe", "hybrid", "ssm", "vlm", "audio", "snn-det"]


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


# the four assigned LM shapes
SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class LMConfig:
    arch_id: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 → d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    attn_every: int = 0  # zamba2: one shared attn block every N mamba blocks
    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 1_500  # whisper audio frames after the conv frontend (stub)
    # --- modality frontend stubs ---
    frontend: Literal["none", "patches", "audio_frames"] = "none"
    n_patches: int = 0  # llava anyres patch embeddings per image
    # --- numerics ---
    dtype: str = "bfloat16"
    ffn_density: float = 1.0  # read by no model, in either package
    remat: bool = True
    scan_layers: bool = True
    fsdp: bool = False
    # serve path: the carried stacked KV cache written in place (cached_forward)
    # vs the naive forward that rebuilds the cache per layer
    serve_fast: bool = True
    # int8 KV cache with per-(token, head) scales — the paper's FXP8
    # quantization applied to the cache
    kv_quant: bool = False
    # which shapes this arch skips
    skip_shapes: tuple = ()

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def n_params(self) -> int:
        """Analytic parameter count (embedding + layers)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd, nh, nkv = self.hd, self.n_heads, self.n_kv_heads
        attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
        if self.qkv_bias:
            attn += (nh + 2 * nkv) * hd
        mlp = 3 * d * f
        if self.family == "moe":
            mlp = self.n_experts * 3 * d * f + self.n_shared_experts * 3 * d * f + d * self.n_experts
        per_layer = attn + mlp + 2 * d
        total = self.n_layers * per_layer + v * d + d
        if not self.tie_embeddings:
            total += d * v
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.family != "moe":
            return self.n_params()
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd, nh, nkv = self.hd, self.n_heads, self.n_kv_heads
        attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
        mlp = (self.top_k + self.n_shared_experts) * 3 * d * f + d * self.n_experts
        total = self.n_layers * (attn + mlp + 2 * d) + v * d + d
        if not self.tie_embeddings:
            total += d * v
        return total


def smoke_config(cfg):
    """Reduced same-family config for CPU smoke tests: few layers, small
    width/vocab/experts — structure preserved. LM configs shrink depth and
    width; the snn-det config shrinks its spatial extent
    (:func:`repro_torch.configs.snn_det.smoke_config`)."""
    from repro_torch.models.snn_yolo import SNNDetConfig  # lazy: avoid a cycle

    if isinstance(cfg, SNNDetConfig):
        from repro_torch.configs import snn_det

        return snn_det.smoke_config(cfg)
    return replace(
        cfg,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4),
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else cfg.ssm_head_dim,
        attn_every=min(cfg.attn_every, 2) if cfg.attn_every else 0,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=32 if cfg.encoder_layers else cfg.encoder_seq,
        n_patches=8 if cfg.n_patches else 0,
        dtype="float32",
        remat=False,
        fsdp=False,
        kv_quant=False,
    )
