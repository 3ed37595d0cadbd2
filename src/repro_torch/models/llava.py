"""llava-next style VLM: the dense LM backbone and an anyres patch-embedding
stub. Counterpart of ``repro/models/llava.py``.

The vision tower is a stub, as in the JAX package: the caller supplies
the patch features (B, n_patches, D_VISION). The real parts are the
multimodal projector (a two-layer GELU MLP, llava-1.6's convention) and
the LM backbone (``models/transformer.py``). The projected patches are
put before the token embeddings; the LM loss is taken on the token suffix
only.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import LMConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as tfm

D_VISION = 1024  # CLIP-L/14 feature width (the stub frontend's output)


def init_params(gen: torch.Generator, cfg: LMConfig) -> dict:
    p = tfm.init_params(gen, cfg)
    p["mm_proj"] = {
        "w1": L._init(gen, (D_VISION, cfg.d_model), cfg.param_dtype),
        "w2": L._init(gen, (cfg.d_model, cfg.d_model), cfg.param_dtype),
    }
    return p


def param_axes(cfg: LMConfig) -> dict:
    a = tfm.param_axes(cfg)
    a["mm_proj"] = {"w1": (None, "embed"), "w2": ("embed", "embed2")}
    return a


def project_patches(params, patches: torch.Tensor) -> torch.Tensor:
    """(B, P, D_VISION) stub features → (B, P, d_model) LM embeddings."""
    p = params["mm_proj"]
    h = L.gelu(L._mm(patches.to(p["w1"].dtype), p["w1"]))
    return L._mm(h, p["w2"])


def make_loss_fn(cfg: LMConfig):
    base = tfm.make_loss_fn(cfg)

    def loss_fn(params, batch):
        embeds = project_patches(params, batch["patches"])
        return base(params, {**batch, "extra_embeds": embeds})

    return loss_fn


def make_prefill_fn(cfg: LMConfig):
    """The naive prefill with patches: (params, tokens, patches) → (last
    logits, KV of the patches and the tokens)."""

    def prefill(params, tokens, patches):
        embeds = project_patches(params, patches)
        logits, cache = tfm.forward(params, tokens, cfg, extra_embeds=embeds, collect_kv=True)
        return logits[:, -1], cache

    return prefill
