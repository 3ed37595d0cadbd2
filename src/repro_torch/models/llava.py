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
from repro_torch.distributed import fsdp
from repro_torch.models import layers as L
from repro_torch.models import transformer as tfm

D_VISION = 1024  # CLIP-L/14 feature width (the stub frontend's output)


def init_params(gen: torch.Generator, cfg: LMConfig, specs=None) -> dict:
    """The backbone's parameters, then the projector's. ``specs``: the
    params' layout over the processes (``fsdp.Shard`` per leaf, from
    :func:`param_axes`): the same draws, and only this process's slices
    kept (the backbone a layer at a time)."""
    p = tfm.init_params(gen, cfg, specs=specs)
    mm = {
        "w1": L._init(gen, (D_VISION, cfg.d_model), cfg.param_dtype),
        "w2": L._init(gen, (cfg.d_model, cfg.d_model), cfg.param_dtype),
    }
    p["mm_proj"] = mm if specs is None else fsdp.shard_tree(mm, specs["mm_proj"])
    return p


def param_axes(cfg: LMConfig) -> dict:
    a = tfm.param_axes(cfg)
    a["mm_proj"] = {"w1": (None, "embed"), "w2": ("embed", "embed2")}
    return a


def project_patches(params, patches: torch.Tensor) -> torch.Tensor:
    """(B, P, D_VISION) stub features → (B, P, d_model) LM embeddings. In
    the sharded train step ``params["mm_proj"]`` is an ``fsdp.Gathered``:
    each weight is gathered where it is read here, and its gradient
    reduce-scattered back to this process's slice."""
    p = params["mm_proj"]
    w1, w2 = p["w1"], p["w2"]  # one read each: a read of a Gathered is a gather
    h = L.gelu(L._mm(patches.to(w1.dtype), w1))
    return L._mm(h, w2)


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
