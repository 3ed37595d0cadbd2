"""One model API over the LM families. Counterpart of
``repro/models/zoo.py`` for the families the port serves and trains, dense
and moe:

    init_params(seed, device=None)      -> params tree, drawn on the device
    loss_fn(params, batch)              -> mean next-token loss (f32 scalar)
    prefill_fn(params, tokens, ...)     -> (last logits, cache)
    decode_fn(params, cache, tok, pos)  -> (logits, cache)
    init_cache(batch, max_seq, ...)     -> cache

The MoE loss goes through :func:`moe.moe_block`, which is what the JAX
package's ``moe_block_ep`` computes on one device; the load-balance aux
loss is discarded in both packages. The sharding metadata (``param_axes``,
``cache_axes``) waits for ROADMAP queue 1 item 9d; the vlm, hybrid, ssm and
audio families raise :class:`NotImplementedError` (item 9c).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.backend import resolve_device
from repro_torch.configs.base import LMConfig
from repro_torch.models import moe
from repro_torch.models import transformer as tfm


class ModelAPI(NamedTuple):
    cfg: LMConfig
    init_params: Callable  # (seed, device=None) -> params
    loss_fn: Callable  # (params, batch) -> loss
    prefill_fn: Callable
    decode_fn: Callable
    init_cache: Callable  # (batch, max_seq, dtype=bf16, device=None) -> cache


def _dense_api(cfg: LMConfig, block_fn=tfm.dense_block, layer_init=tfm.layer_init,
               mlp_fn=None) -> ModelAPI:
    def init_params(seed: int = 0, *, device=None):
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        return tfm.init_params(gen, cfg, layer_init)

    def init_cache(batch, max_seq, dtype=torch.bfloat16, *, device=None):
        dev = resolve_device(device)
        if cfg.kv_quant:
            return tfm.QuantKVCache.zeros(cfg, batch, max_seq, device=dev)
        return tfm.KVCache.zeros(cfg, batch, max_seq, dtype, device=dev)

    def decode(params, cache, token, pos):
        if cfg.serve_fast:  # the carried cache, written in place
            return tfm.cached_forward(params, token[:, None], cfg, cache, pos, mlp_fn=mlp_fn)
        return tfm.make_decode_fn(cfg, block_fn)(params, cache, token, pos)

    def prefill(params, tokens, valid_len=None, cache=None):
        """``cache``: serve_fast's (L, B, S, ...) cache to write the prompt
        into (every row is written before it is read, so a buffer may be
        reused); a new one when None."""
        if cfg.serve_fast:
            if cache is None:
                cache = init_cache(*tokens.shape, device=tokens.device)
            return tfm.cached_forward(params, tokens, cfg, cache, 0, mlp_fn=mlp_fn,
                                      valid_len=valid_len)
        if cache is not None:
            raise ValueError("cache= is the serve_fast path's; the naive prefill builds its own")
        return tfm.make_prefill_fn(cfg, block_fn)(params, tokens, valid_len=valid_len)

    return ModelAPI(
        cfg=cfg,
        init_params=init_params,
        loss_fn=tfm.make_loss_fn(cfg, block_fn),
        prefill_fn=prefill,
        decode_fn=decode,
        init_cache=init_cache,
    )


def _moe_mlp_fn(cfg):
    def f(h, lp):
        out, _aux = moe.moe_mlp(h, lp["moe"], cfg)
        return out

    return f


def _moe_api(cfg: LMConfig) -> ModelAPI:
    return _dense_api(cfg, moe.moe_block, moe.moe_layer_init, mlp_fn=_moe_mlp_fn(cfg))


_FAMILIES = {
    "dense": _dense_api,
    "moe": _moe_api,
}


def get_api(cfg: LMConfig) -> ModelAPI:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"{cfg.arch_id}: the {cfg.family} family is not ported yet "
            f"(ROADMAP.md queue 1 item 9c); the port serves {sorted(_FAMILIES)}"
        )
    return _FAMILIES[cfg.family](cfg)
