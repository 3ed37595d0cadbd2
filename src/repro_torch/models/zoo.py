"""One model API over every LM family (dense / moe / hybrid / ssm / vlm /
audio). Counterpart of ``repro/models/zoo.py``:

    init_params(seed, device=None)      -> params tree, drawn on the device
    loss_fn(params, batch)              -> mean next-token loss (f32 scalar)
    prefill_fn(params, tokens[, patches|frames][, cache]) -> (last logits, cache)
    decode_fn(params, cache, tok, pos)  -> (logits, cache)
    init_cache(batch, max_seq, ...)     -> cache (the recurrent state for ssm)

The vlm batch carries ``patches`` (B, n_patches, D_VISION) and the audio
batch ``frames`` (B, encoder_seq, d_model), the stub frontends' outputs.
The MoE loss goes through :func:`moe.moe_block`, which is what the JAX
package's ``moe_block_ep`` computes on one device; the load-balance aux
loss is discarded in both packages. The sharding metadata (``param_axes``,
``cache_axes``, ``input_specs``) waits for ROADMAP queue 1 item 9d.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.backend import resolve_device
from repro_torch.configs.base import LMConfig
from repro_torch.models import hybrid as hyb
from repro_torch.models import layers as L
from repro_torch.models import llava
from repro_torch.models import moe
from repro_torch.models import rwkv6
from repro_torch.models import transformer as tfm
from repro_torch.models import whisper


class ModelAPI(NamedTuple):
    cfg: LMConfig
    init_params: Callable  # (seed, device=None) -> params
    loss_fn: Callable  # (params, batch) -> loss
    prefill_fn: Callable
    decode_fn: Callable
    init_cache: Callable  # (batch, max_seq, dtype=bf16, device=None) -> cache


def _seeded(init_fn, cfg: LMConfig) -> Callable:
    """``init_params(seed, device=None)`` over ``init_fn(gen, cfg)``."""

    def init_params(seed: int = 0, *, device=None):
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
        return init_fn(gen, cfg)

    return init_params


def _dense_api(cfg: LMConfig, block_fn=tfm.dense_block, layer_init=tfm.layer_init,
               mlp_fn=None) -> ModelAPI:
    def init_cache(batch, max_seq, dtype=torch.bfloat16, *, device=None):
        dev = resolve_device(device)
        if cfg.kv_quant:
            return tfm.QuantKVCache.zeros(cfg, batch, max_seq, device=dev)
        return tfm.KVCache.zeros(cfg, batch, max_seq, dtype, device=dev)

    def decode(params, cache, token, pos):
        if cfg.serve_fast:  # the carried cache, written in place
            return tfm.cached_forward(params, token[:, None], cfg, cache, pos, mlp_fn=mlp_fn)
        return tfm.make_decode_fn(cfg, block_fn)(params, cache, token, pos)

    def prefill(params, tokens, valid_len=None, cache=None, *, extra_embeds=None):
        """``cache``: serve_fast's (L, B, S, ...) cache to write the prompt
        (``extra_embeds`` first) into (every row is written before it is
        read, so a buffer may be reused); a new one when None."""
        if cfg.serve_fast:
            if cache is None:
                s = tokens.shape[1] + (extra_embeds.shape[1] if extra_embeds is not None else 0)
                cache = init_cache(tokens.shape[0], s, device=tokens.device)
            return tfm.cached_forward(params, tokens, cfg, cache, 0, mlp_fn=mlp_fn,
                                      extra_embeds=extra_embeds, valid_len=valid_len)
        if cache is not None:
            raise ValueError("cache= is the serve_fast path's; the naive prefill builds its own")
        return tfm.make_prefill_fn(cfg, block_fn)(params, tokens, valid_len=valid_len,
                                                  extra_embeds=extra_embeds)

    return ModelAPI(
        cfg=cfg,
        init_params=_seeded(lambda gen, c: tfm.init_params(gen, c, layer_init), cfg),
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


def _vlm_api(cfg: LMConfig) -> ModelAPI:
    base = _dense_api(cfg)

    def prefill(params, tokens, patches, cache=None):
        embeds = llava.project_patches(params, patches)
        return base.prefill_fn(params, tokens, cache=cache, extra_embeds=embeds)

    return base._replace(
        init_params=_seeded(llava.init_params, cfg),
        loss_fn=llava.make_loss_fn(cfg),
        prefill_fn=prefill,
    )


def _hybrid_api(cfg: LMConfig) -> ModelAPI:
    def loss_fn(params, batch):
        logits, _ = hyb.forward(params, batch["tokens"], cfg)
        return L.cross_entropy(logits[:, :-1], batch["labels"][:, 1:])

    def prefill(params, tokens):
        logits, cache = hyb.forward(params, tokens, cfg, collect_kv=True)
        return logits[:, -1], cache

    def decode(params, cache, token, pos):
        if cfg.serve_fast:  # the carried cache, written in place
            return hyb.cached_decode(params, token, cfg, cache, pos)
        logits, new_cache = hyb.forward(params, token[:, None], cfg, cache=cache,
                                        cache_pos=pos)
        return logits[:, 0], new_cache

    def init_cache(batch, max_seq, dtype=torch.bfloat16, *, device=None):
        return hyb.init_cache(cfg, batch, max_seq, dtype, device=resolve_device(device))

    return ModelAPI(
        cfg=cfg,
        init_params=_seeded(hyb.init_params, cfg),
        loss_fn=loss_fn,
        prefill_fn=prefill,
        decode_fn=decode,
        init_cache=init_cache,
    )


def _ssm_api(cfg: LMConfig) -> ModelAPI:
    def loss_fn(params, batch):
        logits, _ = rwkv6.forward(params, batch["tokens"], cfg)
        return L.cross_entropy(logits[:, :-1], batch["labels"][:, 1:])

    def prefill(params, tokens):
        state = rwkv6.init_cache(cfg, tokens.shape[0], device=tokens.device)
        logits, new_state = rwkv6.forward(params, tokens, cfg, state=state)
        return logits[:, -1], new_state

    def decode(params, cache, token, pos):
        del pos  # the recurrent state carries the position
        logits, new_state = rwkv6.forward(params, token[:, None], cfg, state=cache)
        return logits[:, 0], new_state

    def init_cache(batch, max_seq=None, *, device=None):
        del max_seq  # O(1) in the sequence length
        return rwkv6.init_cache(cfg, batch, device=resolve_device(device))

    return ModelAPI(
        cfg=cfg,
        init_params=_seeded(rwkv6.init_params, cfg),
        loss_fn=loss_fn,
        prefill_fn=prefill,
        decode_fn=decode,
        init_cache=init_cache,
    )


def _audio_api(cfg: LMConfig) -> ModelAPI:
    def loss_fn(params, batch):
        enc = whisper.encode(params, batch["frames"], cfg)
        cross = whisper.cross_kv(params, enc, cfg)
        logits, _ = whisper.decoder_forward(params, batch["tokens"], cfg, cross)
        return L.cross_entropy(logits[:, :-1], batch["labels"][:, 1:])

    def prefill(params, tokens, frames, cache=None):
        """``cache``: a decode cache to write the prompt's self K/V (rows
        [:T]) and the cross K/V into, cast to its dtype; the prompt's own
        T-row cache when None."""
        enc = whisper.encode(params, frames, cfg)
        cross = whisper.cross_kv(params, enc, cfg)
        logits, small = whisper.decoder_forward(params, tokens, cfg, cross, collect_kv=True)
        if cache is None:
            return logits[:, -1], small
        for dst, src in zip(cache, small):
            dst[:, :, :src.shape[2]] = src.to(dst.dtype)
        return logits[:, -1], cache

    def decode(params, cache, token, pos):
        cross = (cache.cross_k, cache.cross_v)
        logits, new_cache = whisper.decoder_forward(params, token[:, None], cfg, cross,
                                                    cache=cache, cache_pos=pos)
        return logits[:, 0], new_cache

    def init_cache(batch, max_seq, dtype=torch.bfloat16, *, device=None):
        dev = resolve_device(device)
        kv = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
        ckv = (cfg.n_layers, batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.hd)
        return whisper.WhisperCache(*(torch.zeros(shape, dtype=dtype, device=dev)
                                      for shape in (kv, kv, ckv, ckv)))

    return ModelAPI(
        cfg=cfg,
        init_params=_seeded(whisper.init_params, cfg),
        loss_fn=loss_fn,
        prefill_fn=prefill,
        decode_fn=decode,
        init_cache=init_cache,
    )


_FAMILIES = {
    "dense": _dense_api,
    "moe": _moe_api,
    "vlm": _vlm_api,
    "hybrid": _hybrid_api,
    "ssm": _ssm_api,
    "audio": _audio_api,
}


def get_api(cfg: LMConfig) -> ModelAPI:
    return _FAMILIES[cfg.family](cfg)
