"""One model API over every LM family (dense / moe / hybrid / ssm / vlm /
audio). Counterpart of ``repro/models/zoo.py``:

    init_params(seed, device=None)      -> params tree, drawn on the device
    loss_fn(params, batch)              -> mean next-token loss (f32 scalar)
    prefill_fn(params, tokens[, patches|frames][, cache]) -> (last logits, cache)
    decode_fn(params, cache, tok, pos)  -> (logits, cache)
    init_cache(batch, max_seq, ...)     -> cache (the recurrent state for ssm)

    param_axes()                        -> logical-axis tree (the params' structure)
    cache_axes(batch, max_seq)          -> logical-axis tree of the cache

The vlm batch carries ``patches`` (B, n_patches, D_VISION) and the audio
batch ``frames`` (B, encoder_seq, d_model), the stub frontends' outputs.
The MoE loss goes through :func:`moe.moe_block`, which is what the JAX
package's ``moe_block_ep`` computes on one device; the load-balance aux
loss is discarded in both packages.

:func:`input_specs` gives ``meta``-device stand-ins for every input of an
(arch × shape) cell (JAX's ``ShapeDtypeStruct`` s) and :func:`batch_axes`
their logical axes: what ``launch/dryrun.py`` counts and lays out.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.backend import resolve_device
from repro_torch.configs.base import LMConfig, ShapeSpec
from repro_torch.models import hybrid as hyb
from repro_torch.models import layers as L
from repro_torch.models import llava
from repro_torch.models import moe
from repro_torch.models import rwkv6
from repro_torch.models import transformer as tfm
from repro_torch.models import whisper


class ModelAPI(NamedTuple):
    cfg: LMConfig
    init_params: Callable  # (seed, device=None, specs=None) -> params (specs: this process's slices)
    loss_fn: Callable  # (params, batch) -> loss
    prefill_fn: Callable
    decode_fn: Callable
    init_cache: Callable  # (batch, max_seq, dtype=bf16, device=None) -> cache
    param_axes: Callable  # () -> logical axes, the params' structure
    cache_axes: Callable  # (batch, max_seq) -> logical axes, the cache's structure


class _MetaGen(NamedTuple):
    """Stands in for a generator on the ``meta`` device, which has none."""

    device: torch.device = torch.device("meta")


def _seeded(init_fn, cfg: LMConfig) -> Callable:
    """``init_params(seed, device=None, specs=None)`` over ``init_fn(gen,
    cfg)``; ``device="meta"`` gives the tree's shapes and dtypes without
    memory (JAX's ``eval_shape`` of ``init_params``). ``specs`` (the
    params' layout, ``fsdp.Shard`` per leaf; the dense, MoE and vlm
    families' ``init_fn`` take it): this process's slices, drawn a layer at
    a time."""

    def init_params(seed: int = 0, *, device=None, specs=None):
        dev = resolve_device(device)
        gen = _MetaGen() if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
        return init_fn(gen, cfg) if specs is None else init_fn(gen, cfg, specs=specs)

    return init_params


KV_AXES = ("layers", "batch", "kv_seq", "kv_heads", None)


def _dense_api(cfg: LMConfig, block_fn=tfm.dense_block, layer_init=tfm.layer_init,
               layer_ax=tfm.layer_axes, mlp_fn=None) -> ModelAPI:
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

    def cache_axes(batch, max_seq):
        if cfg.kv_quant:
            sc = KV_AXES[:-1]
            return tfm.QuantKVCache(KV_AXES, KV_AXES, sc, sc)
        return tfm.KVCache(KV_AXES, KV_AXES)

    return ModelAPI(
        cfg=cfg,
        init_params=_seeded(lambda gen, c, **kw: tfm.init_params(gen, c, layer_init, **kw), cfg),
        loss_fn=tfm.make_loss_fn(cfg, block_fn),
        prefill_fn=prefill,
        decode_fn=decode,
        init_cache=init_cache,
        param_axes=lambda: tfm.param_axes(cfg, layer_ax),
        cache_axes=cache_axes,
    )


def _moe_mlp_fn(cfg):
    def f(h, lp):
        out, _aux = moe.moe_mlp(h, lp["moe"], cfg)
        return out

    return f


def _moe_api(cfg: LMConfig) -> ModelAPI:
    return _dense_api(cfg, moe.moe_block, moe.moe_layer_init, moe.moe_layer_axes,
                      mlp_fn=_moe_mlp_fn(cfg))


def _vlm_api(cfg: LMConfig) -> ModelAPI:
    base = _dense_api(cfg)

    def prefill(params, tokens, patches, cache=None):
        embeds = llava.project_patches(params, patches)
        return base.prefill_fn(params, tokens, cache=cache, extra_embeds=embeds)

    return base._replace(
        init_params=_seeded(llava.init_params, cfg),
        loss_fn=llava.make_loss_fn(cfg),
        prefill_fn=prefill,
        param_axes=lambda: llava.param_axes(cfg),
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

    def cache_axes(batch, max_seq):
        def st_axes(lead):
            return hyb.mamba2.MambaState(h=lead + ("batch", "ssm_heads", None, None),
                                         conv=lead + ("batch", None, "mlp"))

        return hyb.HybridCache(
            mamba=st_axes(("layers", None)),
            tail=st_axes(("layers",)) if hyb.split_layers(cfg)[1] else None,
            attn_k=KV_AXES,
            attn_v=KV_AXES,
        )

    return ModelAPI(
        cfg=cfg,
        init_params=_seeded(hyb.init_params, cfg),
        loss_fn=loss_fn,
        prefill_fn=prefill,
        decode_fn=decode,
        init_cache=init_cache,
        param_axes=lambda: hyb.param_axes(cfg),
        cache_axes=cache_axes,
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

    def cache_axes(batch, max_seq):
        return rwkv6.RWKVState(
            s=("layers", "batch", "heads", None, None),
            x_tm=("layers", "batch", "act_embed"),
            x_cm=("layers", "batch", "act_embed"),
        )

    return ModelAPI(
        cfg=cfg,
        init_params=_seeded(rwkv6.init_params, cfg),
        loss_fn=loss_fn,
        prefill_fn=prefill,
        decode_fn=decode,
        init_cache=init_cache,
        param_axes=lambda: rwkv6.param_axes(cfg),
        cache_axes=cache_axes,
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
        param_axes=lambda: whisper.param_axes(cfg),
        cache_axes=lambda batch, max_seq: whisper.WhisperCache(KV_AXES, KV_AXES, KV_AXES,
                                                               KV_AXES),
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


# ------------------------------------------------------------ input specs --


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: LMConfig, shape: ShapeSpec) -> dict:
    """``meta`` tensors standing in for every input of this (arch × shape)
    cell — no memory behind them:

    train   -> {"batch": {...}}                         for loss_fn / a train step
    prefill -> {"args": (tokens[, patches|frames],)}    for prefill_fn
    decode  -> {"cache": ..., "token": ..., "pos": ...} for decode_fn
    """
    b, s = shape.global_batch, shape.seq_len
    tok = _meta((b, s), torch.int32)
    extra = None
    if cfg.family == "vlm":
        extra = _meta((b, cfg.n_patches, llava.D_VISION), torch.bfloat16)
    if cfg.family == "audio":
        extra = _meta((b, cfg.encoder_seq, cfg.d_model), torch.bfloat16)
    if shape.kind == "train":
        batch = {"tokens": tok, "labels": tok}
        if extra is not None:
            batch["patches" if cfg.family == "vlm" else "frames"] = extra
        return {"batch": batch}
    if shape.kind == "prefill":
        return {"args": (tok,) if extra is None else (tok, extra)}
    # decode: one new token against a populated cache of length S
    return {
        "cache": get_api(cfg).init_cache(b, s, device="meta"),
        "token": _meta((b,), torch.int32),
        "pos": _meta((), torch.int32),
    }


def batch_axes(cfg: LMConfig, shape: ShapeSpec) -> dict:
    """The logical axes of :func:`input_specs`' tree."""
    if shape.kind == "train":
        axes = {"tokens": ("batch", None), "labels": ("batch", None)}
        if cfg.family == "vlm":
            axes["patches"] = ("batch", None, None)
        if cfg.family == "audio":
            axes["frames"] = ("batch", None, None)
        return {"batch": axes}
    if shape.kind == "prefill":
        axes = [("batch", None)]
        if cfg.family in ("vlm", "audio"):
            axes.append(("batch", None, None))
        return {"args": tuple(axes)}
    return {
        "cache": get_api(cfg).cache_axes(shape.global_batch, shape.seq_len),
        "token": ("batch",),
        "pos": (),
    }
