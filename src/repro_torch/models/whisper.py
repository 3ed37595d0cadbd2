"""Whisper-style encoder–decoder backbone (whisper-small). Counterpart of
``repro/models/whisper.py``. The conv audio frontend is a stub, as in the
JAX package: the caller supplies the frame embeddings (B, encoder_seq,
d_model); the encoder's self-attention and the decoder's causal and cross
attention are real. The MLPs are two-matrix GELU (whisper's convention).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as tfm


def gelu_mlp_init(gen: torch.Generator, cfg: LMConfig) -> dict:
    return {
        "wi": L._init(gen, (cfg.d_model, cfg.d_ff), cfg.param_dtype),
        "wo": L._init(gen, (cfg.d_ff, cfg.d_model), cfg.param_dtype),
    }


def gelu_mlp_axes(cfg):
    return {"wi": ("embed", "mlp"), "wo": ("mlp", "embed")}


def gelu_mlp(x, p):
    return L._mm(L.gelu(L._mm(x, p["wi"])), p["wo"])


def _ones(gen, cfg):
    return torch.ones((cfg.d_model,), dtype=cfg.param_dtype, device=gen.device)


def enc_layer_init(gen: torch.Generator, cfg: LMConfig) -> dict:
    return {
        "attn": L.attn_init(gen, cfg),
        "mlp": gelu_mlp_init(gen, cfg),
        "ln1": _ones(gen, cfg),
        "ln2": _ones(gen, cfg),
    }


def enc_layer_axes(cfg):
    return {"attn": L.attn_axes(cfg), "mlp": gelu_mlp_axes(cfg), "ln1": (None,), "ln2": (None,)}


def dec_layer_init(gen: torch.Generator, cfg: LMConfig) -> dict:
    return {
        "self_attn": L.attn_init(gen, cfg),
        "cross_attn": L.attn_init(gen, cfg),
        "mlp": gelu_mlp_init(gen, cfg),
        "ln1": _ones(gen, cfg),
        "ln_x": _ones(gen, cfg),
        "ln2": _ones(gen, cfg),
    }


def dec_layer_axes(cfg):
    return {
        "self_attn": L.attn_axes(cfg),
        "cross_attn": L.attn_axes(cfg),
        "mlp": gelu_mlp_axes(cfg),
        "ln1": (None,),
        "ln_x": (None,),
        "ln2": (None,),
    }


def init_params(gen: torch.Generator, cfg: LMConfig) -> dict:
    return {
        "embed": L.embed_init(gen, cfg),
        "encoder": tfm.init_stacked(gen, cfg, enc_layer_init, (cfg.encoder_layers,)),
        "decoder": tfm.init_stacked(gen, cfg, dec_layer_init, (cfg.n_layers,)),
    }


def param_axes(cfg: LMConfig) -> dict:
    return {
        "embed": L.embed_axes(cfg),
        "encoder": tfm.stack_axes(enc_layer_axes(cfg), ("layers",)),
        "decoder": tfm.stack_axes(dec_layer_axes(cfg), ("layers",)),
    }


def _enc_layer(h, lp, cfg, positions):
    a, _ = L.attention(L.rmsnorm(h, lp["ln1"], cfg.norm_eps), lp["attn"], cfg,
                       positions=positions, causal=False)
    h = h + a
    return h + gelu_mlp(L.rmsnorm(h, lp["ln2"], cfg.norm_eps), lp["mlp"])


def encode(params, frames, cfg: LMConfig):
    """frames (B, S_enc, D), the stub frontend's output → encoder states."""
    b, s, _ = frames.shape
    positions = torch.arange(s, device=frames.device)[None].expand(b, s)
    remat = cfg.remat and torch.is_grad_enabled()
    h = frames.to(cfg.param_dtype)
    for i in range(cfg.encoder_layers):
        lp = tfm.layer_params(params["encoder"], i)
        if remat:
            h = checkpoint(_enc_layer, h, lp, cfg, positions, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            h = _enc_layer(h, lp, cfg, positions)
    return h


class WhisperCache(NamedTuple):
    self_k: torch.Tensor  # (L, B, S_max, kv, hd)
    self_v: torch.Tensor
    cross_k: torch.Tensor  # (L, B, S_enc, kv, hd): fixed after prefill
    cross_v: torch.Tensor


def cross_kv(params, enc_out, cfg: LMConfig):
    """Each decoder layer's cross-attention K/V from the encoder's output:
    two (L, B, S_enc, kv, hd) stacks."""
    b, s, _ = enc_out.shape
    ks, vs = [], []
    for i in range(cfg.n_layers):
        p = tfm.layer_params(params["decoder"], i)["cross_attn"]
        k = L._mm(enc_out, p["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.hd)
        v = L._mm(enc_out, p["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.hd)
        if cfg.qkv_bias:
            k = k + p["bk"].reshape(cfg.n_kv_heads, cfg.hd)
            v = v + p["bv"].reshape(cfg.n_kv_heads, cfg.hd)
        ks.append(k)
        vs.append(v)
    return torch.stack(ks), torch.stack(vs)


def _dec_layer(h, lp, cfg, positions, ck, cv, kv=None, cache_pos=None):
    a, new_kv = L.attention(L.rmsnorm(h, lp["ln1"], cfg.norm_eps), lp["self_attn"], cfg,
                            positions=positions, causal=True, kv_cache=kv,
                            cache_pos=cache_pos)
    h = h + a
    c, _ = L.attention(L.rmsnorm(h, lp["ln_x"], cfg.norm_eps), lp["cross_attn"], cfg,
                       positions=positions, cross_kv=L.KVSlice(ck, cv))
    h = h + c
    h = h + gelu_mlp(L.rmsnorm(h, lp["ln2"], cfg.norm_eps), lp["mlp"])
    return h, new_kv


def _dec_out(h, lp, cfg, positions, ck, cv):
    return _dec_layer(h, lp, cfg, positions, ck, cv)[0]


def decoder_forward(params, tokens, cfg: LMConfig, cross: tuple, *,
                    cache: Optional[WhisperCache] = None, cache_pos=None,
                    collect_kv: bool = False):
    """tokens (B, S) against ``cross`` ((L, B, S_enc, kv, hd) ×2) → (logits,
    WhisperCache | None). With ``cache``, the self-attention K/V are written
    at ``cache_pos`` into a copy of each layer's rows."""
    collect_kv = collect_kv or cache is not None
    remat = cfg.remat and torch.is_grad_enabled() and not collect_kv
    x = L.embed_tokens(tokens, params["embed"])
    b, s, _ = x.shape
    positions = tfm._positions(cache_pos if cache_pos is not None else 0, b, s, x.device)
    kv_in = (cache.self_k, cache.self_v) if cache is not None else None
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = tfm.layer_params(params["decoder"], i)
        if remat:
            x = checkpoint(_dec_out, x, lp, cfg, positions, cross[0][i], cross[1][i],
                           use_reentrant=False, preserve_rng_state=False)
            continue
        x, new_kv = _dec_layer(x, lp, cfg, positions, cross[0][i], cross[1][i],
                               tfm.KVSlice_or_none(kv_in, i), cache_pos)
        ks.append(new_kv.k)
        vs.append(new_kv.v)
    logits = L.logits_fn(x, params["embed"], cfg)
    if not collect_kv:
        return logits, None
    return logits, WhisperCache(self_k=torch.stack(ks), self_v=torch.stack(vs),
                                cross_k=cross[0], cross_v=cross[1])
