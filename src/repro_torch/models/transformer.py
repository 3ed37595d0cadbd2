"""Dense decoder-only transformer (the qwen / llama / llava backbone) and
the prefill/decode steps the MoE family reuses with its own layer body.
Counterpart of ``repro/models/transformer.py``. ``extra_embeds`` (B, P, D)
is a modality prefix (llava's projected patches) put before the token
embeddings by :func:`forward`, :func:`cached_forward` and the prefill.

Parameters are stacked over layers — every leaf of ``params["layers"]`` is
(L, ...) — as the JAX package's scanned layers are, so a params tree
crosses between the packages leaf for leaf
(:func:`repro_torch.interop.lm_params_from_numpy`).

Two serving paths, as in JAX: :func:`forward` (``serve_fast=False``)
rebuilds the KV cache per layer, and :func:`cached_forward` (the default)
writes each layer's new rows into the carried stacked cache in place — the
PyTorch form of the JAX package's carry-aliased ``fori_loop``.

Training: :func:`make_loss_fn` (the next-token loss over :func:`forward`).
With ``cfg.remat`` each layer's block runs under
``torch.utils.checkpoint`` while autograd records, as JAX wraps its scanned
layer in ``jax.checkpoint``: the backward keeps one layer's activations
and recomputes them, and the numbers are unchanged. ``forward`` also takes
the layers as a list of per-layer trees (JAX's unscanned layout), which is
how the trainer hands it one autograd leaf per layer.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as tu
from repro_torch.configs.base import LMConfig
from repro_torch.distributed import fsdp
from repro_torch.distributed import sharding as shd
from repro_torch.models import layers as L


# ------------------------------------------------------------------ params --


def layer_init(gen: torch.Generator, cfg: LMConfig) -> dict:
    return {
        "attn": L.attn_init(gen, cfg),
        "mlp": L.mlp_init(gen, cfg),
        "ln1": torch.ones((cfg.d_model,), dtype=cfg.param_dtype, device=gen.device),
        "ln2": torch.ones((cfg.d_model,), dtype=cfg.param_dtype, device=gen.device),
    }


def layer_axes(cfg: LMConfig) -> dict:
    """The logical axes of :func:`layer_init`'s tree."""
    return {
        "attn": L.attn_axes(cfg),
        "mlp": L.mlp_axes(cfg),
        "ln1": (None,),
        "ln2": (None,),
    }


def stack_axes(axes_tree, lead: tuple):
    """``lead`` axis names put before every leaf of an axes tree: the
    axes of a stacked (*lead, ...) parameter tree."""
    return tu.tree_map(lambda axes: tuple(lead) + axes, axes_tree, is_leaf=shd.is_axes)


def param_axes(cfg: LMConfig, layer_axes_fn=layer_axes) -> dict:
    """The logical axes of :func:`init_params`'s tree. The port's layers
    are always stacked, as a scanned JAX model's (``cfg.scan_layers``)."""
    return {"embed": L.embed_axes(cfg), "layers": stack_axes(layer_axes_fn(cfg), ("layers",))}


def layer_params(layers, *idx: int) -> dict:
    """Layer ``idx``'s parameters (one index per layer axis): a view of that
    row of every stacked leaf, or the entry of nested lists of per-layer
    trees (the train step's autograd views)."""
    if isinstance(layers, list):
        for i in idx:
            layers = layers[i]
        return layers
    return tu.tree_map(lambda a: a[idx], layers)


def init_stacked(gen: torch.Generator, cfg: LMConfig, layer_init_fn, lead: tuple,
                 specs=None) -> dict:
    """``prod(lead)`` layers drawn one at a time into stacked (*lead, ...)
    leaves: the peak is the stack plus one layer. ``specs``: the stacked
    leaves' layout over the processes (``fsdp.Shard``); each layer is
    drawn whole and only this process's slice of it kept."""
    n = 1
    for d in lead:
        n *= d
    inner = None if specs is None else tu.tree_map(lambda s: s.inner(len(lead)), specs)
    stacked = None
    for i in range(n):
        layer = layer_init_fn(gen, cfg)
        if inner is not None:
            layer = fsdp.shard_tree(layer, inner)
        if stacked is None:
            stacked = tu.tree_map(lambda a: a.new_empty(tuple(lead) + tuple(a.shape)), layer)
        for dst, src in zip(tu.leaves(stacked), tu.leaves(layer)):
            dst.view(n, *src.shape)[i].copy_(src)
        del layer
    return stacked


def init_params(gen: torch.Generator, cfg: LMConfig, layer_init_fn=layer_init,
                specs=None) -> dict:
    """Seeded parameters on ``gen``'s device: the embeddings, then the
    layers drawn one at a time into their stacked (L, ...) leaves.
    ``specs``: the params' layout over the processes (``fsdp.Shard``):
    only this process's slices are kept, the same draws made, so the
    whole tree is never held."""
    embed = L.embed_init(gen, cfg)
    if specs is not None:
        embed = fsdp.shard_tree(embed, specs["embed"])
    return {"embed": embed, "layers": init_stacked(gen, cfg, layer_init_fn, (cfg.n_layers,),
                                                   None if specs is None else specs["layers"])}


# ----------------------------------------------------------------- forward --


def dense_block(x, lp, cfg: LMConfig, *, positions, kv=None, cache_pos=None, causal=True):
    """Pre-norm attention + SwiGLU block. Returns (x, new_kv)."""
    h, new_kv = L.attention(
        L.rmsnorm(x, lp["ln1"], cfg.norm_eps),
        lp["attn"],
        cfg,
        positions=positions,
        causal=causal,
        kv_cache=kv,
        cache_pos=cache_pos,
    )
    x = x + h
    x = x + L.mlp(L.rmsnorm(x, lp["ln2"], cfg.norm_eps), lp["mlp"])
    return x, new_kv


class KVCache(NamedTuple):
    """Stacked over layers: k/v (L, B, S_max, n_kv, hd)."""

    k: torch.Tensor
    v: torch.Tensor

    @staticmethod
    def zeros(cfg: LMConfig, batch: int, max_seq: int, dtype=torch.bfloat16, *, device):
        shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
        return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device))


def KVSlice_or_none(kv, i: int):
    """Layer ``i``'s rows of a stacked (k, v) pair, or None without one."""
    return None if kv is None else L.KVSlice(kv[0][i], kv[1][i])


def embed_with_prefix(tokens, params, extra_embeds=None) -> torch.Tensor:
    """Token embeddings, with ``extra_embeds`` (B, P, D) put before them in
    the embeddings' dtype."""
    x = L.embed_tokens(tokens, params["embed"])
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    return x


def _positions(pos0, b: int, s: int, device) -> torch.Tensor:
    """(B, S) positions of tokens written from ``pos0`` (an int, or one
    position per batch row)."""
    base = pos0[:, None] if L.per_slot(pos0) else int(pos0)
    return (base + torch.arange(s, device=device)[None]).expand(b, s)


def forward(
    params: dict,
    tokens: torch.Tensor,
    cfg: LMConfig,
    *,
    block_fn: Callable = dense_block,
    kv_cache: Optional[KVCache] = None,
    cache_pos=None,
    extra_embeds: Optional[torch.Tensor] = None,
    collect_kv: bool = False,
) -> tuple[torch.Tensor, Optional[KVCache]]:
    """tokens (B, S) → logits (B, P + S, V), layer by layer over the stacked
    params, ``extra_embeds`` (B, P, D) prepended. ``collect_kv``: also
    return the per-layer K/V (prefill/decode). Under autograd with
    ``cfg.remat``, each block is recomputed in the backward instead of
    kept."""
    collect_kv = collect_kv or kv_cache is not None
    remat = cfg.remat and torch.is_grad_enabled() and not collect_kv
    x = embed_with_prefix(tokens, params, extra_embeds)
    b, s, _ = x.shape
    positions = _positions(cache_pos if cache_pos is not None else 0, b, s, x.device)
    new_ks, new_vs = [], []
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        if remat:
            x = checkpoint(_block_out, block_fn, x, lp, cfg, positions, use_reentrant=False,
                           preserve_rng_state=False)
            continue
        kv = KVSlice_or_none(kv_cache, i)
        x, new_kv = block_fn(x, lp, cfg, positions=positions, kv=kv, cache_pos=cache_pos)
        if collect_kv:
            new_ks.append(new_kv.k)
            new_vs.append(new_kv.v)
    new_cache = KVCache(torch.stack(new_ks), torch.stack(new_vs)) if new_ks else None
    return L.logits_fn(x, params["embed"], cfg), new_cache


def _block_out(block_fn, x, lp, cfg, positions):
    return block_fn(x, lp, cfg, positions=positions)[0]


# ------------------------------------------------------------- step makers --


def make_loss_fn(cfg: LMConfig, block_fn=dense_block):
    """(params, batch) → the mean next-token loss, as JAX's: logits at
    positions [:-1] against ``labels[:, 1:]``. A ``batch["extra_embeds"]``
    prefix (llava's patches) carries no loss: only the token suffix's
    logits are scored."""

    def loss_fn(params, batch):
        extra = batch.get("extra_embeds")
        logits, _ = forward(params, batch["tokens"], cfg, block_fn=block_fn,
                            extra_embeds=extra)
        labels = batch["labels"]
        if extra is not None:
            logits = logits[:, -labels.shape[1]:]
        return L.cross_entropy(logits[:, :-1], labels[:, 1:])

    return loss_fn


def make_prefill_fn(cfg: LMConfig, block_fn=dense_block):
    """Prefill: run the prompt, return the last position's logits and the
    populated KV cache. ``valid_len`` supports bucketed prefill: tokens
    padded past the real prompt, the causal mask keeps positions <
    valid_len blind to the pad, and the logits come from position
    ``valid_len - 1``, counted over the whole input (``extra_embeds``
    first)."""

    def prefill(params, tokens, valid_len=None, *, extra_embeds=None):
        logits, cache = forward(params, tokens, cfg, block_fn=block_fn,
                                extra_embeds=extra_embeds, collect_kv=True)
        if valid_len is None:
            return logits[:, -1], cache
        return logits[:, int(valid_len) - 1], cache

    return prefill


def make_decode_fn(cfg: LMConfig, block_fn=dense_block):
    """One decode step: (params, cache, token, pos) → (logits, cache)."""

    def decode(params, cache, token, pos):
        logits, new_cache = forward(
            params, token[:, None], cfg, block_fn=block_fn, kv_cache=cache, cache_pos=pos
        )
        return logits[:, 0], new_cache

    return decode


# ------------------------------------------------------------ serve path --
# cached_forward carries the stacked cache and writes each layer's new rows
# into it in place, so the only cache traffic is the attention read. With
# ``kv_quant`` the cache is int8 with per-(token, head) scales (the paper's
# FXP8 applied to the cache), dequantized to bf16 inside the attention read.


class QuantKVCache(NamedTuple):
    """int8 KV + per-(layer, batch, pos, head) f32 scales."""

    k: torch.Tensor  # (L, B, S, kv, hd) int8
    v: torch.Tensor
    k_scale: torch.Tensor  # (L, B, S, kv) f32
    v_scale: torch.Tensor

    @staticmethod
    def zeros(cfg: LMConfig, batch: int, max_seq: int, *, device):
        shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
        return QuantKVCache(
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        )


def _q8_kv(x):
    """(..., hd) → int8 payload + f32 scale over the head dim."""
    scale = torch.amax(torch.abs(x.float()), dim=-1) / 127.0
    q = torch.round(x.float() / torch.clamp_min(scale[..., None], 1e-9))
    return q.to(torch.int8), scale


def cached_forward(
    params: dict,
    tokens: torch.Tensor,  # (B, S_new): 1 for decode, the prompt for prefill
    cfg: LMConfig,
    cache,  # KVCache or QuantKVCache, (L, B, S_max, kv, hd); written in place
    pos0,  # int, or (B,) tensor: write offset of tokens[:, 0]
    *,
    mlp_fn: Optional[Callable] = None,
    extra_embeds: Optional[torch.Tensor] = None,
    valid_len=None,
):
    """Prefill/decode over a carried stacked cache. Returns (last-position
    logits (B, V), the cache). ``extra_embeds`` (B, P, D) is written first,
    from ``pos0``. ``valid_len`` selects position ``valid_len - 1`` instead
    of the last (bucketed prefill over end-padded tokens — pad rows land in
    the cache past the prompt, and serving only ever copies rows
    [:valid_len])."""
    mlp_fn = mlp_fn or (lambda h, lp: L.mlp(h, lp["mlp"]))
    quant = isinstance(cache, QuantKVCache)
    x = embed_with_prefix(tokens, params, extra_embeds)
    b, s, _ = x.shape
    dev = x.device
    slots = L.per_slot(pos0)
    positions = _positions(pos0, b, s, dev)
    s_max = cache.k.shape[2]
    steps = torch.arange(s, device=dev)
    if slots:  # per-slot offsets (serving)
        rows = torch.arange(b, device=dev)[:, None]
        cols = pos0[:, None] + steps[None]
        off = pos0[:, None, None]
    else:  # uniform offset
        p0 = int(pos0)
        off = p0
    # visibility: kv position j attends to query step t iff j <= pos0 + t
    valid = torch.arange(s_max, device=dev)[None, None, :] <= (off + steps[None, :, None])

    def put(buf, i, val):
        if slots:
            buf[i, rows, cols] = val.to(buf.dtype)
        else:
            buf[i, :, p0:p0 + s] = val.to(buf.dtype)

    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = L._qkv(h, lp["attn"], cfg, positions)
        if quant:
            kq, ks = _q8_kv(k)
            vq, vs = _q8_kv(v)
            for buf, val in zip(cache, (kq, vq, ks, vs)):
                put(buf, i, val)
            k_l = cache.k[i].to(torch.bfloat16) * cache.k_scale[i][..., None].to(torch.bfloat16)
            v_l = cache.v[i].to(torch.bfloat16) * cache.v_scale[i][..., None].to(torch.bfloat16)
        else:
            put(cache.k, i, k)
            put(cache.v, i, v)
            k_l, v_l = cache.k[i], cache.v[i]

        if s == s_max and not slots and s > L.CHUNKED_ATTN_THRESHOLD:
            # long prefill: the chunked path (exact: prefill starts at 0)
            att = L._chunked_sdpa(q, k_l, v_l, cfg, causal=True)
        else:
            att = L._sdpa(q, k_l, v_l, valid[:, None], cfg)
        x = x + L._mm(att, lp["attn"]["wo"])
        x = x + mlp_fn(L.rmsnorm(x, lp["ln2"], cfg.norm_eps), lp)

    x_last = x[:, -1:] if valid_len is None else x[:, int(valid_len) - 1:int(valid_len)]
    logits = L.logits_fn(x_last, params["embed"], cfg)
    return logits[:, 0], cache
