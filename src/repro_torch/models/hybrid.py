"""zamba2-style hybrid: stacks of Mamba2 layers with one shared attention
block (a single parameter set applied every ``attn_every`` layers).
Counterpart of ``repro/models/hybrid.py``.

Layout: ``n_super`` super-layers, each ``attn_every`` mamba layers and one
application of the shared attention block; ``n_tail`` trailing mamba
layers make up the rest (81 = 13·6 + 3 for zamba2-7b).

:func:`forward` rebuilds the cache (prefill, the naive decode);
:func:`cached_decode` (``serve_fast``) writes the states and the shared
block's KV row into the carried cache in place.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2
from repro_torch.models import transformer as tfm


def split_layers(cfg: LMConfig) -> tuple[int, int]:
    n_super = cfg.n_layers // cfg.attn_every
    n_tail = cfg.n_layers - n_super * cfg.attn_every
    return n_super, n_tail


def init_params(gen: torch.Generator, cfg: LMConfig) -> dict:
    """The embeddings, the (n_super, attn_every) mamba stack, the one shared
    attention block and the tail, each layer drawn one at a time."""
    n_super, n_tail = split_layers(cfg)
    p = {
        "embed": L.embed_init(gen, cfg),
        "mamba": tfm.init_stacked(gen, cfg, mamba2.mamba_init, (n_super, cfg.attn_every)),
        "shared_attn": tfm.layer_init(gen, cfg),  # one block, reused
    }
    if n_tail:
        p["tail"] = tfm.init_stacked(gen, cfg, mamba2.mamba_init, (n_tail,))
    return p


def param_axes(cfg: LMConfig) -> dict:
    n_super, n_tail = split_layers(cfg)
    p = {
        "embed": L.embed_axes(cfg),
        "mamba": tfm.stack_axes(mamba2.mamba_axes(cfg), ("layers", None)),
        "shared_attn": tfm.layer_axes(cfg),
    }
    if n_tail:
        p["tail"] = tfm.stack_axes(mamba2.mamba_axes(cfg), ("layers",))
    return p


class HybridCache(NamedTuple):
    mamba: mamba2.MambaState  # stacked (n_super, attn_every, B, ...)
    tail: Optional[mamba2.MambaState]  # stacked (n_tail, B, ...)
    attn_k: torch.Tensor  # (n_super, B, S, kv, hd)
    attn_v: torch.Tensor


def init_cache(cfg: LMConfig, batch: int, max_seq: int, dtype=torch.bfloat16, *,
               device) -> HybridCache:
    n_super, n_tail = split_layers(cfg)
    kv_shape = (n_super, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return HybridCache(
        mamba=mamba2.init_state(cfg, batch, device=device, lead=(n_super, cfg.attn_every)),
        tail=mamba2.init_state(cfg, batch, device=device, lead=(n_tail,)) if n_tail else None,
        attn_k=torch.zeros(kv_shape, dtype=dtype, device=device),
        attn_v=torch.zeros(kv_shape, dtype=dtype, device=device),
    )


def _state(st: Optional[mamba2.MambaState], *idx) -> Optional[mamba2.MambaState]:
    return None if st is None else mamba2.MambaState(h=st.h[idx], conv=st.conv[idx])


def _stack_states(states: list) -> mamba2.MambaState:
    return mamba2.MambaState(h=torch.stack([s.h for s in states]),
                             conv=torch.stack([s.conv for s in states]))


def _super_out(x, params, cfg, i, positions):
    for j in range(cfg.attn_every):
        x, _ = mamba2.mamba_forward(x, tfm.layer_params(params["mamba"], i, j), cfg)
    return tfm.dense_block(x, params["shared_attn"], cfg, positions=positions)[0]


def forward(params, tokens, cfg: LMConfig, *, cache: Optional[HybridCache] = None,
            cache_pos=None, collect_kv: bool = False):
    """Returns (logits, new_cache | None). Under autograd with ``cfg.remat``
    and nothing to collect, each super-layer is recomputed in the backward."""
    collect_kv = collect_kv or cache is not None
    remat = cfg.remat and torch.is_grad_enabled() and not collect_kv
    x = L.embed_tokens(tokens, params["embed"])
    b, s, _ = x.shape
    positions = tfm._positions(cache_pos if cache_pos is not None else 0, b, s, x.device)
    n_super, n_tail = split_layers(cfg)
    shared = params["shared_attn"]
    mstate = cache.mamba if cache is not None else None
    kv_in = (cache.attn_k, cache.attn_v) if cache is not None else None

    supers, ks, vs = [], [], []
    for i in range(n_super):
        if remat:
            x = checkpoint(_super_out, x, params, cfg, i, positions, use_reentrant=False,
                           preserve_rng_state=False)
            continue
        new_states = []
        for j in range(cfg.attn_every):
            x, ns = mamba2.mamba_forward(x, tfm.layer_params(params["mamba"], i, j), cfg,
                                         state=_state(mstate, i, j))
            new_states.append(ns)
        x, new_kv = tfm.dense_block(x, shared, cfg, positions=positions,
                                    kv=tfm.KVSlice_or_none(kv_in, i), cache_pos=cache_pos)
        supers.append(_stack_states(new_states))
        ks.append(new_kv.k)
        vs.append(new_kv.v)

    tail_states = []
    for j in range(n_tail):
        x, ns = mamba2.mamba_forward(x, tfm.layer_params(params["tail"], j), cfg,
                                     state=_state(cache.tail if cache is not None else None, j))
        tail_states.append(ns)

    logits = L.logits_fn(x, params["embed"], cfg)
    if not collect_kv:
        return logits, None
    return logits, HybridCache(
        mamba=_stack_states(supers),
        tail=_stack_states(tail_states) if n_tail else None,
        attn_k=torch.stack(ks),
        attn_v=torch.stack(vs),
    )


def cached_decode(params, token, cfg: LMConfig, cache: HybridCache, pos):
    """token (B,), pos an int or (B,) tensor. Writes every state and the
    shared block's K/V row at ``pos`` into ``cache`` in place. Returns
    (logits (B, V), cache)."""
    x = L.embed_tokens(token[:, None], params["embed"])
    b = x.shape[0]
    dev = x.device
    slots = L.per_slot(pos)
    positions = tfm._positions(pos, b, 1, dev)
    n_super, n_tail = split_layers(cfg)
    shared = params["shared_attn"]
    s_max = cache.attn_k.shape[2]
    mh, mconv, kc, vc = cache.mamba.h, cache.mamba.conv, cache.attn_k, cache.attn_v
    off = pos[:, None, None] if slots else int(pos)
    valid = torch.arange(s_max, device=dev)[None, None, :] <= off
    rows = torch.arange(b, device=dev)

    for i in range(n_super):
        for j in range(cfg.attn_every):
            x, ns = mamba2.mamba_forward(x, tfm.layer_params(params["mamba"], i, j), cfg,
                                         state=_state(cache.mamba, i, j))
            mh[i, j] = ns.h.to(mh.dtype)
            mconv[i, j] = ns.conv.to(mconv.dtype)
        # the shared attention block over the carried KV (one row written)
        h = L.rmsnorm(x, shared["ln1"], cfg.norm_eps)
        q, k, v = L._qkv(h, shared["attn"], cfg, positions)
        if slots:
            kc[i, rows, pos] = k[:, 0].to(kc.dtype)
            vc[i, rows, pos] = v[:, 0].to(vc.dtype)
        else:
            kc[i, :, int(pos)] = k[:, 0].to(kc.dtype)
            vc[i, :, int(pos)] = v[:, 0].to(vc.dtype)
        att = L._sdpa(q, kc[i], vc[i], valid[:, None], cfg)
        x = x + L._mm(att, shared["attn"]["wo"])
        x = x + L.mlp(L.rmsnorm(x, shared["ln2"], cfg.norm_eps), shared["mlp"])

    for j in range(n_tail):
        x, ns = mamba2.mamba_forward(x, tfm.layer_params(params["tail"], j), cfg,
                                     state=_state(cache.tail, j))
        cache.tail.h[j] = ns.h.to(cache.tail.h.dtype)
        cache.tail.conv[j] = ns.conv.to(cache.tail.conv.dtype)

    logits = L.logits_fn(x, params["embed"], cfg)
    return logits[:, 0], cache
