"""Mixture-of-Experts layers (deepseek-moe-16b: 2 shared + 64 routed top-6
fine-grained; olmoe-1b-7b: 64 routed top-8). Counterpart of
``repro/models/moe.py``.

Dispatch is sort-based grouping with a fixed per-expert capacity
(dropped-token MoE), and every integer map equals the JAX package's:
``route`` breaks ties in the top-k by the lower expert index (as
``jax.lax.top_k``), ``dispatch_group`` sorts stably, and the entries past
an expert's capacity drop as in JAX. The expert-parallel path of the JAX
package (``moe_mlp_ep``) falls back to :func:`moe_mlp` on one device,
which is what the port runs.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import LMConfig
from repro_torch.models import layers as L


def moe_init(gen: torch.Generator, cfg: LMConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = cfg.param_dtype
    p = {
        "router": L._init(gen, (d, e), torch.float32),  # router math in f32
        "experts": {
            "wi": L._init(gen, (e, d, f), dt),
            "wg": L._init(gen, (e, d, f), dt),
            "wo": L._init(gen, (e, f, d), dt),
        },
    }
    if cfg.n_shared_experts:
        p["shared"] = L.mlp_init(gen, cfg, d_ff=f * cfg.n_shared_experts)
    return p


def moe_axes(cfg: LMConfig) -> dict:
    """The logical axes of :func:`moe_init`'s tree: experts over 'model',
    the per-expert FFN dims on an axis of their own (two dims of one
    tensor cannot both take the 'model' mesh axis)."""
    a = {
        "router": ("embed", None),
        "experts": {
            "wi": ("experts", "embed", "expert_mlp"),
            "wg": ("experts", "embed", "expert_mlp"),
            "wo": ("experts", "expert_mlp", "embed"),
        },
    }
    if cfg.n_shared_experts:
        a["shared"] = L.mlp_axes(cfg)
    return a


def _capacity(n_tokens: int, cfg: LMConfig) -> int:
    cap = int(math.ceil(cfg.top_k * n_tokens / cfg.n_experts * cfg.capacity_factor))
    return max(cap, 8)


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: among equal values the lower
    index comes first (``torch.topk`` promises no order for ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(x2d: torch.Tensor, router_w: torch.Tensor, cfg: LMConfig):
    """x2d (T, D) → (expert_ids (T,k), gates (T,k), aux_loss)."""
    logits = L._mm(x2d.float(), router_w).float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, ids = _top_k(probs, cfg.top_k)
    gates = gates / torch.clamp_min(gates.sum(dim=-1, keepdim=True), 1e-9)
    # load-balance auxiliary loss (Switch-style)
    me = probs.mean(dim=0)
    ce = torch.nn.functional.one_hot(ids, cfg.n_experts).float().sum(dim=1).mean(dim=0) / cfg.top_k
    aux = cfg.n_experts * (me * ce).sum()
    return ids, gates, aux


def dispatch_group(ids: torch.Tensor, n_tokens: int, cfg: LMConfig):
    """Sort-based grouping. ids (T, k) → the token of each expert slot
    (E*C,) (``n_tokens``, the pad row, where empty), the slot that served
    each (token, k) entry (T, k) (-1 where it overflowed), and C."""
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity(n_tokens, cfg)
    dev = ids.device
    flat_e = ids.reshape(-1)  # (T*k,)
    flat_tok = torch.arange(n_tokens, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    sorted_tok = flat_tok[order]
    # rank of each entry within its expert group
    group_start = torch.searchsorted(sorted_e, torch.arange(E, device=dev, dtype=sorted_e.dtype))
    rank = torch.arange(n_tokens * k, device=dev) - group_start[sorted_e]
    keep = rank < C
    slot = torch.where(keep, sorted_e * C + rank, E * C)  # E*C: the overflow bucket
    slot_token = torch.full((E * C + 1,), n_tokens, dtype=torch.int64, device=dev)
    slot_token[slot] = sorted_tok  # indices repeat only at the overflow bucket
    entry_slot = torch.full((n_tokens * k,), -1, dtype=torch.int64, device=dev)
    entry_slot[order] = torch.where(keep, slot, -1)
    return slot_token[: E * C], entry_slot.reshape(n_tokens, k), C


def moe_mlp(x: torch.Tensor, p: dict, cfg: LMConfig):
    """x (B, S, D) → (out, aux_loss)."""
    b, s, d = x.shape
    t = b * s
    x2d = x.reshape(t, d)
    ids, gates, aux = route(x2d, p["router"], cfg)
    slot_token, entry_slot, C = dispatch_group(ids, t, cfg)

    x_pad = torch.cat([x2d, x2d.new_zeros((1, d))], dim=0)
    grouped = x_pad[slot_token].reshape(cfg.n_experts, C, d)  # (E, C, D)

    ew = p["experts"]
    grouped, wg, wi, wo = L._promote(grouped, ew["wg"], ew["wi"], ew["wo"])
    hg = torch.einsum("ecd,edf->ecf", grouped, wg)
    hi = torch.einsum("ecd,edf->ecf", grouped, wi)
    ho = torch.einsum("ecf,efd->ecd", L.silu(hg) * hi, wo)  # (E, C, D)
    ho_flat = ho.reshape(cfg.n_experts * C, d)

    # combine: each (token, k) entry pulls its slot's output, scaled by gate
    pulled = ho_flat[torch.clamp_min(entry_slot, 0)]  # (T, k, D)
    valid = (entry_slot >= 0).to(pulled.dtype)[..., None]
    out = torch.sum(pulled * valid * gates[..., None].to(pulled.dtype), dim=1)

    if cfg.n_shared_experts:
        out = out + L.mlp(x2d, p["shared"])
    return out.reshape(b, s, d).to(x.dtype), aux


def moe_layer_init(gen: torch.Generator, cfg: LMConfig) -> dict:
    return {
        "attn": L.attn_init(gen, cfg),
        "moe": moe_init(gen, cfg),
        "ln1": torch.ones((cfg.d_model,), dtype=cfg.param_dtype, device=gen.device),
        "ln2": torch.ones((cfg.d_model,), dtype=cfg.param_dtype, device=gen.device),
    }


def moe_layer_axes(cfg: LMConfig) -> dict:
    return {"attn": L.attn_axes(cfg), "moe": moe_axes(cfg), "ln1": (None,), "ln2": (None,)}


def moe_block(x, lp, cfg: LMConfig, *, positions, kv=None, cache_pos=None):
    h, new_kv = L.attention(
        L.rmsnorm(x, lp["ln1"], cfg.norm_eps),
        lp["attn"],
        cfg,
        positions=positions,
        kv_cache=kv,
        cache_pos=cache_pos,
    )
    x = x + h
    mo, _aux = moe_mlp(L.rmsnorm(x, lp["ln2"], cfg.norm_eps), lp["moe"], cfg)
    return x + mo, new_kv
