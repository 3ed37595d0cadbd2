"""Shared LM building blocks: RMSNorm, RoPE, grouped-query attention with a
KV cache, the SwiGLU MLP and the embeddings. Counterpart of
``repro/models/layers.py``: pure functions over explicit param dicts, and
every dtype step of the JAX package's is kept — ``rmsnorm`` and
``apply_rope`` compute in f32 and cast back; ``_sdpa`` runs its product in
the operands' promoted dtype, softmaxes in f32 and casts the probabilities
to ``v``'s dtype; the LM head returns f32. Where JAX promotes two dtypes
implicitly (an f32 activation against a bf16 cache), :func:`_mm` and
:func:`_promote` do it explicitly.

Attention is written as plain tensor products, as the JAX package writes
it with ``jnp.einsum``: no Pallas kernel is on this path, and a fused
attention library call would sum in another order. The embedding lookup
and the LM head are the single-device branches of the JAX package's
``distributed/embedding.py``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import LMConfig


def _init(gen: torch.Generator, shape, dtype, scale=None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / np.sqrt(shape[0])
    meta = gen.device.type == "meta"  # shapes only: no generator draws there
    x = torch.randn(shape, generator=None if meta else gen, device=gen.device,
                    dtype=torch.float32)
    return (x * float(scale)).to(dtype)


def _promote(*xs: torch.Tensor) -> list:
    """The operands in their promoted dtype (jnp's implicit promotion)."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in xs]


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with jnp's dtype promotion."""
    a, b = _promote(a, b)
    return a @ b


# ------------------------------------------------------------- norms/rope --


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) integers."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    angles = positions[..., None].float() * freqs  # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------- attention --


def attn_init(gen: torch.Generator, cfg: LMConfig) -> dict:
    d, nh, nkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.param_dtype
    p = {
        "wq": _init(gen, (d, nh * hd), dt),
        "wk": _init(gen, (d, nkv * hd), dt),
        "wv": _init(gen, (d, nkv * hd), dt),
        "wo": _init(gen, (nh * hd, d), dt),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((nh * hd,), dtype=dt, device=gen.device)
        p["bk"] = torch.zeros((nkv * hd,), dtype=dt, device=gen.device)
        p["bv"] = torch.zeros((nkv * hd,), dtype=dt, device=gen.device)
    return p


def attn_axes(cfg: LMConfig) -> dict:
    """The logical axes of :func:`attn_init`'s tree (``repro_torch.
    distributed.sharding``)."""
    a = {
        "wq": ("embed", "qkv"),
        "wk": ("embed", "qkv"),
        "wv": ("embed", "qkv"),
        "wo": ("qkv", "embed"),
    }
    if cfg.qkv_bias:
        a |= {"bq": ("qkv",), "bk": ("qkv",), "bv": ("qkv",)}
    return a


class KVSlice(NamedTuple):
    k: torch.Tensor  # (B, S, n_kv, hd)
    v: torch.Tensor


def _qkv(x, p, cfg: LMConfig, positions):
    b, s, _ = x.shape
    nh, nkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = _mm(x, p["wq"])
    k = _mm(x, p["wk"])
    v = _mm(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, nh, hd)
    k = k.reshape(b, s, nkv, hd)
    v = v.reshape(b, s, nkv, hd)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q, k, v, mask, cfg: LMConfig):
    """Grouped-query scaled dot-product attention.
    q: (B,Sq,H,hd)  k,v: (B,Skv,KV,hd)  mask: (B,1,Sq,Skv) bool or None."""
    b, sq, nh, hd = q.shape
    nkv = k.shape[2]
    g = nh // nkv
    qg, kk = _promote(q.reshape(b, sq, nkv, g, hd), k)
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, kk).float() / math.sqrt(hd)
    if mask is not None:
        logits = torch.where(mask[:, :, None] if mask.ndim == 4 else mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(b, sq, nh * hd)


# Above this many query positions self-attention takes the chunked
# online-softmax path: peak memory O(q_chunk·kv_chunk) instead of O(Sq·Skv).
CHUNKED_ATTN_THRESHOLD = 8_192
Q_CHUNK = 8_192
KV_CHUNK = 2_048


def _chunked_sdpa(q, k, v, cfg: LMConfig, *, causal: bool, q_chunk=None, kv_chunk=None):
    """Blockwise attention with an online softmax (the FlashAttention
    recurrence), the JAX package's scan written as loops. q (B,S,H,hd),
    k/v (B,S,KV,hd); S is padded to the chunk sizes and the pad keys
    masked."""
    q_chunk = q_chunk or Q_CHUNK
    kv_chunk = kv_chunk or KV_CHUNK
    b, s, nh, hd = q.shape
    nkv = k.shape[2]
    g = nh // nkv
    scale = float(1.0 / np.sqrt(hd))
    s_real = s
    pad = (-s) % max(q_chunk, kv_chunk)
    if pad:  # pad keys get masked below; padded queries are sliced away
        q, k, v = (torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        s = s + pad
    nq, nk = s // q_chunk, s // kv_chunk
    qc = q.reshape(b, nq, q_chunk, nkv, g, hd)
    kc = k.reshape(b, nk, kv_chunk, nkv, hd)
    vc = v.reshape(b, nk, kv_chunk, nkv, hd)
    dev = q.device
    outs = []
    for qi in range(nq):
        qb = qc[:, qi]  # (B, qc, KV, G, hd)
        qpos = qi * q_chunk + torch.arange(q_chunk, device=dev)
        acc = torch.zeros((b, nkv, g, q_chunk, hd), dtype=torch.float32, device=dev)
        m = torch.full((b, nkv, g, q_chunk), -math.inf, dtype=torch.float32, device=dev)
        l = torch.zeros((b, nkv, g, q_chunk), dtype=torch.float32, device=dev)
        for ki in range(nk):
            kb, vb = kc[:, ki], vc[:, ki]
            logits = torch.einsum("bqkgh,bskh->bkgqs", *_promote(qb, kb)).float() * scale
            kpos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            mask = kpos[None, :] < s_real  # padded keys never attended
            if causal:
                mask = mask & (qpos[:, None] >= kpos[None, :])
            logits = torch.where(mask[None, None, None], logits, -1e30)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p_ = torch.exp(logits - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p_.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p_.to(vb.dtype), vb).float()
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        outs.append(out.to(q.dtype))  # (B, KV, G, qc, hd)
    out = torch.stack(outs, dim=3)  # (B, KV, G, nq, qc, hd)
    out = out.reshape(b, nkv, g, s, hd).permute(0, 3, 1, 2, 4).reshape(b, s, nh * hd)
    return out[:, :s_real]


def per_slot(pos) -> bool:
    """Whether a cache position is one per batch row (continuous batching)
    rather than one for the whole batch."""
    return isinstance(pos, torch.Tensor) and pos.ndim == 1


def attention(
    x: torch.Tensor,
    p: dict,
    cfg: LMConfig,
    *,
    positions: torch.Tensor,
    causal: bool = True,
    kv_cache: Optional[KVSlice] = None,
    cache_pos=None,
    cross_kv: Optional[KVSlice] = None,
):
    """Returns (out, new_kv). Modes:
      * full (prefill): self-attention over x, causal unless ``causal=False``
        (whisper's encoder);
      * decode: kv_cache + cache_pos given, the step written at cache_pos
        (an int, or one position per batch row) into a copy of the cache;
      * cross: cross_kv given (whisper's decoder) — keys and values from the
        encoder, no mask, no new KV.
    """
    b, s, _ = x.shape
    if cross_kv is not None:
        nh, hd = cfg.n_heads, cfg.hd
        q = _mm(x, p["wq"]).reshape(b, s, nh, hd)
        if cfg.qkv_bias:
            q = q + p["bq"].reshape(nh, hd)
        out = _sdpa(q, cross_kv.k, cross_kv.v, None, cfg)
        return _mm(out, p["wo"]), None

    q, k, v = _qkv(x, p, cfg, positions)

    if kv_cache is not None:
        k_all, v_all = kv_cache.k.clone(), kv_cache.v.clone()
        if not per_slot(cache_pos):  # uniform position across the batch
            p0 = int(cache_pos)
            k_all[:, p0:p0 + s] = k.to(k_all.dtype)
            v_all[:, p0:p0 + s] = v.to(v_all.dtype)
            pos_b = torch.full((1,), p0, device=x.device)
        else:  # per-slot positions (continuous batching)
            rows = torch.arange(b, device=x.device)[:, None]
            cols = cache_pos[:, None] + torch.arange(s, device=x.device)[None]
            k_all[rows, cols] = k.to(k_all.dtype)
            v_all[rows, cols] = v.to(v_all.dtype)
            pos_b = cache_pos
        skv = k_all.shape[1]
        # position j is visible to query step i iff j <= cache_pos + i
        valid = torch.arange(skv, device=x.device)[None, None, :] <= (
            pos_b[:, None, None] + torch.arange(s, device=x.device)[None, :, None]
        )
        out = _sdpa(q, k_all, v_all, valid[:, None], cfg)
        return _mm(out, p["wo"]), KVSlice(k_all, v_all)

    if s > CHUNKED_ATTN_THRESHOLD:
        out = _chunked_sdpa(q, k, v, cfg, causal=causal)
    else:
        mask = None
        if causal:
            mask = torch.tril(torch.ones((s, s), dtype=torch.bool, device=x.device))[None, None]
        out = _sdpa(q, k, v, mask, cfg)
    return _mm(out, p["wo"]), KVSlice(k, v)


# -------------------------------------------------------------------- MLP --


def mlp_init(gen: torch.Generator, cfg: LMConfig, d_ff: Optional[int] = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = cfg.param_dtype
    return {
        "wi": _init(gen, (d, f), dt),
        "wg": _init(gen, (d, f), dt),
        "wo": _init(gen, (f, d), dt),
    }


def mlp_axes(cfg: LMConfig) -> dict:
    return {"wi": ("embed", "mlp"), "wg": ("embed", "mlp"), "wo": ("mlp", "embed")}


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``'s formula, x·sigmoid(x)."""
    return x * torch.sigmoid(x)


def mlp(x: torch.Tensor, p: dict) -> torch.Tensor:
    """SwiGLU."""
    return _mm(silu(_mm(x, p["wg"])) * _mm(x, p["wi"]), p["wo"])


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``'s formula, logaddexp(x, 0) (no linear cut-off)."""
    return torch.logaddexp(x, torch.zeros_like(x))


# -------------------------------------------------------------- embeddings --


def embed_init(gen: torch.Generator, cfg: LMConfig) -> dict:
    dt = cfg.param_dtype
    p = {
        "tok": _init(gen, (cfg.vocab_size, cfg.d_model), dt, scale=1.0),
        "final_norm": torch.ones((cfg.d_model,), dtype=dt, device=gen.device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = _init(gen, (cfg.d_model, cfg.vocab_size), dt)
    return p


def embed_axes(cfg: LMConfig) -> dict:
    a = {"tok": ("vocab", "embed"), "final_norm": (None,)}
    if not cfg.tie_embeddings:
        a["lm_head"] = ("embed", "vocab")
    return a


def embed_tokens(tokens: torch.Tensor, p: dict) -> torch.Tensor:
    return p["tok"][tokens]


def logits_fn(x: torch.Tensor, p: dict, cfg: LMConfig) -> torch.Tensor:
    """Final norm and LM head: the product in the parameters' dtype, cast
    to f32 (``de.lm_head``'s ``(x @ w).astype(float32)``)."""
    x = rmsnorm(x, p["final_norm"], cfg.norm_eps)
    w = p["tok"].T if cfg.tie_embeddings else p["lm_head"]
    return _mm(x, w).float()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits (..., V) f32, labels (...) integers. Mean NLL: the logsumexp
    as ``jax.nn.logsumexp`` computes it (the max held out of the gradient,
    0 where it is not finite) minus the gold logit."""
    m = logits.detach().amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    logz = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)
