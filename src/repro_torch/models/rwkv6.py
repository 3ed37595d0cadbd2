"""RWKV6 "Finch" (attention-free, data-dependent decay) — rwkv6-3b.
Counterpart of ``repro/models/rwkv6.py``.

Time-mix recurrence per head (state S ∈ R^{hd×hd}):
    y_t = r_t · (diag(u)·k_t v_tᵀ + S_t)
    S_{t+1} = diag(w_t) · S_t + k_t v_tᵀ
with data-dependent per-channel decay w_t = exp(-exp(w0 + tanh(x W_a) W_b)).

Prefill and training run the chunked form (:func:`_wkv_chunked`, chunks of
64): within a chunk an attention-like masked product with decay weights,
the state carried chunk to chunk. It is the JAX package's formulation, its
``exp`` factorisation clipped to ±60 and its pad (w = 1, k = 0) included.
A single token (decode) takes the recurrence itself.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as tfm

HEAD_DIM = 64
LORA_R = 64


def n_heads(cfg: LMConfig) -> int:
    return cfg.d_model // HEAD_DIM


def rwkv_init(gen: torch.Generator, cfg: LMConfig) -> dict:
    d = cfg.d_model
    dt = cfg.param_dtype
    dev = gen.device

    def full(v, dtype=dt):
        return torch.full((d,), v, dtype=dtype, device=dev)

    return {
        "ln1": full(1.0),
        "ln2": full(1.0),
        # time-mix interpolation factors (token shift)
        "mu_r": full(0.5),
        "mu_k": full(0.5),
        "mu_v": full(0.5),
        "mu_g": full(0.5),
        "mu_w": full(0.5),
        "w_r": L._init(gen, (d, d), dt),
        "w_k": L._init(gen, (d, d), dt),
        "w_v": L._init(gen, (d, d), dt),
        "w_g": L._init(gen, (d, d), dt),
        "w_o": L._init(gen, (d, d), dt),
        # data-dependent decay LoRA
        "w0": full(-6.0, torch.float32),
        "w_a": L._init(gen, (d, LORA_R), dt),
        "w_b": L._init(gen, (LORA_R, d), dt),
        "u": full(0.0, torch.float32),  # bonus for the current token
        "gn": full(1.0),  # norm weight on the head outputs
        # channel-mix
        "mu_cr": full(0.5),
        "mu_ck": full(0.5),
        "c_r": L._init(gen, (d, d), dt),
        "c_k": L._init(gen, (d, cfg.d_ff), dt),
        "c_v": L._init(gen, (cfg.d_ff, d), dt),
    }


def rwkv_axes(cfg: LMConfig) -> dict:
    vec = (None,)
    mat = ("embed", "heads")
    return {
        "ln1": vec, "ln2": vec,
        "mu_r": vec, "mu_k": vec, "mu_v": vec, "mu_g": vec, "mu_w": vec,
        "w_r": mat, "w_k": mat, "w_v": mat, "w_g": mat, "w_o": ("heads", "embed"),
        "w0": vec, "w_a": ("embed", None), "w_b": (None, "heads"), "u": vec, "gn": vec,
        "mu_cr": vec, "mu_ck": vec,
        "c_r": ("embed", "heads"), "c_k": ("embed", "mlp"), "c_v": ("mlp", "embed"),
    }


class RWKVState(NamedTuple):
    s: torch.Tensor  # (B, H, hd, hd) wkv state
    x_tm: torch.Tensor  # (B, D) last token (time-mix shift)
    x_cm: torch.Tensor  # (B, D) last token (channel-mix shift)


def init_state(cfg: LMConfig, batch: int, *, device) -> RWKVState:
    h = n_heads(cfg)
    return RWKVState(
        s=torch.zeros((batch, h, HEAD_DIM, HEAD_DIM), dtype=torch.float32, device=device),
        x_tm=torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device),
        x_cm=torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device),
    )


def _shift(x, last):
    """Token shift: x_{t-1} with the carried boundary. x (B,T,D), last (B,D)."""
    return torch.cat([last[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _exp_clip(a, lo: float, hi: float):
    return torch.exp(torch.clamp(a, lo, hi))


def _wkv_chunked(r, k, v, w, u, s0, *, chunk: int = 64):
    """Chunked WKV6. r/k/v (B,T,H,hd), w (B,T,H,hd) decay in (0,1),
    s0 (B,H,hd,hd); T a multiple of ``chunk``. Returns (y (B,T,H,hd),
    s_final).

    Recurrence: S_t = diag(w_t)·S_{t-1} + k_t v_tᵀ ;
                y_t = rᵀ_t (S_{t-1} + diag(u)·k_t v_tᵀ).
    """
    B, T, H, hd = r.shape
    nc = T // chunk
    assert T % chunk == 0
    rc = r.reshape(B, nc, chunk, H, hd)
    kc = k.reshape(B, nc, chunk, H, hd)
    vc = v.reshape(B, nc, chunk, H, hd)
    logw = torch.log(torch.clamp(w, 1e-8, 1.0)).reshape(B, nc, chunk, H, hd)
    sw = torch.cumsum(logw, dim=2)  # inclusive cumulative log decay

    # intra-chunk: the decay from an injection at i to t > i is
    # e^{sw_t - sw_i}, factored as (r_t ∘ e^{sw_t}) · (k_i ∘ e^{-sw_i})
    r_tilde = rc * _exp_clip(sw, -60.0, 0.0)
    k_tilde = kc * _exp_clip(-sw, 0.0, 60.0)
    scores = torch.einsum("bnthd,bnihd->bntih", r_tilde, k_tilde)  # (B,nc,t,i,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), -1)
    scores = torch.where(tri[None, None, :, :, None], scores, 0.0)
    y_intra = torch.einsum("bntih,bnihd->bnthd", scores, vc)
    # current-token bonus: y_t += (r_t ∘ u ∘ k_t)·v_t
    bonus = torch.sum(rc * u[None, None, None] * kc, dim=-1)  # (B,nc,t,H)
    y_intra = y_intra + bonus[..., None] * vc

    # chunk state: S' = diag(e^{sw_last}) S + Σ_i diag(e^{sw_last - sw_i}) k_i v_iᵀ
    sw_last = sw[:, :, -1:]  # (B,nc,1,H,hd)
    rdec = _exp_clip(sw_last - sw, -60.0, 0.0)
    inj = torch.einsum("bnthd,bntho->bnhdo", kc * rdec, vc)  # (B,nc,H,hd,hd)
    cdec = _exp_clip(sw_last[:, :, 0], -60.0, 0.0)  # (B,nc,H,hd)

    # unbind, not inj[:, n]: the backward stacks the chunks' gradients once
    # where indexing builds a zero gradient of the whole tensor per chunk
    s, s_prevs = s0, []
    for c_n, inj_n in zip(cdec.unbind(1), inj.unbind(1)):
        s_prevs.append(s)
        s = s * c_n[..., None] + inj_n
    s_prevs = torch.stack(s_prevs, dim=1)  # (B,nc,H,hd,hd)

    # inter-chunk: the carried state decayed from the chunk start to t
    esw = _exp_clip(sw, -60.0, 0.0)
    y_inter = torch.einsum("bnthd,bnhdo->bntho", rc * esw, s_prevs)

    y = (y_intra + y_inter).reshape(B, T, H, hd)
    return y, s


def time_mix(x, p, cfg: LMConfig, state: Optional[RWKVState], *, chunk: int = 64):
    b, t, d = x.shape
    H = n_heads(cfg)
    f32 = torch.float32
    last = state.x_tm if state is not None else torch.zeros((b, d), dtype=f32, device=x.device)
    xs = _shift(x, last)

    def lerp(mu):
        return x + (xs - x) * mu[None, None]

    r = L._mm(lerp(p["mu_r"]), p["w_r"]).reshape(b, t, H, HEAD_DIM).to(f32)
    k = L._mm(lerp(p["mu_k"]), p["w_k"]).reshape(b, t, H, HEAD_DIM).to(f32)
    v = L._mm(lerp(p["mu_v"]), p["w_v"]).reshape(b, t, H, HEAD_DIM).to(f32)
    g = L.silu(L._mm(lerp(p["mu_g"]), p["w_g"]))
    wln = p["w0"][None, None] + torch.tanh(
        lerp(p["mu_w"]).to(f32) @ p["w_a"].to(f32)
    ) @ p["w_b"].to(f32)
    w = torch.exp(-torch.exp(wln)).reshape(b, t, H, HEAD_DIM)  # decay ∈ (0,1)
    u = p["u"].reshape(H, HEAD_DIM)

    if state is not None:
        s0 = state.s
    else:
        s0 = torch.zeros((b, H, HEAD_DIM, HEAD_DIM), dtype=f32, device=x.device)
    if t == 1:  # decode: the recurrence
        r1, k1, v1, w1 = r[:, 0], k[:, 0], v[:, 0], w[:, 0]
        y = torch.einsum("bhd,bhdo->bho", r1, s0) + torch.sum(
            r1 * u[None] * k1, dim=-1, keepdim=True
        ) * v1
        s_final = s0 * w1[..., None] + torch.einsum("bhd,bho->bhdo", k1, v1)
        y = y[:, None]  # (B,1,H,hd)
    else:
        pad = (-t) % chunk
        if pad:  # pad steps decay nothing (w = 1) and inject nothing (k = 0)
            r, k, v = (torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v))
            w = torch.nn.functional.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
        y, s_final = _wkv_chunked(r, k, v, w, u, s0, chunk=chunk)
        y = y[:, :t]

    y = y.reshape(b, t, d)
    y = L.rmsnorm(y.to(x.dtype), p["gn"], cfg.norm_eps) * g
    out = L._mm(y, p["w_o"])
    return out, s_final, x[:, -1].to(f32)


def channel_mix(x, p, state: Optional[RWKVState]):
    b, t, d = x.shape
    last = (state.x_cm if state is not None
            else torch.zeros((b, d), dtype=torch.float32, device=x.device))
    xs = _shift(x, last)
    xr = x + (xs - x) * p["mu_cr"][None, None]
    xk = x + (xs - x) * p["mu_ck"][None, None]
    rr = torch.sigmoid(L._mm(xr, p["c_r"]))
    kk = torch.square(torch.relu(L._mm(xk, p["c_k"])))
    return rr * L._mm(kk, p["c_v"]), x[:, -1].to(torch.float32)


def rwkv_block(x, lp, cfg: LMConfig, *, state: Optional[RWKVState] = None, chunk: int = 64):
    """One RWKV6 layer. Returns (x, new_state)."""
    h, s_new, tm_last = time_mix(L.rmsnorm(x, lp["ln1"], cfg.norm_eps), lp, cfg, state,
                                 chunk=chunk)
    x = x + h
    h2, cm_last = channel_mix(L.rmsnorm(x, lp["ln2"], cfg.norm_eps), lp, state)
    x = x + h2
    return x, RWKVState(s=s_new, x_tm=tm_last, x_cm=cm_last)


# ------------------------------------------------------------- full model --


def init_params(gen: torch.Generator, cfg: LMConfig) -> dict:
    return tfm.init_params(gen, cfg, rwkv_init)


def param_axes(cfg: LMConfig) -> dict:
    return tfm.param_axes(cfg, rwkv_axes)


def init_cache(cfg: LMConfig, batch: int, *, device) -> RWKVState:
    """The recurrent state stacked over layers: O(1) in sequence length."""
    st = init_state(cfg, batch, device=device)
    return RWKVState(*(torch.zeros((cfg.n_layers,) + tuple(a.shape), dtype=torch.float32,
                                   device=device) for a in st))


def _block_out(x, lp, cfg, chunk):
    return rwkv_block(x, lp, cfg, chunk=chunk)[0]


def forward(params, tokens, cfg: LMConfig, *, state: Optional[RWKVState] = None,
            collect_state: bool = False, chunk: int = 64):
    """tokens (B, T) → (logits, new_state | None), layer by layer over the
    stacked params (JAX's scan). Under autograd with ``cfg.remat`` and no
    state to collect, each block is recomputed in the backward."""
    collect_state = collect_state or state is not None
    remat = cfg.remat and torch.is_grad_enabled() and not collect_state
    x = L.embed_tokens(tokens, params["embed"])
    new = []
    for i in range(cfg.n_layers):
        lp = tfm.layer_params(params["layers"], i)
        if remat:
            x = checkpoint(_block_out, x, lp, cfg, chunk, use_reentrant=False,
                           preserve_rng_state=False)
            continue
        st = RWKVState(*(a[i] for a in state)) if state is not None else None
        x, ns = rwkv_block(x, lp, cfg, state=st, chunk=chunk)
        if collect_state:
            new.append(ns)
    logits = L.logits_fn(x, params["embed"], cfg)
    new_state = RWKVState(*(torch.stack(f) for f in zip(*new))) if new else None
    return logits, new_state
