"""Mamba2 (SSD) blocks for the zamba2-7b hybrid. Counterpart of
``repro/models/mamba2.py``.

The SSM recurrence  h_t = a_t · h_{t-1} + dt_t · B_t ⊗ x_t,  y_t = C_t · h_t
is a data-dependent leaky integrator. Prefill and training use the chunked
SSD form (:func:`_ssd_chunked`, chunks of 128: masked products within a
chunk, the state carried chunk to chunk), the JAX package's formulation
with its ±60 ``exp`` clips and its pad (dt = 0); decode is the single-step
recurrence on a carried state.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import LMConfig
from repro_torch.models import layers as L

CONV_K = 4  # depthwise causal conv width (mamba2 default)


def d_inner(cfg: LMConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def n_ssm_heads(cfg: LMConfig) -> int:
    return d_inner(cfg) // cfg.ssm_head_dim


def mamba_init(gen: torch.Generator, cfg: LMConfig) -> dict:
    d = cfg.d_model
    di = d_inner(cfg)
    nh = n_ssm_heads(cfg)
    ds = cfg.ssm_state
    dt = cfg.param_dtype
    dev = gen.device
    f32 = torch.float32
    # in_proj → [z, x, B, C, dt]
    proj_out = di + di + ds + ds + nh
    return {
        "in_proj": L._init(gen, (d, proj_out), dt),
        "conv_w": L._init(gen, (CONV_K, di + 2 * ds), dt, scale=0.5),
        "A_log": torch.zeros((nh,), dtype=f32, device=dev),
        "D": torch.ones((nh,), dtype=f32, device=dev),
        "dt_bias": torch.zeros((nh,), dtype=f32, device=dev),
        "out_norm": torch.ones((di,), dtype=dt, device=dev),
        "out_proj": L._init(gen, (di, d), dt),
        "ln": torch.ones((d,), dtype=dt, device=dev),
    }


def mamba_axes(cfg: LMConfig) -> dict:
    return {
        "in_proj": ("embed", "mlp"),
        "conv_w": ("conv_k", "mlp"),
        "A_log": (None,),
        "D": (None,),
        "dt_bias": (None,),
        "out_norm": ("mlp",),
        "out_proj": ("mlp", "embed"),
        "ln": (None,),
    }


class MambaState(NamedTuple):
    h: torch.Tensor  # (B, nh, head_dim, d_state) SSM state
    conv: torch.Tensor  # (B, CONV_K-1, di + 2*ds) conv tail


def init_state(cfg: LMConfig, batch: int, *, device, lead: tuple = ()) -> MambaState:
    """Zero f32 states, with ``lead`` axes (stacked layers) before the batch."""
    di = d_inner(cfg)
    f32 = torch.float32
    return MambaState(
        h=torch.zeros(tuple(lead) + (batch, n_ssm_heads(cfg), cfg.ssm_head_dim, cfg.ssm_state),
                      dtype=f32, device=device),
        conv=torch.zeros(tuple(lead) + (batch, CONV_K - 1, di + 2 * cfg.ssm_state), dtype=f32,
                         device=device),
    )


def _split_proj(xz, cfg: LMConfig):
    di = d_inner(cfg)
    ds = cfg.ssm_state
    z = xz[..., :di]
    xbc = xz[..., di:di + di + 2 * ds]
    dt = xz[..., di + di + 2 * ds:]
    return z, xbc, dt


def _causal_conv(xbc, conv_w, conv_state=None):
    """Depthwise causal conv1d. xbc (B, T, C); returns (out, new_tail)."""
    b, t, c = xbc.shape
    if conv_state is None:
        pad = torch.zeros((b, CONV_K - 1, c), dtype=xbc.dtype, device=xbc.device)
    else:
        pad = conv_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)  # (B, T+K-1, C)
    out = sum(xp[:, i:i + t, :] * conv_w[i][None, None] for i in range(CONV_K))
    return L.silu(out), xp[:, -(CONV_K - 1):, :]


def _exp_clip(a, lo: float, hi: float):
    return torch.exp(torch.clamp(a, lo, hi))


def _ssd_chunked(xh, dt, a_log, b_in, c_in, d_skip, h0, *, chunk: int = 128):
    """Chunked SSD. xh (B, T, nh, hd), dt (B, T, nh), b_in/c_in (B, T, ds),
    h0 (B, nh, hd, ds); T a multiple of ``chunk``. Returns (y (B,T,nh,hd),
    h_final). Scalar-per-head decay a_t = exp(-exp(a_log) · dt_t)."""
    B, T, nh, hd = xh.shape
    ds = b_in.shape[-1]
    nc = T // chunk
    assert T % chunk == 0, (T, chunk)
    xc = xh.reshape(B, nc, chunk, nh, hd)
    dtc = dt.reshape(B, nc, chunk, nh)
    bc = b_in.reshape(B, nc, chunk, ds)
    cc = c_in.reshape(B, nc, chunk, ds)

    neg_a = -torch.exp(a_log)[None, None, None]  # (1,1,1,nh)
    log_a = neg_a * dtc  # (B, nc, chunk, nh) log decay per step
    s = torch.cumsum(log_a, dim=2)  # within-chunk cumulative log decay

    # intra-chunk: Y[t] = Σ_{i<=t} C_t·B_i · e^{s_t - s_i} · dt_i x_i, with
    # e^{s_t - s_i} factored as e^{s_t}·e^{-s_i}
    cb = torch.einsum("bnts,bnis->bnti", cc, bc)  # (B,nc,chunk,chunk)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=xh.device))
    cb = torch.where(tri[None, None], cb, 0.0)
    e_pos = _exp_clip(s, -60.0, 0.0)  # e^{s_t}
    e_neg = _exp_clip(-s, 0.0, 60.0)  # e^{-s_i}
    x_tilde = xc * (e_neg * dtc)[..., None]
    y_intra = torch.einsum("bnti,bnihd->bnthd", cb, x_tilde) * e_pos[..., None]

    # chunk state: h' = e^{s_last} h + Σ_i e^{s_last - s_i} dt_i B_i⊗x_i
    s_last = s[:, :, -1:, :]  # (B,nc,1,nh)
    rdecay = _exp_clip(s_last - s, -60.0, 0.0)
    u = torch.einsum("bnth,bnthd,bnts->bnhds", dtc * rdecay, xc, bc)
    chunk_decay = _exp_clip(s_last[:, :, 0, :], -60.0, 0.0)  # (B,nc,nh)

    # unbind, not u[:, n]: the backward stacks the chunks' gradients once
    # where indexing builds a zero gradient of the whole tensor per chunk
    h, h_prevs = h0, []
    for d_n, u_n in zip(chunk_decay.unbind(1), u.unbind(1)):
        h_prevs.append(h)
        h = h * d_n[:, :, None, None] + u_n
    h_prevs = torch.stack(h_prevs, dim=1)  # (B,nc,nh,hd,ds)

    # inter-chunk: y_t += C_t · e^{s_t} h_chunk_start
    e_s = _exp_clip(s, -60.0, 0.0)
    y_inter = torch.einsum("bnts,bnhds,bnth->bnthd", cc, h_prevs, e_s)

    y = (y_intra + y_inter).reshape(B, T, nh, hd)
    y = y + d_skip[None, None, :, None] * xh
    return y, h


def mamba_forward(x, p, cfg: LMConfig, *, state: Optional[MambaState] = None, chunk=128):
    """x (B, T, D) → (x + out, new_state): the recurrence for T = 1
    (decode), the chunked SSD for T > 1 (prefill, training)."""
    b, t, d = x.shape
    nh, hd, ds = n_ssm_heads(cfg), cfg.ssm_head_dim, cfg.ssm_state
    f32 = torch.float32
    h = L.rmsnorm(x, p["ln"], cfg.norm_eps)
    xz = L._mm(h, p["in_proj"])
    z, xbc, dt_raw = _split_proj(xz, cfg)
    xbc, conv_tail = _causal_conv(xbc, p["conv_w"], state.conv if state is not None else None)
    di = d_inner(cfg)
    xh = xbc[..., :di].reshape(b, t, nh, hd).to(f32)
    b_in = xbc[..., di:di + ds].to(f32)
    c_in = xbc[..., di + ds:].to(f32)
    dt = L.softplus(dt_raw.to(f32) + p["dt_bias"][None, None])  # (B,T,nh)

    h0 = state.h if state is not None else torch.zeros((b, nh, hd, ds), dtype=f32,
                                                       device=x.device)
    if t == 1:  # decode: one recurrence step
        a = torch.exp(-torch.exp(p["A_log"])[None, :] * dt[:, 0])  # (B, nh)
        inj = torch.einsum("bh,bhd,bs->bhds", dt[:, 0], xh[:, 0], b_in[:, 0])
        h_final = h0 * a[:, :, None, None] + inj
        y = torch.einsum("bs,bhds->bhd", c_in[:, 0], h_final)
        y = y + p["D"][None, :, None] * xh[:, 0]
        y = y[:, None]  # (B,1,nh,hd)
    else:
        pad = (-t) % chunk
        if pad:  # pad steps have dt = 0: no decay, no injection
            xh = torch.nn.functional.pad(xh, (0, 0, 0, 0, 0, pad))
            dt, b_in, c_in = (torch.nn.functional.pad(a, (0, 0, 0, pad))
                              for a in (dt, b_in, c_in))
        y, h_final = _ssd_chunked(xh, dt, p["A_log"], b_in, c_in, p["D"], h0, chunk=chunk)
        y = y[:, :t]

    y = y.reshape(b, t, di).to(x.dtype)
    y = L.rmsnorm(y, p["out_norm"], cfg.norm_eps) * L.silu(z)
    out = L._mm(y, p["out_proj"])
    return x + out, MambaState(h=h_final, conv=conv_tail.to(f32))
