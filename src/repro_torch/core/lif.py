"""Leaky integrate-and-fire dynamics and threshold-dependent batch norm
(paper §I, §II-A). Counterpart of ``repro/core/lif.py``.

    v[t] = leak · v[t-1] + x[t];  s[t] = v[t] ≥ θ
    hard reset: v = v·(1 − s);  soft: v −= θ·s;  none: no reset

Training backpropagates through the spike with the STBP rectangular
surrogate (Wu et al. 2019): ds/dv ≈ 1[|v − θ| < W/2] / W, W = 1, and no
gradient to θ. The hard reset keeps its product form, so the gradient also
flows through the reset by way of the surrogate.

tdBN: y = α·θ·(x − μ)·rsqrt(σ² + ε)·γ + β, statistics pooled over every
axis but the channel (time counts as batch).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

THRESHOLD = 0.5
LEAK = 0.25
SURROGATE_WIDTH = 1.0


class _Spike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, threshold):
        ctx.save_for_backward(v)
        ctx.threshold = threshold
        return (v >= threshold).to(v.dtype)

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        surrogate = ((v - ctx.threshold).abs() < SURROGATE_WIDTH / 2).to(g.dtype)
        return g * surrogate / SURROGATE_WIDTH, None


def spike_fn(v: torch.Tensor, threshold: float = THRESHOLD) -> torch.Tensor:
    """Heaviside spike (f32 {0, 1}) with the rectangular surrogate gradient."""
    return _Spike.apply(v, threshold)


class LIFState(NamedTuple):
    v: torch.Tensor


def lif_step(state: LIFState, x: torch.Tensor, *, threshold=THRESHOLD, leak=LEAK,
             reset: str = "hard"):
    """One LIF step. Returns (new_state, spikes f32 {0,1})."""
    v = state.v * leak + x
    s = spike_fn(v, threshold)
    if reset == "hard":
        v_next = v * (1.0 - s)
    elif reset == "soft":
        v_next = v - s * threshold
    elif reset == "none":
        v_next = v
    else:
        raise ValueError(f"unknown reset mode {reset!r}")
    return LIFState(v=v_next), s


def lif_over_time(x_seq: torch.Tensor, *, threshold=THRESHOLD, leak=LEAK,
                  reset: str = "hard", init: LIFState | None = None):
    """LIF over the leading time axis. x_seq: (T, ...) → (spikes (T, ...),
    final LIFState)."""
    state = init if init is not None else LIFState(v=torch.zeros_like(x_seq[0]))
    spikes = []
    for x in x_seq:
        state, s = lif_step(state, x, threshold=threshold, leak=leak, reset=reset)
        spikes.append(s)
    return torch.stack(spikes), state


def membrane_readout(x_seq: torch.Tensor, *, leak=LEAK, v0: torch.Tensor | None = None,
                     return_final: bool = False):
    """The output layer: accumulate the membrane with no reset and average
    it over the time steps. ``v0`` warm-starts the accumulator."""
    v = torch.zeros_like(x_seq[0]) if v0 is None else v0
    total = None
    for x in x_seq:
        v = v * leak + x
        total = v if total is None else total + v
    out = total / x_seq.shape[0]
    return (out, v) if return_final else out


class TdBNParams(NamedTuple):
    gamma: torch.Tensor
    beta: torch.Tensor


class TdBNState(NamedTuple):
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor


def bn_rinv(var: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """rsqrt(var + eps) — the one place both executors take it from.
    ``torch.rsqrt`` rounds differently on the CPU and the card (and from
    XLA's), so the kernel's bundle and the dense path's eval-mode tdBN must
    share this helper on one device to agree bit for bit."""
    return torch.rsqrt(var + eps)


def tdbn_apply(params: TdBNParams, state: TdBNState, x: torch.Tensor, *,
               threshold=THRESHOLD, alpha: float = 1.0, momentum: float = 0.9,
               training: bool = True, eps: float = 1e-5,
               rinv: torch.Tensor | None = None):
    """tdBN over a (T, N, ..., C) volume, channels last. Returns
    (y, new_state): train mode normalises by this batch's statistics and
    moves the running ones; eval mode uses the running ones, and takes
    rsqrt(var + eps) from ``rinv`` when given — the row of the affine
    bundle a compiled detector carries, so the unfused layers multiply by
    the value the fused kernel does (and, for a bundle carried over from the
    JAX package, by the value XLA rounded)."""
    reduce_dims = tuple(range(x.dim() - 1))
    if training:
        mean = x.mean(dim=reduce_dims)
        var = x.var(dim=reduce_dims, unbiased=False)
        new_state = TdBNState(
            mean=momentum * state.mean + (1 - momentum) * mean,
            var=momentum * state.var + (1 - momentum) * var,
            count=state.count + 1,
        )
    else:
        mean, var = state.mean, state.var
        new_state = state
    if training or rinv is None:
        rinv = bn_rinv(var, eps)
    x_hat = (x - mean) * rinv
    y = (alpha * threshold) * x_hat * params.gamma + params.beta
    return y, new_state
