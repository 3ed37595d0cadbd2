"""The paper's SNN object detector (§II, Fig 1/2) and its ANN/QNN/BNN
baselines (Table II), for inference and training.

Counterpart of ``repro/models/snn_yolo.py`` with the same topology, layer
names, parameter shapes and config fields:

  encode 3×3 3→16 (in_T=1) · pool · conv_block 3×3 16→32 (1 → T) · pool
  · 5 CSP basic blocks (shortcut 1×1, main 1×1 → 3×3 → 3×3, agg 1×1 over
  the concat), pooling after the first ``pooled_stages − 1`` · 1×1 head
  read out as the no-reset membrane averaged over T.

Tensors are NHWC with time leading: (T, N, H, W, C). Parameters are a
dict {layer: {"w", "gamma", "beta"}}; tdBN state {layer: {"mean", "var",
"count"}}. The ANN→SNN conversion's operating point runs here too: rate
encoding, the rate-gated pool, ``pool_drive`` and ``taps=``. Training
(``forward(..., train=True)`` without a plan) runs the differentiable
fake-quant float path: STE weights, tdBN batch statistics, the surrogate
spike; :func:`yolo_loss` is its objective. :func:`layer_specs` describes
the network to the energy model (:mod:`repro_torch.core.energy`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch import tree as tu
from repro_torch.backend import resolve_device
from repro_torch.core import block_conv as bc
from repro_torch.core import energy as en
from repro_torch.core import lif as lifm
from repro_torch.core import plan as cplan
from repro_torch.core import quant


@dataclass(frozen=True)
class SNNDetConfig:
    arch_id: str = "snn-det"
    input_hw: tuple = (576, 1024)
    num_classes: int = 3
    num_anchors: int = 5
    stem_channels: int = 16
    conv_block_channels: int = 32
    stage_channels: tuple = ((32, 32), (32, 64), (64, 128), (128, 256), (256, 256))
    pooled_stages: int = 4
    full_t: int = 3
    threshold: float = 0.5
    leak: float = 0.25
    reset: str = "hard"
    v_init: float = 0.0
    pool_drive: bool = False
    pool_mode: str = "or"
    head_readout: str = "mean"
    mode: str = "snn"
    act_bits: int = 4
    weight_bits: int = 8
    use_block_conv: bool = False
    mixed_time: bool = True
    rate_encode: bool = False
    conv_exec: str = "dense"
    block_hw: tuple = (18, 32)
    # the JAX package's Pallas interpret override; kept so its config
    # sidecars load, and ignored here
    kernel_interpret: bool | None = None

    @property
    def head_channels(self) -> int:
        return self.num_anchors * (5 + self.num_classes)

    @property
    def grid_hw(self) -> tuple:
        f = 2 ** (self.pooled_stages + 1)
        return (self.input_hw[0] // f, self.input_hw[1] // f)


def config_to_dict(cfg: SNNDetConfig) -> dict:
    """JSON-serializable dict of the config (the checkpoint sidecar)."""
    return dataclasses.asdict(cfg)


def config_from_dict(d: dict) -> SNNDetConfig:
    """Inverse of :func:`config_to_dict`; reads sidecars the JAX package
    wrote (JSON lists become tuples again)."""
    d = dict(d)
    unknown = set(d) - {f.name for f in dataclasses.fields(SNNDetConfig)}
    if unknown:
        raise ValueError(f"unknown SNNDetConfig fields {sorted(unknown)} — "
                         "checkpoint written by an incompatible version?")
    for k in ("input_hw", "block_hw"):
        if k in d:
            d[k] = tuple(d[k])
    if "stage_channels" in d:
        d["stage_channels"] = tuple(tuple(p) for p in d["stage_channels"])
    return SNNDetConfig(**d)


# ----------------------------------------------------------------- params --


def layer_shapes(cfg: SNNDetConfig) -> dict:
    """{layer: (kh, kw, cin, cout)} in the JAX package's parameter order."""
    out = {
        "encode": (3, 3, 3, cfg.stem_channels),
        "conv_block": (3, 3, cfg.stem_channels, cfg.conv_block_channels),
    }
    for i, (cin, cout) in enumerate(cfg.stage_channels):
        half = cout // 2
        out[f"stage{i}/shortcut"] = (1, 1, cin, half)
        out[f"stage{i}/main_in"] = (1, 1, cin, cout)
        out[f"stage{i}/main_a"] = (3, 3, cout, cout)
        out[f"stage{i}/main_b"] = (3, 3, cout, cout)
        out[f"stage{i}/agg"] = (1, 1, cout + half, cout)
    out["head"] = (1, 1, cfg.stage_channels[-1][1], cfg.head_channels)
    return out


def membrane_hw(cfg: SNNDetConfig) -> dict:
    """{layer: (H, W)} of each layer's LIF membrane: its output map, halved
    for the layers whose pool ``pool_drive`` moves before the LIF (encode,
    conv_block and the pooled stages' agg) — the shapes of a session's
    state, as the JAX package derives them from the step itself."""
    hw = layer_hw(cfg)
    if cfg.pool_drive:
        pooled = ["encode", "conv_block"] + [
            f"stage{i}/agg" for i in range(len(cfg.stage_channels))
            if i < cfg.pooled_stages - 1
        ]
        for name in pooled:
            hw[name] = (hw[name][0] // 2, hw[name][1] // 2)
    return hw


def layer_hw(cfg: SNNDetConfig) -> dict:
    """{layer: (H, W)} of each layer's output (= input) feature map."""
    h, w = cfg.input_hw
    out = {"encode": (h, w), "conv_block": (h // 2, w // 2)}
    sh, sw = h // 4, w // 4
    for i in range(len(cfg.stage_channels)):
        for part in ("shortcut", "main_in", "main_a", "main_b", "agg"):
            out[f"stage{i}/{part}"] = (sh, sw)
        if i < cfg.pooled_stages - 1:
            sh, sw = sh // 2, sw // 2
    out["head"] = cfg.grid_hw
    return out


def _bn_state(c: int, device) -> dict:
    return {
        "mean": torch.zeros(c, device=device),
        "var": torch.ones(c, device=device),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def init_params(cfg: SNNDetConfig, *, seed: int = 0, device=None):
    """(params, bn_state): He-normal conv weights drawn from a
    ``torch.Generator`` seeded with ``seed`` (on the CPU, so a seed gives
    the same weights on every device), gamma 1, beta 0, fresh tdBN stats.
    The JAX package draws from ``jax.random``: same shapes, other values."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params: dict[str, Any] = {}
    bn: dict[str, Any] = {}
    for name, (kh, kw, cin, cout) in layer_shapes(cfg).items():
        w = torch.randn((kh, kw, cin, cout), generator=gen) * math.sqrt(2.0 / (kh * kw * cin))
        params[name] = {"w": w.to(dev)}
        if name != "head":
            params[name]["gamma"] = torch.ones(cout, device=dev)
            params[name]["beta"] = torch.zeros(cout, device=dev)
            bn[name] = _bn_state(cout, dev)
    return params, bn


def param_count(params) -> int:
    return sum(leaf.numel() for leaf in tu.leaves(params))


def default_bn_state(params) -> dict:
    """Fresh inference-time tdBN state (mean 0, var 1) matching ``params``."""
    return {
        name: _bn_state(lp["w"].shape[-1], lp["w"].device)
        for name, lp in params.items()
        if "gamma" in lp
    }


@contextlib.contextmanager
def _no_tf32():
    """Full-f32 convs and matmuls: cuDNN's convs default to TF32 on the card."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@torch.no_grad()
def calibrate_bn_state(params, bn_state, images, cfg: SNNDetConfig, *, iters: int = 25):
    """Move the tdBN running statistics onto real activation statistics with
    train-mode forwards on the dense fake-quant path (no plan), TF32 off.
    Returns the new bn_state."""
    dense_cfg = dataclasses.replace(cfg, conv_exec="dense")
    images = torch.as_tensor(images, device=params["encode"]["w"].device)
    with _no_tf32():
        for _ in range(iters):
            bn_state = forward(params, bn_state, images, dense_cfg, train=True)[1]
    return bn_state


# ---------------------------------------------------------------- forward --


def _conv_t(x_t, layer_p, cfg: SNNDetConfig, *, name=None, plan=None):
    """One conv over the (T, N, H, W, C) volume: through the plan's executor
    when there is a plan, else the fake-quant float path."""
    if plan is not None and name is not None and name in plan.layers:
        return cplan.run_conv(x_t, plan.layers[name], cfg)
    w = _maybe_quant_w(layer_p["w"], cfg)
    t, n = x_t.shape[:2]
    x = x_t.reshape((t * n,) + tuple(x_t.shape[2:])).float()
    if cfg.use_block_conv and w.shape[0] > 1:
        bh, bw = cfg.block_hw
        y = bc.block_conv2d(x, w, block_h=bh, block_w=bw)
    else:
        y = bc.conv2d(x, w)
    return y.reshape((t, n) + tuple(y.shape[1:]))


def _maybe_quant_w(w, cfg: SNNDetConfig):
    if cfg.weight_bits and cfg.mode != "bnn":
        return quant.fake_quant_tensor(w, cfg.weight_bits)
    if cfg.mode == "bnn":
        # binary weights scaled by the mean magnitude (XNOR-style); |w| as a
        # select, whose gradient at 0 is 1 as jnp.abs's is
        return torch.sign(w) * torch.where(w >= 0, w, -w).mean()
    return w


def _tdbn(x_t, layer_p, layer_s, cfg, train, rinv=None):
    """tdBN over (T, N, H, W, C). The new running statistics carry no
    autograd history (the JAX package returns them as an ``aux``)."""
    params = lifm.TdBNParams(gamma=layer_p["gamma"], beta=layer_p["beta"])
    state = lifm.TdBNState(mean=layer_s["mean"], var=layer_s["var"], count=layer_s["count"])
    y, new = lifm.tdbn_apply(params, state, x_t, threshold=cfg.threshold, training=train,
                             rinv=rinv)
    return y, {"mean": new.mean.detach(), "var": new.var.detach(), "count": new.count}


def _activation(y_t, cfg: SNNDetConfig, *, v0=None):
    """Post-norm nonlinearity per model family. Returns (act, v_final);
    ``v0`` warm-starts the LIF membrane, and v_final is None for the
    stateless modes."""
    if cfg.mode == "snn":
        if v0 is None and cfg.v_init:
            v0 = torch.full(tuple(y_t.shape[1:]), cfg.v_init, dtype=y_t.dtype,
                            device=y_t.device)
        init = None if v0 is None else lifm.LIFState(v=v0)
        spikes, final = lifm.lif_over_time(
            y_t, threshold=cfg.threshold, leak=cfg.leak, reset=cfg.reset, init=init
        )
        return spikes, final.v
    if cfg.mode == "ann":
        return torch.relu(y_t), None
    if cfg.mode == "qnn":
        act = torch.relu(y_t)
        qmax = 2**cfg.act_bits - 1
        scale = torch.clamp(act.amax(), min=1e-6) / qmax
        return quant.fake_quant(act, scale), None
    if cfg.mode == "bnn":
        return lifm.spike_fn(y_t, 0.0), None  # binary activation, surrogate gradient
    raise ValueError(cfg.mode)


def _conv_bn_act(x_t, layer_p, layer_s, cfg, train, *, out_t=None, name=None,
                 plan=None, v0=None, affine=None, taps=None, pool=False):
    """Conv → tdBN → activation (the LIF in snn mode). Returns (act,
    new_bn_state, final membrane or None).

    Mixed time steps: with out_t > x_t.shape[0] == 1 the conv runs once and
    drives every LIF step. At eval on the kernel executor the whole chain
    is one launch of the fused kernel (``plan.run_fused``), unless the
    drive is recorded (``taps``: the tdBN output, before any pool, under
    the layer's name) or pooled before the LIF.

    ``pool``: this layer's output feeds a 2×2 pool. With ``cfg.pool_drive``
    (snn mode) the pool runs here, a max-pool of the tdBN drive before the LIF
    (whatever ``pool_mode`` is), and the caller skips its own pool. In eval
    mode the tdBN takes rsqrt(var + eps) from ``affine`` when given."""
    t_out = out_t or x_t.shape[0]
    pool_inside = pool and cfg.pool_drive and cfg.mode == "snn"
    if (
        not train
        and taps is None
        and not pool_inside
        and cfg.mode == "snn"
        and cfg.conv_exec == "pallas"
        and plan is not None
        and name in plan.layers
        and x_t.shape[0] in (1, t_out)
    ):
        spikes, v = cplan.run_fused(
            x_t, plan.layers[name], cfg,
            gamma=layer_p["gamma"], beta=layer_p["beta"],
            mean=layer_s["mean"], var=layer_s["var"],
            v0=v0, out_t=t_out, affine=affine,
        )
        return spikes, layer_s, v
    y_t = _conv_t(x_t, layer_p, cfg, name=name, plan=plan)
    if t_out != y_t.shape[0]:
        if y_t.shape[0] != 1:
            raise ValueError("can only broadcast a conv drive from T=1")
        y_t = y_t.expand((t_out,) + tuple(y_t.shape[1:]))
    rinv = None if train or affine is None else affine[2, : y_t.shape[-1]]
    y_t, new_s = _tdbn(y_t, layer_p, layer_s, cfg, train, rinv=rinv)
    if taps is not None and name is not None:
        taps[name] = y_t
    if pool_inside:
        y_t = _maxpool_t(y_t)
    act, v_final = _activation(y_t, cfg, v0=v0)
    return act, new_s, v_final


class _MaxPool2x2(torch.autograd.Function):
    """2×2 max-pool of (T, N, H, W, C) whose gradient goes to the first
    maximum of each window in row-major order, where XLA's select-and-
    scatter sends it (``amax`` would split it among tied maxima, and binary
    spikes tie all the time). An odd last row or column is dropped and gets
    no gradient, as under ``reduce_window``'s VALID padding."""

    @staticmethod
    def forward(ctx, x):
        t, n, h, w, c = x.shape
        win = _even(x).reshape(t, n, h // 2, 2, w // 2, 2, c).permute(0, 1, 2, 4, 6, 3, 5)
        win = win.reshape(t, n, h // 2, w // 2, c, 4)
        idx = win.argmax(dim=-1, keepdim=True)
        ctx.save_for_backward(idx)
        ctx.hw = (h, w)
        return win.gather(-1, idx).squeeze(-1)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        t, n, h2, w2, c, _ = idx.shape
        h, w = ctx.hw
        gw = torch.zeros((t, n, h2, w2, c, 4), dtype=g.dtype, device=g.device)
        gw.scatter_(-1, idx, g.unsqueeze(-1))
        gw = gw.reshape(t, n, h2, w2, c, 2, 2).permute(0, 1, 2, 5, 3, 6, 4)
        gw = gw.reshape(t, n, 2 * h2, 2 * w2, c)
        return torch.nn.functional.pad(gw, (0, 0, 0, w - 2 * w2, 0, h - 2 * h2))


def _even(x_t):
    """(T, N, H, W, C) cropped to even H and W: the 2×2 windows of a VALID
    pool, which drops an odd last row or column."""
    h, w = x_t.shape[2], x_t.shape[3]
    return x_t[:, :, : h - h % 2, : w - w % 2]


def _maxpool_t(x_t):
    """2×2 spike max-pool == OR gate (the paper's max-pooling module).
    Works on any dtype: uint8 spikes from the kernel, f32 from the oracle;
    differentiable as JAX's ``reduce_window`` max is, whose VALID windows
    drop an odd last row or column."""
    if x_t.requires_grad and torch.is_grad_enabled():
        return _MaxPool2x2.apply(x_t)
    t, n, h, w, c = x_t.shape
    return _even(x_t).reshape(t, n, h // 2, 2, w // 2, 2, c).amax(dim=(3, 5))


def _rate_gated_pool_t(s_t):
    """2×2 rate-gated spike pool (Rueckauer et al. 2017): each window emits
    the current spike of the input with the highest cumulative spike count,
    so the pooled rate tracks the largest input rate where the OR gate
    overestimates it. The max-reduce key is 2·count + spike in f32 (exact:
    count ≤ T ≪ 2^23), so ties go to a spiking input."""
    s = s_t.float()
    key = torch.cumsum(s, dim=0) * 2.0 + s
    return torch.remainder(_maxpool_t(key), 2.0).to(s_t.dtype)


def _pool_t(s_t, cfg: SNNDetConfig):
    """Pool a spike volume per ``cfg.pool_mode``: "rate" gates by rate (snn
    mode only: the other modes' activations are real-valued, where max is
    max), anything else is the OR-gate max-pool."""
    if cfg.mode == "snn" and cfg.pool_mode == "rate":
        return _rate_gated_pool_t(s_t)
    return _maxpool_t(s_t)


def forward(params, bn_state, images, cfg: SNNDetConfig, *, train: bool = False,
            plan=None, membrane=None, affines=None, taps=None):
    """images: (N, H, W, 3) in [0, 1]. Returns (head, new_bn_state, aux).
    ``train=True`` normalises by the batch's statistics and returns the
    moved running ones (detached); gradients flow when there is no plan.

    head: (N, gh, gw, anchors, 5 + classes) raw predictions.
    aux["spikes"]: per-macro-layer spikes; aux["membrane"]: each layer's
    final LIF membrane plus the head accumulator under "head" — the state
    a ``DetectorSession`` threads across frames.

    ``plan``: the compiled :class:`~repro_torch.core.plan.DetectorPlan`,
    required for any executor but ``dense``. ``membrane``: {layer: v}
    warm start (cold where missing). ``affines``: {layer: (5, Kp) bundle}
    precomputed for the fused kernel (and read for rsqrt(var + eps) by the
    unfused layers). ``taps``: a dict that, when given, receives every
    layer's tdBN output (the per-step LIF drive, (T, N, H, W, C), before
    any pool) under its name plus the raw head conv under "head" — the
    conversion front-end's probe; it keeps every layer off the fused
    kernel."""
    if cfg.conv_exec != "dense" and cfg.mode != "snn":
        # the compressed executors take binary spikes; the other modes'
        # activations are multibit floats and would be truncated
        raise ValueError(
            f"conv_exec={cfg.conv_exec!r} requires mode='snn' (got "
            f"mode={cfg.mode!r}: activations are not binary spikes)"
        )
    if cfg.conv_exec != "dense" and not cfg.weight_bits:
        raise ValueError(
            f"conv_exec={cfg.conv_exec!r} requires weight_bits > 0 (the "
            "compressed plan is FXP int8; weight_bits=0 means float weights)"
        )
    if plan is not None and tuple(plan.block_hw) != tuple(cfg.block_hw):
        raise ValueError(
            f"plan was built for block_hw={tuple(plan.block_hw)} but "
            f"cfg.block_hw={tuple(cfg.block_hw)}; rebuild the plan"
        )
    if plan is None and cfg.conv_exec != "dense":
        raise ValueError(
            f"conv_exec={cfg.conv_exec!r} needs a compiled plan: use "
            "repro_torch.models.snn_yolo.compile_detector(cfg, params)"
        )
    snn = cfg.mode == "snn"
    full_t = cfg.full_t if snn else 1
    new_state = dict(bn_state)
    aff = affines or {}
    mem = membrane or {}
    new_mem: dict[str, Any] = {}
    aux: dict[str, Any] = {"spikes": {}, "membrane": new_mem}

    def cba(x_in, lname, out_t=None, pool=False):
        s, new_state[lname], new_mem[lname] = _conv_bn_act(
            x_in, params[lname], bn_state[lname], cfg, train, out_t=out_t,
            name=lname, plan=plan, v0=mem.get(lname), affine=aff.get(lname),
            taps=taps, pool=pool,
        )
        return s

    pd = cfg.pool_drive and snn  # the pooled layers pool their drive inside
    x_t = images.float()[None]  # the encode layer sees the raw image once
    s_t = cba(x_t, "encode", out_t=full_t if cfg.rate_encode and snn else None, pool=True)
    aux["spikes"]["encode"] = s_t
    if not pd:
        s_t = _pool_t(s_t, cfg)

    out_t = full_t if cfg.mixed_time else s_t.shape[0]
    if not cfg.mixed_time and snn:
        s_t = s_t.expand((full_t,) + tuple(s_t.shape[1:]))
        out_t = full_t
    s_t = cba(s_t, "conv_block", out_t=out_t, pool=True)
    aux["spikes"]["conv_block"] = s_t
    if not pd:
        s_t = _pool_t(s_t, cfg)

    for i in range(len(cfg.stage_channels)):
        name = f"stage{i}"
        pooled = i < cfg.pooled_stages - 1
        short = cba(s_t, f"{name}/shortcut")
        m = cba(s_t, f"{name}/main_in")
        m = cba(m, f"{name}/main_a")
        m = cba(m, f"{name}/main_b")
        s_t = cba(torch.cat([m, short], dim=-1), f"{name}/agg", pool=pooled)
        aux["spikes"][name] = s_t
        if pooled and not pd:
            s_t = _pool_t(s_t, cfg)

    y_t = _conv_t(s_t, params["head"], cfg, name="head", plan=plan)
    if taps is not None:
        taps["head"] = y_t
    if snn:
        head, new_mem["head"] = lifm.membrane_readout(
            y_t, leak=cfg.leak, v0=mem.get("head"), return_final=True
        )
        if cfg.head_readout == "final":
            head = new_mem["head"] / y_t.shape[0]
    else:
        head = y_t.mean(dim=0)
    n, gh, gw, _ = head.shape
    head = head.reshape(n, gh, gw, cfg.num_anchors, 5 + cfg.num_classes)
    return head, new_state, aux


# ------------------------------------------------------- layer accounting --


# Per-layer post-pruning densities of the 3×3 kernels, shaped like paper
# Fig 3: a single global magnitude threshold keeps far more weights in the
# small early layers than in the large late ones (the JAX package's
# calibration: Table I's −70% params and §IV-E's −47.3% ops jointly).
FIG3_DENSITY_PROFILE = {
    "encode": 0.70,
    "conv_block": 0.70,
    "stage0": 0.70,
    "stage1": 0.50,
    "stage2": 0.50,
    "stage3": 0.12,
    "stage4": 0.12,
}


def layer_specs(
    cfg: SNNDetConfig, *, pruned_density: float | dict | None = None
) -> list[en.ConvLayerSpec]:
    """The network as a ConvLayerSpec list for the §IV-D/E energy model.

    density applies to 3×3 kernels only (paper prunes only those at 80%).
    ``pruned_density``: None → Fig 3 profile; float → uniform; dict →
    per-group override. Time steps follow the (1, full_t) mixed schedule.
    """
    H, W = cfg.input_hw
    t = cfg.full_t
    if pruned_density is None:
        profile = FIG3_DENSITY_PROFILE
    elif isinstance(pruned_density, dict):
        profile = pruned_density
    else:
        profile = {k: pruned_density for k in FIG3_DENSITY_PROFILE}

    specs = [
        en.ConvLayerSpec(
            "encode", H, W, 3, cfg.stem_channels, 3, 1, 1, bits_in=8, density=profile["encode"]
        )
    ]
    h, w = H // 2, W // 2
    specs.append(
        en.ConvLayerSpec("conv_block", h, w, cfg.stem_channels, cfg.conv_block_channels, 3,
                         1, t, density=profile["conv_block"])
    )
    h, w = h // 2, w // 2
    for i, (cin, cout) in enumerate(cfg.stage_channels):
        half = cout // 2
        d3 = profile[f"stage{i}"]
        specs += [
            en.ConvLayerSpec(f"stage{i}/shortcut", h, w, cin, half, 1, t, t),
            en.ConvLayerSpec(f"stage{i}/main_in", h, w, cin, cout, 1, t, t),
            en.ConvLayerSpec(f"stage{i}/main_a", h, w, cout, cout, 3, t, t, density=d3),
            en.ConvLayerSpec(f"stage{i}/main_b", h, w, cout, cout, 3, t, t, density=d3),
            en.ConvLayerSpec(f"stage{i}/agg", h, w, cout + half, cout, 1, t, t),
        ]
        if i < cfg.pooled_stages - 1:
            h, w = h // 2, w // 2
    gh, gw = cfg.grid_hw
    specs.append(
        en.ConvLayerSpec(
            "head", gh, gw, cfg.stage_channels[-1][1], cfg.head_channels, 1, t, t, bits_out=8
        )
    )
    return specs


# ------------------------------------------------------------- YOLOv2 head -


def decode_head(head, anchors, *, threshold=None):
    """YOLOv2 box decode. head: (N, gh, gw, A, 5+C) raw → (boxes xywh in
    [0, 1], objectness, class probabilities). With ``threshold``,
    objectness below it is zeroed (the validity mask downstream)."""
    txy = torch.sigmoid(head[..., 0:2])
    twh = head[..., 2:4]
    obj = torch.sigmoid(head[..., 4])
    if threshold is not None:
        obj = torch.where(obj >= threshold, obj, torch.zeros_like(obj))
    cls = torch.softmax(head[..., 5:], dim=-1)
    n, gh, gw, a, _ = head.shape
    gy, gx = torch.meshgrid(
        torch.arange(gh, device=head.device), torch.arange(gw, device=head.device),
        indexing="ij",
    )
    cx = (gx[None, :, :, None] + txy[..., 0]) / gw
    cy = (gy[None, :, :, None] + txy[..., 1]) / gh
    anc = torch.as_tensor(anchors, dtype=head.dtype, device=head.device)
    bw = anc[:, 0] * torch.exp(twh[..., 0]) / gw
    bh = anc[:, 1] * torch.exp(twh[..., 1]) / gh
    boxes = torch.stack([cx, cy, bw, bh], dim=-1)
    return boxes, obj, cls


DEFAULT_ANCHORS = ((1.0, 1.0), (2.0, 2.0), (4.0, 2.5), (2.5, 4.0), (6.0, 6.0))


def compile_detector(cfg: SNNDetConfig, params, bn_state=None, **kwargs):
    """Compile-once entry point: a
    :class:`repro_torch.serve.detector.CompiledDetector` owning the plan,
    the per-layer affine bundles and the postprocess::

        det = compile_detector(cfg, params, bn)   # on the card by default
        dets = det(frames)
        sess = det.new_session(batch=2)

    ``**kwargs`` (device, anchors, thresholds, affines, tile_cache) go to
    the ``CompiledDetector`` constructor."""
    from repro_torch.serve.detector import CompiledDetector  # import cycle

    return CompiledDetector(cfg, params, bn_state, **kwargs)


def yolo_loss(head, targets, anchors=DEFAULT_ANCHORS, *, l_coord=5.0, l_noobj=0.5):
    """YOLOv2-style loss. targets: (N, gh, gw, A, 5+C) with [tx, ty, tw, th,
    obj, one-hot classes]; obj ∈ {0, 1} marks the assigned anchors. tx/ty
    are within-cell offsets, tw/th log-scale against the assigned anchor —
    :func:`decode_head`'s inverse domain."""
    obj_mask = targets[..., 4]
    noobj_mask = 1.0 - obj_mask
    pxy = torch.sigmoid(head[..., 0:2])
    pwh = head[..., 2:4]
    pobj = torch.sigmoid(head[..., 4])
    plog = torch.log_softmax(head[..., 5:], dim=-1)
    coord = torch.sum(obj_mask[..., None] * ((pxy - targets[..., 0:2]) ** 2
                                             + (pwh - targets[..., 2:4]) ** 2))
    obj_l = torch.sum(obj_mask * (pobj - 1.0) ** 2)
    noobj_l = torch.sum(noobj_mask * pobj**2)
    cls_l = -torch.sum(obj_mask[..., None] * targets[..., 5:] * plog)
    return (l_coord * coord + obj_l + l_noobj * noobj_l + cls_l) / head.shape[0]
