"""Plain PyTorch reference of the spiking detector, written from the model's
equations (paper TCSI 2022 §II) and independent of the program under test.

Every conv is an integer accumulation: the int8 weights (per-tensor FXP,
round half to even, clamped to [-2^(b-1), 2^(b-1) - 1]) times binary spikes
or u8 pixels, summed as integer-valued float32 one tap at a time, each tap a
matmul over the channels. Every partial sum stays below 2^24, so the sums
are exact in any order. Then, per output channel and in this order, each
product rounded on its own (the model's published arithmetic):

    y = acc * s                (s = FXP scale, / 255 for the 8-bit encode)
    x = (y - mean) * rsqrt(var + 1e-5)
    d = ((threshold * x) * gamma) + beta        (tdBN at inference)
    v = v * leak + d;  spike = v >= threshold;  hard reset v = 0,
                                                 soft reset v -= threshold

The network is the CSP backbone (encode 3x3 · pool · conv_block 3x3 · pool
· 5 stages of shortcut 1x1, main 1x1 -> 3x3 -> 3x3, agg 1x1 over the
concat, pooled after the first ``pooled_stages - 1``) and a 1x1 YOLOv2 head
read out as the no-reset membrane (mean over T, or final / T). 3x3 convs
are block convolutions: each ``block_hw`` block replicate-padded at its own
border. Mixed time steps: the encode fires once (T = 1) unless it is rate
coded, and conv_block turns one step into ``full_t``.

``bits`` and ``fdtype`` lower the precision for the control: int4 weights
and bfloat16 arithmetic in place of int8 and float32.

Tensors are NHWC, time leading: (T, N, H, W, C). Nothing here imports the
program.
"""
from __future__ import annotations

import numpy as np
import torch

EPS = 1e-5
ROW_BYTES = 1 << 30  # a conv is computed in chunks of about this many input bytes


def layer_shapes(m: dict) -> dict:
    """{layer: (kh, kw, cin, cout)} in forward order, the head last."""
    out = {"encode": (3, 3, 3, m["stem_channels"]),
           "conv_block": (3, 3, m["stem_channels"], m["conv_block_channels"])}
    for i, (cin, cout) in enumerate(m["stage_channels"]):
        half = cout // 2
        out[f"stage{i}/shortcut"] = (1, 1, cin, half)
        out[f"stage{i}/main_in"] = (1, 1, cin, cout)
        out[f"stage{i}/main_a"] = (3, 3, cout, cout)
        out[f"stage{i}/main_b"] = (3, 3, cout, cout)
        out[f"stage{i}/agg"] = (1, 1, cout + half, cout)
    out["head"] = (1, 1, m["stage_channels"][-1][1],
                   m["num_anchors"] * (5 + m["num_classes"]))
    return out


def layer_geometry(m: dict) -> dict:
    """{layer: (H, W, t_in, t_out)} of each conv's input map and steps."""
    h, w = m["input_hw"]
    t = m["full_t"]
    enc_out = t if m.get("rate_encode") else 1
    geo = {"encode": (h, w, 1, enc_out),
           "conv_block": (h // 2, w // 2, enc_out, t if m["mixed_time"] else enc_out)}
    sh, sw = h // 4, w // 4
    for i in range(len(m["stage_channels"])):
        for part in ("shortcut", "main_in", "main_a", "main_b", "agg"):
            geo[f"stage{i}/{part}"] = (sh, sw, t, t)
        if i < m["pooled_stages"] - 1:
            sh, sw = sh // 2, sw // 2
    geo["head"] = (sh, sw, t, t)
    return geo


def quantize(w: torch.Tensor, bits: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric FXP: (integer-valued float q, f32 scale)."""
    qmax = 2 ** (bits - 1) - 1
    amax = w.abs().amax()
    scale = torch.where(amax > 0, amax, torch.full_like(amax, float(qmax))) / qmax
    return torch.clamp(torch.round(w / scale), -qmax - 1, qmax), scale


def _block_index(n: int, block: int, shift: int, device) -> torch.Tensor:
    """For each position, its neighbour at ``shift``, clamped into its block."""
    i = torch.arange(n, device=device)
    start = (i // block) * block
    return torch.clamp(i + shift, min=start, max=start + block - 1)


def conv_int(x: torch.Tensor, q: torch.Tensor, block_hw) -> torch.Tensor:
    """Integer block conv: x (B, H, W, C) integer-valued, q (kh, kw, C, K)
    integer-valued, both float32 -> (B, H, W, K) float32, exact."""
    kh, kw, c, k = q.shape
    b, h, w, _ = x.shape
    out = torch.empty((b, h, w, k), dtype=torch.float32, device=x.device)
    chunk = max(1, ROW_BYTES // max(1, h * w * max(c, k) * 4))
    if kh == 1 and kw == 1:
        for i in range(0, b, chunk):
            xs = x[i:i + chunk]
            out[i:i + chunk] = (xs.reshape(-1, c) @ q[0, 0]).reshape(xs.shape[0], h, w, k)
        return out
    bh, bw = block_hw
    if h % bh or w % bw:
        raise ValueError(f"map ({h}, {w}) does not divide into blocks ({bh}, {bw})")
    rows = [_block_index(h, bh, dy - (kh - 1) // 2, x.device) for dy in range(kh)]
    cols = [_block_index(w, bw, dx - (kw - 1) // 2, x.device) for dx in range(kw)]
    live = [(dy, dx) for dy in range(kh) for dx in range(kw) if bool(q[dy, dx].any())]
    for i in range(0, b, chunk):
        xs = x[i:i + chunk]
        acc = torch.zeros((xs.shape[0] * h * w, k), dtype=torch.float32, device=x.device)
        for dy, dx in live:
            win = xs.index_select(1, rows[dy]).index_select(2, cols[dx])
            acc += win.reshape(-1, c) @ q[dy, dx]
        out[i:i + chunk] = acc.reshape(xs.shape[0], h, w, k)
    return out


def _pool_or(s: torch.Tensor) -> torch.Tensor:
    """2x2 OR (max) pool of (..., H, W, C), VALID."""
    *lead, h, w, c = s.shape
    s = s[..., : h - h % 2, : w - w % 2, :]
    return s.reshape(*lead, h // 2, 2, w // 2, 2, c).amax(dim=(-4, -2))


def _pool_rate(s_t: torch.Tensor) -> torch.Tensor:
    """2x2 rate-gated pool over time (Rueckauer et al. 2017): at each step a
    window passes the current spike of its input with the most spikes so
    far (key 2 * count + spike; ties go to a spiking input)."""
    count = torch.zeros_like(s_t[0], dtype=torch.float32)
    out = []
    for s in s_t:
        s = s.float()
        count = count + s
        out.append(torch.remainder(_pool_or(count * 2.0 + s), 2.0).to(torch.uint8))
    return torch.stack(out)


class Net:
    """The spiking detector of one configuration, at one precision.

    ``m``: the configuration's model keys; ``weights``: {layer: {"w",
    "gamma", "beta", "mean", "var"}} float32 tensors on the device (the head
    has only "w"). The int8 (or int4) weights and every per-channel constant
    are worked out here."""

    def __init__(self, m: dict, weights: dict, *, bits: int = 8,
                 fdtype: torch.dtype = torch.float32):
        self.m = m
        self.fdtype = fdtype
        self.shapes = layer_shapes(m)
        self.layers = {}
        for name in self.shapes:
            p = weights[name]
            q, scale = quantize(p["w"].float(), bits)
            if name == "encode":
                scale = scale / 255.0
            entry = {"q": q.float(), "scale": scale.to(fdtype)}
            if name != "head":
                entry.update(mean=p["mean"].to(fdtype),
                             rinv=torch.rsqrt(p["var"] + EPS).to(fdtype),
                             gamma=p["gamma"].to(fdtype), beta=p["beta"].to(fdtype))
            self.layers[name] = entry

    def nnz(self) -> dict:
        """{layer: nonzero int weights} (the operations' count)."""
        return {n: int(torch.count_nonzero(e["q"])) for n, e in self.layers.items()}

    def zero_state(self, n: int, device) -> dict:
        """Cold membranes of ``n`` streams: {layer: (N, H, W, C)}."""
        geo = layer_geometry(self.m)
        return {name: torch.zeros((n, geo[name][0], geo[name][1], self.shapes[name][3]),
                                  dtype=self.fdtype, device=device)
                for name in self.shapes}

    def _layer(self, name: str, x_t: torch.Tensor, t_out: int, v: torch.Tensor):
        """conv -> rescale -> tdBN -> LIF; returns (spikes u8, final v)."""
        e, m = self.layers[name], self.m
        t_in, n = x_t.shape[:2]
        acc = conv_int(x_t.reshape(t_in * n, *x_t.shape[2:]).float(), e["q"], m["block_hw"])
        acc = acc.reshape(t_in, n, *acc.shape[1:])
        leak, thr = m["leak"], m["threshold"]

        def drive(a):
            y = a.to(self.fdtype) * e["scale"]
            return ((thr * ((y - e["mean"]) * e["rinv"])) * e["gamma"]) + e["beta"]

        d = drive(acc[0]) if t_in == 1 else None
        spikes = []
        for t in range(t_out):
            v = v * leak + (d if t_in == 1 else drive(acc[t]))
            s = v >= thr
            if m["reset"] == "soft":
                v = torch.where(s, v - thr, v)
            else:
                v = torch.where(s, torch.zeros_like(v), v)
            spikes.append(s.to(torch.uint8))
        return torch.stack(spikes), v

    def _pool(self, s_t):
        if self.m.get("pool_mode") == "rate":
            return _pool_rate(s_t)
        return _pool_or(s_t)

    @torch.no_grad()
    def step(self, frames: torch.Tensor, state: dict) -> tuple[torch.Tensor, dict]:
        """One frame of N streams: frames (N, H, W, 3) in [0, 1] on the
        device, state {layer: membrane} -> (head (N, gh, gw, A, 5 + C),
        the new state)."""
        m, geo, new = self.m, layer_geometry(self.m), {}
        pix = torch.clamp(torch.round(frames.float() * 255.0), 0, 255)[None]
        s, new["encode"] = self._layer("encode", pix, geo["encode"][3], state["encode"])
        s = self._pool(s)
        s, new["conv_block"] = self._layer("conv_block", s, geo["conv_block"][3],
                                           state["conv_block"])
        s = self._pool(s)
        t = m["full_t"]
        for i in range(len(m["stage_channels"])):
            g = f"stage{i}"
            short, new[f"{g}/shortcut"] = self._layer(f"{g}/shortcut", s, t, state[f"{g}/shortcut"])
            a, new[f"{g}/main_in"] = self._layer(f"{g}/main_in", s, t, state[f"{g}/main_in"])
            a, new[f"{g}/main_a"] = self._layer(f"{g}/main_a", a, t, state[f"{g}/main_a"])
            a, new[f"{g}/main_b"] = self._layer(f"{g}/main_b", a, t, state[f"{g}/main_b"])
            s, new[f"{g}/agg"] = self._layer(f"{g}/agg", torch.cat([a, short], dim=-1), t,
                                             state[f"{g}/agg"])
            if i < m["pooled_stages"] - 1:
                s = self._pool(s)
        e = self.layers["head"]
        n = s.shape[1]
        acc = conv_int(s.reshape(t * n, *s.shape[2:]).float(), e["q"], m["block_hw"])
        y = acc.reshape(t, n, *acc.shape[1:]).to(self.fdtype) * e["scale"]
        v, total = state["head"], None
        for k in range(t):
            v = v * m["leak"] + y[k]
            total = v if total is None else total + v
        new["head"] = v
        head = (v if m["head_readout"] == "final" else total) / t
        gh, gw = head.shape[1:3]
        return head.reshape(n, gh, gw, m["num_anchors"], 5 + m["num_classes"]).float(), new


# ------------------------------------------------------------ postprocess --


def decode(head: torch.Tensor, anchors, score_threshold: float, dtype=torch.float32):
    """YOLOv2 decode and best-class scores of one batch of heads.
    Returns (boxes (N, M, 4) cx cy w h, scores (N, M), classes (N, M))."""
    head = head.to(dtype)
    n, gh, gw, a, _ = head.shape
    txy = torch.sigmoid(head[..., 0:2])
    obj = torch.sigmoid(head[..., 4])
    obj = torch.where(obj >= score_threshold, obj, torch.zeros_like(obj))
    cls = torch.softmax(head[..., 5:], dim=-1)
    gy = torch.arange(gh, device=head.device)[None, :, None, None]
    gx = torch.arange(gw, device=head.device)[None, None, :, None]
    anc = torch.tensor(anchors, dtype=dtype, device=head.device)
    cx = (gx + txy[..., 0]) / gw
    cy = (gy + txy[..., 1]) / gh
    bw = anc[:, 0] * torch.exp(head[..., 2]) / gw
    bh = anc[:, 1] * torch.exp(head[..., 3]) / gh
    boxes = torch.stack([cx, cy, bw, bh], dim=-1).reshape(n, -1, 4)
    score = obj * cls.amax(dim=-1)
    score = torch.where(score >= score_threshold, score, torch.zeros_like(score))
    return boxes, score.reshape(n, -1), torch.argmax(cls, dim=-1).reshape(n, -1)


def _iou(a, b):
    """IoU of one cx-cy-w-h box ``a`` against each row of ``b`` (numpy
    float32, each operation rounded on its own)."""
    two = np.float32(2)
    ax0, ay0, ax1, ay1 = a[0] - a[2] / two, a[1] - a[3] / two, a[0] + a[2] / two, a[1] + a[3] / two
    bx0, by0 = b[:, 0] - b[:, 2] / two, b[:, 1] - b[:, 3] / two
    bx1, by1 = b[:, 0] + b[:, 2] / two, b[:, 1] + b[:, 3] / two
    iw = np.maximum(np.minimum(ax1, bx1) - np.maximum(ax0, bx0), np.float32(0))
    ih = np.maximum(np.minimum(ay1, by1) - np.maximum(ay0, by0), np.float32(0))
    inter = iw * ih
    union = a[2] * a[3] + b[:, 2] * b[:, 3] - inter
    return inter / np.maximum(union, np.float32(1e-9))


def nms(boxes, scores, classes, *, iou_threshold: float, max_out: int):
    """Greedy class-aware NMS of one image (numpy): each round picks the
    live box of highest score (ties: the lowest index); a pick kills the
    boxes of its class at IoU >= the threshold. Scores <= 0 never live.
    Returns (indices, valid) of ``min(max_out, M)`` rounds, padded."""
    m = scores.shape[0]
    live = np.where(scores > 0, scores, -np.inf).astype(np.float32)
    idx = np.zeros(max_out, np.int64)
    ok = np.zeros(max_out, bool)
    for k in range(min(max_out, m)):
        i = int(np.argmax(live))
        if not live[i] > 0:
            break
        idx[k], ok[k] = i, True
        kill = (_iou(boxes[i], boxes) >= np.float32(iou_threshold)) & (classes == classes[i])
        live[kill] = -np.inf
    return idx, ok


def postprocess(head: torch.Tensor, anchors, *, score_threshold: float, iou_threshold: float,
                max_detections: int, dtype=torch.float32) -> list:
    """Per image: dict of boxes (K, 4), scores (K,), classes (K,) of the
    valid detections, in pick order (numpy float32 / int64)."""
    boxes, scores, classes = decode(head, anchors, score_threshold, dtype)
    boxes = boxes.float().cpu().numpy()
    scores = scores.float().cpu().numpy()
    classes = classes.cpu().numpy()
    out = []
    for b in range(boxes.shape[0]):
        idx, ok = nms(boxes[b], scores[b], classes[b], iou_threshold=iou_threshold,
                      max_out=max_detections)
        sel = idx[ok]
        out.append({"boxes": boxes[b][sel], "scores": scores[b][sel],
                    "classes": classes[b][sel].astype(np.int64)})
    return out
