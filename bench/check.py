"""The comparison that decides ``correct``.

For a sample of the requests served in the window, the reference runs
each request's frames from its first, carrying its own membranes (cold at
the request's start, as the engine blanks a joining stream), and two
numbers are read over every frame the program delivered:

* ``head_gap``: the widest gap between the program's raw head and the
  reference's, over the reference's largest |head| of that frame. The head
  carries all 28 convs and the membranes carried from the request's
  earlier frames.
* ``det_gap``: the widest gap between the program's detections and the
  reference's postprocess of the program's own head (boxes and scores);
  a different number of detections, or another class, reads 1.

Each has its limit in the configuration's file (``limits``); PERF.md gives
the readings each was set from.
"""
from __future__ import annotations

import numpy as np
import torch

from bench.reference import snn_ref

MISMATCH = 1.0  # det_gap of a frame whose detections differ in count or class


def _field(d, name):
    return d[name] if isinstance(d, dict) else getattr(d, name)


def _det_gap(prog, ref: dict) -> float:
    valid = np.asarray(_field(prog, "valid"), bool)
    n = int(valid.sum())
    if n != len(ref["scores"]) or not valid[:n].all():
        return MISMATCH
    if n == 0:
        return 0.0
    if not np.array_equal(np.asarray(_field(prog, "classes"))[:n].astype(np.int64),
                          ref["classes"]):
        return MISMATCH
    return max(_gap(np.asarray(_field(prog, "boxes"))[:n], ref["boxes"]),
               _gap(np.asarray(_field(prog, "scores"))[:n], ref["scores"]))


def _gap(a, b) -> float:
    """The widest |a - b|; equal entries (infinities too) read 0."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.where(a == b, 0.0, np.abs(a - b))
    return float(np.nan_to_num(d, nan=np.inf).max()) if d.size else 0.0


def reference_heads(net: snn_ref.Net, requests: list, device, *, batch: int):
    """Each request's heads by the reference: ``requests`` are (frames,
    number of frames to run); yields (request index, frame index, head)."""
    for g in range(0, len(requests), batch):
        group = requests[g:g + batch]
        state = net.zero_state(len(group), device)
        for k in range(max(n for _, n in group)):
            x = np.stack([f[min(k, n - 1)] for f, n in group])
            head, state = net.step(torch.from_numpy(x).to(device), state)
            head = head.cpu().numpy()
            for b, (_, n) in enumerate(group):
                if k < n:
                    yield g + b, k, head[b]


def compare(net: snn_ref.Net, config: dict, outputs: list, device, *, batch: int) -> dict:
    """``outputs``: per sampled request (frames, detections per delivered
    frame, raw heads per delivered frame). Returns the readings."""
    s = config["serve"]
    head_gap = det_gap = 0.0
    reqs = [(frames, len(heads)) for frames, _, heads in outputs]
    for r, k, ref_head in reference_heads(net, reqs, device, batch=batch):
        _, dets, heads = outputs[r]
        prog = np.asarray(heads[k], np.float64)
        scale = max(float(np.abs(ref_head).max()), 1e-30)
        head_gap = max(head_gap, _gap(prog, ref_head) / scale)
        ref = snn_ref.postprocess(torch.from_numpy(np.asarray(heads[k])[None]).to(device),
                                  s["anchors"], score_threshold=s["score_threshold"],
                                  iou_threshold=s["iou_threshold"],
                                  max_detections=s["max_detections"])[0]
        det_gap = max(det_gap, _det_gap(dets[k], ref))
    return {"head_gap": head_gap, "det_gap": det_gap}


def judge(readings: dict, limits: dict) -> dict:
    return {k: {"value": readings[k], "limit": limits[k]} for k in readings}


def control_outputs(ctrl: snn_ref.Net, config: dict, outputs: list, device, *, batch: int,
                    dtype=torch.bfloat16) -> list:
    """The control in the program's place: its heads and its detections
    (postprocessed in ``dtype``) for the same requests and frames."""
    s = config["serve"]
    max_out = s["max_detections"]
    reqs = [(frames, len(heads)) for frames, _, heads in outputs]
    out = [(frames, [None] * n, [None] * n) for frames, n in reqs]
    for r, k, head in reference_heads(ctrl, reqs, device, batch=batch):
        d = snn_ref.postprocess(torch.from_numpy(head[None]).to(device), s["anchors"],
                                score_threshold=s["score_threshold"],
                                iou_threshold=s["iou_threshold"], max_detections=max_out,
                                dtype=dtype)[0]
        n = len(d["scores"])
        valid = np.zeros(max_out, bool)
        valid[:n] = True
        boxes = np.zeros((max_out, 4), np.float32)
        boxes[:n] = d["boxes"]
        scores = np.zeros(max_out, np.float32)
        scores[:n] = d["scores"]
        classes = np.zeros(max_out, np.int64)
        classes[:n] = d["classes"]
        out[r][1][k] = {"boxes": boxes, "scores": scores, "classes": classes, "valid": valid}
        out[r][2][k] = head
    return out
