"""The reference against the program on the CPU at the detector's smoke
size, the control (the reference at the next precision down) and the
timed path broken underneath: each has to come out as not correct."""
import numpy as np
import pytest
import torch

from bench import check, harness, limits
from conftest import ROOT, smoke

SEED = 2**31 + 11
CELLS = ("snn-det-ivs3cls.fleet64", "snn-det-converted-t128.images2")


def _run(cell, **kw):
    torch.manual_seed(0)
    return harness.run_cell(cell, SEED, 0.5, False, device="cpu", config_override=smoke,
                            **kw)[0]


def _spread(system, ref, config, sampled, dev, traffic):
    heads = [np.abs(h).max() for _, _, hs in sampled for h in hs]
    dets = [int(np.asarray(d.valid).sum()) for _, ds, _ in sampled for d in ds]
    return {"max_head": float(max(heads)), "detections": sum(dets), "frames": len(heads)}


@pytest.mark.parametrize("cell", CELLS)
def test_the_reference_equals_the_program_on_the_cpu(cell):
    res = _run(cell, after=_spread)
    assert res["correct"], res["checks"]
    # the CPU runs the program's plain versions: the same roundings, bit for bit
    assert {k: c["value"] for k, c in res["checks"].items()} == {"head_gap": 0.0, "det_gap": 0.0}
    spread = res["after"]
    assert spread["frames"] >= 2 and spread["max_head"] > 0 and spread["detections"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_comparison(cell):
    res = _run(cell, after=limits.control)
    limits_ = {k: c["limit"] for k, c in res["checks"].items()}
    failed = [k for k, v in res["after"].items() if v > limits_[k]]
    assert failed, (res["after"], limits_)


def _state_unchanged(det):
    step = det.masked_step

    def broken(frames, mem, active, cold=None):
        head, _, dets = step(frames, mem, active, cold)
        return head, mem, dets
    det.masked_step = broken


def _half_left_out(det):
    step = det.masked_step

    def broken(frames, mem, active, cold=None):
        head, new, dets = step(frames, mem, active, cold)
        half = head.shape[0] // 2 or 1
        head = head.clone()
        head[half:] = 0.0
        dets = type(dets)(*(f.clone() for f in dets))
        dets.valid[half:] = False
        return head, new, dets
    det.masked_step = broken


def _answer_altered(det):
    step = det.masked_step

    def broken(frames, mem, active, cold=None):
        head, new, dets = step(frames, mem, active, cold)
        head = head.clone()
        head[:, 0, 0, 0, 4] += 1.0
        return head, new, dets
    det.masked_step = broken


@pytest.mark.parametrize("cell,fault", [
    ("snn-det-ivs3cls.fleet64", _state_unchanged),
    ("snn-det-ivs3cls.fleet64", _half_left_out),
    ("snn-det-ivs3cls.fleet64", _answer_altered),
    ("snn-det-converted-t128.images2", _half_left_out),
    ("snn-det-converted-t128.images2", _answer_altered),
])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    res = _run(cell, fault=fault)
    assert not res["correct"], res["checks"]


def test_the_control_is_the_reference_at_lower_precision():
    from bench.families.snn_det import System

    config = smoke(harness.find_cell(harness.load_spec(ROOT), CELLS[0], ROOT)["config"])
    system = System(config, SEED, "cpu")
    full, ctrl = system.reference(), system.reference(bits=4, fdtype=torch.bfloat16)
    assert ctrl.layers["stage0/main_a"]["q"].abs().max() <= 8
    assert full.layers["stage0/main_a"]["q"].abs().max() == 127
    x = torch.rand(1, 24, 32, 3)
    h_full, _ = full.step(x, full.zero_state(1, "cpu"))
    h_ctrl, _ = ctrl.step(x, ctrl.zero_state(1, "cpu"))
    assert not torch.equal(h_full, h_ctrl)
    assert check.judge({"head_gap": 0.5}, {"head_gap": 0.1})["head_gap"]["value"] == 0.5
