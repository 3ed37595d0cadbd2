"""The port at the ANN→SNN conversion's operating point, against a live JAX
``pallas`` run on the same inputs.

``repro.convert.emit.target_config`` serves a converted detector with soft
reset, ``v_init`` = θ·frac, leak 1.0, rate-encoded input, the rate-gated
pool, the final-membrane head readout, T of 64–128 and optionally
``pool_drive``. Here the conformance config takes those settings at
``full_t=8`` (the fused kernel's T > 4 path), with ``pool_drive`` off (every
layer fused) and on (encode and conv_block pool their drive before the LIF,
so they run unfused: one gated one-to-all launch each).

Inputs are built by the JAX package (``golden.build_inputs``) under
``jax.threefry_partitionable(False)`` and cross as numpy arrays, the JAX
affine bundles included (torch's rsqrt rounds differently from XLA's,
ROADMAP queue 3, R3).

Tolerances: spikes, ``valid`` and ``classes`` equal; head, boxes, scores and
recorded drives within 1e-5. Membranes within 8 ulp of the layer's largest
|v|: with leak 1.0 a membrane integrates every drive of the 3 frames × 8
steps (|v| up to ~41 here), and XLA's CPU codegen contracts the JAX
kernel's mul+add into FMAs (ROADMAP queue 3, R4), so its drives differ from
the per-op rounded chain by up to 1 ulp and the membranes drift apart by up
to 1.05e-5 (5.5 ulp of a layer's largest |v|). No spike flips from it at
these inputs.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "conformance"))
import golden  # noqa: E402

from repro.core import plan as jplan  # noqa: E402
from repro.eval import harness as jharness  # noqa: E402
from repro.models import snn_yolo as jsy  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.eval import harness  # noqa: E402
from repro_torch.kernels import fused_pipeline as fp  # noqa: E402
from repro_torch.kernels import gated_one_to_all as g2a  # noqa: E402
from repro_torch.models import snn_yolo as sy  # noqa: E402

FLOAT_ATOL = 1e-5
MEM_ULPS = 8
FULL_T = 8
POOL_DRIVE = [False, True]
EXECUTORS = ["pallas", "gated"]


def converted_config(pool_drive: bool, conv_exec: str = "pallas"):
    """The conformance config at ``target_config``'s settings."""
    return dataclasses.replace(
        golden.conformance_config(), reset="soft", v_init=0.25, leak=1.0,
        rate_encode=True, pool_mode="rate", head_readout="final", full_t=FULL_T,
        pool_drive=pool_drive, conv_exec=conv_exec,
    )


def _port_config(jcfg, conv_exec):
    """Through the JSON sidecar round trip a JAX checkpoint takes."""
    return dataclasses.replace(sy.config_from_dict(jsy.config_to_dict(jcfg)),
                               conv_exec=conv_exec)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_inputs():
    with jax.threefry_partitionable(False):
        return golden.build_inputs()


def _jax_run(params, bn, frames, cfg, with_taps):
    det = jsy.compile_detector(cfg, params, bn)
    sess = det.new_session(batch=golden.BATCH)
    steps = [sess.step(frames[k]) for k in range(golden.N_FRAMES)]
    taps = {} if with_taps else None
    _, _, aux = jsy.forward(params, bn, frames[0], cfg, plan=det.plan, taps=taps)
    return {
        "affines": _np(jplan.precompute_affines(det.plan, params, bn, cfg)),
        "heads": [np.asarray(s.head) for s in steps],
        "dets": [_np(s.detections._asdict()) for s in steps],
        "state": _np(sess.state),
        "spikes": _np(aux["spikes"]),
        "taps": None if taps is None else _np(taps),
    }


@pytest.fixture(scope="module")
def jax_runs(jax_inputs):
    params, bn, frames = jax_inputs
    # the JAX taps= forward runs every layer unfused in interpret mode: take
    # it once, at pool_drive (the cheaper of the two)
    return {pd: _jax_run(params, bn, frames, converted_config(pd), with_taps=pd)
            for pd in POOL_DRIVE}


def _counting(monkeypatch):
    """Count the calls of each kernel wrapper (on the CPU a wrapper runs its
    plain version and bumps no launch count)."""
    calls = {"fused": 0, "gated": 0}
    real_fp, real_g = fp.fused_pipeline, g2a.gated_one_to_all

    def fused(*a, **k):
        calls["fused"] += 1
        return real_fp(*a, **k)

    def gated(*a, **k):
        calls["gated"] += 1
        return real_g(*a, **k)

    monkeypatch.setattr(fp, "fused_pipeline", fused)
    monkeypatch.setattr(g2a, "gated_one_to_all", gated)
    return calls


@pytest.fixture(scope="module")
def port_runs(jax_inputs, jax_runs):
    params, bn, frames = jax_inputs
    fr = np.array(frames)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        calls = _counting(mp)
        for pd in POOL_DRIVE:
            p, b, a = interop.params_from_numpy(_np(params), _np(bn), jax_runs[pd]["affines"],
                                                device="cpu")
            for ex in EXECUTORS:
                cfg = _port_config(converted_config(pd), ex)
                det = sy.compile_detector(cfg, p, b, device="cpu", affines=a)
                sess = det.new_session(batch=golden.BATCH)
                zero_shapes = {k: tuple(v.shape) for k, v in sess.state.items()}
                calls.update(fused=0, gated=0)
                steps = [sess.step(fr[k]) for k in range(golden.N_FRAMES)]
                per_frame = {k: v / golden.N_FRAMES for k, v in calls.items()}
                taps = {}
                calls.update(fused=0, gated=0)
                _, _, aux = sy.forward(det.params, det.bn_state, torch.from_numpy(fr[0]), cfg,
                                       plan=det.plan, affines=det._affines, taps=taps)
                out[pd, ex] = {
                    "heads": [s.head for s in steps],
                    "dets": [s.detections for s in steps],
                    "state": sess.state,
                    "zero_shapes": zero_shapes,
                    "calls_per_frame": per_frame,
                    "taps_calls": dict(calls),
                    "spikes": aux["spikes"],
                    "taps": taps,
                }
    return out


@pytest.mark.parametrize("ex", EXECUTORS)
@pytest.mark.parametrize("pd", POOL_DRIVE)
def test_detections_match_jax(port_runs, jax_runs, pd, ex):
    got, want = port_runs[pd, ex], jax_runs[pd]
    for k in range(golden.N_FRAMES):
        for f in ("valid", "classes"):
            np.testing.assert_array_equal(getattr(got["dets"][k], f).numpy(),
                                          want["dets"][k][f], err_msg=f"frame {k} {f}")
        for f in ("boxes", "scores"):
            np.testing.assert_allclose(getattr(got["dets"][k], f).numpy(), want["dets"][k][f],
                                       atol=FLOAT_ATOL, rtol=0, err_msg=f"frame {k} {f}")
        np.testing.assert_allclose(got["heads"][k].numpy(), want["heads"][k],
                                   atol=FLOAT_ATOL, rtol=0, err_msg=f"frame {k} head")
    assert want["dets"][0]["valid"].any(), "no detection survived: the check is vacuous"


@pytest.mark.parametrize("ex", EXECUTORS)
@pytest.mark.parametrize("pd", POOL_DRIVE)
def test_spikes_equal_jax(port_runs, jax_runs, pd, ex):
    got, want = port_runs[pd, ex]["spikes"], jax_runs[pd]["spikes"]
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(got[name].float().numpy(), want[name], err_msg=name)
    assert float(got["stage4"].float().mean()) > 0, "no spikes reach stage4"


@pytest.mark.parametrize("ex", EXECUTORS)
@pytest.mark.parametrize("pd", POOL_DRIVE)
def test_membranes_match_jax(port_runs, jax_runs, pd, ex):
    got, want = port_runs[pd, ex]["state"], jax_runs[pd]["state"]
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].numpy()
        assert g.shape == w.shape, name
        tol = MEM_ULPS * np.spacing(np.float32(max(1.0, np.abs(w).max())))
        assert np.abs(g - w).max() <= tol, (name, np.abs(g - w).max(), tol)


@pytest.mark.parametrize("pd", POOL_DRIVE)
def test_session_state_shapes_match_jax(port_runs, jax_runs, pd):
    """Under pool_drive the pooled layers' membranes are at half
    resolution; a fresh session's zero state has the JAX session's shapes."""
    want = {k: v.shape for k, v in jax_runs[pd]["state"].items()}
    for ex in EXECUTORS:
        assert port_runs[pd, ex]["zero_shapes"] == want
    if pd:
        assert want["encode"][1:3] == (12, 16)  # 24×32 input, pooled before the LIF


@pytest.mark.parametrize("pd", POOL_DRIVE)
def test_port_executors_bit_equal(port_runs, pd):
    a, b = port_runs[pd, "pallas"], port_runs[pd, "gated"]
    for k in range(golden.N_FRAMES):
        assert torch.equal(a["heads"][k], b["heads"][k])
    for name in a["state"]:
        assert torch.equal(a["state"][name].view(torch.int32), b["state"][name].view(torch.int32))
    for name in a["taps"]:
        assert torch.equal(a["taps"][name], b["taps"][name]), name


@pytest.mark.parametrize("pd", POOL_DRIVE)
def test_kernel_calls_per_frame(port_runs, pd):
    """27 fused layers; under pool_drive the pooled ones (encode and
    conv_block here, pooled_stages=1) leave the fused kernel for one gated
    launch each. ``taps=`` keeps every layer unfused: encode and the 3×3
    layers (2 + 5×2) are one gated launch each, the 1×1 layers matmuls."""
    assert port_runs[pd, "pallas"]["calls_per_frame"] == (
        {"fused": 25, "gated": 2} if pd else {"fused": 27, "gated": 0})
    assert port_runs[pd, "pallas"]["taps_calls"] == {"fused": 0, "gated": 12}
    assert port_runs[pd, "gated"]["calls_per_frame"] == {"fused": 0, "gated": 0}


def test_fused_kernel_runs_t8(jax_inputs, jax_runs, monkeypatch):
    """rate_encode at full_t=8 goes through the fused kernel: encode with
    one drive for 8 steps, the rest 8 steps in and out (a T > 4 the port
    refused before)."""
    params, bn, frames = jax_inputs
    p, b, a = interop.params_from_numpy(_np(params), _np(bn), jax_runs[False]["affines"],
                                        device="cpu")
    det = sy.compile_detector(_port_config(converted_config(False), "pallas"), p, b,
                              device="cpu", affines=a)
    seen = []
    real = fp.fused_pipeline

    def spy(x, *args, **kwargs):
        seen.append((x.shape[0], kwargs["t_out"]))
        return real(x, *args, **kwargs)

    monkeypatch.setattr(fp, "fused_pipeline", spy)
    head = det.new_session(batch=golden.BATCH).step(np.array(frames[0])).head
    assert len(seen) == 27 and seen[0] == (1, FULL_T)
    assert set(seen[1:]) == {(FULL_T, FULL_T)}
    np.testing.assert_allclose(head.numpy(), jax_runs[False]["heads"][0], atol=FLOAT_ATOL,
                               rtol=0)


def test_taps_match_jax(port_runs, jax_runs):
    got, want = port_runs[True, "pallas"]["taps"], jax_runs[True]["taps"]
    assert set(got) == set(want) and "head" in got
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        np.testing.assert_allclose(got[name].numpy(), w, atol=FLOAT_ATOL, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("t", [1, 3, 8])
def test_rate_gated_pool_matches_jax(t):
    rng = np.random.default_rng(t)
    s = (rng.random((t, 2, 8, 12, 5)) < 0.4).astype(np.float32)
    want = np.asarray(jsy._rate_gated_pool_t(jnp.asarray(s)))
    got = sy._rate_gated_pool_t(torch.from_numpy(s))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(sy._rate_gated_pool_t(torch.from_numpy(s).to(torch.uint8)),
                       got.to(torch.uint8))


def test_checkpoint_restored_from_jax_serves_alike(jax_inputs, tmp_path):
    """A detector checkpoint written by the JAX package, restored by the
    port (numpy only) and served, gives the detections of the JAX restore."""
    params, bn, frames = jax_inputs
    cfg = converted_config(True)
    jharness.save_detector_checkpoint(str(tmp_path), 7, params, bn, cfg)
    jcfg, jp, jbn, jstep = jharness.restore_detector_checkpoint(str(tmp_path))
    want_dets, want_head = jsy.compile_detector(jcfg, jp, jbn).detect(frames[0])
    rcfg, p, b, step = harness.restore_detector_checkpoint(str(tmp_path), device="cpu")
    assert step == jstep == 7 and rcfg == _port_config(cfg, cfg.conv_exec)
    for name in params:
        for k, v in params[name].items():
            np.testing.assert_array_equal(p[name][k].numpy(), np.asarray(v))
    det = sy.compile_detector(rcfg, p, b, device="cpu")
    dets, head = det.detect(np.array(frames[0]))
    for f in ("valid", "classes"):
        np.testing.assert_array_equal(getattr(dets, f).numpy(), np.asarray(getattr(want_dets, f)))
    np.testing.assert_allclose(head.numpy(), np.asarray(want_head), atol=FLOAT_ATOL, rtol=0)
