"""The port's serving slice end to end at the conformance config, against
the checked-in golden (tests/conformance/fixtures/golden_conformance.npz)
and a live JAX ``pallas`` run on the same inputs.

Inputs are built by the JAX package (``golden.build_inputs``) under
``jax.threefry_partitionable(False)`` — the stream the golden was written
with — and cross as numpy arrays, affine bundles included: torch's rsqrt
rounds differently from XLA's, and a recomputed rsqrt(var+eps) would flip
the odd spike sitting at threshold."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "conformance"))
import golden  # noqa: E402

from repro.core import plan as jplan  # noqa: E402
from repro.core import pruning as jpruning  # noqa: E402
from repro.models import snn_yolo as jsy  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.kernels import fused_pipeline as fp  # noqa: E402
from repro_torch.models import snn_yolo as sy  # noqa: E402
from repro_torch.serve import detector as sd  # noqa: E402

FLOAT_ATOL = 1e-5
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def _port_config(conv_exec="pallas"):
    """The conformance config, through the JSON sidecar round trip a JAX
    checkpoint takes into the port."""
    d = jsy.config_to_dict(golden.conformance_config())
    return dataclasses.replace(sy.config_from_dict(d), conv_exec=conv_exec)


@pytest.fixture(scope="module")
def jax_inputs():
    with jax.threefry_partitionable(False):
        return golden.build_inputs()


@pytest.fixture(scope="module")
def port_inputs(jax_inputs):
    params, bn, frames = jax_inputs
    cfg = golden.conformance_config()
    jcfg = dataclasses.replace(cfg, conv_exec="pallas")
    affines = jplan.precompute_affines(jplan.build_plan(params, jcfg), params, bn, jcfg)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    p, b, a = interop.params_from_numpy(
        to_np(params), to_np(bn), to_np(affines), device="cpu"
    )
    return p, b, a, np.array(frames)  # a writable copy for torch


def _run(det, frames):
    """The port's side of ``golden.run_executor``."""
    dets, head = det.detect(frames[0])
    out = {"head": head, "boxes": dets.boxes, "scores": dets.scores,
           "classes": dets.classes, "valid": dets.valid}
    sess = det.new_session(batch=golden.BATCH)
    for k in range(golden.N_FRAMES):
        step = sess.step(frames[k])
        out[f"stream_head_{k}"] = step.head
        out[f"stream_valid_{k}"] = step.detections.valid
    for name, v in sess.state.items():
        out[f"mem/{name}"] = v
    return {k: v.numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def port_result(port_inputs):
    p, b, a, frames = port_inputs
    det = sy.compile_detector(_port_config(), p, b, device="cpu", affines=a)
    return _run(det, frames)


@pytest.fixture(scope="module")
def references(jax_inputs):
    params, bn, frames = jax_inputs
    return {
        "golden": golden.load_golden(),
        "live-jax-pallas": golden.run_executor("pallas", params, bn, frames),
    }


@pytest.mark.parametrize("ref", ["golden", "live-jax-pallas"])
def test_detections_structure_equal(port_result, references, ref):
    want = references[ref]
    keys = ["valid", "classes"] + [f"stream_valid_{k}" for k in range(golden.N_FRAMES)]
    for k in keys:
        np.testing.assert_array_equal(port_result[k], want[k], err_msg=k)
    assert port_result["valid"].any(), "no detection survived: the check is vacuous"


@pytest.mark.parametrize("ref", ["golden", "live-jax-pallas"])
def test_floats_within_tolerance(port_result, references, ref):
    want = references[ref]
    floats = [k for k in want if k != "frames" and want[k].dtype.kind == "f"]
    assert {f"mem/{n}" for n in sy.layer_shapes(_port_config())} <= set(floats)
    for k in floats:
        assert k in port_result, f"missing surface {k!r}"
        np.testing.assert_allclose(
            port_result[k], want[k], atol=FLOAT_ATOL, rtol=0, err_msg=k
        )


def test_one_kernel_call_per_fused_layer(port_inputs, monkeypatch):
    """27 fused layers at the full topology (here: 2 + 5×5 at smoke
    widths), one fused-pipeline call each per frame; the head is the only
    conv outside the kernel."""
    p, b, a, frames = port_inputs
    det = sy.compile_detector(_port_config(), p, b, device="cpu", affines=a)
    calls = []
    real = fp.fused_pipeline

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(fp, "fused_pipeline", counting)
    det.detect(frames[0])
    assert len(calls) == len([n for n in det.plan.layers if n != "head"]) == 27


def test_kernel_executor_equals_dense_executor(port_inputs):
    """On one device with one rsqrt helper, the kernel executor's chain and
    the dense oracle's unfused conv → tdBN → LIF agree bit for bit."""
    p, b, _, frames = port_inputs
    heads = {}
    for ex in ("dense", "pallas"):
        det = sy.compile_detector(_port_config(ex), p, b, device="cpu")
        sess = det.new_session(batch=golden.BATCH)
        for k in range(golden.N_FRAMES):
            heads[ex] = sess.step(frames[k]).head
    assert torch.equal(heads["dense"], heads["pallas"])


def test_calibration_tracks_jax(jax_inputs):
    """Train-mode tdBN on the dense fake-quant path moves the running
    statistics as the JAX package does, to float tolerance."""
    frames = jax_inputs[2]
    with jax.threefry_partitionable(False):
        fresh_p, fresh_bn = jsy.init_params(
            jax.random.PRNGKey(golden.SEED), golden.conformance_config()
        )
    fresh_p = jpruning.prune_tree(fresh_p, golden.PRUNE_RATE)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    p, b, _ = interop.params_from_numpy(to_np(fresh_p), to_np(fresh_bn), device="cpu")
    got = sy.calibrate_bn_state(p, b, torch.from_numpy(np.array(frames[0])),
                                _port_config("dense"), iters=3)
    want = jsy.calibrate_bn_state(fresh_p, fresh_bn, frames[0], golden.conformance_config(),
                                  iters=3)
    for name in want:
        for k in ("mean", "var"):
            np.testing.assert_allclose(
                got[name][k].numpy(), np.asarray(want[name][k]), rtol=1e-3, atol=1e-4,
                err_msg=f"{name}/{k}",
            )


def test_stale_plan_refused(port_inputs):
    p, b, a, frames = port_inputs
    p = {n: {k: v.clone() for k, v in d.items()} for n, d in p.items()}
    det = sy.compile_detector(_port_config(), p, b, device="cpu", affines=a)
    det.detect(frames[0])
    det.params["stage0/main_a"]["w"].mul_(2.0)  # an in-place edit
    with pytest.raises(sd.StalePlanError):
        det.detect(frames[0])


def test_session_reset_one_stream(port_inputs):
    p, b, a, frames = port_inputs
    det = sy.compile_detector(_port_config(), p, b, device="cpu", affines=a)
    sess = det.new_session(batch=2)
    sess.step(frames[0])
    sess.reset(1)
    assert all(float(v[1].abs().max()) == 0.0 for v in sess.state.values())
    assert any(float(v[0].abs().max()) > 0.0 for v in sess.state.values())
    with pytest.raises(IndexError):
        sess.reset(2)


@pytest.mark.parametrize("mode", ["ann", "qnn", "bnn"])
def test_unported_paths_raise(port_inputs, mode):
    """The ann/qnn/bnn modes run on the dense executor; the compressed
    executors take binary spikes only and refuse them with the JAX
    package's ValueError."""
    p, b, a, frames = port_inputs
    cfg = dataclasses.replace(_port_config(), mode=mode)
    det = sy.compile_detector(cfg, p, b, device="cpu")
    with pytest.raises(ValueError, match="requires mode='snn'"):
        det.detect(frames[0])
    with pytest.raises(ValueError, match="requires mode='snn'"):
        jsy.forward({}, {}, frames[0], cfg, plan=object())
    dense = sy.compile_detector(dataclasses.replace(cfg, conv_exec="dense"), p, b,
                                device="cpu")
    _, head = dense.detect(frames[0])
    assert head.shape[1:] == (*cfg.grid_hw, cfg.num_anchors, 5 + cfg.num_classes)
    assert torch.isfinite(head).all()


def test_unknown_executor_refused(port_inputs):
    p, b, _, _ = port_inputs
    with pytest.raises(ValueError, match="registered"):
        sy.compile_detector(_port_config("systolic"), p, b, device="cpu")


def _python(code: str) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": SRC, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)


def test_import_leaves_jax_out():
    r = _python(
        "import sys, repro_torch, repro_torch.serve.detector, repro_torch.interop, "
        "repro_torch.configs.snn_det, repro_torch.core.bitserial, repro_torch.core.bitmask, "
        "repro_torch.core.spike_conv, repro_torch.kernels.gated_one_to_all, "
        "repro_torch.train.checkpoint, repro_torch.eval.harness, repro_torch.core.energy, "
        "repro_torch.kernels.ref, repro_torch.kernels.spike_lif, "
        "repro_torch.kernels.bitmask_matmul, repro_torch.benchmarks.kernel_bench, "
        "repro_torch.benchmarks.e2e_detector, repro_torch.benchmarks.kernel_phases, "
        "repro_torch.serve.engine, repro_torch.benchmarks.serve_bench, "
        "repro_torch.launch.serve, repro_torch.tree, repro_torch.train.optimizer, "
        "repro_torch.train.ft, repro_torch.data.synthetic_detection, "
        "repro_torch.data.detection_datasets, repro_torch.eval.detection_map, "
        "repro_torch.launch.train_detector, repro_torch.core.quant, repro_torch.core.miout, "
        "repro_torch.eval.sharded, repro_torch.benchmarks.eval_map, "
        "repro_torch.benchmarks.table1_ablation, repro_torch.benchmarks.table2_models, "
        "repro_torch.benchmarks.table3_hw, repro_torch.benchmarks.fig3_density, "
        "repro_torch.benchmarks.fig5_miout, repro_torch.benchmarks.fig6_parallelism, "
        "repro_torch.benchmarks.fig15_mixed_t, repro_torch.benchmarks.fig17_dram, "
        "repro_torch.benchmarks.run\n"
        "from repro_torch.core.quant import int8_conv_accumulate, acc_range_ok, "
        "conv_acc_worst_case, ACC_BITS\n"
        "from repro_torch.core.miout import miout, choose_schedule, schedule_ops, "
        "repeat_conv_for_timesteps\n"
        "from repro_torch.eval.sharded import reports_identical\n"
        "from repro_torch.eval.harness import accumulator_report, EvalReport, run_pipeline\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.')]\n"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    assert r.returncode == 0, r.stdout + r.stderr


def test_default_device_without_gpu_raises():
    r = _python(
        "from repro_torch.configs.snn_det import CONFIG, smoke_config\n"
        "from repro_torch.models import snn_yolo as sy\n"
        "cfg = smoke_config(CONFIG)\n"
        "p, b = sy.init_params(cfg, device='cpu')\n"
        "try:\n"
        "    sy.compile_detector(cfg, p, b)\n"
        "except RuntimeError as e:\n"
        "    print('raised', e)\n"
        "else:\n"
        "    raise SystemExit('compiled without a card')\n"
    )
    assert r.returncode == 0 and "no CUDA device" in r.stdout, r.stdout + r.stderr
