"""The paper's evaluation on the port against the JAX package, on the CPU:
the 16-bit accumulator helpers, mIoUT and the mixed schedule, the
train → prune → QAT → evaluate pipeline, ``eval_map``, the serve CLI's
``--eval-map`` gate, the Table I–III and Fig 3, 5, 6, 15, 17 benchmarks and
the benchmark runner.

Weights cross as numpy arrays (``interop.params_from_numpy``): the two
packages' seeded weights come from different generators, so a benchmark
whose numbers depend on the weights runs on the same arrays in both. Each
tolerance is stated beside its check."""
import dataclasses
import json
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import fig3_density as jfig3  # noqa: E402
from benchmarks import fig5_miout as jfig5  # noqa: E402
from benchmarks import fig6_parallelism as jfig6  # noqa: E402
from benchmarks import fig15_mixed_t as jfig15  # noqa: E402
from benchmarks import fig17_dram as jfig17  # noqa: E402
from benchmarks import table1_ablation as jt1  # noqa: E402
from benchmarks import table2_models as jt2  # noqa: E402
from benchmarks import table3_hw as jt3  # noqa: E402
from repro.core import miout as jmi  # noqa: E402
from repro.core import pruning as jpruning  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.eval import harness as jh  # noqa: E402
from repro.eval import sharded as jse  # noqa: E402
from repro.models import snn_yolo as jsy  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.benchmarks import (  # noqa: E402
    eval_map,
    fig3_density,
    fig5_miout,
    fig6_parallelism,
    fig15_mixed_t,
    fig17_dram,
    run,
    table1_ablation,
    table2_models,
    table3_hw,
)
from repro_torch.configs.snn_det import CONFIG, smoke_config  # noqa: E402
from repro_torch.core import miout as mi  # noqa: E402
from repro_torch.core import pruning, quant  # noqa: E402
from repro_torch.eval import harness  # noqa: E402
from repro_torch.eval import sharded as se  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import snn_yolo as sy  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_ULP = float(np.finfo(np.float32).eps)  # 1 ulp at 1.0: the mIoUT / density bound
REL = 1e-12  # the accounting's floats: the same formulas in the same order


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_same(got, want, what=""):
    """Dicts, lists and tuples recursively: ints, bools and strings exact,
    floats within REL (NaN equal to NaN)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (what, set(got) ^ set(want))
        for k in want:
            _assert_same(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{what}[{i}]")
    elif isinstance(want, (bool, np.bool_, str)) or want is None:
        assert got == want, (what, got, want)
    elif isinstance(want, (int, np.integer)):
        assert int(got) == int(want), (what, got, want)
    else:
        w, g = float(want), float(got)
        assert (np.isnan(w) and np.isnan(g)) or abs(g - w) <= REL * abs(w), (what, g, w)


# ------------------------------------------------------ 16-bit accumulator --


@pytest.mark.parametrize("shape", [(3, 3, 3, 16), (3, 3, 16, 32), (1, 1, 32, 16),
                                   (3, 3, 64, 64)])
@pytest.mark.parametrize("inputs", ["int8", "spikes"])
def test_accumulator_helpers_match_jax_exactly(shape, inputs):
    """``int8_conv_accumulate`` (int32, NHWC × HWIO, SAME), ``acc_range_ok``
    and ``conv_acc_worst_case`` equal JAX's exactly, on seeded int8 (or
    binary spike) inputs and 80%-pruned int8 weights."""
    rng = np.random.default_rng(sum(shape) + len(inputs))
    kh, kw, cin, kout = shape
    w = rng.integers(-128, 128, shape).astype(np.int8)
    if kh > 1:
        w[rng.uniform(size=shape) < 0.8] = 0
    lo, hi = (-128, 128) if inputs == "int8" else (0, 2)
    x = rng.integers(lo, hi, (2, 9, 13, cin)).astype(np.int8)
    want = np.asarray(jquant.int8_conv_accumulate(jnp.asarray(x), jnp.asarray(w),
                                                  ("NHWC", "HWIO", "NHWC")))
    got = quant.int8_conv_accumulate(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert quant.acc_range_ok(got) == bool(jquant.acc_range_ok(jnp.asarray(want)))
    assert quant.conv_acc_worst_case(torch.from_numpy(w)) == jquant.conv_acc_worst_case(w)
    assert quant.conv_acc_worst_case(w) == jquant.conv_acc_worst_case(w)
    if inputs == "spikes":
        assert np.abs(want).max() <= jquant.conv_acc_worst_case(w)


def test_acc_range_ok_edges():
    assert quant.ACC_BITS == jquant.ACC_BITS == 16
    for v, ok in ((2**15 - 1, True), (2**15, False), (-(2**15), True), (-(2**15) - 1, False)):
        t = torch.tensor([v], dtype=torch.int32)
        assert quant.acc_range_ok(t) is ok == bool(jquant.acc_range_ok(jnp.asarray([v])))
    assert quant.acc_range_ok(torch.tensor([300], dtype=torch.int32), bits=9) is False


# -------------------------------------------------------------------- mIoUT --


def _spike_cases():
    rng = np.random.default_rng(5)
    fig4 = np.zeros((3, 8, 1), np.float32)
    fig4[:, :4] = 1.0
    fig4[0, 4] = 1.0
    fig4[2, 5] = 1.0
    silent = rng.integers(0, 2, (3, 2, 6, 5, 4)).astype(np.float32)
    silent[..., 2] = 0.0  # an all-silent channel is masked out, not 0/0
    dense = (rng.uniform(size=(3, 2, 8, 8, 16)) < 0.7).astype(np.uint8)
    same = np.broadcast_to(rng.integers(0, 2, (1, 4, 4, 3)), (3, 4, 4, 3)).astype(np.float32)
    return {"fig4": fig4, "silent_channel": silent, "dense_u8": dense, "identical_steps": same,
            "all_silent": np.zeros((3, 4, 2), np.float32),
            "sparse_T16": (rng.uniform(size=(16, 3, 5, 7)) < 0.2).astype(np.float32)}


@pytest.mark.parametrize("case", sorted(_spike_cases()))
def test_miout_matches_jax_within_1_ulp(case):
    s = _spike_cases()[case]
    want = float(jmi.miout(jnp.asarray(s)))
    got = mi.miout(torch.from_numpy(np.ascontiguousarray(s)))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= F32_ULP * max(abs(want), 1.0), (float(got), want)
    if case == "fig4":
        assert abs(float(got) - 4 / 6) < 1e-6
    want_c0 = float(jmi.miout(jnp.asarray(s), channel_axis=0))
    assert abs(float(mi.miout(torch.from_numpy(np.ascontiguousarray(s)), channel_axis=0))
               - want_c0) <= F32_ULP * max(abs(want_c0), 1.0)


def test_schedule_helpers_match_jax():
    rng = np.random.default_rng(2)
    for _ in range(20):
        n = int(rng.integers(1, 12))
        mious = rng.uniform(size=n).round(2).tolist()
        macs = rng.integers(1, 10**9, n).tolist()
        for thr in (0.3, 0.6, 0.9):
            got = mi.choose_schedule(mious, macs, threshold=thr, full_t=4)
            assert got == jmi.choose_schedule(mious, macs, threshold=thr, full_t=4)
            assert mi.schedule_ops(macs, got) == jmi.schedule_ops(macs, got)
    assert mi.choose_schedule([0.9, 0.8, 0.4, 0.9], [100] * 4) == [1, 1, 3, 3]
    with pytest.raises(ValueError, match="length"):
        mi.schedule_ops([1, 2], [1])
    x = torch.arange(6.0).reshape(2, 3)
    rep = mi.repeat_conv_for_timesteps(x, 3)
    want = np.asarray(jmi.repeat_conv_for_timesteps(jnp.asarray(x.numpy()), 3))
    assert rep.shape == (3, 2, 3) and np.array_equal(rep.numpy(), want)


# -------------------------------------------------- reports and accumulator --


def test_reports_identical_is_jax_predicate():
    base = {"map": 0.25, "per_class_ap": [0.5, float("nan"), 0.0], "n_gt": [2, 0, 1],
            "n_pred": [3, 1, 0], "n_images": 4, "iou_threshold": 0.5, "n_shards": 2}
    variants = [
        {}, {"map": float("nan")}, {"per_class_ap": [0.5, 0.0, 0.0]},
        {"per_class_ap": [0.5, float("nan")]}, {"n_gt": [2, 0, 2]}, {"n_pred": [3, 1, 1]},
        {"n_images": 5}, {"iou_threshold": 0.75}, {"n_shards": 1, "gather": "host"},
        {"map": 0.25 + 1e-17}, {"map": np.nextafter(0.25, 1.0)},
    ]
    for v in variants:
        other = {**base, **v}
        assert se.reports_identical(base, other) == jse.reports_identical(base, other), v
    assert se.reports_identical(base, dict(base))
    assert not se.reports_identical(base, {**base, "n_pred": [3, 1, 1]})


def _block_demo(h):
    """``demo_config`` with block conv (block 6×10 divides every map): the
    compressed executors' border semantics in every stage."""
    return dataclasses.replace(h.demo_config(), use_block_conv=True)


@pytest.fixture(scope="module")
def trained_np():
    """Float weights trained 40 steps on the CPU by the port (batch 2, lr
    5e-3), as numpy: detections spread over all three classes, which random
    weights do not give. JAX evaluates the same arrays."""
    cfg = dataclasses.replace(_block_demo(harness), weight_bits=0)
    params, bn, _, losses = harness.train_steps(cfg, steps=40, batch=2, lr_peak=5e-3,
                                                verbose=False, device="cpu")
    assert losses[-1] < losses[0]
    return tu.tree_map(lambda t: t.numpy(), params), tu.tree_map(lambda t: t.numpy(), bn)


def test_accumulator_report_matches_jax_exactly(trained_np):
    params_np, bn_np = trained_np
    pruned_np = _np(jpruning.prune_tree(jax.tree_util.tree_map(jnp.asarray, params_np), 0.8))
    jcfg = _block_demo(jh)
    jdet = jh.compile_eval_detector(jcfg, jax.tree_util.tree_map(jnp.asarray, pruned_np),
                                    jax.tree_util.tree_map(jnp.asarray, bn_np))
    p, b, _ = interop.params_from_numpy(pruned_np, bn_np, device="cpu")
    det = harness.compile_eval_detector(dataclasses.replace(_block_demo(harness),
                                                            conv_exec="pallas"), p, b,
                                        device="cpu")
    want, got = jh.accumulator_report(jdet), harness.accumulator_report(det)
    assert got == want and got["max_abs"] > 1000 and got["within_16b"]
    assert list(got["layers"]) == list(want["layers"])
    float_det = harness.compile_eval_detector(harness.demo_config(weight_bits=0), p, b,
                                              device="cpu")
    assert float_det.plan is None
    assert harness.accumulator_report(float_det) == jh.accumulator_report(
        types.SimpleNamespace(plan=None))


# ----------------------------------------------------------------- pipeline --


def test_run_pipeline_matches_jax_on_carried_weights(trained_np, monkeypatch):
    """Both packages' ``run_pipeline`` with ``train_steps`` replaced: the
    float stage returns the same carried-across weights, QAT is the
    identity. Every stage report, both schedule reports and the accumulator
    report are identical (mAP, per-class AP, counts: ``valid`` and
    ``classes`` are exact, ROADMAP R4), and the final handles detect the same
    ``valid``/``classes`` with boxes and scores within 1e-5. JAX evaluates
    with the dense executor (its executors agree exactly under block conv),
    the port with its kernel executor's plain version."""
    params_np, bn_np = trained_np
    seen = {"jax": [], "torch": []}

    def jax_train(cfg, *, steps, params=None, bn=None, **kw):
        seen["jax"].append((cfg.weight_bits, steps, kw.get("lr_peak"), kw.get("start_index")))
        if params is None:
            return (jax.tree_util.tree_map(jnp.asarray, params_np),
                    jax.tree_util.tree_map(jnp.asarray, bn_np), None, [2.0, 1.0])
        return params, bn, None, [1.0]

    def torch_train(cfg, *, steps, params=None, bn=None, device=None, **kw):
        seen["torch"].append((cfg.weight_bits, steps, kw.get("lr_peak"),
                              kw.get("start_index")))
        if params is None:
            p, b, _ = interop.params_from_numpy(params_np, bn_np, device=device)
            return p, b, None, [2.0, 1.0]
        return params, bn, None, [1.0]

    monkeypatch.setattr(jh, "train_steps", jax_train)
    monkeypatch.setattr(harness, "train_steps", torch_train)
    kw = dict(steps=7, finetune_steps=3, batch=2, eval_images=8, verbose=False)
    want = jh.run_pipeline(_block_demo(jh), conv_exec="dense", **kw)
    got = harness.run_pipeline(_block_demo(harness), conv_exec="pallas", device="cpu", **kw)
    assert seen["torch"] == seen["jax"] == [(0, 7, None, None), (8, 3, 3e-4, 14)]
    assert set(got.stages) == set(want.stages) == {"trained", "pruned", "qat"}
    for name in want.stages:
        assert se.reports_identical(got.stages[name], want.stages[name]), name
    for name in want.schedules:
        assert se.reports_identical(got.schedules[name], want.schedules[name]), name
    assert sum(got.stages["qat"]["n_pred"][1:]) > 0  # more than one class detected
    assert got.accumulator == want.accumulator
    assert got.schedule_delta == want.schedule_delta == 0.0
    assert got.losses == want.losses
    sg, sw = got.summary(), want.summary()
    sg.pop("wall_s"), sw.pop("wall_s")
    assert json.dumps(sg, sort_keys=True) == json.dumps(sw, sort_keys=True)
    images = _eval_images(got.final_det.cfg, 8)
    jd, _ = want.final_det.detect(jnp.asarray(images))
    td, _ = got.final_det.detect(torch.from_numpy(images))
    for f in ("valid", "classes"):
        assert np.array_equal(getattr(td, f).numpy(), np.asarray(getattr(jd, f))), f
    v = np.asarray(jd.valid).astype(bool)
    for f in ("boxes", "scores"):
        assert np.abs(getattr(td, f).numpy()[v] - np.asarray(getattr(jd, f))[v]).max() <= 1e-5


def _eval_images(cfg, n):
    from repro_torch.data import synthetic_detection as sd

    images, _ = sd.eval_set(n, hw=cfg.input_hw, grid_div=harness.grid_div(cfg))
    return images


def test_run_pipeline_on_cpu_end_to_end(tmp_path):
    """A real two-step pipeline: the pruned support survives QAT, the
    summary has JAX's keys, the checkpoints are the float and QAT stages."""
    cfg = _block_demo(harness)
    rep = harness.run_pipeline(cfg, steps=2, finetune_steps=1, batch=2, eval_images=4,
                               conv_exec="pallas", ckpt_dir=str(tmp_path), verbose=False,
                               device="cpu")
    jkeys = jh.EvalReport(stages={"qat": {"map": 0.0, "per_class_ap": []}},
                          schedules={"uniform_t3": {"map": 0.0}, "mixed_1_3": {"map": 0.0}},
                          accumulator={"max_abs": 0, "within_16b": True}, losses={},
                          wall_s=0.0).summary()
    assert set(rep.summary()) == set(jkeys)
    assert len(rep.losses["train"]) == 2 and len(rep.losses["qat"]) == 1
    fcfg, fparams, _, step = harness.restore_detector_checkpoint(str(tmp_path), step=2,
                                                                device="cpu")
    assert step == 2 and fcfg.weight_bits == 0 and fcfg.conv_exec == "dense"
    qcfg, qparams, _, step = harness.restore_detector_checkpoint(str(tmp_path), device="cpu")
    assert step == 3 and qcfg == dataclasses.replace(cfg, conv_exec="pallas")
    mask = pruning.mask_tree(fparams, 0.8)
    for m, w, fw in zip(tu.leaves(mask), tu.leaves(qparams), tu.leaves(fparams)):
        assert bool((w[m == 0] == 0).all())
        if pruning.is_spatial_kernel(fw):
            assert 0.15 < float(m.mean()) < 0.25
    for a, b in zip(tu.leaves(qparams), tu.leaves(rep.final_det.params)):
        assert torch.equal(a, b)
    assert rep.final_det.cfg.conv_exec == "pallas" and rep.final_det.plan is not None


def test_run_pipeline_refuses_what_is_not_ported():
    """``eval_shards=2`` routes every evaluation through the sharded path
    and gives the stage and schedule reports of ``eval_shards=1``; a
    compressed executor still needs a block-conv config."""
    kw = dict(steps=1, finetune_steps=1, batch=2, eval_images=4, conv_exec="pallas",
              verbose=False, device="cpu")
    one = harness.run_pipeline(smoke_config(CONFIG), **kw)
    two = harness.run_pipeline(smoke_config(CONFIG), eval_shards=2, **kw)
    for name in one.stages:
        assert two.stages[name]["n_shards"] == 2 and two.stages[name]["gather"] == "host"
        assert se.reports_identical(two.stages[name], one.stages[name]), name
    for name in one.schedules:
        assert se.reports_identical(two.schedules[name], one.schedules[name]), name
    with pytest.raises(ValueError, match="block-conv border"):
        harness.run_pipeline(harness.demo_config(), steps=1, conv_exec="pallas",
                             device="cpu")
    with pytest.raises(ValueError, match="block-conv border"):
        jh.run_pipeline(jh.demo_config(), steps=1, conv_exec="pallas")


# --------------------------------------------------------------- benchmarks --


@pytest.mark.parametrize("name", ["table1_ablation", "table3_hw", "fig15_mixed_t",
                                  "fig17_dram", "fig6_parallelism", "table2_models"])
def test_analytic_benchmarks_equal_jax(name, capsys):
    """The accounting benchmarks give JAX's dict (ints exact, floats within
    1e-12 relative); Table II without its training cells."""
    port = {"table1_ablation": lambda: table1_ablation.run("cpu"),
            "table3_hw": table3_hw.run, "fig15_mixed_t": fig15_mixed_t.run,
            "fig17_dram": fig17_dram.run, "fig6_parallelism": fig6_parallelism.run,
            "table2_models": lambda: table2_models.run(0, device="cpu")}[name]
    ref = {"table1_ablation": jt1.run, "table3_hw": jt3.run, "fig15_mixed_t": jfig15.run,
           "fig17_dram": jfig17.run, "fig6_parallelism": jfig6.run,
           "table2_models": lambda: jt2.run(0)}[name]
    want = ref()
    jax_text = capsys.readouterr().out
    got = port()
    _assert_same(got, want, name)
    assert capsys.readouterr().out == jax_text


@pytest.fixture(scope="module")
def jax_full_params():
    """The JAX benchmarks' own weights at ``CONFIG`` (``PRNGKey(0)``), numpy."""
    from repro.configs import get_config

    params, bn = jsy.init_params(jax.random.PRNGKey(0), get_config("snn-det"))
    return _np(params), _np(bn)


def _carry(monkeypatch, params_np, bn_np, cfg_hw=None):
    """The port's ``init_params`` handing out the given JAX arrays."""
    def init_params(cfg, *, seed=0, device=None):
        assert seed == 0 and sy.layer_shapes(cfg) == {
            k: v["w"].shape for k, v in params_np.items()}
        p, b, _ = interop.params_from_numpy(params_np, bn_np, device=device)
        return p, b

    monkeypatch.setattr(sy, "init_params", init_params)


@pytest.mark.parametrize("hw", [(5, 7), (9, 16), (4, 6)])
def test_maxpool_drops_an_odd_row_as_jax(hw):
    """The 2×2 pool on an odd map (Fig 5's 144×256 input pools a 9×16 one):
    JAX's VALID ``reduce_window`` drops the odd last row/column; the forward
    equal, and the gradient equal too (0 on the dropped row, the first
    maximum of a tied window)."""
    rng = np.random.default_rng(sum(hw))
    x = rng.integers(0, 2, (2, 3, *hw, 4)).astype(np.float32)
    want = np.asarray(jsy._maxpool_t(jnp.asarray(x)))
    assert np.array_equal(sy._maxpool_t(torch.from_numpy(x)).numpy(), want)
    g = rng.normal(size=want.shape).astype(np.float32)
    jgrad = jax.grad(lambda z: jnp.sum(jsy._maxpool_t(z) * g))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    (sy._maxpool_t(t) * torch.from_numpy(g)).sum().backward()
    assert np.array_equal(t.grad.numpy(), np.asarray(jgrad))


def test_fig3_density_equals_jax_on_its_weights(jax_full_params, monkeypatch, capsys):
    """Per-layer densities within 1 ulp of f32 (a mean), the shape verdict equal."""
    want = jfig3.run()
    _carry(monkeypatch, *jax_full_params)
    got = fig3_density.run(device="cpu")
    assert set(got) == set(want) and got["_monotone"] is want["_monotone"] is True
    for k, v in want.items():
        if k != "_monotone":
            assert abs(got[k] - v) <= F32_ULP * v, (k, got[k], v)
    capsys.readouterr()


def test_fig5_miout_equals_jax_on_its_weights(monkeypatch, capsys):
    """Fig 4's 0.67 and per-layer mIoUT at 144×256 within 1 ulp, on JAX's
    weights at that config (seed 0)."""
    want = jfig5.run()
    cfg = dataclasses.replace(jfig5.get_config("snn-det"), input_hw=(144, 256),
                              use_block_conv=False, mixed_time=False)
    _carry(monkeypatch, *map(_np, jsy.init_params(jax.random.PRNGKey(0), cfg)))
    got = fig5_miout.run("cpu")
    assert set(got) == set(want) and abs(got["fig4"] - 4 / 6) < 1e-6
    for k, v in want.items():
        assert abs(got[k] - v) <= F32_ULP * max(abs(v), 1.0), (k, got[k], v)
    capsys.readouterr()


def test_table2_short_train_on_jax_weights(monkeypatch):
    """Two plain-SGD steps of the snn mode on JAX's weights: the first loss
    within 1e-5 relative (the same forward), the second within 1e-4
    relative (after one update of lr 5e-3 × gradients that agree to
    1e-4·max|g|, tests/test_torch_train.py)."""
    small = dataclasses.replace(
        CONFIG, input_hw=(96, 160), stem_channels=8, conv_block_channels=16,
        stage_channels=((16, 16), (16, 32), (32, 32)), pooled_stages=3,
        use_block_conv=False)
    jcfg = dataclasses.replace(jt2.get_config("snn-det"), **{
        k: getattr(small, k) for k in ("input_hw", "stem_channels", "conv_block_channels",
                                       "stage_channels", "pooled_stages", "use_block_conv")})
    want = jt2._short_train(jcfg, 2)
    _carry(monkeypatch, *map(_np, jsy.init_params(jax.random.PRNGKey(0), jcfg)))
    got = table2_models._short_train(small, 2, device="cpu")
    assert len(got) == 2
    assert abs(got[0] - want[0]) <= 1e-5 * abs(want[0]), (got, want)
    assert abs(got[1] - want[1]) <= 1e-4 * abs(want[1]), (got, want)


# ------------------------------------------------------------ eval_map, CLI --


def test_eval_map_ckpt_dir_then_checkpoint(tmp_path, monkeypatch, capsys):
    """``--ckpt-dir`` then ``--checkpoint`` scores the QAT weights as the
    pipeline did; the working directory receives only the JSON asked for."""
    work, ckpts = tmp_path / "work", tmp_path / "ckpts"
    work.mkdir()
    monkeypatch.chdir(work)
    res = eval_map.main(["--fast", "--steps", "3", "--device", "cpu", "--ckpt-dir",
                         str(ckpts), "--out-json", "pipe.json"])
    assert os.listdir(work) == ["pipe.json"]
    assert json.loads((work / "pipe.json").read_text()) == json.loads(json.dumps(res))
    assert res["config"]["steps"] == 3 and res["config"]["finetune_steps"] == 20
    assert set(res["map_by_stage"]) == {"trained", "pruned", "qat"}
    again = eval_map.main(["--checkpoint", str(ckpts), "--fast", "--device", "cpu"])
    assert sorted(os.listdir(work)) == ["BENCH_torch_eval_ckpt.json", "pipe.json"]
    assert again["config"]["step"] == 23
    assert again["map"] == res["stages"]["qat"]["map"]
    assert again["per_class_ap"] == res["stages"]["qat"]["per_class_ap"]
    assert again["n_gt"] == res["stages"]["qat"]["n_gt"]
    sharded = eval_map.run_checkpoint(str(ckpts), eval_images=2, shards=2, out_json="",
                                      device="cpu")
    assert sharded["sharded_parity"]["bit_identical"] and sharded["config"]["eval_shards"] == 2
    assert sorted(os.listdir(work)) == ["BENCH_torch_eval_ckpt.json", "pipe.json"]
    assert "BIT-IDENTICAL" in capsys.readouterr().out


def test_eval_map_refuses_what_is_not_ported(tmp_path, monkeypatch, smoke_ckpt):
    """``--shards`` fails the run unless the sharded report is
    bit-identical to the single-process one; a dataset spec naming a
    missing file raises before anything is trained or written."""
    monkeypatch.chdir(tmp_path)
    real = harness.evaluate_detector

    def off_by_one(det, **kw):  # the single-process re-score disagrees
        rep = real(det, **kw)
        return rep if kw.get("sharded") else {**rep, "n_pred": [n + 1 for n in rep["n_pred"]]}

    monkeypatch.setattr(harness, "evaluate_detector", off_by_one)
    with pytest.raises(SystemExit, match="not bit-identical"):
        eval_map.main(["--checkpoint", smoke_ckpt, "--fast", "--shards", "2", "--device",
                       "cpu", "--out-json", ""])
    monkeypatch.setattr(harness, "evaluate_detector", real)
    # the COCO loader is ported: a spec naming a missing file raises before
    # anything is trained or written
    with pytest.raises(FileNotFoundError, match="x.json"):
        eval_map.main(["--fast", "--dataset", "coco:x.json", "--device", "cpu"])
    assert os.listdir(tmp_path) == []
    assert eval_map.OUT_JSON == "BENCH_torch_eval.json" != "BENCH_eval.json"


@pytest.fixture(scope="module")
def smoke_ckpt(tmp_path_factory):
    """A QAT detector checkpoint at the smoke config (block conv, 24×32),
    written by ``run_pipeline`` on the CPU."""
    root = str(tmp_path_factory.mktemp("smoke_ckpt"))
    harness.run_pipeline(smoke_config(CONFIG), steps=3, finetune_steps=2, batch=2,
                         eval_images=4, conv_exec="pallas", ckpt_dir=root, verbose=False,
                         device="cpu")
    return root


def test_serve_eval_map_checkpoint_is_bit_identical(smoke_ckpt):
    """``serve --eval-map --checkpoint``: the served detections score exactly
    as ``harness.evaluate_detector`` does, and the CLI exits 0."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "snn-det", "--eval-map",
         "--checkpoint", smoke_ckpt, "--requests", "8", "--slots", "3", "--device", "cpu"],
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert re.search(r"harness parity: served .* — BIT-IDENTICAL", r.stdout), r.stdout
    assert "served 8 streams (8 frames)" in r.stdout


def test_serve_eval_map_gate_fails_on_a_mismatch(smoke_ckpt, monkeypatch, capsys):
    real = harness.evaluate_detector

    def off_by_one(det, **kw):
        rep = real(det, **kw)
        return {**rep, "n_pred": [n + 1 for n in rep["n_pred"]]}

    monkeypatch.setattr(harness, "evaluate_detector", off_by_one)
    with pytest.raises(SystemExit, match="does not match"):
        serve.main(["--arch", "snn-det", "--eval-map", "--checkpoint", smoke_ckpt,
                    "--requests", "4", "--device", "cpu"])
    assert "MISMATCH" in capsys.readouterr().out


def test_serve_eval_map_flags_refuse_what_is_not_ported(smoke_ckpt, capsys):
    # --eval-shards 2 scores the served detections through the sharded
    # reduction, identically to --eval-shards 1, and passes the harness gate
    argv = ["--arch", "snn-det", "--eval-map", "--checkpoint", smoke_ckpt, "--requests", "6",
            "--device", "cpu"]
    serve.main(argv)
    one = capsys.readouterr().out
    serve.main(argv + ["--eval-shards", "2"])
    two = capsys.readouterr().out
    score = re.compile(r"served-detections mAP@0.5 (\S+) over 6 val frames")
    assert score.search(one).group(1) == score.search(two).group(1)
    assert "(2 shards, host gather)" in two and "BIT-IDENTICAL" in two
    # the VOC loader is ported: a spec naming a missing directory raises
    missing = os.path.join(smoke_ckpt, "no_such_voc_dir")
    with pytest.raises(FileNotFoundError, match="no_such_voc_dir"):
        serve.main(["--arch", "snn-det", "--eval-map", "--dataset", f"voc:{missing}",
                    "--device", "cpu"])
    # demo weights: the served score, and no parity gate without a checkpoint
    done = serve.main(["--arch", "snn-det", "--eval-map", "--requests", "3",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(done) == 3 and "served-detections mAP@0.5" in out and "parity" not in out


# ------------------------------------------------------------------ runner --


def test_runner_runs_jax_suites_in_jax_order():
    """The suite list is JAX's ``benchmarks/run.py`` list without
    ``roofline`` (TPU dry-run artifacts, ROADMAP item 9)."""
    with open(os.path.join(ROOT, "benchmarks", "run.py")) as f:
        jax_names = re.findall(r'\(\s*"(\w+)",\s*lambda', f.read())
    assert "roofline" in jax_names
    names = [n for n, _ in run.suites(fast=True, device="cpu")]
    assert names == [n for n in jax_names if n != "roofline"]


def test_runner_reports_failed_suites(monkeypatch, capsys, tmp_path):
    def boom():
        raise RuntimeError("suite broke")

    monkeypatch.setattr(run, "suites", lambda fast, device: [
        ("fig6_parallelism", lambda: {"ok": 1}), ("broken", boom), ("fig17", lambda: 2)])
    with pytest.raises(SystemExit) as e:
        run.main(["--fast", "--device", "cpu", "--json", str(tmp_path / "r.json")])
    assert e.value.code == 1
    out = capsys.readouterr()
    assert "FAILED suites: ['broken']" in out.out and "suite broke" in out.err
    assert json.loads((tmp_path / "r.json").read_text()) == {"fig6_parallelism": {"ok": 1},
                                                             "fig17": 2}
    monkeypatch.setattr(run, "suites", lambda fast, device: [("a", lambda: 1),
                                                             ("b", lambda: 2)])
    assert run.main(["--device", "cpu"]) == {"a": 1, "b": 2}
    assert "all 2 benchmark suites completed" in capsys.readouterr().out
