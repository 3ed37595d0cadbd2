"""The paper's evaluation on the port against the JAX package, on the CPU:
the 16-bit accumulator helpers, mIoUT and the mixed schedule, and the
accumulator report and the train → prune → QAT → evaluate pipeline on the
same trained weights (the module's ``trained_np`` fixture). The pipeline on
its own, ``eval_map`` and the serve CLI's ``--eval-map`` gate are in
``test_torch_paper_eval.py``; the Table I–III and Fig 3, 5, 6, 15, 17
benchmarks and the runner in ``test_torch_paper_bench.py`` (one file per
shared fixture, so xdist spreads them over workers).

Weights cross as numpy arrays (``interop.params_from_numpy``): the two
packages' seeded weights come from different generators, so a check whose
numbers depend on the weights runs on the same arrays in both. Each
tolerance is stated beside its check."""
import dataclasses
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.core import miout as jmi  # noqa: E402
from repro.core import pruning as jpruning  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.eval import harness as jh  # noqa: E402
from repro.eval import sharded as jse  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.core import miout as mi  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.eval import harness  # noqa: E402
from repro_torch.eval import sharded as se  # noqa: E402

F32_ULP = float(np.finfo(np.float32).eps)  # 1 ulp at 1.0: the mIoUT / density bound


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


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


def _eval_images(cfg, n):
    from repro_torch.data import synthetic_detection as sd

    images, _ = sd.eval_set(n, hw=cfg.input_hw, grid_div=harness.grid_div(cfg))
    return images


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
