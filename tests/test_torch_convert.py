"""The port's ANN→SNN conversion (``repro_torch.convert``) against the JAX
package's (``repro.convert``) on the same inputs, at
``tests/test_convert.py``'s smoke scale (full_t=4, 4 calibration images,
v_init_frac 0.5), the JAX side on the ``dense`` executor, the port's on the
CPU (plain versions).

Tolerances, per test:
* the importer and the per-layer emit (``folded``, ``_condition``,
  ``_emit_layer``) are numpy in both packages: exact;
* the ANN reference forward, calibration, the emitted parameters and tdBN
  variances: within 1e-5 of each array's largest magnitude (the convs sum
  f32 in another order: XLA's against PyTorch's); the emitted tdBN means
  within 1e-5 of each channel's spread sqrt(var + eps);
* the plans' int8 weights: equal, a difference allowed only where the
  port's float weight sits on a rounding half (none occurs here);
* the head-scale fit α: bit-equal to the JAX package's fit arithmetic on
  the same weights through JAX's own forward run op by op. JAX's
  ``convert_ann`` fits through a jitted forward, where XLA contracts
  mul+add into FMAs (ROADMAP R4): at T=4 that flips encode spikes against
  JAX's own eager forward, so its α sits ~1e-3 from the eager one; the
  end-to-end α is held to 2e-3 of it for that reason;
* converted heads (JAX's parameters carried across) through the port's
  ``dense`` and ``pallas`` executors: spikes, ``valid`` and ``classes``
  equal and floats within 1e-5 (``tests/test_torch_converted.py``'s
  bounds) of JAX's forward run op by op, for the same reason.

Inputs are built under ``jax.threefry_partitionable(False)`` (ROADMAP R1).
"""
import contextlib
import dataclasses
import io
import json
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import convert as jcv  # noqa: E402
from repro.convert import emit as jemit  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.data import detection_datasets as jdd  # noqa: E402
from repro.eval import harness as jharness  # noqa: E402
from repro.models import postprocess as jpost  # noqa: E402
from repro.models import snn_yolo as jsy  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch import convert as cv  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.convert import emit  # noqa: E402
from repro_torch.core import plan as cplan  # noqa: E402
from repro_torch.data import detection_datasets as dd  # noqa: E402
from repro_torch.eval import harness  # noqa: E402
from repro_torch.models import snn_yolo as sy  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "ann_detector", "ann_tiny_yolo.npz")
COCO = os.path.join(ROOT, "tests", "fixtures", "coco_fixture", "instances.json")
SMOKE = dict(full_t=4, calib_images=4, calib_batch=4, v_init_frac=0.5)
REL = 1e-5
ALPHA_JIT_REL = 2e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _source(kind):
    return (dd.CocoJsonSource(COCO), jdd.CocoJsonSource(COCO)) if kind == "coco" else (None, None)


@pytest.fixture(scope="module")
def anns():
    return cv.load_ann_npz(FIXTURE), jcv.load_ann_npz(FIXTURE)


@pytest.fixture(scope="module")
def calib_images(anns):
    ann = anns[0]
    images, _ = dd.SyntheticSource().eval_set(
        4, split="train", hw=ann.cfg.input_hw, grid_div=harness.grid_div(ann.cfg))
    return images


@pytest.fixture(scope="module")
def converted(anns):
    """One smoke-scale conversion per calibration source, in both packages."""
    ann, jann = anns
    out = {}
    for kind in ("synthetic", "coco"):
        src, jsrc = _source(kind)
        with jax.threefry_partitionable(False):
            jout = jcv.convert_ann(jann, source=jsrc, cc=jcv.ConvertConfig(**SMOKE))
        out[kind] = (cv.convert_ann(ann, source=src, cc=cv.ConvertConfig(**SMOKE), device="cpu"),
                     jout)
    return out


def _tiny_ann():
    """A seeded tiny ANN-mode detector (``tests/test_convert.py``'s), the
    JAX trees and the same arrays carried across to the port."""
    from repro.configs import get_config, smoke_config

    jcfg = dataclasses.replace(
        smoke_config(get_config("snn-det")), arch_id="ann-tiny-test",
        mode="ann", weight_bits=0, conv_exec="dense", use_block_conv=True,
    )
    with jax.threefry_partitionable(False):
        jp, jbn = jsy.init_params(jax.random.PRNGKey(0), jcfg)
    jp, jbn = _np(jp), _np(jbn)
    rng = np.random.default_rng(0)
    for name in jbn:  # non-trivial BN so the fold is exercised
        c = jbn[name]["mean"].shape[0]
        jbn[name] = {**jbn[name], "mean": rng.normal(size=c).astype(np.float32) * 0.1,
                     "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
        jp[name] = {**jp[name], "gamma": rng.uniform(0.5, 1.5, c).astype(np.float32),
                    "beta": rng.normal(size=c).astype(np.float32) * 0.1}
    p, b, _ = interop.params_from_numpy(jp, jbn, device="cpu")
    cfg = sy.config_from_dict(jsy.config_to_dict(jcfg))
    return jcfg, jp, jbn, cfg, p, b


# --------------------------------------------------------------- importer --


def test_load_fixture_matches_jax(anns):
    ann, jann = anns
    assert dataclasses.asdict(ann.cfg) == dataclasses.asdict(jann.cfg)
    assert ann.cfg.mode == "ann" and ann.eps == jann.eps
    assert list(ann.layers) == list(jann.layers) == cv.conv_bn_layer_names(ann.cfg)
    for name, lay in ann.layers.items():
        jl = jann.layers[name]
        for f in ("w", "gamma", "beta", "mean", "var"):
            np.testing.assert_array_equal(getattr(lay, f), getattr(jl, f))
        assert lay.bias is None and jl.bias is None
        w_t, b_t = ann.folded(name)
        jw_t, jb_t = jann.folded(name)
        assert w_t.dtype == jw_t.dtype == np.float32
        np.testing.assert_array_equal(w_t, jw_t)
        np.testing.assert_array_equal(b_t, jb_t)
    np.testing.assert_array_equal(ann.head_w, jann.head_w)


def test_export_matches_jax_bytes(tmp_path):
    jcfg, jp, jbn, cfg, p, b = _tiny_ann()
    jpath, path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jcv.export_ann_npz(jpath, jp, jbn, jcfg)
    assert cv.export_ann_npz(path, p, b, cfg) == path
    with np.load(jpath) as jz, np.load(path) as z:
        assert sorted(z.files) == sorted(jz.files)
        for k in z.files:
            assert z[k].dtype == jz[k].dtype and z[k].shape == jz[k].shape, k
            assert z[k].tobytes() == jz[k].tobytes(), k
    # each package loads the other's bundle, with the bias the fold reads
    for a, bb in ((cv.load_ann_npz(jpath), jcv.load_ann_npz(path)),
                  (cv.load_ann_npz(path), jcv.load_ann_npz(jpath))):
        assert dataclasses.asdict(a.cfg) == dataclasses.asdict(bb.cfg)
        for name in a.layers:
            for x, y in zip(a.folded(name), bb.folded(name)):
                np.testing.assert_array_equal(x, y)


def _mutate(tmp_path, case):
    """A malformed copy of the fixture bundle."""
    with np.load(FIXTURE) as z:
        data = {k: z[k] for k in z.files}
    if case == "no-meta":
        del data["__meta__"]
    elif case == "wrong-format":
        meta = json.loads(data["__meta__"].tobytes())
        meta["format"] = "repro-ann-detector/0"
        data["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    elif case == "missing-key":
        del data["conv_block/var"]
        del data["head/w"]
    elif case == "unexpected-key":
        data["stage9/agg/w"] = np.zeros(3, np.float32)
    elif case == "shape-mismatch":
        data["stage1/main_a/w"] = data["stage1/main_a/w"][:, :, :-1]
    elif case == "bias-shape":
        data["encode/bias"] = np.zeros(3, np.float32)
    elif case == "head-shape":
        data["head/w"] = data["head/w"][..., :-1]
    path = str(tmp_path / f"{case}.npz")
    np.savez(path, **data)
    return path


@pytest.mark.parametrize("case", ["no-meta", "wrong-format", "missing-key", "unexpected-key",
                                  "shape-mismatch", "bias-shape", "head-shape"])
def test_malformed_bundles_raise_like_jax(tmp_path, case):
    path = _mutate(tmp_path, case)
    with pytest.raises(ValueError) as jerr:
        jcv.load_ann_npz(path)
    with pytest.raises(ValueError) as err:
        cv.load_ann_npz(path)
    assert str(err.value) == str(jerr.value)


def test_bias_folds_like_jax(tmp_path):
    with np.load(FIXTURE) as z:
        data = {k: z[k] for k in z.files}
    rng = np.random.default_rng(1)
    data["conv_block/bias"] = rng.normal(size=data["conv_block/beta"].shape).astype(np.float32)
    path = str(tmp_path / "bias.npz")
    np.savez(path, **data)
    ann, jann = cv.load_ann_npz(path), jcv.load_ann_npz(path)
    for x, y in zip(ann.folded("conv_block"), jann.folded("conv_block")):
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------- calibrate --


@pytest.mark.parametrize("block", [True, False], ids=["block-conv", "same-conv"])
def test_ann_reference_forward_matches_jax(anns, calib_images, block):
    ann, jann = anns
    bhw = (6, 10)
    taps, jtaps = {}, {}
    head = cv.ann_reference_forward(ann, calib_images, taps=taps, use_block_conv=block,
                                    block_hw=bhw, device="cpu")
    jhead = jcv.ann_reference_forward(jann, jnp.asarray(calib_images), taps=jtaps,
                                      use_block_conv=block, block_hw=bhw)
    assert set(taps) == set(jtaps) and "head" in taps
    assert _rel(head.numpy(), jhead) <= REL
    for name, want in jtaps.items():
        assert _rel(taps[name].numpy(), want) <= REL, name
    np.testing.assert_array_equal(cv.quantize_images_u8(calib_images).numpy(),
                                  np.asarray(jcv.quantize_images_u8(calib_images)))


def test_ann_reference_forward_equals_ann_mode_forward(tmp_path):
    """The standalone conv→folded-BN→ReLU walk reproduces the port's own
    ``forward(mode="ann")`` on the same weights (``tests/test_convert.py``'s
    check, at its tolerance)."""
    jcfg, jp, jbn, cfg, p, b = _tiny_ann()
    path = str(tmp_path / "ann.npz")
    cv.export_ann_npz(path, p, b, cfg)
    ann = cv.load_ann_npz(path)
    rng = np.random.default_rng(0)
    images = rng.random((2, *cfg.input_hw, 3)).astype(np.float32)
    ref = cv.ann_reference_forward(ann, images, taps={}, use_block_conv=cfg.use_block_conv,
                                   block_hw=cfg.block_hw, device="cpu")
    with torch.no_grad():
        head, _, _ = sy.forward(p, b, cv.quantize_images_u8(images), cfg, train=False)
    np.testing.assert_allclose(ref.numpy(), head.numpy().reshape(ref.shape), rtol=1e-4,
                               atol=1e-4)


def test_calibrate_matches_jax(anns, calib_images):
    ann, jann = anns
    kw = dict(percentile=99.7, encode_duty=0.5, batch=4, use_block_conv=True, block_hw=(6, 10))
    stats = cv.calibrate(ann, calib_images, device="cpu", **kw)
    jstats = jcv.calibrate(jann, calib_images, **kw)
    assert stats.n_images == jstats.n_images == 4 and stats.percentile == jstats.percentile
    assert _rel(stats.head, jstats.head) <= REL
    assert set(stats.layers) == set(jstats.layers)
    for name, st in stats.layers.items():
        js = jstats.layers[name]
        for f in ("lam", "mean", "var", "spike_value", "spike_frac"):
            a, b = getattr(st, f), getattr(js, f)
            if b is None:
                assert a is None, (name, f)
                continue
            assert a.dtype == b.dtype == np.float32, (name, f)
            assert _rel(a, b) <= REL, (name, f, _rel(a, b))
    assert stats.layers["encode"].spike_value is not None


# ------------------------------------------------------------------ emit --


def test_condition_exact():
    rng = np.random.default_rng(5)
    w = rng.normal(size=(3, 3, 4, 6)).astype(np.float32)
    w[..., 2] = 0.0  # a dead output channel keeps d = 1
    for x in (w, np.zeros_like(w)):
        got, want = emit._condition(x), jemit._condition(x)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_emit_layer_exact_on_jax_stats(anns, calib_images):
    """JAX's CalibrationStats carried across: every layer's emitted
    parameters, tdBN state and report entry equal JAX's, bit for bit."""
    ann, jann = anns
    jstats = jcv.calibrate(jann, calib_images, batch=4, block_hw=(6, 10))
    rng = np.random.default_rng(2)
    for name in cv.conv_bn_layer_names(ann.cfg):
        w_t, b_t = ann.folded(name)
        st = jstats.layers[name]
        in_value = np.abs(rng.normal(size=w_t.shape[2])).astype(np.float32) + 0.05
        for gain, lam in ((1.0, st.lam), (1.7, 0.5 * st.lam)):
            kw = dict(lam_target=np.asarray(lam, np.float32), gain=gain, dead_eps=1e-6)
            p, s, info, dead = emit._emit_layer(w_t, b_t, st, in_value, device="cpu", **kw)
            jp_, js_, jinfo, jdead = jemit._emit_layer(w_t, b_t, st, in_value, **kw)
            for k in ("w", "gamma", "beta"):
                np.testing.assert_array_equal(p[k].numpy(), np.asarray(jp_[k]), err_msg=k)
            for k in ("mean", "var", "count"):
                np.testing.assert_array_equal(s[k].numpy(), np.asarray(js_[k]), err_msg=k)
            assert s["count"].dtype == torch.int32
            assert info == jinfo
            np.testing.assert_array_equal(dead, jdead)


@pytest.mark.parametrize("t,leak,mode", [(1, 0.25, "mean"), (8, 1.0, "mean"), (8, 1.0, "final"),
                                         (2, 0.5, "final"), (128, 1.0, "final"),
                                         (64, 0.9, "mean")])
def test_readout_scale_and_target_config_match_jax(anns, t, leak, mode):
    assert cv.readout_scale(t, leak, mode) == jcv.readout_scale(t, leak, mode)
    assert dataclasses.asdict(cv.ConvertConfig()) == dataclasses.asdict(jcv.ConvertConfig())
    kw = dict(full_t=t, leak=leak, head_readout=mode, v_init_frac=0.25, pool_drive=True)
    got = emit.target_config(anns[0].cfg, cv.ConvertConfig(**kw))
    want = jemit.target_config(anns[1].cfg, jcv.ConvertConfig(**kw))
    assert sy.config_to_dict(got) == jsy.config_to_dict(want)


@pytest.mark.parametrize("kind", ["synthetic", "coco"])
def test_convert_ann_matches_jax(converted, kind):
    out, jout = converted[kind]
    assert sy.config_to_dict(out.cfg) == jsy.config_to_dict(jout.cfg)
    assert set(out.params) == set(jout.params) and set(out.bn_state) == set(jout.bn_state)
    for name, lp in jout.params.items():
        for k, v in lp.items():
            got = out.params[name][k]
            assert got.dtype == torch.float32
            if name == "head":  # carries α: see test_head_fit_matches_jax
                continue
            assert _rel(got.numpy(), v) <= REL, (name, k, _rel(got.numpy(), v))
    for name, ls in jout.bn_state.items():
        mean, var = out.bn_state[name]["mean"].numpy(), out.bn_state[name]["var"].numpy()
        assert _rel(var, ls["var"]) <= REL, name
        # a mean is held per channel against its spread, what tdBN divides
        # it by: numpy's f32 running mean over ~4k samples carries rounding
        # of ~n·eps·E|x|, which one-ulp differences of the samples move
        spread = np.sqrt(np.asarray(ls["var"], np.float64) + 1e-5)
        drift = np.abs(mean.astype(np.float64) - np.asarray(ls["mean"])) / spread
        assert drift.max() <= REL, (name, float(drift.max()))
        assert int(out.bn_state[name]["count"]) == int(ls["count"]) == 1
    # the head is the ANN head over the readout gain, scaled by α
    alpha, jalpha = out.report["head_scale_fit"], jout.report["head_scale_fit"]
    assert _rel(out.params["head"]["w"].numpy() / alpha, np.asarray(jout.params["head"]["w"])
                / jalpha) <= REL
    assert abs(alpha - jalpha) <= ALPHA_JIT_REL * abs(jalpha)

    # the plans' int8 weights: equal, or the port's weight on a rounding half
    plan = cplan.build_plan(out.params, out.cfg)
    jp = jplan.build_plan(jout.params, jout.cfg)
    for name, lp in plan.layers.items():
        if name == "head":
            continue
        a, b = lp.w_q.numpy(), np.asarray(jp.layers[name].w_q)
        diff = a != b
        if diff.any():
            q = out.params[name]["w"].numpy() / float(lp.scale)
            assert np.all(np.abs(np.abs(q[diff] - np.trunc(q[diff])) - 0.5) < 1e-4), name
            assert np.abs(a.astype(int) - b).max() <= 1, name

    rep, jrep = out.report, jout.report
    assert set(rep) == set(jrep)
    assert rep["convert_config"] == jrep["convert_config"]
    assert rep["source_arch_id"] == jrep["source_arch_id"]
    assert rep["calib_images"] == jrep["calib_images"] == 4
    assert rep["readout_scale"] == jrep["readout_scale"]
    assert set(rep["layers"]) == set(jrep["layers"])
    for name, info in rep["layers"].items():
        assert set(info) == set(jrep["layers"][name])
        for k, v in info.items():
            assert v == pytest.approx(jrep["layers"][name][k], rel=REL, abs=1e-30), (name, k)
    ps, jps = rep["plan_summary"], jrep["plan_summary"]
    assert set(ps) == set(jps) and ps["block_hw"] == jps["block_hw"]
    for name, info in ps["layers"].items():
        j = jps["layers"][name]
        assert set(info) == set(j) and info["shape"] == j["shape"]
        if name != "head":
            assert info["nnz"] == j["nnz"] and info["compressed_bytes"] == j["compressed_bytes"]
            assert info["scale"] == pytest.approx(j["scale"], rel=REL)
    json.dumps(rep)  # the sidecar is JSON


def _jax_eager_fit(jcfg, jparams, jbn, images, head_ann) -> float:
    """JAX's ``_fit_head_scale`` arithmetic with its forward run op by op
    (no jit, so no FMA contraction): the same dense plan, the same numpy
    reductions."""
    fit_cfg = dataclasses.replace(jcfg, conv_exec="dense")
    plan = jplan.build_plan(jparams, fit_cfg)
    head = np.asarray(jsy.forward(jparams, jbn, jnp.asarray(images), fit_cfg, train=False,
                                  plan=plan)[0])
    return float((head * head_ann).sum()) / float((head * head).sum())


def test_head_fit_matches_jax(anns, converted, calib_images):
    """α is bit-equal whenever the heads are: the port's fit on the port's
    emitted weights equals JAX's fit arithmetic on the same weights carried
    across, through JAX's forward run op by op."""
    ann, jann = anns
    out, jout = converted["synthetic"]
    jcfg = jout.cfg
    stats = cv.calibrate(ann, calib_images, batch=4, block_hw=(6, 10), device="cpu")
    p = {n: dict(v) for n, v in out.params.items()}
    p["head"] = {"w": out.params["head"]["w"] / out.report["head_scale_fit"]}
    alpha = emit._fit_head_scale(out.cfg, p, out.bn_state, calib_images, stats.head)
    jp = {n: {k: np.asarray(v.numpy()) for k, v in lp.items()} for n, lp in p.items()}
    jb = {n: {k: np.asarray(v.numpy()) for k, v in ls.items()} for n, ls in out.bn_state.items()}
    want = _jax_eager_fit(jcfg, jp, jb, calib_images, stats.head)
    assert alpha == want


@pytest.fixture(scope="module")
def jax_heads(converted):
    """JAX's converted detector on 2 val images: its forward run op by op
    (spikes and head), and the detections of its postprocess."""
    _, jout = converted["synthetic"]
    cfg = dataclasses.replace(jout.cfg, conv_exec="dense")
    images, _ = jdd.SyntheticSource().eval_set(2, hw=cfg.input_hw, grid_div=16)
    plan = jplan.build_plan(jout.params, cfg)
    head, _, aux = jsy.forward(jout.params, jout.bn_state, jnp.asarray(images), cfg,
                               train=False, plan=plan)
    dets = jpost.postprocess(head, jsy.DEFAULT_ANCHORS, score_threshold=0.01,
                             max_detections=64)
    return images, np.asarray(head), _np(aux["spikes"]), _np(dets._asdict())


@pytest.mark.parametrize("ex", ["dense", "pallas"])
def test_converted_heads_match_jax(converted, jax_heads, ex):
    _, jout = converted["synthetic"]
    images, jhead, jspikes, jdets = jax_heads
    p, b, _ = interop.params_from_numpy(_np(jout.params), _np(jout.bn_state), device="cpu")
    cfg = dataclasses.replace(sy.config_from_dict(jsy.config_to_dict(jout.cfg)), conv_exec=ex)
    det = harness.compile_eval_detector(cfg, p, b, device="cpu")
    dets, head = det.detect(torch.from_numpy(images))
    np.testing.assert_allclose(head.numpy(), jhead, atol=1e-5, rtol=0)
    with torch.no_grad():
        _, _, aux = sy.forward(det.params, det.bn_state, torch.from_numpy(images), cfg,
                               plan=det.plan, affines=det._affines)
    for name, want in jspikes.items():
        np.testing.assert_array_equal(aux["spikes"][name].float().numpy(), want, err_msg=name)
    assert float(aux["spikes"]["stage2"].float().mean()) > 0
    for f in ("valid", "classes"):
        np.testing.assert_array_equal(getattr(dets, f).numpy(), jdets[f], err_msg=f)
    np.testing.assert_allclose(dets.scores.numpy(), jdets["scores"], atol=1e-5, rtol=0)
    assert jdets["valid"].any()


# ------------------------------------------------------------ checkpoints --


def test_checkpoints_cross_packages(converted, tmp_path):
    out, jout = converted["synthetic"]
    # the port writes, JAX restores bit for bit and reads the report
    root = str(tmp_path / "port")
    out.save(root, step=3)
    jcfg, jp, jbn, step = jharness.restore_detector_checkpoint(root)
    assert step == 3 and jsy.config_to_dict(jcfg) == sy.config_to_dict(out.cfg)
    for name, lp in out.params.items():
        for k, v in lp.items():
            np.testing.assert_array_equal(np.asarray(jp[name][k]), v.numpy())
    for name, ls in out.bn_state.items():
        for k, v in ls.items():
            np.testing.assert_array_equal(np.asarray(jbn[name][k]), v.numpy())
    rep = json.loads(jckpt.read_extra_file(root, jcv.ConvertedDetector.REPORT_FILE))
    assert rep == json.loads(json.dumps(out.report))
    # JAX writes, the port restores bit for bit and reads the report
    jroot = str(tmp_path / "jax")
    jout.save(jroot)
    cfg, p, b, step = harness.restore_detector_checkpoint(jroot, device="cpu")
    assert step == 0 and sy.config_to_dict(cfg) == jsy.config_to_dict(jout.cfg)
    for name, lp in jout.params.items():
        for k, v in lp.items():
            np.testing.assert_array_equal(p[name][k].numpy(), np.asarray(v))
    for name, ls in jout.bn_state.items():
        for k, v in ls.items():
            np.testing.assert_array_equal(b[name][k].numpy(), np.asarray(v))
    blob = ckpt.read_extra_file(jroot, cv.ConvertedDetector.REPORT_FILE)
    assert json.loads(blob)["head_scale_fit"] == jout.report["head_scale_fit"]


# ------------------------------------------------------------------- CLIs --


def test_convert_cli_on_cpu_then_scored_and_served(tmp_path, monkeypatch):
    """``launch.convert --device cpu`` at tiny T exits with its mAP line;
    ``eval_map --checkpoint`` scores the checkpoint (synthetic and the COCO
    fixture), and the serve CLI's ``--eval-map`` gate holds on it, once on
    the COCO fixture (4 images for 6 requests: it serves all 4)."""
    from repro_torch.benchmarks import eval_map
    from repro_torch.launch import convert as convert_cli
    from repro_torch.launch import serve

    monkeypatch.chdir(tmp_path)
    out_dir = str(tmp_path / "conv")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = convert_cli.main(["--npz", FIXTURE, "--out", out_dir, "--full-t", "4",
                                "--calib-images", "4", "--eval-images", "4",
                                "--conv-exec", "pallas", "--device", "cpu"])
    text = buf.getvalue()
    assert re.search(r"converted mAP@0\.5 = \d\.\d{4} on 4 val images", text), text
    assert f"eval_map --checkpoint {out_dir}" in text and "--eval-map" in text
    assert res["converted"].cfg.conv_exec == "pallas" and res["converted"].cfg.full_t == 4
    for ds in ("synthetic", f"coco:{COCO}"):
        r = eval_map.main(["--checkpoint", out_dir, "--fast", "--dataset", ds,
                           "--device", "cpu"])
        assert r["config"]["dataset"] == ds and np.isfinite(r["map"])
        assert r["n_images"] == (4 if ds.startswith("coco") else 8)
        assert r["config"]["arch_id"] == "snn-det-eval-converted"
    assert sorted(os.listdir(tmp_path)) == ["BENCH_torch_eval_ckpt.json", "conv"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        done = serve.main(["--arch", "snn-det", "--checkpoint", out_dir, "--eval-map",
                           "--requests", "6", "--dataset", f"coco:{COCO}", "--device", "cpu"])
    text = buf.getvalue()
    assert len(done) == 4 and "serving all of them" in text
    assert re.search(r"harness parity: served .* — BIT-IDENTICAL", text), text


def test_convert_package_imports_no_jax():
    import subprocess
    import sys

    code = ("import sys; import repro_torch.convert, repro_torch.launch.convert; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'repro' or m.startswith('repro.')]; print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
