"""The port's training path against the JAX package on the same numpy
inputs: the surrogate spike and the STE, the YOLO loss, the ann/qnn/bnn
modes, one ``train_steps`` step at ``demo_config`` (spikes first, then loss,
gradients, parameters and tdBN state), AdamW with f32 and int8 moments,
pruning masks, the synthetic data, mAP, and the training launcher on the CPU.

Parameters and tdBN state are built by the JAX package and carried across
as numpy arrays (``interop.params_from_numpy``); images and targets come
from the synthetic generator, which both packages hold to the same crc32s.
Every tolerance is stated beside its check, and the measured worst error is
printed beside it."""
import dataclasses
import json
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import lif as jlif  # noqa: E402
from repro.core import pruning as jpruning  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.data import detection_datasets as jdd  # noqa: E402
from repro.data import synthetic_detection as jsd  # noqa: E402
from repro.eval import detection_map as jdm  # noqa: E402
from repro.eval import harness as jh  # noqa: E402
from repro.models import snn_yolo as jsy  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.core import lif  # noqa: E402
from repro_torch.core import pruning, quant  # noqa: E402
from repro_torch.data import detection_datasets as dd  # noqa: E402
from repro_torch.data import synthetic_detection as sd  # noqa: E402
from repro_torch.eval import detection_map as dm  # noqa: E402
from repro_torch.eval import harness  # noqa: E402
from repro_torch.launch import train_detector  # noqa: E402
from repro_torch.models import snn_yolo as sy  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402

BATCH = 2
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7  # × max|g_jax| per leaf, + atol
STATE_RTOL = 1e-6  # × max|x_jax| per leaf: updated params, tdBN state
# (a running mean × the leaf's max of |mean| and sqrt(var): a mean's f32
# rounding scales with the data it averages, and the batch means here are
# sums of O(1) drives that nearly cancel)
# Adam's first step moves an element by lr·ĝ/(|ĝ| + eps): where the clipped
# gradient ĝ is within a few eps of 0, an f32 difference of ~1e-7·max|g| in
# g changes that element's step by up to 2·lr. Parameters are held to
# STATE_RTOL where |ĝ| ≥ WELL_CONDITIONED (100·eps), and within 2·lr
# elsewhere; the optimizer on the same gradients is held to STATE_RTOL
# everywhere (test_apply_updates_on_jax_grads).
WELL_CONDITIONED = 100 * jopt.AdamWConfig().eps

_CHECKSUMS_PATH = os.path.join(os.path.dirname(__file__), "fixtures", "data_checksums.json")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _worst(a, b) -> float:
    """max |a − b| / max |a| (0 for an all-zero a equal to b)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = np.abs(a).max()
    err = np.abs(a - b).max()
    return float(err / scale) if scale else float(err)


# -------------------------------------------------------- surrogate and STE --


@pytest.mark.parametrize("threshold", [0.5, 0.0])
def test_spike_fn_surrogate_grad_exact(threshold):
    v = np.random.default_rng(0).uniform(-1.5, 2.0, (4, 64)).astype(np.float32)
    v[0, :4] = [threshold, threshold + 0.5, threshold - 0.5, threshold + 0.4999999]
    g = np.random.default_rng(1).standard_normal(v.shape).astype(np.float32)
    want_s, vjp = jax.vjp(lambda x: jlif.spike_fn(x, threshold), jnp.asarray(v))
    (want_g,) = vjp(jnp.asarray(g))
    x = _t(v).requires_grad_(True)
    s = lif.spike_fn(x, threshold)
    s.backward(_t(g))
    np.testing.assert_array_equal(s.detach().numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want_g))  # exact


@pytest.mark.parametrize("reset", ["hard", "soft", "none"])
def test_lif_over_time_grad_matches_jax(reset):
    """The gradient flows through the hard reset v·(1 − s) by way of the
    surrogate, as in JAX: within 1e-6 × max|g|."""
    x = np.random.default_rng(2).uniform(-0.5, 1.5, (5, 3, 16)).astype(np.float32)
    w = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    f = lambda a: jnp.sum(jlif.lif_over_time(a, reset=reset)[0] * w)  # noqa: E731
    want = np.asarray(jax.grad(f)(jnp.asarray(x)))
    xt = _t(x).requires_grad_(True)
    torch.sum(lif.lif_over_time(xt, reset=reset)[0] * _t(w)).backward()
    err = _worst(want, xt.grad.numpy())
    print(f"lif grad {reset}: worst {err:.2e} (bound 1e-6)")
    assert err <= 1e-6


def test_fake_quant_tensor_ste_exact():
    x = np.random.default_rng(4).standard_normal((3, 3, 8, 16)).astype(np.float32)
    g = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    want_y, vjp = jax.vjp(lambda a: jquant.fake_quant_tensor(a, 8), jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_(True)
    y = quant.fake_quant_tensor(xt, 8)
    y.backward(_t(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want_y))
    # the scale max|x|/127 carries no gradient: g passes straight through
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_g))
    np.testing.assert_array_equal(xt.grad.numpy(), g)


# ------------------------------------------------------------------- loss --


def test_yolo_loss_and_head_grad_match_jax():
    cfg = harness.demo_config()
    b = next(sd.batches(BATCH, hw=cfg.input_hw, steps=1, grid_div=harness.grid_div(cfg)))
    head = np.random.default_rng(6).standard_normal(b["target"].shape).astype(np.float32)
    want, want_g = jax.value_and_grad(jsy.yolo_loss)(jnp.asarray(head), jnp.asarray(b["target"]))
    ht = _t(head).requires_grad_(True)
    loss = sy.yolo_loss(ht, _t(b["target"]))
    loss.backward()
    lerr = abs(float(loss.detach()) - float(want)) / abs(float(want))
    gerr = np.max(np.abs(ht.grad.numpy() - np.asarray(want_g)) / (np.abs(np.asarray(want_g))
                                                                  + 1e-30))
    print(f"yolo_loss: rel {lerr:.2e} (bound 1e-6); head grad worst rel {gerr:.2e} (bound 1e-5)")
    assert lerr <= 1e-6
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=0)


# ------------------------------------------------------------------ modes --


def _small_cfg(**kw):
    return dataclasses.replace(
        harness.demo_config(), input_hw=(32, 48), stem_channels=4, conv_block_channels=8,
        stage_channels=((8, 8), (8, 16)), pooled_stages=2, block_hw=(4, 6), **kw)


@pytest.fixture(scope="module")
def small_inputs():
    cfg = _small_cfg()
    params, bn = jsy.init_params(jax.random.PRNGKey(1), cfg)
    imgs = np.random.default_rng(7).uniform(0, 1, (BATCH, *cfg.input_hw, 3)).astype(np.float32)
    return params, bn, imgs


# per-layer activation bounds, × max|a_jax| (binary activations: exact).
# The ann bound is 1e-5: its real-valued activations carry f32 sums taken
# in another order through train-mode tdBN layer after layer (measured up
# to 3.5e-6 four layers deep); the quantized qnn activations stay within
# 1e-6 (measured ≤ 3.1e-7).
MODE_BOUNDS = {"ann": 1e-5, "qnn": 1e-6, "bnn": 0.0}


@pytest.mark.parametrize("mode,train", [("ann", True), ("qnn", True), ("bnn", True),
                                        ("ann", False)])
def test_mode_forward_matches_jax(small_inputs, mode, train):
    """Each macro layer's activations and the head against JAX's."""
    params, bn, imgs = small_inputs
    cfg = _small_cfg(mode=mode)
    want, want_bn, want_aux = jsy.forward(params, bn, jnp.asarray(imgs), cfg, train=train)
    p, b, _ = interop.params_from_numpy(_np(params), _np(bn), device="cpu")
    head, new_bn, aux = sy.forward(p, b, _t(imgs), cfg, train=train)
    bound = MODE_BOUNDS[mode] if train else 1e-6
    for name, a in want_aux["spikes"].items():
        a, got = np.asarray(a), aux["spikes"][name].detach().numpy()
        assert got.shape == a.shape, name
        err = _worst(a, got)
        print(f"{mode} train={train} {name}: worst {err:.2e} (bound {bound:g})")
        assert err <= bound, name
    err = _worst(np.asarray(want), head.detach().numpy())
    print(f"{mode} train={train} head: worst {err:.2e} (bound 1e-5)")
    assert err <= 1e-5
    if train:
        for name, st in _np(want_bn).items():
            assert _worst(st["var"], new_bn[name]["var"].numpy()) <= 1e-5


def _activate_np(y, cfg):
    """The mode's activation of a tdBN output, and each element's distance
    from its decision boundary (the threshold 0, or a rounding tie)."""
    if cfg.mode == "bnn":
        return (y >= 0).astype(np.float32), np.abs(y) / np.abs(y).max()
    act = np.maximum(y, 0)
    scale = np.float32(max(act.max(), 1e-6) / (2**cfg.act_bits - 1))
    r = act / scale
    return np.round(r), np.abs(r - np.floor(r) - 0.5)


@pytest.mark.parametrize("mode", ["qnn", "bnn"])
def test_mode_eval_activations_differ_only_at_ties(small_inputs, mode):
    """Eval mode with fresh tdBN statistics: a drive can land exactly on a
    decision boundary (an exact 0 for bnn's sign, a half-integer for qnn's
    rounding), where f32 sums in another order decide the activation. The
    drives (``taps=``) are compared layer by layer up to the first layer
    whose activations differ: drives within 1e-6 × max, and every differing
    activation there has JAX's drive within 1e-6 of the boundary. Layers
    past it see other inputs and are not compared."""
    params, bn, imgs = small_inputs
    cfg = _small_cfg(mode=mode)
    jt, tt = {}, {}
    jsy.forward(params, bn, jnp.asarray(imgs), cfg, taps=jt)
    p, b, _ = interop.params_from_numpy(_np(params), _np(bn), device="cpu")
    sy.forward(p, b, _t(imgs), cfg, taps=tt)
    for name in jt:
        if name == "head":
            break
        y, got = np.asarray(jt[name]), tt[name].numpy()
        err = _worst(y, got)
        assert err <= 1e-6, f"{name}: drive worst {err:.2e}"
        a, dist = _activate_np(y, cfg)
        a_port, _ = _activate_np(got, cfg)
        diff = a != a_port
        if diff.any():
            print(f"{mode} eval: first differing activations at {name}: {int(diff.sum())} of "
                  f"{diff.size}, JAX's drive at most {dist[diff].max():.1e} from the boundary "
                  "(bound 1e-6)")
            assert dist[diff].max() <= 1e-6
            break


def test_compressed_executor_refuses_other_modes(small_inputs):
    params, bn, imgs = small_inputs
    p, b, _ = interop.params_from_numpy(_np(params), _np(bn), device="cpu")
    with pytest.raises(ValueError, match="requires mode='snn'"):
        sy.forward(p, b, _t(imgs), _small_cfg(mode="ann", conv_exec="gated"), plan=object())


def test_param_count_matches_jax(small_inputs):
    params, bn, _ = small_inputs
    p, _, _ = interop.params_from_numpy(_np(params), _np(bn), device="cpu")
    assert sy.param_count(p) == jsy.param_count(params)


# --------------------------------------------------------- one train step --


@pytest.fixture(scope="module")
def step_inputs():
    """JAX's initial params and bn at demo_config, the first train batch,
    and JAX's loss, gradients, spikes and new bn on it (jitted)."""
    cfg = jh.demo_config()
    params, bn = jsy.init_params(jax.random.PRNGKey(0), cfg)
    batch = next(jsd.batches(BATCH, hw=cfg.input_hw, steps=1, grid_div=jh.grid_div(cfg)))

    def loss_fn(p, b):
        head, new_bn, aux = jsy.forward(p, b, jnp.asarray(batch["image"]), cfg, train=True)
        return jsy.yolo_loss(head, jnp.asarray(batch["target"])), (new_bn, aux["spikes"])

    (loss, (new_bn, spikes)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, bn)
    return dict(cfg=cfg, params=params, bn=bn, batch=batch, loss=float(loss),
                grads=_np(grads), new_bn=_np(new_bn), spikes=_np(spikes))


def _port_state(inp):
    p, b, _ = interop.params_from_numpy(_np(inp["params"]), _np(inp["bn"]), device="cpu")
    return p, b


def test_train_step_spikes_loss_grads_match_jax(step_inputs):
    inp = step_inputs
    p, b = _port_state(inp)
    imgs, tgts = _t(inp["batch"]["image"]), _t(inp["batch"]["target"])
    with sy._no_tf32():
        loss, grads, new_bn, aux = harness.loss_and_grads(harness.demo_config(), p, b, imgs,
                                                          tgts)
    # spikes first: a flipped spike would move gradients by O(1/W)
    for name, want in inp["spikes"].items():
        got = aux["spikes"][name].detach().numpy()
        flips = int((got != want).sum())
        assert flips == 0, f"{flips} spikes of {want.size} flipped in layer {name}"
    lerr = abs(float(loss) - inp["loss"]) / abs(inp["loss"])
    print(f"loss: rel {lerr:.2e} (bound {LOSS_RTOL})")
    assert lerr <= LOSS_RTOL
    worst = 0.0
    for name, layer in inp["grads"].items():
        for k, want in layer.items():
            got = grads[name][k].numpy()
            bound = GRAD_RTOL * np.abs(want).max() + GRAD_ATOL
            err = float(np.abs(got - want).max())
            worst = max(worst, err / bound)
            assert err <= bound, f"grad {name}/{k}: |Δ| {err:.3e} > {bound:.3e}"
    print(f"grads: worst |Δ| / bound {worst:.3f} (bound 1e-4·max|g| + 1e-7)")
    bn_worst = 0.0
    for name, st in inp["new_bn"].items():
        assert new_bn[name]["count"].dtype == torch.int32
        assert int(new_bn[name]["count"]) == int(st["count"])
        for k in ("mean", "var"):
            assert not new_bn[name][k].requires_grad  # no autograd history kept
        err = _bn_worst(st, new_bn[name])
        bn_worst = max(bn_worst, err)
        assert err <= STATE_RTOL, f"bn {name}: {err:.2e}"
    print(f"new bn: worst rel {bn_worst:.2e} (bound {STATE_RTOL})")


def _bn_worst(want: dict, got: dict) -> float:
    """Worst error of a new tdBN state: var × max|var|, mean × the larger
    of max|mean| and max sqrt(var) (STATE_RTOL's note)."""
    mean, var = np.asarray(want["mean"]), np.asarray(want["var"])
    scale = max(np.abs(mean).max(), np.sqrt(var).max())
    return max(float(np.abs(got["mean"].numpy() - mean).max() / scale),
               _worst(var, got["var"].numpy()))


def _clipped_grads(grads, grad_clip, mask=None):
    """|ĝ|: the gradients as the step applies them (masked, then clipped)."""
    if mask is not None:
        grads = tu.tree_map(lambda g, m: g * np.asarray(m), grads, mask)
    gnorm = np.sqrt(sum(np.sum(np.square(g, dtype=np.float64)) for g in tu.leaves(grads)))
    clip = min(1.0, grad_clip / max(gnorm, 1e-12))
    return tu.tree_map(lambda g: np.abs(g) * clip, grads)


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "grad_mask"])
def test_train_steps_one_step_matches_jax(step_inputs, masked):
    """``train_steps(steps=1)`` from the same params, bn and batch: loss
    within LOSS_RTOL, new bn within STATE_RTOL, parameters as the module
    docstring's Adam note says; with ``grad_mask``, masked entries are
    exactly 0 after the step on both sides."""
    inp = step_inputs
    cfg = inp["cfg"]
    jmask = jpruning.mask_tree(inp["params"], 0.8) if masked else None
    jp, jbn, jo, jl = jh.train_steps(cfg, steps=1, batch=BATCH, params=inp["params"],
                                     bn=inp["bn"], grad_mask=jmask, verbose=False)
    p, b = _port_state(inp)
    mask = pruning.mask_tree(p, 0.8) if masked else None
    tp, tbn, to, tl = harness.train_steps(harness.demo_config(), steps=1, batch=BATCH,
                                          params=p, bn=b, grad_mask=mask, verbose=False)
    lerr = abs(tl[0] - jl[0]) / abs(jl[0])
    print(f"loss: rel {lerr:.2e} (bound {LOSS_RTOL})")
    assert lerr <= LOSS_RTOL
    assert to.step.dtype == torch.int32 and int(to.step) == int(jo.step) == 1
    ocfg = jh_ocfg(1)
    lr = float(jopt.lr_schedule(ocfg, jnp.int32(1)))
    gabs = _clipped_grads(inp["grads"], ocfg.grad_clip, jmask)
    worst = 0.0
    for name, layer in _np(jp).items():
        for k, want in layer.items():
            got = tp[name][k].numpy()
            tol = np.where(gabs[name][k] >= WELL_CONDITIONED,
                           STATE_RTOL * np.abs(want).max(), 2 * lr + STATE_RTOL)
            err = np.abs(got - want)
            ok = err <= tol
            assert ok.all(), f"param {name}/{k}: {int((~ok).sum())} elements off"
            well = gabs[name][k] >= WELL_CONDITIONED
            if well.any():
                worst = max(worst, float(err[well].max() / np.abs(want).max()))
            if masked:
                zero = np.asarray(jmask[name][k]) == 0
                assert (got[zero] == 0).all() and (want[zero] == 0).all()
    print(f"params (|ĝ| ≥ {WELL_CONDITIONED:g}): worst rel {worst:.2e} (bound {STATE_RTOL})")
    bn_worst = max(_bn_worst(st, tbn[name]) for name, st in _np(jbn).items())
    print(f"new bn: worst rel {bn_worst:.2e} (bound {STATE_RTOL})")
    assert bn_worst <= STATE_RTOL


def jh_ocfg(steps):
    """The optimizer settings JAX's ``harness.train_steps`` builds."""
    return jopt.AdamWConfig(lr_peak=2e-3, lr_init=2e-4, lr_final=2e-5,
                            warmup_steps=max(steps // 15, 1), total_steps=steps,
                            weight_decay=1e-3)


def test_train_config_matches_jax():
    for steps in (1, 30, 300):
        assert tuple(harness.train_config(steps)) == tuple(jh_ocfg(steps))


def test_apply_updates_on_jax_grads(step_inputs):
    """The optimizer alone, on JAX's gradients: every updated parameter
    within STATE_RTOL × max|p| of JAX's."""
    inp = step_inputs
    ocfg = jh_ocfg(1)
    jp, _ = jax.jit(jopt.apply_updates, static_argnums=3)(
        inp["params"], jax.tree_util.tree_map(jnp.asarray, inp["grads"]),
        jopt.init_state(inp["params"], ocfg), ocfg)
    p, _ = _port_state(inp)
    grads = tu.tree_map(_t, inp["grads"])
    tp, _ = opt.apply_updates(p, grads, opt.init_state(p, opt.AdamWConfig(**ocfg._asdict())),
                              opt.AdamWConfig(**ocfg._asdict()))
    worst = max(_worst(w, tp[n][k].numpy()) for n, l in _np(jp).items() for k, w in l.items())
    print(f"apply_updates on JAX's grads: worst rel {worst:.2e} (bound {STATE_RTOL})")
    assert worst <= STATE_RTOL


# -------------------------------------------------------------- optimizer --


def test_lr_schedule_every_step():
    """Warmup steps exact; decay steps within 1.2e-7 × (lr_peak − lr_final):
    the f32 cosine may round one ulp apart (XLA's and torch's), and the
    schedule scales it by the cosine's amplitude."""
    ocfg = jopt.AdamWConfig(lr_peak=2e-3, lr_init=2e-4, lr_final=2e-5, warmup_steps=5,
                            total_steps=20)
    tcfg = opt.AdamWConfig(**ocfg._asdict())
    bound = 1.2e-7 * (ocfg.lr_peak - ocfg.lr_final)
    worst = 0.0
    for step in range(25):
        want = np.float32(jopt.lr_schedule(ocfg, jnp.int32(step)))
        got = opt.lr_schedule(tcfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        if step < ocfg.warmup_steps:
            assert got.numpy() == want, step
        worst = max(worst, abs(float(got) - float(want)))
    print(f"lr_schedule: worst |Δ| {worst:.2e} (bound {bound:.2e})")
    assert worst <= bound


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.standard_normal((3, 3, 4, 8)).astype(np.float32)},
            "b": rng.standard_normal((8,)).astype(np.float32),
            "s": np.float32(rng.standard_normal())}


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_apply_updates_three_steps_match_jax(int8):
    ocfg = jopt.AdamWConfig(lr_peak=1e-2, lr_init=1e-3, warmup_steps=2, total_steps=10,
                            int8_moments=int8)
    tcfg = opt.AdamWConfig(**ocfg._asdict())
    params = _opt_tree(0)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init_state(jp, ocfg)
    tp = tu.tree_map(_t, params)
    ts = opt.init_state(tp, tcfg)
    for k in range(3):
        g = _opt_tree(10 + k)
        jp, js = jopt.apply_updates(jp, jax.tree_util.tree_map(jnp.asarray, g), js, ocfg)
        tp, ts = opt.apply_updates(tp, tu.tree_map(_t, g), ts, tcfg)
    assert int(ts.step) == int(js.step) == 3 and ts.step.dtype == torch.int32
    worst = max(_worst(a, b.numpy()) for a, b in
                zip(jax.tree_util.tree_leaves(jp), tu.leaves(tp)))
    print(f"params after 3 steps ({'int8' if int8 else 'f32'}): worst rel {worst:.2e} "
          f"(bound {STATE_RTOL})")
    assert worst <= STATE_RTOL
    jm = jax.tree_util.tree_leaves(js.m)
    tm = tu.leaves(ts.m)
    assert [np.asarray(a).dtype for a in jm] == [b.numpy().dtype for b in tm]
    for a, b in zip(jm + jax.tree_util.tree_leaves(js.v), tm + tu.leaves(ts.v)):
        if np.asarray(a).dtype == np.int8:  # a payload may round the other way by 1
            assert np.abs(np.asarray(a, np.int32) - b.numpy().astype(np.int32)).max() <= 1
        else:
            assert _worst(a, b.numpy()) <= 1e-5


def test_q8_codec_and_compress_decompress_match_jax():
    x = np.random.default_rng(8).standard_normal((6, 33)).astype(np.float32) * 3
    res = np.random.default_rng(9).standard_normal((6, 33)).astype(np.float32) * 0.01
    for arr in (x, x[0, 0]):
        jq, js = jopt._q8_pack(jnp.asarray(arr))
        tq, ts = opt._q8_pack(_t(arr))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(opt._q8_unpack(tq, ts).numpy(),
                                      np.asarray(jopt._q8_unpack(jq, js)))
    jh_, jr = jopt.compress_decompress(jnp.asarray(x), jnp.asarray(res))
    th, tr = opt.compress_decompress(_t(x), _t(res))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh_))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    ef = opt.ef_init(tu.tree_map(_t, _opt_tree(0)))
    assert all(not r.any() for r in tu.leaves(ef.residual))


# ---------------------------------------------------------------- pruning --


def test_mask_tree_density_and_report_match_jax(small_inputs):
    params, bn, _ = small_inputs
    p, _, _ = interop.params_from_numpy(_np(params), _np(bn), device="cpu")
    jmask = _np(jpruning.mask_tree(params, 0.8))
    tmask = pruning.mask_tree(p, 0.8)
    for name, layer in jmask.items():
        for k, m in layer.items():
            np.testing.assert_array_equal(tmask[name][k].numpy(), m)
    jpr = jpruning.prune_tree(params, 0.8)
    tpr = pruning.prune_tree(p, 0.8)
    w = tpr["stage0/main_a"]["w"]
    assert pruning.density(w) == jpruning.density(jpr["stage0/main_a"]["w"])
    assert pruning.tree_sparsity_report(tpr) == jpruning.tree_sparsity_report(jpr)


# ------------------------------------------------------------------- data --


def test_synthetic_source_batches_bit_equal_to_jax():
    kw = dict(hw=(96, 160), steps=2, grid_div=16, start_index=3, host_id=1, n_hosts=2)
    src = dd.parse_dataset_spec("synthetic")
    assert isinstance(src, dd.DetectionSource)
    for got, want in zip(src.batches(3, **kw), jsd.batches(3, **kw)):
        for k in ("image", "target"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    imgs, gts = src.eval_set(3, hw=(96, 160), grid_div=16)
    jimgs, jgts = jsd.eval_set(3, hw=(96, 160), grid_div=16)
    np.testing.assert_array_equal(imgs, jimgs)
    for a, b in zip(gts, jgts):
        np.testing.assert_array_equal(a["boxes"], b["boxes"])
        np.testing.assert_array_equal(a["classes"], b["classes"])


def test_synthetic_samples_match_pinned_checksums():
    with open(_CHECKSUMS_PATH) as f:
        pins = json.load(f)
    for s in pins["samples"]:
        img, tgt, _ = sd.sample(s["index"], split=s["split"], hw=tuple(pins["hw"]),
                                grid_div=pins["grid_div"])
        assert zlib.crc32(np.ascontiguousarray(img).tobytes()) == s["image_crc32"]
        assert zlib.crc32(np.ascontiguousarray(tgt).tobytes()) == s["target_crc32"]


@pytest.mark.parametrize("spec", ["coco:instances.json", "voc:/data", "imagenet"])
def test_unported_dataset_specs_raise(spec, tmp_path, monkeypatch):
    """The COCO and VOC specs are ported now: a spec naming no annotations
    raises what the JAX package raises (the file or directory is missing),
    and an unknown kind raises its ValueError."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises((OSError, ValueError)) as jerr:
        jdd.parse_dataset_spec(spec)
    with pytest.raises(type(jerr.value)) as err:
        dd.parse_dataset_spec(spec)
    assert str(err.value) == str(jerr.value)


# ------------------------------------------------------------- evaluation --


def test_detection_map_matches_jax():
    rng = np.random.default_rng(10)
    _, gts = sd.eval_set(6, hw=(96, 160), grid_div=16)
    preds = []
    for gt in gts:
        n = int(rng.integers(0, 9))
        boxes = np.concatenate([gt["boxes"] + rng.normal(0, 0.01, gt["boxes"].shape),
                                rng.uniform(0.05, 0.5, (n, 4))]).astype(np.float32)
        preds.append({"boxes": boxes,
                      "scores": rng.uniform(0, 1, len(boxes)).astype(np.float32),
                      "classes": rng.integers(0, 3, len(boxes))})
    got = dm.evaluate_detections(preds, gts, num_classes=3)
    want = jdm.evaluate_detections(preds, gts, num_classes=3)
    assert got["map"] == want["map"] and 0 < got["map"] < 1
    for k in ("per_class_ap", "n_gt", "n_pred", "n_images", "iou_threshold"):
        assert got[k] == want[k], k
    assert dm.map50(preds, gts, num_classes=3) == jdm.map50(preds, gts, num_classes=3)


def test_evaluate_detector_sharded_raises():
    """``sharded=2`` scores as one shard does; a forced card gather without
    the cards raises, naming the devices."""
    from repro_torch.eval import sharded as se

    cfg = _small_cfg()
    params, bn = sy.init_params(cfg, device="cpu")
    det = harness.compile_eval_detector(cfg, params, bn, device="cpu")
    r = harness.evaluate_detector(det, n_images=2, batch=1)
    assert r["n_images"] == 2 and r["split"] == "val"
    got = harness.evaluate_detector(det, n_images=2, sharded=2)
    assert got["n_shards"] == 2 and got["split"] == "val" and se.reports_identical(got, r)
    with pytest.raises(ValueError, match="devices"):
        harness.evaluate_detector(det, n_images=2, sharded=se.ShardedEvalConfig(
            n_shards=2, use_device_mesh=True))


# -------------------------------------------------------------------- CLI --


def test_train_detector_cli_on_cpu(tmp_path, capsys):
    out = train_detector.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                               "--eval-images", "2", "--ckpt", str(tmp_path)])
    text = capsys.readouterr().out
    assert "train_detector OK" in text and "mAP@0.5 [pruned+quant]" in text
    assert len(out["losses"]) == 3 and out["losses"][-1] < out["losses"][0]
    assert 0.25 < out["sparsity"]["kept_frac"] < 0.4
    assert torch.isfinite(out["head"]).all()
    cfg, params, bn, step = harness.restore_detector_checkpoint(out["detector_ckpt"],
                                                                device="cpu")
    assert step == 3 and cfg == harness.demo_config()
    assert (tmp_path / "heartbeat.json").exists()
    with pytest.raises(SystemExit):  # the train state is complete: nothing left to run
        train_detector.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                             "--eval-images", "2", "--ckpt", str(tmp_path)])


def test_train_detector_defaults_to_the_card(tmp_path):
    """Without ``--device`` the launcher asks for the card and raises where
    there is none; nothing falls back to the CPU."""
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train_detector", "--steps", "1",
         "--ckpt", str(tmp_path)],
        env={**os.environ, "PYTHONPATH": src, "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "no CUDA device" in r.stderr, r.stdout + r.stderr
