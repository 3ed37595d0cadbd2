"""The port's LM training path against the JAX package on the CPU, at
``smoke_config`` (f32) of qwen1.5-0.5b (dense, QKV bias, tied embeddings)
and olmoe-1b-7b (MoE top-2 of 8): the ``lm_data`` pipeline, the loss, one
``make_train_step`` step (microbatches, int8 error-feedback gradient
compression, int8 moments), the torch mirrors of ``tests/test_train.py``,
remat, the ``launch.train`` CLI and train-state checkpoints read across the
two packages.

JAX builds the parameters and states; they cross as numpy arrays
(``interop.train_state_from_numpy``). JAX's train step runs jitted, as its
own tests run it. Tolerances, each against JAX's value:

* batches: bit-equal; checkpoints restored across packages: bit-equal;
* ``cross_entropy`` and ``loss_fn``: CE_RTOL relative;
* one train step: the loss LOSS_RTOL relative, the gradient norm
  GNORM_RTOL relative, every gradient leaf within GRAD_TOL of its largest
  |g|, f32 moments MOMENT_TOL of the leaf's largest |m| (int8 payloads
  within 1, their scales MOMENT_TOL relative), the error-feedback residual
  within GRAD_TOL of the leaf's largest |g|; per R9 (ROADMAP §3) an element
  whose compression payload rounds the other way (found by compressing each
  package's own gradients; at most 1e-4 of the elements) is off by one
  quantum (max |g| of its row / 127) in its applied gradient, so its
  residual is held to one quantum and its moments are not compared;
* parameters per R6 (ROADMAP §3): STATE_RTOL of the leaf's largest |p|
  where the applied gradient |ĝ| ≥ 100·eps, within 2·lr elsewhere — eps the
  update's own (1e-8, or 1e-5 with int8 moments); per R8 a leaf that starts
  at 0 (the QKV biases) is the update itself after one step, and its
  threshold is 1e4·eps.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import lm_data as jlm_data  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.data import lm_data  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import ft  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

ARCHS = ["qwen1.5-0.5b", "olmoe-1b-7b"]
BATCH, SEQ = 8, 16
CE_RTOL = 1e-6
LOSS_RTOL = 1e-5
GNORM_RTOL = 1e-5
GRAD_TOL = 1e-5  # × the leaf's largest |g|
MOMENT_TOL = 1e-5
STATE_RTOL = 1e-6
R6_FACTOR, R8_FACTOR = 100, 1e4  # × eps: the well-conditioned |ĝ|
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _ocfg(int8=False, **kw):
    """JAX's test_train settings, and the port's copy."""
    j = jopt.AdamWConfig(warmup_steps=2, total_steps=20, int8_moments=int8, **kw)
    return j, opt.AdamWConfig(**j._asdict())


@functools.lru_cache(maxsize=None)
def _jax_model(arch):
    """(JAX config, api, params, jitted value_and_grad): built once per arch."""
    jcfg = jconfigs.smoke_config(jconfigs.get_config(arch))
    japi = jzoo.get_api(jcfg)
    return jcfg, japi, japi.init_params(jax.random.PRNGKey(0)), jax.jit(
        jax.value_and_grad(japi.loss_fn))


@functools.lru_cache(maxsize=None)
def _jax_step(arch, n_mb=1, gc=False, int8=False):
    """JAX's jitted train step, compiled once per case and arch."""
    _, japi, _, _ = _jax_model(arch)
    return jax.jit(jtrainer.make_train_step(japi.loss_fn, _ocfg(int8)[0], n_microbatch=n_mb,
                                            grad_compress=gc))


def _port_model(arch, **kw):
    cfg = dataclasses.replace(configs.smoke_config(configs.get_config(arch)), **kw)
    return cfg, zoo.get_api(cfg)


def _batch(cfg, step=0, batch=BATCH, seq=SEQ):
    return lm_data.batch_at(step, batch_size=batch, seq_len=seq, vocab=cfg.vocab_size)


def _rel(got, want) -> float:
    return abs(float(got) - float(want)) / abs(float(want))


def _leaf_err(want, got) -> float:
    """max |Δ| / max |want| of one leaf."""
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    assert want.shape == got.shape
    scale = np.abs(want).max()
    err = np.abs(want - got).max()
    return float(err / scale) if scale else float(err)


# ------------------------------------------------------------------ lm_data --


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("host_id,n_hosts", [(0, 1), (1, 2), (3, 4)])
@pytest.mark.parametrize("step", [0, 5])
def test_batch_at_bit_equal_to_jax(step, host_id, n_hosts, split, seed):
    kw = dict(batch_size=4, seq_len=24, vocab=50_304, seed=seed, split=split,
              host_id=host_id, n_hosts=n_hosts)
    got, want = lm_data.batch_at(step, **kw), jlm_data.batch_at(step, **kw)
    for k in ("tokens", "labels"):
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def _stream_threads():
    return [t for t in threading.enumerate() if t.name == "lm_data.stream"]


def test_stream_yields_batch_at_from_start_step_and_its_thread_ends():
    kw = dict(batch_size=2, seq_len=8, vocab=256, seed=3)
    got = list(lm_data.stream(start_step=5, steps=4, **kw))
    want = list(jlm_data.stream(start_step=5, steps=4, **kw))
    assert len(got) == len(want) == 4
    for t, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g["tokens"], lm_data.batch_at(5 + t, **kw)["tokens"])
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(g[k], w[k])
    assert not _stream_threads()  # exhausted: the producer was joined
    s = lm_data.stream(start_step=0, **kw)  # endless, closed after one batch
    np.testing.assert_array_equal(next(s)["tokens"], lm_data.batch_at(0, **kw)["tokens"])
    s.close()
    assert not _stream_threads()


# ---------------------------------------------------------------------- loss --


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 97)) * 4).astype(np.float32)
    labels = rng.integers(0, 97, (3, 7)).astype(np.int32)
    want = float(JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    got = L.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    assert got.dtype == torch.float32
    err = _rel(got, want)
    print(f"cross_entropy: rel {err:.2e} (bound {CE_RTOL})")
    assert err <= CE_RTOL


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_matches_jax(arch):
    _, _, jp, vg = _jax_model(arch)
    cfg, api = _port_model(arch)
    b = _batch(cfg)
    want = float(vg(jp, jax.tree_util.tree_map(jnp.asarray, b))[0])
    p = interop.lm_params_from_numpy(_np(jp), cfg, device="cpu")
    with torch.no_grad():
        got = api.loss_fn(p, _torch_batch(b))
    err = _rel(got, want)
    print(f"{arch} loss_fn: rel {err:.2e} (bound {CE_RTOL})")
    assert err <= CE_RTOL


def test_loss_fn_with_extra_embeds_matches_jax():
    """A ``batch["extra_embeds"]`` prefix (B, 5, D), prepended and scored
    nowhere (``transformer.py``'s modality prefix), against JAX's loss."""
    _, japi, jp, _ = _jax_model("qwen1.5-0.5b")
    cfg, api = _port_model("qwen1.5-0.5b")
    b = dict(_batch(cfg))
    b["extra_embeds"] = np.random.default_rng(7).standard_normal(
        (BATCH, 5, cfg.d_model)).astype(np.float32)
    want = float(japi.loss_fn(jp, jax.tree_util.tree_map(jnp.asarray, b)))
    p = interop.lm_params_from_numpy(_np(jp), cfg, device="cpu")
    with torch.no_grad():
        got = api.loss_fn(p, _torch_batch(b))
    err = _rel(got, want)
    print(f"loss_fn with extra_embeds: rel {err:.2e} (bound {CE_RTOL})")
    assert err <= CE_RTOL


# ------------------------------------------------------------ one train step --


def _jax_grads(arch, b, n_mb):
    """JAX's gradients as its train step forms them: value_and_grad, or the
    f32 sum over microbatches divided by their count."""
    _, _, jp, vg = _jax_model(arch)
    jb = jax.tree_util.tree_map(jnp.asarray, b)
    if n_mb == 1:
        return vg(jp, jb)[1]
    acc = None
    for i in range(n_mb):
        mb = jax.tree_util.tree_map(lambda x: x.reshape(n_mb, -1, *x.shape[1:])[i], jb)
        g = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), vg(jp, mb)[1])
        acc = g if acc is None else jax.tree_util.tree_map(jnp.add, acc, g)
    return jax.tree_util.tree_map(lambda g: g / n_mb, acc)


def _applied(grads, gc: bool, clip_norm: float):
    """|ĝ| of each element: the gradient the update applies (compressed
    with a zero residual under ``gc``), clipped."""
    if gc:
        grads = jax.tree_util.tree_map(
            lambda g: jopt.compress_decompress(g, jnp.zeros_like(g))[0], grads)
    gnorm = float(jopt.global_norm(grads))
    clip = min(1.0, clip_norm / max(gnorm, 1e-12))
    return jax.tree_util.tree_map(lambda g: np.abs(np.asarray(g)) * clip, grads)


def _check_params(jparams0, jparams, tparams, gabs, lr, eps):
    """R6, with R8 for leaves that start at 0; returns the worst relative
    error over the well-conditioned elements."""
    worst = 0.0
    flat = jax.tree_util.tree_flatten_with_path(_np(jparams))[0]
    for (path, want), p0, got, ga in zip(flat, jax.tree_util.tree_leaves(_np(jparams0)),
                                         tu.leaves(tparams), jax.tree_util.tree_leaves(gabs)):
        got = got.numpy()
        factor = R8_FACTOR if not np.any(p0) else R6_FACTOR
        well = ga >= factor * eps
        scale = np.abs(want).max()
        tol = np.where(well, STATE_RTOL * scale, 2 * lr + STATE_RTOL * scale)
        err = np.abs(got.astype(np.float64) - want)
        off = err > tol
        assert not off.any(), (f"param {jax.tree_util.keystr(path)}: {int(off.sum())} "
                               f"elements off, worst {float(err.max()):.3e}")
        if well.any():
            worst = max(worst, float(err[well].max() / scale))
    return worst


def _payload_flips(jgrads, tgrads) -> list:
    """Per leaf, where the int8 compression payloads of the two packages'
    gradients differ (R9: x/scale within an f32 difference of a rounding
    half)."""
    return [np.asarray(jopt._q8_pack(j)[0]) != opt._q8_pack(t)[0].numpy()
            for j, t in zip(jax.tree_util.tree_leaves(jgrads), tu.leaves(tgrads))]


def _check_moments(jopt_state, topt_state, flips):
    """Moments away from R9's flipped elements (a flip moves an element's
    applied gradient, and so its moments, by one quantum)."""
    is_q8 = lambda x: isinstance(x, jopt.Q8Leaf)  # noqa: E731
    for f in ("m", "v"):
        jl = jax.tree_util.tree_leaves(getattr(jopt_state, f), is_leaf=is_q8)
        tl = tu.leaves(getattr(topt_state, f), is_leaf=lambda x: isinstance(x, opt.Q8Leaf))
        for j, t, flip in zip(jl, tl, flips):
            keep = ~flip
            if is_q8(j):
                dq = np.abs(np.asarray(j.q, np.int32) - t.q.numpy().astype(np.int32))
                assert dq[keep].max() <= 1 and t.q.dtype == torch.int8
                assert _leaf_err(j.scale, t.scale.numpy()) <= MOMENT_TOL
            else:
                want, got = np.asarray(j), t.numpy()
                err = np.abs(got[keep] - want[keep]).max() if keep.any() else 0.0
                assert err <= MOMENT_TOL * np.abs(want).max()


@pytest.mark.parametrize("int8", [False, True], ids=["f32m", "int8m"])
@pytest.mark.parametrize("gc", [False, True], ids=["nogc", "gc"])
@pytest.mark.parametrize("n_mb", [1, 4], ids=["mb1", "mb4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, n_mb, gc, int8):
    """One ``make_train_step`` step from the same carried-across state and
    ``batch_at`` batch: loss, gradient norm, lr and step, the gradients,
    the new parameters, moments and error-feedback residual."""
    _, japi, jp, _ = _jax_model(arch)
    cfg, api = _port_model(arch)
    jo, to = _ocfg(int8)
    b = _batch(cfg)
    js = jtrainer.init_train_state(jp, jo, grad_compress=gc)
    jnew, jm = _jax_step(arch, n_mb, gc, int8)(js, jax.tree_util.tree_map(jnp.asarray, b))

    state = interop.train_state_from_numpy(_np(js), cfg, device="cpu")
    tb = _torch_batch(b)
    loss, grads = trainer.loss_and_grads(api.loss_fn, state.params, tb, n_microbatch=n_mb)
    jgrads = _jax_grads(arch, b, n_mb)
    gworst = max(_leaf_err(w, g.numpy()) for w, g in
                 zip(jax.tree_util.tree_leaves(_np(jgrads)), tu.leaves(grads)))
    assert all(g.dtype == torch.float32 for g in tu.leaves(grads))
    new, m = trainer.make_train_step(api.loss_fn, to, n_microbatch=n_mb, grad_compress=gc)(
        state, tb)
    lerr, nerr = _rel(m["loss"], jm["loss"]), _rel(m["grad_norm"], jm["grad_norm"])
    print(f"{arch} mb={n_mb} gc={gc} int8={int8}: loss rel {lerr:.2e} (bound {LOSS_RTOL}), "
          f"grad_norm rel {nerr:.2e} (bound {GNORM_RTOL}), grads worst {gworst:.2e} "
          f"(bound {GRAD_TOL})")
    assert lerr <= LOSS_RTOL and nerr <= GNORM_RTOL and gworst <= GRAD_TOL
    assert float(m["lr"]) == float(jm["lr"])
    assert int(m["step"]) == int(jm["step"]) == 1 and new.opt.step.dtype == torch.int32
    lr = float(jm["lr"])
    eps = max(jo.eps, 1e-5) if int8 else jo.eps
    pworst = _check_params(jp, jnew.params, new.params, _applied(jgrads, gc, jo.grad_clip),
                           lr, eps)
    print(f"  params (well-conditioned): worst rel {pworst:.2e} (bound {STATE_RTOL})")
    flips = _payload_flips(jgrads, grads) if gc else [np.zeros(g.shape, bool)
                                                      for g in tu.leaves(grads)]
    n_flips = sum(int(f.sum()) for f in flips)
    print(f"  int8 payload flips (R9): {n_flips} of {sum(f.size for f in flips)}")
    assert n_flips <= 1e-4 * sum(f.size for f in flips)
    _check_moments(jnew.opt, new.opt, flips)
    if gc:  # within one quantum (max |g| of the row / 127) where a payload flipped
        for want, got, g, flip in zip(jax.tree_util.tree_leaves(_np(jnew.ef)),
                                      tu.leaves(new.ef),
                                      jax.tree_util.tree_leaves(_np(jgrads)), flips):
            quantum = np.abs(g).max(axis=-1, keepdims=True) / 127 if g.ndim else np.abs(g) / 127
            tol = np.where(flip, quantum, 0) + GRAD_TOL * np.abs(g).max()
            assert (np.abs(got.numpy() - want) <= tol).all()
    else:
        assert new.ef is None


@pytest.mark.parametrize("arch", ARCHS)
def test_three_steps_match_jax(arch):
    """Three steps on ``batch_at`` batches 0, 1, 2 from the same state (4
    microbatches, int8 moments): each step's loss and gradient norm within
    LOSS_RTOL and GNORM_RTOL of JAX's, the step equal, the lr within
    1.2e-7 × (lr_peak − lr_final) (test_lr_schedule_every_step's bound: the
    f32 cosine of the decay steps may round an ulp apart)."""
    _, _, jp, _ = _jax_model(arch)
    cfg, api = _port_model(arch)
    jo, to = _ocfg(int8=True)
    js = jtrainer.init_train_state(jp, jo)
    state = interop.train_state_from_numpy(_np(js), cfg, device="cpu")
    jstep = _jax_step(arch, 4, False, True)
    step = trainer.make_train_step(api.loss_fn, to, n_microbatch=4)
    for t in range(3):
        b = _batch(cfg, step=t)
        js, jm = jstep(js, jax.tree_util.tree_map(jnp.asarray, b))
        state, m = step(state, _torch_batch(b))
        lerr, nerr = _rel(m["loss"], jm["loss"]), _rel(m["grad_norm"], jm["grad_norm"])
        print(f"{arch} step {t}: loss rel {lerr:.2e}, grad_norm rel {nerr:.2e}")
        assert lerr <= LOSS_RTOL and nerr <= GNORM_RTOL
        assert abs(float(m["lr"]) - float(jm["lr"])) <= 1.2e-7 * (jo.lr_peak - jo.lr_final)
        assert int(m["step"]) == int(jm["step"]) == t + 1


# --------------------------------------- torch mirrors of tests/test_train.py --


def test_microbatch_accumulation_equivalence():
    """n_microbatch=4 gives the same update as n_microbatch=1."""
    cfg, api = _port_model("qwen1.5-0.5b")
    _, ocfg = _ocfg()
    params = api.init_params(0, device="cpu")
    b = _torch_batch(_batch(cfg))
    outs = []
    for n_mb in (1, 4):
        state = trainer.init_train_state(tu.tree_map(torch.clone, params), ocfg)
        outs.append(trainer.make_train_step(api.loss_fn, ocfg, n_microbatch=n_mb)(state, b))
    assert float(outs[0][1]["loss"]) == pytest.approx(float(outs[1][1]["loss"]), rel=1e-5)
    for a, c in zip(tu.leaves(outs[0][0].params), tu.leaves(outs[1][0].params)):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=2e-3, atol=2e-5)


def test_int8_training_converges():
    """Fixed-batch memorization with int8 moments: the per-step loss falls."""
    cfg, api = _port_model("qwen1.5-0.5b")
    _, ocfg = _ocfg(int8=True)
    state = trainer.init_train_state(api.init_params(0, device="cpu"), ocfg)
    step = trainer.make_train_step(api.loss_fn, ocfg, n_microbatch=2)
    b = _torch_batch(_batch(cfg, batch=4))
    losses = []
    for _ in range(6):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses


def test_grad_compression_error_feedback():
    """int8 EF compression: the residual carries the quantization error, so
    the time-averaged applied gradient is unbiased."""
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(512).astype(np.float32)
                         * 1e-3)
    res = torch.zeros_like(g)
    applied = torch.zeros_like(g)
    n = 64
    for _ in range(n):
        ghat, res = opt.compress_decompress(g, res)
        applied += ghat
    np.testing.assert_allclose((applied / n).numpy(), g.numpy(), rtol=0.05, atol=2e-7)


def test_end_to_end_loss_drops():
    """lm_data stream → trainer on olmoe; the first batch's loss, evaluated
    again after training, beats its first value."""
    cfg, api = _port_model("olmoe-1b-7b")
    _, ocfg = _ocfg()
    state = trainer.init_train_state(api.init_params(0, device="cpu"), ocfg)
    step = trainer.make_train_step(api.loss_fn, ocfg)
    batch0 = _torch_batch(_batch(cfg, batch=4))
    losses = []
    for b in lm_data.stream(batch_size=4, seq_len=SEQ, vocab=cfg.vocab_size, steps=6):
        state, m = step(state, _torch_batch(b))
        losses.append(float(m["loss"]))
    _, m_end = step(state, batch0)
    assert float(m_end["loss"]) < losses[0], (losses, float(m_end["loss"]))


# --------------------------------------------------------------------- remat --


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bit_neutral(arch):
    """The loss and every gradient with ``remat=True`` equal those without,
    bit for bit."""
    out = []
    for remat in (False, True):
        cfg, api = _port_model(arch, remat=remat)
        params = api.init_params(0, device="cpu")
        out.append(trainer.loss_and_grads(api.loss_fn, params, _torch_batch(_batch(cfg)),
                                          n_microbatch=2))
    assert torch.equal(out[0][0], out[1][0])
    for a, c in zip(tu.leaves(out[0][1]), tu.leaves(out[1][1])):
        assert torch.equal(a, c)


# ------------------------------------------------------------- apply_updates --


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_apply_updates_by_slices_is_bit_equal(int8, monkeypatch):
    """Leaves updated in dim-0 slices, into the old state's tensors, give the
    whole-leaf update bit for bit (gradients below the clip, so the sliced
    norm's summation order cannot move the clip factor)."""
    rng = np.random.default_rng(4)

    def tree():
        return {"a": torch.from_numpy(rng.standard_normal((7, 5, 33)).astype(np.float32)),
                "b": torch.from_numpy(rng.standard_normal(33).astype(np.float32)),
                "s": torch.tensor(np.float32(rng.standard_normal())),
                "h": torch.from_numpy(rng.standard_normal((9, 40)).astype(np.float32))
                .bfloat16()}

    _, ocfg = _ocfg(int8, lr_peak=1e-2, lr_init=1e-3)
    params = tree()
    grads = [tu.tree_map(lambda x: x * 1e-3, tree()) for _ in range(3)]
    whole, ws = params, opt.init_state(params, ocfg)
    for g in grads:
        whole, ws = opt.apply_updates(whole, g, ws, ocfg)
    monkeypatch.setattr(opt, "SLICE_ELEMS", 40)
    sliced = tu.tree_map(torch.clone, params)
    ss = opt.init_state(sliced, ocfg)
    for g in grads:
        new, ss_new = opt.apply_updates(sliced, g, ss, ocfg, donate=True)
        assert new["a"] is sliced["a"] and ss_new.step is ss.step
        sliced, ss = new, ss_new
    assert not torch.equal(params["a"], sliced["a"])
    for a, c in zip(tu.leaves((whole, ws)), tu.leaves((sliced, ss))):
        assert a.dtype == c.dtype and torch.equal(a, c)


# ----------------------------------------------------------------- launcher --


def test_launcher_on_cpu(tmp_path, capsys):
    out_file = tmp_path / "losses.json"
    out = launch_train.main(["--arch", "qwen1.5-0.5b", "--steps", "11", "--batch", "8",
                             "--seq", "16", "--device", "cpu", "--losses-out", str(out_file)])
    text = capsys.readouterr().out
    losses = json.loads(out_file.read_text())
    assert len(losses) == 11 and losses[-1] < losses[0] and losses == out["losses"]
    assert "step     0 loss" in text and "step    10 loss" in text
    assert "qwen1.5-0.5b: 11 steps, loss" in text and "tok/s" in text


def test_launcher_ckpt_resumes_bit_equal(tmp_path, monkeypatch):
    """A ``--ckpt`` run writes its state and heartbeat; a second invocation
    restores exactly that state and continues the step count."""
    args = ["--arch", "olmoe-1b-7b", "--batch", "8", "--seq", "16", "--device", "cpu",
            "--int8-moments", "--ckpt", str(tmp_path)]
    first = launch_train.main(args + ["--steps", "3"])
    assert first["steps_run"] == [0, 1, 2] and (tmp_path / "hb.json").exists()
    saved = interop.train_state_to_numpy(first["state"])
    restored = []
    real = ckpt.restore

    def recording(*a, **k):  # a host copy: the run goes on to update the state in place
        state, step = real(*a, **k)
        restored.append((interop.train_state_to_numpy(state), step))
        return state, step

    monkeypatch.setattr(ft.ckpt, "restore", recording)
    second = launch_train.main(args + ["--steps", "6"])
    assert second["steps_run"] == [3, 4, 5] and restored[0][1] == 2
    for a, c in zip(tu.leaves(saved), tu.leaves(restored[0][0])):
        assert a.dtype == c.dtype and np.array_equal(a, c)
    assert int(second["state"].opt.step) == 6
    with pytest.raises(SystemExit, match="nothing to run"):
        launch_train.main(args + ["--steps", "6"])


def test_launcher_coordinator_raises():
    """``--coordinator`` joins a process group (here a world of one, so no
    peer is needed), trains through it, and leaves the group on the way out
    (``tests/test_torch_multihost.py`` holds two processes to one)."""
    import socket

    from repro_torch.distributed import runtime

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    argv = ["--arch", "qwen1.5-0.5b", "--device", "cpu", "--steps", "11", "--batch", "8",
            "--seq", "16"]
    got = launch_train.main(argv + ["--coordinator", f"127.0.0.1:{port}",
                                    "--num-processes", "1", "--process-id", "0"])
    assert not torch.distributed.is_initialized()
    assert runtime.get_context().n_hosts == 1
    assert got["steps_run"] == list(range(11)) and got["losses"][-1] < got["losses"][0]


def test_make_train_step_refuses_sharding_metadata():
    """``batch_sharding`` is refused (``ctx=`` is the data-parallel step);
    ``grad_shardings`` is accepted and held to the parameters' structure at
    the first step (its values: tests/test_torch_sharding.py)."""
    _, ocfg = _ocfg()
    step = trainer.make_train_step(None, ocfg, grad_shardings={})
    with pytest.raises(ValueError, match="structure"):
        step(trainer.TrainState(params={"w": torch.zeros(2)}, opt=None, ef=None), {})
    with pytest.raises(NotImplementedError, match="ctx="):
        trainer.make_train_step(None, ocfg, batch_sharding=object())


def test_launcher_defaults_to_the_card():
    """Without ``--device`` the launcher asks for the card and raises where
    there is none; nothing falls back to the CPU."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen1.5-0.5b",
         "--steps", "1"],
        env={**os.environ, "PYTHONPATH": SRC, "CUDA_VISIBLE_DEVICES": ""},
        capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "no CUDA device" in r.stderr, r.stdout + r.stderr


# --------------------------------------------------- checkpoints, both ways --

STATE_CASES = {"f32": (False, False), "int8": (True, False), "int8-ef": (True, True)}


def _jax_state_after_step(arch, int8, gc):
    _, _, jp, _ = _jax_model(arch)
    js = jtrainer.init_train_state(jp, _ocfg(int8)[0], grad_compress=gc)
    b = jax.tree_util.tree_map(jnp.asarray, _batch(configs.smoke_config(
        configs.get_config(arch))))
    return _jax_step(arch, 1, gc, int8)(js, b)[0]


@pytest.mark.parametrize("case", list(STATE_CASES))
def test_port_checkpoint_restored_by_jax(case, tmp_path):
    """A state the port's Supervisor wrote (two steps, committed at the end)
    restores into JAX's ``init_train_state`` template bit for bit."""
    int8, gc = STATE_CASES[case]
    arch = "olmoe-1b-7b"
    _, _, jp, _ = _jax_model(arch)
    cfg, api = _port_model(arch)
    jo, to = _ocfg(int8)
    js0 = jtrainer.init_train_state(jp, jo, grad_compress=gc)
    step = trainer.make_train_step(api.loss_fn, to, grad_compress=gc)

    def run_step(state, t):
        return step(state, _torch_batch(_batch(cfg, step=t)))[0]

    sup = ft.Supervisor(ckpt_root=str(tmp_path), save_every=20,
                        heartbeat=ft.Heartbeat(str(tmp_path / "hb.json")))
    init = lambda: interop.train_state_from_numpy(_np(js0), cfg, device="cpu")  # noqa: E731
    state = sup.run(init_state=init, state_template=init, step_fn=run_step, n_steps=2)
    restored, at = jckpt.restore(str(tmp_path), js0)
    assert at == 1 and (restored.ef is None) == (not gc)
    want = interop.train_state_to_numpy(state)
    jflat = jax.tree_util.tree_flatten_with_path(_np(restored))[0]
    paths, leaves = tu.flatten_with_paths(want)
    assert paths == ["/".join(str(k) for k in p) for p, _ in jflat]
    for (path, a), c in zip(jflat, leaves):
        assert a.dtype == c.dtype and np.array_equal(a, c), jax.tree_util.keystr(path)


@pytest.mark.parametrize("case", list(STATE_CASES))
def test_jax_checkpoint_restored_by_port(case, tmp_path):
    """A state JAX wrote after one jitted step restores into the port's
    template bit for bit."""
    int8, gc = STATE_CASES[case]
    arch = "qwen1.5-0.5b"
    jstate = _jax_state_after_step(arch, int8, gc)
    jckpt.save(str(tmp_path), 0, jstate)
    cfg, api = _port_model(arch)
    _, to = _ocfg(int8)
    template = trainer.init_train_state(api.init_params(0, device="cpu"), to, grad_compress=gc)
    restored, at = ckpt.restore(str(tmp_path), template)
    assert at == 0 and (restored.ef is None) == (not gc)
    jflat = jax.tree_util.tree_leaves(_np(jstate))
    got = tu.leaves(interop.train_state_to_numpy(restored))
    assert len(jflat) == len(got)
    for a, c in zip(jflat, got):
        assert a.dtype == c.dtype and np.array_equal(a, c)


def test_train_state_crosses_both_ways():
    """interop.train_state_from_numpy then train_state_to_numpy gives JAX's
    state back, leaf for leaf and path for path."""
    jstate = _jax_state_after_step("olmoe-1b-7b", True, True)
    cfg, _ = _port_model("olmoe-1b-7b")
    back = interop.train_state_to_numpy(interop.train_state_from_numpy(
        _np(jstate), cfg, device="cpu"))
    jflat = jax.tree_util.tree_flatten_with_path(_np(jstate))[0]
    paths, leaves = tu.flatten_with_paths(back)
    assert paths == ["/".join(str(k) for k in p) for p, _ in jflat]
    for (_, a), c in zip(jflat, leaves):
        assert a.dtype == c.dtype and np.array_equal(a, c)


# ------------------------------------------------------------------- imports --


def test_new_modules_import_no_jax():
    code = (
        "import sys, repro_torch.data.lm_data, repro_torch.train.trainer, "
        "repro_torch.launch.train, repro_torch.models.zoo, repro_torch.interop\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.')]\n"
        "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], env={**os.environ, "PYTHONPATH": SRC},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
