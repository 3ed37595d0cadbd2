"""The port's LM training path for the recurrent families against the JAX
package on the CPU: rwkv6-3b (ssm: the chunked WKV) and zamba2-7b (hybrid:
the chunked SSD and the shared attention block) at ``smoke_config`` (f32),
and zamba2-7b at three layers, so that the hybrid has a mamba tail after its
super-layer. The cases: ``trainer.loss_and_grads`` against JAX's
``value_and_grad``, one ``make_train_step`` step against JAX's jitted step,
remat against no remat, and the ``launch.train`` CLI.

JAX builds the parameters and states; they cross as numpy arrays
(``interop.train_state_from_numpy``). The bounds are those of
``tests/test_torch_lm_train.py``, imported from it with its helpers: the
loss LOSS_RTOL and the gradient norm GNORM_RTOL relative, every gradient
leaf within GRAD_TOL of its largest |g|, the parameters under R6 and R8,
the moments and the error-feedback residual under R9 (ROADMAP §3).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.data import lm_data  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.train import trainer  # noqa: E402
from test_torch_lm_train import (  # noqa: E402
    GNORM_RTOL,
    GRAD_TOL,
    LOSS_RTOL,
    STATE_RTOL,
    _applied,
    _check_moments,
    _check_params,
    _leaf_err,
    _np,
    _ocfg,
    _payload_flips,
    _rel,
    _torch_batch,
)

# case -> (arch, overrides of its smoke config)
CASES = {
    "rwkv6-3b": ("rwkv6-3b", {}),
    "zamba2-7b": ("zamba2-7b", {}),  # one super-layer of 2 mamba layers, no tail
    "zamba2-7b-tail": ("zamba2-7b", {"n_layers": 3}),  # one super-layer and a tail layer
}
BATCH, SEQ = 8, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side at these sizes is many tiny ops: one intra-op thread
    keeps them from contending with the other test processes' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_model(case):
    """(JAX api, params, jitted value_and_grad): built once per case."""
    arch, kw = CASES[case]
    jcfg = dataclasses.replace(jconfigs.smoke_config(jconfigs.get_config(arch)), **kw)
    japi = jzoo.get_api(jcfg)
    return japi, japi.init_params(jax.random.PRNGKey(0)), jax.jit(
        jax.value_and_grad(japi.loss_fn))


def _port_model(case, **kw):
    arch, over = CASES[case]
    cfg = dataclasses.replace(configs.smoke_config(configs.get_config(arch)), **over, **kw)
    return cfg, zoo.get_api(cfg)


def _batch(cfg, step=0):
    return lm_data.batch_at(step, batch_size=BATCH, seq_len=SEQ, vocab=cfg.vocab_size)


def _jax_grads(case, b, n_mb):
    """(loss, grads) as JAX's train step forms them: value_and_grad, or the
    f32 means over microbatches."""
    _, jp, vg = _jax_model(case)
    jb = jax.tree_util.tree_map(jnp.asarray, b)
    if n_mb == 1:
        return vg(jp, jb)
    loss, acc = 0.0, None
    for i in range(n_mb):
        mb = jax.tree_util.tree_map(lambda x: x.reshape(n_mb, -1, *x.shape[1:])[i], jb)
        l_mb, g = vg(jp, mb)
        g = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), g)
        loss += float(l_mb)
        acc = g if acc is None else jax.tree_util.tree_map(jnp.add, acc, g)
    return loss / n_mb, jax.tree_util.tree_map(lambda g: g / n_mb, acc)


def _grads_worst(jgrads, grads) -> tuple:
    """(worst leaf error × its largest |g|, that leaf's path)."""
    flat = jax.tree_util.tree_flatten_with_path(_np(jgrads))[0]
    return max((_leaf_err(w, g.numpy()), jax.tree_util.keystr(path))
               for (path, w), g in zip(flat, tu.leaves(grads)))


@pytest.mark.parametrize("n_mb", [1, 4], ids=["mb1", "mb4"])
@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match_jax(case, n_mb):
    """``trainer.loss_and_grads`` on carried-across parameters: the loss
    within LOSS_RTOL of JAX's, every gradient leaf (f32 accumulators over
    microbatches) within GRAD_TOL of the leaf's largest |g|."""
    _, jp, _ = _jax_model(case)
    cfg, api = _port_model(case)
    b = _batch(cfg)
    jloss, jgrads = _jax_grads(case, b, n_mb)
    params = interop.lm_params_from_numpy(_np(jp), cfg, device="cpu")
    loss, grads = trainer.loss_and_grads(api.loss_fn, params, _torch_batch(b),
                                         n_microbatch=n_mb)
    assert all(g.dtype == torch.float32 for g in tu.leaves(grads))
    lerr = _rel(loss, jloss)
    gworst, where = _grads_worst(jgrads, grads)
    print(f"{case} mb={n_mb}: loss rel {lerr:.2e} (bound {LOSS_RTOL}), grads worst "
          f"{gworst:.2e} at {where} (bound {GRAD_TOL})")
    assert lerr <= LOSS_RTOL and gworst <= GRAD_TOL


def test_hybrid_stacks_get_per_layer_views():
    """The train step's autograd views split the hybrid's mamba stack
    (n_super, attn_every, ...) and its tail (n_tail, ...) into one autograd
    leaf per layer, as the other families' ``layers``; each layer's
    gradient lands in its own row of the stacked gradient."""
    cfg, api = _port_model("zamba2-7b-tail")
    params = api.init_params(0, device="cpu")
    grads = tu.tree_map(torch.zeros_like, params)
    views = trainer._autograd_views(params, grads, accumulate=False)
    assert len(views["mamba"]) == 1 and len(views["mamba"][0]) == cfg.attn_every
    assert len(views["tail"]) == 1
    for stack, idx in (("mamba", (0, 1)), ("tail", (0,))):
        got = views[stack][idx[0]] if len(idx) == 1 else views[stack][idx[0]][idx[1]]
        for k, v in got.items():
            assert v.is_leaf and v.requires_grad and v.shape == params[stack][k][idx].shape
    assert views["shared_attn"]["ln1"].shape == params["shared_attn"]["ln1"].shape
    w = views["tail"][0]["out_proj"]
    (w * 3.0).sum().backward()
    assert bool((grads["tail"]["out_proj"][0] == 3.0).all()) and w.grad is None


@pytest.mark.parametrize("step_case", [(1, False, False), (4, True, True)],
                         ids=["mb1-f32m", "mb4-gc-int8m"])
@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(case, step_case):
    """One ``make_train_step`` step from the same carried-across state and
    ``batch_at`` batch: loss, gradient norm, lr and step, the new
    parameters (R6, R8), moments and error-feedback residual (R9)."""
    n_mb, gc, int8 = step_case
    japi, jp, _ = _jax_model(case)
    cfg, api = _port_model(case)
    jo, to = _ocfg(int8)
    b = _batch(cfg)
    js = jtrainer.init_train_state(jp, jo, grad_compress=gc)
    jstep = jax.jit(jtrainer.make_train_step(japi.loss_fn, jo, n_microbatch=n_mb,
                                             grad_compress=gc))
    jnew, jm = jstep(js, jax.tree_util.tree_map(jnp.asarray, b))
    _, jgrads = _jax_grads(case, b, n_mb)

    state = interop.train_state_from_numpy(_np(js), cfg, device="cpu")
    tb = _torch_batch(b)
    _, grads = trainer.loss_and_grads(api.loss_fn, state.params, tb, n_microbatch=n_mb)
    new, m = trainer.make_train_step(api.loss_fn, to, n_microbatch=n_mb, grad_compress=gc)(
        state, tb)
    lerr, nerr = _rel(m["loss"], jm["loss"]), _rel(m["grad_norm"], jm["grad_norm"])
    print(f"{case} mb={n_mb} gc={gc} int8={int8}: loss rel {lerr:.2e} (bound {LOSS_RTOL}), "
          f"grad_norm rel {nerr:.2e} (bound {GNORM_RTOL})")
    assert lerr <= LOSS_RTOL and nerr <= GNORM_RTOL
    assert float(m["lr"]) == float(jm["lr"])
    assert int(m["step"]) == int(jm["step"]) == 1
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


@pytest.mark.parametrize("n_mb", [1, 2], ids=["mb1", "mb2"])
@pytest.mark.parametrize("case", list(CASES))
def test_remat_is_bit_neutral(case, n_mb):
    """The loss and every gradient with ``remat=True`` (rwkv6: each layer
    recomputed; the hybrid: each super-layer) equal those without, bit for
    bit."""
    out = []
    for remat in (False, True):
        cfg, api = _port_model(case, remat=remat)
        params = api.init_params(0, device="cpu")
        out.append(trainer.loss_and_grads(api.loss_fn, params, _torch_batch(_batch(cfg)),
                                          n_microbatch=n_mb))
    assert torch.equal(out[0][0], out[1][0])
    for a, c in zip(tu.leaves(out[0][1]), tu.leaves(out[1][1])):
        assert torch.equal(a, c)


@pytest.mark.parametrize("argv", [["--arch", "rwkv6-3b"], ["--arch", "zamba2-7b"],
                                  ["--arch", "zamba2-7b", "--microbatch", "2",
                                   "--int8-moments"]],
                         ids=["rwkv6-3b", "zamba2-7b", "zamba2-7b-mb2-int8m"])
def test_launcher_on_cpu(argv, capsys):
    """``launch.train`` at the smoke config on the CPU: every loss finite and
    the last below the first (the launcher's own gate)."""
    out = launch_train.main(argv + ["--steps", "11", "--batch", "8", "--seq", "32",
                                    "--device", "cpu"])
    text = capsys.readouterr().out
    losses = out["losses"]
    assert len(losses) == 11 and np.isfinite(losses).all() and losses[-1] < losses[0]
    assert f"{argv[1]}: 11 steps, loss" in text and "tok/s" in text
