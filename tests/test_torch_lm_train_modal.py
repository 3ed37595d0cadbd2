"""The port's last LM training paths against the JAX package on the CPU:

* (a) the audio and vlm families' train step at ``smoke_config`` (f32) of
  whisper-small and llava-next-34b: ``trainer.loss_and_grads`` at 1 and 2
  microbatches against JAX's ``value_and_grad`` and its microbatch mean,
  and one ``make_train_step`` step against JAX's jitted step (whisper on
  f32 moments; llava on int8 moments with error-feedback compression), on
  the ``tokens``/``labels`` and ``frames`` or ``patches`` batch of
  ``zoo.input_specs``' train branch; whisper's encoder and decoder stacks
  as per-layer autograd leaves; remat bit-neutral;
* (b) llava-next-34b's sharded layout (its config's ``fsdp``) for 2 and 4
  processes, in process: every leaf of the train state, the projector and
  the error-feedback residual included, split to ``shard_shape`` of JAX's
  spec, and the sliced init bit-equal to the slices of the whole init;
* (c) one job of two gloo processes: a ``wo`` leaf split along its last
  dimension compressed with ``row_max`` (payload, scales, compressed
  gradient and residual bit-equal to JAX's ``compress_decompress`` of the
  whole leaf); qwen1.5-32b with ``grad_compress=True`` and int8 moments
  taking two sharded steps under ``ft.Supervisor`` from JAX's initial state
  (its checkpoint, residual included, restored whole by both packages and
  slice by slice); llava taking one sharded compressed step, its projector
  gathered where it is read and its gradient reduce-scattered.

JAX builds the parameters; they cross as numpy arrays. Tokens, frames and
patches are drawn with numpy from a seed. Every JAX number of an arch
comes from one jitted function (its train step, ``value_and_grad`` at the
step's parameters and the compression payloads): one compile an arch. The bounds are those of
``tests/test_torch_lm_train.py``, imported with its helpers: the loss
LOSS_RTOL and the gradient norm GNORM_RTOL relative, every gradient leaf
within GRAD_TOL of its largest |g|, the parameters under R6 and R8, the
moments and the residual under R9 (ROADMAP §3). A second step is held to
JAX's jitted step taken from the port's own first-step state, so each
step's bounds are those of one step. In a second step, an element whose
compression payload flipped (R9) is held to R6's 2·lr in its parameter, as
an ill-conditioned one: the moments carry its one-quantum difference into
the update.
"""
import dataclasses
import functools
import json
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.data import lm_data  # noqa: E402
from repro_torch.distributed import fsdp, runtime  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.models import llava, zoo  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import trainer  # noqa: E402
from test_torch_lm_train import (  # noqa: E402
    GNORM_RTOL,
    GRAD_TOL,
    LOSS_RTOL,
    STATE_RTOL,
    _check_moments,
    _check_params,
    _leaf_err,
    _np,
    _ocfg,
    _rel,
)
from test_torch_fsdp import _wo_inputs  # noqa: E402
from test_torch_multihost import _run_group  # noqa: E402

MODAL = ["whisper-small", "llava-next-34b"]
MB_ROWS, SEQ = 2, 16  # rows a microbatch (one JAX compile an arch), tokens
QWEN = "qwen1.5-32b"
QWEN_BATCH = 8
QWEN_STEPS = 2
# each arch's step, one microbatch: (grad_compress, int8_moments); qwen's in the
# two-process job, llava's in process and in the job
STEP_CASE = {"whisper-small": (False, False), "llava-next-34b": (True, True),
             QWEN: (True, True)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's side at these sizes is many tiny ops: one intra-op thread
    keeps them from contending with the child processes and the other test
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax(arch):
    """(JAX's params, its initial train state of the arch's STEP_CASE, and
    ``fn(state, batch) -> (new state, metrics, loss, grads, payloads)``):
    JAX's train step jitted together with ``value_and_grad`` of the loss at
    the state's parameters and, where the step compresses, the int8
    payloads of those gradients plus the state's residual (``_q8_pack`` of
    ``compress_decompress``'s sum), so one compile an arch gives every JAX
    number the file compares. The init is jitted too: one compile, where
    the eager init compiles each of its many small ops."""
    japi = jzoo.get_api(jconfigs.smoke_config(jconfigs.get_config(arch)))
    gc, int8 = STEP_CASE[arch]
    step = jtrainer.make_train_step(japi.loss_fn, _ocfg(int8)[0], grad_compress=gc)
    vg = jax.value_and_grad(japi.loss_fn)

    def fn(state, batch):
        new, metrics = step(state, batch)
        loss, grads = vg(state.params, batch)
        payloads = None if state.ef is None else jax.tree_util.tree_map(
            lambda g, r: jopt._q8_pack(g.astype(jnp.float32) + r)[0], grads,
            state.ef.residual)
        return new, metrics, loss, grads, payloads

    jp = jax.jit(japi.init_params)(jax.random.PRNGKey(0))
    return jp, jtrainer.init_train_state(jp, _ocfg(int8)[0], grad_compress=gc), jax.jit(fn)


def _port_model(arch, **kw):
    cfg = dataclasses.replace(configs.smoke_config(configs.get_config(arch)), **kw)
    return cfg, zoo.get_api(cfg)


def _batch(cfg, rows, seed=0):
    """``rows`` rows of ``zoo.input_specs``' train batch: tokens and their
    next-token labels, and the stub frontend's frames (B, encoder_seq,
    d_model) or patches (B, n_patches, D_VISION)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (rows, SEQ + 1)).astype(np.int32)
    b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal((rows, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    else:
        b["patches"] = (rng.standard_normal((rows, cfg.n_patches, llava.D_VISION))
                        * 0.5).astype(np.float32)
    return b


def _torch_batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _jax_grads(arch, b, n_mb):
    """(loss, grads) as JAX's train step forms them: value_and_grad at the
    initial parameters, or the f32 means over microbatches (the sum and the
    division in numpy's f32: the same IEEE operations, without a JAX
    compile per leaf shape)."""
    _, js, fn = _jax(arch)
    outs = [fn(js, {k: jnp.asarray(v.reshape(n_mb, -1, *v.shape[1:])[i])
                    for k, v in b.items()})[2:4] for i in range(n_mb)]
    if n_mb == 1:
        return outs[0]
    acc = functools.reduce(lambda x, y: jax.tree_util.tree_map(np.add, x, y), [
        jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), g) for _, g in outs])
    return (sum(float(loss) for loss, _ in outs) / n_mb,
            jax.tree_util.tree_map(lambda g: g / np.float32(n_mb), acc))


def _grads_worst(jgrads, grads) -> tuple:
    """(worst leaf error × its largest |g|, that leaf's path)."""
    flat = jax.tree_util.tree_flatten_with_path(_np(jgrads))[0]
    return max((_leaf_err(w, np.asarray(g)), jax.tree_util.keystr(path))
               for (path, w), g in zip(flat, grads))


def _applied(jgrads, res, clip_norm):
    """|ĝ| of each element: JAX's gradient compressed against the residual
    ``res`` (numpy leaves, None: no compression), clipped. It only sorts
    elements into well- and ill-conditioned ones, so the port's codec
    compresses here (one JAX compile fewer a tree)."""
    leaves = [np.array(g, np.float32) for g in jax.tree_util.tree_leaves(jgrads)]
    if res is not None:
        leaves = [opt.compress_decompress(torch.from_numpy(g), torch.tensor(r))[0].numpy()
                  for g, r in zip(leaves, res)]
    gnorm = np.sqrt(sum(np.sum(np.square(g, dtype=np.float64)) for g in leaves))
    clip = min(1.0, clip_norm / max(gnorm, 1e-12))
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jgrads),
                                        [np.abs(g) * clip for g in leaves])


def _flips(jq, grads, res) -> list:
    """Per leaf, where the int8 compression payloads of the two packages'
    gradients, each with the same residual, differ (R9): JAX's ``jq``
    against the port's codec on the port's gradients."""
    return [np.asarray(q) != opt._q8_pack(torch.from_numpy(np.asarray(g) + r))[0].numpy()
            for q, g, r in zip(jax.tree_util.tree_leaves(jq), grads, res)]


def _check_residual(want_leaves, got_leaves, jgrads, flips):
    """The residual within GRAD_TOL of the leaf's largest |g|, and one
    quantum (max |g| of the row / 127) more where a payload flipped."""
    for want, got, g, flip in zip(want_leaves, got_leaves,
                                  jax.tree_util.tree_leaves(_np(jgrads)), flips):
        quantum = np.abs(g).max(axis=-1, keepdims=True) / 127 if g.ndim else np.abs(g) / 127
        tol = np.where(flip, quantum, 0) + GRAD_TOL * np.abs(g).max()
        assert (np.abs(np.asarray(got) - np.asarray(want)) <= tol).all()


def _check_step(jm, m, jp0, jnew, new, jgrads, jq, grads, res, *, gc, int8):
    """One step held to JAX's: loss, gradient norm, lr, the parameters (R6,
    R8), the payload flips (R9), moments and residual. ``new``: the port's
    state after the step with numpy leaves, JAX's structure; ``jq``: JAX's
    payloads; ``grads``: the port's gradients (numpy leaves); ``res``: the
    residual both steps started from (numpy leaves)."""
    lerr, nerr = _rel(m["loss"], jm["loss"]), _rel(m["grad_norm"], jm["grad_norm"])
    print(f"  loss rel {lerr:.2e} (bound {LOSS_RTOL}), grad_norm rel {nerr:.2e} "
          f"(bound {GNORM_RTOL})")
    assert lerr <= LOSS_RTOL and nerr <= GNORM_RTOL
    jo = _ocfg(int8)[0]
    # test_three_steps_match_jax's lr bound: the f32 cosine may round an ulp apart
    assert abs(float(m["lr"]) - float(jm["lr"])) <= 1.2e-7 * (jo.lr_peak - jo.lr_final)
    assert int(m["step"]) == int(jm["step"])
    lr, eps = float(jm["lr"]), max(jo.eps, 1e-5) if int8 else jo.eps
    flips = (_flips(jq, grads, res) if gc
             else [np.zeros(np.shape(g), bool) for g in grads])
    n_flips, n = sum(int(f.sum()) for f in flips), sum(f.size for f in flips)
    gabs = _applied(jgrads, res if gc else None, jo.grad_clip)
    if int(jm["step"]) > 1:
        # from the second step on, the moments carry a flipped element's
        # one-quantum difference (R9) into its update linearly: it is held to
        # R6's 2·lr, as an ill-conditioned one (a step moves an element by
        # lr·|m̂|/(√v̂+eps), and |m̂|/√v̂ ≤ 1.0004 at step 2 for b1 0.9,
        # b2 0.95, by Cauchy–Schwarz)
        gabs = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(gabs),
            [np.where(f, 0.0, a) for a, f in zip(jax.tree_util.tree_leaves(gabs), flips)])
    tparams = [torch.from_numpy(np.asarray(x)) for x in jax.tree_util.tree_leaves(new.params)]
    pworst = _check_params(jp0, jnew.params, tparams, gabs, lr, eps)
    print(f"  params (well-conditioned): worst rel {pworst:.2e} (bound {STATE_RTOL}); "
          f"int8 payload flips (R9): {n_flips} of {n}")
    assert n_flips <= 1e-4 * n
    tq8 = lambda x: opt.Q8Leaf(*map(torch.from_numpy, x)) if isinstance(  # noqa: E731
        x, jopt.Q8Leaf) else torch.from_numpy(np.asarray(x))
    is_q8 = lambda x: isinstance(x, jopt.Q8Leaf)  # noqa: E731
    topt = opt.AdamWState(step=None, **{f: jax.tree_util.tree_map(
        tq8, getattr(new.opt, f), is_leaf=is_q8) for f in ("m", "v")})
    _check_moments(jnew.opt, topt, flips)
    if gc:
        _check_residual(jax.tree_util.tree_leaves(_np(jnew.ef)),
                        jax.tree_util.tree_leaves(new.ef), jgrads, flips)
    else:
        assert new.ef is None and jnew.ef is None


# ------------------------------------- (a) the modal train step, port side --


def test_audio_stacks_get_per_layer_views():
    """The train step's autograd views split whisper's encoder and decoder
    stacks (L, ...) into one autograd leaf per layer; each layer's gradient
    lands in its own row of the stacked gradient."""
    cfg, api = _port_model("whisper-small")
    params = api.init_params(0, device="cpu")
    grads = tu.tree_map(torch.zeros_like, params)
    views = trainer._autograd_views(params, grads, accumulate=False)
    assert len(views["encoder"]) == cfg.encoder_layers and len(views["decoder"]) == cfg.n_layers
    for stack in ("encoder", "decoder"):
        for i, layer in enumerate(views[stack]):
            for got, whole in zip(tu.leaves(layer), tu.leaves(params[stack])):
                assert got.is_leaf and got.requires_grad and got.shape == whole[i].shape
    w = views["encoder"][1]["mlp"]["wo"]
    (w * 3.0).sum().backward()
    assert bool((grads["encoder"]["mlp"]["wo"][1] == 3.0).all()) and w.grad is None
    assert not grads["encoder"]["mlp"]["wo"][0].any()


@pytest.mark.parametrize("arch", MODAL)
def test_remat_is_bit_neutral(arch):
    """The loss and every gradient with ``remat=True`` (each encoder,
    decoder or backbone layer recomputed in the backward) equal those
    without, bit for bit."""
    out = []
    for remat in (False, True):
        cfg, api = _port_model(arch, remat=remat)
        out.append(trainer.loss_and_grads(api.loss_fn, api.init_params(0, device="cpu"),
                                          _torch_batch(_batch(cfg, MB_ROWS))))
    assert torch.equal(out[0][0], out[1][0])
    for a, c in zip(tu.leaves(out[0][1]), tu.leaves(out[1][1])):
        assert torch.equal(a, c)


# ------------------------------------------------ (b) llava's sharded layout --


def _llava_specs(n, rank):
    cfg, api = _port_model("llava-next-34b")
    ocfg = opt.AdamWConfig(int8_moments=True)
    ctx = runtime.DistributedContext(rank, n, device_type="cpu")
    rules = shd.default_rules(fsdp.mesh_for(ctx), fsdp=True)
    return api, ocfg, trainer.state_specs(api.param_axes(), api.init_params(0, device="meta"),
                                          ocfg, rules, ctx, grad_compress=True)


@pytest.mark.parametrize("n", [2, 4])
def test_llava_local_shapes_follow_jax_specs(n):
    """Each leaf of the compressed int8 train state of every rank, the
    projector and the residual included, has ``shard_shape`` of JAX's spec
    (``train_state_axes(grad_compress=True)`` under ``default_rules(mesh,
    fsdp=True)``); the split leaves are those whose axes hold ``embed``."""
    jcfg = jconfigs.smoke_config(jconfigs.get_config("llava-next-34b"))
    jaxes = jtrainer.train_state_axes(jzoo.get_api(jcfg).param_axes(),
                                      jopt.AdamWConfig(int8_moments=True), grad_compress=True)
    jrules = jshd.default_rules(types.SimpleNamespace(axis_names=("data", "model")), fsdp=True)
    is_ax = lambda x: isinstance(x, tuple) and all(  # noqa: E731
        isinstance(a, (str, type(None))) for a in x)
    jflat = jax.tree_util.tree_flatten_with_path(jaxes, is_leaf=is_ax)[0]
    mesh = shd.MeshShape(("data", "model"), (n, 1))
    api, ocfg, _ = _llava_specs(n, 0)
    whole = trainer.init_train_state(api.init_params(0, device="meta"), ocfg, grad_compress=True)
    paths = tu.flatten_with_paths(whole)[0]
    assert len(paths) == len(jflat)
    seen = set()
    for rank in range(n):
        specs = _llava_specs(n, rank)[2]
        for (jpath, axes), w, s in zip(jflat, tu.leaves(whole), tu.leaves(specs)):
            key = jax.tree_util.keystr(jpath)
            want = shd.shard_shape(tuple(w.shape), tuple(jshd.spec_for(axes, jrules)), mesh)
            assert fsdp.local_shape(w.shape, s) == want, (key, want)
            assert s.split == ("embed" in axes), (key, axes)
            if s.split:
                seen.add(key)
    assert any("mm_proj" in k and "w1" in k and k.startswith(".ef") for k in seen), seen
    assert any("mm_proj" in k and "w2" in k and k.startswith(".params") for k in seen), seen


@pytest.mark.parametrize("n", [2, 4])
def test_llava_sliced_init_draws_the_whole_inits_slices(n):
    """``llava.init_params(specs=)`` (through ``zoo``) draws the backbone a
    layer at a time and the projector whole, and keeps this rank's slices:
    bit-equal to slicing the whole init; the state's moments and residual
    take the slices' shapes."""
    api, ocfg, _ = _llava_specs(n, 0)
    whole = api.init_params(0, device="cpu")
    for rank in range(n):
        specs = _llava_specs(n, rank)[2]
        got = api.init_params(0, device="cpu", specs=specs.params)
        for a, b in zip(tu.leaves(got), tu.leaves(fsdp.shard_tree(whole, specs.params))):
            assert a.dtype == b.dtype and torch.equal(a, b)
        state = trainer.init_train_state(got, ocfg, grad_compress=True, specs=specs)
        for p, r in zip(tu.leaves(state.params), tu.leaves(state.ef)):
            assert r.shape == p.shape and r.dtype == torch.float32 and not r.any()


# ------------------------------------- (a) the modal steps against JAX --


@pytest.mark.parametrize("n_mb", [1, 2], ids=["mb1", "mb2"])
@pytest.mark.parametrize("arch", MODAL)
def test_loss_and_grads_match_jax(arch, n_mb):
    """``trainer.loss_and_grads`` on carried-across parameters over the
    frames or patches batch: the loss within LOSS_RTOL of JAX's, every
    gradient leaf (f32 accumulators over microbatches) within GRAD_TOL of
    the leaf's largest |g|."""
    jp = _jax(arch)[0]
    cfg, api = _port_model(arch)
    b = _batch(cfg, MB_ROWS * n_mb)
    jloss, jgrads = _jax_grads(arch, b, n_mb)
    params = interop.lm_params_from_numpy(_np(jp), cfg, device="cpu")
    loss, grads = trainer.loss_and_grads(api.loss_fn, params, _torch_batch(b),
                                         n_microbatch=n_mb)
    assert all(g.dtype == torch.float32 for g in tu.leaves(grads))
    lerr = _rel(loss, jloss)
    gworst, where = _grads_worst(jgrads, [g.numpy() for g in tu.leaves(grads)])
    print(f"{arch} mb={n_mb}: loss rel {lerr:.2e} (bound {LOSS_RTOL}), grads worst "
          f"{gworst:.2e} at {where} (bound {GRAD_TOL})")
    assert lerr <= LOSS_RTOL and gworst <= GRAD_TOL


@pytest.mark.parametrize("arch", MODAL)
def test_train_step_matches_jax(arch):
    """One ``make_train_step`` step from the same carried-across state:
    whisper on f32 moments, llava on int8 moments with error-feedback
    compression (the microbatches are ``loss_and_grads``', held above)."""
    gc, int8 = STEP_CASE[arch]
    jp, js, fn = _jax(arch)
    cfg, api = _port_model(arch)
    to = _ocfg(int8)[1]
    b = _batch(cfg, MB_ROWS)
    jnew, jm, _, jgrads, jq = fn(js, jax.tree_util.tree_map(jnp.asarray, b))

    state = interop.train_state_from_numpy(_np(js), cfg, device="cpu")
    tb = _torch_batch(b)
    _, grads = trainer.loss_and_grads(api.loss_fn, state.params, tb)
    new, m = trainer.make_train_step(api.loss_fn, to, grad_compress=gc)(state, tb)
    print(f"{arch} gc={gc} int8={int8}:")
    res0 = [np.zeros(g.shape, np.float32) for g in tu.leaves(grads)]
    _check_step(jm, m, jp, jnew, interop.train_state_to_numpy(new), jgrads, jq,
                [g.numpy() for g in tu.leaves(grads)], res0, gc=gc, int8=int8)


# --------------------------------------------- (c) two processes, one job --

_JOB_BODY = """
import dataclasses
from repro_torch import tree as tu
from repro_torch.configs import get_config, smoke_config
from repro_torch.data import lm_data
from repro_torch.distributed import collectives, fsdp
from repro_torch.distributed import sharding as shd
from repro_torch.models import llava, zoo
from repro_torch.train import ft
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer
d = np.load({inputs!r})
out = {{}}
metrics = {{}}
rules = shd.default_rules(fsdp.mesh_for(ctx), fsdp=True)
row_max = lambda a: fsdp.allreduce_(a, ctx, "max")

# a wo-like leaf split along its last (embed) axis, compressed with a residual
for name in ("wo", "wo_odd"):
    g, r = torch.from_numpy(d[name]), torch.from_numpy(d[name + "_res"])
    s = tu.leaves(fsdp.local_specs({{"w": ("layers", "mlp", "embed")}}, {{"w": g}}, rules,
                                   ctx))[0]
    gl, rl = fsdp.shard_leaf(g, s), fsdp.shard_leaf(r, s)
    q, scale = opt._q8_pack(gl + rl, row_max)
    g_hat, new_res = opt.compress_decompress(gl, rl, row_max)
    out[name + "_q"] = fsdp.all_gather_leaf(q, s, ctx).numpy()
    out[name + "_scale%d" % ctx.host_id] = scale.numpy()
    out[name + "_ghat"] = fsdp.all_gather_leaf(g_hat, s, ctx).numpy()
    out[name + "_newres"] = fsdp.all_gather_leaf(new_res, s, ctx).numpy()


def sharded(arch, ocfg, prefix):
    cfg = smoke_config(get_config(arch))
    api = zoo.get_api(cfg)
    meta = api.init_params(0, device="meta")
    whole = tu.unflatten_like(meta, [torch.from_numpy(d["%s%d" % (prefix, i)])
                                     for i in range(len(tu.leaves(meta)))])
    specs = trainer.state_specs(api.param_axes(), meta, ocfg, rules, ctx, grad_compress=True)
    return cfg, api, whole, specs


def grads_of(api, state, batch, specs):
    # the averaged gradients before compression, gathered whole
    _, grads = trainer.loss_and_grads(api.loss_fn, state.params, batch, specs=specs.params,
                                      ctx=ctx)
    collectives.allreduce_mean_([g for g, s in zip(tu.leaves(grads), tu.leaves(specs.params))
                                 if not s.split], ctx)
    return [g.numpy().copy() for g in tu.leaves(fsdp.gather_tree(grads, specs.params, ctx))]


# qwen1.5-32b: two compressed sharded steps under the Supervisor (a checkpoint
# after each step), from JAX's initial state
ocfg = opt.AdamWConfig(warmup_steps=2, total_steps=20, int8_moments=True)
cfg, api, whole, specs = sharded("qwen1.5-32b", ocfg, "p")
step = trainer.make_train_step(api.loss_fn, ocfg, ctx=ctx, specs=specs, grad_compress=True)


def init_state():
    return trainer.init_train_state(fsdp.shard_tree(whole, specs.params), ocfg,
                                    grad_compress=True, specs=specs)


def run_step(state, t):
    rows = lm_data.batch_at(t, batch_size={batch} // ctx.n_hosts, seq_len={seq},
                            vocab=cfg.vocab_size, host_id=ctx.host_id, n_hosts=ctx.n_hosts)
    batch = {{k: torch.from_numpy(v) for k, v in rows.items()}}
    for i, g in enumerate(grads_of(api, state, batch, specs)):
        out["q%d_g%d" % (t, i)] = g
    state, m = step(state, batch)
    # copies: a whole leaf comes back as the state's own tensor, which the
    # next step updates in place
    for i, leaf in enumerate(tu.leaves(fsdp.gather_tree(state, specs, ctx))):
        out["q%d_s%d" % (t, i)] = leaf.numpy().copy()
    metrics["qwen%d" % t] = {{k: float(v) for k, v in m.items()}}
    return state


ft.Supervisor(ckpt_root={ckpt!r}, save_every=1, ctx=ctx).run(
    init_state=init_state, state_template=init_state, step_fn=run_step, n_steps={steps},
    specs=specs)

# llava-next-34b: one compressed sharded step; the projector's reads recorded
cfg, api, whole, specs = sharded("llava-next-34b", ocfg, "l")
seen = {{"project": [], "gather": [], "rs": [], "inside": False}}
real_gather, real_rs, real_project = (fsdp.all_gather_leaf, fsdp.reduce_scatter_leaf,
                                      llava.project_patches)


def gather_rec(local, s, c):
    got = real_gather(local, s, c)
    seen["gather"].append([list(got.shape), seen["inside"]])
    return got


def rs_rec(g, s, c):
    seen["rs"].append(list(g.shape))
    return real_rs(g, s, c)


def project_rec(params, patches):
    seen["project"].append(type(params["mm_proj"]).__name__)
    seen["inside"] = True
    try:
        return real_project(params, patches)
    finally:
        seen["inside"] = False


state = trainer.init_train_state(fsdp.shard_tree(whole, specs.params), ocfg,
                                 grad_compress=True, specs=specs)
batch = {{k[len("llava_"):]: torch.from_numpy(v.reshape(ctx.n_hosts, -1, *v.shape[1:])
                                               [ctx.host_id].copy())
         for k, v in d.items() if k.startswith("llava_")}}
for i, g in enumerate(grads_of(api, state, batch, specs)):
    out["l_g%d" % i] = g
fsdp.all_gather_leaf, fsdp.reduce_scatter_leaf, llava.project_patches = (
    gather_rec, rs_rec, project_rec)
try:
    state, m = trainer.make_train_step(api.loss_fn, ocfg, ctx=ctx, specs=specs,
                                       grad_compress=True)(state, batch)
finally:
    fsdp.all_gather_leaf, fsdp.reduce_scatter_leaf, llava.project_patches = (
        real_gather, real_rs, real_project)
for i, leaf in enumerate(tu.leaves(fsdp.gather_tree(state, specs, ctx))):
    out["l_s%d" % i] = leaf.numpy()
metrics["llava"] = {{k: float(v) for k, v in m.items()}}
np.savez({result!r}.replace(".npz", "%d.npz" % ctx.host_id), **out)
print("METRICS=" + json.dumps(metrics))
print("SEEN=" + json.dumps(seen))
"""


def _line(out, key):
    return json.loads(next(ln for ln in out.splitlines()
                           if ln.startswith(key + "="))[len(key) + 1:])


@pytest.fixture(autouse=True, scope="module")
def _job_started(tmp_path_factory):
    """The two-process job, started once before the file's first test and
    run in a thread beside the in-process cases (the children are
    separate processes): JAX's parameters and the batches in, every
    process's results out. Yields the thread and where its results land."""
    d = tmp_path_factory.mktemp("modal_job")
    inputs = {}
    for name, shape, seed in (("wo", (2, 64, 64), 0), ("wo_odd", (2, 64, 63), 1)):
        inputs[name] = _wo_inputs(shape, seed)
        inputs[name + "_res"] = _wo_inputs(shape, seed + 10) / 200
    for prefix, arch in (("p", QWEN), ("l", "llava-next-34b")):
        inputs.update({f"{prefix}{i}": np.asarray(a) for i, a in
                       enumerate(jax.tree_util.tree_leaves(_jax(arch)[0]))})
    b = _batch(_port_model("llava-next-34b")[0], MB_ROWS)
    # host h takes row h
    inputs.update({f"llava_{k}": v for k, v in b.items()})
    np.savez(d / "inputs.npz", **inputs)
    body = _JOB_BODY.format(inputs=str(d / "inputs.npz"), result=str(d / "result.npz"),
                            ckpt=str(d / "ckpt"), batch=QWEN_BATCH, seq=SEQ, steps=QWEN_STEPS)
    out = {"inputs": inputs, "batch": b, "dir": d}

    def run():
        try:
            out["outs"] = _run_group(body, prelude="import torch; torch.set_num_threads(1)")
        except BaseException as e:  # noqa: BLE001 — re-raised by the job fixture
            out["error"] = e

    thread = threading.Thread(target=run, name="modal_job")
    thread.start()
    yield thread, out
    thread.join()


@pytest.fixture(scope="module")
def job(_job_started):
    """The two-process job's results: each process's arrays, metrics and
    recorded collectives."""
    thread, out = _job_started
    thread.join()
    if "error" in out:
        raise out["error"]
    d = out["dir"]
    return {"inputs": out["inputs"], "batch": out["batch"], "ckpt": str(d / "ckpt"),
            "res": [dict(np.load(d / f"result{h}.npz")) for h in range(2)],
            "metrics": [_line(o, "METRICS") for o in out["outs"]],
            "seen": [_line(o, "SEEN") for o in out["outs"]]}


def test_split_wo_compression_bit_equal_to_jax(job):
    """A leaf split along its last dimension, compressed with ``row_max``:
    the int8 payload, each process's row scales, the compressed gradient
    and the new residual equal JAX's ``compress_decompress`` of the whole
    leaf bit for bit, including a last dimension that two does not
    divide."""
    for name in ("wo", "wo_odd"):
        g, r = (jnp.asarray(job["inputs"][name + k]) for k in ("", "_res"))
        jq, js = jopt._q8_pack(g + r)
        jhat, jres = jopt.compress_decompress(g, r)
        for h in range(2):
            got = job["res"][h]
            assert got[name + "_q"].dtype == np.int8
            np.testing.assert_array_equal(got[name + "_q"], np.asarray(jq))
            np.testing.assert_array_equal(got[f"{name}_scale{h}"], np.asarray(js))
            np.testing.assert_array_equal(got[name + "_ghat"], np.asarray(jhat))
            np.testing.assert_array_equal(got[name + "_newres"], np.asarray(jres))


def _port_state(res, prefix, template):
    """The port's gathered state (numpy leaves) in JAX's structure."""
    leaves = jax.tree_util.tree_leaves(template)
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(template),
                                        [res[f"{prefix}{i}"] for i in range(len(leaves))])


def test_compressed_sharded_steps_match_jax(job):
    """qwen1.5-32b, int8 moments, ``grad_compress=True``, two processes with
    half of the batch each: step 1 from JAX's initial state against JAX's
    jitted step, step 2 against JAX's step from the port's own gathered
    step-1 state; each under the one-step bounds, the residual included
    (R9). The two loss and norm series also hold to JAX's own two steps;
    both processes report the same metrics."""
    jp, js, fn = _jax(QWEN)
    vocab = _port_model(QWEN)[0].vocab_size
    res = job["res"][0]
    assert job["metrics"][0] == job["metrics"][1]
    own = js
    for t in range(QWEN_STEPS):
        b = jax.tree_util.tree_map(jnp.asarray, lm_data.batch_at(
            t, batch_size=QWEN_BATCH, seq_len=SEQ, vocab=vocab))
        jnew, jm, _, jgrads, jq = fn(js, b)
        new = _port_state(res, f"q{t}_s", js)
        grads = [res[f"q{t}_g{i}"] for i in range(len(jax.tree_util.tree_leaves(jp)))]
        gworst, where = _grads_worst(jgrads, grads)
        print(f"sharded compressed step {t + 1}: grads worst {gworst:.2e} at {where}")
        assert gworst <= GRAD_TOL
        m = job["metrics"][0][f"qwen{t}"]
        _check_step(jm, m, _np(js.params), jnew, new, jgrads, jq, grads,
                    jax.tree_util.tree_leaves(_np(js.ef)), gc=True, int8=True)
        own, om = fn(own, b)[:2]
        assert _rel(m["loss"], om["loss"]) <= LOSS_RTOL
        assert _rel(m["grad_norm"], om["grad_norm"]) <= GNORM_RTOL
        js = jax.tree_util.tree_map(jnp.asarray, new)


def test_compressed_sharded_checkpoint_restores(job):
    """The Supervisor's last checkpoint of the two processes (each split
    leaf gathered and written whole, the residual beside the moments)
    restores in one process through the port's ``restore`` and JAX's,
    bit-equal to the state the processes gathered; ``restore(specs=)``
    gives each rank exactly its slices."""
    res = job["res"][0]
    cfg, api = _port_model(QWEN)
    ocfg = opt.AdamWConfig(int8_moments=True)
    template = trainer.init_train_state(api.init_params(0, device="cpu"), ocfg,
                                        grad_compress=True)
    last = f"q{QWEN_STEPS - 1}_s"
    whole, step = ckpt.restore(job["ckpt"], template)
    assert step == QWEN_STEPS - 1 and whole.ef is not None
    for i, a in enumerate(tu.leaves(whole)):
        assert a.numpy().dtype == res[f"{last}{i}"].dtype
        np.testing.assert_array_equal(a.numpy(), res[f"{last}{i}"])
    jstate, jstep = jckpt.restore(job["ckpt"], _jax(QWEN)[1])
    assert jstep == QWEN_STEPS - 1
    for i, a in enumerate(jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), res[f"{last}{i}"])
    for rank in range(2):
        ctx = runtime.DistributedContext(rank, 2, device_type="cpu")
        specs = trainer.state_specs(api.param_axes(), api.init_params(0, device="meta"), ocfg,
                                    shd.default_rules(fsdp.mesh_for(ctx), fsdp=True), ctx,
                                    grad_compress=True)
        local_t = trainer.init_train_state(api.init_params(0, device="cpu", specs=specs.params),
                                           ocfg, grad_compress=True, specs=specs)
        local, _ = ckpt.restore(job["ckpt"], local_t, specs=specs)
        assert any(s.split for s in tu.leaves(specs.ef))
        for a, b in zip(tu.leaves(local), tu.leaves(fsdp.shard_tree(whole, specs))):
            assert torch.equal(a, b)


def test_llava_sharded_step_matches_jax(job):
    """llava-next-34b, int8 moments, ``grad_compress=True``: one step on two
    processes, each with one of the two rows and its slices of the state,
    gathered, against JAX's jitted step over both rows."""
    jp, js, fn = _jax("llava-next-34b")
    jnew, jm, _, jgrads, jq = fn(js, jax.tree_util.tree_map(jnp.asarray, job["batch"]))
    res = job["res"][0]
    grads = [res[f"l_g{i}"] for i in range(len(jax.tree_util.tree_leaves(jp)))]
    gworst, where = _grads_worst(jgrads, grads)
    print(f"llava sharded step: grads worst {gworst:.2e} at {where}")
    assert gworst <= GRAD_TOL
    assert job["metrics"][0]["llava"] == job["metrics"][1]["llava"]
    _check_step(jm, job["metrics"][0]["llava"], _np(jp), jnew, _port_state(res, "l_s", js),
                jgrads, jq, grads, jax.tree_util.tree_leaves(_np(js.ef)), gc=True, int8=True)


def test_llava_projector_gathers_and_reduce_scatters(job):
    """In the sharded step ``project_patches`` reads ``params["mm_proj"]``
    as an ``fsdp.Gathered``: both of its weights are gathered whole there
    (w1 (D_VISION, d_model), split along its last dimension, and w2), and
    every gather's backward reduce-scatters a gradient of the same shape,
    w1's among them."""
    cfg = _port_model("llava-next-34b")[0]
    w1, w2 = [llava.D_VISION, cfg.d_model], [cfg.d_model, cfg.d_model]
    for seen in job["seen"]:
        assert seen["project"] == ["Gathered"]
        inside = [shape for shape, flag in seen["gather"] if flag]
        assert inside == [w1, w2]
        assert sorted(seen["rs"]) == sorted(shape for shape, _ in seen["gather"])
        assert w1 in seen["rs"]
