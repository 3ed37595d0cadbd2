"""The port's sharded (ZeRO-3) training state, ``repro_torch.distributed.
fsdp``, against the JAX launcher's ``default_rules(mesh, fsdp=True)`` on the
CPU, at ``smoke_config`` of the three ``fsdp`` LM configs:

* (a) in process, for 2 and 4 processes: every leaf of the train state
  (params and both moments, f32 and int8) is split where JAX's spec names
  the data axis, to ``shard_shape`` of that spec; the slices join back to
  the whole state bit for bit;
* (b) two gloo processes pack the int8 moment of a ``wo`` leaf split along
  its last (``embed``) dimension: payload and scales bit-equal to JAX's
  ``_q8_pack`` of the whole leaf;
* (c) two gloo processes take one sharded ``make_train_step`` step of
  qwen1.5-32b (int8 moments) from JAX's initial state, without and with
  remat: the gathered gradients, parameters and moments held to JAX's
  jitted step under the bounds of ``tests/test_torch_lm_train.py`` (R6,
  R8, R9);
* (d) ``launch.train --arch qwen1.5-32b --int8-moments`` in two processes:
  the losses equal one process's within rtol 2e-4, atol 1e-5 (the bound of
  ``test_data_parallel_train_loss_parity``) and each process holds at most
  0.52 of the one-process state's bytes;
* (e) its checkpoint, saved sharded, restored whole by one process through
  both packages' ``restore``, bit-equal to the gathered state; a
  one-process checkpoint resumed by two processes continues the
  uninterrupted loss series.

The children are ``python -c`` processes with the 300 s limit and the
``runtime.TIMEOUT_S`` group timeout of ``tests/test_torch_multihost.py``,
each job on a free port.
"""
import dataclasses
import functools
import json
import os
import shutil
import subprocess
import sys
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
from repro_torch import configs  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.data import lm_data  # noqa: E402
from repro_torch.distributed import fsdp, runtime  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import trainer  # noqa: E402
from test_torch_lm_train import (  # noqa: E402
    GNORM_RTOL, GRAD_TOL, LOSS_RTOL, _applied, _check_moments, _check_params, _jax_model,
    _jax_step, _leaf_err, _np, _ocfg, _rel)
from test_torch_multihost import _ENV, ROOT, _collect, _free_port, _run_group  # noqa: E402

FSDP_ARCHS = ["qwen1.5-32b", "qwen1.5-110b", "llama3-405b"]
ARCH = "qwen1.5-32b"
BATCH, SEQ = 8, 16
# 24 steps: the Supervisor saves at steps 19 and 23, and the loss falls over
# the whole run and over the resumed steps 20..23 (the launcher's gate)
STEPS = 24
RESUME_FROM = 19
LOSS_RTOL_2P, LOSS_ATOL_2P = 2e-4, 1e-5  # test_data_parallel_train_loss_parity's bound
STATE_SHARE = 0.52  # of the one-process state's bytes, per process of two


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The in-process runs here are many tiny ops: one intra-op thread
    keeps them from contending with the child processes and the other test
    processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ctx(rank, n):
    return runtime.DistributedContext(rank, n, device_type="cpu")


def _join_leaf(parts, s):
    """The whole leaf from every process's slice, in rank order."""
    if not s.split:
        return parts[0]
    return torch.cat(parts, dim=s.dim).narrow(s.dim, 0, s.whole)


def _join_shards(trees, specs):
    """The whole tree from every process's local tree (rank order)."""
    flat = [tu.leaves(t) for t in trees]
    joined = [_join_leaf([f[i] for f in flat], s) for i, s in enumerate(tu.leaves(specs))]
    return tu.unflatten_like(trees[0], joined)


def _port_specs(arch, n, rank, int8):
    cfg = configs.smoke_config(configs.get_config(arch))
    api = zoo.get_api(cfg)
    ocfg = opt.AdamWConfig(int8_moments=int8)
    ctx = _ctx(rank, n)
    rules = shd.default_rules(fsdp.mesh_for(ctx), fsdp=True)
    return cfg, api, ocfg, trainer.state_specs(api.param_axes(),
                                               api.init_params(0, device="meta"), ocfg,
                                               rules, ctx)


# --------------------------------------------------------- (a) the layout --


@pytest.mark.parametrize("int8", [False, True], ids=["f32m", "int8m"])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_local_shapes_follow_jax_specs_and_join_back(arch, n, int8):
    """Each leaf's local shape is ``shard_shape`` of JAX's spec (JAX's
    ``spec_for`` over its ``default_rules(mesh, fsdp=True)``, which reads
    only the mesh's axis names); the split leaves are exactly those whose
    axes hold ``embed``; the slices of every rank join back bit-equal."""
    jcfg = jconfigs.smoke_config(jconfigs.get_config(arch))
    jaxes = jtrainer.train_state_axes(jzoo.get_api(jcfg).param_axes(),
                                      jopt.AdamWConfig(int8_moments=int8))
    jrules = jshd.default_rules(types.SimpleNamespace(axis_names=("data", "model")), fsdp=True)
    is_ax = lambda x: isinstance(x, tuple) and all(  # noqa: E731
        isinstance(a, (str, type(None))) for a in x)
    jflat = jax.tree_util.tree_flatten_with_path(jaxes, is_leaf=is_ax)[0]
    mesh = shd.MeshShape(("data", "model"), (n, 1))

    cfg, api, ocfg, _ = _port_specs(arch, n, 0, int8)
    gen = torch.Generator().manual_seed(3)
    whole = tu.tree_map(lambda t: (torch.randn(t.shape, generator=gen) * 50).to(t.dtype),
                        trainer.init_train_state(api.init_params(0, device="cpu"), ocfg))
    paths, leaves = tu.flatten_with_paths(whole)
    assert len(paths) == len(jflat)
    locals_ = []
    n_split = 0
    for rank in range(n):
        specs = _port_specs(arch, n, rank, int8)[3]
        local = fsdp.shard_tree(whole, specs)
        for (jpath, axes), w, loc, s in zip(jflat, leaves, tu.leaves(local), tu.leaves(specs)):
            want = shd.shard_shape(tuple(w.shape), tuple(jshd.spec_for(axes, jrules)), mesh)
            assert tuple(loc.shape) == want, (jax.tree_util.keystr(jpath), loc.shape, want)
            assert s.split == ("embed" in axes), (jax.tree_util.keystr(jpath), axes)
            n_split += s.split
        locals_.append(local)
    assert n_split > 0
    joined = _join_shards(locals_, specs)
    for a, b in zip(tu.leaves(whole), tu.leaves(joined)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("arch", FSDP_ARCHS)
def test_sliced_init_draws_the_whole_inits_slices(arch, n):
    """``init_params(specs=)`` draws one layer at a time and keeps this
    rank's slices: bit-equal to slicing the whole init; a sharded state
    refuses whole parameters."""
    _, api, ocfg, _ = _port_specs(arch, n, 0, True)
    whole = api.init_params(0, device="cpu")
    for rank in range(n):
        specs = _port_specs(arch, n, rank, True)[3]
        got = api.init_params(0, device="cpu", specs=specs.params)
        for a, b in zip(tu.leaves(got), tu.leaves(fsdp.shard_tree(whole, specs.params))):
            assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="slice"):
        trainer.init_train_state(whole, ocfg, specs=specs)


def test_uneven_split_pads_the_last_slice():
    """A dimension the process count does not divide: slices of the
    rounded-up size, the last one zero-padded, joined back exactly."""
    x = torch.arange(2 * 5 * 7, dtype=torch.float32).reshape(2, 5, 7)
    specs = [fsdp.Shard(dim=2, whole=7, n=4, rank=r) for r in range(4)]
    parts = [fsdp.shard_leaf(x, s) for s in specs]
    assert [tuple(p.shape) for p in parts] == [(2, 5, 2)] * 4
    assert torch.equal(parts[3][..., 1], torch.zeros(2, 5))
    assert torch.equal(_join_leaf(parts, specs[0]), x)
    assert fsdp.local_shape(x.shape, specs[0]) == shd.shard_shape(
        x.shape, (None, None, "data"), shd.MeshShape(("data",), (4,)))


def test_sharded_step_refusals():
    """A sharded state needs a process group. (Error-feedback compression
    with a sharded state runs: ``tests/test_torch_lm_train_modal.py``.)"""
    _, api, ocfg, specs = _port_specs(ARCH, 2, 0, True)
    with pytest.raises(ValueError, match="ctx="):
        trainer.make_train_step(api.loss_fn, ocfg, specs=specs)


def test_launcher_keeps_the_archs_fsdp_at_the_smoke_config():
    args = launch_train.parse_args(["--arch", ARCH])
    cfg = launch_train.launch_config(args)
    assert cfg.fsdp and cfg.d_model == 64
    assert not launch_train.launch_config(launch_train.parse_args(["--arch",
                                                                   "qwen1.5-0.5b"])).fsdp


# ------------------------------------- (b), (c) two processes, in process --

_STEP_BODY = """
import dataclasses
from repro_torch import tree as tu
from repro_torch.configs import get_config, smoke_config
from repro_torch.data import lm_data
from repro_torch.distributed import collectives, fsdp
from repro_torch.distributed import sharding as shd
from repro_torch.models import zoo
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer
collectives.PIECE_BYTES = 256  # several pieces a collective: the pipelined gloo path
d = np.load({inputs!r})
out = {{}}
rules = shd.default_rules(fsdp.mesh_for(ctx), fsdp=True)
# (b) a wo-like leaf split along its last (embed) axis, packed as the update does
for name in ("wo", "wo_odd"):
    x = torch.from_numpy(d[name])
    s = tu.leaves(fsdp.local_specs({{"w": ("layers", "qkv", "embed")}}, {{"w": x}}, rules,
                                   ctx))[0]
    q, scale = opt._q8_pack(fsdp.shard_leaf(x, s),
                            row_max=lambda a: fsdp.allreduce_(a, ctx, "max"))
    out[name + "_q"] = fsdp.all_gather_leaf(q, s, ctx).numpy()
    out[name + "_scale"] = scale.numpy()
if ctx.host_id == 1:
    print("SCALES=" + json.dumps({{k: v.tolist() for k, v in out.items() if "scale" in k}}))
# (c) one sharded step of qwen1.5-32b from JAX's initial state, without and
# with remat (under remat each layer is gathered again in its backward)
for remat in (False, True):
    cfg = dataclasses.replace(smoke_config(get_config("qwen1.5-32b")), remat=remat)
    api = zoo.get_api(cfg)
    ocfg = opt.AdamWConfig(warmup_steps=2, total_steps=20, int8_moments=True)
    meta = api.init_params(0, device="meta")
    params = tu.unflatten_like(meta, [torch.from_numpy(d["p%d" % i])
                                      for i in range(len(tu.leaves(meta)))])
    specs = trainer.state_specs(api.param_axes(), meta, ocfg, rules, ctx)
    state = trainer.init_train_state(fsdp.shard_tree(params, specs.params), ocfg, specs=specs)
    rows = lm_data.batch_at(0, batch_size={batch} // ctx.n_hosts, seq_len={seq},
                            vocab=cfg.vocab_size, host_id=ctx.host_id, n_hosts=ctx.n_hosts)
    batch = {{k: torch.from_numpy(v) for k, v in rows.items()}}
    _, grads = trainer.loss_and_grads(api.loss_fn, state.params, batch, specs=specs.params,
                                      ctx=ctx)
    collectives.allreduce_mean_([g for g, s in zip(tu.leaves(grads), tu.leaves(specs.params))
                                 if not s.split], ctx)
    grads = fsdp.gather_tree(grads, specs.params, ctx)
    step = trainer.make_train_step(api.loss_fn, ocfg, ctx=ctx, specs=specs)
    new, m = step(state, batch)
    whole = fsdp.gather_tree(new, specs, ctx)
    tag = "remat_" if remat else ""
    for i, g in enumerate(tu.leaves(grads)):
        out["%sg%d" % (tag, i)] = g.numpy()
    for i, leaf in enumerate(tu.leaves(whole)):
        out["%ss%d" % (tag, i)] = leaf.numpy()
    if ctx.host_id == 0:
        print("METRICS=" + json.dumps({{"remat": remat,
                                        **{{k: float(v) for k, v in m.items()}}}}))
if ctx.host_id == 0:
    np.savez({result!r}, **out)
"""


def _wo_inputs(shape, seed):
    """f32 rows whose max |x| falls in either half of the split axis."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, shape).astype(np.float32)
    x[..., 0] *= 40  # the first half's max in some rows
    x[..., -1] *= np.where(rng.random(shape[:-1]) < 0.5, 80, 1).astype(np.float32)
    return x


@pytest.fixture(scope="module")
def two_process_step(tmp_path_factory):
    """The (b) and (c) job, run once: JAX's inputs in, the gathered
    results of host 0 out."""
    d = tmp_path_factory.mktemp("fsdp_step")
    _, japi, jp, _ = _jax_model(ARCH)
    inputs = {"wo": _wo_inputs((2, 64, 64), 0), "wo_odd": _wo_inputs((2, 64, 63), 1)}
    inputs.update({f"p{i}": np.asarray(a) for i, a in enumerate(jax.tree_util.tree_leaves(jp))})
    np.savez(d / "inputs.npz", **inputs)
    outs = _run_group(_STEP_BODY.format(inputs=str(d / "inputs.npz"),
                                        result=str(d / "result.npz"), batch=BATCH, seq=SEQ))
    metrics = {m.pop("remat"): m for m in (
        json.loads(ln[len("METRICS="):]) for ln in outs[0].splitlines()
        if ln.startswith("METRICS="))}
    scales1 = json.loads(next(ln for ln in outs[1].splitlines()
                              if ln.startswith("SCALES="))[len("SCALES="):])
    return inputs, dict(np.load(d / "result.npz")), metrics, {
        k: np.asarray(v, np.float32) for k, v in scales1.items()}


def test_split_wo_int8_moment_bit_equal_to_jax(two_process_step):
    """(b) The row scale is the max over both processes' halves of the row:
    payload and scales equal JAX's ``_q8_pack`` of the whole leaf, on both
    processes, including a last dimension that two does not divide."""
    inputs, res, _, scales1 = two_process_step
    for name in ("wo", "wo_odd"):
        jq, js = jopt._q8_pack(jnp.asarray(inputs[name]))
        assert res[name + "_q"].dtype == np.int8
        np.testing.assert_array_equal(res[name + "_q"], np.asarray(jq))
        np.testing.assert_array_equal(res[name + "_scale"], np.asarray(js))  # host 0's
        np.testing.assert_array_equal(scales1[name + "_scale"], np.asarray(js))  # host 1's


@functools.lru_cache(maxsize=None)
def _jax_remat_model(arch):
    """JAX's config with ``remat=True``, its api and jitted value_and_grad
    and train step (int8 moments): the parameters equal ``_jax_model``'s,
    which no config flag of the init reads."""
    jcfg = dataclasses.replace(jconfigs.smoke_config(jconfigs.get_config(arch)), remat=True)
    japi = jzoo.get_api(jcfg)
    return (jax.jit(jax.value_and_grad(japi.loss_fn)),
            jax.jit(jtrainer.make_train_step(japi.loss_fn, _ocfg(True)[0])))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_sharded_train_step_matches_jax(two_process_step, remat):
    """(c) One step on two processes, each with half of the batch and its
    slices of the state, gathered: loss and gradient norm within the
    one-process bounds of JAX's jitted step, every gradient within
    GRAD_TOL, parameters per R6/R8, int8 moments per R9's rule (payloads
    within one, scales within MOMENT_TOL). With ``remat`` against JAX's
    step at ``remat=True``: each layer's weights are gathered again inside
    the checkpointed block's backward, and its gradient reduce-scattered
    once."""
    _, res, metrics, _ = two_process_step
    m = metrics[remat]
    tag = "remat_" if remat else ""
    _, japi, jp, vg = _jax_model(ARCH)
    jstep = _jax_step(ARCH, 1, False, True)
    if remat:
        vg, jstep = _jax_remat_model(ARCH)
    jo, _ = _ocfg(True)
    cfg = configs.smoke_config(configs.get_config(ARCH))
    b = {k: jnp.asarray(v) for k, v in
         lm_data.batch_at(0, batch_size=BATCH, seq_len=SEQ, vocab=cfg.vocab_size).items()}
    js = jtrainer.init_train_state(jp, jo)
    jnew, jm = jstep(js, b)
    jgrads = vg(jp, b)[1]
    jg_leaves = jax.tree_util.tree_leaves(_np(jgrads))
    gworst = max(_leaf_err(w, res[f"{tag}g{i}"]) for i, w in enumerate(jg_leaves))
    lerr, nerr = _rel(m["loss"], jm["loss"]), _rel(m["grad_norm"], jm["grad_norm"])
    print(f"sharded step (remat={remat}): loss rel {lerr:.2e}, grad_norm rel {nerr:.2e}, "
          f"grads {gworst:.2e}")
    assert lerr <= LOSS_RTOL and nerr <= GNORM_RTOL and gworst <= GRAD_TOL
    assert m["lr"] == float(jm["lr"]) and m["step"] == 1
    api = zoo.get_api(cfg)
    template = trainer.init_train_state(api.init_params(0, device="meta"),
                                        opt.AdamWConfig(int8_moments=True))
    new = tu.unflatten_like(template, [torch.from_numpy(res[f"{tag}s{i}"])
                                       for i in range(len(tu.leaves(template)))])
    lr, eps = float(jm["lr"]), max(jo.eps, 1e-5)
    pworst = _check_params(jp, jnew.params, new.params, _applied(jgrads, False, jo.grad_clip),
                           lr, eps)
    print(f"  params (well-conditioned): worst rel {pworst:.2e}")
    _check_moments(jnew.opt, new.opt, [np.zeros(g.shape, bool) for g in jg_leaves])
    assert int(new.opt.step) == 1


# ------------------------------------------------- (d), (e) the launcher --

# one process of launch.train: the state gathered by every process before
# the group closes, written whole by host 0
_LAUNCH_CHILD = r"""
import json, sys
import numpy as np
from repro_torch import tree as tu
from repro_torch.distributed import fsdp
from repro_torch.launch import train as lt
a = json.loads(sys.argv[1])
real = lt.train
def train(args, ctx, dev, cfg=None):
    res = real(args, ctx, dev, cfg)
    whole = fsdp.gather_tree(res["state"], res["specs"], ctx)
    if ctx.host_id == 0:
        np.savez(a["gathered"], **{str(i): t.numpy() for i, t in enumerate(tu.leaves(whole))})
    print("BYTES=" + json.dumps(res["state_bytes"]), flush=True)
    print("GNORMS=" + json.dumps(res["grad_norms"]), flush=True)
    return res
lt.train = train
lt.main(a["argv"])
"""


def _launch_two(argv, gathered):
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _LAUNCH_CHILD, json.dumps({"gathered": str(gathered), "argv": [
            *argv, "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
            "--process-id", str(pid)]})],
        env=_ENV, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]
    return _collect(procs)


def _json_line(out, key):
    return json.loads(next(ln for ln in out.splitlines()
                           if ln.startswith(key + "="))[len(key) + 1:])


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """One process (in process, the reference) and two processes, each
    ``--steps 24 --ckpt``; then the one-process checkpoint cut back to step
    19 and resumed by two processes."""
    d = tmp_path_factory.mktemp("fsdp_launch")
    common = ["--arch", ARCH, "--int8-moments", "--steps", str(STEPS), "--batch", str(BATCH),
              "--seq", str(SEQ), "--device", "cpu"]
    one = launch_train.main(common + ["--ckpt", str(d / "one")])
    two_out = _launch_two(common + ["--ckpt", str(d / "two"), "--losses-out",
                                    str(d / "two.json")], d / "two_state.npz")
    shutil.rmtree(d / "one" / f"step_{STEPS - 1:09d}")
    resumed_out = _launch_two(common + ["--ckpt", str(d / "one"), "--losses-out",
                                        str(d / "resumed.json")], d / "resumed_state.npz")
    return types.SimpleNamespace(
        d=d, one=one, two_out=two_out, resumed_out=resumed_out,
        two=json.loads((d / "two.json").read_text()),
        resumed=json.loads((d / "resumed.json").read_text()),
        gathered=np.load(d / "two_state.npz"))


def test_two_process_losses_equal_one_process(launches):
    """(d) The sharded two-process run's losses and gradient norms equal
    the replicated one's, and each process holds at most 0.52 of its
    state's bytes."""
    one, two = launches.one["losses"], launches.two
    assert len(two) == len(one) == STEPS
    np.testing.assert_allclose(two, one, rtol=LOSS_RTOL_2P, atol=LOSS_ATOL_2P)
    for out in launches.two_out:
        np.testing.assert_allclose(_json_line(out, "GNORMS"), launches.one["grad_norms"],
                                   rtol=LOSS_RTOL_2P, atol=LOSS_ATOL_2P)
    whole = launches.one["state_bytes"]
    whole_total = whole["params"] + whole["grads"] + whole["moments"]
    assert launches.one["specs"] is None and whole["whole"] == {
        k: whole[k] for k in ("params", "grads", "moments")}
    for out in launches.two_out:
        got = _json_line(out, "BYTES")
        assert got["whole"] == whole["whole"]
        share = (got["params"] + got["grads"] + got["moments"]) / whole_total
        print(f"per-process state share {share:.4f} (bound {STATE_SHARE})")
        assert share <= STATE_SHARE
        assert "bytes whole" in out
    assert f"{ARCH}: {STEPS} steps" in launches.two_out[0]


def test_sharded_checkpoint_restored_whole_by_both_packages(launches):
    """(e) The two processes' last checkpoint (each split leaf gathered and
    written whole, the leaves striped over the hosts) restores in one
    process through the port's ``restore`` and JAX's, bit-equal to the
    state the two processes gathered."""
    root = str(launches.d / "two")
    cfg = launch_train.launch_config(launch_train.parse_args(["--arch", ARCH]))
    api = zoo.get_api(cfg)
    ocfg = opt.AdamWConfig(int8_moments=True)
    state, step = ckpt.restore(root, trainer.init_train_state(api.init_params(0, device="cpu"),
                                                              ocfg))
    assert step == STEPS - 1
    got = [launches.gathered[str(i)] for i in range(len(tu.leaves(state)))]
    for a, b in zip(tu.leaves(state), got):
        assert a.numpy().dtype == b.dtype and np.array_equal(a.numpy(), b)
    _, japi, jp, _ = _jax_model(ARCH)
    jstate, jstep = jckpt.restore(root, jtrainer.init_train_state(jp, _ocfg(True)[0]))
    assert jstep == STEPS - 1
    for a, b in zip(jax.tree_util.tree_leaves(jstate), got):
        assert np.asarray(a).dtype == b.dtype and np.array_equal(np.asarray(a), b)
    manifest = json.loads((launches.d / "two" / f"step_{STEPS - 1:09d}" /
                           "shard_manifest.json").read_text())
    assert manifest["n_hosts"] == 2 and set(manifest["hosts"]) == {"0", "1"}


def test_one_process_checkpoint_resumes_in_two(launches):
    """(e) A checkpoint one process wrote (whole leaves) resumes in two,
    each reading its own slices: steps 20..23 continue the uninterrupted
    one-process series."""
    one = launches.one["losses"]
    assert len(launches.resumed) == STEPS - RESUME_FROM - 1
    np.testing.assert_allclose(launches.resumed, one[RESUME_FROM + 1:], rtol=LOSS_RTOL_2P,
                               atol=LOSS_ATOL_2P)


def test_sharded_restore_reads_own_slices(launches, tmp_path):
    """``restore(specs=)`` of a whole checkpoint gives each rank exactly its
    slices of the whole state (the resumed job's reads, in process)."""
    root = str(launches.d / "two")
    _, api, ocfg, _ = _port_specs(ARCH, 2, 0, True)
    whole_t = trainer.init_train_state(api.init_params(0, device="cpu"), ocfg)
    whole, _ = ckpt.restore(root, whole_t)
    parts = []
    for rank in range(2):
        specs = _port_specs(ARCH, 2, rank, True)[3]
        template = trainer.init_train_state(
            api.init_params(0, device="cpu", specs=specs.params), ocfg, specs=specs)
        local, _ = ckpt.restore(root, template, specs=specs)
        for a, b in zip(tu.leaves(local), tu.leaves(fsdp.shard_tree(whole, specs))):
            assert torch.equal(a, b)
        parts.append(local)
    for a, b in zip(tu.leaves(_join_shards(parts, specs)), tu.leaves(whole)):
        assert torch.equal(a, b)


def test_fsdp_module_imports_no_jax():
    code = ("import sys, repro_torch.distributed.fsdp, repro_torch.launch.train\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'repro' or m.startswith('repro.')]\n"
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code],
                       env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
