"""The port's sharding metadata against the JAX package's, leaf by leaf:
every axes tree (``param_axes``, ``cache_axes``, ``batch_axes``, the train
state's) for all ten LM configs, the rules table with ``spec_for`` /
``sanitize_spec`` on the reference's meshes (JAX's side on an
``AbstractMesh``: no devices), ``input_specs``' shapes and dtypes, and the
helpers JAX has no counterpart of (``shard_shape``, ``to_placements``).
Paths are spelled by ``repro_torch.tree`` on both sides."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import smoke_config as jsmoke  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.configs.base import smoke_config  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "host": ((2, 4), ("data", "model"))}


def _flat(tree):
    return tu.flatten_with_paths(tree, is_leaf=shd.is_axes)


@functools.cache
def _meta_params(arch):
    return zoo.get_api(get_config(arch)).init_params(0, device="meta")


def _cells(arch):
    return [s for s in SHAPES if s not in get_config(arch).skip_shapes]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_equal_jax_and_fit_the_params(arch):
    api = zoo.get_api(smoke_config(get_config(arch)))
    jp, jl = _flat(jzoo.get_api(jsmoke(jget_config(arch))).param_axes())
    pp, pl = _flat(api.param_axes())
    assert (pp, pl) == (jp, jl)
    params = api.init_params(0, device="cpu")
    paths, leaves = tu.flatten_with_paths(params)
    assert paths == pp
    for path, leaf, axes in zip(paths, leaves, pl):
        assert leaf.dim() == len(axes), (path, tuple(leaf.shape), axes)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_axes_equal_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert _flat(zoo.get_api(cfg).cache_axes(4, 64)) == \
        _flat(jzoo.get_api(jcfg).cache_axes(4, 64))
    for name in _cells(arch):
        assert _flat(zoo.batch_axes(cfg, SHAPES[name])) == \
            _flat(jzoo.batch_axes(jcfg, SHAPES[name])), name


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_jax(arch):
    """meta tensors where JAX gives ShapeDtypeStructs: the same shapes and
    dtypes, leaf by leaf, for every cell of the config."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name in _cells(arch):
        got = tu.flatten_with_paths(zoo.input_specs(cfg, SHAPES[name]))
        want = tu.flatten_with_paths(jzoo.input_specs(jcfg, SHAPES[name]))
        assert got[0] == want[0], name
        for t, s in zip(got[1], want[1]):
            assert t.device.type == "meta"
            assert (tuple(t.shape), _dtype_name(t.dtype)) == (tuple(s.shape), str(s.dtype))
        batch_axes = _flat(zoo.batch_axes(cfg, SHAPES[name]))[1]
        assert len(batch_axes) == len(got[1])
        for t, axes in zip(got[1], batch_axes):
            assert t.dim() == len(axes)


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_rules_and_specs_equal_jax(mesh_name, fsdp):
    """default_rules, spec_for and sanitize_spec over every parameter of
    every config (full width, shapes from the meta tree), per leaf."""
    sizes, names = MESHES[mesh_name]
    jmesh, mesh = AbstractMesh(sizes, names), shd.MeshShape(names, sizes)
    for kv_seq_shard in (True, False):
        jr = jshd.default_rules(jmesh, fsdp=fsdp, kv_seq_shard=kv_seq_shard)
        r = shd.default_rules(mesh, fsdp=fsdp, kv_seq_shard=kv_seq_shard)
        assert r == jr
    rules, jrules = shd.default_rules(mesh, fsdp=fsdp), jshd.default_rules(jmesh, fsdp=fsdp)
    for arch in ARCH_IDS:
        api = zoo.get_api(get_config(arch))
        axes = _flat(api.param_axes())[1]
        shapes = [tuple(t.shape) for t in tu.leaves(_meta_params(arch))]
        specs = tu.leaves(shd.tree_specs_for(mesh, api.param_axes(), _meta_params(arch), rules),
                          is_leaf=shd.is_spec)
        for ax, shape, spec in zip(axes, shapes, specs):
            want = jshd.spec_for(ax, jrules)
            assert shd.spec_for(ax, rules) == tuple(want)
            assert spec == tuple(jshd.sanitize_spec(jmesh, want, shape)), (arch, ax, shape)
            local = shd.shard_shape(shape, spec, mesh)
            assert np.prod(local) * shd.num_devices(mesh) >= np.prod(shape)


@pytest.mark.parametrize("int8,compress", [(False, False), (True, True)])
def test_train_state_axes_equal_jax(int8, compress):
    cfg, jcfg = smoke_config(get_config("olmoe-1b-7b")), jsmoke(jget_config("olmoe-1b-7b"))
    got = trainer.train_state_axes(zoo.get_api(cfg).param_axes(),
                                   opt.AdamWConfig(int8_moments=int8), grad_compress=compress)
    want = jtrainer.train_state_axes(jzoo.get_api(jcfg).param_axes(),
                                     jopt.AdamWConfig(int8_moments=int8), grad_compress=compress)
    assert _flat(got) == _flat(want)
    state = trainer.init_train_state(zoo.get_api(cfg).init_params(0, device="meta"),
                                     opt.AdamWConfig(int8_moments=int8),
                                     grad_compress=compress)
    for t, axes in zip(tu.leaves(state), _flat(got)[1]):
        assert t.dim() == len(axes)


def test_shard_shape_and_placements():
    mesh = shd.MeshShape(("data", "model"), (2, 4))
    assert shd.shard_shape((8, 12, 3), ("data", "model", None), mesh) == (4, 3, 3)
    assert shd.shard_shape((8, 12), (("data", "model"), None), mesh) == (1, 12)
    assert shd.shard_shape((5,), ("model",), mesh) == (2,)  # the padded last shard
    assert shd.num_devices(mesh) == 8

    class FakeMesh:  # the DeviceMesh surface to_placements reads
        mesh_dim_names = ("data", "model")

    from torch.distributed.tensor import Replicate, Shard

    assert shd.to_placements(("model", "data"), FakeMesh()) == (Shard(1), Shard(0))
    assert shd.to_placements((None, "model"), FakeMesh()) == (Replicate(), Shard(1))
    assert shd.to_placements((("data", "model"), None), FakeMesh()) == (Shard(0), Shard(0))
    with pytest.raises(ValueError, match="shards two"):
        shd.to_placements(("model", "model"), FakeMesh())


def test_constrain_is_identity_without_a_mesh():
    x = torch.arange(6.0).reshape(2, 3)
    rules = shd.default_rules(shd.MeshShape(("data", "model"), (2, 2)))
    assert shd.constrain(x, ("batch", None), rules) is x
    assert shd.constrain_act(x, ("batch", None)) is x
    with shd.use_rules(rules):
        assert shd.current_rules() is rules and shd.current_mesh() is None
        assert shd.constrain_act(x, ("batch", None)) is x
    assert shd.current_rules() is None


@pytest.mark.parametrize("n_mb", [1, 2])
def test_grad_shardings_change_no_value(n_mb):
    """make_train_step(grad_shardings=) no longer raises, and its step is
    bit-equal to the step without it; a spec tree of another structure is
    refused."""
    cfg = dataclasses.replace(smoke_config(get_config("qwen1.5-0.5b")), remat=False)
    api = zoo.get_api(cfg)
    ocfg = opt.AdamWConfig()
    mesh = shd.MeshShape(("data", "model"), (2, 2))
    specs = shd.tree_specs(api.param_axes(), shd.default_rules(mesh, fsdp=True))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32))
    batch = {"tokens": toks, "labels": toks}
    outs = []
    for gs in (None, specs):
        state = trainer.init_train_state(api.init_params(0, device="cpu"), ocfg)
        step = trainer.make_train_step(api.loss_fn, ocfg, n_microbatch=n_mb, grad_shardings=gs)
        for _ in range(2):
            state, metrics = step(state, batch)
        outs.append((tu.leaves(state), metrics))
    for a, b in zip(outs[0][0], outs[1][0]):
        assert torch.equal(a, b)
    assert float(outs[0][1]["loss"]) == float(outs[1][1]["loss"])
    bad = dict(specs)
    bad.pop("embed")
    step = trainer.make_train_step(api.loss_fn, ocfg, grad_shardings=bad)
    with pytest.raises(ValueError, match="structure"):
        step(trainer.init_train_state(api.init_params(0, device="cpu"), ocfg), batch)


def test_slice_modules_import_no_jax():
    """``import repro_torch`` and this slice's modules pull in neither JAX
    nor the JAX package (a fresh interpreter)."""
    import os
    import subprocess
    import sys

    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    code = (
        "import sys, repro_torch, repro_torch.kernels.autotune, "
        "repro_torch.distributed.sharding, repro_torch.distributed.embedding, "
        "repro_torch.distributed.kvops, repro_torch.launch.op_cost, repro_torch.launch.dryrun, "
        "repro_torch.benchmarks.roofline, repro_torch.benchmarks.detector_dryrun\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'repro' or m.startswith('repro.')]\n"
        "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], env={**os.environ, "PYTHONPATH": src},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
