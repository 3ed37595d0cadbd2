"""The paper's Table I–III and Fig 3, 5, 6, 15, 17 benchmarks on the port
against the JAX package's, on the CPU, and the benchmark runner. Weights
cross as numpy arrays (``interop.params_from_numpy``; the module's
``jax_full_params`` fixture holds JAX's own at ``CONFIG``), so a benchmark
whose numbers depend on the weights runs on the same arrays in both.
Moved out of ``test_torch_paper.py`` unchanged. Each tolerance is stated
beside its check."""
import dataclasses
import json
import os
import re

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
from repro.models import snn_yolo as jsy  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.benchmarks import (  # noqa: E402
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
from repro_torch.configs.snn_det import CONFIG  # noqa: E402
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


# ------------------------------------------------------------------ runner --


def test_runner_runs_jax_suites_in_jax_order():
    """The suite list is JAX's ``benchmarks/run.py`` list, ``roofline``
    (the port's dry-run artifacts) included."""
    with open(os.path.join(ROOT, "benchmarks", "run.py")) as f:
        jax_names = re.findall(r'\(\s*"(\w+)",\s*lambda', f.read())
    assert "roofline" in jax_names
    names = [n for n, _ in run.suites(fast=True, device="cpu")]
    assert names == jax_names


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
