"""The port's developer entry points against the JAX package's examples and
scripts, on the CPU: ``launch.quickstart`` (examples/quickstart.py),
``launch.mixed_timestep_search`` (examples/mixed_timestep_search.py),
``launch.serve_lm`` (examples/serve_lm.py), ``launch.make_ann_fixture``
(scripts/make_ann_fixture.py) and ``benchmarks.check_crossover``
(scripts/check_crossover.py).

Every case runs JAX-built arrays through both packages (``jax.random``
and torch draw other weights). The detector runs at ``smoke_config`` with
the quickstart's ``use_block_conv=False, mixed_time=True``, not the
examples' 144x256. Tolerances: counts, bytes, schedules, GOps, kernel
errors, spikes, detection counts and token streams equal; spike rates
(the f32 means of those equal spikes) within ``RATE_RTOL``; mIoUT within
``MIOUT_TOL``. The quickstart's tdBN state after calibration
and its affine bundles cross from JAX, since torch's rsqrt rounds
otherwise (ROADMAP R3).
"""
import dataclasses
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import convert as jcv  # noqa: E402
from repro.core import bitmask as jbitmask  # noqa: E402
from repro.core import miout as jmiout  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.core import pruning as jpruning  # noqa: E402
from repro.data import synthetic_detection as jsd  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import snn_yolo as jsy  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro_torch import convert as cv  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.benchmarks import check_crossover  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.launch import make_ann_fixture  # noqa: E402
from repro_torch.launch import mixed_timestep_search as search  # noqa: E402
from repro_torch.launch import quickstart, serve_lm  # noqa: E402
from repro_torch.models import snn_yolo as sy  # noqa: E402

MIOUT_TOL = 1e-6
RATE_RTOL = 2.0 ** -23  # one f32 ulp: the mean of equal spikes, rounded in another order
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "ann_detector", "ann_tiny_yolo.npz")
NEW_MODULES = ("repro_torch.launch.quickstart", "repro_torch.launch.mixed_timestep_search",
               "repro_torch.launch.serve_lm", "repro_torch.launch.make_ann_fixture",
               "repro_torch.benchmarks.check_crossover")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_frames(cfg, n):
    batch = next(jsd.batches(n, hw=cfg.input_hw, steps=1, grid_div=2 ** (cfg.pooled_stages + 1)))
    return jnp.asarray(batch["image"])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tiny torch ops: one intra-op thread keeps them from contending with
    the other test processes' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def det_cfgs():
    jcfg = dataclasses.replace(jconfigs.smoke_config(jconfigs.get_config("snn-det")),
                               use_block_conv=False, mixed_time=True)
    cfg = sy.config_from_dict(jsy.config_to_dict(jcfg))
    return jcfg, cfg


@pytest.fixture(scope="module")
def jax_weights(det_cfgs):
    jcfg, _ = det_cfgs
    # jitted: the same threefry bits as the eager call, without an eager
    # compile per layer
    return jax.jit(jsy.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)


@pytest.fixture(scope="module")
def jax_quickstart(det_cfgs, jax_weights):
    """examples/quickstart.py's steps with the JAX package's functions."""
    jcfg, _ = det_cfgs
    params, bn = jax_weights
    frame = _jax_frames(jcfg, 1)
    _, _, aux = jsy.forward(params, bn, frame, jcfg)  # eager: equal spikes (R4)
    pruned = jpruning.prune_tree(params, rate=0.8)
    w = np.asarray(pruned["stage4/main_a"]["w"])
    nnz = int((w != 0).sum())
    rng = np.random.default_rng(0)
    spikes = (rng.random((1, 18, 32, w.shape[2])) < 0.23).astype(np.int8)
    wq = np.asarray(np.clip(np.round(w * 127), -127, 127), np.int8)
    y = jops.gated_conv(jnp.asarray(spikes), jops.pack_conv_weights(wq), interpret=True)
    y_ref = jref.gated_conv_ref(jnp.asarray(spikes), jnp.asarray(wq))
    cbn = jsy.calibrate_bn_state(pruned, bn, frame, jcfg)
    det = jsy.compile_detector(jcfg, pruned, cbn)
    sess = det.new_session(batch=1)
    return {
        "param_count": jsy.param_count(params),
        "spikes": {k: np.asarray(v) for k, v in aux["spikes"].items()},
        "spike_rate": {k: float(v.mean()) for k, v in aux["spikes"].items()},
        "stage4/main_a": {"density": float((w != 0).mean()), **{
            f"{f}_bytes": jbitmask.format_bits((w.shape[3], w.size // w.shape[3]), nnz,
                                               weight_bits=8, fmt=f) // 8
            for f in ("dense", "csr", "bitmask")}},
        "miout": {k: float(jmiout.miout(aux["spikes"][k])) for k in ("conv_block", "stage3")},
        "kernel": {"max_err": int(jnp.max(jnp.abs(y.astype(jnp.int32)
                                                  - y_ref.astype(jnp.int32)))),
                   "taps_executed": int((wq != 0).sum()), "taps": wq.size},
        "detections": int(det(frame).count[0]),
        "session_counts": [int(sess.step(frame).detections.count[0]) for _ in range(3)],
        "calibrated_bn": _np(cbn),
        "affines": _np(jplan.precompute_affines(jplan.build_plan(pruned, jcfg), pruned, cbn,
                                                jcfg)),
    }


@pytest.fixture(scope="module")
def port_quickstart(det_cfgs, jax_weights, jax_quickstart):
    _, cfg = det_cfgs
    params, bn = jax_weights
    p, b, _ = interop.params_from_numpy(_np(params), _np(bn), device="cpu")
    _, cbn, aff = interop.params_from_numpy(_np(params), jax_quickstart["calibrated_bn"],
                                            jax_quickstart["affines"], device="cpu")
    spikes = {}
    forward = sy.forward

    def recording_forward(*a, **kw):  # step 2's spikes, for the exact check
        out = forward(*a, **kw)
        spikes.setdefault("step2", {k: v.numpy().copy() for k, v in out[2]["spikes"].items()})
        return out

    sy.forward = recording_forward
    try:
        r = quickstart.run(cfg, params=p, bn=b, calibrated_bn=cbn, affines=aff, device="cpu")
    finally:
        sy.forward = forward
    return r, spikes["step2"]


def test_quickstart_equals_jax(port_quickstart, jax_quickstart):
    got, spikes = port_quickstart
    want = jax_quickstart
    for k in ("param_count", "stage4/main_a", "kernel", "detections", "session_counts"):
        assert got[k] == want[k], k
    assert set(spikes) == set(want["spikes"]) == set(got["spike_rate"])
    for name, s in want["spikes"].items():
        np.testing.assert_array_equal(spikes[name], s, err_msg=name)
        # equal spikes; the f32 means round their division apart by an ulp
        np.testing.assert_allclose(got["spike_rate"][name], want["spike_rate"][name],
                                   rtol=RATE_RTOL, atol=0, err_msg=name)
    assert spikes["conv_block"].any(), "no spike past the encoder: the check is vacuous"
    for name, v in want["miout"].items():
        assert abs(got["miout"][name] - v) <= MIOUT_TOL, name
        assert got["in_t"][name] == (1 if v > 0.9 else 3)
    assert got["kernel"]["max_err"] == 0 and got["kernel_launches"] == 0  # plain on the CPU
    assert got["head_shape"] == (1, 6, 8, 5, 8)


@pytest.fixture(scope="module")
def jax_search_spikes(det_cfgs, jax_weights):
    """examples/mixed_timestep_search.py's forward: every layer at T=3,
    batch 2 (eager, as the example runs it)."""
    jcfg = dataclasses.replace(det_cfgs[0], mixed_time=False)
    params, bn = jax_weights
    return jsy.forward(params, bn, _jax_frames(jcfg, 2), jcfg)[2]["spikes"]


@pytest.mark.parametrize("threshold", [0.9, 0.5, 0.1])
def test_mixed_timestep_search_equals_jax(det_cfgs, jax_weights, jax_search_spikes, threshold):
    """examples/mixed_timestep_search.py's schedule and GOps; at 0.1 the
    conv block's mIoUT clears the threshold and drops to in_T=1."""
    jcfg, cfg = (dataclasses.replace(c, mixed_time=False) for c in det_cfgs)
    want = {}
    for name, s in jax_search_spikes.items():
        want[name] = 1 if s.shape[0] == 1 else (
            1 if float(jmiout.miout(s)) >= threshold else jcfg.full_t)
    specs = jsy.layer_specs(jconfigs.get_config("snn-det"))

    def gops(in_t_of):
        return sum(2 * sp.h * sp.w * sp.nnz * in_t_of(sp.name.split("/")[0]) * sp.bits_in
                   for sp in specs) / 1e9

    params, bn = jax_weights
    p, b, _ = interop.params_from_numpy(_np(params), _np(bn), device="cpu")
    got = search.run(cfg, threshold=threshold, params=p, bn=b, device="cpu")
    assert got["schedule"] == want
    for name, s in jax_search_spikes.items():
        if s.shape[0] > 1:
            assert abs(got["miout"][name] - float(jmiout.miout(s))) <= MIOUT_TOL, name
    assert got["base_gops"] == gops(lambda m: jcfg.full_t)
    assert got["proposed_gops"] == gops(lambda m: want.get(m, jcfg.full_t))
    if threshold == 0.1:
        assert got["schedule"]["conv_block"] == 1 and got["proposed_gops"] < got["base_gops"]


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "rwkv6-3b"])
def test_serve_burst_equals_jax_engine(arch):
    """examples/serve_lm.py's burst (12 requests, 4 slots, 128 rows) through
    both Engines on the same weights: every token stream equal."""
    jcfg = jconfigs.smoke_config(jconfigs.get_config(arch))
    jp = jzoo.get_api(jcfg).init_params(jax.random.PRNGKey(0))
    eng = JEngine(jcfg, jp, n_slots=4, max_seq=128)
    rng = np.random.default_rng(0)
    for r in range(12):
        plen = int(rng.integers(3, 24))
        n_new = int(rng.integers(4, 17))
        eng.submit(JRequest(rid=r, prompt=list(rng.integers(1, jcfg.vocab_size, plen)),
                            max_new_tokens=n_new))
    want = {r.rid: [int(t) for t in r.out] for r in eng.run()}
    p = interop.lm_params_from_numpy(_np(jp), smoke_config(get_config(arch)), device="cpu")
    got = serve_lm.serve_burst(arch, params=p, device="cpu")
    assert len(got["done"]) == 12 and got["tokens_per_s"] > 0
    assert {r.rid: [int(t) for t in r.out] for r in got["done"]} == want
    assert got["new_tokens"] == sum(len(v) for v in want.values())


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_make_ann_fixture_bundle_reads_in_both_packages(tmp_path, capsys):
    out = str(tmp_path / "ann.npz")
    r = make_ann_fixture.main(["--steps", "2", "--eval-images", "4", "--out", out,
                               "--device", "cpu"])
    printed = capsys.readouterr().out
    assert f"wrote {out}" in printed and "ANN mAP@0.5 = " in printed
    assert len(r["losses"]) == 2 and np.isfinite(r["losses"]).all()
    mine, theirs = cv.load_ann_npz(out), jcv.load_ann_npz(out)
    assert jsy.config_to_dict(theirs.cfg) == sy.config_to_dict(mine.cfg)
    assert mine.cfg.mode == "ann" and mine.cfg.input_hw == (96, 160)
    assert list(mine.layers) == list(theirs.layers)
    for name, layer in theirs.layers.items():
        for k, v in dataclasses.asdict(layer).items():
            np.testing.assert_array_equal(getattr(mine.layers[name], k), v,
                                          err_msg=f"{name}/{k}")
    np.testing.assert_array_equal(np.asarray(mine.head_w), np.asarray(theirs.head_w))


def test_make_ann_fixture_refuses_the_committed_fixture(tmp_path):
    before = _sha(FIXTURE)
    for path in (FIXTURE, os.path.relpath(FIXTURE)):
        with pytest.raises(ValueError, match="committed fixture"):
            make_ann_fixture.main(["--steps", "1", "--out", path, "--device", "cpu"])
    assert _sha(FIXTURE) == before


def _load_script_gate():
    spec = importlib.util.spec_from_file_location(
        "check_crossover_script", os.path.join(ROOT, "scripts", "check_crossover.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _payload(dense_s, pallas_s, *, diff=0.0):
    return {"executors": {
        "dense": {"wall_s": dense_s, "max_abs_diff_vs_dense": 0.0},
        "gated": {"wall_s": dense_s, "max_abs_diff_vs_dense": diff},
        "pallas": {"wall_s": pallas_s, "max_abs_diff_vs_dense": diff},
    }}


# tests/test_ci_gates.py::TestCrossoverGate's cases: (payload, ok, text in the message)
CROSSOVER_CASES = {
    "pallas_faster_passes": (_payload(0.008, 0.0078), True, "crossover holds"),
    "pallas_within_tolerance_passes": (_payload(0.008, 0.0082), True, "crossover holds"),
    "pallas_slower_fails": (_payload(0.0079, 0.0108), False, "slower than dense"),
    "sub_floor_walls_skip": (_payload(0.0004, 0.0009), True, "skipped"),
    "nonzero_diff_fails_even_when_faster": (_payload(0.008, 0.004, diff=1e-6), False,
                                            "max_abs_diff_vs_dense"),
    "missing_executor_fails": ({"executors": {"dense": {"wall_s": 0.008,
                                                        "max_abs_diff_vs_dense": 0.0}}},
                               False, "missing dense/pallas"),
}


@pytest.mark.parametrize("case", [*CROSSOVER_CASES, "cli_exit_codes"])
def test_crossover_gate(case, tmp_path, capsys):
    script = _load_script_gate()
    if case == "cli_exit_codes":
        good, bad = tmp_path / "good.json", tmp_path / "bad.json"
        good.write_text(json.dumps(_payload(0.008, 0.0078)))
        bad.write_text(json.dumps(_payload(0.0079, 0.0108)))
        for path, rc in ((good, 0), (bad, 1), (tmp_path / "absent.json", 1)):
            assert check_crossover.main(["--file", str(path)]) == rc
            assert script.main(["--file", str(path)]) == rc
        out = capsys.readouterr().out.splitlines()
        assert out[0::2] == out[1::2]  # the same line from both
        return
    data, ok, text = CROSSOVER_CASES[case]
    got = check_crossover.check(data, tolerance=0.05, min_seconds=0.001)
    assert got == script.check(data, tolerance=0.05, min_seconds=0.001)
    assert got[0] is ok and text in got[1]


def test_crossover_default_file_is_the_ports(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert check_crossover.main([]) == 1  # no BENCH_torch_e2e.json here
    (tmp_path / "BENCH_torch_e2e.json").write_text(json.dumps(_payload(0.008, 0.0078)))
    assert check_crossover.main([]) == 0
    assert "crossover gate [BENCH_torch_e2e.json]: crossover holds" in capsys.readouterr().out


@pytest.mark.parametrize("module", ["quickstart", "mixed_timestep_search", "serve_lm"])
def test_cli_prints_ok_on_the_cpu(module, det_cfgs, monkeypatch, capsys):
    """The CLIs with the port's seeded weights on the CPU (the detector at
    the smoke config, the LMs at theirs): each ends with the JAX example's
    OK line."""
    _, cfg = det_cfgs
    monkeypatch.setattr(quickstart, "quickstart_config", lambda: cfg)
    monkeypatch.setattr(search, "search_config",
                        lambda full_config: dataclasses.replace(cfg, mixed_time=False))
    mod = {"quickstart": quickstart, "mixed_timestep_search": search,
           "serve_lm": serve_lm}[module]
    mod.main(["--device", "cpu"])
    assert capsys.readouterr().out.splitlines()[-1] == f"{module} OK"


def test_entry_points_need_a_card_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    for call in (lambda: quickstart.main([]), lambda: search.main([]),
                 lambda: serve_lm.main([]),
                 lambda: make_ann_fixture.main(["--out", str(tmp_path / "a.npz")])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_new_modules_import_no_jax():
    code = ("import sys\n"
            f"for m in {NEW_MODULES!r}: __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
