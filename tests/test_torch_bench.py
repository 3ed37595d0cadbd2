"""The port's kernel-benchmark path on the CPU against the JAX package:
``layer_specs`` and the energy model equal to JAX's (integers exactly,
floats within 1e-12 relative); ``kernel_bench.run`` on ``make_inputs(0)``
exact for the gated conv and the LIF, within tolerance for the matmul,
its accounting equal to what the JAX ops give on the same arrays;
``run_fused`` bit-exact with one encode launch; ``e2e_detector.run`` with
every executor bit-equal to dense and its accumulates and weight bytes
equal to JAX's on the same carried-across weights."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks import e2e_detector as je2e  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.convert import emit as jemit  # noqa: E402
from repro.core import energy as jen  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.core import pruning as jpruning  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import snn_yolo as jsy  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.benchmarks import e2e_detector, kernel_bench  # noqa: E402
from repro_torch.core import energy as en  # noqa: E402
from repro_torch.kernels import fused_pipeline as fp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import snn_yolo as sy  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-12


def _configs():
    paper = get_config("snn-det")
    return {
        "CONFIG": paper,
        "smoke": jsmoke(paper),
        "converted-pool_drive": jemit.target_config(
            paper, jemit.ConvertConfig(full_t=16, pool_drive=True)),
    }


DENSITIES = {"fig3": None, "1.0": 1.0, "0.2": 0.2,
             "dict": {"encode": 0.9, "conv_block": 0.6, "stage0": 0.5, "stage1": 0.4,
                      "stage2": 0.3, "stage3": 0.2, "stage4": 0.1}}


def _close(got, want, what):
    if isinstance(want, (int, np.integer)) and not isinstance(want, bool):
        assert isinstance(got, int) and got == want, (what, got, want)
    else:
        assert abs(got - want) <= REL * max(abs(want), 1e-300), (what, got, want)


@pytest.mark.parametrize("density", list(DENSITIES))
@pytest.mark.parametrize("cfg_name", list(_configs()))
def test_layer_specs_and_energy_equal_jax(cfg_name, density):
    jcfg = _configs()[cfg_name]
    cfg = sy.config_from_dict(jsy.config_to_dict(jcfg))
    pd = DENSITIES[density]
    want = jsy.layer_specs(jcfg, pruned_density=pd)
    got = sy.layer_specs(cfg, pruned_density=pd)
    assert [s.name for s in got] == [s.name for s in want]
    for g, w in zip(got, want):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)
        for attr in ("params", "nnz", "macs_dense_1t"):
            _close(getattr(g, attr), getattr(w, attr), (g.name, attr))
        for sparse in (True, False):
            _close(g.macs(sparse=sparse), w.macs(sparse=sparse), (g.name, "macs", sparse))
            _close(g.ops(sparse=sparse), w.ops(sparse=sparse), (g.name, "ops", sparse))
        for sram in (en.SRAM_36KB_BITS_PER_PIXEL, en.SRAM_81KB_BITS_PER_PIXEL):
            _close(en.input_dram_bytes(g, sram), jen.input_dram_bytes(w, sram), g.name)
        _close(en.output_dram_bytes(g), jen.output_dram_bytes(w), g.name)
        for fmt in ("dense", "bitmask", "csr"):
            _close(en.param_dram_bytes(g, fmt), jen.param_dram_bytes(w, fmt), (g.name, fmt))
    for sram in (en.SRAM_36KB_BITS_PER_PIXEL, en.SRAM_81KB_BITS_PER_PIXEL):
        for fmt in ("dense", "bitmask", "csr"):
            gt = en.network_traffic(got, sram_bits_per_pixel=sram, param_fmt=fmt)
            wt = jen.network_traffic(want, sram_bits_per_pixel=sram, param_fmt=fmt)
            for f in ("input_mb", "output_mb", "param_mb", "total_mb"):
                _close(getattr(gt, f), getattr(wt, f), (f, sram, fmt))
            _close(gt.dram_energy_mj(), wt.dram_energy_mj(), ("energy", sram, fmt))
    for sparse in (True, False):
        _close(en.network_latency_s(got, sparse=sparse),
               jen.network_latency_s(want, sparse=sparse), "latency")
        _close(en.fps(got, sparse=sparse), jen.fps(want, sparse=sparse), "fps")
    _close(en.peak_gops(), jen.peak_gops(), "peak")
    _close(en.peak_gops(sparse_speedup=1 / (1 - 0.473)),
           jen.peak_gops(sparse_speedup=1 / (1 - 0.473)), "peak sparse")
    _close(en.core_energy_mj_per_frame(got), jen.core_energy_mj_per_frame(want), "core mJ")


def test_layer_specs_halves_only_the_pooled_stages():
    cfg = sy.config_from_dict(jsy.config_to_dict(get_config("snn-det")))
    hw = {s.name: (s.h, s.w) for s in sy.layer_specs(cfg)}
    assert hw["encode"] == (576, 1024) and hw["conv_block"] == (288, 512)
    assert [hw[f"stage{i}/agg"] for i in range(5)] == [
        (144, 256), (72, 128), (36, 64), (18, 32), (18, 32)]
    assert hw["head"] == cfg.grid_hw == (18, 32)


def test_kernel_bench_run_on_cpu_matches_jax_accounting():
    out = kernel_bench.run(device="cpu")
    inp = kernel_bench.make_inputs(0)
    g, lif, mm = out["gated_one_to_all"], out["fused_lif"], out["bitmask_matmul"]
    assert g["max_err"] == 0 and lif["max_err"] == 0.0
    assert mm["within_tolerance"] and mm["max_err"] < 1e-4
    wd = inp["w_conv"]
    assert g["nnz_taps"] == int((wd != 0).sum())
    assert g["weight_bytes_compressed"] == jops.pack_conv_weights(wd).compressed_bytes
    jspikes = np.asarray(jops.fused_lif(jnp.asarray(inp["psum"]), threshold=0.5, leak=0.25))
    assert lif["spike_rate"] == float(np.float32(jspikes.astype(np.float32).mean()))
    assert mm["compressed_bytes"] == jops.pack_matmul_weights(inp["w_mm"]).compressed_bytes
    assert mm["density"] == float((inp["w_mm"] != 0).mean())
    # the gated conv's integers equal the JAX kernel's on the same arrays
    want = np.asarray(jops.gated_conv(jnp.asarray(inp["spikes"]),
                                      jops.pack_conv_weights(wd)))
    got = ops.gated_conv(torch.from_numpy(inp["spikes"].astype(np.uint8)),
                         ops.pack_conv_weights(wd), bh=18, bw=32)
    np.testing.assert_array_equal(got.numpy(), want)
    assert out["fused_pipeline"] == {"max_err": 0.0, "encode_dispatches": 1}


def test_run_fused_on_cpu_is_exact_with_one_encode_call(monkeypatch):
    real, calls = fp.fused_pipeline, []

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(fp, "fused_pipeline", counted)
    out = kernel_bench.run_fused(device="cpu")
    assert out == {"fused_pipeline": {"max_err": 0.0, "encode_dispatches": 1}}
    # one detect of the kernel executor (27 fused layers), then the encode
    # layer alone: ONE call for its 8 bit planes
    assert len(calls) == 27 + 1
    assert calls[-1] == calls[0] and calls[0][0] == 1  # encode: t_in = 1
    assert kernel_bench.main(["--fast", "--device", "cpu"]) == out


@pytest.fixture(scope="module")
def jax_weights():
    """The JAX benchmark's own weights (jax.random key 0, pruned 0.8), as
    numpy, and its config."""
    jcfg = je2e.reduced_config()
    params, _ = jsy.init_params(jax.random.PRNGKey(0), jcfg)
    params = jpruning.prune_tree(params, 0.8)
    return jcfg, jax.tree_util.tree_map(np.asarray, params)


def test_e2e_detector_on_cpu_matches_jax_accounting(jax_weights, tmp_path):
    jcfg, params_np = jax_weights
    bn_np = {n: {"mean": np.zeros(p["w"].shape[-1], np.float32),
                 "var": np.ones(p["w"].shape[-1], np.float32),
                 "count": np.zeros((), np.int32)}
             for n, p in params_np.items() if "gamma" in p}
    params, _, _ = interop.params_from_numpy(params_np, bn_np, device="cpu")
    cfg = e2e_detector.reduced_config()
    assert jsy.config_to_dict(jcfg) == sy.config_to_dict(cfg)
    out_json = tmp_path / "BENCH_torch_e2e.json"
    res = e2e_detector.run(cfg, device="cpu", params=params, reps=2, out_json=str(out_json))

    jparams = jax.tree_util.tree_map(jnp.asarray, params_np)
    jp = jplan.build_plan(jparams, dataclasses.replace(jcfg, conv_exec="pallas"))
    for ex in e2e_detector.EXECUTORS:
        row = res["executors"][ex]
        assert row["max_abs_diff_vs_dense"] == 0.0
        assert row["accumulates"] == je2e._accumulates(jcfg, jp, sparse=ex != "dense")
        assert row["wall_s"] > 0 and len(row["detections"]) == 1
    assert res["weight_bytes"]["dense"] == jp.dense_bytes
    assert res["weight_bytes"]["compressed"] == jp.compressed_bytes

    written = json.loads(out_json.read_text())
    assert written == json.loads(json.dumps(res))
    with open(os.path.join(ROOT, "BENCH_e2e.json")) as f:
        bench = json.load(f)

    def keys(d, prefix=""):
        out = set()
        for k, v in d.items():
            out.add(prefix + k)
            if isinstance(v, dict) and k != "launches_per_frame":
                out |= keys(v, prefix + k + "/")
        return out

    assert keys(bench) <= keys(written)


def test_e2e_detector_main_writes_only_where_asked(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "e2e.json"
    e2e_detector.main(["--device", "cpu", "--reps", "1", "--out", str(out)])
    assert sorted(os.listdir(tmp_path)) == ["e2e.json"]
    res = json.loads(out.read_text())
    assert res["device"] == "cpu" and res["config"]["input_hw"] == [24, 32]
    assert all(r["launches_per_frame"] == {} for r in res["executors"].values())


@pytest.mark.parametrize("module", ["kernel_bench", "e2e_detector", "kernel_phases",
                                    "serve_bench", "launch.serve", "eval_map",
                                    "table1_ablation", "fig5_miout", "run"])
def test_benchmarks_default_to_the_card(module, tmp_path):
    """Without --device a benchmark (or the serve CLI) runs on the card, and
    with no card it raises instead of falling back to the CPU."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "CUDA_VISIBLE_DEVICES": ""}
    argv = ["-m", f"repro_torch.benchmarks.{module}"]
    if module == "launch.serve":
        argv = ["-m", "repro_torch.launch.serve", "--arch", "snn-det"]
    r = subprocess.run([sys.executable, *argv], env=env,
                       cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "no CUDA device" in r.stderr, r.stdout + r.stderr
    assert os.listdir(tmp_path) == []


def test_kernel_phases_instruments_both_kernels():
    """The phase counter's copies of the fused and matmul kernels find every
    anchor in the sources (a source edit that moves one fails here, on the
    CPU, before a chip run) and keep the kernels' entry points. The fused
    kernel's loop phases are counted in the shared conv loop's copy."""
    from repro_torch.benchmarks import kernel_phases as kp

    conv = kp.conv_source()
    for name, src, loop in (("fused_pipeline", kp.fused_source(), conv),
                            ("bitmask_matmul", kp.matmul_source(), "")):
        assert (src + loop).count("clock64()") >= 8, name
        assert 'extern "C" int phases_read' in src
        assert ("g_phases[b][i] = v[i]" in src) != ("g_phases[b][1] = c_setup" in src)
        assert f'extern "C" int {name}_launch' in src


def test_kernel_phases_instruments_the_gated_kernel():
    """The gated kernel's copy counts its set-up (live taps, ranks, decode,
    once per K-dim segment) and total; the shared loop's copy adds its four
    loop phases into the same block row, once per call."""
    from repro_torch.benchmarks import kernel_phases as kp

    src, conv = kp.gated_source(), kp.conv_source()
    assert src.count("clock64()") == 5 and "c_setup += clock64() - c_s" in src
    assert 'extern "C" int gated_one_to_all_launch' in src
    assert 'extern "C" int phases_read' in src and "igemm::g_phases" in src
    assert conv.count("clock64()") == 8 and conv.count("+= c_") == 4
    assert "__device__ long long g_phases" in conv and "phases_read" not in conv
    assert set(kp.GATED_PHASES) == set(kp.FUSED_PHASES)
    assert {(c[1], c[3]) for c in kp.GATED_CASES.values()} >= {(16, (32, 288, 512)),
                                                               (256, (32, 18, 32))}
