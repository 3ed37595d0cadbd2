"""The port's megabatched serving (``serve/engine.py``,
``serve/detector.py``'s ``masked_step`` and ``DetectorEngineCore``), its
``serve_bench`` and its serve CLI on the CPU, at the conformance config.

Inputs are built by the JAX package (``golden.build_inputs``) under
``jax.threefry_partitionable(False)`` and cross as numpy arrays, the JAX
affine bundles included (torch's rsqrt rounds differently from XLA's,
ROADMAP queue 3, R3). The port's ``Engine`` (kernel executor, plain
versions on the CPU) is held to the JAX ``Engine`` (its ``gated``
executor, which the conformance suite holds bit-equal to ``pallas``):
heads within 1e-5, ``valid`` and ``classes`` equal (R4). Every megabatch
contract — the counterparts of ``tests/test_detector_serve.py``'s
``TestFrameServing`` and ``TestMegabatchServing`` — is bit-exact against
solo port sessions."""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "conformance"))
import golden  # noqa: E402

from repro.core import plan as jplan  # noqa: E402
from repro.eval import harness as jharness  # noqa: E402
from repro.launch import serve as jlaunch  # noqa: E402
from repro.models import snn_yolo as jsy  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import FrameRequest as JFrameRequest  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.benchmarks import serve_bench  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import snn_yolo as sy  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AdmissionPolicy,
    DetectorEngineCore,
    Engine,
    EngineAPI,
    FrameRequest,
)
from repro_torch.serve.detector import step_latency_ms  # noqa: E402

FLOAT_ATOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGGERED = [1, 4, 2, 5, 3, 1, 2, 6, 1, 3]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_inputs():
    with jax.threefry_partitionable(False):
        return golden.build_inputs()


@pytest.fixture(scope="module")
def det(jax_inputs):
    """The port's compiled detector (kernel executor, on the CPU) with the
    JAX affine bundles carried across."""
    params, bn, _ = jax_inputs
    jcfg = dataclasses.replace(golden.conformance_config(), conv_exec="pallas")
    affines = jplan.precompute_affines(jplan.build_plan(params, jcfg), params, bn, jcfg)
    p, b, a = interop.params_from_numpy(_np(params), _np(bn), _np(affines), device="cpu")
    cfg = dataclasses.replace(sy.config_from_dict(jsy.config_to_dict(jcfg)), conv_exec="pallas")
    return sy.compile_detector(cfg, p, b, device="cpu", affines=a)


def _streams(det, lengths, seed=11):
    rng = np.random.default_rng(seed)
    h, w = det.cfg.input_hw
    return [(rng.integers(0, 256, (f, h, w, 3)) / 255.0).astype(np.float32) for f in lengths]


def _solo_replay(det, frames):
    solo = det.new_session(batch=1)
    return [solo.step(f[None]) for f in frames]


def _assert_equals_solo(det, reqs):
    for fr in reqs:
        assert len(fr.heads) == len(fr.frames)
        for k, step in enumerate(_solo_replay(det, fr.frames)):
            np.testing.assert_array_equal(fr.heads[k], step.head[0].numpy())
            for f in ("boxes", "scores", "classes", "valid"):
                np.testing.assert_array_equal(getattr(fr.out[k], f),
                                              getattr(step.detections, f)[0].numpy())


@pytest.fixture(scope="module")
def staggered(det):
    """The port's Engine over staggered stream lengths, 4 slots: every tick
    sees joins or leaves, rows remap, the bucket grows and shrinks."""
    reqs = [FrameRequest(rid=r, frames=s) for r, s in enumerate(_streams(det, STAGGERED))]
    eng = Engine(det, n_slots=4)
    for fr in reqs:
        assert eng.submit(fr)
    out = eng.run()
    assert out.status == "drained" and len(out) == len(STAGGERED)
    return reqs


def test_engine_matches_the_jax_engine(jax_inputs, det, staggered):
    params, bn, _ = jax_inputs
    jdet = jsy.compile_detector(
        dataclasses.replace(golden.conformance_config(), conv_exec="gated"), params, bn)
    jeng = JEngine(jdet, n_slots=4)
    jreqs = [JFrameRequest(rid=fr.rid, frames=fr.frames) for fr in staggered]
    for fr in jreqs:
        assert jeng.submit(fr)
    assert jeng.run().status == "drained"
    for got, want in zip(staggered, jreqs):
        for k in range(len(got.frames)):
            np.testing.assert_allclose(got.heads[k], np.asarray(want.heads[k]), atol=FLOAT_ATOL,
                                       rtol=0, err_msg=f"stream {got.rid} frame {k}")
            for f in ("valid", "classes"):
                np.testing.assert_array_equal(getattr(got.out[k], f),
                                              np.asarray(getattr(want.out[k], f)))


def test_join_leave_remap_parity_vs_solo_sessions(det, staggered):
    _assert_equals_solo(det, staggered)


def test_capacity_buckets_grow_and_shrink_without_losing_state(det):
    core = DetectorEngineCore(det, n_slots=16, min_bucket=2)
    assert core.cap == 2
    reqs = [FrameRequest(rid=r, frames=s) for r, s in enumerate(_streams(det, [6] * 5))]
    core.admit(reqs[0], 0)
    core.admit(reqs[1], 1)
    active = {0: reqs[0], 1: reqs[1]}
    core.step(active)
    assert core.cap == 2
    caps = []
    for slot in (2, 3, 4):  # growth 2 -> 4 -> 8
        core.admit(reqs[slot], slot)
        active[slot] = reqs[slot]
        caps.append(core.cap)
    assert caps == [4, 4, 8]
    while active:
        for slot in core.step(active):
            del active[slot]
    assert core.cap == 2  # drained back to the min bucket
    _assert_equals_solo(det, reqs)


def test_inactive_lanes_masked_out_of_the_step(det):
    """Active rows come out bit-identical whatever the dead lanes hold, and
    a dead lane's membrane stays exactly as it was."""
    (stream,) = _streams(det, [1])
    batch = np.zeros((4,) + stream.shape[1:], np.float32)
    batch[:2] = stream[0]
    active = np.array([True, True, False, False])
    mem = det.zero_state(4)
    h1, m1, _ = det.masked_step(batch, mem, active)
    garbage = batch.copy()
    garbage[2:] = 0.7
    rng = np.random.default_rng(3)
    dirty = {k: v.clone() for k, v in mem.items()}
    for v in dirty.values():
        v[2:] = torch.from_numpy(rng.normal(size=v[2:].shape).astype(np.float32))
    h2, m2, _ = det.masked_step(garbage, dirty, active)
    assert torch.equal(h1[:2], h2[:2])
    for k in m1:
        assert torch.equal(m1[k][:2], m2[k][:2]), k
        assert torch.equal(m1[k][2:], mem[k][2:]) and torch.equal(m2[k][2:], dirty[k][2:]), k


def test_cold_mask_resets_a_dirty_lane_in_step(det):
    """A cold row serves like an explicitly zeroed one; a row that is cold
    and inactive comes out zeroed (the JAX step keeps the blanked state)."""
    (stream,) = _streams(det, [1])
    batch = np.concatenate([stream, stream, stream])
    on = np.ones(3, bool)
    _, dirty, _ = det.masked_step(batch, det.zero_state(3), on)
    cold = np.array([False, True, True])
    active = np.array([True, True, False])
    h_cold, m_cold, _ = det.masked_step(batch, dirty, active, cold)
    zeroed = {k: v.clone() for k, v in dirty.items()}
    for v in zeroed.values():
        v[1:] = 0.0
    h_ref, m_ref, _ = det.masked_step(batch, zeroed, active, np.zeros(3, bool))
    h_none, m_none, _ = det.masked_step(batch, zeroed, active)  # no cold row: no blanking pass
    assert torch.equal(h_cold, h_ref) and torch.equal(h_none, h_ref)
    assert all(torch.equal(m_none[k], m_ref[k]) for k in m_ref)
    for k in m_cold:
        assert torch.equal(m_cold[k], m_ref[k]), k
        assert not m_cold[k][2].any(), k


def test_double_buffered_upload_changes_nothing(det, monkeypatch):
    """A steady 6-frame stream: every tick after the first takes the frames
    staged during the tick before, and serves as the solo replay does."""
    (stream,) = _streams(det, [6])
    eng = Engine(det, n_slots=2)
    offsets = []
    real = eng.core._upload

    def upload(active, offset=0):
        offsets.append(offset)
        return real(active, offset)

    monkeypatch.setattr(eng.core, "_upload", upload)
    fr = FrameRequest(rid=0, frames=stream)
    eng.submit(fr)
    eng.run()
    assert offsets == [0] + [1] * 5  # one direct upload, then staged ones only
    _assert_equals_solo(det, [fr])


def test_run_truncation_reports_pending(det):
    reqs = [FrameRequest(rid=r, frames=s) for r, s in enumerate(_streams(det, [4, 4, 4]))]
    eng = Engine(det, n_slots=2)
    for fr in reqs:
        eng.submit(fr)
    out = eng.run(max_steps=2)
    assert out.status == "truncated" and not out.drained and len(out) == 0
    assert {r.rid for r in out.pending} == {0, 1, 2}
    assert all(not r.done for r in out.pending)
    out2 = eng.run()
    assert out2.status == "drained" and {r.rid for r in out2} == {0, 1, 2}
    _assert_equals_solo(det, reqs)


def test_bounded_queue_rejects(det):
    streams = _streams(det, [2] * 5)
    eng = Engine(det, n_slots=2, admission=AdmissionPolicy(max_queue=2))
    results = [eng.submit(FrameRequest(rid=r, frames=s)) for r, s in enumerate(streams)]
    assert [bool(r) for r in results] == [True, True, False, False, False]
    assert all(r.reason == "queue-full" for r in results[2:])
    assert [r.rid for r in eng.rejected] == [2, 3, 4]
    out = eng.run()
    assert out.status == "drained" and {r.rid for r in out} == {0, 1}


def test_shed_oldest_keeps_fresh_traffic(det):
    reqs = [FrameRequest(rid=r, frames=s) for r, s in enumerate(_streams(det, [2] * 3))]
    eng = Engine(det, n_slots=2, admission=AdmissionPolicy(max_queue=2, on_full="shed-oldest"))
    r0, r1 = eng.submit(reqs[0]), eng.submit(reqs[1])
    assert r0 and r1 and r0.shed == ()
    r2 = eng.submit(reqs[2])
    assert r2 and r2.reason == "shed-oldest" and tuple(r.rid for r in r2.shed) == (0,)
    assert [r.rid for r in eng.queue] == [1, 2]
    assert {r.rid for r in eng.run()} == {1, 2} and not reqs[0].done
    _assert_equals_solo(det, reqs[1:])


@pytest.mark.parametrize("kwargs,match", [({"on_full": "drop-newest"}, "on_full"),
                                          ({"max_queue": 0}, "max_queue")])
def test_admission_policy_validates(kwargs, match):
    with pytest.raises(ValueError, match=match):
        AdmissionPolicy(**kwargs)


def test_bad_frames_rejected_at_submit(det):
    eng = Engine(det, n_slots=2)
    res = eng.submit(FrameRequest(rid=0, frames=np.zeros((8, 8, 3))))  # no F axis
    assert not res and "FrameRequest" in res.reason
    assert eng.queue == [] and eng.rejected[0].rid == 0
    out = eng.run()
    assert out.status == "drained" and len(out) == 0


@pytest.mark.parametrize("dh,channels", [(2, 3), (0, 1)])
def test_mismatched_hw_rejected_before_touching_state(det, dh, channels):
    """admit validates first: a wrong H or channel count leaves the rows,
    the cold set and every membrane as they were."""
    core = DetectorEngineCore(det, n_slots=2)
    h, w = det.cfg.input_hw
    core.admit(FrameRequest(rid=0, frames=np.zeros((2, h, w, 3), np.float32)), 0)
    mem_before = {k: v.clone() for k, v in core._mem.items()}
    rows_before = (dict(core._row_of), list(core._rows), set(core._cold))
    bad = FrameRequest(rid=1, frames=np.zeros((2, h + dh, w, channels), np.float32))
    with pytest.raises(ValueError, match="input_hw"):
        core.admit(bad, 1)
    assert (dict(core._row_of), list(core._rows), set(core._cold)) == rows_before
    assert all(torch.equal(mem_before[k], core._mem[k]) for k in mem_before)


def test_core_satisfies_engine_api(det):
    assert isinstance(DetectorEngineCore(det, n_slots=2), EngineAPI)


@pytest.mark.parametrize("with_bn", [True, False], ids=["params-and-bn", "params-only"])
def test_engine_compiles_a_config(det, with_bn):
    """``Engine(cfg, params)`` and ``Engine(cfg, (params, bn))`` compile the
    detector on the device asked for and serve like sessions of the same
    compile."""
    params = (det.params, det.bn_state) if with_bn else det.params
    eng = Engine(det.cfg, params, n_slots=2, device="cpu")
    want = sy.compile_detector(det.cfg, det.params, det.bn_state if with_bn else None,
                               device="cpu")
    assert eng.core.det.device.type == "cpu"
    reqs = [FrameRequest(rid=r, frames=s) for r, s in enumerate(_streams(det, [2, 1]))]
    for fr in reqs:
        eng.submit(fr)
    assert eng.run().status == "drained"
    _assert_equals_solo(want, reqs)


def test_engine_rejects_unknown_config():
    with pytest.raises(TypeError, match="serve"):
        Engine(object(), None, device="cpu")


def test_step_latency_percentiles_over_synthetic_load(det):
    eng = Engine(det, n_slots=4)
    for r, s in enumerate(_streams(det, [3] * 6)):
        eng.submit(FrameRequest(rid=r, frames=s))
    eng.run()
    lat = step_latency_ms(eng.core.step_wall)
    assert set(lat) == {"step_p50_ms", "step_p95_ms", "step_p99_ms"}
    assert 0 < lat["step_p50_ms"] <= lat["step_p95_ms"] <= lat["step_p99_ms"]
    assert len(eng.core.step_wall) >= 3 and eng.core.step_device_ms == []


def test_serve_bench_on_cpu_has_jax_keys_and_holds_parity(tmp_path):
    """``--fast`` sizes at the smoke config: the JSON has every key of the
    JAX ``BENCH_serve.json`` plus the port's, and its parity checks (which
    raise) held."""
    out = tmp_path / "serve.json"
    res = serve_bench.main(["--device", "cpu", "--fast", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    with open(os.path.join(ROOT, "BENCH_serve.json")) as f:
        jax_res = json.load(f)
    assert set(jax_res) <= set(res) and set(jax_res["config"]) <= set(res["config"])
    jrow = next(iter(jax_res["executors"].values()))
    for ex, row in res["executors"].items():
        assert set(jrow) <= set(row) and row["max_abs_diff_vs_dense"] == 0.0, ex
    jload = next(iter(jax_res["load"].values()))
    assert list(res["load"]) == ["64"]
    row = res["load"]["64"]
    assert set(jload) <= set(row)
    assert {"tick_host_ms", "upload_host_ms", "tick_device_ms", "masked_step_device_ms", "masked_step_by_kernel",
            "peak_memory_bytes", "device"} <= set(row)
    assert row["device"] == "cpu" and row["tick_device_ms"] is None
    assert row["n_streams"] == 64 and row["frames_per_stream"] == 2
    assert len(row["tick_host_ms"]) == 2 and row["max_abs_diff_vs_session"] == 0.0


def test_serve_cli_on_cpu_with_demo_weights(capsys):
    done = launch.main(["--arch", "snn-det", "--device", "cpu", "--requests", "5",
                        "--slots", "2", "--frames", "2", "--max-queue", "2"])
    text = capsys.readouterr().out
    assert "rejected 3 requests" in text and "snn-det[pallas]: served 2 streams" in text
    assert sorted(r.rid for r in done) == [0, 1] and all(len(r.heads) == 2 for r in done)


def test_serve_cli_restores_a_jax_checkpoint_and_serves_alike(jax_inputs, tmp_path,
                                                              monkeypatch):
    """A checkpoint written by the JAX package, served by both launchers on
    the same frames: heads within 1e-5, valid and classes equal."""
    params, bn, _ = jax_inputs
    jharness.save_detector_checkpoint(str(tmp_path), 7, params, bn, golden.conformance_config())
    engines = []

    class Recording(JEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    monkeypatch.setattr(jlaunch, "Engine", Recording)
    args = ["--arch", "snn-det", "--checkpoint", str(tmp_path), "--requests", "3",
            "--slots", "2", "--frames", "2"]
    jlaunch.main(args + ["--conv-exec", "gated"])
    want = {r.rid: r for r in engines[0].finished}
    got = launch.main(args + ["--conv-exec", "pallas", "--device", "cpu"])
    assert sorted(r.rid for r in got) == sorted(want) == [0, 1, 2]
    for r in got:
        for k in range(2):
            np.testing.assert_allclose(r.heads[k], np.asarray(want[r.rid].heads[k]),
                                       atol=FLOAT_ATOL, rtol=0)
            for f in ("valid", "classes"):
                np.testing.assert_array_equal(getattr(r.out[k], f),
                                              np.asarray(getattr(want[r.rid].out[k], f)))
