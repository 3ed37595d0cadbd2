"""The port's checkpoint write side, ``ft`` and the detector checkpoint,
against the JAX package's layout: the cases of ``tests/test_checkpoint.py``
(atomic commit, crash mid-save, gc, async save and its failures, reserved
names, extra files, template mismatches, Supervisor restarts and give-up,
the straggler monitor) on the port, then checkpoints crossing between the
packages — the port writes, JAX's ``restore`` and
``harness.restore_detector_checkpoint`` read back bit-equal leaves, and
the other way round; a trained, pruned and quantized detector the port
saved serves the same detections through JAX's ``compile_detector``."""
import dataclasses
import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.eval import harness as jh  # noqa: E402
from repro.models import snn_yolo as jsy  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.core import pruning, quant  # noqa: E402
from repro_torch.eval import harness  # noqa: E402
from repro_torch.models import snn_yolo as sy  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import ft  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "a": torch.randn((8, 16), generator=g),
        "nested": {"b": torch.arange(10, dtype=torch.int32), "c": torch.tensor(3.5)},
    }


def _template(tree):
    return tu.tree_map(lambda x: torch.empty_like(x), tree)


def _assert_tree_equal(a, b):
    la, lb = tu.leaves(a), tu.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


# ------------------------------------- mirrors of tests/test_checkpoint.py --


def test_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 7, t)
    restored, step = ckpt.restore(str(tmp_path), _template(t))
    assert step == 7
    _assert_tree_equal(t, restored)


def test_restore_shape_dtype_template_gives_numpy(tmp_path):
    ckpt.save(str(tmp_path), 1, {"w": torch.ones(2, 3), "n": torch.zeros((), dtype=torch.int32)})
    got, _ = ckpt.restore(str(tmp_path), {"w": ckpt.ShapeDtype((2, 3), np.float32),
                                          "n": ckpt.ShapeDtype((), np.int32)})
    assert isinstance(got["w"], np.ndarray) and got["n"].dtype == np.int32


def test_latest_and_gc(tmp_path):
    for s in (1, 5, 3, 9):
        ckpt.save(str(tmp_path), s, _tree(s))
    assert ckpt.latest_step(str(tmp_path)) == 9
    ckpt.gc_old(str(tmp_path), keep=2)
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path))
    assert steps == [5, 9]


def test_crash_mid_save_never_corrupts(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 1, t)
    os.makedirs(tmp_path / "step_000000002.tmp")  # a dead writer's staging dir
    with open(tmp_path / "step_000000002.tmp" / "leaf_00000.npy", "w") as f:
        f.write("garbage")
    assert ckpt.latest_step(str(tmp_path)) == 1  # .tmp is invisible
    restored, step = ckpt.restore(str(tmp_path), _template(t))
    assert step == 1
    _assert_tree_equal(t, restored)


def test_async_save_snapshots_before_returning(tmp_path):
    """The leaves are copied to the host before save_async returns: an
    in-place update right after it does not reach the checkpoint."""
    t = _tree()
    want = tu.tree_map(lambda x: x.clone(), t)
    th = ckpt.save_async(str(tmp_path), 3, t)
    t["a"].add_(1.0)
    th.join()
    ckpt.wait_pending()
    restored, step = ckpt.restore(str(tmp_path), _template(t))
    assert step == 3
    _assert_tree_equal(want, restored)


def test_restore_validates_shape(tmp_path):
    ckpt.save(str(tmp_path), 0, {"w": torch.zeros((4, 4))})
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(str(tmp_path), {"w": torch.zeros((8, 4))})


def test_gc_ignores_uncommitted_junk(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree(1))
    ckpt.save(str(tmp_path), 3, _tree(3))
    os.makedirs(tmp_path / "step_000000002")  # junk: no manifest.json
    os.makedirs(tmp_path / "step_junk")  # junk: unparsable step
    ckpt.gc_old(str(tmp_path), keep=2)
    kept = sorted(os.listdir(tmp_path))
    assert "step_000000001" in kept and "step_000000003" in kept
    assert "step_000000002" in kept and "step_junk" in kept


def test_gc_joins_pending_writer_for_doomed_step(tmp_path, monkeypatch):
    committed, release = threading.Event(), threading.Event()
    real_write = ckpt._write

    def gated_write(root, step, paths, host, extra_files=None):
        out = real_write(root, step, paths, host, extra_files)
        if step == 1:
            committed.set()
            assert release.wait(timeout=10)
        return out

    monkeypatch.setattr(ckpt, "_write", gated_write)
    ckpt.save_async(str(tmp_path), 1, _tree(1))
    assert committed.wait(timeout=10)
    for s in (5, 6):
        ckpt.save(str(tmp_path), s, _tree(s))
    gc_done = threading.Event()

    def run_gc():
        ckpt.gc_old(str(tmp_path), keep=2)
        gc_done.set()

    t = threading.Thread(target=run_gc, daemon=True)
    t.start()
    assert not gc_done.wait(timeout=0.3)  # gc is blocked on the writer
    release.set()
    assert gc_done.wait(timeout=10)
    ckpt.wait_pending()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path))
    assert steps == [5, 6]


def test_failed_async_write_raises_in_wait_pending(tmp_path, monkeypatch):
    def bad_write(root, step, paths, host, extra_files=None):
        raise OSError("no space left on device")

    monkeypatch.setattr(ckpt, "_write", bad_write)
    ckpt.save_async(str(tmp_path), 1, _tree())
    with pytest.raises(OSError, match="no space left"):
        ckpt.wait_pending()
    ckpt.wait_pending()  # recorded failures do not repeat


def test_restore_mismatch_lists_leaf_paths(tmp_path):
    ckpt.save(str(tmp_path), 0, {"a": torch.zeros(2), "extra": torch.ones(())})
    with pytest.raises(ValueError) as e:
        ckpt.restore(str(tmp_path), {"a": torch.zeros(2), "missing_leaf": torch.zeros(())})
    assert "missing_leaf" in str(e.value) and "extra" in str(e.value)


def test_restore_tolerates_extra_manifest_leaves(tmp_path):
    ckpt.save(str(tmp_path), 0, {"a": torch.full((2,), 7.0), "opt": torch.ones(())})
    restored, step = ckpt.restore(str(tmp_path), {"a": torch.zeros(2)})
    assert step == 0
    np.testing.assert_array_equal(restored["a"].numpy(), [7.0, 7.0])


def test_save_extra_files_commit_atomically(tmp_path):
    ckpt.save(str(tmp_path), 2, _tree(), extra_files={"meta.json": b"{}"})
    assert (tmp_path / "step_000000002" / "meta.json").read_bytes() == b"{}"
    assert ckpt.read_extra_file(str(tmp_path), "meta.json") == b"{}"
    with pytest.raises(FileNotFoundError):
        ckpt.read_extra_file(str(tmp_path), "absent.json")


@pytest.mark.parametrize("name", ["manifest.json", "shard_manifest.json", "staging.json",
                                  "leaf_99999.npy", "host_0.done"])
def test_reserved_extra_file_names_refused(tmp_path, name):
    with pytest.raises(ValueError, match="collides"):
        ckpt.save(str(tmp_path), 3, _tree(), extra_files={name: b"x"})
    assert ckpt.latest_step(str(tmp_path)) is None


def test_supervisor_restarts_after_failures(tmp_path):
    failures = {4, 12}
    seen = []

    def init_state():
        return {"x": torch.zeros(()), "step_sum": torch.zeros(())}

    def step_fn(state, step):
        if step in failures:
            failures.discard(step)  # fail once per step
            raise RuntimeError(f"simulated node loss at {step}")
        seen.append(step)
        return {"x": state["x"] + 1, "step_sum": state["step_sum"] + step}

    sup = ft.Supervisor(ckpt_root=str(tmp_path), max_restarts=5, save_every=2,
                        heartbeat=ft.Heartbeat(str(tmp_path / "hb.json")))
    final = sup.run(init_state=init_state, state_template=init_state, step_fn=step_fn,
                    n_steps=20)
    assert sup.restarts == 2
    assert set(seen) == set(range(20))
    assert float(final["x"]) == 20  # checkpoint/restore kept the count exact
    assert float(final["step_sum"]) == sum(range(20))
    assert sup.heartbeat.last()["step"] == 19
    assert not sup.heartbeat.stalled(timeout_s=60)


def test_supervisor_resumes_a_finished_run(tmp_path):
    sup = ft.Supervisor(ckpt_root=str(tmp_path), save_every=3)
    init = lambda: {"x": torch.zeros(())}  # noqa: E731
    sup.run(init_state=init, state_template=init,
            step_fn=lambda s, k: {"x": s["x"] + 1}, n_steps=4)
    calls = []
    again = ft.Supervisor(ckpt_root=str(tmp_path)).run(
        init_state=init, state_template=init,
        step_fn=lambda s, k: calls.append(k) or s, n_steps=4)
    assert calls == [] and float(again["x"]) == 4


def test_supervisor_gives_up(tmp_path):
    def bad_step(state, step):
        raise RuntimeError("always fails")

    sup = ft.Supervisor(ckpt_root=str(tmp_path), max_restarts=2)
    with pytest.raises(RuntimeError) as exc_info:
        sup.run(init_state=lambda: {"x": torch.zeros(())},
                state_template=lambda: {"x": torch.zeros(())}, step_fn=bad_step, n_steps=5)
    assert sup.restarts == 3
    assert "[host 0/1]" in str(exc_info.value)
    assert "always fails" in str(exc_info.value)
    assert isinstance(exc_info.value.__cause__, RuntimeError)


def test_straggler_monitor():
    mon = ft.StragglerMonitor(alpha=0.5, threshold=2.0)
    assert not mon.observe(0, 1.0)
    assert not mon.observe(1, 1.1)
    assert mon.observe(2, 5.0)  # 5x the EWMA -> flagged
    assert len(mon.flagged) == 1


# ------------------------------------------------- across the two packages --


def _jax_tree(tree):
    """The port's optimizer state types → JAX's, leaves as jnp arrays."""
    def conv(x):
        if isinstance(x, opt.AdamWState):
            return jopt.AdamWState(step=conv(x.step), m=conv(x.m), v=conv(x.v))
        if isinstance(x, opt.Q8Leaf):
            return jopt.Q8Leaf(conv(x.q), conv(x.scale))
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(conv(v) for v in x)
        return jnp.asarray(x)

    return conv(interop.tree_to_numpy(tree))


def _train_state(int8: bool):
    cfg = dataclasses.replace(harness.demo_config(), stage_channels=((16, 16),),
                              pooled_stages=1)
    params, bn = sy.init_params(cfg, seed=3, device="cpu")
    ocfg = opt.AdamWConfig(int8_moments=int8)
    o = opt.init_state(params, ocfg)
    g = tu.tree_map(lambda p: torch.randn(p.shape, generator=torch.Generator().manual_seed(5)),
                    params)
    params, o = opt.apply_updates(params, g, o, ocfg)
    return {"params": params, "bn": bn, "opt": o, "extra": (torch.tensor(1.5), [torch.ones(2)])}


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_manifest_paths_equal_jax(tmp_path, int8):
    state = _train_state(int8)
    ckpt.save(str(tmp_path / "port"), 1, state)
    jckpt.save(str(tmp_path / "jax"), 1, _jax_tree(state))
    man = [json.loads((tmp_path / d / "step_000000001" / "manifest.json").read_text())
           for d in ("port", "jax")]
    assert [(e["path"], e["shape"], e["dtype"]) for e in man[0]["leaves"]] == \
        [(e["path"], e["shape"], e["dtype"]) for e in man[1]["leaves"]]
    assert any(e["path"] == "['opt']/.m/['encode']/['w']" + ("/.q" if int8 else "")
               for e in man[0]["leaves"])


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_port_train_state_restored_by_jax(tmp_path, int8):
    state = _train_state(int8)
    ckpt.save(str(tmp_path), 4, state)
    want = _jax_tree(state)
    template = jax.tree_util.tree_map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), want)
    got, step = jckpt.restore(str(tmp_path), template)
    assert step == 4
    for a, b in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_jax_train_state_restored_by_port(tmp_path, int8):
    """JAX writes {params, bn, opt}; the port restores it into its own
    structure, and ``opt_state_from_numpy`` carries the same state across
    in memory: both bit-equal."""
    cfg = dataclasses.replace(jh.demo_config(), stage_channels=((16, 16),), pooled_stages=1)
    params, bn = jsy.init_params(jax.random.PRNGKey(2), cfg)
    ocfg = jopt.AdamWConfig(int8_moments=int8)
    grads = jax.tree_util.tree_map(lambda p: jnp.ones_like(p) * 0.3, params)
    params, o = jopt.apply_updates(params, grads, jopt.init_state(params, ocfg), ocfg)
    jckpt.save(str(tmp_path), 2, {"params": params, "bn": bn, "opt": o})
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    p, b, _ = interop.params_from_numpy(np_tree(params), np_tree(bn), device="cpu")
    mem = opt.init_state(p, opt.AdamWConfig(int8_moments=int8))
    got, step = ckpt.restore(str(tmp_path), {"params": p, "bn": b, "opt": mem})
    carried = interop.opt_state_from_numpy(np_tree(o), device="cpu")
    assert step == 2 and isinstance(got["opt"], opt.AdamWState)
    assert got["opt"].step.dtype == torch.int32 and int(got["opt"].step) == 1
    want = np_tree({"params": params, "bn": bn, "opt": o})
    for a, g in zip(jax.tree_util.tree_leaves(want), tu.leaves(got)):
        np.testing.assert_array_equal(g.numpy(), a)
    _assert_tree_equal(got["opt"], carried)


@pytest.fixture(scope="module")
def trained_detector(tmp_path_factory):
    """A detector the port trained (2 steps at demo_config), pruned 80%,
    fake-quantized to 8 bits and saved; and uint8-grid frames."""
    root = str(tmp_path_factory.mktemp("det"))
    cfg = harness.demo_config()
    params, bn, _, losses = harness.train_steps(cfg, steps=2, batch=2, verbose=False,
                                                device="cpu")
    pruned = pruning.prune_tree(params, 0.8)
    q = tu.tree_map(lambda x: quant.fake_quant_tensor(x, 8) if x.dim() == 4 else x, pruned)
    harness.save_detector_checkpoint(root, 2, q, bn, cfg,
                                     extra_files={"notes.txt": b"port-trained"})
    frames = (np.random.default_rng(0).integers(0, 256, (2, *cfg.input_hw, 3))
              / 255.0).astype(np.float32)
    return root, cfg, q, bn, frames


def test_detector_checkpoint_restored_by_jax(trained_detector):
    root, cfg, q, bn, _ = trained_detector
    jcfg, jp, jbn, step = jh.restore_detector_checkpoint(root)
    assert step == 2
    assert jsy.config_to_dict(jcfg) == sy.config_to_dict(cfg)
    for name, layer in q.items():
        for k, v in layer.items():
            assert np.asarray(jp[name][k]).dtype == np.float32
            np.testing.assert_array_equal(np.asarray(jp[name][k]), v.numpy())
    for name, st in bn.items():
        for k, v in st.items():
            a = np.asarray(jbn[name][k])
            assert a.dtype == v.numpy().dtype
            np.testing.assert_array_equal(a, v.numpy())
    assert jckpt.read_extra_file(root, "notes.txt") == b"port-trained"
    # the port's own reader agrees
    pcfg, pp, pb, _ = harness.restore_detector_checkpoint(root, device="cpu")
    assert pcfg == cfg
    _assert_tree_equal({"p": q, "b": bn}, {"p": pp, "b": pb})


def test_detector_checkpoint_serves_same_detections_in_jax(trained_detector):
    """JAX's compile_detector on the restored weights gives the same
    ``valid`` and ``classes`` as the port's on its own (evaluation
    thresholds, so that a briefly trained head yields detections)."""
    root, cfg, q, bn, frames = trained_detector
    jcfg, jp, jbn, _ = jh.restore_detector_checkpoint(root)
    jdets, jhead = jh.compile_eval_detector(jcfg, jp, jbn).detect(jnp.asarray(frames))
    dets, head = harness.compile_eval_detector(cfg, q, bn, device="cpu").detect(frames)
    np.testing.assert_array_equal(dets.valid.numpy(), np.asarray(jdets.valid))
    assert int(dets.valid.sum()) > 0
    np.testing.assert_array_equal(dets.classes.numpy(), np.asarray(jdets.classes))
    err = float(np.abs(head.numpy() - np.asarray(jhead)).max())
    print(f"head: max |Δ| {err:.2e} (bound 1e-4)")
    assert err <= 1e-4


def test_detector_checkpoint_refuses_config_shadowing(tmp_path):
    cfg = harness.demo_config()
    params, bn = sy.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="shadow"):
        harness.save_detector_checkpoint(str(tmp_path), 0, params, bn, cfg,
                                         extra_files={harness.DETECTOR_CONFIG_FILE: b"{}"})
    assert ckpt.latest_step(str(tmp_path)) is None
