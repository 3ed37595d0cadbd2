"""The port's multi-process execution on the CPU: the mirror of
``tests/test_multihost.py`` (and of ``tests/test_distributed.py``'s
int8/hierarchical sums), with real gloo process groups.

Each test spawns two (or four) ``python -c`` processes under
``CUDA_VISIBLE_DEVICES=""`` that meet through
``repro_torch.distributed.runtime.initialize(device="cpu")`` and exercise
the per-host paths end to end; the parent computes every reference itself
(JAX's, and the port's in one process), so parity is cross-process by
construction:

* the group spans both processes,
* sharded mAP over two hosts is bit-identical to JAX's single-host
  evaluation (precomputed predictions, and the detector path on carried
  weights), and an uneven shard count is refused,
* data-parallel ``launch.train`` matches the single-process run,
* a checkpoint saved striped over two hosts restores bit-exact in one
  process through both packages' ``restore``,
* ``int8_psum`` and ``hierarchical_psum`` over a 2 × 2 (pod, data) grid.

Every child has a 300 s limit, and every process group a timeout of its own
(``runtime.TIMEOUT_S``), so a crashed peer fails the test and never hangs
the suite."""
import dataclasses
import inspect
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.eval import detection_map as jdm  # noqa: E402
from repro.eval import harness as jh  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.eval import harness  # noqa: E402
from repro_torch.eval import sharded as se  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# two threads a child: the suite runs beside other workers
_ENV = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "CUDA_VISIBLE_DEVICES": "",
        "OMP_NUM_THREADS": "2"}
CHILD_TIMEOUT_S = 300
NUM_CLASSES = 3
DET_IOU = 0.1  # as tests/test_torch_sharded_eval.py: a report of zeros compares nothing
DET_IMAGES = 16

_PREAMBLE = """\
import json
import numpy as np
import torch
from repro_torch.distributed import runtime
ctx = runtime.initialize(coordinator_address="127.0.0.1:{port}", num_processes={n},
                         process_id={pid}, device="cpu")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_group(body: str, *, prelude: str = "", n: int = 2) -> list:
    """The same worker body as processes 0..n-1 of one job; returns their
    stdouts, asserting every one exited 0."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", prelude + "\n" + _PREAMBLE.format(port=port, n=n, pid=pid)
         + textwrap.dedent(body) + "\nruntime.shutdown()\n"],
        env=_ENV, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(n)]
    return _collect(procs)


def _collect(procs) -> list:
    outs, failures = [], []
    try:
        for pid, p in enumerate(procs):
            out, err = p.communicate(timeout=CHILD_TIMEOUT_S)
            if p.returncode != 0:
                failures.append(f"host {pid} rc={p.returncode}\nstdout:\n{out}\n"
                                f"stderr:\n{err[-4000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not failures, "\n\n".join(failures)
    return outs


def _report_line(out: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith("REPORT=")]
    assert len(lines) == 1, f"expected one REPORT= line, got:\n{out}"
    return json.loads(lines[0][len("REPORT="):])


def _random_split(seed: int, n_images: int):
    """Seeded (predictions, ground_truths) with overlapping boxes and
    one-decimal score ties: the pooling ORDER is observable in AP, so
    parity proves the cross-process gather rebuilds the single-host
    order."""
    rng = np.random.default_rng(seed)
    preds, gts = [], []
    for _ in range(n_images):
        g = int(rng.integers(0, 5))
        g_boxes = rng.uniform(0.2, 0.8, (g, 4)).astype(np.float32)
        g_cls = rng.integers(0, NUM_CLASSES, g)
        gts.append({"boxes": g_boxes, "classes": g_cls})
        p_extra = int(rng.integers(0, 6))
        near = g_boxes + rng.normal(0, 0.02, g_boxes.shape).astype(np.float32)
        p_boxes = np.concatenate([near, rng.uniform(0.2, 0.8, (p_extra, 4)).astype(np.float32)])
        p_cls = np.concatenate([g_cls, rng.integers(0, NUM_CLASSES, p_extra)])
        scores = np.round(rng.uniform(0, 1, len(p_boxes)), 1)
        preds.append({"boxes": p_boxes, "scores": scores.astype(np.float32),
                      "classes": p_cls})
    return preds, gts


def test_two_process_group_spans_both_processes():
    """The mesh regression's counterpart: the process group is the stripe
    mesh, one member per host, ranks in host order."""
    outs = _run_group("""
        from repro_torch.distributed import collectives as C
        assert ctx.is_multi_controller and ctx.n_hosts == 2 and ctx.backend == "gloo"
        assert torch.distributed.get_world_size() == 2
        assert ctx.device == torch.device("cpu")
        g, total = C.eval_stats_allgather({"rank": np.array([[ctx.host_id]], np.int32)},
                                          np.ones((1, 2), np.int32), ctx)
        assert g["rank"].reshape(-1).tolist() == [0, 1], g
        assert total.tolist() == [2, 2], total
        assert ctx.owned_shards(4) == [ctx.host_id, ctx.host_id + 2]
        ctx.barrier("spans")
        print("GROUP_OK", ctx.describe())
    """)
    assert [o.split("GROUP_OK ")[1].strip() for o in outs] == ["host 0/2, gloo",
                                                               "host 1/2, gloo"]


def test_sharded_predictions_map_bit_parity():
    """``evaluate_predictions_sharded`` over 2 hosts × 2 owned shards ==
    JAX's ``detection_map.evaluate_detections``, bit for bit, on every
    host; ``n_shards=3`` is refused."""
    outs = _run_group(prelude=inspect.getsource(_random_split) + f"\nNUM_CLASSES = {NUM_CLASSES}\n",
                      body="""
        from repro_torch.eval import sharded as se
        preds, gts = _random_split(5, 12)
        rep = se.evaluate_predictions_sharded(preds, gts, num_classes=NUM_CLASSES,
                                              eval_cfg=se.ShardedEvalConfig(n_shards=4), ctx=ctx)
        assert rep["n_hosts"] == 2 and rep["gather"] == "process" and rep["n_shards"] == 4
        try:
            se.evaluate_predictions_sharded(preds, gts, num_classes=NUM_CLASSES,
                                            eval_cfg=se.ShardedEvalConfig(n_shards=3), ctx=ctx)
        except ValueError as e:
            assert "stripe evenly" in str(e), e
        else:
            raise AssertionError("n_shards=3 over 2 hosts must raise")
        print("REPORT=" + json.dumps(rep))
    """)
    preds, gts = _random_split(5, 12)
    ref = jdm.evaluate_detections(preds, gts, num_classes=NUM_CLASSES, iou_threshold=0.5)
    assert ref["map"] > 0
    for out in outs:
        assert se.reports_identical(_report_line(out), ref)


def test_sharded_detector_map_bit_parity(tmp_path):
    """The full forward→decode→NMS path: each host runs only its owned
    shards of the val split through the kernel executor's plain version;
    the report equals the port's single-process one and JAX's (dense
    executor) on the same weights — the port's seeded ``demo_weights`` at
    the smoke config, carried across — bit for bit."""
    from repro.configs import get_config
    from repro.configs import smoke_config as jsmoke
    from repro_torch.configs.snn_det import CONFIG, smoke_config
    from repro_torch.serve.detector import demo_weights

    cfg = dataclasses.replace(smoke_config(CONFIG), conv_exec="pallas")
    params, bn, _ = demo_weights(cfg, device="cpu")
    root = str(tmp_path / "det")
    harness.save_detector_checkpoint(root, 0, params, bn, cfg)
    outs = _run_group(f"""
        from repro_torch.eval import harness
        from repro_torch.eval import sharded as se
        cfg, p, b, _ = harness.restore_detector_checkpoint({root!r}, device=ctx.device)
        det = harness.compile_eval_detector(cfg, p, b, device=ctx.device)
        rep = harness.evaluate_detector(det, n_images={DET_IMAGES}, iou_threshold={DET_IOU},
                                        sharded=se.ShardedEvalConfig(n_shards=4, batch=2),
                                        ctx=ctx)
        assert rep["n_hosts"] == 2 and rep["gather"] == "process"
        print("REPORT=" + json.dumps(rep))
    """)
    single = harness.evaluate_detector(harness.compile_eval_detector(cfg, params, bn,
                                                                     device="cpu"),
                                       n_images=DET_IMAGES, iou_threshold=DET_IOU)
    to_jax = lambda t: jax.tree_util.tree_map(  # noqa: E731
        jnp.asarray, tu.tree_map(lambda x: x.numpy(), t))
    jcfg = dataclasses.replace(jsmoke(get_config("snn-det")), conv_exec="dense")
    jdet = jh.compile_eval_detector(jcfg, to_jax(params), to_jax(bn))
    ref = jh.evaluate_detector(jdet, n_images=DET_IMAGES, iou_threshold=DET_IOU)
    assert ref["map"] > 0 and se.reports_identical(single, ref)
    for out in outs:
        assert se.reports_identical(_report_line(out), ref)


def test_data_parallel_train_loss_parity(tmp_path):
    """``launch.train --coordinator`` (global batch 8 striped over 2 hosts,
    the gradients averaged over them) reproduces the single-process loss
    trajectory at ``tests/test_multihost.py``'s bound."""
    steps = 11  # the smoke loss curve is noisy early; by step 11 the launcher's gate holds
    common = ["--arch", "qwen1.5-0.5b", "--steps", str(steps), "--batch", "8", "--seq", "16",
              "--device", "cpu"]
    port = _free_port()
    multi_out = tmp_path / "multi.json"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *common,
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
         "--process-id", str(pid), "--losses-out", str(multi_out)],
        env=_ENV, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]
    outs = _collect(procs)
    assert "qwen1.5-0.5b: 11 steps" in outs[0] and outs[1] == ""  # only host 0 prints
    single = launch_train.main(common)["losses"]
    multi = json.loads(multi_out.read_text())
    assert len(multi) == len(single) == steps
    # the 2-host global batch is a row permutation of the single-process one
    np.testing.assert_allclose(multi, single, rtol=2e-4, atol=1e-5)


def test_checkpoint_two_host_save_one_host_restore(tmp_path):
    """A leaf-striped save on 2 hosts (host i writes leaf j where
    j % 2 == i), then the parent — one process — restores it bit-exact
    through the port's ``restore`` and through JAX's, and reads the shard
    manifest; ``save_async`` refuses the multi-controller context."""
    root = tmp_path / "ckpt"
    full_w = np.arange(12, dtype=np.float32).reshape(4, 3) / 7.0
    full_m = (np.arange(8, dtype=np.int32) * 3).reshape(8, 1)
    full_v = (np.arange(6, dtype=np.float32) / 3.0).reshape(2, 3)
    outs = _run_group(f"""
        from repro_torch.train import checkpoint as ckpt
        tree = {{"w": torch.arange(12, dtype=torch.float32).reshape(4, 3) / 7.0,
                 "b": np.full((3,), 7, np.int16),
                 "m": (torch.arange(8, dtype=torch.int32) * 3).reshape(8, 1),
                 "v": (torch.arange(6, dtype=torch.float32) / 3.0).reshape(2, 3).bfloat16()}}
        out = ckpt.save({str(root)!r}, 3, tree, ctx=ctx, extra_files={{"note.txt": b"hi"}})
        try:
            ckpt.save_async({str(root)!r}, 4, tree)
        except NotImplementedError as e:
            assert "single-controller" in str(e)
        else:
            raise AssertionError("save_async must refuse multi-controller")
        print("SAVED", out)
    """)
    assert all("SAVED" in o for o in outs)
    want_v = torch.from_numpy(full_v).bfloat16()
    template = {"w": torch.zeros((4, 3)), "b": ckpt.ShapeDtype((3,), np.int16),
                "m": torch.zeros((8, 1), dtype=torch.int32),
                "v": torch.zeros((2, 3), dtype=torch.bfloat16)}
    state, step = ckpt.restore(str(root), template)
    assert step == 3
    assert torch.equal(state["w"], torch.from_numpy(full_w))  # bit-exact
    assert torch.equal(state["m"], torch.from_numpy(full_m))
    assert state["v"].dtype == torch.bfloat16 and torch.equal(state["v"], want_v)
    np.testing.assert_array_equal(state["b"], np.full((3,), 7, np.int16))
    jstate, jstep = jckpt.restore(str(root), {
        "w": jnp.zeros((4, 3), jnp.float32), "b": np.zeros((3,), np.int16),
        "m": jnp.zeros((8, 1), jnp.int32), "v": jnp.zeros((2, 3), jnp.bfloat16)})
    assert jstep == 3
    np.testing.assert_array_equal(np.asarray(jstate["w"]), full_w)
    np.testing.assert_array_equal(np.asarray(jstate["m"]), full_m)
    np.testing.assert_array_equal(np.asarray(jstate["v"], np.float32), want_v.float().numpy())
    np.testing.assert_array_equal(np.asarray(jstate["b"]), np.full((3,), 7, np.int16))

    step_dir = root / "step_000000003"
    manifest = json.loads((step_dir / "shard_manifest.json").read_text())
    assert manifest["n_hosts"] == 2 and set(manifest["hosts"]) == {"0", "1"}
    # sorted keys b, m, v, w -> host 0 owns leaves 0 and 2, host 1 leaves 1 and 3
    assert manifest["hosts"]["0"] == ["leaf_00000.npy", "leaf_00002.npy"]
    assert manifest["hosts"]["1"] == ["leaf_00001.npy", "leaf_00003.npy"]
    leaves = json.loads((step_dir / "manifest.json").read_text())["leaves"]
    assert [e["host"] for e in leaves] == [0, 1, 0, 1]
    assert [e["dtype"] for e in leaves] == ["int16", "int32", "float32", "float32"]
    assert (step_dir / "note.txt").read_bytes() == b"hi"
    assert not (root / "step_000000004").exists()


def test_int8_and_hierarchical_psum_four_processes():
    """Four gloo processes on a 2 × 2 (pod, data) grid, at
    ``tests/test_distributed.py``'s bounds: the int8 sum over ``data`` is 2x
    within two int8 roundings (4·max/127), the hierarchical sum over both
    axes 4x within 1e-5 relative."""
    outs = _run_group("""
        from repro_torch.distributed import collectives as C
        pod, data = C.subgroups(ctx, n_pods=2)
        x = torch.arange(24, dtype=torch.float32).reshape(4, 6) / 7.0
        y = C.int8_psum(ctx, data)(x)
        atol = 4 * float(x.abs().max()) / 127
        np.testing.assert_allclose(y.numpy(), x.numpy() * 2, atol=atol)
        z = C.hierarchical_psum(ctx, pod, data)(x)
        np.testing.assert_allclose(z.numpy(), x.numpy() * 4, rtol=1e-5)
        w = x.clone()
        C.allreduce_mean_([w], ctx)
        assert torch.equal(w, x)  # the mean of four equal copies
        print("COLLECTIVES_OK")
    """, n=4)
    assert all("COLLECTIVES_OK" in o for o in outs)
