"""The paper's pipeline end to end on the port, on the CPU: ``run_pipeline``
alone and what it refuses, ``eval_map`` (``--ckpt-dir``, then
``--checkpoint``) and the serve CLI's ``--eval-map`` gate on a QAT
checkpoint (the module's ``smoke_ckpt`` fixture), against the JAX package
where it has a counterpart. Moved out of ``test_torch_paper.py``
unchanged. Each tolerance is stated beside its check."""
import dataclasses
import json
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
from repro.eval import harness as jh  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.benchmarks import eval_map  # noqa: E402
from repro_torch.configs.snn_det import CONFIG, smoke_config  # noqa: E402
from repro_torch.core import pruning  # noqa: E402
from repro_torch.eval import harness  # noqa: E402
from repro_torch.eval import sharded as se  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _block_demo(h):
    """``demo_config`` with block conv (block 6×10 divides every map): the
    compressed executors' border semantics in every stage."""
    return dataclasses.replace(h.demo_config(), use_block_conv=True)


def test_run_pipeline_on_cpu_end_to_end(tmp_path):
    """A real two-step pipeline: the pruned support survives QAT, the
    summary has JAX's keys, the checkpoints are the float and QAT stages."""
    cfg = _block_demo(harness)
    rep = harness.run_pipeline(cfg, steps=2, finetune_steps=1, batch=2, eval_images=4,
                               conv_exec="pallas", ckpt_dir=str(tmp_path), verbose=False,
                               device="cpu")
    jkeys = jh.EvalReport(stages={"qat": {"map": 0.0, "per_class_ap": []}},
                          schedules={"uniform_t3": {"map": 0.0}, "mixed_1_3": {"map": 0.0}},
                          accumulator={"max_abs": 0, "within_16b": True}, losses={},
                          wall_s=0.0).summary()
    assert set(rep.summary()) == set(jkeys)
    assert len(rep.losses["train"]) == 2 and len(rep.losses["qat"]) == 1
    fcfg, fparams, _, step = harness.restore_detector_checkpoint(str(tmp_path), step=2,
                                                                device="cpu")
    assert step == 2 and fcfg.weight_bits == 0 and fcfg.conv_exec == "dense"
    qcfg, qparams, _, step = harness.restore_detector_checkpoint(str(tmp_path), device="cpu")
    assert step == 3 and qcfg == dataclasses.replace(cfg, conv_exec="pallas")
    mask = pruning.mask_tree(fparams, 0.8)
    for m, w, fw in zip(tu.leaves(mask), tu.leaves(qparams), tu.leaves(fparams)):
        assert bool((w[m == 0] == 0).all())
        if pruning.is_spatial_kernel(fw):
            assert 0.15 < float(m.mean()) < 0.25
    for a, b in zip(tu.leaves(qparams), tu.leaves(rep.final_det.params)):
        assert torch.equal(a, b)
    assert rep.final_det.cfg.conv_exec == "pallas" and rep.final_det.plan is not None


def test_run_pipeline_refuses_what_is_not_ported():
    """``eval_shards=2`` routes every evaluation through the sharded path
    and gives the stage and schedule reports of ``eval_shards=1``; a
    compressed executor still needs a block-conv config."""
    kw = dict(steps=1, finetune_steps=1, batch=2, eval_images=4, conv_exec="pallas",
              verbose=False, device="cpu")
    one = harness.run_pipeline(smoke_config(CONFIG), **kw)
    two = harness.run_pipeline(smoke_config(CONFIG), eval_shards=2, **kw)
    for name in one.stages:
        assert two.stages[name]["n_shards"] == 2 and two.stages[name]["gather"] == "host"
        assert se.reports_identical(two.stages[name], one.stages[name]), name
    for name in one.schedules:
        assert se.reports_identical(two.schedules[name], one.schedules[name]), name
    with pytest.raises(ValueError, match="block-conv border"):
        harness.run_pipeline(harness.demo_config(), steps=1, conv_exec="pallas",
                             device="cpu")
    with pytest.raises(ValueError, match="block-conv border"):
        jh.run_pipeline(jh.demo_config(), steps=1, conv_exec="pallas")


# ------------------------------------------------------------ eval_map, CLI --


def test_eval_map_ckpt_dir_then_checkpoint(tmp_path, monkeypatch, capsys):
    """``--ckpt-dir`` then ``--checkpoint`` scores the QAT weights as the
    pipeline did; the working directory receives only the JSON asked for."""
    work, ckpts = tmp_path / "work", tmp_path / "ckpts"
    work.mkdir()
    monkeypatch.chdir(work)
    res = eval_map.main(["--fast", "--steps", "3", "--device", "cpu", "--ckpt-dir",
                         str(ckpts), "--out-json", "pipe.json"])
    assert os.listdir(work) == ["pipe.json"]
    assert json.loads((work / "pipe.json").read_text()) == json.loads(json.dumps(res))
    assert res["config"]["steps"] == 3 and res["config"]["finetune_steps"] == 20
    assert set(res["map_by_stage"]) == {"trained", "pruned", "qat"}
    again = eval_map.main(["--checkpoint", str(ckpts), "--fast", "--device", "cpu"])
    assert sorted(os.listdir(work)) == ["BENCH_torch_eval_ckpt.json", "pipe.json"]
    assert again["config"]["step"] == 23
    assert again["map"] == res["stages"]["qat"]["map"]
    assert again["per_class_ap"] == res["stages"]["qat"]["per_class_ap"]
    assert again["n_gt"] == res["stages"]["qat"]["n_gt"]
    sharded = eval_map.run_checkpoint(str(ckpts), eval_images=2, shards=2, out_json="",
                                      device="cpu")
    assert sharded["sharded_parity"]["bit_identical"] and sharded["config"]["eval_shards"] == 2
    assert sorted(os.listdir(work)) == ["BENCH_torch_eval_ckpt.json", "pipe.json"]
    assert "BIT-IDENTICAL" in capsys.readouterr().out


def test_eval_map_refuses_what_is_not_ported(tmp_path, monkeypatch, smoke_ckpt):
    """``--shards`` fails the run unless the sharded report is
    bit-identical to the single-process one; a dataset spec naming a
    missing file raises before anything is trained or written."""
    monkeypatch.chdir(tmp_path)
    real = harness.evaluate_detector

    def off_by_one(det, **kw):  # the single-process re-score disagrees
        rep = real(det, **kw)
        return rep if kw.get("sharded") else {**rep, "n_pred": [n + 1 for n in rep["n_pred"]]}

    monkeypatch.setattr(harness, "evaluate_detector", off_by_one)
    with pytest.raises(SystemExit, match="not bit-identical"):
        eval_map.main(["--checkpoint", smoke_ckpt, "--fast", "--shards", "2", "--device",
                       "cpu", "--out-json", ""])
    monkeypatch.setattr(harness, "evaluate_detector", real)
    # the COCO loader is ported: a spec naming a missing file raises before
    # anything is trained or written
    with pytest.raises(FileNotFoundError, match="x.json"):
        eval_map.main(["--fast", "--dataset", "coco:x.json", "--device", "cpu"])
    assert os.listdir(tmp_path) == []
    assert eval_map.OUT_JSON == "BENCH_torch_eval.json" != "BENCH_eval.json"


@pytest.fixture(scope="module")
def smoke_ckpt(tmp_path_factory):
    """A QAT detector checkpoint at the smoke config (block conv, 24×32),
    written by ``run_pipeline`` on the CPU."""
    root = str(tmp_path_factory.mktemp("smoke_ckpt"))
    harness.run_pipeline(smoke_config(CONFIG), steps=3, finetune_steps=2, batch=2,
                         eval_images=4, conv_exec="pallas", ckpt_dir=root, verbose=False,
                         device="cpu")
    return root


def test_serve_eval_map_checkpoint_is_bit_identical(smoke_ckpt):
    """``serve --eval-map --checkpoint``: the served detections score exactly
    as ``harness.evaluate_detector`` does, and the CLI exits 0."""
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "snn-det", "--eval-map",
         "--checkpoint", smoke_ckpt, "--requests", "8", "--slots", "3", "--device", "cpu"],
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert re.search(r"harness parity: served .* — BIT-IDENTICAL", r.stdout), r.stdout
    assert "served 8 streams (8 frames)" in r.stdout


def test_serve_eval_map_gate_fails_on_a_mismatch(smoke_ckpt, monkeypatch, capsys):
    real = harness.evaluate_detector

    def off_by_one(det, **kw):
        rep = real(det, **kw)
        return {**rep, "n_pred": [n + 1 for n in rep["n_pred"]]}

    monkeypatch.setattr(harness, "evaluate_detector", off_by_one)
    with pytest.raises(SystemExit, match="does not match"):
        serve.main(["--arch", "snn-det", "--eval-map", "--checkpoint", smoke_ckpt,
                    "--requests", "4", "--device", "cpu"])
    assert "MISMATCH" in capsys.readouterr().out


def test_serve_eval_map_flags_refuse_what_is_not_ported(smoke_ckpt, capsys):
    # --eval-shards 2 scores the served detections through the sharded
    # reduction, identically to --eval-shards 1, and passes the harness gate
    argv = ["--arch", "snn-det", "--eval-map", "--checkpoint", smoke_ckpt, "--requests", "6",
            "--device", "cpu"]
    serve.main(argv)
    one = capsys.readouterr().out
    serve.main(argv + ["--eval-shards", "2"])
    two = capsys.readouterr().out
    score = re.compile(r"served-detections mAP@0.5 (\S+) over 6 val frames")
    assert score.search(one).group(1) == score.search(two).group(1)
    assert "(2 shards, host gather)" in two and "BIT-IDENTICAL" in two
    # the VOC loader is ported: a spec naming a missing directory raises
    missing = os.path.join(smoke_ckpt, "no_such_voc_dir")
    with pytest.raises(FileNotFoundError, match="no_such_voc_dir"):
        serve.main(["--arch", "snn-det", "--eval-map", "--dataset", f"voc:{missing}",
                    "--device", "cpu"])
    # demo weights: the served score, and no parity gate without a checkpoint
    done = serve.main(["--arch", "snn-det", "--eval-map", "--requests", "3",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(done) == 3 and "served-detections mAP@0.5" in out and "parity" not in out
