"""The benchmark's command on the card: a short run of each cell prints one
result line that the contract's keys are in. Skips without a card."""
import json
import os
import subprocess
import sys

import pytest
import torch

from bench import harness
from conftest import ROOT


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in harness.load_spec(ROOT)["workloads"]])
def test_a_short_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode on this path")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "bench", "run.py"), "--workload",
                          cell, "--seed", "2147483659", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1


def test_without_a_card_the_command_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "bench", "run.py"), "--workload",
                          "snn-det-ivs3cls.fleet64", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
