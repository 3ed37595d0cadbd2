"""Cells, traffic and configurations are found by name; the clients'
requests depend on the seed alone."""
import json
import os
import shutil

import numpy as np
import pytest

from bench import harness
from bench.workload import ClosedLoop, Traffic
from conftest import ROOT


def test_a_workload_added_as_data_is_found_by_name(tmp_path):
    shutil.copytree(os.path.join(ROOT, "bench", "configs"), tmp_path / "bench" / "configs")
    shutil.copytree(os.path.join(ROOT, "bench", "traffic"), tmp_path / "bench" / "traffic")
    spec = harness.load_spec(ROOT)
    spec["workloads"].append({"name": "snn-det-ivs3cls.join16", "config": "snn-det-ivs3cls",
                              "traffic": "join16", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "only_join16", "unit": "ms", "better": "lower",
                              "source": "host_clock", "layer": "device",
                              "moves": "frames_per_s", "workloads": ["snn-det-ivs3cls.join16"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (tmp_path / "bench" / "traffic" / "join16.json").write_text(json.dumps(
        {"loop": "closed", "n_slots": 16, "clients": 16, "frames_per_request": 4,
         "pool_frames": 8, "warmup_ticks": 1, "compare_requests": 2, "reference_batch": 2}))
    found = harness.find_cell(harness.load_spec(str(tmp_path)), "snn-det-ivs3cls.join16",
                              str(tmp_path))
    assert found["traffic"].n_slots == 16
    assert found["config"]["name"] == "snn-det-ivs3cls"
    assert [m["name"] for m in found["per_layer"]][-1] == "only_join16"
    other = harness.find_cell(harness.load_spec(str(tmp_path)), "snn-det-ivs3cls.fleet64",
                              str(tmp_path))
    assert "only_join16" not in [m["name"] for m in other["per_layer"]]
    with pytest.raises(KeyError):
        harness.find_cell(spec, "no-such.cell", str(tmp_path))


def test_every_cell_of_the_benchmark_resolves():
    spec = harness.load_spec(ROOT)
    for cell in spec["workloads"]:
        found = harness.find_cell(spec, cell["name"], ROOT)
        assert found["end_to_end"] and found["per_layer"]
        for m in found["per_layer"]:
            harness.metric_reader(m["name"])


def test_requests_depend_on_the_seed_alone():
    t = Traffic.from_json({"loop": "closed", "n_slots": 4, "clients": 4,
                           "frames_per_request": 4, "pool_frames": 10, "warmup_ticks": 1, "compare_requests": 1,
                           "reference_batch": 1})
    pool = np.arange(10, dtype=np.float32)[:, None, None, None] * np.ones((1, 2, 2, 3),
                                                                          np.float32)
    a, b = ClosedLoop(t, pool, 7), ClosedLoop(t, pool, 7)
    first = a.first()
    assert [len(f) for _, _, f in first] == [4, 4, 4, 4]
    b.first()
    # the clients finish in another order: each client's next request is the same
    later_a = [a.next(c)[2][:, 0, 0, 0].tolist() for c in (0, 1, 2, 3)]
    later_b = [b.next(c)[2][:, 0, 0, 0].tolist() for c in (3, 2, 1, 0)][::-1]
    assert later_a == later_b
    assert all(len(f) == 4 for f in later_a)
    assert np.shares_memory(first[0][2], pool)  # a view: admission copies nothing
    other = ClosedLoop(t, pool, 8)
    other.first()
    assert [other.next(c)[2][:, 0, 0, 0].tolist() for c in range(4)] != later_a
