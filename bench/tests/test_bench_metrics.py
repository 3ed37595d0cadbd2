"""The metric arithmetic on hand-made windows and traces, and one small
layer's bound worked out by hand."""
import math

import pytest

from bench import cost, stats
from bench.harness import Window, metric_reader
from bench.trace import Trace


def test_rate_and_percentile_over_the_whole_window():
    ticks = [0.010] * 19 + [0.030]
    assert stats.rate(100, 2.0) == 50.0
    assert stats.percentile_ms(ticks, 95) == pytest.approx(10.0 + (0.95 * 19 - 18) * 20.0)
    assert stats.percentile_ms([0.002, 0.004], 50) == pytest.approx(3.0)
    with pytest.raises(ValueError):
        stats.percentile_ms([], 95)


def test_engine_readers():
    w = Window(seconds=1.0, ticks=[0.02, 0.03], frames=16,
               step_wall=[0.020, 0.030], upload_wall=[0.004, 0.002, 0.003],
               step_device_ms=[15.0, 20.0], launches={"fused_pipeline": 54})
    assert metric_reader("engine_host_ms")(w) == pytest.approx(7.5)
    assert metric_reader("upload_host_ms")(w) == pytest.approx(4.5)
    assert metric_reader("step_device_ms")(w) == pytest.approx(17.5)
    assert metric_reader("fused_launches_per_frame")(w) == pytest.approx(54 / 16)
    assert metric_reader("engine_host_ms")(Window(seconds=1.0, ticks=[], frames=0)) is None


def _event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_trace_readers_and_breakdown():
    events = [
        _event("engine.step", "user_annotation", 0.0, 1000.0),
        _event("core.upload", "user_annotation", 0.0, 200.0),
        _event("engine.step", "user_annotation", 1000.0, 1000.0),
        _event("void fused_pipeline_kernel<1, 2, 8, 1, false>(Params)", "kernel", 200.0, 300.0),
        _event("elementwise_kernel", "kernel", 400.0, 300.0),  # overlaps the one before
        _event("Memcpy HtoD", "gpu_memcpy", 1000.0, 100.0),
        _event("elementwise_kernel", "kernel", 1500.0, 400.0),
    ]
    tr = Trace(events)
    assert tr.window_s == pytest.approx(2000e-6)
    assert tr.busy_s == pytest.approx((500 + 100 + 400) * 1e-6)
    assert tr.kernel_s("fused_pipeline_kernel") == pytest.approx(300e-6)
    assert tr.kernel_s(exclude=("fused_pipeline_kernel",)) == pytest.approx(700e-6)
    w = Window(seconds=0.002, ticks=[0.001, 0.001], frames=4, step_wall=[0.001, 0.001],
               trace=tr)
    assert metric_reader("device_idle_pct")(w) == pytest.approx(50.0)
    assert metric_reader("eager_device_ms")(w) == pytest.approx(0.35)
    gaps = dict(tr.breakdown()["idle_gaps"])
    assert gaps["core.upload"] == pytest.approx(200e-6)  # 0..200 inside the upload
    assert gaps["engine.step"] == pytest.approx((300 + 400 + 100) * 1e-6)
    ops = dict(tr.breakdown()["device_ops"])
    assert ops["elementwise_kernel"] == pytest.approx(700e-6)


def test_one_small_layers_bound_by_hand():
    # a 3x3 layer, 8 -> 16 channels, 3 input steps, 4x4 map, batch 2, 100 nonzero weights
    shape, geo, nnz, batch = (3, 3, 8, 16), (4, 4, 3, 3), 100, 2
    pix = batch * 16
    nbytes = 3 * pix * 8 + 100 + math.ceil(9 * 8 * 16 / 8) + 5 * 16 * 4 + 2 * pix * 16 * 4 \
        + 3 * pix * 16
    ops = 2 * 3 * pix * 100
    assert cost.launch_bytes(shape, geo, nnz, batch) == nbytes
    assert cost.launch_ops(geo, nnz, batch) == ops
    assert cost.least_s(shape, geo, nnz, batch) == max(nbytes / 3.35e12, ops / 1979e12)


def test_roofline_and_mfu_readers():
    m = {"input_hw": [24, 32], "stem_channels": 8, "conv_block_channels": 8,
         "stage_channels": [[8, 8]], "pooled_stages": 1, "num_anchors": 5, "num_classes": 3,
         "full_t": 3, "mixed_time": True, "rate_encode": False}
    from bench.reference import snn_ref

    nnz = {n: 10 for n in snn_ref.layer_shapes(m)}
    tr = Trace([_event("engine.step", "user_annotation", 0.0, 1000.0),
                _event("fused_pipeline_kernel", "kernel", 0.0, 500.0)])
    w = Window(seconds=0.5, ticks=[0.5], frames=3, batches=[4, 4], model=m, nnz=nnz, trace=tr)
    least = 2 * cost.tick_least_s(m, nnz, 4)
    assert metric_reader("fused_roofline")(w) == pytest.approx(100 * least / 500e-6)
    assert metric_reader("step_mfu_pct")(w) == pytest.approx(
        100 * 3 * cost.frame_ops(m, nnz) / (0.5 * 1979e12))
    w.trace = Trace([_event("engine.step", "user_annotation", 0.0, 1.0)])
    assert metric_reader("fused_roofline")(w) is None  # nothing to read: no number
