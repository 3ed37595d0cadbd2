"""The meta-device cost model (``repro_torch.launch.op_cost``) and the
dry-run (``launch.dryrun``), mirroring ``tests/test_hlo_cost.py``'s
subjects where they have a torch meaning: n layers count n × one, nested
loops multiply, unrolled equals looped, batched-dot FLOPs, collectives
counted per call. The documented difference is pinned: an eager
elementwise chain is not HBM-free. One qwen1.5-0.5b ``smoke_config``
forward's product FLOPs are held within 1% of JAX's ``hlo_cost`` count,
the two-depth extrapolation equal to the full walk, and the dry-run run
on two ``smoke_config`` cells."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import smoke_config as jsmoke  # noqa: E402
from repro.launch import hlo_cost  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec, smoke_config  # noqa: E402
from repro_torch.distributed import collectives  # noqa: E402
from repro_torch.launch import dryrun, op_cost  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models import zoo  # noqa: E402


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("n", [1, 4, 16])
def test_n_layers_count_n_times_one(n):
    def f(x, w):
        for _ in range(n):
            x = x @ w
        return x

    c = op_cost.count(f, _meta(256, 256), _meta(256, 256))[1]
    assert c.flops == c.product_flops == 2 * 256**3 * n
    assert c.bytes == n * 3 * 256 * 256 * 4  # two operands and the result per product


def test_nested_loops_multiply():
    def g(x, w):
        for _ in range(3):
            for _ in range(5):
                x = x @ w
        return x

    c = op_cost.count(g, _meta(128, 128), _meta(128, 128))[1]
    assert c.flops == 2 * 128**3 * 15


def test_unrolled_equals_looped():
    def unrolled(x, w):
        x = x @ w
        x = x @ w
        x = x @ w
        return torch.tanh(x)

    def looped(x, w):
        for _ in range(3):
            x = x @ w
        return torch.tanh(x)

    a = op_cost.count(unrolled, _meta(64, 64), _meta(64, 64))[1]
    b = op_cost.count(looped, _meta(64, 64), _meta(64, 64))[1]
    assert a.as_dict() == b.as_dict()


def test_batched_dot_flops():
    c = op_cost.count(lambda a, b: torch.einsum("bik,bkj->bij", a, b),
                      _meta(4, 64, 32), _meta(4, 32, 48))[1]
    assert c.product_flops == 2 * 4 * 64 * 32 * 48


def test_eager_elementwise_chains_are_not_hbm_free():
    """The documented difference from hlo_cost's perfect-fusion model (whose
    test holds this chain under 30 MB): every eager pass reads its operands
    and writes its result, 11 MiB-units of 4 MiB here; flops one per
    output element."""
    def f(x):
        y = torch.tanh(x) * 2 + 1
        return torch.sigmoid(y) - x

    c = op_cost.count(f, _meta(1024, 1024))[1]
    mb = 1024 * 1024 * 4
    assert c.bytes == (2 + 2 + 2 + 2 + 3) * mb > 30e6
    assert c.flops == 5 * 1024 * 1024


def test_views_move_nothing():
    c = op_cost.count(lambda x: x.reshape(64, 16).t()[:8], _meta(32, 32))[1]
    assert c.bytes == 0 and c.flops == 0


def test_collectives_counted_per_call():
    grads = [_meta(10, 4), _meta(6, dtype=torch.bfloat16)]

    class Ctx:
        n_hosts = 2

    def step():
        collectives.allreduce_mean_(grads, Ctx())
        collectives.allreduce_mean_(grads[:1], Ctx())
        return collectives.int8_psum(Ctx())(grads[0])

    real = collectives.allreduce_mean_
    c = op_cost.count(step)[1]
    assert collectives.allreduce_mean_ is real  # the stand-ins are put back
    assert c.coll_calls == 4
    assert c.coll_by_kind == {"all-reduce": (40 * 4 + 6 * 2) + 40 * 4,
                              "all-to-all": 40, "all-gather": 40}
    assert c.coll_bytes == sum(c.coll_by_kind.values())


def test_qwen_smoke_forward_product_flops_match_hlo_cost(monkeypatch):
    """The matmul FLOPs of one forward equal JAX's trip-count-aware HLO
    count (its elementwise flops switched off) within 1%."""
    cfg, jcfg = smoke_config(get_config("qwen1.5-0.5b")), jsmoke(jget_config("qwen1.5-0.5b"))
    b, s = 2, 32
    params = zoo.get_api(cfg).init_params(0, device="meta")
    with torch.no_grad():
        got = op_cost.count(lambda: tfm.forward(params, _meta(b, s, dtype=torch.int32),
                                                cfg)[0])[1]
    jparams = jax.eval_shape(lambda k: jtfm.init_params(k, jcfg), jax.random.PRNGKey(0))
    text = jax.jit(lambda p, t: jtfm.forward(p, t, jcfg)[0]).lower(
        jparams, jax.ShapeDtypeStruct((b, s), jnp.int32)).compile().as_text()
    monkeypatch.setattr(hlo_cost, "_ELEMWISE_FLOP_OPS", set())
    want = hlo_cost.analyze_text(text)["flops"]
    assert got.product_flops == pytest.approx(want, rel=0.01)


CELLS = {
    "qwen1.5-0.5b": ShapeSpec("train_small", 32, 4, "train"),
    "olmoe-1b-7b": ShapeSpec("train_small", 32, 4, "train"),
    "zamba2-7b": ShapeSpec("decode_small", 64, 2, "decode"),
    "rwkv6-3b": ShapeSpec("prefill_small", 128, 2, "prefill"),
    "llava-next-34b": ShapeSpec("prefill_small", 16, 2, "prefill"),
}


@pytest.mark.parametrize("arch", sorted(CELLS))
def test_two_depth_extrapolation_equals_the_walk(arch):
    """Counting the stacked layers at two depths and extrapolating equals
    counting every layer (the hybrid's super-layers and tail included):
    FLOPs and collective bytes exactly; bytes within 1%, because autograd
    copies an arriving gradient into its leaf or takes it as it is
    depending on reference counts, which vary from layer to layer (a
    train step's few weight-sized copies)."""
    base = smoke_config(get_config(arch))
    units = 7 if arch != "zamba2-7b" else 3 * base.attn_every + 1  # 3 super-layers and a tail
    cfg = dataclasses.replace(base, n_layers=units)
    walked = dryrun.step_cost(cfg, CELLS[arch], walk=True)[0]
    extrapolated = dryrun.step_cost(cfg, CELLS[arch])[0]
    for k in ("flops", "product_flops", "coll_bytes"):
        assert getattr(extrapolated, k) == pytest.approx(getattr(walked, k), rel=1e-12), k
    assert extrapolated.bytes == pytest.approx(walked.bytes, rel=0.01 if
                                               CELLS[arch].kind == "train" else 1e-12)


@pytest.fixture
def smoke_cells(monkeypatch, tmp_path):
    """The dry-run at smoke_config on small shapes: its CLI reads the
    configs and shapes through the module."""
    monkeypatch.setattr(dryrun, "get_config", lambda a: smoke_config(get_config(a)))
    monkeypatch.setattr(dryrun, "SHAPES", {"train_4k": CELLS["qwen1.5-0.5b"],
                                           "decode_32k": CELLS["zamba2-7b"],
                                           "long_500k": ShapeSpec("long_500k", 256, 1,
                                                                  "decode")})
    return tmp_path


def test_dryrun_on_two_smoke_cells(smoke_cells, capsys):
    out = str(smoke_cells)
    assert dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "train_4k", "--mesh", "all",
                        "--out", out]) == 0
    assert dryrun.main(["--arch", "zamba2-7b", "--shape", "decode_32k", "--out", out]) == 0
    assert dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "long_500k", "--out", out]) == 0
    rec = json.loads((smoke_cells / "qwen1.5-0.5b__train_4k__h100.json").read_text())
    assert rec["status"] == "ok" and rec["step"] == "train_step"
    assert rec["n_microbatch"] == 2 and rec["per_device_batch"] == 4
    assert rec["collective_bytes_per_device"]["total"] == 0  # one card
    assert rec["static_bytes_per_device"]["params"] == sum(
        t.numel() * t.element_size() for t in
        __import__("repro_torch.tree", fromlist=["leaves"]).leaves(
            zoo.get_api(dryrun.get_config("qwen1.5-0.5b")).init_params(0, device="meta")))
    t = rec["roofline"]
    assert t["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert 0 < t["useful_flops_ratio"] <= 1
    x4 = json.loads((smoke_cells / "qwen1.5-0.5b__train_4k__h100x4.json").read_text())
    assert x4["per_device_batch"] == 1 and x4["model_axis"] is None
    # the data-parallel gradient all-reduce: every parameter's gradient once
    assert x4["collective_bytes_per_device"]["all-reduce"] > 0
    single = json.loads((smoke_cells / "qwen1.5-0.5b__train_4k__single.json").read_text())
    assert single["model_axis"] == "even split, not executed"
    assert single["static_bytes_per_device"]["params"] < rec["static_bytes_per_device"]["params"]
    dec = json.loads((smoke_cells / "zamba2-7b__decode_32k__h100.json").read_text())
    assert dec["step"] == "serve_step(decode)" and dec["static_bytes_per_device"]["cache"] > 0
    skipped = json.loads((smoke_cells / "qwen1.5-0.5b__long_500k__h100.json").read_text())
    assert skipped["status"] == "skipped"
    from repro_torch.benchmarks import roofline

    table = roofline.run(out, "h100")
    assert set(table) == {"qwen1.5-0.5b__train_4k", "zamba2-7b__decode_32k"}
    assert "skipped" in capsys.readouterr().out
    assert np.isfinite([v for v in table["zamba2-7b__decode_32k"].values()
                        if isinstance(v, float)]).all()
