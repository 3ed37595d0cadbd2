"""The port's sharded operations on a (data=2, model=2) ``DeviceMesh`` of
four gloo processes, against the JAX package's own functions run without
a mesh on the same numpy inputs (the mirror of ``tests/test_distributed.py``'s
embedding, KV-write and all-gather-matmul cases):

* ``embedding.embed_lookup`` — the table sharded ("model", "data") as
  vocab × d_model (fsdp rules); the rows equal JAX's, the gradient of
  sum(out²) equal JAX's, and on every rank the gradient has the table's
  layout and only the rank's (V/2, D/2) block;
* ``embedding.lm_head`` — logits vocab-sharded, equal to JAX's;
* ``kvops.cache_write`` — a sequence-sharded cache at (layer, pos) ∈
  {(0, 0), (1, 5), (2, 13)}, every rank writing only its own rows;
* ``collectives.overlap_allgather_matmul`` — within 1e-4 of JAX's on a
  one-device mesh, the same bits on every rank;
* ``sharding.constrain`` redistributes a DTensor, and is the identity on
  a plain tensor.

All of it runs in ONE spawned job of four processes (each `python -c`
child under ``CUDA_VISIBLE_DEVICES=""``, 300 s at most), which writes its
results for the parent to compare.
"""
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

from repro.distributed import collectives as jcoll  # noqa: E402
from repro.distributed import embedding as jde  # noqa: E402
from repro.distributed import kvops as jkv  # noqa: E402
from repro.distributed.compat import make_mesh  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ENV = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"), "CUDA_VISIBLE_DEVICES": "",
        "OMP_NUM_THREADS": "1"}
CHILD_TIMEOUT_S = 300
V, D, B, S = 32, 16, 4, 8
KV_SHAPE = (3, 2, 16, 2, 4)  # (L, B, S, KV, HD)
WRITES = ((0, 0), (1, 5), (2, 13))

_CHILD = """
import numpy as np, torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor, DTensor
from repro_torch.distributed import runtime, sharding as shd, embedding as de, kvops
from repro_torch.distributed import collectives as C
ctx = runtime.initialize(coordinator_address="127.0.0.1:{port}", num_processes=4,
                         process_id={pid}, device="cpu")
inp = dict(np.load("{inp}"))
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
out = {{}}
rules = shd.default_rules(mesh, fsdp=True)
table_spec = ("model", "data")
tab = distribute_tensor(torch.from_numpy(inp["table"]), mesh,
                        shd.to_placements(table_spec, mesh)).requires_grad_(True)
tok = distribute_tensor(torch.from_numpy(inp["tokens"]), mesh,
                        shd.to_placements(("data", None), mesh))
with shd.use_rules(rules, mesh=mesh):
    emb = de.embed_lookup(tok, tab)
    (emb.to_local() ** 2).sum().backward()  # this rank's rows; 'model' replicas carry one copy
out["emb"] = emb.full_tensor().detach().numpy()
g = tab.grad
out["grad_local_shape"] = np.array(g.to_local().shape)
out["grad_layout_ok"] = np.array(tuple(g.placements) == tuple(tab.placements))
out["grad_local"] = g.to_local().numpy()
out["grad"] = g.full_tensor().numpy()
w = distribute_tensor(torch.from_numpy(inp["w_head"]), mesh,
                      shd.to_placements(("data", "model"), mesh))
x = distribute_tensor(torch.from_numpy(inp["x_head"]), mesh,
                      shd.to_placements(("data", None, None), mesh))
with shd.use_rules(rules, mesh=mesh):
    logits = de.lm_head(x, w)
out["logits_local_shape"] = np.array(logits.to_local().shape)
out["logits"] = logits.full_tensor().detach().numpy()
kv_rules = shd.default_rules(mesh)
for i, (layer, pos) in enumerate({writes}):
    buf = distribute_tensor(torch.zeros({kv_shape}), mesh,
                            shd.to_placements((None, "data", "model", None, None), mesh))
    before = buf.to_local().clone()
    with shd.use_rules(kv_rules, mesh=mesh):
        kvops.cache_write(buf, torch.from_numpy(inp["kv_val"]), layer, torch.tensor(pos))
    out[f"kv{{i}}"] = buf.full_tensor().numpy()
    out[f"kv{{i}}_changed"] = np.array(int((buf.to_local() != before).sum()))
ws = distribute_tensor(torch.from_numpy(inp["w_mm"]), mesh,
                       shd.to_placements(("model", None), mesh))
out["mm"] = C.overlap_allgather_matmul(mesh, "model")(torch.from_numpy(inp["x_mm"]), ws).numpy()
rep = distribute_tensor(torch.from_numpy(inp["x_mm"]), mesh, shd.to_placements((None, None), mesh))
moved = shd.constrain(rep, ("batch", None), rules)
out["constrain_local_shape"] = np.array(moved.to_local().shape)
out["constrain_full"] = moved.full_tensor().numpy()
plain = torch.ones(3)
out["constrain_plain_same"] = np.array(shd.constrain(plain, ("batch",), rules) is plain)
np.savez("{outdir}/rank{pid}.npz", **out)
runtime.shutdown()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The four-process job's inputs and each rank's results."""
    tmp = tmp_path_factory.mktemp("dist_ops")
    rng = np.random.default_rng(0)
    inp = {
        "table": rng.normal(size=(V, D)).astype(np.float32),
        "tokens": rng.integers(0, V, (B, S)).astype(np.int32),
        "w_head": rng.normal(size=(D, V)).astype(np.float32),
        "x_head": rng.normal(size=(B, S, D)).astype(np.float32),
        "kv_val": np.full((KV_SHAPE[1], 1) + KV_SHAPE[3:], 7.0, np.float32),
        "x_mm": rng.normal(size=(8, 16)).astype(np.float32),
        "w_mm": rng.normal(size=(16, 12)).astype(np.float32),
    }
    np.savez(tmp / "inp.npz", **inp)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_CHILD.format(
            port=port, pid=pid, inp=tmp / "inp.npz", outdir=tmp, writes=WRITES,
            kv_shape=KV_SHAPE))],
        env=_ENV, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(4)]
    failures = []
    try:
        for pid, p in enumerate(procs):
            out, err = p.communicate(timeout=CHILD_TIMEOUT_S)
            if p.returncode:
                failures.append(f"rank {pid} rc={p.returncode}\n{out}\n{err[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert not failures, "\n\n".join(failures)
    return inp, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]


def _jax_embed(inp):
    table, tokens = jnp.asarray(inp["table"]), jnp.asarray(inp["tokens"])
    out = jde.embed_lookup(tokens, table)  # no mesh context: JAX's plain path
    grad = jax.grad(lambda t: jnp.sum(jde.embed_lookup(tokens, t) ** 2))(table)
    return np.asarray(out), np.asarray(grad)


def test_embed_lookup_rows_equal_jax(job):
    inp, ranks = job
    want, _ = _jax_embed(inp)
    for r in ranks:
        np.testing.assert_array_equal(r["emb"], want)


def test_embed_gradient_arrives_sharded(job):
    """The point of the sharded lookup: each rank's gradient has the
    table's layout and holds only its (V/2, D/2) block, and the blocks make
    up JAX's gradient."""
    inp, ranks = job
    _, want = _jax_embed(inp)
    for pid, r in enumerate(ranks):
        assert bool(r["grad_layout_ok"])
        assert tuple(r["grad_local_shape"]) == (V // 2, D // 2)
        d, m = divmod(pid, 2)  # mesh (data, model): the table is (vocab→model, embed→data)
        block = want[m * V // 2:(m + 1) * V // 2, d * D // 2:(d + 1) * D // 2]
        np.testing.assert_allclose(r["grad_local"], block, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["grad"], want, rtol=1e-5, atol=1e-5)


def test_lm_head_equals_jax(job):
    inp, ranks = job
    want = np.asarray(jde.lm_head(jnp.asarray(inp["x_head"]), jnp.asarray(inp["w_head"])))
    for r in ranks:
        assert tuple(r["logits_local_shape"]) == (B // 2, S, V // 2)  # vocab-sharded
        np.testing.assert_allclose(r["logits"], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("i", range(len(WRITES)))
def test_cache_write_seq_sharded(job, i):
    """Each rank writes only the rows in its range: the write's B rows of
    one position land on the one model rank owning it, for each data rank."""
    inp, ranks = job
    layer, pos = WRITES[i]
    want = np.asarray(jkv.cache_write(jnp.zeros(KV_SHAPE), jnp.asarray(inp["kv_val"]),
                                      jnp.int32(layer), jnp.int32(pos)))
    owner = pos // (KV_SHAPE[2] // 2)
    per_rank = (KV_SHAPE[1] // 2) * KV_SHAPE[3] * KV_SHAPE[4]
    for pid, r in enumerate(ranks):
        np.testing.assert_array_equal(r[f"kv{i}"], want)
        assert int(r[f"kv{i}_changed"]) == (per_rank if pid % 2 == owner else 0)


def test_overlap_allgather_matmul_equals_jax(job):
    inp, ranks = job
    mesh = make_mesh((1, 1), ("data", "model"))
    with mesh:
        want = np.asarray(jcoll.overlap_allgather_matmul(mesh, "model")(
            jnp.asarray(inp["x_mm"]), jnp.asarray(inp["w_mm"])))
    for r in ranks:
        np.testing.assert_allclose(r["mm"], want, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(r["mm"], ranks[0]["mm"])


def test_constrain_redistributes_a_dtensor(job):
    inp, ranks = job
    for r in ranks:
        assert tuple(r["constrain_local_shape"]) == (inp["x_mm"].shape[0] // 2,
                                                     inp["x_mm"].shape[1])
        np.testing.assert_array_equal(r["constrain_full"], inp["x_mm"])
        assert bool(r["constrain_plain_same"])
