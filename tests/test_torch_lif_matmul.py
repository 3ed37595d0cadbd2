"""The port's fused LIF and bitmask matmul against the JAX package on the
same numpy-seeded inputs: ``pack_matmul_weights`` byte-equal to JAX
``pack_weights``; ``bitmask_matmul`` (on the CPU, its plain version) within
1e-5·(|x|@|W|) + 1e-6 of JAX ``ops.bitmask_matmul`` (interpret mode) and of
a float64 product — tighter than ``tests/test_kernels.py``'s rtol 1e-4,
atol 1e-3, and enough for two f32 sums taken in different orders;
``fused_lif`` spikes exactly equal to JAX ``ops.fused_lif``. At the leaks
used (0.25, 0.5) ``v·leak`` is exact, so XLA's FMA contraction cannot move
a bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.kernels import bitmask_matmul as bmm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import spike_lif as sl  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6  # of |x| @ |W|, elementwise

MATMUL_CASES = {
    # m, k, n, density, kblk, nblk — the first three are tests/test_kernels.py's
    "32x64x48": (32, 64, 48, 0.2, 64, 32),
    "100x128x64": (100, 128, 64, 0.5, 64, 32),
    "16x512x256": (16, 512, 256, 0.1, 64, 32),
    "ragged-k-n": (37, 100, 70, 0.3, 16, 24),
    "blocks-3x2": (20, 1030, 300, 0.2, 512, 256),
    "one-block-zero": (9, 128, 64, 0.4, 64, 32),
    "all-zero": (5, 64, 40, 0.0, 32, 16),
}
WEIGHT_DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
                 "int8": (jnp.int8, torch.int8)}


def _weights(name: str, dtype: str):
    """W as (numpy for JAX, tensor for the port) holding the same values."""
    _, k, n, density, kblk, nblk = MATMUL_CASES[name]
    rng = np.random.default_rng(k * 7 + n)
    w = rng.standard_normal((k, n)) * (50 if dtype == "int8" else 1)
    w[rng.random((k, n)) >= density] = 0.0
    if name == "one-block-zero":
        w[:kblk, nblk:2 * nblk] = 0.0
    jnp_t, torch_t = WEIGHT_DTYPES[dtype]
    if dtype == "int8":
        w = np.clip(np.round(w), -127, 127).astype(np.int8)
        return w, torch.from_numpy(w)
    wt = torch.from_numpy(w.astype(np.float32)).to(torch_t)
    return np.asarray(jnp.asarray(w.astype(np.float32), jnp_t)), wt


@pytest.mark.parametrize("dtype", list(WEIGHT_DTYPES))
@pytest.mark.parametrize("name", list(MATMUL_CASES))
def test_pack_matmul_weights_byte_equal_to_jax(name, dtype):
    _, _, _, _, kblk, nblk = MATMUL_CASES[name]
    w_np, w_t = _weights(name, dtype)
    want = jops.pack_matmul_weights(w_np, kblk=kblk, nblk=nblk)
    got = ops.pack_matmul_weights(w_t, kblk=kblk, nblk=nblk)
    assert (got.shape, got.kblk, got.nblk) == (want.shape, want.kblk, want.nblk)
    np.testing.assert_array_equal(got.maskp.numpy(), np.asarray(want.maskp))
    wv = np.asarray(want.vals)
    assert got.vals.dtype == w_t.dtype and tuple(got.vals.shape) == wv.shape
    assert got.vals.view(torch.uint8).numpy().tobytes() == wv.tobytes()
    assert got.compressed_bytes == want.compressed_bytes
    if name == "all-zero":
        assert wv.shape[-1] == 1  # VPAD is at least 1
    # carried across from the JAX arrays, the same bytes again
    carried = interop.packed_matmul_from_numpy(np.asarray(want.maskp), wv, want.shape, kblk,
                                               nblk, device="cpu")
    assert torch.equal(carried.maskp, got.maskp)
    assert torch.equal(carried.vals.view(torch.uint8), got.vals.view(torch.uint8))


def _within(got, want, x, w) -> None:
    scale = np.abs(x.astype(np.float64)) @ np.abs(w.astype(np.float64))
    bad = np.abs(got.astype(np.float64) - want.astype(np.float64)) > RTOL * scale + ATOL
    assert not bad.any(), f"{int(bad.sum())} outside tolerance, max |Δ| " \
        f"{float(np.abs(got.astype(np.float64) - want).max())}"


@pytest.mark.parametrize("x_dtype,w_dtype", [("f32", "f32"), ("bf16", "bf16"),
                                             ("f32", "int8")])
@pytest.mark.parametrize("name", list(MATMUL_CASES))
def test_bitmask_matmul_matches_jax_and_float64(name, x_dtype, w_dtype):
    m, k, n, _, kblk, nblk = MATMUL_CASES[name]
    w_np, w_t = _weights(name, w_dtype)
    x = np.random.default_rng(m).standard_normal((m, k)).astype(np.float32)
    x_t = torch.from_numpy(x)
    if x_dtype == "bf16":
        x_t = x_t.bfloat16()
    x_vals = x_t.float().numpy()  # the values both sides multiply
    w_vals = w_t.float().numpy()
    jx = jnp.asarray(x, jnp.bfloat16 if x_dtype == "bf16" else jnp.float32)
    want = np.asarray(jops.bitmask_matmul(
        jx, jops.pack_matmul_weights(w_np, kblk=kblk, nblk=nblk), mblk=32))
    got = ops.bitmask_matmul(x_t, ops.pack_matmul_weights(w_t, kblk=kblk, nblk=nblk))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    f64 = x_vals.astype(np.float64) @ w_vals.astype(np.float64)
    _within(got.numpy(), want, x_vals, w_vals)
    _within(got.numpy(), f64, x_vals, w_vals)
    _within(want, f64, x_vals, w_vals)
    _within(ref.bitmask_matmul_ref(x_t, w_t).numpy(), f64, x_vals, w_vals)


def test_bitmask_matmul_decode_is_the_dense_weights():
    _, k, n, _, kblk, nblk = MATMUL_CASES["ragged-k-n"]
    _, w_t = _weights("ragged-k-n", "f32")
    pw = ops.pack_matmul_weights(w_t, kblk=kblk, nblk=nblk)
    dense = bmm.decode_dense(pw.maskp, pw.vals)
    assert tuple(dense.shape) == (-(-k // kblk) * kblk, -(-n // nblk) * nblk)
    assert torch.equal(dense[:k, :n], w_t)
    assert not dense[k:].any() and not dense[:, n:].any()


def test_bitmask_matmul_checks_its_operands():
    w = torch.zeros((64, 32))
    w[::3, ::2] = 1.0
    pw = ops.pack_matmul_weights(w, kblk=32, nblk=16)
    x = torch.ones((4, 64))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.bitmask_matmul(x.double(), pw)
    with pytest.raises(ValueError, match="K=63"):
        ops.bitmask_matmul(x[:, :63], pw)
    with pytest.raises(ValueError, match="contiguous"):
        ops.bitmask_matmul(torch.ones((64, 4)).t(), pw)
    with pytest.raises(ValueError, match="not packed weights"):
        ops.bitmask_matmul(x, pw._replace(vals=pw.vals.double()))
    with pytest.raises(ValueError, match="is on meta"):
        ops.bitmask_matmul(x, pw.to("meta"))
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        ops.bitmask_matmul(x.to("meta"), pw.to("meta"))
    with pytest.raises(ValueError, match="multiple of 8"):
        ops.pack_matmul_weights(w, kblk=12)


LIF_SHAPES = [(3, 100, 16), (1, 7, 8), (4, 600, 32), (8, 300, 5)]  # test_kernels.py's + T=8


@pytest.mark.parametrize("threshold,leak", [(0.5, 0.25), (0.3, 0.5)])
@pytest.mark.parametrize("t,m,c", LIF_SHAPES)
def test_fused_lif_spikes_equal_jax(t, m, c, threshold, leak):
    x = np.random.default_rng(t * m + c).standard_normal((t, m, c)).astype(np.float32)
    want = np.asarray(jops.fused_lif(jnp.asarray(x), threshold=threshold, leak=leak))
    got = ops.fused_lif(torch.from_numpy(x), threshold=threshold, leak=leak)
    assert got.dtype == torch.int8 and tuple(got.shape) == (t, m, c)
    np.testing.assert_array_equal(got.numpy(), want)
    oracle = ref.fused_lif_ref(torch.from_numpy(x), threshold=threshold, leak=leak)
    assert torch.equal(got, oracle)
    assert 0 < float(got.float().mean()) < 1


def test_fused_lif_bf16_input_equals_jax():
    x = np.random.default_rng(5).standard_normal((5, 300, 12)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jops.fused_lif(jx, threshold=0.5, leak=0.25))
    got = ops.fused_lif(torch.from_numpy(x).bfloat16(), threshold=0.5, leak=0.25)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fused_lif_special_values_equal_jax():
    """inf resets to inf·0 = NaN and NaN never spikes again: the reset is
    the product v·(1 − s), not a select, on both sides."""
    x = np.random.default_rng(9).standard_normal((6, 16, 8)).astype(np.float32)
    x[0, 0, :4] = [np.inf, -np.inf, np.nan, -0.0]
    x[2, 1, :2] = [np.inf, np.nan]
    want = np.asarray(jops.fused_lif(jnp.asarray(x)))
    got = ops.fused_lif(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[1:, 0, 0].sum() == 0  # the inf element's membrane went NaN


def test_fused_lif_checks_its_input():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.fused_lif(torch.zeros((2, 3, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match=r"\(T, M, C\)"):
        ops.fused_lif(torch.zeros((2, 3)))
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_lif(torch.zeros((4, 3, 2)).transpose(0, 2))
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        sl.fused_lif(torch.zeros((2, 3, 4), device="meta"))
