"""The port's host side of the kernels against the JAX package: packed
weights byte for byte, the decode into the kernel's live-tap layout, the
affine bundle, and the block-clamped windows against the JAX package's
replicate-padded block layout."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import fused_pipeline as fp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def _weights(seed, kh, cin, kout, density, dead_taps=()):
    rng = np.random.default_rng(seed)
    w = rng.integers(-127, 128, (kh, kh, cin, kout)).astype(np.int8)
    w[rng.random(w.shape) > density] = 0
    for t in dead_taps:
        w[t // kh, t % kh] = 0
    return w


PACK_CASES = [
    # kh, cin, kout, kblk, density, dead taps
    (3, 8, 16, 8, 0.3, ()),
    (3, 3, 16, 128, 0.7, ()),  # encode: cin padded 3 → 8
    (3, 16, 40, 16, 0.2, (0, 4, 8)),  # ragged K-blocks, dead taps
    (1, 12, 4, 8, 1.0, ()),  # pointwise, kout < kblk
    (3, 8, 8, 8, 0.0, ()),  # fully pruned
]


@pytest.mark.parametrize("kh,cin,kout,kblk,density,dead", PACK_CASES)
def test_pack_byte_equal(kh, cin, kout, kblk, density, dead):
    w = _weights(0, kh, cin, kout, density, dead)
    got, want = ops.pack_conv_weights(w, kblk=kblk), jops.pack_conv_weights(w, kblk=kblk)
    for field in ("maskp", "vals", "tap_any"):
        a, b = getattr(got, field), np.asarray(getattr(want, field))
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), field
    assert got.tap_alive == tuple(want.tap_alive)
    assert (got.kh, got.kw, got.cin, got.kout, got.kblk) == (
        want.kh, want.kw, want.cin, want.kout, want.kblk)
    assert got.compressed_bytes == want.compressed_bytes


@pytest.mark.parametrize("kh,cin,kout,kblk,density,dead", PACK_CASES)
def test_unpack_roundtrip(kh, cin, kout, kblk, density, dead):
    w = _weights(1, kh, cin, kout, density, dead)
    got = ops.unpack_conv_weights(ops.pack_conv_weights(w, kblk=kblk))
    want = jops.unpack_conv_weights(jops.pack_conv_weights(w, kblk=kblk))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, :, :cin], w)


def test_vpad_overflow_raises():
    w = _weights(2, 3, 8, 8, 0.5)
    with pytest.raises(ValueError, match="vpad"):
        ops.pack_conv_weights(w, kblk=8, vpad=1)
    pw = ops.pack_conv_weights(w, kblk=8)
    bad = pw._replace(vals=pw.vals[:, :1])
    with pytest.raises(ValueError, match="VPAD"):
        ops.validate_packed(bad)
    ops.validate_packed(pw)


@pytest.mark.parametrize("kh,cin,kout,kblk,density,dead", PACK_CASES)
def test_predecode_layout(kh, cin, kout, kblk, density, dead):
    """The kernel operand holds exactly the live taps' dense weights, each
    channel quad innermost, zero-padded to whole K-blocks."""
    w = _weights(3, kh, cin, kout, density, dead)
    pw = ops.pack_conv_weights(w, kblk=kblk)
    live = ops.predecode(pw, "cpu")
    assert live.taps == pw.tap_alive
    n_live = len(live.taps)
    assert tuple(live.w.shape) == (n_live, pw.cin // 4, pw.kp, 4)
    flat = live.w.permute(0, 1, 3, 2).reshape(n_live, pw.cin, pw.kp).numpy()
    dense = jops.unpack_conv_weights(jops.pack_conv_weights(w, kblk=kblk))
    dense = dense.reshape(kh * kh, pw.cin, kout)
    np.testing.assert_array_equal(flat[:, :, :kout], dense[list(live.taps)])
    assert not flat[:, :, kout:].any()


@pytest.mark.parametrize("kh,cin,kout,kblk,density,dead", PACK_CASES)
def test_plain_packed_decode_equals_predecode(kh, cin, kout, kblk, density, dead):
    """The plain version of the kernel's in-kernel decode (bits → rank →
    gather) gives exactly the host-side predecoded operand."""
    pw = ops.pack_conv_weights(_weights(7, kh, cin, kout, density, dead), kblk=kblk)
    got = fp.decode_packed(torch.from_numpy(pw.maskp), torch.from_numpy(pw.vals), pw.tap_alive)
    assert torch.equal(got, ops.predecode(pw, "cpu").w)


@pytest.mark.parametrize("kout,kblk", [(16, 8), (4, 8), (40, 16)])
def test_affine_bundle_layout(kout, kblk):
    """(5, Kp) rows = the JAX (KB, 5, KBLK) bundle with K-blocks flattened.
    Every row but rsqrt(var+eps) is bit-equal; that one is within 2 ulp
    (torch.rsqrt and XLA's are approximations that round differently —
    why parity tests carry the JAX-built bundle across)."""
    rng = np.random.default_rng(4)
    pw = ops.pack_conv_weights(_weights(5, 3, 8, kout, 0.5), kblk=kblk)
    jpw = jops.pack_conv_weights(_weights(5, 3, 8, kout, 0.5), kblk=kblk)
    scale = np.float32(0.0123)
    mean, gamma, beta = (rng.standard_normal(kout).astype(np.float32) for _ in range(3))
    var = (rng.random(kout) + 0.1).astype(np.float32)
    got = ops.affine_bundle(
        pw, torch.tensor(scale), *(torch.from_numpy(a) for a in (mean, var, gamma, beta))
    ).numpy()
    want = np.asarray(jops.affine_bundle(
        jpw, jnp.float32(scale), *(jnp.asarray(a) for a in (mean, var, gamma, beta))
    ))
    want = want.transpose(1, 0, 2).reshape(fp.AFFINE_ROWS, -1)
    assert got.shape == want.shape == (5, pw.kp)
    np.testing.assert_array_equal(got[[0, 1, 3, 4]], want[[0, 1, 3, 4]])
    np.testing.assert_array_max_ulp(got[2], want[2], maxulp=2)


@pytest.mark.parametrize("kh,taps", [(3, tuple(range(9))), (3, (1, 3, 5, 7)), (1, (0,))])
def test_block_windows_match_jax_block_layout(kh, taps):
    """Clamping each neighbour into its block == the JAX package's
    replicate-padded independent blocks (``_block_layout``)."""
    rng = np.random.default_rng(6)
    n, h, w, c, bh, bw = 2, 12, 16, 8, 6, 8
    x = rng.integers(0, 2, (n, h, w, c)).astype(np.int8)
    pad = (kh - 1) // 2
    blocks = np.asarray(jops._block_layout(jnp.asarray(x), bh=bh, bw=bw, pad=pad, cin_p=c))
    got = fp.block_windows(torch.from_numpy(x), taps, kh=kh, kw=kh, bh=bh, bw=bw).numpy()
    for li, tap in enumerate(taps):
        dy, dx = tap // kh, tap % kh
        win = blocks[:, dy:dy + bh, dx:dx + bw]  # (N*nbh*nbw, bh, bw, C)
        win = win.reshape(n, h // bh, w // bw, bh, bw, c).transpose(0, 1, 3, 2, 4, 5)
        np.testing.assert_array_equal(got[..., li, :], win.reshape(n, h, w, c))
