"""The port's gated one-to-all conv and the core modules around it, against
the JAX package on the same numpy-seeded inputs: ``gated_conv`` (on the
CPU, its plain version) against JAX ``ops.gated_conv`` in interpret mode,
int32 exactly equal, on the cases of ``tests/test_kernels.py``; the
bit-serial, bitmask and spike-conv modules exactly equal; and the encode
layer's u8 fold equal to the 8-plane bit-serial conv."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import bitmask as jbm  # noqa: E402
from repro.core import bitserial as jbs  # noqa: E402
from repro.core import spike_conv as jsc  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import bitmask as bm  # noqa: E402
from repro_torch.core import bitserial as bs  # noqa: E402
from repro_torch.core import plan as cplan  # noqa: E402
from repro_torch.core import spike_conv as sc  # noqa: E402
from repro_torch.kernels import fused_pipeline as fp  # noqa: E402
from repro_torch.kernels import gated_one_to_all as g2a  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def _weights(seed, kh, cin, k, density):
    rng = np.random.default_rng(seed)
    w = rng.integers(-127, 128, (kh, kh, cin, k)).astype(np.int8)
    return (w * (rng.random(w.shape) < density)).astype(np.int8)


GATED_CASES = {
    # kh, cin, kout, density, kblk, (n, h, w) — tests/test_kernels.py's cases
    "3x3-c8-k16": (3, 8, 16, 0.2, 8, (2, 18, 32)),
    "3x3-c16-k8": (3, 16, 8, 0.5, 8, (2, 18, 32)),
    "3x3-c3-k40": (3, 3, 40, 0.3, 8, (2, 18, 32)),
    "3x3-c32-k32": (3, 32, 32, 0.05, 8, (2, 18, 32)),
    "3x3-dense": (3, 8, 8, 1.0, 8, (2, 18, 32)),
    "1x1": (1, 16, 24, 0.7, 8, (1, 18, 32)),
    "multi-blocks": (3, 8, 16, 0.3, 16, (2, 36, 64)),
    "all-zero": (3, 8, 8, 0.0, 8, (1, 18, 32)),
    "k-blocks-3": (3, 8, 40, 0.25, 16, (1, 18, 32)),
}


@pytest.mark.parametrize("name", list(GATED_CASES))
def test_gated_conv_equals_jax_kernel(name):
    kh, cin, kout, density, kblk, (n, h, w) = GATED_CASES[name]
    wq = _weights(cin * 7 + kout, kh, cin, kout, density)
    x = np.random.default_rng(0).integers(0, 2, (n, h, w, cin)).astype(np.int8)
    want = np.asarray(jops.gated_conv(jnp.asarray(x), jops.pack_conv_weights(wq, kblk=kblk)))
    pw = ops.pack_conv_weights(wq, kblk=kblk)
    got = ops.gated_conv(torch.from_numpy(x.astype(np.uint8)), pw, bh=18, bw=32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    oracle = g2a.gated_conv_ref(torch.from_numpy(x), torch.from_numpy(wq), bh=18, bw=32)
    assert torch.equal(got.float(), oracle)


def test_gated_wrapper_checks_its_operands():
    pw = ops.pack_conv_weights(_weights(1, 3, 8, 8, 0.5), kblk=8)
    dev = ops.packed_tensors(pw, "cpu")
    x = torch.zeros((1, 18, 32, 8), dtype=torch.uint8)
    kw = dict(kout=8, kh=3, kw=3, bh=18, bw=32)
    with pytest.raises(ValueError, match="uint8"):
        g2a.gated_one_to_all(x.float(), *dev, **kw)
    with pytest.raises(ValueError, match="divisible"):
        g2a.gated_one_to_all(x[:, :17], *dev, **kw)
    with pytest.raises(ValueError, match="tap_any"):
        g2a.gated_one_to_all(x, dev.maskp, dev.vals, dev.tap_any.long(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        g2a.gated_one_to_all(x.transpose(1, 2).contiguous().transpose(1, 2), *dev, **kw)


def test_decode_dense_equals_unpack():
    wq = _weights(3, 3, 16, 40, 0.3)
    pw = ops.pack_conv_weights(wq, kblk=16)
    dense = fp.decode_dense(torch.from_numpy(pw.maskp), torch.from_numpy(pw.vals))
    want = ops.unpack_conv_weights(pw).reshape(9, pw.cin, pw.kout)
    np.testing.assert_array_equal(dense[:, :, : pw.kout].numpy(), want)


def test_u8_fold_equals_bitserial_planes():
    """The kernel executor's encode hands the kernel u8 pixel values: the
    exact fold of the JAX executor's 8 bit-serial planes, in one launch."""
    rng = np.random.default_rng(5)
    wq = _weights(5, 3, 3, 16, 0.7)
    pw = ops.pack_conv_weights(wq, kblk=16)
    x = torch.from_numpy(rng.integers(0, 256, (2, 12, 16, 3)).astype(np.uint8))
    folded = ops.gated_conv(x, pw, bh=6, bw=8)
    planes = bs.bitserial_conv(
        x, pw, lambda plane, p: ops.gated_conv(plane.to(torch.uint8), p, bh=6, bw=8).double())
    assert torch.equal(folded.double(), planes)


def test_gated_executor_is_live_tap_im2col():
    """The plain ``gated`` executor's live-tap im2col equals the dense
    block conv on a layer with dead taps, u8 and spike inputs alike."""
    rng = np.random.default_rng(6)
    wq = _weights(6, 3, 8, 16, 0.5)
    wq[0, :] = 0  # three dead taps
    taps = tuple(int(t) for t in np.flatnonzero(np.abs(wq).reshape(9, -1).sum(1)))
    w = torch.from_numpy(wq)
    for hi in (2, 256):
        x = torch.from_numpy(rng.integers(0, hi, (2, 12, 16, 8)).astype(np.float32))
        got = cplan._blocked_gated(x, w, 6, 8, taps)
        assert torch.equal(got, g2a.gated_conv_ref(x, w, bh=6, bw=8))


def test_bitserial_equals_jax():
    rng = np.random.default_rng(7)
    x = rng.integers(0, 256, (2, 6, 8, 3)).astype(np.uint8)
    planes = bs.to_bitplanes(torch.from_numpy(x))
    np.testing.assert_array_equal(planes.numpy(), np.asarray(jbs.to_bitplanes(jnp.asarray(x))))
    np.testing.assert_array_equal(bs.from_bitplanes(planes).numpy(), x.astype(np.float32))
    w = rng.integers(-127, 128, (3, 3, 3, 4)).astype(np.float32)
    got = bs.bitserial_conv(torch.from_numpy(x), torch.from_numpy(w), sc.conv_reference)
    want = jbs.bitserial_conv(jnp.asarray(x), jnp.asarray(w), jsc.conv_reference)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pad_to", [None, 400])
def test_bitmask_equals_jax(pad_to):
    w = _weights(8, 3, 16, 8, 0.3)
    got, want = bm.encode(w, pad_to=pad_to), jbm.encode(w, pad_to=pad_to)
    assert got.nnz == want.nnz > 255  # past a uint8 cumsum's wrap
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(bm.decode(got).numpy(), np.asarray(jbm.decode(want)))
    np.testing.assert_array_equal(bm.decode(got).numpy(), w)
    empty = bm.encode(np.zeros((3, 3, 2, 2), np.int8))
    assert torch.count_nonzero(bm.decode(empty, torch.float32)) == 0


def test_csr_and_format_bits_equal_jax():
    w = _weights(9, 3, 8, 16, 0.25).transpose(3, 0, 1, 2)  # rows = output channels
    got, want = bm.encode_csr(w), jbm.encode_csr(w)
    for f in ("indptr", "indices", "values"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    np.testing.assert_array_equal(bm.decode_csr(got).numpy(), w)
    nnz = int(np.count_nonzero(w))
    for fmt in ("dense", "bitmask", "csr"):
        assert bm.format_bits(w.shape, nnz, fmt=fmt) == jbm.format_bits(w.shape, nnz, fmt=fmt)
    with pytest.raises(ValueError):
        bm.format_bits(w.shape, nnz, fmt="coo")


@pytest.mark.parametrize("kh", [1, 3])
def test_spike_conv_equals_jax(kh):
    rng = np.random.default_rng(10 + kh)
    s = rng.integers(0, 2, (2, 6, 8, 8)).astype(np.float32)
    w = _weights(kh, kh, 8, 12, 0.3)
    ts, tw = torch.from_numpy(s), torch.from_numpy(w)
    js, jw = jnp.asarray(s), jnp.asarray(w)
    for got, want in (
        (sc.conv_reference(ts, tw), jsc.conv_reference(js, jw)),
        (sc.gated_one_to_all(ts, tw), jsc.gated_one_to_all(js, jw)),
        (sc.gated_one_to_all_compressed(ts, bm.encode(w)),
         jsc.gated_one_to_all_compressed(js, jbm.encode(w))),
    ):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert sc.accumulate_count(tw, 48) == jsc.accumulate_count(jw, 48)
    assert sc.dense_count(tw, 48) == jsc.dense_count(jw, 48)


def test_build_key_covers_headers(tmp_path, monkeypatch):
    """An edited ``csrc/*.cuh`` header rebuilds every library: it is part of
    each library's build key, as the source is."""
    from repro_torch import backend

    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(backend, "CSRC", str(tmp_path))
    src = str(tmp_path / "k.cu")
    before = backend._target("k", src)
    assert backend._target("k", src) == before
    (tmp_path / "common.cuh").write_text("// v2\n")
    assert backend._target("k", src) != before
