"""The fused layer pipeline's plain PyTorch version against the JAX
package's Pallas kernel (interpret mode), on the same numpy inputs and the
same JAX-built affine bundle: spikes equal, membranes within 4 ulp of
max(|v|, 1) (XLA's CPU backend contracts mul+add into FMAs inside the fused
graph — see the ``_rounded`` docstring in repro/kernels/fused_pipeline.py —
where the plain version rounds every product; a membrane that cancels to
near zero keeps the error of its O(1) operands, hence the floor at 1).
tests/test_torch_gpu.py holds the CUDA kernel against the plain version
on the card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.interop import affine_rows  # noqa: E402
from repro_torch.kernels import fused_pipeline as fp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

THR, LEAK = 0.5, 0.25


def assert_ulp_close(got, want, maxulp=4):
    scale = np.maximum(np.maximum(np.abs(got), np.abs(want)), np.float32(1.0))
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert (err <= maxulp * np.spacing(scale.astype(np.float32))).all(), err.max()


CASES = {
    # kh, cin, kout, t_in, t_out, in_bits, reset, warm, dead taps
    "3x3-T3-hard": (3, 8, 16, 3, 3, 1, "hard", False, ()),
    "3x3-T3-soft-warm": (3, 8, 16, 3, 3, 1, "soft", True, ()),
    "mixed-1to3-hard": (3, 8, 8, 1, 3, 1, "hard", False, ()),
    "mixed-1to3-soft-warm": (3, 8, 8, 1, 3, 1, "soft", True, ()),
    "T1": (3, 16, 8, 1, 1, 1, "hard", True, ()),
    "1x1-T3": (1, 16, 8, 3, 3, 1, "hard", True, ()),
    "1x1-kout4": (1, 12, 4, 3, 3, 1, "soft", False, ()),
    "dead-taps": (3, 8, 16, 3, 3, 1, "hard", True, (0, 2, 4, 6)),
    "all-taps-dead": (3, 8, 8, 3, 3, 1, "hard", True, tuple(range(9))),
    "encode-u8": (3, 3, 16, 1, 1, 8, "hard", False, ()),
    "encode-u8-rate": (3, 3, 8, 1, 3, 8, "soft", True, ()),
}


def _case(kh, cin, kout, t_in, t_out, in_bits, reset, warm, dead, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.integers(-127, 128, (kh, kh, cin, kout)).astype(np.int8)
    w[rng.random(w.shape) > 0.3] = 0
    for t in dead:
        w[t // kh, t % kh] = 0
    hi = 256 if in_bits == 8 else 2
    x = rng.integers(0, hi, (t_in, 2, 12, 16, cin)).astype(np.uint8)
    scale = np.float32(1.0 / 128) / (np.float32(255.0) if in_bits == 8 else np.float32(1.0))
    mean = rng.normal(size=kout).astype(np.float32)
    var = (rng.random(kout) + 0.5).astype(np.float32)
    gamma = rng.normal(size=kout).astype(np.float32)
    beta = rng.normal(size=kout).astype(np.float32)
    v0 = rng.normal(size=(2, 12, 16, kout)).astype(np.float32) if warm else None
    return w, x, (scale, mean, var, gamma, beta), v0


def _jax(w, x, aff, v0, *, t_out, in_bits, reset, predecode=True):
    pw = jops.pack_conv_weights(w, kblk=8)
    bundle = jops.affine_bundle(pw, *(jnp.asarray(a) for a in aff))
    spk, mem = jops.fused_conv_bn_lif(
        jnp.asarray(x, jnp.float32 if in_bits == 8 else jnp.int8), pw, bundle,
        v0=None if v0 is None else jnp.asarray(v0), out_t=t_out, in_bits=in_bits,
        bn_scale=THR, threshold=THR, leak=LEAK, reset=reset, bh=6, bw=8, nbt=2,
        predecode=predecode,
    )
    return np.asarray(spk), np.asarray(mem), affine_rows(np.asarray(bundle), w.shape[-1])


def _port(w, x, rows, v0, *, t_out, reset, predecode=True):
    pw = ops.pack_conv_weights(w, kblk=8)
    affine = ops.pad_affine(torch.tensor(rows), pw.kp)
    return ops.fused_conv_bn_lif(
        torch.from_numpy(x), pw, affine,
        v0=None if v0 is None else torch.from_numpy(v0),
        out_t=t_out, bn_scale=THR, threshold=THR, leak=LEAK, reset=reset, bh=6, bw=8,
        predecode_weights=predecode,
    )


@pytest.mark.parametrize("mode", ["predecoded", "packed"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_matches_jax_kernel(name, mode):
    """Both weight modes: predecoded, and bitmask-packed weights decoded by
    the kernel (JAX ``predecode=False``; here the plain decode)."""
    kh, cin, kout, t_in, t_out, in_bits, reset, warm, dead = CASES[name]
    w, x, aff, v0 = _case(kh, cin, kout, t_in, t_out, in_bits, reset, warm, dead)
    pre = mode == "predecoded"
    jspk, jmem, rows = _jax(w, x, aff, v0, t_out=t_out, in_bits=in_bits, reset=reset,
                            predecode=pre)
    spk, mem = _port(w, x, rows, v0, t_out=t_out, reset=reset, predecode=pre)
    assert spk.dtype == torch.uint8 and tuple(spk.shape) == jspk.shape
    np.testing.assert_array_equal(spk.numpy(), jspk.astype(np.uint8))
    assert_ulp_close(mem.numpy(), jmem)
    assert 0 < spk.float().mean() < 1 or name == "all-taps-dead"


def test_one_drive_reused_for_mixed_time():
    """t_in=1 → t_out=3 equals feeding the same input three times."""
    kh, cin, kout, _, t_out, in_bits, reset, warm, dead = CASES["mixed-1to3-hard"]
    w, x, aff, v0 = _case(kh, cin, kout, 1, t_out, in_bits, reset, warm, dead)
    *_, rows = _jax(w, x, aff, v0, t_out=t_out, in_bits=in_bits, reset=reset)
    once = _port(w, x, rows, v0, t_out=3, reset=reset)
    thrice = _port(w, np.repeat(x, 3, axis=0), rows, v0, t_out=3, reset=reset)
    assert torch.equal(once[0], thrice[0]) and torch.equal(once[1], thrice[1])


def test_wrapper_rejects_bad_operands():
    w, x, aff, v0 = _case(3, 8, 8, 3, 3, 1, "hard", False, ())
    pw = ops.pack_conv_weights(w, kblk=8)
    live = ops.predecode(pw, "cpu")
    affine = torch.zeros(5, pw.kp)
    kw = dict(kout=8, kh=3, kw=3, bh=6, bw=8, t_out=3, bn_scale=THR, threshold=THR, leak=LEAK)
    xt = torch.from_numpy(x)
    fp.fused_pipeline(xt, live.w, live.taps, affine, None, **kw)
    with pytest.raises(ValueError, match="uint8"):
        fp.fused_pipeline(xt.float(), live.w, live.taps, affine, None, **kw)
    with pytest.raises(ValueError, match="t_in"):
        fp.fused_pipeline(xt, live.w, live.taps, affine, None, **{**kw, "t_out": 2})
    with pytest.raises(ValueError, match="block"):
        fp.fused_pipeline(xt, live.w, live.taps, affine, None, **{**kw, "bh": 5})
    with pytest.raises(ValueError, match="affine"):
        fp.fused_pipeline(xt, live.w, live.taps, affine[:4], None, **kw)
    with pytest.raises(ValueError, match="reset"):
        fp.fused_pipeline(xt, live.w, live.taps, affine, None, **{**kw, "reset": "none"})
    maskp, vals = torch.from_numpy(pw.maskp), torch.from_numpy(pw.vals)
    fp.fused_pipeline_packed(xt, maskp, vals, pw.tap_alive, affine, None, **kw)
    with pytest.raises(ValueError, match="packed"):
        fp.fused_pipeline_packed(xt, maskp, vals.to(torch.uint8), pw.tap_alive, affine,
                                 None, **kw)
    with pytest.raises(ValueError, match="does not fit"):
        fp.fused_pipeline_packed(xt[..., :4].contiguous(), maskp, vals, pw.tap_alive,
                                 affine, None, **kw)
