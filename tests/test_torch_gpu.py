"""The port's CUDA kernels against their plain PyTorch versions on the card:
bit for bit, the fused pipeline in both weight modes (T up to 16, each of
its tensor-core tilings, weights resident or streamed), the gated
one-to-all conv and the fused LIF; the bitmask matmul within
1e-5·(|x|@|W|) + 1e-6 of its plain version and of a float64 product (f32
sums in another order), its split-K path the same from run to run. Needs a CUDA device and nothing of JAX; skips
without a card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import bitmask_matmul as bmm  # noqa: E402
from repro_torch.kernels import fused_pipeline as fp  # noqa: E402
from repro_torch.kernels import gated_one_to_all as g2a  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import spike_lif as sl  # noqa: E402

THR, LEAK = 0.5, 0.25

CASES = {
    # kh, cin, kout, t_in, t_out, u8 input, reset, warm, dead taps, (h, w), block
    "3x3-T3-hard": (3, 8, 16, 3, 3, False, "hard", False, (), (12, 16), (6, 8)),
    "3x3-T3-soft-warm": (3, 8, 16, 3, 3, False, "soft", True, (), (12, 16), (6, 8)),
    "mixed-1to3": (3, 16, 32, 1, 3, False, "hard", True, (), (36, 64), (18, 32)),
    "1x1-kout4": (1, 12, 4, 3, 3, False, "soft", False, (), (12, 16), (6, 8)),
    "1x1-kout6-tail": (1, 8, 6, 3, 3, False, "hard", True, (), (12, 16), (6, 8)),
    "dead-taps": (3, 8, 16, 3, 3, False, "hard", True, (0, 2, 4, 6), (12, 16), (6, 8)),
    "all-taps-dead": (3, 8, 8, 3, 3, False, "hard", True, tuple(range(9)), (12, 16), (6, 8)),
    "encode-u8": (3, 3, 16, 1, 1, True, "hard", False, (), (36, 64), (18, 32)),
    "wide-k512": (3, 64, 512, 3, 3, False, "soft", True, (), (18, 32), (18, 32)),
    # T > 4: the streamed time loop (t_in == t_out) and one drive for all steps
    "T5-equal": (3, 8, 16, 5, 5, False, "soft", True, (), (12, 16), (6, 8)),
    "T8-equal": (3, 16, 32, 8, 8, False, "hard", False, (), (36, 64), (18, 32)),
    "T16-equal": (3, 8, 12, 16, 16, False, "soft", True, (), (12, 16), (6, 8)),
    "T5-mixed": (3, 8, 16, 1, 5, False, "hard", True, (), (12, 16), (6, 8)),
    "T8-mixed-u8": (3, 3, 16, 1, 8, True, "soft", False, (), (36, 64), (18, 32)),
    "T16-mixed": (3, 16, 32, 1, 16, False, "soft", True, (), (36, 64), (18, 32)),
    # the tensor-core tilings: C = 16 (two taps per 32-byte k-step), a wide
    # 1x1, Kout not a multiple of the channel tile, the one-block 18x32 map
    # at Kout 256 (32 x 64 tiles) at T = 3 and T = 16
    "c16-two-taps-per-kstep": (3, 16, 24, 3, 3, False, "hard", True, (), (36, 64), (18, 32)),
    "1x1-c384-k256": (1, 384, 256, 3, 3, False, "soft", True, (), (18, 32), (18, 32)),
    "kout40-tail": (3, 16, 40, 3, 3, False, "hard", True, (), (12, 16), (6, 8)),
    "3x3-kout6-tail": (3, 8, 6, 1, 3, False, "soft", True, (), (12, 16), (6, 8)),
    "18x32-k256-T3": (3, 256, 256, 3, 3, False, "soft", True, (), (18, 32), (18, 32)),
    "18x32-k256-T16": (3, 256, 256, 16, 16, False, "hard", False, (), (18, 32), (18, 32)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _fused_operands(case, dev, density=0.3):
    """(args, kw, pw) for one fused case: seeded weights, inputs, affine."""
    kh, cin, kout, t_in, t_out, u8, reset, warm, dead, (h, w), (bh, bw) = case
    rng = np.random.default_rng(0)
    wq = rng.integers(-127, 128, (kh, kh, cin, kout)).astype(np.int8)
    wq[rng.random(wq.shape) > density] = 0
    for t in dead:
        wq[t // kh, t % kh] = 0
    pw = ops.pack_conv_weights(wq, kblk=128)
    live = ops.predecode(pw, dev)
    x = rng.integers(0, 256 if u8 else 2, (t_in, 2, h, w, pw.cin)).astype(np.uint8)
    x[..., cin:] = 0
    rows = np.stack([
        np.full(kout, 1.0 / (kh * kh * cin * (127 if u8 else 1)), np.float32),
        rng.normal(size=kout), rng.random(kout) + 0.5, rng.normal(size=kout),
        rng.normal(size=kout),
    ]).astype(np.float32)
    affine = ops.pad_affine(torch.tensor(rows, device=dev), pw.kp)
    v0 = torch.tensor(rng.normal(size=(2, h, w, kout)), dtype=torch.float32,
                      device=dev) if warm else None
    args = (torch.from_numpy(x).to(dev), live.w, live.taps, affine, v0)
    kw = dict(kout=kout, kh=kh, kw=kh, bh=bh, bw=bw, t_out=t_out, bn_scale=THR,
              threshold=THR, leak=LEAK, reset=reset, v_init=0.25)
    return args, kw, pw


@pytest.mark.gpu
def test_fused_pipeline_streams_weights_past_the_resident_budget(cuda):
    """A 7x7 layer at C = 256: its 64-channel weight slice (49*256*64 B =
    784 KB) exceeds shared memory, so the predecoded kernel streams the
    weights in K-chunks beside the inputs; still bit-equal. The packed mode
    decodes into resident shared memory only and refuses the layer."""
    case = (7, 256, 64, 3, 3, False, "soft", True, (), (18, 32), (18, 32))
    args, kw, pw = _fused_operands(case, cuda, density=0.2)
    spk, mem = fp.fused_pipeline(*args, **kw)
    rspk, rmem = fp.fused_pipeline_reference(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(spk, rspk)
    assert torch.equal(mem.view(torch.int32), rmem.view(torch.int32))
    with pytest.raises(RuntimeError, match="launch failed"):
        fp.fused_pipeline_packed(args[0], torch.from_numpy(pw.maskp).to(cuda),
                                 torch.from_numpy(pw.vals).to(cuda), pw.tap_alive,
                                 args[3], args[4], **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["predecoded", "packed"])
@pytest.mark.parametrize("name", list(CASES))
def test_fused_pipeline_kernel_equals_plain_version(cuda, name, mode):
    args, kw, pw = _fused_operands(CASES[name], cuda)
    if mode == "packed":
        counter, launch = fp.KERNEL_PACKED, lambda: fp.fused_pipeline_packed(
            args[0], torch.from_numpy(pw.maskp).to(cuda),
            torch.from_numpy(pw.vals).to(cuda), pw.tap_alive, *args[3:], **kw)
    else:
        counter, launch = fp.KERNEL, lambda: fp.fused_pipeline(*args, **kw)
    before = fp.backend.launches[counter]
    spk, mem = launch()
    assert fp.backend.launches[counter] == before + 1
    rspk, rmem = fp.fused_pipeline_reference(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(spk, rspk)
    assert torch.equal(mem.view(torch.int32), rmem.view(torch.int32))


GATED_CASES = {
    # kh, cin, kout, density, kblk, u8 input, dead taps, (m, h, w), block
    "3x3-c8-k16": (3, 8, 16, 0.2, 8, False, (), (2, 18, 32), (18, 32)),
    "3x3-c16-k8": (3, 16, 8, 0.5, 8, False, (), (2, 18, 32), (18, 32)),
    "3x3-c3-k40": (3, 3, 40, 0.3, 8, False, (), (2, 18, 32), (18, 32)),
    "3x3-c32-k32-sparse": (3, 32, 32, 0.05, 8, False, (), (2, 18, 32), (18, 32)),
    "3x3-dense": (3, 8, 8, 1.0, 8, False, (), (2, 18, 32), (18, 32)),
    "1x1": (1, 16, 24, 0.7, 8, False, (), (1, 18, 32), (18, 32)),
    "multi-blocks": (3, 8, 16, 0.3, 16, False, (), (2, 36, 64), (18, 32)),
    "all-zero": (3, 8, 8, 0.0, 8, False, (), (1, 18, 32), (18, 32)),
    "k-blocks-3": (3, 8, 40, 0.25, 16, False, (), (1, 18, 32), (18, 32)),
    "kout6-tail": (3, 8, 6, 0.5, 8, False, (), (2, 12, 16), (6, 8)),
    "dead-taps": (3, 16, 32, 0.4, 32, False, (0, 2, 4, 6), (2, 12, 16), (6, 8)),
    "encode-u8": (3, 3, 16, 0.7, 16, True, (), (2, 36, 64), (18, 32)),
    "wide-c256-k256": (3, 256, 256, 0.2, 128, False, (), (4, 18, 32), (18, 32)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(GATED_CASES))
def test_gated_one_to_all_kernel_equals_plain_version(cuda, name):
    kh, cin, kout, density, kblk, u8, dead, (m, h, w), (bh, bw) = GATED_CASES[name]
    rng = np.random.default_rng(1)
    wq = rng.integers(-127, 128, (kh, kh, cin, kout)).astype(np.int8)
    wq[rng.random(wq.shape) >= density] = 0
    for t in dead:
        wq[t // kh, t % kh] = 0
    pw = ops.pack_conv_weights(wq, kblk=kblk)
    dev = ops.packed_tensors(pw, cuda)
    x = rng.integers(0, 256 if u8 else 2, (m, h, w, pw.cin)).astype(np.uint8)
    x[..., cin:] = 0
    xt = torch.from_numpy(x).to(cuda)
    kw = dict(kout=kout, kh=kh, kw=kh, bh=bh, bw=bw)
    before = g2a.backend.launches[g2a.KERNEL]
    got = g2a.gated_one_to_all(xt, *dev, **kw)
    assert g2a.backend.launches[g2a.KERNEL] == before + 1
    want = g2a.gated_one_to_all_reference(xt, *dev, **kw)
    oracle = ref.gated_conv_ref(xt[..., :cin], torch.from_numpy(wq).to(cuda), bh=bh, bw=bw)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(got.float(), oracle)


LIF_CASES = {
    # t, m, c, dtype, threshold, leak
    "T1": (1, 300, 16, torch.float32, 0.5, 0.25),
    "T3-ragged-m": (3, 1001, 8, torch.float32, 0.5, 0.25),
    "T5-c3": (5, 777, 3, torch.float32, 0.3, 0.5),
    "T16": (16, 4096, 32, torch.float32, 0.5, 0.25),
    "T4-bf16": (4, 513, 16, torch.bfloat16, 0.5, 0.25),
    "T3-bf16-odd": (3, 37, 3, torch.bfloat16, 0.3, 0.5),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(LIF_CASES))
def test_fused_lif_kernel_equals_plain_version(cuda, name):
    t, m, c, dtype, thr, leak = LIF_CASES[name]
    x = np.random.default_rng(t * m).standard_normal((t, m, c)).astype(np.float32)
    x[0, 0, :3] = [np.inf, np.nan, -0.0]
    xt = torch.from_numpy(x).to(dtype).to(cuda)
    before = sl.backend.launches[sl.KERNEL]
    got = sl.fused_lif(xt, threshold=thr, leak=leak)
    assert sl.backend.launches[sl.KERNEL] == before + 1
    want = sl.fused_lif_reference(xt, threshold=thr, leak=leak)
    torch.cuda.synchronize()
    assert got.dtype == torch.int8 and torch.equal(got, want)
    assert torch.equal(got, ref.fused_lif_ref(xt, threshold=thr, leak=leak))


MATMUL_CASES = {
    # m, k, n, density, kblk, nblk, x dtype, W dtype
    "one-block": (64, 512, 256, 0.2, 512, 256, torch.float32, torch.float32),
    "blocks-3x3": (200, 1500, 700, 0.2, 512, 256, torch.float32, torch.float32),
    "ragged-small-blocks": (37, 100, 70, 0.3, 16, 24, torch.float32, torch.float32),
    "nblk-48": (129, 96, 150, 0.5, 32, 48, torch.float32, torch.float32),
    "zero-blocks": (65, 1024, 512, 0.2, 512, 256, torch.float32, torch.float32),
    "all-zero": (8, 64, 40, 0.0, 32, 16, torch.float32, torch.float32),
    "bf16-x": (100, 600, 300, 0.2, 512, 256, torch.bfloat16, torch.float32),
    "bf16-both": (100, 600, 300, 0.2, 512, 256, torch.bfloat16, torch.bfloat16),
    "int8-vals": (100, 600, 300, 0.2, 512, 256, torch.float32, torch.int8),
    "dense": (64, 256, 128, 1.0, 64, 128, torch.float32, torch.float32),
    # the tensor-core kernel's paths: one and 16 rows (split-K), a ragged
    # last K-block, KBLK not a multiple of the 32-row slice, x rows not
    # 16-byte aligned, the bf16 single pass with int8 values, and
    # qwen1.5-0.5b's FFN up-projection on 2048 tokens
    "m1-split-k": (1, 1024, 2816, 0.2, 512, 256, torch.float32, torch.float32),
    "m16-split-k": (16, 2816, 1024, 0.2, 512, 256, torch.float32, torch.float32),
    "ragged-last-kblock": (70, 1000, 300, 0.2, 512, 256, torch.float32, torch.float32),
    "kblk-40": (50, 120, 90, 0.3, 40, 48, torch.float32, torch.float32),
    "x-unaligned": (33, 101, 70, 0.3, 16, 24, torch.float32, torch.float32),
    "bf16-x-unaligned": (20, 100, 64, 0.3, 32, 64, torch.bfloat16, torch.bfloat16),
    "bf16-x-int8-vals": (100, 600, 300, 0.2, 512, 256, torch.bfloat16, torch.int8),
    "ffn-2048x1024x2816": (2048, 1024, 2816, 0.2, 512, 256, torch.float32, torch.float32),
}


def _matmul_operands(name, dev):
    m, k, n, density, kblk, nblk, xdt, wdt = MATMUL_CASES[name]
    rng = np.random.default_rng(m + k + n)
    w = rng.standard_normal((k, n)) * (50 if wdt == torch.int8 else 1)
    w[rng.random((k, n)) >= density] = 0.0
    if name == "zero-blocks":
        w[:512, 256:] = 0.0  # two whole blocks
    wt = (torch.from_numpy(np.clip(np.round(w), -127, 127)).to(torch.int8)
          if wdt == torch.int8 else torch.from_numpy(w).to(wdt))
    x = torch.from_numpy(rng.standard_normal((m, k))).to(xdt).to(dev)
    return x, wt, ops.pack_matmul_weights(wt, kblk=kblk, nblk=nblk).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(MATMUL_CASES))
def test_bitmask_matmul_kernel_within_tolerance(cuda, name):
    x, wt, pw = _matmul_operands(name, cuda)
    before = bmm.backend.launches[bmm.KERNEL]
    got = bmm.bitmask_matmul(x, pw)
    assert bmm.backend.launches[bmm.KERNEL] == before + 1
    plain = bmm.bitmask_matmul_reference(x, pw)
    torch.cuda.synchronize()
    w64 = wt.double().to(cuda)
    f64 = x.double() @ w64
    tol = 1e-5 * (x.double().abs() @ w64.abs()) + 1e-6
    assert got.dtype == torch.float32 and got.shape == plain.shape
    for want in (plain, f64):
        assert bool(((got.double() - want.double()).abs() <= tol).all()), \
            float((got.double() - want.double()).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["one-block", "m16-split-k", "bf16-both"])
def test_bitmask_matmul_split_k_is_deterministic(cuda, name):
    """At small M the kernel splits the K slices across blocks and sums the
    partials in a fixed order: two runs give the same bits."""
    x, _, pw = _matmul_operands(name, cuda)
    assert bmm.kernel_splits(x.shape[0], pw) > 1
    first = bmm.bitmask_matmul(x, pw)
    second = bmm.bitmask_matmul(x, pw)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


@pytest.mark.gpu
def test_bitmask_matmul_bf16_pass_is_exact_on_integers(cuda):
    """The one bf16 pass (x bf16, values int8): small integer x and W give
    integer products and sums below 2^24, exact in f32 in any order, so the
    kernel must equal the float64 product bit for bit."""
    rng = np.random.default_rng(7)
    w = rng.integers(-127, 128, (600, 300))
    w[rng.random(w.shape) >= 0.2] = 0
    wt = torch.from_numpy(w).to(torch.int8)
    x = torch.from_numpy(rng.integers(-8, 9, (100, 600)).astype(np.float32))
    x = x.to(torch.bfloat16).to(cuda)
    pw = ops.pack_matmul_weights(wt).to(cuda)
    got = bmm.bitmask_matmul(x, pw)
    want = (x.double() @ wt.double().to(cuda)).float()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_new_kernels_refuse_bad_input(cuda):
    x, _, pw = _matmul_operands("one-block", cuda)
    with pytest.raises(ValueError, match="is on cpu"):
        bmm.bitmask_matmul(x, pw.to("cpu"))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        bmm.bitmask_matmul(x.half(), pw)
    with pytest.raises(ValueError, match="contiguous"):
        bmm.bitmask_matmul(x.t().contiguous().t(), pw)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        sl.fused_lif(torch.zeros((2, 8, 4), dtype=torch.float16, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        sl.fused_lif(torch.zeros((4, 8, 2), device=cuda).transpose(0, 2))
    with pytest.raises(ValueError, match="aligned"):
        sl.fused_lif(torch.zeros(65, device=cuda)[1:].reshape(1, 8, 8))
