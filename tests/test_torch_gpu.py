"""The port's CUDA kernels against their plain PyTorch versions on the card:
bit for bit, the fused pipeline in both weight modes (T up to 16, each of
its tensor-core tilings, weights resident or streamed — the packed mode
decoding streamed K-chunks), the gated one-to-all conv and the fused LIF;
the bitmask matmul within 1e-5·(|x|@|W|) + 1e-6 of its plain version and
of a float64 product (f32 sums in another order), its split-K path the
same from run to run; and the megabatched Engine on the card against solo
session replays. Needs a CUDA device and nothing of JAX; skips without a
card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import bitmask_matmul as bmm  # noqa: E402
from repro_torch.kernels import fused_pipeline as fp  # noqa: E402
from repro_torch.kernels import gated_one_to_all as g2a  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import spike_lif as sl  # noqa: E402
from repro_torch.configs.snn_det import smoke_config  # noqa: E402
from repro_torch.models import snn_yolo as sy  # noqa: E402
from repro_torch.serve import Engine, FrameRequest  # noqa: E402
from repro_torch.serve.detector import demo_weights  # noqa: E402

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


def _fused_operands(case, dev, density=0.3, kblk=128):
    """(args, kw, pw) for one fused case: seeded weights, inputs, affine."""
    kh, cin, kout, t_in, t_out, u8, reset, warm, dead, (h, w), (bh, bw) = case
    rng = np.random.default_rng(0)
    wq = rng.integers(-127, 128, (kh, kh, cin, kout)).astype(np.int8)
    wq[rng.random(wq.shape) > density] = 0
    for t in dead:
        wq[t // kh, t % kh] = 0
    pw = ops.pack_conv_weights(wq, kblk=kblk)
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


def _packed_launch(args, kw, pw, dev):
    return fp.fused_pipeline_packed(args[0], torch.from_numpy(pw.maskp).to(dev),
                                    torch.from_numpy(pw.vals).to(dev), pw.tap_alive,
                                    *args[3:], **kw)


@pytest.mark.gpu
def test_fused_pipeline_streams_weights_past_the_resident_budget(cuda):
    """A 7x7 layer at C = 256: its 64-channel weight slice (49*256*64 B =
    784 KB) exceeds shared memory, so the kernel streams the weights in
    K-chunks beside the inputs, copied (predecoded) or decoded chunk by
    chunk (packed); both bit-equal to the plain version."""
    case = (7, 256, 64, 3, 3, False, "soft", True, (), (18, 32), (18, 32))
    args, kw, pw = _fused_operands(case, cuda, density=0.2)
    rspk, rmem = fp.fused_pipeline_reference(*args, **kw)
    for spk, mem in (fp.fused_pipeline(*args, **kw), _packed_launch(args, kw, pw, cuda)):
        torch.cuda.synchronize()
        assert torch.equal(spk, rspk)
        assert torch.equal(mem.view(torch.int32), rmem.view(torch.int32))


STREAMED_PACKED_CASES = {
    # (case as in CASES, kblk): K-chunks whose boundaries fall inside a tap
    # (C = 264, 136 against 128- and 256-byte chunks), so inside a
    # K-block's mask rows; 64-channel tiles that start inside a K-block
    # (KBLK 40, 24) and span two or three of them; a Kout tail inside the
    # last K-block; dead taps; T = 3, and one conv driving 4 LIF steps
    "5x5-c264-k100-kblk40": ((5, 264, 100, 3, 3, False, "soft", True, (0, 7),
                              (18, 32), (18, 32)), 40),
    "7x7-c136-k56-kblk24-mixed": ((7, 136, 56, 1, 4, False, "hard", True, (24,),
                                   (36, 64), (18, 32)), 24),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(STREAMED_PACKED_CASES))
def test_fused_pipeline_packed_decodes_streamed_chunks(cuda, name):
    case, kblk = STREAMED_PACKED_CASES[name]
    args, kw, pw = _fused_operands(case, cuda, density=0.25, kblk=kblk)
    spk, mem = _packed_launch(args, kw, pw, cuda)
    kh, cin = case[0], case[1]
    plan = fp.last_plan()  # the tile's weight slice exceeds the block's shared memory
    assert plan["tile_channels"] * kh * kh * cin > plan["smem_bytes"]
    rspk, rmem = fp.fused_pipeline_reference(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(spk, rspk)
    assert torch.equal(mem.view(torch.int32), rmem.view(torch.int32))


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
    # kh, cin, kout, density, kblk, u8 input, dead taps (a tap, or (tap, k0,
    # k1): the tap dead in output channels k0:k1 only), (m, h, w), block
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
    # the tensor-core tilings: M not a multiple of 4 (the images fold into
    # the pixel tiles, so a tile may span two images); C = 16 (two taps per
    # k-step) on a multi-block map, conv_block's shape class; a 64-channel
    # tile over four K-blocks of 16 with a tap dead in one of them and alive
    # in the others; kout tails; 5x5 and 7x7 kernels; a 7x7 at C = 256 whose
    # decoded weights exceed shared memory (decoded and summed in K-dim
    # segments, A from im2col gathers); M = 0
    "m5-c256-k256": (3, 256, 256, 0.2, 128, False, (), (5, 18, 32), (18, 32)),
    "m6-c256-k256": (3, 256, 256, 0.2, 128, False, (), (6, 18, 32), (18, 32)),
    "c16-multi-block-m8": (3, 16, 32, 0.3, 32, False, (), (8, 36, 64), (18, 32)),
    "c16-one-image": (3, 16, 32, 0.3, 32, False, (4,), (1, 36, 64), (18, 32)),
    "tile64-kblk16-tap-dead-in-one": (3, 32, 64, 0.3, 16, False, ((4, 0, 16), (0, 16, 64)),
                                      (4, 18, 32), (18, 32)),
    "kout40-tail-m4": (3, 16, 40, 0.3, 8, False, (), (4, 18, 32), (18, 32)),
    "kout6-tail-m5": (3, 8, 6, 0.5, 8, False, (), (5, 12, 16), (6, 8)),
    "kout6-tail-large-map": (3, 8, 6, 0.5, 8, False, (), (2, 96, 128), (6, 8)),
    "5x5-c64": (5, 64, 64, 0.2, 64, False, (), (4, 18, 32), (18, 32)),
    "7x7-c64": (7, 64, 32, 0.2, 32, False, (), (1, 36, 64), (18, 32)),
    "7x7-c256-segmented": (7, 256, 16, 0.2, 16, False, (), (1, 18, 32), (18, 32)),
    "7x7-c256-k64-segmented-m4": (7, 256, 64, 0.1, 64, False, (), (4, 18, 32), (18, 32)),
    "m0": (3, 16, 32, 0.3, 32, False, (), (0, 18, 32), (18, 32)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(GATED_CASES))
def test_gated_one_to_all_kernel_equals_plain_version(cuda, name):
    kh, cin, kout, density, kblk, u8, dead, (m, h, w), (bh, bw) = GATED_CASES[name]
    rng = np.random.default_rng(1)
    wq = rng.integers(-127, 128, (kh, kh, cin, kout)).astype(np.int8)
    wq[rng.random(wq.shape) >= density] = 0
    for d in dead:
        t, k0, k1 = (d, 0, kout) if isinstance(d, int) else d
        wq[t // kh, t % kh, :, k0:k1] = 0
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


@pytest.mark.gpu
@pytest.mark.parametrize("lengths,slots", [((1, 4, 2, 5, 3, 1, 2, 6, 1, 3), 4), ((6,), 2)],
                         ids=["join-leave", "steady-double-buffered"])
def test_engine_on_the_card_equals_solo_sessions(cuda, lengths, slots, monkeypatch):
    """The megabatched Engine on the card (smoke config, kernel executor):
    staggered joins and leaves over 4 slots, and one steady 6-frame stream
    whose every tick after the first takes the frames uploaded on the side
    stream during the tick before. Every served head and detection is
    bit-equal to a solo session replay; 27 fused launches per tick."""
    cfg = dataclasses.replace(smoke_config(), conv_exec="pallas")
    params, bn, rng = demo_weights(cfg, device=cuda)
    det = sy.compile_detector(cfg, params, bn, device=cuda)
    h, w = cfg.input_hw
    reqs = [FrameRequest(rid=r, frames=(rng.integers(0, 256, (n, h, w, 3)) / 255.0)
                         .astype(np.float32)) for r, n in enumerate(lengths)]
    eng = Engine(det, n_slots=slots)
    offsets = []
    real = eng.core._upload
    monkeypatch.setattr(eng.core, "_upload", lambda active, offset=0:
                        offsets.append(offset) or real(active, offset))
    for fr in reqs:
        assert eng.submit(fr)
    before = fp.backend.launches[fp.KERNEL]
    assert eng.run().status == "drained"
    torch.cuda.synchronize()
    ticks = len(eng.core.step_wall)
    assert fp.backend.launches[fp.KERNEL] - before == 27 * ticks
    assert len(eng.core.step_device_ms) == ticks
    if len(lengths) == 1:
        assert offsets == [0] + [1] * 5
    for fr in reqs:
        solo = det.new_session(batch=1)
        for k, f in enumerate(fr.frames):
            step = solo.step(f[None])
            assert np.array_equal(fr.heads[k], step.head[0].cpu().numpy()), (fr.rid, k)
            for name in ("boxes", "scores", "classes", "valid"):
                assert np.array_equal(getattr(fr.out[k], name),
                                      getattr(step.detections, name)[0].cpu().numpy())


@pytest.mark.gpu
def test_train_step_on_the_card_equals_cpu(cuda):
    """One train step (loss and gradients, then AdamW) at ``demo_config``
    on the card and on the CPU from the same host params and batch: spikes
    equal, loss within 1e-5 relative, each gradient leaf within
    1e-4·max|g| + 1e-7, the new tdBN state and the updated parameters within
    1e-6 × the leaf's max (parameters where the clipped gradient |ĝ| ≥ 1e-6;
    within 2·lr elsewhere, as in ``tests/test_torch_train.py``). cuDNN's
    backward convs sum in another order (and not deterministically), so
    nothing is compared bit for bit."""
    from repro_torch import tree as tu
    from repro_torch.data import synthetic_detection as sdata
    from repro_torch.eval import harness
    from repro_torch.train import optimizer as opt

    cfg = harness.demo_config()
    params, bn = sy.init_params(cfg, seed=0, device="cpu")
    batch = next(sdata.batches(2, hw=cfg.input_hw, steps=1, grid_div=harness.grid_div(cfg)))
    ocfg = harness.train_config(1)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        p = tu.tree_map(lambda t: t.to(dev), params)
        b = tu.tree_map(lambda t: t.to(dev), bn)
        with sy._no_tf32():
            loss, grads, new_bn, aux = harness.loss_and_grads(
                cfg, p, b, torch.from_numpy(batch["image"]).to(dev),
                torch.from_numpy(batch["target"]).to(dev))
            new_p, _ = opt.apply_updates(p, grads, opt.init_state(p, ocfg), ocfg)
        out[dev.type] = tu.tree_map(lambda t: t.detach().cpu(),
                                    (loss, grads, new_bn, new_p, aux["spikes"]))
    (l0, g0, bn0, p0, s0), (l1, g1, bn1, p1, s1) = out["cpu"], out["cuda"]
    for k in s0:
        assert torch.equal(s0[k], s1[k]), f"{int((s0[k] != s1[k]).sum())} spikes flip at {k}"
    assert abs(float(l1 - l0)) <= 1e-5 * abs(float(l0))
    gnorm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in tu.leaves(g0))))
    clip = min(1.0, ocfg.grad_clip / gnorm)
    lr = float(opt.lr_schedule(ocfg, torch.tensor(1, dtype=torch.int32)))
    for a, b_, pa, pb in zip(tu.leaves(g0), tu.leaves(g1), tu.leaves(p0), tu.leaves(p1)):
        assert float((a - b_).abs().max()) <= 1e-4 * float(a.abs().max()) + 1e-7
        scale = 1e-6 * float(pa.abs().max())
        tol = torch.where(a.abs() * clip >= 1e-6, scale, 2 * lr + scale)
        assert bool(((pa - pb).abs() <= tol).all())
    for name, st in bn0.items():
        mscale = max(float(st["mean"].abs().max()), float(st["var"].sqrt().max()))
        assert float((bn1[name]["mean"] - st["mean"]).abs().max()) <= 1e-6 * mscale
        assert float((bn1[name]["var"] - st["var"]).abs().max()) <= \
            1e-6 * float(st["var"].abs().max())
        assert bn1[name]["count"].dtype == torch.int32


@pytest.mark.gpu
def test_run_pipeline_on_the_card_kernel_equals_dense(cuda, tmp_path):
    """``run_pipeline(conv_exec="pallas")`` on the card at ``demo_config``
    with block conv: one fused launch per layer and ``detect()`` in the two
    quantized evaluations and none elsewhere, and the ``"qat"`` and
    ``"uniform_t3"`` reports identical to the dense executor's on the same
    weights."""
    from repro_torch import backend
    from repro_torch.eval import harness
    from repro_torch.eval import sharded as se

    cfg = dataclasses.replace(harness.demo_config(), use_block_conv=True)
    backend.reset_launches()
    rep = harness.run_pipeline(cfg, steps=20, finetune_steps=5, batch=2, eval_images=8,
                               conv_exec="pallas", device=cuda, verbose=False)
    torch.cuda.synchronize()
    det = rep.final_det
    n_fused = len(det.plan.layers) - 1  # every layer but the head
    assert dict(backend.launches) == {fp.KERNEL: 2 * n_fused}
    for name, mixed in (("qat", True), ("uniform_t3", False)):
        dense = harness.compile_eval_detector(
            dataclasses.replace(det.cfg, conv_exec="dense", mixed_time=mixed), det.params,
            det.bn_state, device=cuda)
        got = rep.stages["qat"] if mixed else rep.schedules["uniform_t3"]
        assert se.reports_identical(got, harness.evaluate_detector(dense, n_images=8)), name
