"""The port's CUDA kernels against their plain PyTorch versions on the card:
bit for bit, the fused pipeline in both weight modes (T up to 16, each of
its tensor-core tilings, weights resident or streamed — the packed mode
decoding streamed K-chunks), the gated one-to-all conv and the fused LIF;
the bitmask matmul within 1e-5·(|x|@|W|) + 1e-6 of its plain version and
of a float64 product (f32 sums in another order), its split-K path the
same from run to run; the megabatched Engine on the card against solo
session replays; and the ANN→SNN conversion on the card against the CPU's,
a converted detector's fused launches at T=128 against the plain version,
and the COCO fixture feeding ``evaluate_detector``; LM token serving (the
smoke configs on the card against the CPU, qwen1.5-0.5b at full width; a
recurrent and a modal family on the card against the CPU); LM
training (one train step at the smoke configs on the card against the CPU,
the training launcher at qwen1.5-0.5b's full width); two processes sharing
the card in one sharded detector evaluation; on four cards, the NCCL
branch (one process per card) and the single-process card gather; and, on
two cards, the sharded (``fsdp``) training state over NCCL.
Needs a CUDA device and nothing of JAX; skips without a card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import dataclasses
import os

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


# ------------------------------------------------------ ANN→SNN conversion --

_FIXTURE_NPZ = os.path.join(os.path.dirname(__file__), "fixtures", "ann_detector",
                            "ann_tiny_yolo.npz")
_COCO_JSON = os.path.join(os.path.dirname(__file__), "fixtures", "coco_fixture",
                          "instances.json")
_SMOKE_CC = dict(full_t=4, calib_images=4, calib_batch=4, v_init_frac=0.5)


@pytest.mark.gpu
def test_conversion_on_the_card_equals_cpu(cuda):
    """The committed fixture converted at ``tests/test_convert.py``'s smoke
    scale on the card and on the CPU: parameters and tdBN variances within
    1e-5 of each array's largest magnitude, the tdBN means within 1e-5 of
    each channel's spread (the f32 convs sum in another order; the
    statistics are numpy on host copies in both), and the plans' int8
    weights equal or one apart at a rounding half."""
    from repro_torch import convert as cv
    from repro_torch.core import plan as cplan

    ann = cv.load_ann_npz(_FIXTURE_NPZ)
    cc = cv.ConvertConfig(**_SMOKE_CC)
    card, cpu = (cv.convert_ann(ann, cc=cc, device=d) for d in (cuda, "cpu"))
    assert card.params["encode"]["w"].device.type == "cuda"

    def rel(a, b):
        a, b = a.cpu().double(), b.cpu().double()
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    for name, lp in cpu.params.items():
        for k, v in lp.items():
            if name != "head":
                assert rel(card.params[name][k], v) <= 1e-5, (name, k)
    for name, st in cpu.bn_state.items():
        assert rel(card.bn_state[name]["var"], st["var"]) <= 1e-5, name
        spread = (st["var"].double() + 1e-5).sqrt()
        drift = (card.bn_state[name]["mean"].cpu().double() - st["mean"].double()).abs() / spread
        assert float(drift.max()) <= 1e-5, name
    alpha, calpha = card.report["head_scale_fit"], cpu.report["head_scale_fit"]
    assert abs(alpha - calpha) <= 2e-3 * abs(calpha)
    pa, pb = cplan.build_plan(card.params, card.cfg), cplan.build_plan(cpu.params, cpu.cfg)
    for name, lp in pa.layers.items():
        if name == "head":
            continue
        a, b = lp.w_q.cpu(), pb.layers[name].w_q
        diff = a != b
        if bool(diff.any()):
            q = card.params[name]["w"].cpu() / float(lp.scale)
            frac = (q - q.trunc()).abs()
            assert bool(((frac - 0.5).abs()[diff] <= 2e-3).all()), name
            assert int((a.int() - b.int()).abs().max()) <= 1, name


@pytest.mark.gpu
def test_converted_fused_launches_equal_plain_at_t128(cuda, monkeypatch):
    """The fixture converted at T=128 (``ConvertConfig``'s default; 4
    calibration images to keep it short): one ``detect()`` of 4 val images
    through the kernel executor launches the fused kernel once per fused
    layer, every launch's inputs replayed through the kernel and its plain
    version bit for bit, and the head bit-equal to the dense executor's."""
    from repro_torch import backend
    from repro_torch import convert as cv
    from repro_torch.data import synthetic_detection as sd
    from repro_torch.eval import harness

    ann = cv.load_ann_npz(_FIXTURE_NPZ)
    out = cv.convert_ann(ann, cc=cv.ConvertConfig(calib_images=4), device=cuda)
    assert out.cfg.full_t == 128
    det = harness.compile_eval_detector(dataclasses.replace(out.cfg, conv_exec="pallas"),
                                        out.params, out.bn_state, device=cuda)
    dense = harness.compile_eval_detector(dataclasses.replace(out.cfg, conv_exec="dense"),
                                          out.params, out.bn_state, device=cuda)
    images, _ = sd.eval_set(4, hw=out.cfg.input_hw, grid_div=harness.grid_div(out.cfg))
    seen = []
    real = fp.fused_pipeline

    def record(*args, **kw):
        seen.append((tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args),
                     dict(kw)))
        return real(*args, **kw)

    monkeypatch.setattr(fp, "fused_pipeline", record)
    backend.reset_launches()
    dets, head = det.detect(torch.from_numpy(images))
    torch.cuda.synchronize()
    n_fused = len(det.plan.layers) - 1
    assert backend.launches[fp.KERNEL] == n_fused == len(seen)
    monkeypatch.setattr(fp, "fused_pipeline", real)
    assert seen[1][1]["t_out"] == 128 and seen[1][0][0].shape[0] == 128
    for args, kw in seen:
        spk, mem = fp.fused_pipeline(*args, **kw)
        rspk, rmem = fp.fused_pipeline_reference(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(spk, rspk)
        assert torch.equal(mem.view(torch.int32), rmem.view(torch.int32))
    ddets, dhead = dense.detect(torch.from_numpy(images))
    assert torch.equal(head.view(torch.int32), dhead.view(torch.int32))
    for f in ("valid", "classes"):
        assert torch.equal(getattr(dets, f), getattr(ddets, f))


@pytest.mark.gpu
def test_coco_source_feeds_evaluate_detector_on_the_card(cuda):
    """The committed COCO fixture calibrates a conversion on the card and
    feeds ``evaluate_detector``: the kernel executor's report identical to
    the dense executor's over the 4 letterboxed images."""
    from repro_torch import convert as cv
    from repro_torch.data import detection_datasets as dd
    from repro_torch.eval import harness
    from repro_torch.eval import sharded as se

    source = dd.parse_dataset_spec(f"coco:{_COCO_JSON}")
    out = cv.convert_ann(cv.load_ann_npz(_FIXTURE_NPZ), source=source,
                         cc=cv.ConvertConfig(**_SMOKE_CC), device=cuda)
    reps = {}
    for ex in ("pallas", "dense"):
        det = harness.compile_eval_detector(dataclasses.replace(out.cfg, conv_exec=ex),
                                            out.params, out.bn_state, device=cuda)
        reps[ex] = harness.evaluate_detector(det, n_images=48, source=source)
    assert reps["pallas"]["n_images"] == 4
    assert se.reports_identical(reps["pallas"], reps["dense"])


# ---------------------------------------------------------- LM serving --
# No hand-written kernel is on this path; the card runs PyTorch's own.
LM_LOGITS_TOL = 4e-3  # tests/test_torch_lm.py's bound through the bf16 KV cache
LM_F32_TOL = 8e-5  # card against CPU, f32 logits with no bf16 cache on the path


def _lm_serve(cfg, params, prompts, *, n_slots, max_new):
    """Serve ``prompts`` through ``Engine``; (outputs by rid, every logits
    call's rows on the host, in call order)."""
    from repro_torch.serve import Request

    eng = Engine(cfg, params, n_slots=n_slots, max_seq=96)
    calls = []
    decode, prefill_fn = eng.core._decode, eng.core._prefill_fn

    def dec(*a):
        out = decode(*a)
        calls.append(out[0].float().cpu())
        return out

    def pre(length):
        fn = prefill_fn(length)
        return lambda *a, **k: (lambda out: calls.append(out[0].float().cpu()) or out)(
            fn(*a, **k))

    eng.core._decode, eng.core._prefill_fn = dec, pre
    for r, p in enumerate(prompts):
        assert eng.submit(Request(rid=r, prompt=p, max_new_tokens=max_new))
    done = eng.run()
    assert done.status == "drained" and len(done) == len(prompts)
    return {r.rid: r.out for r in done}, calls


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "olmoe-1b-7b", "deepseek-moe-16b"])
def test_lm_engine_on_the_card_equals_cpu(cuda, arch):
    """``Engine`` at the smoke config (f32, TF32 off) on the card and on the
    CPU from the same params: every logits call within 4e-3 of the largest
    |logit|, the greedy streams equal (no step of these inputs has a top-2
    margin below that bound), no hand-written kernel launched."""
    from repro_torch import backend
    from repro_torch import tree as tu
    from repro_torch.configs import get_config
    from repro_torch.configs import smoke_config as lm_smoke
    from repro_torch.models import zoo

    cfg = lm_smoke(get_config(arch))
    params = zoo.get_api(cfg).init_params(0, device="cpu")
    rng = np.random.default_rng(21)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, int(rng.integers(3, 41)))]
               for _ in range(6)]
    before = sum(backend.launches.values())
    with sy._no_tf32():
        cpu_out, cpu_calls = _lm_serve(cfg, params, prompts, n_slots=4, max_new=8)
        card_out, card_calls = _lm_serve(cfg, tu.tree_map(lambda x: x.to(cuda), params),
                                         prompts, n_slots=4, max_new=8)
    torch.cuda.synchronize()
    assert sum(backend.launches.values()) == before
    assert len(card_calls) == len(cpu_calls)
    for a, b in zip(card_calls, cpu_calls):
        assert float((a - b).abs().max()) <= LM_LOGITS_TOL * float(b.abs().max())
    assert card_out == cpu_out


@pytest.mark.gpu
def test_lm_engine_full_width_on_the_card(cuda):
    """qwen1.5-0.5b at its published width in bf16: 4 requests through an
    8-slot Engine drain with finite logits and tokens in the vocabulary,
    prefill keyed by bucket, no hand-written kernel launched."""
    from repro_torch import backend
    from repro_torch.configs import get_config
    from repro_torch.models import zoo

    cfg = get_config("qwen1.5-0.5b")
    params = zoo.get_api(cfg).init_params(0, device=cuda)
    assert params["embed"]["tok"].dtype == torch.bfloat16
    rng = np.random.default_rng(22)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)] for n in (5, 20, 40, 70)]
    before = sum(backend.launches.values())
    out, calls = _lm_serve(cfg, params, prompts, n_slots=8, max_new=8)
    torch.cuda.synchronize()
    assert sum(backend.launches.values()) == before
    assert all(len(o) == 8 and all(0 <= t < cfg.vocab_size for t in o) for o in out.values())
    assert all(bool(torch.isfinite(c).all()) for c in calls)
    assert len(calls) == 4 + 7  # one prefill per request, 7 decode steps of all 4 together


def _api_greedy(api, params, toks, frames, n):
    """whisper through its API: prefill with the frames into a bf16 cache,
    ``n`` greedy decode steps; (streams, every logits call on the host)."""
    b, t = toks.shape
    cache = api.init_cache(b, t + n, device=toks.device)
    logits, cache = api.prefill_fn(params, toks, frames, cache=cache)
    seq, calls = [logits.argmax(-1)], [logits.float().cpu()]
    for i in range(n):
        logits, cache = api.decode_fn(params, cache, seq[-1], t + i)
        seq.append(logits.argmax(-1))
        calls.append(logits.float().cpu())
    return torch.stack(seq, 1).cpu(), calls


@pytest.mark.gpu
def test_lm_families_on_the_card_equal_cpu(cuda):
    """A recurrent and a modal family at the smoke config (f32, TF32 off) on
    the card and on the CPU from the same params: rwkv6-3b through
    ``Engine``, whisper-small through its API with seeded frames. Logits
    within 8e-5 of the largest |logit| (4e-3 for whisper's decode steps,
    which read K/V from the bf16 cache), streams equal, no hand-written
    kernel launched."""
    from repro_torch import backend
    from repro_torch import tree as tu
    from repro_torch.configs import get_config
    from repro_torch.configs import smoke_config as lm_smoke
    from repro_torch.models import zoo

    before = sum(backend.launches.values())
    cfg = lm_smoke(get_config("rwkv6-3b"))
    params = zoo.get_api(cfg).init_params(0, device="cpu")
    rng = np.random.default_rng(23)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, int(rng.integers(3, 41)))]
               for _ in range(6)]
    cfg_w = lm_smoke(get_config("whisper-small"))
    api_w = zoo.get_api(cfg_w)
    params_w = api_w.init_params(0, device="cpu")
    toks = torch.from_numpy(rng.integers(1, cfg_w.vocab_size, (2, 4)))
    frames = torch.from_numpy(rng.standard_normal((2, cfg_w.encoder_seq, cfg_w.d_model))
                              .astype(np.float32))
    with sy._no_tf32():
        cpu_out, cpu_calls = _lm_serve(cfg, params, prompts, n_slots=4, max_new=8)
        card_out, card_calls = _lm_serve(cfg, tu.tree_map(lambda x: x.to(cuda), params),
                                         prompts, n_slots=4, max_new=8)
        cpu_seq, cpu_w = _api_greedy(api_w, params_w, toks, frames, 8)
        card_seq, card_w = _api_greedy(api_w, tu.tree_map(lambda x: x.to(cuda), params_w),
                                       toks.to(cuda), frames.to(cuda), 8)
    torch.cuda.synchronize()
    assert sum(backend.launches.values()) == before
    tols = [LM_F32_TOL] * (len(cpu_calls) + 1) + [LM_LOGITS_TOL] * (len(cpu_w) - 1)
    for a, b, tol in zip(card_calls + card_w, cpu_calls + cpu_w, tols, strict=True):
        assert float((a - b).abs().max()) <= tol * float(b.abs().max())
    assert card_out == cpu_out and torch.equal(card_seq, cpu_seq)


def _lm_train_step(api, params, batch, n_mb, gc, ocfg):
    """(grads, new params, metrics) of one train step on ``params``' device,
    moved to the host; ``params`` are left as they were."""
    from repro_torch import tree as tu
    from repro_torch.train import trainer

    p = tu.tree_map(torch.clone, params)
    _, grads = trainer.loss_and_grads(api.loss_fn, p, batch, n_microbatch=n_mb)
    new, m = trainer.make_train_step(api.loss_fn, ocfg, n_microbatch=n_mb, grad_compress=gc)(
        trainer.init_train_state(p, ocfg, grad_compress=gc), batch)
    cpu = lambda t: tu.tree_map(lambda x: x.cpu(), t)  # noqa: E731
    return cpu(grads), cpu(new.params), {k: v.cpu() for k, v in m.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("n_mb,gc,int8", [(1, False, False), (2, False, False), (1, True, True)])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "olmoe-1b-7b"])
def test_lm_train_step_on_the_card_equals_cpu(cuda, arch, n_mb, gc, int8):
    """One ``make_train_step`` step at the smoke config (f32, TF32 off) on the
    card and on the CPU from the same params and ``batch_at`` batch, held to
    tests/test_torch_lm_train.py's bounds: loss and gradient norm 1e-5
    relative, gradients 1e-5 of each leaf's largest |g|, parameters 1e-6 of
    the leaf's largest |p| where the applied |ĝ| ≥ 100·eps (1e4·eps for a
    leaf that starts at 0; R6, R8), 2·lr elsewhere; no hand-written kernel."""
    from repro_torch import backend
    from repro_torch import tree as tu
    from repro_torch.configs import get_config
    from repro_torch.configs import smoke_config as lm_smoke
    from repro_torch.data import lm_data
    from repro_torch.models import zoo
    from repro_torch.train import optimizer as opt

    cfg = lm_smoke(get_config(arch))
    api = zoo.get_api(cfg)
    params = api.init_params(0, device="cpu")
    ocfg = opt.AdamWConfig(warmup_steps=2, total_steps=20, int8_moments=int8)
    b = lm_data.batch_at(0, batch_size=8, seq_len=32, vocab=cfg.vocab_size)
    before = sum(backend.launches.values())
    with sy._no_tf32():
        want = _lm_train_step(api, params, {k: torch.from_numpy(v) for k, v in b.items()},
                              n_mb, gc, ocfg)
        got = _lm_train_step(api, tu.tree_map(lambda x: x.to(cuda), params),
                             {k: torch.from_numpy(v).to(cuda) for k, v in b.items()},
                             n_mb, gc, ocfg)
    torch.cuda.synchronize()
    assert sum(backend.launches.values()) == before
    for k in ("loss", "grad_norm"):
        assert abs(float(got[2][k]) - float(want[2][k])) <= 1e-5 * abs(float(want[2][k]))
    assert float(got[2]["lr"]) == float(want[2]["lr"]) and int(got[2]["step"]) == 1
    for a, c in zip(tu.leaves(want[0]), tu.leaves(got[0])):
        assert float((a - c).abs().max()) <= 1e-5 * float(a.abs().max())
    applied = want[0]
    if gc:
        applied = tu.tree_map(lambda g: opt.compress_decompress(g, torch.zeros_like(g))[0],
                              applied)
    clip = min(1.0, ocfg.grad_clip / float(want[2]["grad_norm"]))
    lr, eps = float(want[2]["lr"]), max(ocfg.eps, 1e-5) if int8 else ocfg.eps
    for p0, a, c, g in zip(tu.leaves(params), tu.leaves(want[1]), tu.leaves(got[1]),
                           tu.leaves(applied)):
        well = g.abs() * clip >= (1e4 if not bool(p0.any()) else 100) * eps
        scale = float(a.abs().max())
        tol = torch.where(well, 1e-6 * scale, 2 * lr + 1e-6 * scale)
        assert bool(((c.double() - a.double()).abs() <= tol).all())


@pytest.mark.gpu
def test_lm_train_launcher_full_width_on_the_card(cuda, tmp_path):
    """``launch.train`` at qwen1.5-0.5b's published width (bf16, remat) for
    three short steps: finite, falling losses written to ``--losses-out``;
    the parameters stay bf16; no hand-written kernel launched."""
    import json

    from repro_torch import backend
    from repro_torch.launch import train as launch_train

    before = sum(backend.launches.values())
    out = launch_train.main(["--arch", "qwen1.5-0.5b", "--full-config", "--steps", "3",
                             "--batch", "4", "--seq", "512", "--microbatch", "2",
                             "--losses-out", str(tmp_path / "losses.json")])
    torch.cuda.synchronize()
    assert sum(backend.launches.values()) == before
    losses = json.loads((tmp_path / "losses.json").read_text())
    assert len(losses) == 3 and all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert out["state"].params["embed"]["tok"].dtype == torch.bfloat16


@pytest.mark.gpu
def test_sharded_eval_two_processes_on_the_card(cuda, tmp_path):
    """Two processes on the one card (gloo, host-staged) walk their own
    shards of a smoke-config detector through the fused kernel: each
    process's report is identical to the single-process report on the card,
    and each launched the kernel."""
    import json
    import socket
    import subprocess
    import sys

    from repro_torch.eval import harness
    from repro_torch.eval import sharded as se

    cfg = dataclasses.replace(smoke_config(), conv_exec="pallas")
    params, bn, _ = demo_weights(cfg, device="cpu")
    root = str(tmp_path / "det")
    harness.save_detector_checkpoint(root, 0, params, bn, cfg)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    body = """
import json, sys
from repro_torch import backend
from repro_torch.distributed import runtime
from repro_torch.eval import harness
from repro_torch.eval import sharded as se
ctx = runtime.initialize(coordinator_address="127.0.0.1:%d", num_processes=2,
                         process_id=int(sys.argv[1]))
cfg, p, b, _ = harness.restore_detector_checkpoint(%r, device=ctx.device)
det = harness.compile_eval_detector(cfg, p, b, device=ctx.device)
backend.reset_launches()
rep = harness.evaluate_detector(det, n_images=8, sharded=se.ShardedEvalConfig(n_shards=4, batch=2),
                                ctx=ctx)
print("REPORT=" + json.dumps({**rep, "launches": dict(backend.launches),
                              "backend": ctx.backend}))
runtime.shutdown()
""" % (port, root)
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    procs = [subprocess.Popen([sys.executable, "-c", body, str(pid)],
                              env={**os.environ, "PYTHONPATH": src}, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for pid in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, out + err[-4000:]
        outs.append(json.loads(out.split("REPORT=")[1]))
    cfg_, p_, b_, _ = harness.restore_detector_checkpoint(root, device=cuda)
    ref = harness.evaluate_detector(harness.compile_eval_detector(cfg_, p_, b_, device=cuda),
                                    n_images=8, batch=2)
    for rep in outs:
        assert rep["gather"] == "process" and rep["backend"] == "gloo"
        assert se.reports_identical(rep, ref) and rep["launches"][fp.KERNEL] > 0


_FOUR_CARD_CHILD = """
import json, sys
import numpy as np
import torch
from repro_torch import backend
from repro_torch.distributed import collectives as C
from repro_torch.distributed import runtime
from repro_torch.eval import harness
from repro_torch.eval import sharded as se
a = json.loads(sys.argv[1])
ctx = runtime.initialize(coordinator_address=a["addr"], num_processes=4, process_id=a["pid"])
out = {"describe": ctx.describe(), "device": str(ctx.device)}
g, total = C.eval_stats_allgather({"rank": np.array([[ctx.host_id]], np.int32),
                                   "even": np.array([[ctx.host_id % 2 == 0]])},
                                  np.ones((1, 2), np.int32), ctx)
out.update(ranks=g["rank"].reshape(-1).tolist(), even=g["even"].reshape(-1).tolist(),
           total=total.tolist())
pod, data = C.subgroups(ctx, n_pods=2)
x = (torch.arange(24, dtype=torch.float32).reshape(4, 6) / 7.0).to(ctx.device)
out["int8_err"] = float((C.int8_psum(ctx, data)(x) - 2 * x).abs().max())
out["int8_bound"] = 4 * float(x.abs().max()) / 127
z = C.hierarchical_psum(ctx, pod, data)(x)
out["hier_within_1e-5"] = bool(((z - 4 * x).abs() <= 1e-5 * (4 * x).abs()).all())
w = [torch.full((1000,), float(ctx.host_id), device=ctx.device),
     torch.full((7,), float(ctx.host_id), device=ctx.device, dtype=torch.bfloat16)]
C.allreduce_mean_(w, ctx)
out["mean"] = [float(w[0][0]), float(w[1][0])]
cfg, p, b, _ = harness.restore_detector_checkpoint(a["ckpt"], device=ctx.device)
det = harness.compile_eval_detector(cfg, p, b, device=ctx.device)
backend.reset_launches()
out["report"] = harness.evaluate_detector(det, n_images=16, ctx=ctx,
                                          sharded=se.ShardedEvalConfig(n_shards=4, batch=2))
out["launches"] = dict(backend.launches)
# the sharded operations over a (data 2, model 2) DeviceMesh of the four cards
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
from repro_torch.distributed import embedding as de, kvops, sharding as shd
mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
gen = torch.Generator().manual_seed(0)
table, tokens = torch.randn(32, 16, generator=gen), torch.randint(0, 32, (4, 8), generator=gen)
tab = distribute_tensor(table.to(ctx.device), mesh,
                        shd.to_placements(("model", "data"), mesh)).requires_grad_(True)
tok = distribute_tensor(tokens.to(ctx.device), mesh, shd.to_placements(("data", None), mesh))
with shd.use_rules(shd.default_rules(mesh, fsdp=True), mesh=mesh):
    emb = de.embed_lookup(tok, tab)
    (emb.to_local() ** 2).sum().backward()
ref_t = table.clone().requires_grad_(True)
(ref_t[tokens] ** 2).sum().backward()
out["embed_equal"] = bool(torch.equal(emb.full_tensor().detach().cpu(), table[tokens]))
out["embed_grad_err"] = float((tab.grad.full_tensor().cpu() - ref_t.grad).abs().max())
out["embed_grad_local"] = list(tab.grad.to_local().shape)
buf = distribute_tensor(torch.zeros(3, 2, 16, 2, 4, device=ctx.device), mesh,
                        shd.to_placements((None, "data", "model", None, None), mesh))
with shd.use_rules(shd.default_rules(mesh), mesh=mesh):
    kvops.cache_write(buf, torch.full((2, 1, 2, 4), 7.0, device=ctx.device), 2, 13)
want = torch.zeros(3, 2, 16, 2, 4)
want[2, :, 13] = 7.0
out["kv_equal"] = bool(torch.equal(buf.full_tensor().cpu(), want))
xm, wm = torch.randn(8, 16, generator=gen), torch.randn(16, 12, generator=gen)
ws = distribute_tensor(wm.to(ctx.device), mesh, shd.to_placements(("model", None), mesh))
ym = C.overlap_allgather_matmul(mesh, "model")(xm.to(ctx.device), ws)
out["mm_err"] = float((ym.cpu() - xm @ wm).abs().max())
ctx.barrier("done")
print("CHILD=" + json.dumps(out), flush=True)
runtime.shutdown()
"""


@pytest.mark.gpu
def test_four_cards_nccl_and_card_gather(cuda, tmp_path):
    """With four cards: the sharded reduction gathers across the cards in
    one process (``gather == "mesh"``) as the host does; four processes,
    one per card, take the NCCL branch, and their collectives (the eval
    gather, ``int8_psum``/``hierarchical_psum`` on a 2 × 2 grid at
    ``tests/test_distributed.py``'s bounds, the gradient mean) and a
    sharded detector evaluation through the fused kernel agree with one
    process; the sharded embedding (its gradient sharded), ``cache_write``
    and ``overlap_allgather_matmul`` over a (2, 2) DeviceMesh of the four
    cards equal their plain versions. Skips with fewer cards."""
    import json
    import socket
    import subprocess
    import sys

    from repro_torch.eval import detection_map as dm
    from repro_torch.eval import harness
    from repro_torch.eval import sharded as se

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    rng = np.random.default_rng(11)
    preds, gts = [], []
    for _ in range(10):
        g = int(rng.integers(0, 5))
        g_boxes = rng.uniform(0.2, 0.8, (g, 4)).astype(np.float32)
        g_cls = rng.integers(0, 3, g)
        gts.append({"boxes": g_boxes, "classes": g_cls})
        extra = int(rng.integers(0, 6))
        boxes = np.concatenate([g_boxes + rng.normal(0, 0.02, g_boxes.shape).astype(np.float32),
                                rng.uniform(0.2, 0.8, (extra, 4)).astype(np.float32)])
        preds.append({"boxes": boxes, "classes": np.concatenate([g_cls, rng.integers(0, 3, extra)]),
                      "scores": np.round(rng.uniform(0, 1, len(boxes)), 1).astype(np.float32)})
    ref = dm.evaluate_detections(preds, gts, num_classes=3)
    assert ref["map"] > 0
    for k in (2, 4):
        got = se.evaluate_predictions_sharded(preds, gts, num_classes=3,
                                              eval_cfg=se.ShardedEvalConfig(n_shards=k))
        assert got["gather"] == "mesh" and se.reports_identical(got, ref), k

    cfg = dataclasses.replace(smoke_config(), conv_exec="pallas")
    params, bn, _ = demo_weights(cfg, device="cpu")
    root = str(tmp_path / "det")
    harness.save_detector_checkpoint(root, 0, params, bn, cfg)
    _, p_, b_, _ = harness.restore_detector_checkpoint(root, device=cuda)
    single = harness.evaluate_detector(harness.compile_eval_detector(cfg, p_, b_, device=cuda),
                                       n_images=16, batch=2)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _FOUR_CARD_CHILD,
         json.dumps({"addr": f"127.0.0.1:{port}", "pid": pid, "ckpt": root})],
        env={**os.environ, "PYTHONPATH": src}, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(4)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, out + err[-4000:]
            outs.append(json.loads(out.split("CHILD=")[1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, o in enumerate(outs):
        assert o["describe"] == f"host {pid}/4, nccl" and o["device"] == f"cuda:{pid}"
        assert o["ranks"] == [0, 1, 2, 3] and o["even"] == [True, False, True, False]
        assert o["total"] == [4, 4] and o["mean"] == [1.5, 1.5]
        assert o["int8_err"] <= o["int8_bound"] and o["hier_within_1e-5"]
        assert o["report"]["gather"] == "process" and se.reports_identical(o["report"], single)
        assert o["launches"][fp.KERNEL] > 0
        # the sharded ops over NCCL: rows equal, the gradient in the table's
        # layout (this card's 16 x 8 block), the cache row on its owner
        assert o["embed_equal"] and o["embed_grad_err"] <= 1e-5
        assert o["embed_grad_local"] == [16, 8]
        assert o["kv_equal"] and o["mm_err"] <= 1e-4


@pytest.mark.gpu
def test_fsdp_two_cards_nccl(cuda, tmp_path):
    """``launch.train --arch qwen1.5-32b --int8-moments`` at the smoke
    config (the arch's ``fsdp`` kept) in two processes, one card each, over
    NCCL: each holds its slices of the state (at most 0.52 of it) and the
    losses equal one process's within rtol 2e-4, atol 1e-5. Skips with
    fewer than two cards."""
    import json
    import re
    import socket
    import subprocess
    import sys

    from repro_torch.launch import train as launch_train

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    common = ["--arch", "qwen1.5-32b", "--int8-moments", "--steps", "24", "--batch", "8",
              "--seq", "16"]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    losses_out = tmp_path / "two.json"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *common, "--coordinator",
         f"127.0.0.1:{port}", "--num-processes", "2", "--process-id", str(pid),
         "--losses-out", str(losses_out)],
        env={**os.environ, "PYTHONPATH": src}, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, out + err[-4000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, out in enumerate(outs):
        share = re.search(rf"host {pid}/2: state \d+ of \d+ bytes whole \(([0-9.]+)\)", out)
        assert share and float(share.group(1)) <= 0.52, out
    one = launch_train.main(common)["losses"]
    two = json.loads(losses_out.read_text())
    np.testing.assert_allclose(two, one, rtol=2e-4, atol=1e-5)


@pytest.mark.gpu
def test_every_candidate_tile_bit_equal(cuda):
    """Every candidate tile of every distinct fused layer shape of the
    576x1024 detector (batch 1, seeded inputs) equals the shape rule's tile
    and the plain version bit for bit, with the plan the library's plan
    query gives; an illegal tile is refused before launch."""
    from repro_torch import backend
    from repro_torch.configs.snn_det import CONFIG
    from repro_torch.kernels import autotune as at

    seen = set()
    for shape in at.detector_layer_shapes(CONFIG).values():
        if shape.key in seen:
            continue
        seen.add(shape.key)
        x, live, affine = at.synthetic_layer(shape, batch=1, device=cuda)
        kw = dict(kout=shape.kout, kh=shape.kh, kw=shape.kw, bh=shape.bh, bw=shape.bw,
                  t_out=shape.t_out, bn_scale=THR, threshold=THR, leak=LEAK)
        want = fp.fused_pipeline_reference(x, live.w, live.taps, affine, None, **kw)
        rule = at.layer_call(shape, x, live, affine, None, threshold=THR, leak=LEAK)()
        for tile in at.candidates(shape):
            got = at.layer_call(shape, x, live, affine, tile, threshold=THR, leak=LEAK)()
            plan = fp.last_plan()
            torch.cuda.synchronize()
            for ref_ in (rule, want):
                assert torch.equal(got[0], ref_[0]), (shape.key, tile)
                assert torch.equal(got[1].view(torch.int32), ref_[1].view(torch.int32))
            smem, _ = fp.tile_plan(tile, c=x.shape[-1], kp=live.w.shape[2],
                                   n_live=len(live.taps), kh=shape.kh, bh=shape.bh, bw=shape.bw)
            assert 0 < smem <= 227 * 1024
            assert (plan["smem_bytes"], plan["steps_per_pass"]) == (smem, tile.tb)
        if shape.t_in == 1:
            before = backend.launches[fp.KERNEL]
            with pytest.raises(ValueError, match="one conv"):
                at.layer_call(shape, x, live, affine, (4, 2, 4, 2))()
            assert backend.launches[fp.KERNEL] == before
    # a 7x7 layer at C = 256 streams its packed weights: no named tile there
    with pytest.raises(ValueError, match="stream"):
        fp.check_tile((1, 2, 2, 4), t_in=3, c=256, kp=256, n_live=49, kh=7, bh=18, bw=32,
                      packed=True, kblk=128)


@pytest.mark.gpu
def test_detector_shard_check_on_the_card(cuda):
    """Column shards of whole blocks reproduce the whole fused forward bit
    for bit (a block grid that every map divides); where a shard cuts a
    block, the first such layer is reported."""
    from repro_torch.benchmarks import detector_dryrun

    for block, shards, first in (((6, 2), 2, None), ((6, 8), 4, "conv_block")):
        cfg = dataclasses.replace(smoke_config(), conv_exec="pallas", block_hw=block)
        params, bn, rng = demo_weights(cfg, seed=0, device=cuda)
        h, w = cfg.input_hw
        frames = torch.from_numpy((rng.integers(0, 256, (2, h, w, 3)) / 255.0)
                                  .astype(np.float32)).to(cuda)
        det = sy.compile_detector(cfg, params, bn, device=cuda)
        out = detector_dryrun.shard_check(det, frames, shards)
        assert out["first_differing_layer"] == first, out
        assert out["head_bit_equal"] == (first is None)
