"""The port's CUDA kernels against their plain PyTorch versions on the card,
bit for bit: the fused pipeline in both weight modes (T up to 16), and the
gated one-to-all conv. Needs a CUDA device and nothing of JAX; skips
without a card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fused_pipeline as fp  # noqa: E402
from repro_torch.kernels import gated_one_to_all as g2a  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

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
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["predecoded", "packed"])
@pytest.mark.parametrize("name", list(CASES))
def test_fused_pipeline_kernel_equals_plain_version(cuda, name, mode):
    kh, cin, kout, t_in, t_out, u8, reset, warm, dead, (h, w), (bh, bw) = CASES[name]
    rng = np.random.default_rng(0)
    wq = rng.integers(-127, 128, (kh, kh, cin, kout)).astype(np.int8)
    wq[rng.random(wq.shape) > 0.3] = 0
    for t in dead:
        wq[t // kh, t % kh] = 0
    pw = ops.pack_conv_weights(wq, kblk=128)
    live = ops.predecode(pw, cuda)
    x = rng.integers(0, 256 if u8 else 2, (t_in, 2, h, w, pw.cin)).astype(np.uint8)
    x[..., cin:] = 0
    rows = np.stack([
        np.full(kout, 1.0 / (kh * kh * cin * (127 if u8 else 1)), np.float32),
        rng.normal(size=kout), rng.random(kout) + 0.5, rng.normal(size=kout),
        rng.normal(size=kout),
    ]).astype(np.float32)
    affine = ops.pad_affine(torch.tensor(rows, device=cuda), pw.kp)
    v0 = torch.tensor(rng.normal(size=(2, h, w, kout)), dtype=torch.float32,
                      device=cuda) if warm else None
    args = (torch.from_numpy(x).to(cuda), live.w, live.taps, affine, v0)
    kw = dict(kout=kout, kh=kh, kw=kh, bh=bh, bw=bw, t_out=t_out, bn_scale=THR,
              threshold=THR, leak=LEAK, reset=reset, v_init=0.25)
    if mode == "packed":
        counter, launch = fp.KERNEL_PACKED, lambda: fp.fused_pipeline_packed(
            args[0], torch.from_numpy(pw.maskp).to(cuda),
            torch.from_numpy(pw.vals).to(cuda), pw.tap_alive, affine, v0, **kw)
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
    oracle = g2a.gated_conv_ref(xt[..., :cin], torch.from_numpy(wq).to(cuda), bh=bh, bw=bw)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(got.float(), oracle)
