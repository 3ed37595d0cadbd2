"""The port's core numerics (quant, pruning, block conv, LIF, tdBN) against
the JAX package on the same numpy inputs. Cases mirror tests/test_core.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import block_conv as jbc  # noqa: E402
from repro.core import lif as jlif  # noqa: E402
from repro.core import pruning as jpruning  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro_torch.core import block_conv as bc  # noqa: E402
from repro_torch.core import lif  # noqa: E402
from repro_torch.core import pruning, quant  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _rand(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------- quant ----
class TestQuant:
    @pytest.mark.parametrize("bits", [2, 4, 8])
    def test_quantize_matches_jax(self, bits):
        x = _rand(0, (3, 3, 8, 16), 3.0)
        got, want = quant.quantize(_t(x), bits=bits), jquant.quantize(jnp.asarray(x), bits=bits)
        np.testing.assert_array_equal(_np(got.q), np.asarray(want.q))
        np.testing.assert_array_equal(_np(got.scale), np.asarray(want.scale))

    def test_dead_slice_scale_guard(self):
        x = _rand(1, (4, 6))
        x[:, 2] = 0.0  # an all-zero channel: scale 1, q 0, no NaN
        got = quant.quantize(_t(x), axis=0)
        want = jquant.quantize(jnp.asarray(x), axis=0)
        np.testing.assert_array_equal(_np(got.q), np.asarray(want.q))
        np.testing.assert_array_equal(_np(got.scale), np.asarray(want.scale))
        assert np.isfinite(_np(got.scale)).all() and (_np(got.q)[:, 2] == 0).all()

    def test_round_half_to_even(self):
        x = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0], np.float32)
        got = quant.quantize(_t(x))
        want = jquant.quantize(jnp.asarray(x))
        np.testing.assert_array_equal(_np(got.q), np.asarray(want.q))

    def test_roundtrip_error_bound(self):
        x = _rand(2, (64,), 3.0)
        qx = quant.quantize(_t(x))
        err = (quant.dequantize(qx) - _t(x)).abs().max()
        assert float(err) <= float(qx.scale) / 2 + 1e-6
        assert qx.q.dtype == torch.int8

    def test_fake_quant_tensor_matches_jax(self):
        x = _rand(3, (3, 3, 4, 8))
        np.testing.assert_array_equal(
            _np(quant.fake_quant_tensor(_t(x))),
            np.asarray(jquant.fake_quant_tensor(jnp.asarray(x))),
        )


# -------------------------------------------------------------- pruning ----
class TestPruning:
    @pytest.mark.parametrize("rate", [0.0, 0.5, 0.8, 0.95])
    def test_prune_by_rate_matches_jax(self, rate):
        w = _rand(4, (3, 3, 8, 8))
        np.testing.assert_array_equal(
            _np(pruning.magnitude_threshold(_t(w), rate)),
            np.asarray(jpruning.magnitude_threshold(jnp.asarray(w), rate)),
        )
        np.testing.assert_array_equal(
            _np(pruning.prune_by_rate(_t(w), rate)),
            np.asarray(jpruning.prune_by_rate(jnp.asarray(w), rate)),
        )

    def test_keeps_largest_strictly_greater(self):
        w = np.array([0.1, -5.0, 0.2, 3.0, 0.2], np.float32)
        got = _np(pruning.prune_by_rate(_t(w), 0.6))
        np.testing.assert_array_equal(got, np.asarray(jpruning.prune_by_rate(jnp.asarray(w), 0.6)))
        np.testing.assert_array_equal(got, [0.0, -5.0, 0.0, 3.0, 0.0])  # ties at thr go

    def test_tree_selects_3x3_only(self):
        params = {"conv3": _rand(5, (3, 3, 8, 8)), "conv1": _rand(6, (1, 1, 8, 8)),
                  "bias": _rand(7, (8,))}
        got = pruning.prune_tree({k: _t(v) for k, v in params.items()}, 0.8)
        want = jpruning.prune_tree({k: jnp.asarray(v) for k, v in params.items()}, 0.8)
        for k in params:
            np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))
        assert pruning.is_spatial_kernel(_t(params["conv3"]))
        assert not pruning.is_spatial_kernel(_t(params["conv1"]))

    def test_bad_rate_raises(self):
        with pytest.raises(ValueError):
            pruning.magnitude_threshold(torch.ones(4), 1.0)


# ----------------------------------------------------------- block conv ----
class TestBlockConv:
    def test_blocks_roundtrip(self):
        x = _rand(8, (2, 12, 16, 3))
        xb = bc.to_blocks(_t(x), 6, 8)
        np.testing.assert_array_equal(_np(xb), np.asarray(jbc.to_blocks(jnp.asarray(x), 6, 8)))
        np.testing.assert_array_equal(_np(bc.from_blocks(xb)), x)

    def test_to_blocks_rejects_ragged(self):
        with pytest.raises(ValueError):
            bc.to_blocks(torch.zeros(1, 10, 16, 1), 6, 8)

    @pytest.mark.parametrize("k", [1, 3])
    def test_block_conv2d_matches_jax(self, k):
        x = _rand(9, (2, 12, 16, 5))
        w = _rand(10, (k, k, 5, 7))
        np.testing.assert_allclose(
            _np(bc.block_conv2d(_t(x), _t(w), block_h=6, block_w=8)),
            np.asarray(jbc.block_conv2d(jnp.asarray(x), jnp.asarray(w), block_h=6, block_w=8)),
            rtol=1e-5, atol=1e-5,
        )

    def test_block_conv2d_integer_inputs_exact(self):
        """Binary spikes × int8 weights: the sums are integers, exact."""
        rng = np.random.default_rng(11)
        x = rng.integers(0, 2, (2, 12, 16, 8)).astype(np.float32)
        w = rng.integers(-128, 128, (3, 3, 8, 4)).astype(np.float32)
        np.testing.assert_array_equal(
            _np(bc.block_conv2d(_t(x), _t(w), block_h=6, block_w=8)),
            np.asarray(jbc.block_conv2d(jnp.asarray(x), jnp.asarray(w), block_h=6, block_w=8)),
        )

    @pytest.mark.parametrize("k", [1, 3])
    def test_conv2d_matches_jax(self, k):
        x = _rand(12, (1, 12, 16, 4))
        w = _rand(13, (k, k, 4, 6))
        np.testing.assert_allclose(
            _np(bc.conv2d(_t(x), _t(w))),
            np.asarray(jbc.conv2d(jnp.asarray(x), jnp.asarray(w))),
            rtol=1e-5, atol=1e-5,
        )

    def test_block_independence(self):
        x = torch.zeros(1, 36, 64, 1)
        w = torch.ones(3, 3, 1, 1)
        y0 = bc.block_conv2d(x, w)
        x2 = x.clone()
        x2[0, 0, 0, 0] = 100.0
        y2 = bc.block_conv2d(x2, w)
        assert torch.equal(y2[:, :, 32:], y0[:, :, 32:])
        assert torch.equal(y2[:, 18:, :], y0[:, 18:, :])


# ------------------------------------------------------------------ LIF ----
class TestLIF:
    def test_fires_above_threshold(self):
        _, s = lif.lif_step(lif.LIFState(v=torch.zeros(4)), torch.tensor([0.6, 0.4, 0.5, -1.0]))
        np.testing.assert_array_equal(_np(s), [1.0, 0.0, 1.0, 0.0])

    def test_hard_reset_zeroes_potential(self):
        st1, s = lif.lif_step(lif.LIFState(v=torch.zeros(1)), torch.tensor([0.7]))
        assert s[0] == 1.0 and st1.v[0] == 0.0

    def test_soft_reset_subtracts(self):
        st1, s = lif.lif_step(lif.LIFState(v=torch.zeros(1)), torch.tensor([0.9]), reset="soft")
        assert s[0] == 1.0
        np.testing.assert_allclose(_np(st1.v), [0.4], atol=1e-6)

    def test_leak_fixed_point(self):
        assert lif.lif_over_time(torch.full((10, 1), 0.3))[0].sum() == 0
        assert lif.lif_over_time(torch.full((10, 1), 0.4))[0].sum() > 0

    @pytest.mark.parametrize("reset", ["hard", "soft", "none"])
    def test_lif_over_time_matches_jax(self, reset):
        x = _rand(14, (4, 3, 5))
        v0 = _rand(15, (3, 5), 0.3)
        s, final = lif.lif_over_time(_t(x), reset=reset, init=lif.LIFState(v=_t(v0)))
        js, jfinal = jlif.lif_over_time(
            jnp.asarray(x), reset=reset, init=jlif.LIFState(v=jnp.asarray(v0))
        )
        np.testing.assert_array_equal(_np(s), np.asarray(js))
        np.testing.assert_allclose(_np(final.v), np.asarray(jfinal.v), rtol=0, atol=1e-6)

    def test_membrane_readout_matches_jax(self):
        x = _rand(16, (3, 2, 4))
        v0 = _rand(17, (2, 4))
        out, fin = lif.membrane_readout(_t(x), v0=_t(v0), return_final=True)
        jout, jfin = jlif.membrane_readout(jnp.asarray(x), v0=jnp.asarray(v0), return_final=True)
        np.testing.assert_allclose(_np(out), np.asarray(jout), rtol=0, atol=1e-6)
        np.testing.assert_allclose(_np(fin), np.asarray(jfin), rtol=0, atol=1e-6)

    def test_membrane_readout_no_reset(self):
        out = lif.membrane_readout(torch.ones(3, 2))
        np.testing.assert_allclose(_np(out), (1.0 + 1.25 + 1.3125) / 3, rtol=1e-6)


class TestTdBN:
    @pytest.mark.parametrize("training", [False, True])
    def test_tdbn_matches_jax(self, training):
        rng = np.random.default_rng(18)
        x = (rng.standard_normal((3, 2, 4, 4, 6)) * 2 + 1).astype(np.float32)
        gamma = rng.standard_normal(6).astype(np.float32)
        beta = rng.standard_normal(6).astype(np.float32)
        mean = rng.standard_normal(6).astype(np.float32)
        var = (rng.random(6) + 0.5).astype(np.float32)
        y, st = lif.tdbn_apply(
            lif.TdBNParams(_t(gamma), _t(beta)),
            lif.TdBNState(_t(mean), _t(var), torch.zeros((), dtype=torch.int32)),
            _t(x), training=training,
        )
        jy, jst = jlif.tdbn_apply(
            jlif.TdBNParams(jnp.asarray(gamma), jnp.asarray(beta)),
            jlif.TdBNState(jnp.asarray(mean), jnp.asarray(var), jnp.zeros((), jnp.int32)),
            jnp.asarray(x), training=training,
        )
        # rsqrt rounds differently in torch and XLA (about a third of
        # inputs by one ulp), so float parity is to a few ulp, not bits
        np.testing.assert_allclose(_np(y), np.asarray(jy), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(st.mean), np.asarray(jst.mean), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_np(st.var), np.asarray(jst.var), rtol=1e-5, atol=1e-6)
        assert int(st.count) == int(jst.count)

    def test_normalizes_to_threshold_scale(self):
        x = _t(_rand(19, (2, 8, 4, 4, 3), 5.0) + 3.0)
        y, _ = lif.tdbn_apply(
            lif.TdBNParams(torch.ones(3), torch.zeros(3)),
            lif.TdBNState(torch.zeros(3), torch.ones(3), torch.zeros((), dtype=torch.int32)),
            x, training=True,
        )
        np.testing.assert_allclose(_np(y.mean(dim=(0, 1, 2, 3))), 0.0, atol=1e-5)
        np.testing.assert_allclose(_np(y.std(dim=(0, 1, 2, 3), unbiased=False)), 0.5, rtol=1e-3)
