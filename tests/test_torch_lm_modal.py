"""The port's modal LM families against the JAX package on the CPU: whisper
(audio: ``models/whisper.py``) and llava (vlm: ``models/llava.py``), the
attention modes only they use (``causal=False``, ``cross_kv``), the
``extra_embeds`` prefix of ``transformer.py``, each family's ``zoo`` API,
and the Engine's refusal of both families (ROADMAP R10) — at
``smoke_config`` (f32) of whisper-small and llava-next-34b.

JAX builds the parameters; they cross as numpy arrays
(``interop.lm_params_from_numpy``); tokens, frames and patches are drawn
with numpy from a seed. Tolerances, each against the largest |value| of the
JAX result: F32_TOL (1e-5) on f32 paths (the encoder, ``cross_kv``, the
naive prefill, the loss); BF16_CACHE_LOGITS_TOL (4e-3) on paths through
the bf16 KV cache (llava's ``serve_fast`` prefill, every decode), as
tests/test_torch_lm.py; greedy token streams equal.
"""
import contextlib
import dataclasses
import functools
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import llava as jllava  # noqa: E402
from repro.models import whisper as jwhisper  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import llava, whisper, zoo  # noqa: E402
from repro_torch.serve import Engine  # noqa: E402

F32_TOL = 1e-5
BF16_CACHE_LOGITS_TOL = 4e-3
BF16_ULP = 2.0 ** -7


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    bound = tol * float(np.abs(want).max())
    assert err <= bound, f"{what}: max |Δ| {err} > {bound}"


def _cfgs(arch, **kw):
    return (dataclasses.replace(jconfigs.smoke_config(jconfigs.get_config(arch)), **kw),
            dataclasses.replace(configs.smoke_config(configs.get_config(arch)), **kw))


def _models(arch, seed=0, **kw):
    jcfg, cfg = _cfgs(arch, **kw)
    japi, api = jzoo.get_api(jcfg), zoo.get_api(cfg)
    jp = japi.init_params(jax.random.PRNGKey(seed))
    p = interop.lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu")
    return japi, api, jp, p


def _randn(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _tokens(shape, seed=1):
    return np.random.default_rng(seed).integers(0, 256, shape)


def _extra(cfg, b, seed=2):
    """The stub frontend's output: frames (B, encoder_seq, d_model) or
    patches (B, n_patches, D_VISION)."""
    if cfg.family == "audio":
        return _randn((b, cfg.encoder_seq, cfg.d_model), seed)
    return _randn((b, cfg.n_patches, llava.D_VISION), seed, 0.5)


# -------------------------------------------------------------- attention --


@pytest.mark.parametrize("qkv_bias", [False, True])
@pytest.mark.parametrize("mode", ["non-causal", "cross"])
def test_attention_modes_match_jax(mode, qkv_bias):
    """``causal=False`` self-attention (whisper's encoder) and ``cross_kv``
    attention over another sequence's K/V (whisper's decoder), with and
    without QKV biases, grouped-query (4 heads over 2 KV heads)."""
    jcfg, cfg = _cfgs("whisper-small", qkv_bias=qkv_bias, n_kv_heads=2)
    jp = JL.attn_init(jax.random.PRNGKey(0), jcfg)
    if qkv_bias:  # non-zero biases, so they count
        jp = {k: (v + 0.1 if k.startswith("b") else v) for k, v in jp.items()}
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = _randn((2, 9, cfg.d_model), 1)
    pos = np.broadcast_to(np.arange(9), (2, 9))
    cross = None
    if mode == "cross":
        k, v = _randn((2, 13, 2, cfg.hd), 3), _randn((2, 13, 2, cfg.hd), 4)
        cross = (k, v)
    jout, jkv = JL.attention(jnp.asarray(x), jp, jcfg, positions=jnp.asarray(pos), causal=False,
                             cross_kv=None if cross is None else JL.KVSlice(
                                 *(jnp.asarray(a) for a in cross)))
    out, kv = L.attention(torch.from_numpy(x), p, cfg, positions=torch.from_numpy(pos.copy()),
                          causal=False, cross_kv=None if cross is None else L.KVSlice(
                              *(torch.from_numpy(a) for a in cross)))
    _close(out.numpy(), jout, F32_TOL, mode)
    if mode == "cross":
        assert kv is None and jkv is None
    else:
        _close(kv.k.numpy(), jkv.k, F32_TOL, "k")


# ---------------------------------------------------------------- whisper --


def test_whisper_encode_cross_kv_decoder_match_jax():
    """``encode`` on seeded frames, ``cross_kv`` from its output, and
    ``decoder_forward`` with ``collect_kv``: states, cross K/V, logits and
    the self-attention cache, all f32."""
    japi, api, jp, p = _models("whisper-small")
    jcfg, cfg = japi.cfg, api.cfg
    frames = _extra(cfg, 2)
    jenc = jax.jit(functools.partial(jwhisper.encode, cfg=jcfg))(jp, jnp.asarray(frames))
    enc = whisper.encode(p, torch.from_numpy(frames), cfg)
    _close(enc.numpy(), jenc, F32_TOL, "encoder")
    jcross = jwhisper.cross_kv(jp, jenc, jcfg)
    cross = whisper.cross_kv(p, torch.from_numpy(np.asarray(jenc)), cfg)
    for a, b, f in zip(cross, jcross, "kv"):
        _close(a.numpy(), b, F32_TOL, f"cross {f}")
    toks = _tokens((2, 6))
    jl, jc = jax.jit(functools.partial(jwhisper.decoder_forward, cfg=jcfg, collect_kv=True))(
        jp, jnp.asarray(toks, jnp.int32), cross=jcross)
    pl, pc = whisper.decoder_forward(p, torch.from_numpy(toks), cfg,
                                     tuple(torch.from_numpy(np.asarray(a)) for a in jcross),
                                     collect_kv=True)
    _close(pl.numpy(), jl, F32_TOL, "logits")
    for got, want, f in zip(interop.lm_cache_to_numpy(pc), jc, pc._fields):
        _close(got, np.asarray(want), F32_TOL, f)


# ------------------------------------------------------------------ llava --


def test_project_patches_matches_jax():
    japi, api, jp, p = _models("llava-next-34b")
    patches = _extra(api.cfg, 2)
    _close(llava.project_patches(p, torch.from_numpy(patches)).numpy(),
           jllava.project_patches(jp, jnp.asarray(patches)), F32_TOL, "projected patches")


@pytest.mark.parametrize("serve_fast", [True, False])
def test_vlm_prefill_with_patches_matches_jax(serve_fast):
    """tests/test_serve_fast.py:23's llava case on both packages: the
    prefill with patches on the fast path (bf16 cache) and the naive path
    (f32 K/V), logits and the cache of P + T rows, against JAX's; and the
    two paths against each other, argmax equal."""
    japi, api, jp, p = _models("llava-next-34b", serve_fast=serve_fast)
    cfg = api.cfg
    toks, patches = _tokens((2, 7)), _extra(cfg, 2)
    jl, jc = japi.prefill_fn(jp, jnp.asarray(toks, jnp.int32), jnp.asarray(patches))
    pl, pc = api.prefill_fn(p, torch.from_numpy(toks), torch.from_numpy(patches))
    tol = BF16_CACHE_LOGITS_TOL if serve_fast else F32_TOL
    _close(pl.numpy(), jl, tol, "logits")
    assert pc.k.shape[2] == cfg.n_patches + 7
    for got, want, f in zip(interop.lm_cache_to_numpy(pc), jc, "kv"):
        _close(got, np.asarray(want, np.float32), BF16_ULP if serve_fast else F32_TOL, f)
    other = zoo.get_api(dataclasses.replace(cfg, serve_fast=not serve_fast))
    ol, oc = other.prefill_fn(p, torch.from_numpy(toks), torch.from_numpy(patches))
    _close(ol.numpy(), pl.numpy(), BF16_CACHE_LOGITS_TOL, "fast vs naive")
    assert (ol.argmax(-1) == pl.argmax(-1)).all()


@pytest.mark.parametrize("arch", ["llava-next-34b", "whisper-small"])
def test_modal_loss_fn_matches_jax(arch):
    """``loss_fn`` with patches (the prefix carries no loss) or frames."""
    japi, api, jp, p = _models(arch)
    b = {"tokens": _tokens((2, 12), 3).astype(np.int32),
         "labels": _tokens((2, 12), 4).astype(np.int32)}
    b["patches" if api.cfg.family == "vlm" else "frames"] = _extra(api.cfg, 2)
    jloss = float(japi.loss_fn(jp, jax.tree_util.tree_map(jnp.asarray, b)))
    ploss = float(api.loss_fn(p, {k: torch.from_numpy(v) for k, v in b.items()}))
    _close(ploss, jloss, F32_TOL, "loss")


# ------------------------------------------------------ greedy at the API --


def _greedy(api, params, toks, extra, n, max_seq, *, jax_side):
    """Prefill with the frames or patches into a ``max_seq`` bf16 cache (the
    JAX side copies its prefill cache in), then ``n`` greedy decode steps at
    one position for the batch: the streams (B, n + 1) and each step's
    logits."""
    b, t = toks.shape
    if jax_side:
        logits, small = api.prefill_fn(params, jnp.asarray(toks, jnp.int32), jnp.asarray(extra))
        cache = api.init_cache(b, max_seq)
        rows = small[0].shape[2]
        cache = type(cache)(*(
            c.at[:, :, :rows].set(s.astype(c.dtype)) if s.shape[2] == rows and c.shape != s.shape
            else s.astype(c.dtype) for c, s in zip(cache, small)))
        decode = jax.jit(api.decode_fn)
        argmax = lambda x: np.asarray(x).argmax(-1)  # noqa: E731
    else:
        cache = api.init_cache(b, max_seq, device="cpu")
        logits, cache = api.prefill_fn(params, torch.from_numpy(toks), torch.from_numpy(extra),
                                       cache=cache)
        rows = t + (extra.shape[1] if api.cfg.family == "vlm" else 0)
        decode = api.decode_fn
        argmax = lambda x: x.numpy().argmax(-1)  # noqa: E731
    seq, rec = [argmax(logits)], [np.asarray(logits if jax_side else logits.numpy())]
    for i in range(n):
        tok = seq[-1]
        tok = jnp.asarray(tok, jnp.int32) if jax_side else torch.from_numpy(tok)
        logits, cache = decode(params, cache, tok, rows + i)
        seq.append(argmax(logits))
        rec.append(np.asarray(logits if jax_side else logits.numpy()))
    return np.stack(seq, 1), rec


@pytest.mark.parametrize("arch", ["llava-next-34b", "whisper-small"])
def test_modal_greedy_streams_equal_jax(arch):
    """The API's prefill (with patches or frames) then 6 ``decode_fn`` steps
    on the bf16 cache, each side feeding its own tokens: streams equal,
    logits within the bf16-cache bound at every step."""
    japi, api, jp, p = _models(arch)
    toks, extra = _tokens((2, 5), 8), _extra(api.cfg, 2, 9)
    want, jrec = _greedy(japi, jp, toks, extra, 6, 32, jax_side=True)
    got, rec = _greedy(api, p, toks, extra, 6, 32, jax_side=False)
    np.testing.assert_array_equal(got, want)
    for i, (a, b) in enumerate(zip(rec, jrec)):
        _close(a, b, BF16_CACHE_LOGITS_TOL, f"step {i}")


def test_modal_caches_cross_both_ways():
    """A ``WhisperCache`` from JAX to the port and back, bit for bit."""
    jcfg, cfg = _cfgs("whisper-small")
    jcache = jax.tree_util.tree_map(lambda a: _randn(a.shape, a.ndim).astype(a.dtype),
                                    jzoo.get_api(jcfg).init_cache(2, 8))
    pcache = interop.lm_cache_from_numpy(jcache, device="cpu")
    want = zoo.get_api(cfg).init_cache(2, 8, device="cpu")
    assert type(pcache) is whisper.WhisperCache
    for a, b in zip(tu.leaves(pcache), tu.leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
    for got, w in zip(interop.lm_cache_to_numpy(pcache), jcache):
        np.testing.assert_array_equal(got, np.asarray(w, np.float32))


# --------------------------------------------------------- Engine refusal --


@pytest.mark.parametrize("arch", ["llava-next-34b", "whisper-small"])
def test_engine_refuses_vlm_and_audio(arch):
    """JAX's Engine fails at the first admit (its prefill gets no patches or
    frames, ROADMAP R10); the port refuses when the core is built, and the
    serve CLI before drawing weights."""
    _, cfg = _cfgs(arch)
    p = zoo.get_api(cfg).init_params(0, device="cpu")
    with pytest.raises(ValueError, match="ROADMAP.md R10"):
        Engine(cfg, p, n_slots=2, max_seq=32)
    with pytest.raises(ValueError, match="ROADMAP.md R10"), \
            contextlib.redirect_stdout(io.StringIO()):
        launch.main(["--arch", arch, "--device", "cpu"])
