"""The port's LM side (``repro_torch.configs``, ``models/layers``,
``transformer``, ``moe``, ``zoo``) against the JAX package on the CPU, at
``smoke_config`` (f32) of qwen1.5-0.5b (dense, QKV bias, tied
embeddings), olmoe-1b-7b (MoE top-2 of 8) and deepseek-moe-16b (MoE with a
shared expert), plus llama3-405b's, the one smoke config with grouped-query
attention (4 heads over 2 KV heads).

JAX builds the parameters; they cross as numpy arrays
(``interop.lm_params_from_numpy``). Tolerances, each against the largest
|value| of the JAX result:

* f32 paths (the naive ``serve_fast=False`` prefill, norms, RoPE,
  attention on f32 K/V, MoE): 1e-5 — what f32 sums in another order and
  R3's rsqrt leave;
* paths through the bf16 KV cache (every decode, and ``serve_fast=True``
  prefill: the cache is bf16 whatever the model's dtype, as in JAX): an f32
  K or V an ulp apart can round to bf16 values 2^-7 apart, and the next
  layer carries that on, so cache rows and int8 scales are held to 2^-7
  and logits to 4e-3 of the largest;
* integer maps (MoE routing ids, dispatch slots, the argmax): exact; the
  int8 KV payload within 1.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import zoo  # noqa: E402

ARCHS = ["qwen1.5-0.5b", "olmoe-1b-7b", "deepseek-moe-16b", "llama3-405b"]
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


def _cache_close(got_cache, want_cache, *, bf16: bool, what=""):
    """Rows of the port's cache against JAX's: bf16 rows within a bf16 ulp
    of the largest value, f32 rows within F32_TOL."""
    for f, got, want in zip("kv", interop.lm_cache_to_numpy(got_cache), want_cache):
        _close(got, np.asarray(want, np.float32), BF16_ULP if bf16 else F32_TOL, f"{what} {f}")


def _cfgs(arch, **kw):
    return (dataclasses.replace(jconfigs.smoke_config(jconfigs.get_config(arch)), **kw),
            dataclasses.replace(configs.smoke_config(configs.get_config(arch)), **kw))


def _models(arch, seed=0, **kw):
    jcfg, cfg = _cfgs(arch, **kw)
    japi, api = jzoo.get_api(jcfg), zoo.get_api(cfg)
    jp = japi.init_params(jax.random.PRNGKey(seed))
    p = interop.lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu")
    return japi, api, jp, p


def _tokens(shape, seed=1):
    return np.random.default_rng(seed).integers(0, 256, shape)


# ------------------------------------------------------------- configs --


def test_registry_equals_jax():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS and configs.ALL_IDS == jconfigs.ALL_IDS
    assert configs.cells() == jconfigs.cells()
    assert configs.cells(include_skipped=True) == jconfigs.cells(include_skipped=True)
    assert configs.SHAPES == {k: configs.ShapeSpec(**dataclasses.asdict(v))
                              for k, v in jconfigs.SHAPES.items()}
    for arch in configs.ARCH_IDS:
        for j, p in ((jconfigs.get_config(arch), configs.get_config(arch)),
                     (jconfigs.smoke_config(jconfigs.get_config(arch)),
                      configs.smoke_config(configs.get_config(arch)))):
            assert dataclasses.asdict(p) == dataclasses.asdict(j), arch
            assert p.hd == j.hd and p.attention_free == j.attention_free
            assert p.n_params() == j.n_params()
            assert p.n_active_params() == j.n_active_params()
            assert p.param_dtype == getattr(torch, str(j.param_dtype))
    det = configs.smoke_config(configs.get_config("snn-det"))
    assert det.input_hw == jconfigs.smoke_config(jconfigs.get_config("snn-det")).input_hw
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-5")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS + ["rwkv6-3b", "zamba2-7b", "llava-next-34b",
                                          "whisper-small"])
def test_init_params_tree_matches_jax(arch, dtype):
    """The port's own seeded init has JAX's structure, shapes and dtypes,
    and JAX's params cross bit for bit (bf16 through f32)."""
    jcfg, cfg = _cfgs(arch, dtype=dtype)
    jp = jzoo.get_api(jcfg).init_params(jax.random.PRNGKey(0))
    p = zoo.get_api(cfg).init_params(0, device="cpu")
    jpaths = jax.tree_util.tree_flatten_with_path(jp)[0]
    ppaths = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda t: t, p, is_leaf=lambda x: isinstance(x, torch.Tensor)),
        is_leaf=lambda x: isinstance(x, torch.Tensor))[0]
    assert [jax.tree_util.keystr(k) for k, _ in jpaths] == \
        [jax.tree_util.keystr(k) for k, _ in ppaths]
    for (_, a), (_, b) in zip(jpaths, ppaths):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
    crossed = interop.lm_params_from_numpy(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp), cfg, device="cpu")
    for (_, a), b in zip(jpaths, jax.tree_util.tree_leaves(
            crossed, is_leaf=lambda x: isinstance(x, torch.Tensor))):
        assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
        np.testing.assert_array_equal(np.asarray(a, np.float32), b.float().numpy())


def test_default_device_is_the_card():
    api = zoo.get_api(configs.smoke_config(configs.get_config("qwen1.5-0.5b")))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_params(0)


# ------------------------------------------------------------- layers --


def test_rmsnorm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    _close(L.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-6).numpy(),
           JL.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6), F32_TOL, "rmsnorm")
    xb = jnp.asarray(x, jnp.bfloat16)
    got = L.rmsnorm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w), 1e-6)
    assert got.dtype == torch.bfloat16
    want = np.asarray(JL.rmsnorm(xb, jnp.asarray(w), 1e-6), np.float32)
    assert np.all(np.abs(got.float().numpy() - want) <= BF16_ULP * np.abs(want))
    q = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    pos = np.stack([np.arange(9), np.arange(100, 109)])
    for theta in (10_000.0, 1_000_000.0):
        np.testing.assert_array_equal(L.rope_freqs(16, theta).numpy(),
                                      np.asarray(JL.rope_freqs(16, theta)))
        _close(L.apply_rope(torch.from_numpy(q), torch.from_numpy(pos), theta).numpy(),
               JL.apply_rope(jnp.asarray(q), jnp.asarray(pos), theta), F32_TOL, "rope")


def _masks(sq, skv):
    causal = np.tril(np.ones((sq, skv), bool))[None, None]
    pos = np.array([skv - sq, 3])  # two slots at their own cache positions
    per_slot = np.arange(skv)[None, None, :] <= (pos[:, None, None]
                                                  + np.arange(sq)[None, :, None])
    return {"causal": causal, "per-slot": per_slot[:, None], "none": None}


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_kv", [4, 2, 1])  # MHA, GQA 2 per group, MQA
@pytest.mark.parametrize("mask", ["causal", "per-slot", "none"])
def test_sdpa_matches_jax(mask, n_kv, kv_dtype):
    jcfg, cfg = _cfgs("qwen1.5-0.5b")
    rng = np.random.default_rng(n_kv)
    sq, skv = (9, 9) if mask == "causal" else (2, 24)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, skv, n_kv, 16)).astype(np.float32)
    v = rng.standard_normal((2, skv, n_kv, 16)).astype(np.float32)
    m = _masks(sq, skv)[mask]
    jk, jv = jnp.asarray(k, kv_dtype), jnp.asarray(v, kv_dtype)
    tk = torch.from_numpy(k).to(getattr(torch, kv_dtype))
    tv = torch.from_numpy(v).to(getattr(torch, kv_dtype))
    want = JL._sdpa(jnp.asarray(q), jk, jv, None if m is None else jnp.asarray(m), jcfg)
    got = L._sdpa(torch.from_numpy(q), tk, tv, None if m is None else torch.from_numpy(m), cfg)
    assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
    _close(got.float().numpy(), np.asarray(want, np.float32),
           F32_TOL if kv_dtype == "float32" else BF16_ULP, f"sdpa {mask}")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("chunks", [(4, 4), (4, 8), (8, 4)])
def test_chunked_sdpa_matches_jax(chunks, causal):
    """Small forced chunks, an S that needs padding, GQA."""
    jcfg, cfg = _cfgs("llama3-405b")
    rng = np.random.default_rng(sum(chunks))
    q = rng.standard_normal((2, 11, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 11, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 11, 2, 16)).astype(np.float32)
    qc, kc = chunks
    want = JL._chunked_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcfg,
                            causal=causal, q_chunk=qc, kv_chunk=kc)
    got = L._chunked_sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), cfg,
                          causal=causal, q_chunk=qc, kv_chunk=kc)
    _close(got.numpy(), want, F32_TOL, "chunked")
    mask = torch.tril(torch.ones((11, 11), dtype=torch.bool))[None, None] if causal else None
    _close(got.numpy(), L._sdpa(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), mask, cfg).numpy(), F32_TOL, "vs sdpa")


# --------------------------------------------------------- prefill/decode --


@pytest.mark.parametrize("serve_fast", [True, False])
def test_long_prefill_takes_the_chunked_path(serve_fast, monkeypatch):
    """Past CHUNKED_ATTN_THRESHOLD query positions, prefill attends through
    ``_chunked_sdpa`` in both packages (the threshold and chunks cut to 8
    and 4 on both sides, so 13 tokens take it): logits against JAX's, and
    against the port's own unchunked prefill."""
    japi, api, jp, p = _models("llama3-405b", serve_fast=serve_fast)
    toks = torch.from_numpy(_tokens((2, 13), 6))
    plain_l, _ = api.prefill_fn(p, toks)
    for mod in (JL, L):
        monkeypatch.setattr(mod, "CHUNKED_ATTN_THRESHOLD", 8)
        monkeypatch.setattr(mod, "Q_CHUNK", 4)
        monkeypatch.setattr(mod, "KV_CHUNK", 4)
    calls = []
    real = L._chunked_sdpa
    monkeypatch.setattr(L, "_chunked_sdpa", lambda *a, **k: calls.append(1) or real(*a, **k))
    jl, _ = japi.prefill_fn(jp, jnp.asarray(toks.numpy(), jnp.int32))
    pl, _ = api.prefill_fn(p, toks)
    assert len(calls) == 2  # one per layer
    tol = BF16_CACHE_LOGITS_TOL if serve_fast else F32_TOL
    _close(pl.numpy(), jl, tol, "chunked vs JAX")
    _close(pl.numpy(), plain_l.numpy(), tol, "chunked vs unchunked")


@pytest.mark.parametrize("serve_fast", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch, serve_fast):
    """Prefill logits and caches, exact-length and bucketed (end-padded
    with valid_len: MoE pad tokens are routed and take capacity slots on
    both sides)."""
    japi, api, jp, p = _models(arch, serve_fast=serve_fast)
    tol = BF16_CACHE_LOGITS_TOL if serve_fast else F32_TOL
    toks = _tokens((2, 7))
    jl, jc = japi.prefill_fn(jp, jnp.asarray(toks, jnp.int32))
    pl, pc = api.prefill_fn(p, torch.from_numpy(toks))
    _close(pl.numpy(), jl, tol, "logits")
    assert (pl.numpy().argmax(-1) == np.asarray(jl).argmax(-1)).all()
    _cache_close(pc, jc, bf16=serve_fast, what="cache")
    padded = np.zeros((1, 16), np.int64)
    padded[0, :5] = toks[0, :5]
    jl, jc = japi.prefill_fn(jp, jnp.asarray(padded, jnp.int32), valid_len=jnp.int32(5))
    pl, pc = api.prefill_fn(p, torch.from_numpy(padded), valid_len=5)
    _close(pl.numpy(), jl, tol, "bucketed logits")
    _cache_close(pc, jc, bf16=serve_fast, what="bucketed cache")


def _two_slot_caches(japi, api, jp, p, prompts, max_seq=32):
    jcache = japi.init_cache(2, max_seq)
    pcache = api.init_cache(2, max_seq, device="cpu")
    firsts = []
    for b, prompt in enumerate(prompts):
        jl, jc = japi.prefill_fn(jp, jnp.asarray(np.asarray(prompt)[None], jnp.int32))
        _, pc = api.prefill_fn(p, torch.from_numpy(np.asarray(prompt)[None]))
        n = len(prompt)
        jcache = type(jcache)(jcache.k.at[:, b, :n].set(jc.k[:, 0].astype(jcache.k.dtype)),
                              jcache.v.at[:, b, :n].set(jc.v[:, 0].astype(jcache.v.dtype)))
        pcache.k[:, b, :n] = pc.k[:, 0].to(pcache.k.dtype)
        pcache.v[:, b, :n] = pc.v[:, 0].to(pcache.v.dtype)
        firsts.append(int(np.asarray(jl).argmax()))
    return jcache, pcache, firsts


@pytest.mark.parametrize("serve_fast", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_per_slot_matches_jax(arch, serve_fast):
    """8 decode steps of two slots at their own positions (5 and 9), each
    side feeding its own greedy token: argmax equal at every step, logits
    and the final caches within tolerance."""
    japi, api, jp, p = _models(arch, serve_fast=serve_fast)
    prompts = [list(_tokens(5, 2)), list(_tokens(9, 3))]
    jcache, pcache, firsts = _two_slot_caches(japi, api, jp, p, prompts)
    tol = BF16_CACHE_LOGITS_TOL  # both paths decode against the bf16 cache
    jtok = ptok = np.asarray(firsts)
    pos = np.array([5, 9])
    jdecode = jax.jit(japi.decode_fn)  # as JAX's Engine runs it
    for step in range(8):
        jl, jcache = jdecode(jp, jcache, jnp.asarray(jtok, jnp.int32), jnp.asarray(pos, jnp.int32))
        pl, pcache = api.decode_fn(p, pcache, torch.from_numpy(ptok), torch.from_numpy(pos))
        _close(pl.numpy(), jl, tol, f"step {step} logits")
        jtok, ptok = np.asarray(jl).argmax(-1), pl.numpy().argmax(-1)
        np.testing.assert_array_equal(ptok, jtok)
        pos = pos + 1
    _cache_close(pcache, jcache, bf16=True, what="decoded cache")
    # rows past each slot's position stay untouched
    assert not pcache.k[:, 0, 13:].any() and not pcache.k[:, 1, 17:].any()


def test_uniform_position_decode_matches_jax():
    """A scalar cache position (the whole batch at one offset), both paths."""
    for serve_fast in (True, False):
        japi, api, jp, p = _models("olmoe-1b-7b", serve_fast=serve_fast)
        toks = _tokens((2, 6), 4)
        _, jc = japi.prefill_fn(jp, jnp.asarray(toks, jnp.int32))
        _, pc = api.prefill_fn(p, torch.from_numpy(toks))
        jcache = japi.init_cache(2, 16)
        jcache = type(jcache)(jcache.k.at[:, :, :6].set(jc.k.astype(jnp.bfloat16)),
                              jcache.v.at[:, :, :6].set(jc.v.astype(jnp.bfloat16)))
        pcache = api.init_cache(2, 16, device="cpu")
        pcache.k[:, :, :6] = pc.k.to(torch.bfloat16)
        pcache.v[:, :, :6] = pc.v.to(torch.bfloat16)
        tok = np.array([3, 5])
        jl, jcache = jax.jit(japi.decode_fn)(jp, jcache, jnp.asarray(tok, jnp.int32),
                                             jnp.int32(6))
        pl, pcache = api.decode_fn(p, pcache, torch.from_numpy(tok), 6)
        _close(pl.numpy(), jl, BF16_CACHE_LOGITS_TOL, "logits")
        _cache_close(pcache, jcache, bf16=True)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "olmoe-1b-7b"])
def test_kv_quant_matches_jax(arch):
    """int8 KV: payload within 1, scales within 2^-7 of the largest, logits
    within the bf16 tolerance (the dequantised K/V are bf16), also after a
    per-slot decode step."""
    japi, api, jp, p = _models(arch, kv_quant=True)
    toks = _tokens((2, 9), 5)
    jl, jc = japi.prefill_fn(jp, jnp.asarray(toks, jnp.int32))
    pl, pc = api.prefill_fn(p, torch.from_numpy(toks))
    assert type(pc).__name__ == "QuantKVCache" and pc.k.dtype == torch.int8

    def check(pc, jc, what):
        got = interop.lm_cache_to_numpy(pc)
        for f in (0, 1):
            assert np.abs(got[f].astype(np.int32) - np.asarray(jc[f], np.int32)).max() <= 1, what
        for f in (2, 3):
            _close(got[f], jc[f], BF16_ULP, f"{what} scale")

    _close(pl.numpy(), jl, BF16_CACHE_LOGITS_TOL, "logits")
    check(pc, jc, "prefill")
    jcache = japi.init_cache(2, 16)
    jcache = type(jcache)(*(a.at[:, :, :9].set(b) for a, b in zip(jcache, jc)))
    pcache = interop.lm_cache_from_numpy(tuple(np.asarray(a) for a in jcache), device="cpu")
    tok, pos = np.array([1, 2]), np.array([9, 4])
    jl, jcache = japi.decode_fn(jp, jcache, jnp.asarray(tok, jnp.int32),
                                jnp.asarray(pos, jnp.int32))
    pl, pcache = api.decode_fn(p, pcache, torch.from_numpy(tok), torch.from_numpy(pos))
    _close(pl.numpy(), jl, BF16_CACHE_LOGITS_TOL, "decode logits")
    check(pcache, jcache, "decode")


# ----------------------------------------------------------------- MoE --


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-moe-16b"])
def test_route_ids_exact(arch):
    jcfg, cfg = _cfgs(arch)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((48, 64)).astype(np.float32)
    w = rng.standard_normal((64, cfg.n_experts)).astype(np.float32) / 8
    jids, jgates, jaux = jmoe.route(jnp.asarray(x), jnp.asarray(w), jcfg)
    ids, gates, aux = moe.route(torch.from_numpy(x), torch.from_numpy(w), cfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(gates.numpy(), jgates, F32_TOL, "gates")
    _close(aux.numpy(), jaux, F32_TOL, "aux")


def test_route_breaks_ties_by_lower_index():
    """Equal probabilities: jax.lax.top_k takes the lower expert index
    first; so does the port (torch.topk promises no order)."""
    jcfg, cfg = _cfgs("olmoe-1b-7b")
    x = np.zeros((5, 64), np.float32)  # every logit 0: all 8 experts tie
    x[1, :] = 1.0
    w = np.zeros((64, 8), np.float32)
    w[:, 5] = w[:, 6] = 1.0  # row 1: experts 5 and 6 tie at the top
    jids, _, _ = jmoe.route(jnp.asarray(x), jnp.asarray(w), jcfg)
    ids, _, _ = moe.route(torch.from_numpy(x), torch.from_numpy(w), cfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert ids[0].tolist() == [0, 1] and ids[1].tolist() == [5, 6]


def _skewed_ids(t, k, e, seed):
    rng = np.random.default_rng(seed)
    probs = np.arange(e, 0, -1, dtype=np.float64) ** 3
    return np.stack([rng.choice(e, size=k, replace=False, p=probs / probs.sum())
                     for _ in range(t)])


@pytest.mark.parametrize("case", ["random", "skewed-overflow", "all-to-expert-0", "decode-8"])
def test_dispatch_group_maps_equal_jax(case):
    """slot_token and entry_slot equal JAX's in integers, with the same
    capacity — including overflow, where the entries that drop must be
    exactly JAX's (the all-to-expert-0 case is tests/test_models.py's)."""
    jcfg, cfg = _cfgs("olmoe-1b-7b")
    e, k = cfg.n_experts, cfg.top_k
    if case == "random":
        ids = np.stack([np.random.default_rng(i).choice(e, k, replace=False) for i in range(40)])
    elif case == "skewed-overflow":
        ids = _skewed_ids(64, k, e, 1)
    elif case == "all-to-expert-0":
        ids = np.zeros((64, k), np.int64)
    else:
        ids = _skewed_ids(8, k, e, 2)
    t = ids.shape[0]
    js, je, jc = jmoe.dispatch_group(jnp.asarray(ids, jnp.int32), t, jcfg)
    ps, pe, pc = moe.dispatch_group(torch.from_numpy(ids), t, cfg)
    assert pc == jc
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pe.numpy(), np.asarray(je))
    dropped = int((pe < 0).sum())
    if case in ("skewed-overflow", "all-to-expert-0"):
        assert dropped > 0
    assert int((pe >= 0).sum()) + dropped == t * k


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-moe-16b"])
def test_moe_mlp_matches_jax(arch):
    japi, api, jp, p = _models(arch)
    jcfg, cfg = japi.cfg, api.cfg
    x = np.random.default_rng(3).standard_normal((2, 24, 64)).astype(np.float32)
    jlp = jax.tree_util.tree_map(lambda a: a[1], jp["layers"]["moe"])
    jout, jaux = jmoe.moe_mlp(jnp.asarray(x), jlp, jcfg)
    out, aux = moe.moe_mlp(torch.from_numpy(x), {k: (v[1] if not isinstance(v, dict) else
                                                     {kk: vv[1] for kk, vv in v.items()})
                                                 for k, v in p["layers"]["moe"].items()}, cfg)
    _close(out.numpy(), jout, F32_TOL, "moe out")
    _close(aux.numpy(), jaux, F32_TOL, "aux")
