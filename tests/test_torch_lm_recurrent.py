"""The port's recurrent LM families against the JAX package on the CPU:
rwkv6 (ssm: ``models/rwkv6.py``) and mamba2 with the zamba2 hybrid
(``models/mamba2.py``, ``hybrid.py``), module by module, through each
family's ``zoo`` API, and served by ``Engine`` — at ``smoke_config`` (f32)
of rwkv6-3b and zamba2-7b (also with 3 layers, so the hybrid has a tail).

JAX builds the parameters; they cross as numpy arrays
(``interop.lm_params_from_numpy``); every other input is drawn with numpy
from a seed. Tolerances, each against the largest |value| of the JAX
result:

* f32 paths — the chunked scans (the same formulation on both sides: the
  ±60 ``exp`` clips and the pads included), the T=1 recurrences, the
  recurrent states, rwkv6's prefill and decode, the hybrid's prefill and
  loss: F32_TOL (1e-5);
* the hybrid's decode reads its shared attention's KV from the bf16 cache:
  logits within BF16_CACHE_LOGITS_TOL (4e-3), as tests/test_torch_lm.py;
* greedy token streams: equal.

The mirrors of tests/test_models.py's chunked-vs-stepwise checks hold the
port to itself with JAX's tolerances.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import hybrid as jhyb  # noqa: E402
from repro.models import mamba2 as jmamba  # noqa: E402
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.models import hybrid, mamba2, rwkv6, zoo  # noqa: E402
from repro_torch.serve import Engine, Request  # noqa: E402

F32_TOL = 1e-5
BF16_CACHE_LOGITS_TOL = 4e-3


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    bound = tol * float(np.abs(want).max())
    assert err <= bound, f"{what}: max |Δ| {err} > {bound}"


def _tree_close(got, want, tol, what=""):
    """Every leaf of a port tree against the JAX tree's leaf at its path."""
    got_np = interop.lm_cache_to_numpy(got)
    jpaths = jax.tree_util.tree_flatten_with_path(want)[0]
    ppaths, pleaves = tu.flatten_with_paths(got_np)
    assert [jax.tree_util.keystr(k) for k, _ in jpaths] == [p.replace("/", "") for p in ppaths]
    for (k, w), g in zip(jpaths, pleaves):
        _close(g, np.asarray(w, np.float32), tol, f"{what} {jax.tree_util.keystr(k)}")


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


def _layer(tree, *idx):
    """(JAX, port) views of one layer of stacked numpy params."""
    lp = jax.tree_util.tree_map(lambda a: np.asarray(a)[idx], tree)
    return (jax.tree_util.tree_map(jnp.asarray, lp),
            tu.tree_map(lambda a: torch.from_numpy(np.array(a)), lp))


# ------------------------------------------------------------------- rwkv6 --


@pytest.mark.parametrize("t,chunk", [(16, 8), (64, 64), (128, 64)])
def test_wkv_chunked_matches_jax(t, chunk):
    rng = np.random.default_rng(t)
    b, h, hd = 2, 2, 64
    r, k, v = (_randn((b, t, h, hd), s, 0.5) for s in (1, 2, 3))
    w = np.exp(-np.exp(rng.uniform(-7, -1, (b, t, h, hd)))).astype(np.float32)
    u = _randn((h, hd), 4, 0.3)
    s0 = _randn((b, h, hd, hd), 5, 0.2)
    jy, js = jrwkv._wkv_chunked(*(jnp.asarray(a) for a in (r, k, v, w, u, s0)), chunk=chunk)
    y, s = rwkv6._wkv_chunked(*(torch.from_numpy(a) for a in (r, k, v, w, u, s0)), chunk=chunk)
    _close(y.numpy(), jy, F32_TOL, "y")
    _close(s.numpy(), js, F32_TOL, "state")


def _rwkv_state(cfg, b, seed):
    h = rwkv6.n_heads(cfg)
    return (_randn((b, h, 64, 64), seed, 0.2), _randn((b, cfg.d_model), seed + 1),
            _randn((b, cfg.d_model), seed + 2))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("t", [1, 20, 70])  # the recurrence; one padded chunk; two chunks
def test_rwkv_block_matches_jax(t, with_state):
    jcfg, cfg = _cfgs("rwkv6-3b")
    jp = jrwkv.init_params(jax.random.PRNGKey(0), jcfg)
    jlp, lp = _layer(jp["layers"], 1)
    x = _randn((2, t, cfg.d_model), t, 0.5)
    jst = st = None
    if with_state:
        arrays = _rwkv_state(cfg, 2, 7)
        jst = jrwkv.RWKVState(*(jnp.asarray(a) for a in arrays))
        st = rwkv6.RWKVState(*(torch.from_numpy(a) for a in arrays))
    jy, jns = jax.jit(functools.partial(jrwkv.rwkv_block, cfg=jcfg))(jnp.asarray(x), jlp,
                                                                      state=jst)
    y, ns = rwkv6.rwkv_block(torch.from_numpy(x), lp, cfg, state=st)
    _close(y.numpy(), jy, F32_TOL, "x")
    _tree_close(ns, jns, F32_TOL, "state")


def test_wkv_chunked_matches_stepwise():
    """tests/test_models.py:136 on the port: the chunked block (chunk 8,
    T=20) against 20 single-token steps."""
    _, cfg = _cfgs("rwkv6-3b")
    lp = rwkv6.rwkv_init(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(_randn((1, 20, cfg.d_model), 1, 0.3))
    y_chunk, st_chunk = rwkv6.rwkv_block(x, lp, cfg, chunk=8)
    st = rwkv6.init_state(cfg, 1, device="cpu")
    outs = []
    for t in range(20):
        y_t, st = rwkv6.rwkv_block(x[:, t:t + 1], lp, cfg, state=st)
        outs.append(y_t)
    y_step = torch.cat(outs, dim=1)
    np.testing.assert_allclose(y_chunk.numpy(), y_step.numpy(), rtol=2e-2, atol=5e-3)
    np.testing.assert_allclose(st_chunk.s.numpy(), st.s.numpy(), rtol=2e-2, atol=5e-3)


@pytest.mark.parametrize("t_len", [2, 9, 17, 30])
def test_wkv_chunk_size_invariance(t_len):
    """tests/test_models.py:155 on the port (four lengths of its 2..30)."""
    _, cfg = _cfgs("rwkv6-3b")
    lp = rwkv6.rwkv_init(torch.Generator().manual_seed(2), cfg)
    x = torch.from_numpy(_randn((1, t_len, cfg.d_model), t_len, 0.2))
    y1, _ = rwkv6.rwkv_block(x, lp, cfg, chunk=4)
    y2, _ = rwkv6.rwkv_block(x, lp, cfg, chunk=16)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=2e-2, atol=2e-3)


# ------------------------------------------------------------------ mamba2 --


@pytest.mark.parametrize("t,chunk", [(16, 8), (128, 128), (256, 128)])
def test_ssd_chunked_matches_jax(t, chunk):
    rng = np.random.default_rng(t)
    b, nh, hd, ds = 2, 4, 16, 16
    xh = _randn((b, t, nh, hd), 1, 0.5)
    dt = rng.uniform(0.0, 0.5, (b, t, nh)).astype(np.float32)
    a_log = _randn((nh,), 2, 0.5)
    b_in, c_in = _randn((b, t, ds), 3, 0.5), _randn((b, t, ds), 4, 0.5)
    d_skip = _randn((nh,), 5)
    h0 = _randn((b, nh, hd, ds), 6, 0.2)
    args = (xh, dt, a_log, b_in, c_in, d_skip, h0)
    jy, jh = jmamba._ssd_chunked(*(jnp.asarray(a) for a in args), chunk=chunk)
    y, h = mamba2._ssd_chunked(*(torch.from_numpy(a) for a in args), chunk=chunk)
    _close(y.numpy(), jy, F32_TOL, "y")
    _close(h.numpy(), jh, F32_TOL, "state")


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("t", [1, 24, 130])  # the recurrence; one padded chunk; two chunks
def test_mamba_forward_matches_jax(t, with_state):
    jcfg, cfg = _cfgs("zamba2-7b")
    jp = jhyb.init_params(jax.random.PRNGKey(0), jcfg)
    jlp, lp = _layer(jp["mamba"], 0, 1)
    x = _randn((2, t, cfg.d_model), t, 0.5)
    jst = st = None
    if with_state:
        shapes = mamba2.init_state(cfg, 2, device="cpu")
        arrays = [_randn(tuple(a.shape), 8 + i, 0.3) for i, a in enumerate(shapes)]
        jst = jmamba.MambaState(*(jnp.asarray(a) for a in arrays))
        st = mamba2.MambaState(*(torch.from_numpy(a) for a in arrays))
    jy, jns = jax.jit(functools.partial(jmamba.mamba_forward, cfg=jcfg))(jnp.asarray(x), jlp,
                                                                         state=jst)
    y, ns = mamba2.mamba_forward(torch.from_numpy(x), lp, cfg, state=st)
    _close(y.numpy(), jy, F32_TOL, "x")
    _tree_close(ns, jns, F32_TOL, "state")


def test_ssd_chunked_matches_stepwise():
    """tests/test_models.py:115 on the port: chunk 8 over T=24 against 24
    single-token steps."""
    _, cfg = _cfgs("zamba2-7b")
    p = mamba2.mamba_init(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(_randn((1, 24, cfg.d_model), 1, 0.3))
    y_chunk, st_chunk = mamba2.mamba_forward(x, p, cfg, chunk=8)
    st = mamba2.init_state(cfg, 1, device="cpu")
    outs = []
    for t in range(24):
        y_t, st = mamba2.mamba_forward(x[:, t:t + 1], p, cfg, state=st)
        outs.append(y_t)
    y_step = torch.cat(outs, dim=1)
    np.testing.assert_allclose(y_chunk.numpy(), y_step.numpy(), rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(st_chunk.h.numpy(), st.h.numpy(), rtol=2e-2, atol=2e-3)


# ------------------------------------------------------------------ hybrid --


@pytest.mark.parametrize("n_layers", [2, 3])  # no tail; a one-layer tail
def test_hybrid_forward_and_cached_decode_match_jax(n_layers):
    """Prefill (``forward`` with ``collect_kv``: logits and every state and
    KV leaf in f32), then two per-slot decode steps through
    ``cached_decode`` on the bf16 serving cache (logits, states, KV rows)."""
    japi, api, jp, p = _models("zamba2-7b", n_layers=n_layers)
    jcfg, cfg = japi.cfg, api.cfg
    toks = _tokens((2, 9))
    jl, jc = jax.jit(functools.partial(jhyb.forward, cfg=jcfg, collect_kv=True))(
        jp, jnp.asarray(toks, jnp.int32))
    pl, pc = hybrid.forward(p, torch.from_numpy(toks), cfg, collect_kv=True)
    _close(pl.numpy(), jl, F32_TOL, "prefill logits")
    _tree_close(pc, jc, F32_TOL, "prefill cache")
    assert (pc.tail is None) == (n_layers == 2)

    jcache = jhyb.init_cache(jcfg, 2, 16)
    jcache = jcache._replace(mamba=jc.mamba, tail=jc.tail,
                             attn_k=jcache.attn_k.at[:, :, :9].set(jc.attn_k.astype(jnp.bfloat16)),
                             attn_v=jcache.attn_v.at[:, :, :9].set(jc.attn_v.astype(jnp.bfloat16)))
    pcache = interop.lm_cache_from_numpy(jax.tree_util.tree_map(np.asarray, jcache), device="cpu")
    pos = np.array([9, 5])
    tok = np.asarray(jl)[:, -1].argmax(-1)
    jdecode = jax.jit(functools.partial(jhyb.cached_decode, cfg=jcfg))
    for step in range(2):
        jlg, jcache = jdecode(jp, jnp.asarray(tok, jnp.int32), cache=jcache,
                              pos=jnp.asarray(pos, jnp.int32))
        plg, pcache = hybrid.cached_decode(p, torch.from_numpy(tok), cfg, pcache,
                                           torch.from_numpy(pos))
        _close(plg.numpy(), jlg, BF16_CACHE_LOGITS_TOL, f"decode {step}")
        tok = np.asarray(jlg).argmax(-1)
        np.testing.assert_array_equal(plg.numpy().argmax(-1), tok)
        pos = pos + 1
    _tree_close(pcache, jcache, BF16_CACHE_LOGITS_TOL, "decoded cache")


# ------------------------------------------------------- the families' APIs --


@pytest.mark.parametrize("serve_fast", [True, False])
@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-7b"])
def test_api_loss_prefill_decode_match_jax(arch, serve_fast):
    """``loss_fn`` on a (2, 24) batch; ``prefill_fn`` on a 2×9 prompt (logits
    and the state); 6 greedy ``decode_fn`` steps at one position for the
    batch, each side feeding its own tokens: equal streams."""
    japi, api, jp, p = _models(arch, serve_fast=serve_fast)
    toks = _tokens((2, 24), 3)
    b = {"tokens": toks.astype(np.int32), "labels": _tokens((2, 24), 4).astype(np.int32)}
    jloss = float(japi.loss_fn(jp, jax.tree_util.tree_map(jnp.asarray, b)))
    ploss = float(api.loss_fn(p, {k: torch.from_numpy(v) for k, v in b.items()}))
    _close(ploss, jloss, F32_TOL, "loss")

    prompt = toks[:, :9]
    jl, jc = japi.prefill_fn(jp, jnp.asarray(prompt, jnp.int32))
    pl, pc = api.prefill_fn(p, torch.from_numpy(prompt))
    _close(pl.numpy(), jl, F32_TOL, "prefill logits")
    if arch == "zamba2-7b":  # the prefill's KV goes into the bf16 serving cache
        jcache = japi.init_cache(2, 32)
        jc = jcache._replace(
            mamba=jc.mamba, tail=jc.tail,
            attn_k=jcache.attn_k.at[:, :, :9].set(jc.attn_k.astype(jnp.bfloat16)),
            attn_v=jcache.attn_v.at[:, :, :9].set(jc.attn_v.astype(jnp.bfloat16)))
        pc = interop.lm_cache_from_numpy(jax.tree_util.tree_map(np.asarray, jc), device="cpu")
    else:
        _tree_close(pc, jc, F32_TOL, "prefill state")
    tol = F32_TOL if arch == "rwkv6-3b" else BF16_CACHE_LOGITS_TOL
    jtok = ptok = np.asarray(jl).argmax(-1)
    np.testing.assert_array_equal(pl.numpy().argmax(-1), jtok)
    jdecode = jax.jit(japi.decode_fn)
    for step in range(6):
        jlg, jc = jdecode(jp, jc, jnp.asarray(jtok, jnp.int32), jnp.int32(9 + step))
        plg, pc = api.decode_fn(p, pc, torch.from_numpy(ptok), 9 + step)
        _close(plg.numpy(), jlg, tol, f"decode {step}")
        jtok, ptok = np.asarray(jlg).argmax(-1), plg.numpy().argmax(-1)
        np.testing.assert_array_equal(ptok, jtok)


def test_recurrent_caches_cross_both_ways():
    """``RWKVState`` and ``HybridCache`` (with and without a tail) from JAX
    to the port and back, leaf for leaf and bit for bit."""
    for arch, kw in (("rwkv6-3b", {}), ("zamba2-7b", {}), ("zamba2-7b", {"n_layers": 3})):
        jcfg, cfg = _cfgs(arch, **kw)
        jcache = jzoo.get_api(jcfg).init_cache(2, 8)
        jcache = jax.tree_util.tree_map(
            lambda a: _randn(a.shape, a.size).astype(a.dtype), jcache)
        pcache = interop.lm_cache_from_numpy(jcache, device="cpu")
        want = zoo.get_api(cfg).init_cache(2, 8, device="cpu")
        assert type(pcache) is type(want)
        for a, b in zip(tu.leaves(pcache), tu.leaves(want)):
            assert a.shape == b.shape and a.dtype == b.dtype
        _tree_close(pcache, jcache, 0.0, arch)


# ------------------------------------------------------------------ serving --


SLOTS, MAX_SEQ = 3, 64


def _requests(cls, vocab):
    """6 requests over 3 slots, prompts of 4, 7 or 12 tokens (exact-length
    prefill: three JAX compiles), 3–8 new tokens each."""
    rng = np.random.default_rng(11)
    return [cls(rid=r, prompt=[int(t) for t in rng.integers(1, vocab, n)],
                max_new_tokens=int(rng.integers(3, 9)))
            for r, n in enumerate([4, 7, 12, 7, 4, 12])]


def _record(core, jax_side: bool):
    rec = []
    decode = core._decode

    def dec(*a):
        out = decode(*a)
        rec.append(np.asarray(out[0]) if jax_side else out[0].numpy().copy())
        return out

    core._decode = dec
    return rec


@pytest.fixture(scope="module", params=["rwkv6-3b", "zamba2-7b"])
def served(request):
    arch = request.param
    jcfg, cfg = _cfgs(arch)
    jp = jzoo.get_api(jcfg).init_params(jax.random.PRNGKey(3))
    p = interop.lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu")
    eng = Engine(cfg, p, n_slots=SLOTS, max_seq=MAX_SEQ)
    jeng = JEngine(jcfg, jp, n_slots=SLOTS, max_seq=MAX_SEQ)
    rec, jrec = _record(eng.core, False), _record(jeng.core, True)
    for r, j in zip(_requests(Request, cfg.vocab_size), _requests(JRequest, cfg.vocab_size)):
        assert eng.submit(r) and jeng.submit(j)
    return dict(arch=arch, eng=eng, done=eng.run(), jdone=jeng.run(), rec=rec, jrec=jrec)


def test_engine_streams_equal_jax(served):
    """tests/test_serve.py:16's families served by both Engines on the same
    weights: equal token streams, same finishing order, every decode
    step's logits (all slots, idle ones included) within tolerance."""
    done, jdone = served["done"], served["jdone"]
    assert done.status == jdone.status == "drained" and len(done) == len(jdone) == 6
    assert [r.rid for r in done] == [r.rid for r in jdone]
    for r, j in zip(done, jdone):
        assert r.out == j.out, f"request {r.rid}: {r.out} != {j.out}"
    assert len(served["rec"]) == len(served["jrec"])
    tol = F32_TOL if served["arch"] == "rwkv6-3b" else BF16_CACHE_LOGITS_TOL
    for i, (a, b) in enumerate(zip(served["rec"], served["jrec"])):
        _close(a, b, tol, f"{served['arch']} step {i}")


def test_recurrent_families_keep_exact_length_prefill(served):
    """tests/test_serve.py:131: no bucketing for recurrent states; the
    prefill entries are the exact prompt lengths."""
    core = served["eng"].core
    assert not core._bucketed
    assert sorted(core._prefill_cache) == [4, 7, 12]
    _, cfg = _cfgs(served["arch"])
    _, _, _, p = _models(served["arch"])
    eng = Engine(cfg, p, n_slots=2, max_seq=32)
    eng.submit(Request(rid=0, prompt=[1, 2, 3], max_new_tokens=3))
    eng.submit(Request(rid=1, prompt=[4, 5, 6, 7], max_new_tokens=3))
    assert len(eng.run()) == 2
    assert not eng.core._bucketed and sorted(eng.core._prefill_cache) == [3, 4]
