"""The port's LM token serving (``serve.Engine`` over ``LMEngineCore``, and
``launch/serve.py``'s LM branch) against the JAX package's ``Engine`` on
the same carried-across weights and prompts, on the CPU at
``smoke_config`` (f32) of qwen1.5-0.5b, olmoe-1b-7b and deepseek-moe-16b.

Greedy token streams must be equal; logits (first token and every decode
step, every slot) are held to 4e-3 of the largest |logit|, the bound of
``tests/test_torch_lm.py`` for paths through the bf16 KV cache. Bucketed
against exact-length prefill is held within that bound with the argmax
equal: JAX's own pair differs by up to 7.6e-6 (ROADMAP R2).
"""
import contextlib
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import zoo as jzoo  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from repro_torch.serve import Engine, LMEngineCore, Request  # noqa: E402

ARCHS = ["qwen1.5-0.5b", "olmoe-1b-7b", "deepseek-moe-16b"]
LOGITS_TOL = 4e-3
SLOTS, MAX_SEQ = 4, 96


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, bound = float(np.abs(got - want).max()), tol * float(np.abs(want).max())
    assert err <= bound, f"{what}: max |Δ| {err} > {bound}"


def _models(arch, **kw):
    jcfg = dataclasses.replace(jconfigs.smoke_config(jconfigs.get_config(arch)), **kw)
    cfg = dataclasses.replace(configs.smoke_config(configs.get_config(arch)), **kw)
    jp = jzoo.get_api(jcfg).init_params(jax.random.PRNGKey(3))
    p = interop.lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu")
    return jcfg, cfg, jp, p


def _requests(cls, vocab, eos=None):
    """7 requests over 4 slots: prompt lengths 3–40 (buckets 16, 32, 64),
    3–9 new tokens each, so slots free at different steps and are reused."""
    rng = np.random.default_rng(11)
    reqs = []
    for r in range(7):
        plen = int(rng.integers(3, 41))
        prompt = [int(t) for t in rng.integers(1, vocab, plen)]
        reqs.append(cls(rid=r, prompt=prompt, max_new_tokens=int(rng.integers(3, 10)),
                        eos_id=-1 if eos is None else eos.get(r, -1)))
    return reqs


def _record(core, jax_side: bool):
    """Wrap a core's decode and prefill to record their logits."""
    rec = {"prefill": [], "decode": []}
    decode = core._decode
    prefill_fn = core._prefill_fn

    def to_np(x):
        return np.asarray(x) if jax_side else x.numpy().copy()

    def dec(*a):
        out = decode(*a)
        rec["decode"].append(to_np(out[0]))
        return out

    def pre(length):
        fn = prefill_fn(length)

        def call(*a, **k):
            out = fn(*a, **k)
            rec["prefill"].append(to_np(out[0]))
            return out

        return call

    core._decode, core._prefill_fn = dec, pre
    return rec


def _serve(eng, reqs, **run_kw):
    for r in reqs:
        assert eng.submit(r)
    return eng.run(**run_kw)


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """Each arch served by both Engines on the same weights and requests,
    one request ending on an EOS the port's first run chose."""
    arch = request.param
    jcfg, cfg, jp, p = _models(arch)
    first = {r.rid: r.out for r in _serve(Engine(cfg, p, n_slots=SLOTS, max_seq=MAX_SEQ),
                                          _requests(Request, cfg.vocab_size))}
    eos = {2: first[2][2]}  # request 2 stops at its third token
    eng = Engine(cfg, p, n_slots=SLOTS, max_seq=MAX_SEQ)
    jeng = JEngine(jcfg, jp, n_slots=SLOTS, max_seq=MAX_SEQ)
    rec, jrec = _record(eng.core, False), _record(jeng.core, True)
    done = _serve(eng, _requests(Request, cfg.vocab_size, eos))
    jdone = _serve(jeng, _requests(JRequest, cfg.vocab_size, eos))
    return dict(arch=arch, cfg=cfg, p=p, eos=eos, first=first, done=done, jdone=jdone,
                rec=rec, jrec=jrec, eng=eng)


def test_engine_streams_equal_jax(served):
    done, jdone = served["done"], served["jdone"]
    assert done.status == jdone.status == "drained" and len(done) == len(jdone) == 7
    assert [r.rid for r in done] == [r.rid for r in jdone]  # same finishing order
    for r, j in zip(done, jdone):
        assert r.out == j.out, f"request {r.rid}: {r.out} != {j.out}"
        assert r.done and j.done
    stopped = next(r for r in done if r.rid == 2)
    assert stopped.out[-1] == served["eos"][2] and len(stopped.out) <= 3
    rec, jrec = served["rec"], served["jrec"]
    assert len(rec["prefill"]) == len(jrec["prefill"]) == 7
    assert len(rec["decode"]) == len(jrec["decode"])
    for i, (a, b) in enumerate(zip(rec["prefill"] + rec["decode"],
                                   jrec["prefill"] + jrec["decode"])):
        _close(a, b, LOGITS_TOL, f"{served['arch']} call {i}")


def test_engine_reuses_slots_and_buckets_prefill(served):
    core = served["eng"].core
    assert isinstance(core, LMEngineCore) and core._bucketed
    lengths = [len(r.prompt) for r in _requests(Request, served["cfg"].vocab_size)]
    assert sorted(core._prefill_cache) == sorted({16 if n <= 16 else 32 if n <= 32 else 64
                                                 for n in lengths})
    assert len(served["done"]) > SLOTS  # more requests than slots: slots were reused


def test_truncation_reports_pending_then_resumes(served):
    cfg, p = served["cfg"], served["p"]
    eng = Engine(cfg, p, n_slots=SLOTS, max_seq=MAX_SEQ)
    out = _serve(eng, _requests(Request, cfg.vocab_size), max_steps=2)
    assert out.status == "truncated"
    assert {r.rid for r in out.pending} == set(range(7)) - {r.rid for r in out}
    assert all(not r.done for r in out.pending)
    out2 = eng.run()  # in-flight slot state survived
    assert out2.status == "drained" and len(out2) == 7
    assert {r.rid: r.out for r in out2} == served["first"]


@pytest.mark.parametrize("serve_fast", [True, False])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "olmoe-1b-7b"])
def test_bucketed_prefill_first_token_logits(arch, serve_fast):
    """Pad + valid_len at bucket 16 against the exact-length prefill: within
    tolerance with the argmax equal, and the prompt's cache rows (the only
    rows the engine copies) likewise; both against JAX's exact prefill."""
    jcfg, cfg, jp, p = _models(arch, serve_fast=serve_fast)
    api, japi = zoo.get_api(cfg), jzoo.get_api(jcfg)
    prompt = np.array([5, 9, 2, 11, 4])
    exact_l, exact_c = api.prefill_fn(p, torch.from_numpy(prompt[None]))
    padded = np.zeros((1, 16), np.int64)
    padded[0, :5] = prompt
    bucket_l, bucket_c = api.prefill_fn(p, torch.from_numpy(padded), valid_len=5)
    jl, _ = japi.prefill_fn(jp, jnp.asarray(prompt[None], jnp.int32))
    for got in (exact_l, bucket_l):
        _close(got.numpy(), exact_l.numpy(), LOGITS_TOL, "bucketed vs exact")
        _close(got.numpy(), jl, LOGITS_TOL, "vs JAX")
        assert int(got.argmax()) == int(np.asarray(jl).argmax())
    for a, b in zip(interop.lm_cache_to_numpy(bucket_c), interop.lm_cache_to_numpy(exact_c)):
        _close(a[:, :, :5], b[:, :, :5], LOGITS_TOL, "cache rows")


def test_prefill_cache_keyed_by_bucket():
    """Ten prompt lengths share two bucket entries (16 and 32) of the
    prefill cache, and every request decodes as the sequential oracle;
    an int8 cache keeps exact-length prefill."""
    _, cfg, _, p = _models("qwen1.5-0.5b")
    api = zoo.get_api(cfg)
    rng = np.random.default_rng(3)
    lengths = [3, 4, 5, 6, 7, 9, 11, 13, 17, 21]
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)] for n in lengths]
    eng = Engine(cfg, p, n_slots=3, max_seq=64)
    done = _serve(eng, [Request(rid=i, prompt=q, max_new_tokens=5) for i, q in enumerate(prompts)])
    assert done.status == "drained" and sorted(eng.core._prefill_cache) == [16, 32]
    outs = {r.rid: r.out for r in done}
    for i, q in enumerate(prompts):
        assert outs[i] == _sequential(api, p, q, 5, max_seq=64)
    qcfg = dataclasses.replace(cfg, kv_quant=True)
    qeng = Engine(qcfg, p, n_slots=2, max_seq=32)
    _serve(qeng, [Request(rid=0, prompt=[1, 2, 3], max_new_tokens=3),
                  Request(rid=1, prompt=[4, 5, 6, 7], max_new_tokens=3)])
    assert not qeng.core._bucketed and sorted(qeng.core._prefill_cache) == [3, 4]


def _sequential(api, params, prompt, n, *, max_seq):
    logits, small = api.prefill_fn(params, torch.tensor([prompt]))
    cache = api.init_cache(1, max_seq, device="cpu")
    for dst, src in zip(cache, small):
        dst[:, :, :len(prompt)] = src.to(dst.dtype)
    seq, pos = [int(logits[0].argmax())], len(prompt)
    for _ in range(n - 1):
        lg, cache = api.decode_fn(params, cache, torch.tensor([seq[-1]]), torch.tensor([pos]))
        seq.append(int(lg[0].argmax()))
        pos += 1
    return seq


def _jax_sequential(japi, jp, prompt, n, *, max_seq):
    logits, small = japi.prefill_fn(jp, jnp.asarray([prompt], jnp.int32))
    cache = japi.init_cache(1, max_seq)
    cache = type(cache)(*(c.at[:, :, :len(prompt)].set(s.astype(c.dtype))
                          for c, s in zip(cache, small)))
    seq, pos = [int(np.asarray(logits[0]).argmax())], len(prompt)
    decode = jax.jit(japi.decode_fn)
    for _ in range(n - 1):
        lg, cache = decode(jp, cache, jnp.asarray([seq[-1]], jnp.int32),
                           jnp.asarray([pos], jnp.int32))
        seq.append(int(np.asarray(lg[0]).argmax()))
        pos += 1
    return seq


def test_kv_quant_engine_equals_jax_sequential():
    """The port's Engine serves an int8 KV cache (its slot copy moves the
    scales too) with the token streams of JAX's prefill + per-slot decode
    on the same cache; JAX's own Engine cannot serve one (ROADMAP R7)."""
    jcfg, cfg, jp, p = _models("qwen1.5-0.5b", kv_quant=True)
    prompts = [[5, 9, 2, 11, 4], [1, 2, 3], [7] * 12]
    eng = Engine(cfg, p, n_slots=2, max_seq=32)
    done = _serve(eng, [Request(rid=i, prompt=q, max_new_tokens=6) for i, q in enumerate(prompts)])
    outs = {r.rid: r.out for r in done}
    japi = jzoo.get_api(jcfg)
    for i, q in enumerate(prompts):
        assert outs[i] == _jax_sequential(japi, jp, q, 6, max_seq=32)


def test_serve_cli_lm_in_process():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        done = launch.main(["--arch", "qwen1.5-0.5b", "--device", "cpu", "--requests", "6",
                            "--slots", "4", "--max-new", "5"])
    assert len(done) == 6 and all(len(r.out) == 5 for r in done)
    line = buf.getvalue().splitlines()[0]
    assert line.startswith("qwen1.5-0.5b: served 6 requests (30 new tokens)") and "tok/s" in line
    # the JAX CLI's prompts: np.random.default_rng(0), lengths 3..31
    rng = np.random.default_rng(0)
    for r in sorted(done, key=lambda r: r.rid):
        plen = int(rng.integers(3, 32))
        assert r.prompt == list(rng.integers(1, 256, plen))


def test_serve_cli_serves_rwkv6_in_process():
    """The ssm family through the CLI: JAX's CLI prompts (default_rng(0),
    3..31 tokens), exact-length prefill, every request its tokens."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        done = launch.main(["--arch", "rwkv6-3b", "--device", "cpu", "--requests", "5",
                            "--slots", "3", "--max-new", "4"])
    assert len(done) == 5 and all(len(r.out) == 4 for r in done)
    line = buf.getvalue().splitlines()[0]
    assert line.startswith("rwkv6-3b: served 5 requests (20 new tokens)") and "tok/s" in line
    rng = np.random.default_rng(0)
    for r in sorted(done, key=lambda r: r.rid):
        plen = int(rng.integers(3, 32))
        assert r.prompt == list(rng.integers(1, 256, plen))


def test_engine_refuses_prompts_without_room():
    """A prompt must leave a cache row for the first decoded token: longer
    ones are refused at submit (and at a direct admit), never truncated."""
    _, cfg, _, p = _models("qwen1.5-0.5b")
    eng = Engine(cfg, p, n_slots=2, max_seq=16)
    res = eng.submit(Request(rid=0, prompt=list(range(1, 17)), max_new_tokens=2))
    assert not res and res.reason.startswith("invalid: prompt of 16 tokens")
    assert not eng.submit(Request(rid=1, prompt=[], max_new_tokens=2))
    assert eng.submit(Request(rid=2, prompt=list(range(1, 16)), max_new_tokens=2))
    done = eng.run()
    assert [r.rid for r in done] == [2] and [r.rid for r in eng.rejected] == [0, 1]
    with pytest.raises(ValueError, match="request 3: prompt of 20 tokens"):
        eng.core.admit(Request(rid=3, prompt=[1] * 20), 0)
