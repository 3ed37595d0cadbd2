"""The fused kernel's tile autotuner (``repro_torch.kernels.autotune``),
mirroring ``tests/test_autotune.py``: the cache round trip and its
deterministic bytes, the injected-measure selection (and its tie rule:
the shape rule's tile within TIE_MARGIN of the fastest), the fallbacks —
a missing file silently, a stale version, a corrupt file, another card or
another kernel hash each with one RuntimeWarning per path —, one bad
entry dropped alone, ``check_cache``, the layer-shape keys equal to JAX's,
the legality checks, and the plan wiring (a tile tuned at one batch
reaches only the launches at that batch). A tile never changes numerics:
on the CPU every legal tile runs the plain version, and a detector built
with the packaged cache equals one built untuned; on the card every tile
is held bit-equal in tests/test_torch_gpu.py and chip_smoke.py's phase p."""
import dataclasses
import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels import autotune as jat  # noqa: E402
from repro_torch.benchmarks.e2e_detector import reduced_config  # noqa: E402
from repro_torch.configs.snn_det import CONFIG, smoke_config  # noqa: E402
from repro_torch.core import plan as cplan  # noqa: E402
from repro_torch.kernels import autotune as at  # noqa: E402
from repro_torch.kernels import fused_pipeline as fp  # noqa: E402
from repro_torch.models import snn_yolo as sy  # noqa: E402

DEV, KER = "NVIDIA H100 80GB HBM3", "0123456789abcdef"


def _shape(**kw) -> at.LayerShape:
    base = dict(kh=1, kw=1, cin=8, kout=8, in_bits=1, t_in=2, t_out=2, h=12, w=16, bh=6, bw=8)
    base.update(kw)
    return at.LayerShape(**base)


@pytest.fixture
def fresh_warnings():
    saved = set(at._warned_paths)
    at._warned_paths.clear()
    yield
    at._warned_paths.clear()
    at._warned_paths.update(saved)


class TestCacheRoundTrip:
    def test_save_load_round_trip(self, tmp_path):
        entries = {_shape().key: at.TileConfig(4, 2, 4, 2),
                   _shape(kh=3, kw=3).key: at.TileConfig(1, 4, 8, 1),
                   _shape(kout=16).key: None}
        p = str(tmp_path / "cache.json")
        at.save_cache(entries, p, device=DEV, kernel=KER)
        assert at.load_cache(p, device=DEV, kernel=KER) == entries

    def test_serialization_is_deterministic(self, tmp_path):
        a = {"k2": at.TileConfig(1, 2, 8, 1), "k1": None}
        b = {"k1": None, "k2": at.TileConfig(1, 2, 8, 1)}
        pa, pb = tmp_path / "a.json", tmp_path / "b.json"
        at.save_cache(a, str(pa), device=DEV, kernel=KER)
        at.save_cache(b, str(pb), device=DEV, kernel=KER)
        assert pa.read_bytes() == pb.read_bytes()
        raw = json.loads(pa.read_text())
        assert (raw["device"], raw["kernel"], raw["version"]) == (DEV, KER, at.CACHE_VERSION)

    def test_tune_with_injected_measure_is_deterministic(self, tmp_path):
        """Same shapes and (injected, clock-free) times → the same winner →
        byte-identical caches; the fake's argmin is its favourite tile."""
        def fake(tile, run):  # prefers wide channel tiles, then one step a pass
            return 1.0 / (tile.ni * tile.wn * 100 + (tile.tb == 1))

        shape = _shape(kh=3, kw=3, kout=16)
        blobs = []
        for name in ("x.json", "y.json"):
            tile, record = at.tune_layer(shape, measure_fn=fake, device="cpu")
            p = tmp_path / name
            at.save_cache({shape.key: tile}, str(p), device=DEV, kernel=KER)
            blobs.append(p.read_bytes())
        assert blobs[0] == blobs[1]
        assert tile == max(at.candidates(shape), key=lambda t: (t.ni * t.wn * 100 + (t.tb == 1)))
        assert set(record) == {at.tile_name(t) for t in at.candidates(shape)}

    def test_record_covers_every_candidate_and_runs_nothing_early(self):
        shape = _shape()
        seen = []

        def fake(tile, run):
            seen.append(tile)
            assert callable(run)
            return float(fp.TILES.index(tuple(tile)) + 1)

        at.tune_layer(shape, measure_fn=fake, device="cpu")
        assert seen == at.candidates(shape)

    def test_tie_keeps_the_rule(self):
        """Within TIE_MARGIN of the fastest, the shape rule's own tile stays
        (None); a clear winner is taken."""
        shape = _shape()
        rule = at.rule(shape, at.TUNE_BATCH, fp.DEFAULT_SMS)
        others = [t for t in at.candidates(shape) if t != rule]
        near = {t: 1.0 for t in others} | {rule: 1.0 + at.TIE_MARGIN / 2}
        assert at.pick(near, rule) is None
        far = {t: 1.0 for t in others} | {rule: 1.0 + 2 * at.TIE_MARGIN}
        assert at.pick(far, rule) == others[0]  # the first of equals, in table order


class TestCacheFallback:
    def test_missing_cache_is_silent(self, tmp_path, fresh_warnings):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert at.load_cache(str(tmp_path / "nope.json"), device=DEV, kernel=KER) == {}
        assert at.lookup(_shape(), {}) is at.DEFAULT_TILE is None

    @pytest.mark.parametrize("what", ["version", "device", "kernel", "corrupt"])
    def test_unusable_cache_warns_once(self, tmp_path, fresh_warnings, what):
        """A file that exists but cannot be used — a stale version, another
        card, another kernel hash, corrupt JSON — loads as {} and warns
        once per path per process, naming the path."""
        p = tmp_path / f"{what}.json"
        at.save_cache({_shape().key: at.TileConfig(1, 2, 8, 1)}, str(p), device=DEV, kernel=KER)
        raw = json.loads(p.read_text())
        if what == "corrupt":
            p.write_text("{not json")
        else:
            raw[what] = {"version": at.CACHE_VERSION + 1, "device": "NVIDIA A100-SXM4-40GB",
                         "kernel": "ffffffffffffffff"}[what]
            p.write_text(json.dumps(raw))
        with pytest.warns(RuntimeWarning) as rec:
            assert at.load_cache(str(p), device=DEV, kernel=KER) == {}
        (msg,) = [str(w.message) for w in rec]
        assert str(p) in msg
        if what == "version":
            assert str(at.CACHE_VERSION + 1) in msg and str(at.CACHE_VERSION) in msg
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # a repeat would raise
            assert at.load_cache(str(p), device=DEV, kernel=KER) == {}

    def test_cpu_accepts_any_card_but_not_another_kernel(self, tmp_path, fresh_warnings):
        """device=None (no card: the CPU) accepts the file's card; the
        kernel hash is checked everywhere."""
        p = str(tmp_path / "c.json")
        at.save_cache({_shape().key: None}, p, device=DEV, kernel=at.kernel_version())
        assert at.load_cache(p, device=None) == {_shape().key: None}

    def test_one_bad_entry_keeps_the_rest(self, tmp_path):
        p = tmp_path / "partial.json"
        good = _shape().key
        p.write_text(json.dumps({
            "version": at.CACHE_VERSION, "device": DEV, "kernel": KER,
            "entries": {good: {"tb": 4, "ni": 2, "wm": 4, "wn": 2},
                        "broken": {"tb": "wide"},
                        "not_a_tile": {"tb": 2, "ni": 2, "wm": 4, "wn": 2}}}))
        assert at.load_cache(str(p), device=DEV, kernel=KER) == {good: at.TileConfig(4, 2, 4, 2)}


class TestShapesAndLegality:
    @pytest.mark.parametrize("which", ["smoke", "full"])
    def test_layer_shape_keys_equal_jax(self, which):
        from repro.configs import smoke_config as jsmoke

        cfg = smoke_config() if which == "smoke" else CONFIG
        jcfg = jsmoke(jget_config("snn-det")) if which == "smoke" else jget_config("snn-det")
        got = {n: s.key for n, s in at.detector_layer_shapes(cfg).items()}
        want = {n: s.key for n, s in jat.detector_layer_shapes(jcfg).items()}
        assert got == want and len(got) == 27

    def test_candidates_mirror_the_kernel(self):
        """Four steps a pass only with a conv per step; on the CPU (no
        library to ask for the shared-memory plan, which the card's tests
        hold) every other tile is a candidate; an illegal tile is refused
        before anything runs."""
        for shape in at.detector_layer_shapes(CONFIG).values():
            cands = at.candidates(shape, "cpu")
            assert all(t.tb == 1 for t in cands) == (shape.t_in == 1)
            assert len(cands) == (4 if shape.t_in == 1 else 6)
        with pytest.raises(ValueError, match="one conv"):
            fp.check_tile((4, 2, 4, 2), t_in=1, c=8, kp=16, n_live=9, kh=3, bh=6, bw=8)
        with pytest.raises(ValueError, match="not one of"):
            fp.check_tile((2, 2, 4, 2), t_in=3, c=8, kp=16, n_live=9, kh=3, bh=6, bw=8)
        assert fp.check_tile(None, t_in=1, c=8, kp=16, n_live=9, kh=3, bh=6, bw=8) == -1
        assert fp.check_tile((1, 2, 8, 1), t_in=1, c=8, kp=16, n_live=9, kh=3, bh=6, bw=8,
                             on_card=False) == 2

    def test_rule_mirrors_launch(self):
        """autotune.rule is csrc/fused_pipeline.cu's launch(): batched over
        time only for small maps with a conv per step."""
        full = at.detector_layer_shapes(CONFIG)
        assert at.rule(full["encode"], 2) == at.TileConfig(1, 2, 8, 1)
        assert at.rule(full["conv_block"], 2) == at.TileConfig(1, 4, 8, 1)
        assert at.rule(full["stage3/main_a"], 2) == at.TileConfig(4, 2, 2, 4)
        assert at.rule(full["stage3/main_a"], 64) == at.TileConfig(1, 4, 4, 2)
        assert at.rule(full["stage1/main_a"], 2) == at.TileConfig(1, 4, 4, 2)
        small = _shape(kout=64, t_in=1, t_out=1)  # 3 tiles of 64 x 64: fewer than the SMs
        assert at.rule(small, 1, fp.DEFAULT_SMS) == at.TileConfig(1, 2, 2, 4)


class TestCheckCache:
    def test_reports_all_missing_then_covered(self, tmp_path, fresh_warnings):
        cfg = dataclasses.replace(smoke_config(), arch_id="snn-det-checktest")
        keys = {at.cache_key(s, b) for s in at.detector_layer_shapes(cfg).values()
                for b in at.TUNE_BATCHES}
        p = str(tmp_path / "cache.json")
        assert sorted(at.check_cache([cfg], p, device=DEV, kernel=KER)) == sorted(keys)
        at.save_cache({k: None for k in keys}, p, device=DEV, kernel=KER)
        assert at.check_cache([cfg], p, device=DEV, kernel=KER) == []
        # a batch the cache was not tuned at is missing
        assert len(at.check_cache([cfg], p, batches=(4,), device=DEV, kernel=KER)) == \
            len(keys) // len(at.TUNE_BATCHES)
        with pytest.warns(RuntimeWarning):  # another kernel hash == an empty cache
            assert sorted(at.check_cache([cfg], p, device=DEV, kernel="f" * 16)) == sorted(keys)

    def test_packaged_cache_is_current(self, capsys):
        """The committed cache names the H100 and this source's kernel hash
        and covers the reduced and 576x1024 configs (`--check`)."""
        assert at.main(["--full-config", "--check"]) == 0
        assert "NVIDIA H100" in capsys.readouterr().out
        raw = json.load(open(at.DEFAULT_CACHE_PATH))
        assert raw["kernel"] == at.kernel_version()


class TestPlanWiring:
    @pytest.fixture(scope="class")
    def setup(self):
        from repro_torch.serve.detector import demo_weights

        cfg = dataclasses.replace(reduced_config(), conv_exec="pallas")
        params, bn, rng = demo_weights(cfg, seed=0, device="cpu")
        h, w = cfg.input_hw
        frames = torch.from_numpy((rng.integers(0, 256, (1, h, w, 3)) / 255.0).astype(np.float32))
        return cfg, params, bn, frames

    def test_plan_carries_the_cached_tiles(self, setup):
        """Each layer keeps the packaged cache's tiles by launch shape
        (batch, H, W), every tuned batch's; {} keeps none."""
        cfg, params, _, _ = setup
        shapes = at.detector_layer_shapes(cfg)
        packaged = cplan.build_plan(params, cfg)
        cache = at.packaged_cache()
        assert {n: packaged.layers[n].tiles for n in shapes} == \
            {n: {(b, s.h, s.w): at.lookup(s, cache, b) for b in at.TUNE_BATCHES
                 if at.lookup(s, cache, b) is not None} for n, s in shapes.items()}
        untuned = cplan.build_plan(params, cfg, tile_cache={})
        assert all(not lp.tiles for lp in untuned.layers.values())

    def test_illegal_tile_refused_at_plan_build(self, setup):
        """A cached tile the kernel cannot run raises when the plan is
        built, not at a launch: four steps a pass at the encode layer."""
        cfg, params, _, _ = setup
        enc = at.detector_layer_shapes(cfg)["encode"]
        with pytest.raises(ValueError, match="one conv"):
            cplan.build_plan(params, cfg,
                             tile_cache={at.cache_key(enc, 2): at.TileConfig(4, 2, 4, 2)})

    def test_tiles_for_reads_every_batch(self):
        shape = _shape()
        cache = {at.cache_key(shape, 2): at.TileConfig(1, 2, 8, 1),
                 at.cache_key(shape, 64): None,
                 at.cache_key(_shape(kout=16), 8): at.TileConfig(1, 4, 8, 1)}
        assert at.tiles_for(shape, cache) == {2: at.TileConfig(1, 2, 8, 1)}
        assert at.lookup(shape, cache, 2) == at.TileConfig(1, 2, 8, 1)
        assert at.lookup(shape, cache, 64) is None and at.lookup(shape, cache, 8) is None

    def test_untuned_equals_tuned_and_forced(self, setup):
        """The packaged cache, {} (the rule) and every layer forced to its
        last legal tile give the same head, bit for bit."""
        cfg, params, bn, frames = setup
        shapes = at.detector_layer_shapes(cfg)
        forced = {at.cache_key(s, 1): at.candidates(s, "cpu")[-1] for s in shapes.values()}
        heads = [sy.compile_detector(cfg, params, bn, device="cpu", tile_cache=c).detect(frames)[1]
                 for c in (None, {}, forced)]
        for h in heads[1:]:
            assert torch.equal(h, heads[0])

    def test_tile_reaches_the_launch(self, setup, monkeypatch):
        self._launch_tiles(setup, monkeypatch, batch=1)

    def test_untuned_batch_keeps_the_rule(self, setup, monkeypatch):
        self._launch_tiles(setup, monkeypatch, batch=2)

    @staticmethod
    def _launch_tiles(setup, monkeypatch, *, batch):
        """Tiles tuned at batch 1 reach the launches at batch 1; at batch 2
        every launch keeps the shape rule (None)."""
        cfg, params, bn, frames = setup
        shapes = at.detector_layer_shapes(cfg)
        forced = {at.cache_key(s, 1): at.candidates(s, "cpu")[0] for s in shapes.values()}
        seen = []
        real = fp.fused_pipeline

        def spy(*a, **kw):
            seen.append(kw["tile"])
            return real(*a, **kw)

        monkeypatch.setattr(fp, "fused_pipeline", spy)
        det = sy.compile_detector(cfg, params, bn, device="cpu", tile_cache=forced)
        det.detect(frames.expand(batch, -1, -1, -1).contiguous())
        want = [forced[at.cache_key(shapes[n], 1)] if batch == 1 else None for n in shapes]
        assert seen == want
