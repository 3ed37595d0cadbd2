"""The port's sharded mAP evaluation (``repro_torch.eval.sharded``) against
the JAX package's, on the CPU, in one process: the mirror of
``tests/test_sharded_eval.py``.

For any split of detections across k shards, gathering the pooled
per-class (score, TP) lists and re-sweeping AP must be bit-identical
(``reports_identical``: NaN-aware exact equality) to JAX's unsharded
``detection_map.evaluate_detections`` — empty shards, classes without
predictions and score ties included (ties make the pooling ORDER visible in
AP). The detector path is held to JAX's ``harness.evaluate_detector`` on
the same carried-across weights (JAX on its dense executor, the port on its
kernel executor's plain version). The cross-process gather is
``tests/test_torch_multihost.py``'s."""
import dataclasses

import numpy as np
import pytest
from hyp_compat import given, settings, st

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import synthetic_detection as jsd  # noqa: E402
from repro.eval import detection_map as jdm  # noqa: E402
from repro.eval import harness as jh  # noqa: E402
from repro.eval import sharded as jse  # noqa: E402
from repro_torch import tree as tu  # noqa: E402
from repro_torch.data import synthetic_detection as sd  # noqa: E402
from repro_torch.eval import harness  # noqa: E402
from repro_torch.eval import sharded as se  # noqa: E402

NUM_CLASSES = 3
# the detector tests score untrained weights at IoU 0.1 on 16 images: at 0.5
# their report is all zeros, which would compare nothing
DET_IOU = 0.1
DET_IMAGES = 16


def _random_split(seed: int, n_images: int, *, tie_decimals=1, max_gt: int = 4,
                  max_pred: int = 5):
    """Seeded (predictions, ground_truths) with overlapping boxes (so TPs
    exist) and, by default, scores rounded to one decimal: the ties that
    make the pooling order observable in AP."""
    rng = np.random.default_rng(seed)
    preds, gts = [], []
    for _ in range(n_images):
        g = int(rng.integers(0, max_gt + 1))
        g_boxes = rng.uniform(0.2, 0.8, (g, 4)).astype(np.float32)
        g_cls = rng.integers(0, NUM_CLASSES, g)
        gts.append({"boxes": g_boxes, "classes": g_cls})
        p_extra = int(rng.integers(0, max_pred + 1))
        near = g_boxes + rng.normal(0, 0.02, g_boxes.shape).astype(np.float32)
        p_boxes = np.concatenate([near, rng.uniform(0.2, 0.8, (p_extra, 4)).astype(np.float32)])
        p_cls = np.concatenate([g_cls, rng.integers(0, NUM_CLASSES, p_extra)])
        scores = rng.uniform(0, 1, len(p_boxes))
        if tie_decimals is not None:
            scores = np.round(scores, tie_decimals)
        preds.append({"boxes": p_boxes, "scores": scores.astype(np.float32), "classes": p_cls})
    return preds, gts


def _assert_identical(got: dict, ref: dict):
    keys = ("map", "per_class_ap", "n_gt", "n_pred", "n_images", "iou_threshold")
    assert se.reports_identical(got, ref), ({k: got.get(k) for k in keys},
                                            {k: ref.get(k) for k in keys})


def _sharded(preds, gts, k, num_classes=NUM_CLASSES):
    return se.evaluate_predictions_sharded(preds, gts, num_classes=num_classes,
                                           eval_cfg=se.ShardedEvalConfig(n_shards=k))


# ------------------------------------------------------- striping contract --


class TestStripingContract:
    def test_matches_batches_host_striping(self):
        for n, k in ((10, 3), (8, 1), (2, 5), (0, 4)):
            shards = [sd.eval_shard_indices(n, s, k) for s in range(k)]
            assert shards == [jsd.eval_shard_indices(n, s, k) for s in range(k)]
            assert sorted(i for sh in shards for i in sh) == list(range(n))
            for s, sh in enumerate(shards):
                assert all(i % k == s for i in sh)

    def test_out_of_range_shard_raises(self):
        with pytest.raises(ValueError):
            sd.eval_shard_indices(8, 3, 3)
        with pytest.raises(ValueError, match="n_shards"):
            se.ShardedEvalConfig(n_shards=0)

    def test_eval_set_shards_partition_the_split(self):
        hw, grid_div = (96, 160), 16
        full, full_gts = jsd.eval_set(5, hw=hw, grid_div=grid_div)
        for s in range(2):
            imgs, gts = sd.eval_set(5, hw=hw, grid_div=grid_div, shard_id=s, n_shards=2)
            np.testing.assert_array_equal(imgs, full[s::2])
            for got, want in zip(gts, full_gts[s::2]):
                np.testing.assert_array_equal(got["boxes"], want["boxes"])
                np.testing.assert_array_equal(got["classes"], want["classes"])

    def test_eval_set_empty_shard(self):
        imgs, gts = sd.eval_set(2, hw=(96, 160), grid_div=16, shard_id=3, n_shards=4)
        assert imgs.shape == (0, 96, 160, 3) and gts == []


# ----------------------------------------------------------- exact reduce --


class TestShardReductionExact:
    @pytest.mark.parametrize("k", [1, 2, 3, 5, 8])
    def test_bit_identical_for_any_shard_count(self, k):
        preds, gts = _random_split(seed=k, n_images=9)
        ref = jdm.evaluate_detections(preds, gts, num_classes=NUM_CLASSES)
        got = _sharded(preds, gts, k)
        assert got["n_shards"] == k and got["n_hosts"] == 1 and got["gather"] == "host"
        _assert_identical(got, ref)
        _assert_identical(got, jse.evaluate_predictions_sharded(
            preds, gts, num_classes=NUM_CLASSES, eval_cfg=jse.ShardedEvalConfig(n_shards=k)))

    def test_empty_shards(self):
        """k > n_images: the trailing shards hold zero images."""
        preds, gts = _random_split(seed=0, n_images=2)
        _assert_identical(_sharded(preds, gts, 7),
                          jdm.evaluate_detections(preds, gts, num_classes=NUM_CLASSES))

    def test_no_predictions_at_all(self):
        _, gts = _random_split(seed=3, n_images=4, max_gt=3)
        empty = [{"boxes": np.zeros((0, 4), np.float32), "scores": np.zeros(0, np.float32),
                  "classes": np.zeros(0, np.int64)} for _ in gts]
        got = _sharded(empty, gts, 3)
        _assert_identical(got, jdm.evaluate_detections(empty, gts, num_classes=NUM_CLASSES))
        assert got["n_pred"] == [0, 0, 0]

    def test_empty_split(self):
        got = se.evaluate_predictions_sharded([], [], num_classes=NUM_CLASSES)
        assert np.isnan(got["map"]) and got["n_images"] == 0
        _assert_identical(got, jse.evaluate_predictions_sharded([], [],
                                                                num_classes=NUM_CLASSES))

    def test_mismatched_pairing_raises(self):
        preds, gts = _random_split(seed=1, n_images=3)
        with pytest.raises(ValueError, match="pairing"):
            se.evaluate_predictions_sharded(preds[:2], gts, num_classes=NUM_CLASSES)
        with pytest.raises(ValueError, match="pairing mismatch"):
            se.match_stats(preds, gts, [0, 1], num_classes=NUM_CLASSES)

    def test_tie_order_is_canonical(self):
        """One class, two images, tied scores, an FP on image 0 and a TP on
        image 1: the stable re-sort pools [FP, TP] (AP 0.25); a shard-major
        concatenation would pool [TP, FP] and report 0.5."""
        gt = {"boxes": np.array([[0.5, 0.5, 0.2, 0.2]], np.float32), "classes": np.array([0])}
        tp_pred = {"boxes": np.array([[0.5, 0.5, 0.2, 0.2]], np.float32),
                   "scores": np.array([0.7], np.float32), "classes": np.array([0])}
        fp_pred = {"boxes": np.array([[0.9, 0.9, 0.05, 0.05]], np.float32),
                   "scores": np.array([0.7], np.float32), "classes": np.array([0])}
        preds, gts = [fp_pred, tp_pred], [gt, gt]
        ref = jdm.evaluate_detections(preds, gts, num_classes=1)
        assert ref["map"] == pytest.approx(0.25)
        _assert_identical(_sharded(preds, gts, 2, num_classes=1), ref)

    def test_padded_rows_round_trip(self):
        """The padding helpers the card and process gathers share: padded
        to a common capacity and unpadded by the valid mask, the shards
        come back as the host gather concatenates them."""
        preds, gts = _random_split(seed=4, n_images=7)
        stats = [se.match_stats([preds[i] for i in idx], [gts[i] for i in idx], idx,
                                num_classes=NUM_CLASSES)
                 for idx in (sd.eval_shard_indices(7, s, 3) for s in range(3))]
        stats.append(se.ShardStats.empty(NUM_CLASSES))
        cap = max(s.image_idx.size for s in stats) + 2
        rows, counts = se._pad_rows(stats, cap)
        assert rows["score"].shape == (4, cap) and rows["valid"].dtype == bool
        got = se._unpad_rows(rows, counts.sum(0))
        want = se._gather_host(stats)
        for f in ("image_idx", "cls", "score", "tp", "n_gt"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
            assert getattr(got, f).dtype == getattr(want, f).dtype, f
        assert got.n_images == want.n_images == 7

    def test_card_gather_requires_devices(self):
        """Forcing the card gather with fewer cards than shards raises
        naming the devices; left to itself the evaluator gathers on the
        host."""
        preds, gts = _random_split(seed=2, n_images=4)
        n = max(torch.cuda.device_count(), 1)  # a single shard reduces nothing
        with pytest.raises(ValueError, match="devices"):
            se.evaluate_predictions_sharded(
                preds, gts, num_classes=NUM_CLASSES,
                eval_cfg=se.ShardedEvalConfig(n_shards=n + 1, use_device_mesh=True))
        assert _sharded(preds, gts, n + 1)["gather"] == "host"

    @settings(max_examples=30, deadline=None)
    @given(st.integers(0, 10_000), st.integers(0, 8), st.integers(1, 6),
           st.sampled_from([None, 0, 1]))
    def test_reduction_property(self, seed, n_images, k, tie_decimals):
        """Any split across k shards, any image count (0 and < k included)
        and tie density: bit-identical to JAX's unsharded sweep."""
        preds, gts = _random_split(seed, n_images, tie_decimals=tie_decimals)
        _assert_identical(_sharded(preds, gts, k),
                          jdm.evaluate_detections(preds, gts, num_classes=NUM_CLASSES))


# ---------------------------------------------------------------- detector --


@pytest.fixture(scope="module")
def detectors():
    """(port detector, JAX's single-process report): the port's seeded
    ``demo_weights`` at the smoke config (pruned 0.8, tdBN-calibrated; no
    training, which is slow on a loaded CPU) carried across as numpy; the
    port evaluates them through its kernel executor's plain version, JAX
    through its dense executor, once for the module."""
    from repro.configs import get_config
    from repro.configs import smoke_config as jsmoke
    from repro_torch.configs.snn_det import CONFIG, smoke_config
    from repro_torch.serve.detector import demo_weights

    cfg = dataclasses.replace(smoke_config(CONFIG), conv_exec="pallas")
    params, bn, _ = demo_weights(cfg, device="cpu")
    det = harness.compile_eval_detector(cfg, params, bn, device="cpu")
    to_jax = lambda t: jax.tree_util.tree_map(  # noqa: E731
        jnp.asarray, tu.tree_map(lambda x: x.numpy(), t))
    jcfg = dataclasses.replace(jsmoke(get_config("snn-det")), conv_exec="dense")
    jdet = jh.compile_eval_detector(jcfg, to_jax(params), to_jax(bn))
    ref = jh.evaluate_detector(jdet, n_images=DET_IMAGES, iou_threshold=DET_IOU)
    assert ref["map"] > 0 and sum(ref["n_pred"]) > 0  # a report that compares something
    return det, ref


class TestShardedDetectorEval:
    @pytest.mark.parametrize("k", [2, 4])
    def test_detector_sharded_matches_single_host(self, detectors, k):
        """Striped split, per-shard forward→decode→NMS through the kernel
        executor's plan: the reduced report equals the port's single-process
        one and JAX's, bit for bit."""
        det, ref = detectors
        single = harness.evaluate_detector(det, n_images=DET_IMAGES, iou_threshold=DET_IOU)
        got = harness.evaluate_detector(det, n_images=DET_IMAGES, iou_threshold=DET_IOU,
                                        sharded=k)
        assert got["n_shards"] == k and got["split"] == ref["split"] == "val"
        _assert_identical(single, ref)
        _assert_identical(got, ref)

    def test_batch_chunking_does_not_change_result(self, detectors):
        det, ref = detectors
        a, b = (harness.evaluate_detector(det, n_images=DET_IMAGES - 3, iou_threshold=DET_IOU,
                                          sharded=se.ShardedEvalConfig(n_shards=2, batch=n))
                for n in (2, 8))
        _assert_identical(a, b)
        assert a["n_images"] == DET_IMAGES - 3
