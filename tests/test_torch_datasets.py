"""The port's file-backed detection sources against the JAX package's on
the same inputs: letterbox geometry, the PNM reader and its strict header
checks, the COCO-json and VOC-xml loaders (eval sets and host-striped
target batches, bit-equal, and the committed fixture's pinned checksums),
the dataset spec and its errors, and the PIL branch of the image decode.
Every comparison is exact: the loaders are numpy in both packages."""
import json
import os
import sys
import zlib

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import detection_datasets as jdd  # noqa: E402
from repro_torch.data import detection_datasets as dd  # noqa: E402

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "coco_fixture")
FIXTURE_JSON = os.path.join(FIXTURE_DIR, "instances.json")
CHECKSUMS = os.path.join(os.path.dirname(__file__), "fixtures", "data_checksums.json")
HWS = [(96, 160), (576, 1024)]


def _equal_eval_sets(got, want):
    (gi, gg), (wi, wg) = got, want
    assert gi.dtype == wi.dtype and gi.shape == wi.shape
    np.testing.assert_array_equal(gi, wi)
    assert len(gg) == len(wg)
    for a, b in zip(gg, wg):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])


def _equal_batches(got_iter, want_iter, steps):
    got, want = list(got_iter), list(want_iter)
    assert len(got) == len(want) == steps
    for g, w in zip(got, want):
        for k in ("image", "target"):
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            np.testing.assert_array_equal(g[k], w[k])


# -------------------------------------------------------------- letterbox --


@pytest.mark.parametrize("src_hw", [(48, 80), (96, 90), (60, 160), (37, 53), (101, 17), (9, 9)])
@pytest.mark.parametrize("hw", [(96, 160), (64, 64), (41, 29)])
def test_letterbox_matches_jax(src_hw, hw):
    rng = np.random.default_rng(src_hw[0] * 1000 + src_hw[1])
    for img in (rng.random(src_hw + (3,)).astype(np.float32),
                rng.integers(0, 256, src_hw).astype(np.uint8)):
        got, geom = dd.letterbox_image(img, hw)
        want, jgeom = jdd.letterbox_image(img, hw)
        assert geom == jgeom and got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        boxes = rng.random((5, 4)).astype(np.float32)
        np.testing.assert_array_equal(dd.letterbox_boxes(boxes, geom, hw),
                                      jdd.letterbox_boxes(boxes, jgeom, hw))
    assert dd.LETTERBOX_PAD_VALUE == jdd.LETTERBOX_PAD_VALUE


# ------------------------------------------------------------------- PNM --


@pytest.mark.parametrize("name", sorted(f for f in os.listdir(FIXTURE_DIR) if f.endswith(".ppm")))
def test_read_ppm_matches_jax(name):
    path = os.path.join(FIXTURE_DIR, name)
    got, want = dd._read_ppm(path), jdd._read_ppm(path)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(dd._read_image(path), jdd._read_image(path))


def _pnm(header: bytes, body: bytes) -> bytes:
    return header + body


BAD_PNM = {
    "truncated-header": b"P6\n4 2\n",
    "crlf-header": _pnm(b"P6\r\n4 2\r\n255\r\n", bytes(24)),
    "wrong-magic": _pnm(b"P3\n4 2\n255\n", bytes(24)),
    "maxval-16bit": _pnm(b"P6\n4 2\n65535\n", bytes(48)),
    "short-body": _pnm(b"P6\n4 2\n255\n", bytes(23)),
    "long-body": _pnm(b"P5\n4 2\n255\n", bytes(9)),
}


@pytest.mark.parametrize("case", list(BAD_PNM))
def test_read_ppm_rejects_bad_files_like_jax(tmp_path, case):
    path = str(tmp_path / "bad.ppm")
    with open(path, "wb") as f:
        f.write(BAD_PNM[case])
    with pytest.raises(ValueError) as jerr:
        jdd._read_ppm(path)
    with pytest.raises(ValueError) as err:
        dd._read_ppm(path)
    assert str(err.value) == str(jerr.value)


def test_read_ppm_accepts_comments_and_pgm(tmp_path):
    img = np.arange(12, dtype=np.uint8).reshape(3, 4, 1)
    path = str(tmp_path / "g.pgm")
    with open(path, "wb") as f:
        f.write(b"P5\n# a comment\n4 3\n255\n" + img.tobytes())
    np.testing.assert_array_equal(dd._read_ppm(path), jdd._read_ppm(path))
    np.testing.assert_array_equal(dd._read_ppm(path), img)


def test_read_image_npy_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    for i, arr in enumerate((rng.integers(0, 256, (5, 7, 3)).astype(np.uint8),
                             rng.random((5, 7)).astype(np.float32))):
        path = str(tmp_path / f"a{i}.npy")
        np.save(path, arr)
        got, want = dd._read_image(path), jdd._read_image(path)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_read_image_without_pil_raises(tmp_path, monkeypatch):
    """Without PIL a png raises the ValueError that names the
    dependency-free formats."""
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ValueError, match=r"needs PIL.*convert to \.ppm or \.npy"):
        dd._read_image(path)


def test_read_image_with_pil_matches_jax(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(4)
    arr = rng.integers(0, 256, (9, 13, 3)).astype(np.uint8)
    path = str(tmp_path / "x.png")
    Image.fromarray(arr).save(path)
    got, want = dd._read_image(path), jdd._read_image(path)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, arr.astype(np.float32) / 255.0)


# ------------------------------------------------------------------- COCO --


@pytest.fixture(scope="module")
def coco():
    return dd.CocoJsonSource(FIXTURE_JSON), jdd.CocoJsonSource(FIXTURE_JSON)


@pytest.mark.parametrize("hw", HWS, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_coco_eval_set_bit_equal_to_jax(coco, hw):
    src, jsrc = coco
    assert src.class_names == jsrc.class_names == ("vehicle", "bike", "pedestrian")
    assert src.num_eval_images("val") == jsrc.num_eval_images("val") == 4
    gd = 16 if hw == (96, 160) else 32
    _equal_eval_sets(src.eval_set(4, hw=hw, grid_div=gd), jsrc.eval_set(4, hw=hw, grid_div=gd))
    for shard in (0, 1):
        _equal_eval_sets(src.eval_set(4, hw=hw, shard_id=shard, n_shards=2),
                         jsrc.eval_set(4, hw=hw, shard_id=shard, n_shards=2))
    _equal_eval_sets(src.eval_set(2, hw=hw), jsrc.eval_set(2, hw=hw))


@pytest.mark.parametrize("hw", HWS, ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("host_id,n_hosts,start", [(0, 1, 0), (1, 2, 0), (0, 3, 5)])
def test_coco_batches_bit_equal_to_jax(coco, hw, host_id, n_hosts, start):
    src, jsrc = coco
    gd = 16 if hw == (96, 160) else 32
    kw = dict(hw=hw, steps=3, grid_div=gd, host_id=host_id, n_hosts=n_hosts, start_index=start)
    _equal_batches(src.batches(3, **kw), jsrc.batches(3, **kw), 3)


def test_coco_fixture_matches_pinned_checksums(coco):
    """The port's letterboxed images, grid targets and boxes are the ones
    ``data_checksums.json`` pins for the JAX package's loader."""
    with open(CHECKSUMS) as f:
        pins = json.load(f)["coco_fixture"]
    src, _ = coco
    hw, gd = (96, 160), 16
    images, gts = src.eval_set(4, hw=hw, grid_div=gd)
    batch = next(src.batches(4, hw=hw, steps=1, grid_div=gd))
    assert list(src.class_names) == pins["class_names"]

    def crc(a):
        return zlib.crc32(np.ascontiguousarray(a).tobytes())

    for pin in pins["samples"]:
        i = pin["index"]
        assert crc(images[i]) == pin["image_crc32"]
        assert crc(batch["target"][i]) == pin["target_crc32"]
        assert crc(gts[i]["boxes"]) == pin["boxes_crc32"]
        assert gts[i]["classes"].tolist() == pin["classes"]


def _write_coco(tmp_path, data):
    path = str(tmp_path / "instances.json")
    with open(path, "w") as f:
        json.dump(data, f)
    return path


COCO_ERRORS = {
    "no-categories": {"images": [], "annotations": [], "categories": []},
    "unknown-image": {"images": [{"id": 1, "file_name": "a.ppm", "height": 4, "width": 4}],
                      "annotations": [{"id": 9, "image_id": 2, "category_id": 1,
                                       "bbox": [0, 0, 1, 1]}],
                      "categories": [{"id": 1, "name": "vehicle"}]},
    "unknown-category": {"images": [{"id": 1, "file_name": "a.ppm", "height": 4, "width": 4}],
                         "annotations": [{"id": 9, "image_id": 1, "category_id": 7,
                                          "bbox": [0, 0, 1, 1]}],
                         "categories": [{"id": 1, "name": "vehicle"}]},
    "no-images": {"images": [], "annotations": [], "categories": [{"id": 1, "name": "v"}]},
}


@pytest.mark.parametrize("case", list(COCO_ERRORS))
def test_coco_errors_match_jax(tmp_path, case):
    path = _write_coco(tmp_path, COCO_ERRORS[case])
    with pytest.raises(ValueError) as jerr:
        jdd.CocoJsonSource(path)
    with pytest.raises(ValueError) as err:
        dd.CocoJsonSource(path)
    assert str(err.value) == str(jerr.value)


def test_coco_skips_crowd_like_jax(tmp_path):
    with open(FIXTURE_JSON) as f:
        data = json.load(f)
    for im in data["images"]:
        im["file_name"] = os.path.join(FIXTURE_DIR, im["file_name"])
    data["annotations"][0]["iscrowd"] = 1
    path = _write_coco(tmp_path, data)
    _equal_eval_sets(dd.CocoJsonSource(path).eval_set(4, hw=(96, 160)),
                     jdd.CocoJsonSource(path).eval_set(4, hw=(96, 160)))


def test_check_classes_error_matches_jax(coco):
    src, jsrc = coco
    with pytest.raises(ValueError) as jerr:
        jsrc.eval_set(4, hw=(96, 160), num_classes=2)
    with pytest.raises(ValueError) as err:
        src.eval_set(4, hw=(96, 160), num_classes=2)
    assert str(err.value) == str(jerr.value) and "classes" in str(err.value)
    with pytest.raises(ValueError, match="classes"):
        next(src.batches(2, hw=(96, 160), num_classes=2))


# -------------------------------------------------------------------- VOC --


def _write_voc(root, with_layout=True):
    """The tree ``tests/test_detection_datasets.py`` writes, plus a second
    image of another size and a grayscale pgm."""
    ann = os.path.join(root, "Annotations") if with_layout else root
    imgd = os.path.join(root, "JPEGImages") if with_layout else root
    os.makedirs(ann, exist_ok=True)
    os.makedirs(imgd, exist_ok=True)
    img = np.full((40, 60, 3), 128, np.uint8)
    with open(os.path.join(imgd, "a.ppm"), "wb") as f:
        f.write(b"P6\n60 40\n255\n" + img.tobytes())
    gray = (np.arange(30 * 50) % 251).astype(np.uint8).reshape(30, 50)
    with open(os.path.join(imgd, "b.pgm"), "wb") as f:
        f.write(b"P5\n50 30\n255\n" + gray.tobytes())
    xml_a = """<annotation><filename>a.ppm</filename>
      <size><width>60</width><height>40</height><depth>3</depth></size>
      <object><name>vehicle</name>
        <bndbox><xmin>6</xmin><ymin>8</ymin><xmax>30</xmax><ymax>24</ymax></bndbox>
      </object>
      <object><name>pedestrian</name>
        <bndbox><xmin>42</xmin><ymin>10</ymin><xmax>48</xmax><ymax>30</ymax></bndbox>
      </object></annotation>"""
    xml_b = """<annotation><filename>b.pgm</filename>
      <size><width>50</width><height>30</height><depth>1</depth></size>
      <object><name> bike </name>
        <bndbox><xmin>1</xmin><ymin>2</ymin><xmax>20</xmax><ymax>29</ymax></bndbox>
      </object></annotation>"""
    for name, xml in (("a.xml", xml_a), ("b.xml", xml_b)):
        with open(os.path.join(ann, name), "w") as f:
            f.write(xml)


@pytest.mark.parametrize("layout", [True, False], ids=["voc-layout", "flat"])
@pytest.mark.parametrize("names", [None, ("vehicle", "bike", "pedestrian")],
                         ids=["inferred", "given"])
def test_voc_bit_equal_to_jax(tmp_path, layout, names):
    _write_voc(str(tmp_path), with_layout=layout)
    src, jsrc = dd.VocXmlSource(str(tmp_path), names), jdd.VocXmlSource(str(tmp_path), names)
    assert src.class_names == jsrc.class_names
    assert src.num_eval_images("val") == jsrc.num_eval_images("val") == 2
    for hw in HWS:
        gd = 16 if hw == (96, 160) else 32
        _equal_eval_sets(src.eval_set(2, hw=hw, grid_div=gd), jsrc.eval_set(2, hw=hw, grid_div=gd))
        kw = dict(hw=hw, steps=3, grid_div=gd, host_id=1, n_hosts=2, start_index=1)
        _equal_batches(src.batches(3, **kw), jsrc.batches(3, **kw), 3)


def test_voc_unknown_class_error_matches_jax(tmp_path):
    _write_voc(str(tmp_path))
    with pytest.raises(ValueError) as jerr:
        jdd.VocXmlSource(str(tmp_path), class_names=("vehicle",))
    with pytest.raises(ValueError) as err:
        dd.VocXmlSource(str(tmp_path), class_names=("vehicle",))
    assert str(err.value) == str(jerr.value)


def test_voc_empty_dir_error_matches_jax(tmp_path):
    with pytest.raises(ValueError) as jerr:
        jdd.VocXmlSource(str(tmp_path))
    with pytest.raises(ValueError) as err:
        dd.VocXmlSource(str(tmp_path))
    assert str(err.value) == str(jerr.value)


# ------------------------------------------------------------------- spec --


def test_parse_dataset_spec_sources(tmp_path):
    _write_voc(str(tmp_path))
    for spec, kind in ((None, dd.SyntheticSource), ("", dd.SyntheticSource),
                       ("synthetic", dd.SyntheticSource),
                       (f"coco:{FIXTURE_JSON}", dd.CocoJsonSource),
                       (f"voc:{tmp_path}", dd.VocXmlSource)):
        src = dd.parse_dataset_spec(spec)
        assert type(src) is kind and isinstance(src, dd.DetectionSource)
        assert src.name == jdd.parse_dataset_spec(spec).name
    src = dd.parse_dataset_spec(f"voc:{tmp_path}")
    _equal_eval_sets(src.eval_set(2, hw=(96, 160)),
                     jdd.parse_dataset_spec(f"voc:{tmp_path}").eval_set(2, hw=(96, 160)))


@pytest.mark.parametrize("spec", ["coco:", "voc:", "imagenet:/x", "nonsense", "coco"])
def test_parse_dataset_spec_errors_match_jax(spec):
    with pytest.raises(ValueError) as jerr:
        jdd.parse_dataset_spec(spec)
    with pytest.raises(ValueError) as err:
        dd.parse_dataset_spec(spec)
    assert str(err.value) == str(jerr.value)


def test_loader_imports_no_jax():
    import subprocess

    code = ("import sys; import repro_torch.data.detection_datasets as d; "
            "d.parse_dataset_spec('coco:" + FIXTURE_JSON + "'); "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'repro' or m.startswith('repro.')]; print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env={**os.environ, "PYTHONPATH": os.path.join(root, "src")}, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_train_detector_trains_on_the_coco_fixture(tmp_path, capsys):
    """``train_detector --dataset coco:...`` trains on the letterboxed
    fixture and scores its 4 images; with ``--eval-shards 2`` the sharded
    score of the committed weights equals one process's."""
    from repro_torch.eval import harness
    from repro_torch.launch import train_detector

    spec = f"coco:{FIXTURE_JSON}"
    out = train_detector.main(["--device", "cpu", "--steps", "8", "--batch", "2",
                               "--eval-images", "16", "--dataset", spec, "--eval-shards", "2",
                               "--ckpt", str(tmp_path)])
    text = capsys.readouterr().out
    assert "train_detector OK" in text and text.count("on 4 val images") == 2
    assert out["losses"][-1] < out["losses"][0]
    assert os.path.isdir(out["detector_ckpt"])
    cfg, p, b, _ = harness.restore_detector_checkpoint(out["detector_ckpt"], device="cpu")
    single = harness.evaluate_detector(harness.compile_eval_detector(cfg, p, b, device="cpu"),
                                       n_images=16, source=dd.parse_dataset_spec(spec))
    assert single["n_images"] == 4 and single["map"] == out["map"]["pruned+quant"]
