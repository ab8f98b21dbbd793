"""The port's data path against the JAX package's.

- ``data/tiff.py`` against JAX's codec, bit for bit (files and arrays), over
  the cases of tests/test_data.py:30-49; the native decoder against the
  Python codec.
- ``determine_flood_dataset`` against JAX's, sample for sample, for every
  subset, ``best``/``same`` DEM and crop None/4, on a CSV-only fixture with
  60 Harvey originals (the ``testing`` subset samples 50).
- ``BatchLoader.epoch_iter`` against JAX's on tests/fixtures.py's 32^2
  dataset: the same names in the same order, inputs and outputs within the
  2e-4 that tests/test_torch_ops.py holds the resize to.
- The post-transform cache: exact and decode-free on the second epoch, its
  flag off, and its capacity guard (tests/test_data.py:227-292).
"""

import csv
import os
import warnings

import numpy as np
import pytest
import torch

from floodgan_tpu.data import tiff as jax_tiff
from floodgan_tpu.data.pipeline import create_flood_dataset as jax_create_flood_dataset
from floodgan_tpu.data.splits import determine_flood_dataset as jax_determine
from floodgan_tpu_torch.data import native, tiff
from floodgan_tpu_torch.data.pipeline import BatchLoader, FloodDataset, create_flood_dataset
from floodgan_tpu_torch.data.splits import determine_flood_dataset

from fixtures import make_flood_fixture

TOL_RESIZE = 2e-4  # tests/test_torch_ops.py's bound for the bicubic-AA resize


# ---------------------------------------------------------------- TIFF codec

@pytest.mark.parametrize("shape,dtype", [
    ((16, 16, 9), np.float32),
    ((16, 16, 3), np.float32),
    ((16, 16), np.float32),
    ((16, 16, 3), np.uint8),
    ((16, 16), np.uint8),
])
@pytest.mark.parametrize("compress", [False, True])
def test_tiff_matches_jax_bit_for_bit(tmp_path, rng, shape, dtype, compress):
    arr = (rng.random(shape) * 255).astype(np.uint8) if dtype == np.uint8 else rng.random(shape, dtype=np.float32)
    ours, theirs = str(tmp_path / "port.tif"), str(tmp_path / "jax.tif")
    tiff.imwrite(ours, arr, compress=compress)
    jax_tiff.imwrite(theirs, arr, compress=compress)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    for path in (ours, theirs):
        got, want = tiff.imread(path), jax_tiff.imread(path)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, arr)


@pytest.mark.parametrize("compress", [False, True])
def test_native_decoder_matches_the_python_codec(tmp_path, rng, compress):
    stacks = [rng.random((24, 20, 9), dtype=np.float32) for _ in range(3)]
    paths = []
    for i, s in enumerate(stacks):
        paths.append(str(tmp_path / f"{i}.tif"))
        tiff.imwrite(paths[-1], s, compress=compress)
    got = native.decode_batch(paths, 24, 20, 9)
    assert got is not None, "the native decoder did not build here"
    np.testing.assert_array_equal(got, np.stack([tiff.imread(p) for p in paths]))
    out = np.zeros((3, 24, 20, 9), np.float32)
    assert native.decode_batch(paths, 24, 20, 9, out=out) is out
    np.testing.assert_array_equal(out, got)
    with pytest.raises(ValueError, match="C-contiguous float32"):
        native.decode_batch(paths, 24, 20, 9, out=np.zeros((3, 24, 20, 9), np.float64))


def test_native_decoder_declines_a_file_outside_its_coverage(tmp_path, rng):
    """An error code (here: 3 channels where 9 are asked for) comes back as
    None, and the loader then takes the Python codec."""
    path = str(tmp_path / "rgb.tif")
    tiff.imwrite(path, rng.random((8, 8, 3), dtype=np.float32))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert native.decode_batch([path], 8, 8, 9) is None


# ------------------------------------------------------------------- splits

@pytest.fixture(scope="module")
def split_csv(tmp_path_factory):
    """dataset_split.csv in the reference schema, 60 Harvey originals."""
    root = tmp_path_factory.mktemp("splits")
    rng = np.random.default_rng(3)
    rows = []
    for disaster, country, n in (("hurricane-harvey", "usa", 60), ("hurricane-florence", "usa", 20),
                                 ("midwest-flooding", "usa", 15), ("nepal-flooding", "india", 12)):
        for i in range(n):
            split = ("train", "validation", "test")[rng.integers(0, 3)]
            for version in ("original", "flipped") if split == "train" else ("original",):
                rows.append({"image": f"{disaster}_{i:08d}", "best_DEM": "01m" if country == "usa" else "30m",
                             "same_DEM": "10m" if country == "usa" else "30m", "version": version,
                             "split": split, "disaster": disaster, "country": country})
    with open(root / "dataset_split.csv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return str(root)


def _samples(splits):
    return {k: [(s.file_name, s.version, s.crop_index, s.image_name) for s in v] for k, v in splits.items()}


@pytest.mark.parametrize("subset", ["usa", "india", "hurricane-harvey", "hurricane-florence", "midwest-flooding",
                                    "nepal-flooding", "all", "harveyflorence", "harveyonflorence", "testing"])
def test_flood_split_matches_jax(split_csv, subset):
    for dem in ("best", "same"):
        for crop in (None, 4):
            want = _samples(jax_determine(subset, dem, crop, metadata_dir=split_csv))
            got = _samples(determine_flood_dataset(subset, dem, crop, metadata_dir=split_csv))
            assert got == want, (subset, dem, crop)
            assert sum(map(len, got.values())) > 0
    if subset == "testing":
        assert len({s[0] for v in got.values() for s in v}) == 50


def test_bad_subset_and_dem_raise(split_csv):
    with pytest.raises(NotImplementedError):
        determine_flood_dataset("atlantis", "best", metadata_dir=split_csv)
    with pytest.raises(NotImplementedError):
        determine_flood_dataset("usa", "worst", metadata_dir=split_csv)


# ------------------------------------------------------------------- loader

@pytest.fixture(scope="module")
def flood_fixture(tmp_path_factory):
    return make_flood_fixture(tmp_path_factory.mktemp("flood"), size=32, n_per_disaster=3)


@pytest.mark.parametrize("subset,topography,resize,crop,batch", [
    ("usa", "all", 16, 4, 2),
    ("usa", "dem", None, None, 3),
    ("all", "map", 24, None, 2),
])
def test_loader_matches_jax(flood_fixture, subset, topography, resize, crop, batch):
    data_path, meta_dir = flood_fixture
    kw = dict(topography=topography, resize=resize, crop=crop, batch_size=batch, metadata_dir=meta_dir)
    ours = create_flood_dataset(subset, "same", data_path, device="cpu", **kw)
    theirs = jax_create_flood_dataset(subset, "same", data_path, **kw)
    for split, (a, b) in enumerate(zip(ours, theirs)):
        assert len(a) == len(b)
        for epoch in (1, 2):  # epoch 2 comes from the post-transform cache
            got, want = list(a.epoch_iter(epoch)), list(b.epoch_iter(epoch))
            assert [x["names"] for x in got] == [x["names"] for x in want], (split, epoch)
            for x, y in zip(got, want):
                assert x["input"].dtype == torch.float32 and x["input"].device.type == "cpu"
                np.testing.assert_allclose(x["input"].numpy(), np.asarray(y["input"]), atol=TOL_RESIZE)
                np.testing.assert_allclose(x["output"].numpy(), np.asarray(y["output"]), atol=TOL_RESIZE)


def test_loader_order_is_the_epochs_permutation(flood_fixture):
    data_path, meta_dir = flood_fixture
    train, _, _ = create_flood_dataset("usa", "same", data_path, "all", None, None, batch_size=2,
                                       metadata_dir=meta_dir, device="cpu")
    n = len(train.dataset)
    names = [nm for b in train.epoch_iter(3) for nm in b["names"]]
    assert names == [train.dataset.name(int(i)) for i in np.random.default_rng(3).permutation(n)]
    assert names != [nm for b in train.epoch_iter(4) for nm in b["names"]]


def test_post_transform_cache_exact_and_decode_free(flood_fixture):
    data_path, meta_dir = flood_fixture
    train, _, _ = create_flood_dataset("usa", "same", data_path, "map", 16, 4, batch_size=2,
                                       metadata_dir=meta_dir, device="cpu")
    first = [(b["input"].clone(), b["output"].clone(), b["names"]) for b in train.epoch_iter(5)]
    assert train.post_cache_hits == 0 and train.stage_seconds["decode"] > 0

    def poisoned(idx_batch):
        raise AssertionError("raw decode path ran despite a warm post-transform cache")

    train._load_raw_batch = poisoned
    second = [(b["input"], b["output"], b["names"]) for b in train.epoch_iter(5)]
    assert train.post_cache_hits == train.post_cache_total == len(second) == len(first)
    for (i1, o1, n1), (i2, o2, n2) in zip(first, second):
        assert n1 == n2
        assert torch.equal(i1, i2) and torch.equal(o1, o2)


def test_post_transform_cache_flag_off(flood_fixture, monkeypatch):
    monkeypatch.setenv("FLOODGAN_POST_CACHE", "0")
    data_path, meta_dir = flood_fixture
    train, _, _ = create_flood_dataset("usa", "same", data_path, "all", 16, None, batch_size=2,
                                       metadata_dir=meta_dir, device="cpu")
    list(train.epoch_iter(1))
    assert len(train.dataset._post_cache._store) == 0
    assert train._assemble_from_post_cache([0, 1]) is None
    monkeypatch.setenv("FLOODGAN_POST_CACHE", "maybe")
    with pytest.raises(ValueError, match="FLOODGAN_POST_CACHE"):
        list(train.epoch_iter(1))


def test_post_transform_cache_capacity_guard(flood_fixture):
    data_path, meta_dir = flood_fixture
    train, _, _ = create_flood_dataset("usa", "same", data_path, "all", 16, None, batch_size=2,
                                       metadata_dir=meta_dir, device="cpu")
    train.dataset._post_cache.max_bytes = 1024  # << one sample
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        first = [b["input"].clone() for b in train.epoch_iter(1)]
    assert any("post-transform cache disabled" in str(x.message) for x in w)
    assert train.dataset._post_cache_disabled and len(train.dataset._post_cache._store) == 0
    second = [b["input"] for b in train.epoch_iter(1)]
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert train.post_cache_hits == 0 and train.post_cache_total == len(second)


def test_capacity_guard_sizes_on_the_iterated_stripe(flood_fixture):
    """A bound that holds the stripe being iterated but not the whole
    split keeps the cache on (the guard counts len(order))."""
    data_path, meta_dir = flood_fixture
    train, _, _ = create_flood_dataset("usa", "same", data_path, "all", 16, None, batch_size=2,
                                       metadata_dir=meta_dir, device="cpu")
    per_sample = 16 * 16 * (9 + 3) * 4
    assert len(train.dataset) == 6
    train.dataset._post_cache.max_bytes = 2 * per_sample
    list(train.iter_indices([0, 1]))
    assert not train.dataset._post_cache_disabled
    list(train.iter_indices([0, 1]))
    assert train.post_cache_hits == 1


def test_wire_dtype_bf16_rounds_only_the_raw_batch(flood_fixture, monkeypatch):
    data_path, meta_dir = flood_fixture
    kw = dict(batch_size=2, metadata_dir=meta_dir, device="cpu")
    plain = list(create_flood_dataset("usa", "same", data_path, "all", 16, None, **kw)[0].epoch_iter(1))
    monkeypatch.setenv("FLOODGAN_WIRE_DTYPE", "bfloat16")
    wire = list(create_flood_dataset("usa", "same", data_path, "all", 16, None, **kw)[0].epoch_iter(1))
    for a, b in zip(plain, wire):
        assert b["input"].dtype == torch.float32
        np.testing.assert_allclose(b["input"].numpy(), a["input"].numpy(), atol=2 * 2.0 ** -8)


def test_loader_without_device_needs_the_card(flood_fixture, monkeypatch):
    data_path, meta_dir = flood_fixture
    ds = FloodDataset("usa", "same", "train", data_path, "all", None, None, metadata_dir=meta_dir)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchLoader(ds)


def test_decoder_counters_and_python_fallback(flood_fixture, monkeypatch):
    """Each batch counts against the decoder that served it; with the native
    decoder off the Python codec serves the same values."""
    data_path, meta_dir = flood_fixture
    kw = dict(batch_size=2, metadata_dir=meta_dir, device="cpu")
    before = dict(native.BATCHES)
    a = list(create_flood_dataset("usa", "same", data_path, "all", None, None, **kw)[0].epoch_iter(1))
    assert native.BATCHES["native"] - before["native"] == len(a)
    monkeypatch.setattr(native, "decode_batch", lambda *args, **kwargs: None)
    before = dict(native.BATCHES)
    b = list(create_flood_dataset("usa", "same", data_path, "all", None, None, **kw)[0].epoch_iter(1))
    assert native.BATCHES["python"] - before["python"] == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x["input"], y["input"]) and torch.equal(x["output"], y["output"])
    assert os.path.isfile(native.LIBRARY)
