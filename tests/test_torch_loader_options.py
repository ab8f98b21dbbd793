"""The options of the port's ``BatchLoader``, ``FloodDataset``,
``MaskDataset`` and ``MultiHostBatchLoader`` against the JAX package's
(floodgan_tpu/data/pipeline.py:92, :165, :207-216;
floodgan_tpu/parallel/multihost.py:63-92), on tests/test_torch_data.py's
32^2 fixture.  Transformed batches are held within the 2e-4 that
tests/test_torch_ops.py holds the resize to; ``transform=False`` batches
(the raw stacks, flipped) bit for bit.

- ``shuffle=False``: index order, the same names and values as JAX's.
- ``drop_remainder``: a dataset of 5 at batch 2 gives 2 batches dropped,
  3 kept, as JAX's length and batches.
- ``transform=False``: JAX's raw batches bit for bit.
- ``num_workers`` 1 and 8, ``prefetch`` 1 and 3: the same batches.
- ``cache_bytes=0`` on the Python codec: the same batches as the default
  cache, and the decode cache never holds a file; the default is the
  environment's bound.
- ``MultiHostBatchLoader(shuffle=False)``: JAX's names in index order.
"""

import numpy as np
import pytest
import torch

from floodgan_tpu.data.pipeline import BatchLoader as JaxBatchLoader
from floodgan_tpu.data.pipeline import FloodDataset as JaxFloodDataset
from floodgan_tpu.parallel import make_mesh as jax_make_mesh
from floodgan_tpu.parallel.multihost import MultiHostBatchLoader as JaxMultiHostBatchLoader
from floodgan_tpu_torch.data import native
from floodgan_tpu_torch.data.pipeline import BatchLoader, FloodDataset, MaskDataset
from floodgan_tpu_torch.data.splits import MaskSample
from floodgan_tpu_torch.parallel.multihost import MultiHostBatchLoader

from fixtures import make_flood_fixture
from torch_seg_fixtures import few_torch_threads

TOL_RESIZE = 2e-4  # tests/test_torch_ops.py's bound for the bicubic-AA resize


@pytest.fixture(scope="module", autouse=True)
def _threads():
    yield from few_torch_threads()


@pytest.fixture(scope="module")
def flood_fixture(tmp_path_factory):
    return make_flood_fixture(tmp_path_factory.mktemp("flood_opts"), size=32, n_per_disaster=3)


def _datasets(fixture, resize=16, n=None, **ours_kw):
    """(port, JAX) train datasets of the 'usa'/'same' split, topography
    all, the first ``n`` samples (None: all)."""
    data_path, meta_dir = fixture
    ours = FloodDataset("usa", "same", "train", data_path, "all", resize, None, metadata_dir=meta_dir, **ours_kw)
    theirs = JaxFloodDataset("usa", "same", "train", data_path, "all", resize, None, metadata_dir=meta_dir)
    if n is not None:
        ours.samples, theirs.samples = ours.samples[:n], theirs.samples[:n]
    return ours, theirs


def _assert_batches_match(got, want, exact=False):
    assert [b["names"] for b in got] == [b["names"] for b in want]
    for a, b in zip(got, want):
        for key in ("input", "output"):
            assert a[key].dtype == torch.float32 and a[key].device.type == "cpu"
            if exact:
                np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]))
            else:
                np.testing.assert_allclose(a[key].numpy(), np.asarray(b[key]), atol=TOL_RESIZE)


def _assert_same(got, want):
    assert [b["names"] for b in got] == [b["names"] for b in want]
    for a, b in zip(got, want):
        assert torch.equal(a["input"], b["input"]) and torch.equal(a["output"], b["output"])


def test_unshuffled_order_matches_jax(flood_fixture):
    ours, theirs = _datasets(flood_fixture)
    a = BatchLoader(ours, batch_size=2, shuffle=False, device="cpu")
    b = JaxBatchLoader(theirs, batch_size=2, shuffle=False, num_workers=2)
    for epoch in (0, 3):  # the epoch does not move an unshuffled order
        got = list(a.epoch_iter(epoch))
        assert [n for x in got for n in x["names"]] == [ours.name(i) for i in range(len(ours))]
        _assert_batches_match(got, list(b.epoch_iter(epoch)))


@pytest.mark.parametrize("drop_remainder,length", [(True, 2), (False, 3)])
def test_drop_remainder_matches_jax(flood_fixture, drop_remainder, length):
    ours, theirs = _datasets(flood_fixture, n=5)
    a = BatchLoader(ours, batch_size=2, drop_remainder=drop_remainder, device="cpu")
    b = JaxBatchLoader(theirs, batch_size=2, drop_remainder=drop_remainder, num_workers=2)
    assert len(a) == len(b) == length
    got = list(a.epoch_iter(4))
    assert len(got) == length and [len(x["names"]) for x in got] == [2, 2, 1][:length]
    _assert_batches_match(got, list(b.epoch_iter(4)))


@pytest.mark.parametrize("shuffle", [True, False])
def test_untransformed_batches_match_jax_bit_for_bit(flood_fixture, shuffle):
    ours, theirs = _datasets(flood_fixture)
    a = BatchLoader(ours, batch_size=2, shuffle=shuffle, transform=False, device="cpu")
    b = JaxBatchLoader(theirs, batch_size=2, shuffle=shuffle, transform=False, num_workers=2)
    for epoch in (1, 2):  # no post-transform cache to serve the second epoch
        got = list(a.epoch_iter(epoch))
        assert got[0]["input"].shape == (2, 32, 32, 9) and got[0]["output"].shape == (2, 32, 32, 3)
        _assert_batches_match(got, list(b.epoch_iter(epoch)), exact=True)
        assert a.post_cache_hits == 0 and a.post_cache_total == len(got)
    assert len(ours._post_cache._store) == 0


@pytest.mark.parametrize("num_workers,prefetch", [(1, 1), (1, 3), (8, 1), (8, 3)])
def test_workers_and_depth_change_no_batch(flood_fixture, num_workers, prefetch):
    ours, theirs = _datasets(flood_fixture)
    reference = list(BatchLoader(_datasets(flood_fixture)[0], batch_size=2, device="cpu").epoch_iter(2))
    a = BatchLoader(ours, batch_size=2, num_workers=num_workers, prefetch=prefetch, device="cpu")
    for epoch in (2, 2):  # the second pass from the post-transform cache
        _assert_same(list(a.epoch_iter(epoch)), reference)
    b = JaxBatchLoader(theirs, batch_size=2, num_workers=num_workers, prefetch=prefetch)
    _assert_batches_match(reference, list(b.epoch_iter(2)))


def test_zero_cache_bytes_decodes_every_time(flood_fixture, monkeypatch):
    monkeypatch.setattr(native, "decode_batch", lambda *args, **kwargs: None)  # the Python codec reads the cache
    cached, _ = _datasets(flood_fixture, resize=None)
    uncached, theirs = _datasets(flood_fixture, resize=None, cache_bytes=0)
    gets = []
    get = uncached._cache.get
    monkeypatch.setattr(uncached._cache, "get", lambda key: gets.append(get(key)) or gets[-1])
    kw = dict(batch_size=2, transform=False, device="cpu")
    for epoch in (1, 2):
        got = list(BatchLoader(uncached, **kw).epoch_iter(epoch))
        _assert_same(got, list(BatchLoader(cached, **kw).epoch_iter(epoch)))
        _assert_batches_match(got, list(JaxBatchLoader(theirs, batch_size=2, transform=False,
                                                       num_workers=2).epoch_iter(epoch)), exact=True)
    assert len(uncached._cache._store) == 0 and gets and all(g is None for g in gets)
    files = {f(i) for i in range(len(cached)) for f in (cached.input_path, cached.output_path)}
    assert set(cached._cache._store) == files  # a flipped copy shares its original's files


def test_cache_bytes_defaults_to_the_environment(flood_fixture, monkeypatch):
    monkeypatch.setenv("FLOODGAN_DECODE_CACHE_BYTES", "12345")
    assert _datasets(flood_fixture)[0]._cache.max_bytes == 12345
    assert MaskDataset([], "unused")._cache.max_bytes == 12345
    assert _datasets(flood_fixture, cache_bytes=7)[0]._cache.max_bytes == 7
    assert MaskDataset([MaskSample("a.tif", "original")], "unused", cache_bytes=0)._cache.max_bytes == 0


def test_unshuffled_multihost_loader_matches_jax(flood_fixture):
    ours, theirs = _datasets(flood_fixture, resize=None)
    jax_loader = JaxMultiHostBatchLoader(theirs, jax_make_mesh(2), 4, shuffle=False, process_index=0,
                                         process_count=1, num_workers=2, prefetch=1)
    for index, count in ((0, 1), (0, 2), (1, 2)):
        loader = MultiHostBatchLoader(ours, 4, index, count, shuffle=False, num_workers=2, prefetch=1, device="cpu")
        assert len(loader) == len(jax_loader) == len(ours) // 4
        lo, hi = loader.stripe
        for epoch in (0, 5):
            want = [b["names"][lo:hi] for b in jax_loader.epoch_iter(epoch)]
            assert [b["names"] for b in loader.epoch_iter(epoch)] == want
    assert [n for b in jax_loader.epoch_iter(0) for n in b["names"]] == [ours.name(i) for i in range(4)]
