"""Striped data loading for data-parallel ranks: the port of
floodgan_tpu/parallel/multihost.py.

Every rank computes the same seeded epoch plan (the shuffle is keyed by
the epoch number alone, as in ``data.pipeline.BatchLoader``; index order
with ``shuffle=False``), so no
coordination traffic is needed; each rank decodes only its contiguous
stripe of every global batch and yields that stripe on its own card.
With one rank this is ``BatchLoader`` with the remainder batch dropped.
On a mesh with a spatial axis every rank of a stripe decodes the stripe's
images and, after the on-device resize and crop, keeps its own rows.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from floodgan_tpu_torch.data.pipeline import Batch, BatchLoader
from floodgan_tpu_torch.parallel.spatial import row_stripe


def process_stripe(global_batch: int, process_index: int, process_count: int) -> tuple:
    """Half-open [start, stop) sample range of ``process_index`` within a
    global batch under contiguous striping, GSPMD's process-major order.
    The batch must divide evenly."""
    if global_batch % process_count:
        raise ValueError(f"global batch {global_batch} must divide over {process_count} processes")
    per = global_batch // process_count
    return process_index * per, (process_index + 1) * per


class MultiHostBatchLoader:
    """Each rank's stripe of every global batch of ``dataset``, on
    ``device``: ``{"input", "output", "names"}`` as ``BatchLoader`` yields
    them, with ``batch_size // process_count`` samples and ``names``
    covering the local stripe only; with ``spatial_count > 1``, rows
    ``row_stripe(H, spatial_index, spatial_count)`` of each image.  Global batches always tile the ranks
    (the remainder is dropped).  The stage counters are the local
    loader's."""

    drop_remainder = True

    def __init__(self, dataset, batch_size: int, process_index: int = 0, process_count: int = 1, device=None,
                 spatial_index: int = 0, spatial_count: int = 1, shuffle: bool = True, num_workers: int = 8,
                 prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.process_index = process_index
        self.process_count = process_count
        self.spatial_index = spatial_index
        self.spatial_count = spatial_count
        self.stripe = process_stripe(batch_size, process_index, process_count)
        # The local loader takes the stripe in the order given, short batches kept.
        self._local = BatchLoader(dataset, batch_size=batch_size // process_count, shuffle=False,
                                  drop_remainder=False, num_workers=num_workers, prefetch=prefetch, device=device)
        self.device = self._local.device
        self._auto_epoch = 0

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def __getattr__(self, name):
        if name in ("post_cache_hits", "post_cache_total", "stage_seconds"):
            return getattr(self._local, name)
        raise AttributeError(name)

    def local_indices(self, epoch: int = 0) -> np.ndarray:
        """This rank's samples of the epoch, global batch after global batch."""
        n = len(self.dataset)
        order = np.random.default_rng(epoch).permutation(n) if self.shuffle else np.arange(n)
        lo, hi = self.stripe
        usable = (n // self.batch_size) * self.batch_size
        return np.concatenate([order[s + lo:s + hi] for s in range(0, usable, self.batch_size)] or
                              [np.zeros(0, np.int64)])

    def epoch_iter(self, epoch: int = 0) -> Iterator[Batch]:
        batches = self._local.iter_indices(self.local_indices(epoch))
        if self.spatial_count == 1:
            return batches
        return (self._rows(b) for b in batches)

    def _rows(self, batch: Batch) -> Batch:
        """This spatial rank's rows of each NHWC image of ``batch``."""
        lo, hi = row_stripe(batch["input"].shape[1], self.spatial_index, self.spatial_count)
        return {**batch, "input": batch["input"][:, lo:hi], "output": batch["output"][:, lo:hi]}

    def __iter__(self) -> Iterator[Batch]:
        """Each plain iteration advances the shuffle epoch, in step on every
        rank; ``epoch_iter(k)`` leaves the counter alone."""
        epoch = self._auto_epoch
        self._auto_epoch += 1
        return self.epoch_iter(epoch)

