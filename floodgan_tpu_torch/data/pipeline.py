"""Host-side dataset and prefetching batch loader, feeding the card.

The port of floodgan_tpu/data/pipeline.py.  Worker threads decode TIFFs
(the native C++ decoder, else the Python codec), copy the raw batch to the
loader's device and run the transform there (flip, channel slice, bicubic
antialiased resize, quadrant crop, [-1, 1]; ``data/transforms.py``),
``prefetch`` batches ahead of the consumer on a pool of ``num_workers``
threads.  Batches are
``{"input": (B,h,w,C), "output": (B,h,w,3), "names": [...]}``, f32 NHWC
tensors on the loader's device.  Mask batches (``MaskDataset``) are
``(B,H,W,3)`` images and ``(B,H,W,1)`` masks, flipped and nothing else, as
are flood batches with ``transform=False`` (the raw 9-channel stack and
3-channel output at the size on disk).

On the card each worker thread has its own CUDA stream.  The raw batch is
decoded into pinned host memory, copied with ``non_blocking=True`` on
that stream, and transformed there; an event recorded after the transform
is what the consumer's stream waits on before it reads the batch, and
``record_stream`` tells the caching allocator that the consumer's stream
uses the tensors, so their memory is not reused while a step still reads
them.

The epoch order is ``np.random.default_rng(epoch).permutation(n)``, as in
the JAX loader (the reference seeds torch's RNG with the epoch number), or
``np.arange(n)`` with ``shuffle=False``; ``drop_remainder=True`` drops a
short last batch.

Environment, with the JAX package's names and defaults:
- ``FLOODGAN_DECODE_CACHE_BYTES`` (4 GiB): the LRU cache of files the
  Python codec decoded, unless a dataset is given ``cache_bytes``;
- ``FLOODGAN_POST_CACHE`` (on) and ``FLOODGAN_POST_CACHE_BYTES`` (4 GiB):
  the post-transform cache.  Epoch 1 fetches each transformed sample to
  host memory once; later epochs copy the cached samples to the card and
  skip decode and transform.  A split that cannot fit whole turns the
  cache off with a warning;
- ``FLOODGAN_WIRE_DTYPE=bfloat16``: the raw batch crosses to the card in
  bf16 (half the bytes) and is upcast there.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import contextlib
import os
import threading
import time
import warnings
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from floodgan_tpu_torch.core.device import full_f32, resolve_device
from floodgan_tpu_torch.data import native, tiff
from floodgan_tpu_torch.data.splits import (
    FloodSample,
    MaskSample,
    determine_flood_dataset,
    determine_masks_dataset,
)
from floodgan_tpu_torch.data.transforms import apply_transformations_batch


class _LruBytesCache:
    """Bytes-bounded LRU cache of arrays, or of tuples of arrays (the
    post-transform cache keeps a sample's (input, output) under one key,
    so eviction never splits a sample)."""

    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._store: "collections.OrderedDict" = collections.OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()

    @staticmethod
    def _nbytes(value) -> int:
        if isinstance(value, tuple):
            return sum(a.nbytes for a in value)
        return value.nbytes

    def get(self, key: str):
        with self._lock:
            arr = self._store.get(key)
            if arr is not None:
                self._store.move_to_end(key)
            return arr

    def put(self, key: str, value) -> None:
        if self._nbytes(value) > self.max_bytes:
            return
        with self._lock:
            if key in self._store:
                return
            self._store[key] = value
            self._bytes += self._nbytes(value)
            while self._bytes > self.max_bytes:
                _, old = self._store.popitem(last=False)
                self._bytes -= self._nbytes(old)


def _env_bytes(name: str) -> int:
    return int(os.environ.get(name, 4 << 30))


def _decode_cache(cache_bytes: Optional[int]) -> _LruBytesCache:
    """The decode cache of ``cache_bytes`` (None: the environment's bound)."""
    return _LruBytesCache(_env_bytes("FLOODGAN_DECODE_CACHE_BYTES") if cache_bytes is None else cache_bytes)


def post_transform_cache() -> bool:
    """``FLOODGAN_POST_CACHE``: on unless set to a false value."""
    v = os.environ.get("FLOODGAN_POST_CACHE")
    if v is None or v.lower() in ("1", "true", "yes", "on"):
        return True
    if v.lower() in ("0", "false", "no", "off"):
        return False
    raise ValueError(f"FLOODGAN_POST_CACHE: unrecognized value {v!r}")


class FloodDataset:
    """Sample list and raw decode of the flood image pairs
    (reference models/data.py:46-81)."""

    def __init__(
        self,
        dataset_subset: str,
        dataset_dem: str,
        split: str,
        path: str,
        topography: Optional[str],
        resize: Optional[int],
        crop: Optional[int],
        metadata_dir: Optional[str] = None,
        cache_bytes: Optional[int] = None,
    ):
        self.samples: List[FloodSample] = determine_flood_dataset(
            dataset_subset, dataset_dem, crop, metadata_dir
        )[split]
        self.path = path
        self.topography = topography
        self.resize = resize
        self.crop = crop
        self._cache = _decode_cache(cache_bytes)
        # Keyed by sample index: the index pins (file, flip, crop index), and
        # the transform's settings are fixed per dataset.
        self._post_cache = _LruBytesCache(_env_bytes("FLOODGAN_POST_CACHE_BYTES"))
        self._post_cache_disabled = False
        self._raw_shape = None

    def __len__(self) -> int:
        return len(self.samples)

    def name(self, index: int) -> str:
        s = self.samples[index]
        return f"{s.image_name}_{s.crop_index}" if self.crop else s.image_name

    def input_path(self, index: int) -> str:
        return f"{self.path}/dataset_input/{self.samples[index].file_name}"

    def output_path(self, index: int) -> str:
        return f"{self.path}/dataset_output/{self.samples[index].image_name}.tif"

    def flags(self, index: int) -> Tuple[bool, int]:
        s = self.samples[index]
        return s.version == "flipped", s.crop_index

    def raw_shape(self) -> Tuple[int, int]:
        """(H, W) of the stacks on disk (one tile size per dataset)."""
        if self._raw_shape is None:
            self._raw_shape = self._read(self.input_path(0)).shape[:2]
        return self._raw_shape

    def read_raw(self, index: int) -> Tuple[np.ndarray, np.ndarray, bool, int]:
        """Decoded (input 9ch, output 3ch) float32 HWC, flip flag, crop
        index.  The flip itself runs in the transform."""
        flip, ci = self.flags(index)
        return self._read(self.input_path(index)), self._read(self.output_path(index)), flip, ci

    def _read(self, file_path: str) -> np.ndarray:
        arr = self._cache.get(file_path)
        if arr is None:
            arr = np.asarray(tiff.imread(file_path), dtype=np.float32)
            self._cache.put(file_path, arr)
        return arr


class MaskDataset:
    """Sample list and raw decode of the segmentation pairs (reference
    models/data.py:179-201): a 3-channel image under masks_input/ and its
    1-channel mask under masks_output/, the same file name."""

    def __init__(self, samples: Sequence[MaskSample], path: str, cache_bytes: Optional[int] = None):
        self.samples = list(samples)
        self.path = path
        self._cache = _decode_cache(cache_bytes)

    def __len__(self) -> int:
        return len(self.samples)

    def name(self, index: int) -> str:
        return self.samples[index].file_name

    def read_raw(self, index: int) -> Tuple[np.ndarray, np.ndarray, bool, int]:
        """Decoded (image 3ch, mask 1ch) float32 HWC, flip flag, crop index 0."""
        s = self.samples[index]
        inp = self._read(f"{self.path}/masks_input/{s.file_name}", channels=3)
        out = self._read(f"{self.path}/masks_output/{s.file_name}", channels=1)
        return inp, out, s.version == "flipped", 0

    def _read(self, file_path: str, channels: int) -> np.ndarray:
        arr = self._cache.get(file_path)
        if arr is None:
            arr = np.asarray(tiff.imread(file_path), dtype=np.float32)
            if arr.ndim == 2:
                arr = arr[:, :, None]
            arr = arr[:, :, :channels]
            self._cache.put(file_path, arr)
        return arr


Batch = Dict[str, object]


class BatchLoader:
    """Thread-prefetched batch iterator on ``device`` (None: the card, which
    raises where there is none), with the JAX loader's options:
    ``shuffle`` (the epoch's permutation, else index order), ``transform``
    (off: flood batches are the raw decoded stacks, flipped and nothing
    else), ``drop_remainder`` (no short last batch), ``num_workers`` (the
    worker threads) and ``prefetch`` (the batches in flight).

    ``post_cache_hits`` / ``post_cache_total`` count the batches of the
    current iteration that the post-transform cache served, and all of its
    batches.  ``stage_seconds`` sums, over the current iteration's batches,
    the worker-side seconds of each stage: ``alloc`` (the raw batch's host
    buffers, pinned on the card's path), ``decode`` (TIFF to host memory),
    ``device`` (H2D and transform, to the event; on the card it includes
    waiting for the card) and ``post_cache`` (the fetch that fills the
    cache, or the stack of cached samples).
    """

    def __init__(self, dataset: Union[FloodDataset, MaskDataset], batch_size: int = 1, shuffle: bool = True,
                 transform: bool = True, drop_remainder: bool = False, num_workers: int = 8, prefetch: int = 2,
                 device=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.transform = transform
        self.drop_remainder = drop_remainder
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.device = resolve_device(device, "BatchLoader")
        self.post_cache_hits = 0
        self.post_cache_total = 0
        self.stage_seconds = {"alloc": 0.0, "decode": 0.0, "device": 0.0, "post_cache": 0.0}
        self._lock = threading.Lock()
        self._streams = threading.local()
        self._stripe = len(dataset)

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_remainder:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def epoch_iter(self, epoch: int = 0) -> Iterator[Batch]:
        n = len(self.dataset)
        return self.iter_indices(np.random.default_rng(epoch).permutation(n) if self.shuffle else np.arange(n))

    def __iter__(self) -> Iterator[Batch]:
        return self.epoch_iter(0)

    def iter_indices(self, order) -> Iterator[Batch]:
        """Batches over an explicit sample order."""
        order = np.asarray(order)
        with self._lock:
            self.post_cache_hits = self.post_cache_total = 0
            self.stage_seconds = dict.fromkeys(self.stage_seconds, 0.0)
            self._stripe = len(order)
        batches = [order[i:i + self.batch_size] for i in range(0, len(order), self.batch_size)]
        if self.drop_remainder:
            batches = [b for b in batches if len(b) == self.batch_size]

        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending: "collections.deque" = collections.deque()
            bi = 0
            try:
                while bi < len(batches) and len(pending) < self.prefetch:
                    pending.append(pool.submit(self._produce, batches[bi]))
                    bi += 1
                while pending:
                    future = pending.popleft()
                    if bi < len(batches):
                        pending.append(pool.submit(self._produce, batches[bi]))
                        bi += 1
                    yield self._hand_over(future.result())
            finally:
                for f in pending:  # an abandoned iteration: let the workers finish
                    f.cancel()

    # ------------------------------------------------------------ workers

    def _stream(self):
        """This worker thread's CUDA stream (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        s = getattr(self._streams, "stream", None)
        if s is None:
            s = self._streams.stream = torch.cuda.Stream(self.device)
        return s

    def _add(self, stage: str, seconds: float) -> None:
        with self._lock:
            self.stage_seconds[stage] += seconds

    def _produce(self, idx_batch) -> Batch:
        cached = self._assemble_from_post_cache(idx_batch)
        with self._lock:
            self.post_cache_total += 1
            self.post_cache_hits += cached is not None
        if cached is not None:
            return cached
        if isinstance(self.dataset, MaskDataset):
            return self._assemble_flipped(idx_batch, *self._load_raw_masks(idx_batch))
        inputs, outputs, flips, crops = self._load_raw_batch(idx_batch)
        if not self.transform:
            return self._assemble_flipped(idx_batch, inputs, outputs, flips)
        return self._assemble(idx_batch, inputs, outputs, flips, crops)

    def _host_buffer(self, shape, dtype=torch.float32) -> torch.Tensor:
        """A host tensor for a batch: pinned when it goes to the card."""
        return torch.empty(shape, dtype=dtype, pin_memory=self.device.type == "cuda")

    def _load_raw_batch(self, idx_batch):
        """Whole-batch decode into host tensors: (inputs, outputs, flips,
        crop indices).  The native decoder writes straight into the
        (pinned) buffers; the Python codec is the fallback."""
        t0 = time.perf_counter()
        ds = self.dataset
        idx = [int(i) for i in idx_batch]
        h, w = ds.raw_shape()
        inputs = self._host_buffer((len(idx), h, w, 9))
        outputs = self._host_buffer((len(idx), h, w, 3))
        self._add("alloc", time.perf_counter() - t0)
        t0 = time.perf_counter()
        got_in = native.decode_batch([ds.input_path(i) for i in idx], h, w, 9, out=inputs.numpy())
        got_out = None
        if got_in is not None:
            got_out = native.decode_batch([ds.output_path(i) for i in idx], h, w, 3, out=outputs.numpy())
        if got_out is not None:
            native.count("native")
        else:
            for k, i in enumerate(idx):
                raw_in, raw_out, _, _ = ds.read_raw(i)
                inputs.numpy()[k] = raw_in
                outputs.numpy()[k] = raw_out
            native.count("python")
        flags = [ds.flags(i) for i in idx]
        self._add("decode", time.perf_counter() - t0)
        return inputs, outputs, [f[0] for f in flags], [f[1] for f in flags]

    def _to_device(self, *host: torch.Tensor) -> List[torch.Tensor]:
        return [t.to(self.device, non_blocking=True) for t in host]

    def _ready(self, stream, t0: float):
        """An event after the work queued so far on this worker's stream;
        the time to it counts as the ``device`` stage."""
        if stream is None:
            self._add("device", time.perf_counter() - t0)
            return None
        ev = torch.cuda.Event()
        ev.record(stream)
        ev.synchronize()
        self._add("device", time.perf_counter() - t0)
        return ev

    def _post_cache_active(self) -> bool:
        return (self.transform and isinstance(self.dataset, FloodDataset)
                and not self.dataset._post_cache_disabled and post_transform_cache())

    def _assemble_from_post_cache(self, idx_batch) -> Optional[Batch]:
        """The steady state: every sample's transformed pair is in host
        memory, so a batch is a stack and a copy to the card, with no decode
        and no transform.  None when any sample is missing (the first
        epoch, or an eviction)."""
        if not self._post_cache_active():
            return None
        pairs = [self.dataset._post_cache.get(str(int(i))) for i in idx_batch]
        if any(p is None for p in pairs):
            return None
        t0 = time.perf_counter()
        host_in = self._host_buffer((len(pairs),) + pairs[0][0].shape)
        host_out = self._host_buffer((len(pairs),) + pairs[0][1].shape)
        np.stack([p[0] for p in pairs], out=host_in.numpy())
        np.stack([p[1] for p in pairs], out=host_out.numpy())
        self._add("post_cache", time.perf_counter() - t0)
        t0 = time.perf_counter()
        stream = self._stream()
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            inp, out = self._to_device(host_in, host_out)
            ready = self._ready(stream, t0)
        names = [self.dataset.name(int(i)) for i in idx_batch]
        return {"input": inp, "output": out, "names": names, "_ready": ready}

    def _wire(self, inputs: torch.Tensor, outputs: torch.Tensor) -> tuple:
        """The raw batch as it crosses to the card: bf16 (half the bytes)
        under ``FLOODGAN_WIRE_DTYPE=bfloat16``, upcast to f32 there."""
        if os.environ.get("FLOODGAN_WIRE_DTYPE") != "bfloat16":
            return inputs, outputs
        return tuple(self._host_buffer(t.shape, torch.bfloat16).copy_(t) for t in (inputs, outputs))

    def _assemble(self, idx_batch, inputs, outputs, flips, crops) -> Batch:
        ds = self.dataset
        inputs, outputs = self._wire(inputs, outputs)
        names = [ds.name(int(i)) for i in idx_batch]
        t0 = time.perf_counter()
        stream = self._stream()
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            raw_in, raw_out = self._to_device(inputs, outputs)
            with full_f32():
                inp, out = apply_transformations_batch(
                    raw_in, raw_out, np.asarray(flips, bool), np.asarray(crops, np.int32),
                    topography=ds.topography, resize=ds.resize, crop=ds.crop,
                )
            del raw_in, raw_out
            ready = self._ready(stream, t0)
            if self._post_cache_active():
                self._fill_post_cache(idx_batch, inp, out)
        return {"input": inp, "output": out, "names": names, "_ready": ready}

    def _load_raw_masks(self, idx_batch):
        """A batch of decoded mask pairs in host tensors: (images, masks,
        flips)."""
        ds = self.dataset
        t0 = time.perf_counter()
        raws = [ds.read_raw(int(i)) for i in idx_batch]
        self._add("decode", time.perf_counter() - t0)
        t0 = time.perf_counter()
        host = [self._host_buffer((len(raws),) + raws[0][k].shape) for k in (0, 1)]
        for k, buf in enumerate(host):
            np.stack([r[k] for r in raws], out=buf.numpy())
        self._add("alloc", time.perf_counter() - t0)
        return host[0], host[1], [r[2] for r in raws]

    def _assemble_flipped(self, idx_batch, inputs, outputs, flips) -> Batch:
        """A batch flipped and nothing else: mask pairs (no resize, crop or
        [-1, 1]; reference models/data.py:191-196), and flood pairs with
        ``transform=False``.  Under the bf16 wire the pairs cross in bf16
        and are upcast to f32 on arrival."""
        inputs, outputs = self._wire(inputs, outputs)
        names = [self.dataset.name(int(i)) for i in idx_batch]
        t0 = time.perf_counter()
        stream = self._stream()
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            flip = torch.tensor(list(flips), device=self.device)[:, None, None, None]
            inp, out = (torch.where(flip, t.flip(2), t).float() for t in self._to_device(inputs, outputs))
            ready = self._ready(stream, t0)
        return {"input": inp, "output": out, "names": names, "_ready": ready}

    def _fill_post_cache(self, idx_batch, inp: torch.Tensor, out: torch.Tensor) -> None:
        """One fetch of the transform's own outputs fills the cache (exact by
        construction), unless the whole iterated stripe cannot fit under the
        byte bound: a batch hits only when every sample is resident, so a
        cache too small would pay this fetch every batch for ~no hits.  Then
        the cache turns itself off, with a warning."""
        ds = self.dataset
        per_sample = (inp[0].numel() * inp.element_size() + out[0].numel() * out.element_size())
        if per_sample * self._stripe > ds._post_cache.max_bytes:
            ds._post_cache_disabled = True
            warnings.warn(
                "post-transform cache disabled: split needs "
                f"{per_sample * self._stripe >> 20} MB ({self._stripe} samples x "
                f"{per_sample / 2**20:.1f} MB) > FLOODGAN_POST_CACHE_BYTES="
                f"{ds._post_cache.max_bytes >> 20} MB; raise the bound to enable the "
                "decode-free steady state"
            )
            return
        t0 = time.perf_counter()
        host_in, host_out = inp.cpu().numpy(), out.cpu().numpy()
        for k, i in enumerate(idx_batch):
            ds._post_cache.put(str(int(i)), (host_in[k].copy(), host_out[k].copy()))
        self._add("post_cache", time.perf_counter() - t0)

    # ------------------------------------------------------------ consumer

    def _hand_over(self, batch: Batch) -> Batch:
        """On the consumer's thread: its stream waits for the worker's
        event, and the allocator learns that stream uses the tensors."""
        ready = batch.pop("_ready")
        if ready is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(ready)
            for t in (batch["input"], batch["output"]):
                t.record_stream(consumer)
        return batch


def create_flood_dataset(
    dataset_subset: str,
    dataset_dem: str,
    path: str,
    topography: Optional[str],
    resize: Optional[int] = None,
    crop: Optional[int] = None,
    batch_size: int = 1,
    metadata_dir: Optional[str] = None,
    device=None,
) -> Tuple[BatchLoader, BatchLoader, BatchLoader]:
    """Train/validation/test loaders (reference models/data.py:11-44)."""
    return tuple(
        BatchLoader(
            FloodDataset(dataset_subset, dataset_dem, split, path, topography, resize, crop,
                         metadata_dir=metadata_dir),
            batch_size=batch_size, device=device,
        )
        for split in ("train", "validation", "test")
    )


def create_masks_dataset(
    dataset_subset: str,
    path: str,
    train_on_all: bool,
    batch_size: int = 1,
    metadata_dir: Optional[str] = None,
    device=None,
):
    """Mask loaders; the train loader only, with ``train_on_all``
    (reference models/data.py:148-177)."""
    splits = determine_masks_dataset(dataset_subset, train_on_all, metadata_dir)
    return tuple(
        None if samples is None else BatchLoader(MaskDataset(samples, path), batch_size=batch_size, device=device)
        for samples in splits
    )
