"""Self-describing single-file checkpoints in the JAX package's wire format.

The port of floodgan_tpu/ckpt/checkpoint.py, so that either package reads
the other's ``.ckpt`` files.  A file is one msgpack map
``{"meta": <JSON str>, "state": <bin>}``.  ``meta`` holds the model name,
topography, num_epochs, identity-loss flag, starting_epoch and the loss
history.  The ``state`` bin is itself msgpack, written as flax's
``msgpack_serialize`` writes a state dict:

- nested maps of str keys (a PairedState is ``{gen_params, disc_params,
  gen_opt: {count, mu, nu}, disc_opt}``);
- a numpy array is ext type 1, whose payload is the msgpack of
  ``(shape, dtype name, C-order bytes)``;
- a numpy scalar is ext type 3 with the same payload; it reads back as a
  numpy scalar;
- a bf16 array (a cycle trainer's replay buffers under bf16) has the dtype
  name ``bfloat16``.  numpy has no bf16, so it reads back as a
  ``BF16Array``, the raw 16-bit patterns, and a bf16 tensor or a
  ``BF16Array`` writes as one;
- an array over ``MAX_CHUNK_SIZE`` (2**30) bytes is written as flax
  writes it, a ``__msgpack_chunked_array__`` map of its shape and of
  1-D chunks of at most that many bytes, and read back whole (a 50-slot
  f32 buffer at 1024^2 x 9 channels is 1.89 GB).

No ``msgpack`` or ``flax`` is needed: the codec is ``ckpt/_msgpack.py``.
"""

from __future__ import annotations

import concurrent.futures as cf
import copy
import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from floodgan_tpu_torch.ckpt import _msgpack

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED_KEY = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE, read at each write


class BF16Array:
    """A bfloat16 array held as its raw 16-bit patterns (``bits``, uint16),
    since numpy has no bf16 type."""

    __slots__ = ("bits",)

    def __init__(self, bits: np.ndarray):
        self.bits = np.asarray(bits).view(np.uint16)

    @classmethod
    def from_tensor(cls, t) -> "BF16Array":
        return cls(t.detach().contiguous().view(torch.int16).cpu().numpy().view(np.uint16).copy())

    @property
    def shape(self) -> tuple:
        return self.bits.shape

    def to_tensor(self) -> torch.Tensor:
        return torch.from_numpy(self.bits.view(np.int16).copy()).view(torch.bfloat16)


def _as_array(x):
    """A numpy array, a ``BF16Array`` or None (not an array) for a leaf."""
    if isinstance(x, (np.ndarray, BF16Array)):
        return x
    if torch.is_tensor(x):
        return BF16Array.from_tensor(x) if x.dtype == torch.bfloat16 else x.detach().cpu().numpy()
    return None


def _array_payload(arr) -> list:
    """The chunks of flax's ``_ndarray_to_bytes``: msgpack of (shape,
    dtype name, bytes), with the data as a view, not a copy."""
    name = "bfloat16" if isinstance(arr, BF16Array) else None
    if name:
        arr = arr.bits
    if arr.dtype.hasobject or arr.dtype.names is not None:
        raise ValueError(f"cannot checkpoint an array of dtype {arr.dtype}")
    arr = np.require(arr, requirements="C")  # ascontiguousarray would make a 0-d array 1-d
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    chunks: list = []
    _msgpack.pack_into(
        [list(arr.shape), name or arr.dtype.name, memoryview(arr.reshape(-1)).cast("B")], chunks
    )
    return chunks


def _ext_default(x):
    if isinstance(x, np.generic):
        return _msgpack.ExtType(EXT_NPSCALAR, _array_payload(np.asarray(x)))
    arr = _as_array(x)
    if arr is None:
        raise TypeError(f"cannot checkpoint a {type(x).__name__}")
    return _msgpack.ExtType(EXT_NDARRAY, _array_payload(arr))


def _array_from_payload(data: memoryview):
    shape, dtype_name, buf = _msgpack.unpackb(data)
    if dtype_name == "bfloat16":
        return BF16Array(np.frombuffer(buf, dtype=np.uint16).reshape(shape))
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)


def _ext_hook(code: int, data: memoryview):
    if code == EXT_NDARRAY:
        return _array_from_payload(data)
    if code == EXT_NPSCALAR:
        return _array_from_payload(data)[()]
    raise ValueError(f"msgpack ext type {code} is not a checkpoint type")


def _chunked(arr) -> Dict[str, Any]:
    """flax's ``_chunk``: the array's shape and its flat data in 1-D
    chunks of at most ``MAX_CHUNK_SIZE`` bytes, each map keyed "0", "1", ..."""
    bits = arr.bits if isinstance(arr, BF16Array) else arr
    size = max(1, int(MAX_CHUNK_SIZE / bits.dtype.itemsize))
    flat = np.require(bits, requirements="C").reshape(-1)
    parts = [flat[i:i + size] for i in range(0, flat.size, size)]
    if isinstance(arr, BF16Array):
        parts = [BF16Array(p) for p in parts]
    return {CHUNKED_KEY: True, "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(i): p for i, p in enumerate(parts)}}


def _unchunked(d: Dict[str, Any]):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    parts = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if parts and isinstance(parts[0], BF16Array):
        return BF16Array(np.concatenate([p.bits for p in parts]).reshape(shape))
    return np.concatenate(parts).reshape(shape)


def _restore_chunks(tree: Any) -> Any:
    if isinstance(tree, dict):
        if CHUNKED_KEY in tree:
            return _unchunked(tree)
        return {k: _restore_chunks(v) for k, v in tree.items()}
    return tree


def _sorted(tree: Any) -> Any:
    """The tree with every map's keys sorted and every array leaf over
    ``MAX_CHUNK_SIZE`` bytes chunked, as flax's ``msgpack_serialize``
    leaves it."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    arr = _as_array(tree)
    if arr is not None:
        nbytes = arr.bits.nbytes if isinstance(arr, BF16Array) else arr.nbytes
        return _chunked(arr) if nbytes > MAX_CHUNK_SIZE else arr
    return tree


def serialize_state(state: Dict[str, Any]) -> List:
    """The chunks of the ``state`` bin: msgpack of a nested dict whose
    leaves are numpy arrays (or tensors) and scalars, every map's keys in
    sorted order (flax's ``msgpack_serialize`` copies the tree with a JAX
    ``tree_map``, which sorts them)."""
    chunks: List = []
    _msgpack.pack_into(_sorted(state), chunks, default=_ext_default)
    return chunks


def save_checkpoint(path: str, meta: Dict[str, Any], state: Dict[str, Any]) -> None:
    """Write ``{"meta": json(meta), "state": <msgpack of state>}`` to
    ``path`` through ``path.tmp`` and an atomic rename: a crash mid-write
    never leaves a torn file under ``path``."""
    state_chunks = serialize_state(state)
    head: List = []
    _msgpack.pack_into({"meta": json.dumps(meta), "state": b""}, head)
    # The empty bin's header goes; the state's chunks follow their own.
    head[-2:] = [_msgpack.bin_header(sum(memoryview(c).nbytes for c in state_chunks))]
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.writelines(head)
        f.writelines(state_chunks)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Returns (meta, raw state): the state as nested dicts of read-only
    numpy arrays (views into the file's bytes, or one copy for a chunked
    array), ``BF16Array``s and numpy scalars."""
    with open(path, "rb") as f:
        data = f.read()
    payload = _msgpack.unpackb(data)
    if not isinstance(payload, dict) or set(payload) != {"meta", "state"}:
        raise ValueError(f"{path} is not a floodgan checkpoint (expected a meta/state map)")
    meta = json.loads(payload["meta"])
    return meta, _restore_chunks(_msgpack.unpackb(payload["state"], ext_hook=_ext_hook))


def host_snapshot(tree: Any) -> Any:
    """``tree`` with every tensor or array leaf copied to host memory: what
    ``jax.device_get`` is to the JAX package.  The copies share nothing
    with the live parameters, which later steps change in place."""
    if isinstance(tree, dict):
        return {k: host_snapshot(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        arr = _as_array(tree)  # a BF16Array is a copy already
        return arr if isinstance(arr, BF16Array) else arr.copy()
    if isinstance(tree, np.ndarray):
        return tree.copy()
    if isinstance(tree, BF16Array):
        return BF16Array(tree.bits.copy())
    return tree


class AsyncCheckpointer:
    """Checkpoint writes off the training thread.

    ``save`` takes the host snapshot of the state and a deep copy of
    ``meta`` (it aliases the live loss lists) on the caller's thread, before
    the next step changes either, then hands serialisation and the write to
    one worker thread.  One write is in flight at a time: a second ``save``
    waits for the first, and surfaces its failure.  ``wait`` drains.
    """

    def __init__(self):
        self._pool = cf.ThreadPoolExecutor(max_workers=1)
        self._pending = None

    def save(self, path: str, meta: Dict[str, Any], state: Dict[str, Any]) -> None:
        self.wait()
        state = host_snapshot(state)
        meta = copy.deepcopy(meta)
        self._pending = self._pool.submit(save_checkpoint, path, meta, state)

    def wait(self) -> None:
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()

    def close(self) -> None:
        self.wait()
        self._pool.shutdown()
