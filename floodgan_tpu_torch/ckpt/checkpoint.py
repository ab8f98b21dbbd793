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
  numpy scalar.

flax splits an array over 2**30 bytes into a ``__msgpack_chunked_array__``
map, and names bf16 arrays ``bfloat16``.  No state of this model has
either, so both raise here rather than being misread.

No ``msgpack`` or ``flax`` is needed: the codec is ``ckpt/_msgpack.py``.
"""

from __future__ import annotations

import concurrent.futures as cf
import copy
import json
import os
from typing import Any, Dict, List, Tuple

import numpy as np

from floodgan_tpu_torch.ckpt import _msgpack

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED_KEY = "__msgpack_chunked_array__"
MAX_ARRAY_BYTES = 2 ** 30


def _array_payload(arr: np.ndarray) -> list:
    """The chunks of flax's ``_ndarray_to_bytes``: msgpack of (shape,
    dtype name, bytes), with the data as a view, not a copy."""
    if arr.dtype.hasobject or arr.dtype.names is not None:
        raise ValueError(f"cannot checkpoint an array of dtype {arr.dtype}")
    if arr.nbytes > MAX_ARRAY_BYTES:
        raise ValueError(
            f"an array of {arr.nbytes} bytes would be chunked by flax "
            f"({CHUNKED_KEY}); this writer does not chunk"
        )
    arr = np.require(arr, requirements="C")  # ascontiguousarray would make a 0-d array 1-d
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    chunks: list = []
    _msgpack.pack_into(
        [list(arr.shape), arr.dtype.name, memoryview(arr.reshape(-1)).cast("B")], chunks
    )
    return chunks


def _ext_default(x):
    if isinstance(x, np.ndarray):
        return _msgpack.ExtType(EXT_NDARRAY, _array_payload(x))
    if isinstance(x, np.generic):
        return _msgpack.ExtType(EXT_NPSCALAR, _array_payload(np.asarray(x)))
    if hasattr(x, "detach") and hasattr(x, "numpy"):  # a torch tensor
        return _msgpack.ExtType(EXT_NDARRAY, _array_payload(x.detach().cpu().numpy()))
    raise TypeError(f"cannot checkpoint a {type(x).__name__}")


def _array_from_payload(data: memoryview) -> np.ndarray:
    shape, dtype_name, buf = _msgpack.unpackb(data)
    if dtype_name == "bfloat16":
        raise ValueError("bfloat16 arrays in a checkpoint are not supported by this reader")
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)


def _ext_hook(code: int, data: memoryview):
    if code == EXT_NDARRAY:
        return _array_from_payload(data)
    if code == EXT_NPSCALAR:
        return _array_from_payload(data)[()]
    raise ValueError(f"msgpack ext type {code} is not a checkpoint type")


def _check_unchunked(tree: Any, path: str = "state") -> None:
    if isinstance(tree, dict):
        if CHUNKED_KEY in tree:
            raise ValueError(f"{path} is a flax chunked array (over 2**30 bytes); not supported")
        for k, v in tree.items():
            _check_unchunked(v, f"{path}/{k}")


def _sorted(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
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
    numpy arrays (views into the file's bytes) and numpy scalars."""
    with open(path, "rb") as f:
        data = f.read()
    payload = _msgpack.unpackb(data)
    if not isinstance(payload, dict) or set(payload) != {"meta", "state"}:
        raise ValueError(f"{path} is not a floodgan checkpoint (expected a meta/state map)")
    meta = json.loads(payload["meta"])
    state = _msgpack.unpackb(payload["state"], ext_hook=_ext_hook)
    _check_unchunked(state)
    return meta, state


def host_snapshot(tree: Any) -> Any:
    """``tree`` with every tensor or array leaf copied to host memory: what
    ``jax.device_get`` is to the JAX package.  The copies share nothing
    with the live parameters, which later steps change in place."""
    if isinstance(tree, dict):
        return {k: host_snapshot(v) for k, v in tree.items()}
    if hasattr(tree, "detach"):
        return tree.detach().cpu().numpy().copy()
    if isinstance(tree, np.ndarray):
        return tree.copy()
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
