"""Per-process checkpoint directories for runs on a mesh: the port of
floodgan_tpu/ckpt/sharded.py, in its directory format, so that either
package reads the other's.

    ckpt_dir/
      meta.json            - written by process 0: {"meta", "manifest",
                             "process_count"}, the manifest mapping each
                             leaf's '/'-joined path to its global shape and
                             dtype name
      shards_p{i}.msgpack  - the pieces process i is responsible for:
                             {path: [{"index": [[start, stop], ...],
                             "data": <C-order bytes>}, ...]}

Responsibility is JAX's rule: a process writes a piece iff it holds
replica 0 of it, so each datum is written once.  On a ``D x S`` mesh
(data and spatial axes) every parameter and optimizer leaf is replicated
and replica 0 lives on rank 0, so rank 0 writes every leaf whole, and the
process count is the world size, ``D x S``.  A leaf sharded over rows
(the cycle trainer's replay buffers on a spatial axis, each rank holding
rows ``[start, stop)`` of axis 1 of every image) is written piecewise:
each spatial rank of data stripe 0 holds replica 0 of its rows and writes
them as one piece, whose index says which rows they are; the manifest
records the whole leaf's shape.  Every process
writes its own file, atomically (``.tmp`` and a rename).  Process 0 then
removes the shard files of a larger topology saved into the same
directory before; a loader ignores files at or above the recorded process
count in any case.

Loading reads the manifest and every live shard file, checks that the
pieces cover each leaf exactly (a missing or duplicated shard raises
rather than restoring unset memory) and assembles the whole state tree as
``ckpt.load_checkpoint`` returns it: nested dicts of numpy arrays, with
``BF16Array`` for bf16 leaves.  The files are msgpack, through the port's
own codec (``ckpt/_msgpack.py``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from floodgan_tpu_torch.ckpt import _msgpack
from floodgan_tpu_torch.ckpt.checkpoint import BF16Array, _as_array, host_snapshot

SEP = "/"
META_FILE = "meta.json"


def _shard_file(i: int) -> str:
    return f"shards_p{i}.msgpack"


def _shard_index(fname: str):
    """i of ``shards_p{i}.msgpack``, else None."""
    if not (fname.startswith("shards_p") and fname.endswith(".msgpack")):
        return None
    try:
        return int(fname[len("shards_p"):-len(".msgpack")])
    except ValueError:
        return None


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    if isinstance(tree, dict):
        out: Dict[str, Any] = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{SEP}{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    for path, value in flat.items():
        *keys, last = path.split(SEP)
        node = root
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = value
    return root


def _leaf_array(leaf):
    arr = _as_array(leaf)
    return np.asarray(leaf) if arr is None else arr


def _write_atomic(path: str, chunks: List) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.writelines(chunks)
    os.replace(tmp, path)


def save_checkpoint_sharded(ckpt_dir: str, meta: Dict[str, Any], state: Dict[str, Any],
                            process_index: int = 0, process_count: int = 1,
                            rows: Optional[Dict[str, Tuple[int, int, int]]] = None,
                            writes_rows: bool = False) -> None:
    """Write this process's shard file and, on process 0, the manifest.
    Every process of the run calls it with the same replicated leaves;
    ``rows`` maps the path of each leaf this process holds only rows of to
    (start, stop, height): its axis 1 is rows [start, stop) of ``height``.
    ``writes_rows``: this process holds replica 0 of those rows and writes
    them."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = {path: _leaf_array(leaf) for path, leaf in _flatten(host_snapshot(state)).items()}
    rows = rows or {}
    manifest, mine = {}, {}
    for path, arr in flat.items():
        bf16 = isinstance(arr, BF16Array)
        data = np.require(arr.bits if bf16 else arr, requirements="C")
        index = [[0, d] for d in data.shape]
        shape = list(data.shape)
        if path in rows:
            start, stop, height = rows[path]
            if data.shape[1] != stop - start:
                raise ValueError(f"leaf '{path}' holds {data.shape[1]} rows, not rows [{start}, {stop})")
            index[1], shape[1] = [start, stop], height
        manifest[path] = {"shape": shape, "dtype": "bfloat16" if bf16 else data.dtype.name}
        if (writes_rows if path in rows else process_index == 0):
            mine[path] = [{"index": index, "data": memoryview(data.reshape(-1)).cast("B")}]
    chunks: List = []
    _msgpack.pack_into(mine, chunks)
    _write_atomic(os.path.join(ckpt_dir, _shard_file(process_index)), chunks)
    if process_index == 0:
        header = json.dumps({"meta": meta, "manifest": manifest, "process_count": process_count})
        _write_atomic(os.path.join(ckpt_dir, META_FILE), [header.encode()])
        for fname in os.listdir(ckpt_dir):
            i = _shard_index(fname)
            if i is not None and i >= process_count:
                os.remove(os.path.join(ckpt_dir, fname))


def _dtype(name: str) -> np.dtype:
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def load_checkpoint_sharded(ckpt_dir: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(meta, state) from a checkpoint directory, whatever the process
    count that wrote it: the state as ``ckpt.load_checkpoint`` returns it."""
    with open(os.path.join(ckpt_dir, META_FILE)) as f:
        header = json.load(f)
    manifest = header["manifest"]
    saved_procs = header.get("process_count")
    pieces: Dict[str, list] = {}
    for fname in sorted(os.listdir(ckpt_dir)):
        i = _shard_index(fname)
        if i is None or (saved_procs is not None and i >= saved_procs):
            continue
        with open(os.path.join(ckpt_dir, fname), "rb") as f:
            for path, entries in _msgpack.unpackb(f.read()).items():
                pieces.setdefault(path, []).extend(entries)

    flat = {}
    for path, info in manifest.items():
        shape = tuple(info["shape"])
        total = int(np.prod(shape, dtype=np.int64))
        got = sum(int(np.prod([b - a for a, b in e["index"]], dtype=np.int64)) for e in pieces.get(path, []))
        if got != total:
            raise ValueError(
                f"sharded checkpoint {ckpt_dir} does not exactly cover leaf '{path}': {got}/{total} elements "
                "present - shard files are missing (partial copy / crashed save) or duplicated"
            )
        dtype = _dtype(info["dtype"])
        out = np.empty(shape, dtype)
        for e in pieces.get(path, []):
            block = np.frombuffer(e["data"], dtype).reshape([b - a for a, b in e["index"]])
            out[tuple(slice(a, b) for a, b in e["index"])] = block
        flat[path] = BF16Array(out) if info["dtype"] == "bfloat16" else out
    return header["meta"], _unflatten(flat)


def is_sharded_checkpoint(path: str) -> bool:
    return os.path.isdir(path) and os.path.isfile(os.path.join(path, META_FILE))
