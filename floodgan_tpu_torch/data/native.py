"""ctypes binding of the native (C++) batch TIFF decoder.

The port's own loader of ``native/tiff_decoder.cpp`` (the JAX package's is
floodgan_tpu/data/native.py).  At first use it compiles the source with
``g++ -O3 -fPIC -shared ... -lz -lpthread`` into
``floodgan_tpu_torch/build/`` (gitignored), again whenever the source is
newer than the library, and writes nothing into ``native/``.  Where the
build fails (no compiler, no zlib headers) or a file falls outside the
decoder's coverage (it returns an error code rather than guessing), it
warns once and the loader uses the Python codec (``data/tiff.py``), about
100x slower.  This is host code: the card never sees it.

``BATCHES`` counts the batches each decoder served, so a run can say which
one fed it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
import warnings
from pathlib import Path
from typing import List, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "tiff_decoder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
LIBRARY = BUILD_DIR / "libfloodgan_tiff.so"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

BATCHES = {"native": 0, "python": 0}

_lock = threading.Lock()
_lib = None
_tried = False
_warned = set()


def _warn_once(key: str, msg: str) -> None:
    with _lock:
        if key in _warned:
            return
        _warned.add(key)
    warnings.warn(msg, stacklevel=3)


def count(decoder: str) -> None:
    with _lock:
        BATCHES[decoder] += 1


def build() -> Path:
    """Compile the decoder unless the library is newer than its source."""
    if LIBRARY.is_file() and LIBRARY.stat().st_mtime >= SOURCE.stat().st_mtime:
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = os.environ.get("CXX", "g++")
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        tmp = Path(tmpdir) / LIBRARY.name
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lz", "-lpthread"],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed with exit code {proc.returncode}:\n{proc.stderr}")
        os.replace(tmp, LIBRARY)
    return LIBRARY


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("FLOODGAN_DISABLE_NATIVE"):
            return None
        try:
            lib = ctypes.CDLL(str(build()))
            lib.floodgan_decode_batch.restype = ctypes.c_int
            lib.floodgan_decode_batch.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ]
            _lib = lib
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _lib = None
            err = e
    if _lib is None:
        _warn_once("build", "native TIFF decoder unavailable (build/load failed: "
                            f"{type(err).__name__}: {err}); falling back to the ~100x slower "
                            "pure-python codec.  Set FLOODGAN_DISABLE_NATIVE=1 to silence this "
                            "if intentional.")
    return _lib


def decode_batch(paths: List[str], h: int, w: int, c: int, out: Optional[np.ndarray] = None,
                 num_threads: int = 0) -> Optional[np.ndarray]:
    """Decode ``paths`` into one (N, h, w, c) float32 array on a C++ thread
    pool: into ``out`` when given (C-contiguous, e.g. a view of pinned
    memory), else a new array.  Returns None, after one warning, if the
    library is unavailable or a file is outside its coverage; the caller
    then decodes with the Python codec."""
    lib = _load()
    if lib is None:
        return None
    shape = (len(paths), h, w, c)
    if out is None:
        out = np.empty(shape, dtype=np.float32)
    if out.shape != shape or out.dtype != np.float32 or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous float32 {shape}, got {out.dtype} {out.shape}")
    joined = b"\0".join(p.encode() for p in paths) + b"\0"
    threads = num_threads or min(len(paths), os.cpu_count() or 1)
    rc = lib.floodgan_decode_batch(joined, len(paths), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                   h, w, c, threads)
    if rc != 0:
        _warn_once("coverage", f"native TIFF decoder returned {rc} for a batch (a file outside its "
                               "coverage); those batches use the pure-python codec")
        return None
    return out
