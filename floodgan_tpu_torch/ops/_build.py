"""Build the port's CUDA kernels and bind them with ctypes.

Each ``csrc/*.cu`` file is compiled by its own nvcc call, all started
together, and the objects are linked into one shared library with a plain
C interface (no PyTorch headers, so the build takes seconds).  The library
lands in ``floodgan_tpu_torch/build/`` under a name that carries a hash of
the sources and flags, so an edited source is rebuilt and an unchanged one
is loaded as it is.  Nothing here runs at import: the first launch on a
CUDA tensor calls ``library()``.  A missing nvcc or a failed build raises
with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Tuple

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills per kernel, into the build log
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_P, _I64, _I32, _F32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float

# C entry points and their argument types.  Every pointer and the stream
# are c_void_p: ctypes would otherwise pass a Python int as a 32-bit int.
SIGNATURES = {
    # x, residual (or NULL), y, stats out (or NULL), planes, hw, relu, slope, eps, stream
    "floodgan_in_act_f32": (_P, _P, _P, _P, _I64, _I64, _I32, _F32, _F32, _P),
    "floodgan_in_act_bf16": (_P, _P, _P, _P, _I64, _I64, _I32, _F32, _F32, _P),
    # x, g, saved stats (or NULL), dx, planes, hw, relu, slope, eps, stream
    "floodgan_in_bwd_f32": (_P, _P, _P, _P, _I64, _I64, _I32, _F32, _F32, _P),
    "floodgan_in_bwd_bf16": (_P, _P, _P, _P, _I64, _I64, _I32, _F32, _F32, _P),
    # The partial forms: x, stats, planes, hw, rows, stream
    "floodgan_in_stats_f32": (_P, _P, _I64, _I64, _F32, _P),
    "floodgan_in_stats_bf16": (_P, _P, _I64, _I64, _F32, _P),
    # x, residual (or NULL), stats, y, planes, hw, row elements, relu, slope, eps, stream
    "floodgan_in_apply_f32": (_P, _P, _P, _P, _I64, _I64, _F32, _I32, _F32, _F32, _P),
    "floodgan_in_apply_bf16": (_P, _P, _P, _P, _I64, _I64, _F32, _I32, _F32, _F32, _P),
    # x, g, stats, gsums, planes, hw, row elements, relu, slope, eps, stream
    "floodgan_in_bwd_stats_f32": (_P, _P, _P, _P, _I64, _I64, _F32, _I32, _F32, _F32, _P),
    "floodgan_in_bwd_stats_bf16": (_P, _P, _P, _P, _I64, _I64, _F32, _I32, _F32, _F32, _P),
    # x, g, stats, gsums, dx, planes, hw, row elements, relu, slope, eps, stream
    "floodgan_in_bwd_apply_f32": (_P, _P, _P, _P, _P, _I64, _I64, _F32, _I32, _F32, _F32, _P),
    "floodgan_in_bwd_apply_bf16": (_P, _P, _P, _P, _P, _I64, _I64, _F32, _I32, _F32, _F32, _P),
    # content, logits, rgb, out, mask, batch, hw, rgb batch stride, stream
    "floodgan_attention_compose_f32": (_P, _P, _P, _P, _P, _I64, _I64, _I64, _P),
    "floodgan_attention_compose_bf16": (_P, _P, _P, _P, _P, _I64, _I64, _I64, _P),
    # content, logits, rgb, gout, gmask (or NULL), dcontent, dlogits,
    # drgb (or NULL), batch, hw, rgb batch stride, stream
    "floodgan_attention_compose_bwd_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _P),
    "floodgan_attention_compose_bwd_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _P),
    # src, dst, bytes, stream
    "floodgan_row_copy": (_P, _P, _I64, _P),
    # g, dx, planes, h, w, left, right, top, bottom, then the band plan
    # (band rows, bands, stage bytes, stages), stream
    "floodgan_reflect_pad_bwd_f32": (_P, _P, _I64, *(_I32,) * 10, _P),
    "floodgan_reflect_pad_bwd_bf16": (_P, _P, _I64, *(_I32,) * 10, _P),
}

_lock = threading.Lock()
_lib = None


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the CUDA kernels cannot be built"
    )


def _run_all(cmds) -> str:
    """Run the commands together; wait for every one.  Returns their
    output, or raises with the output of the first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}:\n{' '.join(cmd)}\n{out}"
            )
    return "".join(outs)


def build() -> Tuple[Path, str]:
    """Compile the kernels unless the library for the current sources
    exists.  Returns (library path, compiler output; "" when reused)."""
    out = BUILD_DIR / f"libfloodgan_kernels_{source_hash()}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [Path(tmpdir) / f"{src.stem}.o" for src in sources()]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                        for src, o in zip(sources(), objs)])
        tmp = Path(tmpdir) / out.name
        log += _run_all([[nvcc, *LINK_FLAGS, "-o", str(tmp), *(str(o) for o in objs)]])
        os.replace(tmp, out)
    return out, log


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
