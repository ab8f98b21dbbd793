"""Where the port runs, and its f32 semantics on the card.

The entry points (``InferenceEngine``, ``PairedTrainer``) run on the card
unless the caller asks for the CPU, and raise where there is no card.
"""

from __future__ import annotations

import contextlib
import subprocess
import threading

import torch

# cuDNN and cuBLAS read the TF32 switches, which are process-wide, when an
# op is enqueued.  One lock keeps a forward on one thread from seeing
# another thread's restore.
_F32_LOCK = threading.Lock()


@contextlib.contextmanager
def full_f32():
    """Run the body with TF32 off for cuDNN convolutions
    (``torch.backends.cudnn.allow_tf32``) and CUDA matmuls
    (``torch.backends.cuda.matmul.allow_tf32``), restoring both after: the
    f32 semantics that the JAX package's CPU goldens pin."""
    with _F32_LOCK:
        saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def resolve_device(device, who: str) -> torch.device:
    """``device``, or the card for None; raises for the card where there is
    none, never falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: no CUDA device is available.  It runs on the card; pass "
            "device='cpu' explicitly to run the plain PyTorch versions."
        )
    return dev


def card_label(index: int = 0) -> str:
    """Card ``index``'s name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them, the
    line written beside every number measured on it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", f"--id={index}"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
