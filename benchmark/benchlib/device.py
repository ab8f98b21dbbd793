"""The card: whether there is one, its name and power limit, its peaks.

``_PEAK_TFLOPS`` and ``peak_tflops`` are frozen copies of
floodgan_tpu_torch/tools/bench.py:74-86; ``HBM_BYTES_PER_S`` of
chip_smoke.py:304; ``card_label`` of floodgan_tpu_torch/core/device.py's.
"""

from __future__ import annotations

import subprocess
import sys
from typing import Optional

import torch

# Dense peak TFLOP/s from NVIDIA's data sheets (no sparsity), by a prefix of
# torch.cuda.get_device_name(): bf16 on the tensor cores, TF32 on the
# tensor cores, f32 outside them.
_PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989.4, "tf32": 494.7, "f32": 66.9},  # SXM5
    "NVIDIA H100 PCIe": {"bf16": 756.5, "tf32": 378.0, "f32": 51.0},
}

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet

PRECISION_OF = {"bfloat16": "bf16", "float32": "f32"}


def peak_tflops(device_name: str, precision: str) -> Optional[float]:
    """The dense peak of ``precision`` (``bf16``, ``tf32`` or ``f32``) of the
    card whose name starts with the longest matching key, or None."""
    for prefix in sorted(_PEAK_TFLOPS, key=len, reverse=True):
        if device_name.startswith(prefix):
            return _PEAK_TFLOPS[prefix][precision]
    return None


def card_label(index: int = 0) -> str:
    """Card ``index``'s name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", f"--id={index}"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def power_limit_w(label: str) -> Optional[float]:
    """The watts of a ``card_label`` line ("NVIDIA H100 80GB HBM3, 700.00 W")."""
    try:
        return float(label.rsplit(",", 1)[1].strip().split()[0])
    except (IndexError, ValueError):
        return None


def require_cards(count: int) -> None:
    """Exit with code 2, printing no result, unless ``count`` cards are
    there: a measurement never falls back to the CPU."""
    if not torch.cuda.is_available():
        print("benchmark: torch.cuda.is_available() is false; the benchmark measures the card",
              file=sys.stderr)
        sys.exit(2)
    if torch.cuda.device_count() < count:
        print(f"benchmark: the cell needs {count} cards, {torch.cuda.device_count()} are there",
              file=sys.stderr)
        sys.exit(2)
