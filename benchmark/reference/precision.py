"""The precisions the reference runs in.

- ``"float32"``: f32 with TF32 off for cuDNN and cuBLAS, the precision the
  serving configuration states and the one the training reference uses.
- ``"tf32"``: the same with TF32 allowed: the control of a float32
  configuration (the nearest precision below f32 with TF32 off).
- ``"fp8"``: both operands of every convolution rounded to float8 e4m3
  with a per-tensor scale, and the gradient that flows back into each
  rounded to e5m2 (the usual fp8 training recipe), accumulation in f32:
  the control of a bfloat16 configuration.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

PRECISIONS = ("float32", "tf32", "fp8")

_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


@contextlib.contextmanager
def matmul_precision(precision: str):
    """TF32 on for ``"tf32"`` and off otherwise, for cuDNN and cuBLAS,
    restored after."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    tf32 = precision == "tf32"
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, _E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, _E5M2_MAX)


def quantizer(precision: str) -> Optional[callable]:
    """The function the reference's convolutions apply to their operands
    (None: none)."""
    return _Fp8.apply if precision == "fp8" else None
