"""Bicubic+antialias resize with torch/PIL semantics, as two contractions.

A copy of floodgan_tpu/ops/resize.py: the (out, in) resample matrices are
built in numpy (PIL's a=-0.5 cubic kernel, support scaled by the
downsampling factor), and the separable resample is two matrix products.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def _cubic(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    return np.where(
        ax <= 1.0,
        (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0,
        np.where(ax < 2.0, a * (ax3 - 5.0 * ax2 + 8.0 * ax - 4.0), 0.0),
    )


@functools.lru_cache(maxsize=64)
def _resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) row-stochastic PIL/torch-AA resample matrix.
    Cached by size; callers copy it into a tensor and never write to it."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale  # cubic kernel radius is 2
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        js = np.arange(xmin, xmax)
        w = _cubic((js + 0.5 - center) / filterscale)
        total = w.sum()
        if total != 0.0:
            w = w / total
        mat[i, xmin:xmax] = w
    return mat.astype(np.float32)


def resize_bicubic_antialias(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize NHWC ``x`` to (out_h, out_w) with torch bicubic-AA semantics."""
    _, in_h, in_w, _ = x.shape
    if (in_h, in_w) == (out_h, out_w):
        return x
    wh = torch.tensor(_resize_matrix(in_h, out_h), device=x.device, dtype=x.dtype)
    ww = torch.tensor(_resize_matrix(in_w, out_w), device=x.device, dtype=x.dtype)
    y = torch.einsum("oh,nhwc->nowc", wh, x)
    return torch.einsum("pw,nowc->nopc", ww, y)


def shorter_edge_size(h: int, w: int, size: int) -> Tuple[int, int]:
    """torchvision Resize(int) semantics: shorter edge -> size, keep aspect."""
    if h <= w:
        return size, max(1, int(round(size * w / h)))
    return max(1, int(round(size * h / w))), size
