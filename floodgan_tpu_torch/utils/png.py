"""A stdlib PNG writer (zlib + struct) for the prediction images.

``imsave_rgb`` writes the bytes that matplotlib 3.10's ``plt.imsave``
writes for a float RGB image in [0, 1]: ``to_rgba(..., bytes=True)``
turns it into RGBA with alpha 255 and each channel ``(x * 255)`` cast to
uint8 in the array's own float type (a truncation), NaN pixels all zero;
the result is saved as 8-bit RGBA.  Pixels equal, file bytes not: no
matplotlib metadata chunk.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def rgba_bytes(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) float in [0, 1] -> (H, W, 4) uint8, as matplotlib does."""
    img = np.asarray(img)
    if img.ndim != 3 or img.shape[2] != 3 or img.dtype.kind != "f":
        raise ValueError(f"expected a float (H, W, 3) image, got {img.dtype} {img.shape}")
    rgba = np.empty(img.shape[:2] + (4,), img.dtype)
    rgba[:, :, :3] = img
    rgba[:, :, 3] = 1
    nans = np.isnan(img).any(axis=2)
    rgba[nans] = 0
    if rgba.max() > 1 or rgba.min() < 0:
        raise ValueError("Floating point image RGB values must be in the 0..1 range.")
    return (rgba * 255).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def imsave_rgb(path: str, img: np.ndarray) -> None:
    rgba = rgba_bytes(img)
    h, w, _ = rgba.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgba.reshape(h, w * 4)], axis=1)  # filter 0
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))
