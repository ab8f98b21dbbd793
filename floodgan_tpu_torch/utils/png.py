"""A stdlib PNG writer (zlib + struct) for the prediction and mask images.

``imsave_rgb`` writes the pixels that matplotlib 3.10's ``plt.imsave``
writes for a float RGB image in [0, 1]: ``to_rgba(..., bytes=True)``
turns it into RGBA with alpha 255 and each channel ``(x * 255)`` cast to
uint8 in the array's own float type (a truncation), NaN pixels all zero;
the result is saved as 8-bit RGBA.  ``imsave_gray`` writes those of a
float (H, W) image under ``vmin=0, vmax=1`` and the ``gray`` (or
``gray_r``) colormap.  Pixels equal, file bytes not: no matplotlib
metadata chunk.
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


def gray_rgba_bytes(img: np.ndarray, reverse: bool = False) -> np.ndarray:
    """(H, W) float -> (H, W, 4) uint8, as ``imsave(img, vmin=0, vmax=1,
    cmap="gray")`` (``"gray_r"`` with ``reverse``) colours it: index
    floor(x * 256) into a 256-entry ramp (1.0 takes the last entry, values
    outside [0, 1] the end entries), the ramp's levels truncated from
    ``level * 255``, alpha 255, NaN pixels all zero."""
    x = np.asarray(img)
    if x.ndim != 2 or x.dtype.kind != "f":
        raise ValueError(f"expected a float (H, W) image, got {x.dtype} {x.shape}")
    ramp = np.linspace(0.0, 1.0, 256)
    lut = ((1.0 - ramp if reverse else ramp) * 255).astype(np.uint8)
    nans = np.isnan(x)
    scaled = np.where(nans, 0, x) * 256  # in x's own float type, as matplotlib scales it
    scaled[scaled == 256] = 255
    level = lut[np.clip(scaled, -1, 256).astype(int).clip(0, 255)]
    rgba = np.empty(x.shape + (4,), np.uint8)
    rgba[..., :3] = level[..., None]
    rgba[..., 3] = 255
    rgba[nans] = 0
    return rgba


def _write(path: str, rgba: np.ndarray) -> None:
    h, w, _ = rgba.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgba.reshape(h, w * 4)], axis=1)  # filter 0
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def imsave_rgb(path: str, img: np.ndarray) -> None:
    """``plt.imsave(path, img)`` of a float RGB image in [0, 1]."""
    _write(path, rgba_bytes(img))


def imsave_gray(path: str, img: np.ndarray, reverse: bool = False) -> None:
    """``plt.imsave(path, img, vmin=0, vmax=1, cmap="gray")`` of a float
    (H, W) image, such as a flood mask (``cmap="gray_r"`` with ``reverse``,
    the attention mask's)."""
    _write(path, gray_rgba_bytes(img, reverse))
