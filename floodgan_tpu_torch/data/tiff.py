"""Minimal baseline-TIFF codec (numpy), standing in for tifffile.

A copy of floodgan_tpu/data/tiff.py: the port cannot import that module,
because floodgan_tpu/data/__init__.py imports the JAX pipeline.

The runtime dataset is float32/uint8 HWC GeoTIFF stacks written by
tifffile (reference models/data.py:64-68 reads them with ``tf.imread``).
This codec covers the subset those files use: little/big-endian baseline
TIFF, single image, strip layout, compression none(1) or deflate(8),
uint8/uint16/float32, contiguous planar config.  A C++ fast-path decoder
for the hot training loop lives in native/ (same wire format), bound by
data/native.py.
"""

from __future__ import annotations

import struct
import zlib
from typing import BinaryIO, Union

import numpy as np

_TAG_WIDTH = 256
_TAG_LENGTH = 257
_TAG_BITS = 258
_TAG_COMPRESSION = 259
_TAG_PHOTOMETRIC = 262
_TAG_STRIP_OFFSETS = 273
_TAG_SPP = 277
_TAG_ROWS_PER_STRIP = 278
_TAG_STRIP_COUNTS = 279
_TAG_PLANAR = 284
_TAG_PREDICTOR = 317
_TAG_SAMPLE_FORMAT = 339

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 8: "h", 9: "i", 11: "f", 12: "d"}


def _read_tag_values(f: BinaryIO, endian: str, ttype: int, count: int, raw: bytes):
    size = _TYPE_SIZES[ttype] * count
    if size > 4:
        (offset,) = struct.unpack(endian + "I", raw)
        pos = f.tell()
        f.seek(offset)
        data = f.read(size)
        f.seek(pos)
    else:
        data = raw[:size]
    fmt = _TYPE_FMT.get(ttype)
    if fmt is None:
        return data
    return list(struct.unpack(endian + fmt * count, data))


def read_tags(path: str) -> dict:
    """Parse the first IFD's tags (values decoded where typed).  Used for
    GeoTIFF georeferencing tags (ModelPixelScale 33550, ModelTiepoint
    33922) by the pre-processing metadata stage."""
    with open(path, "rb") as f:
        header = f.read(8)
        endian = "<" if header[:2] == b"II" else ">"
        _, ifd_offset = struct.unpack(endian + "HI", header[2:8])
        f.seek(ifd_offset)
        (num_entries,) = struct.unpack(endian + "H", f.read(2))
        tags = {}
        for _ in range(num_entries):
            tag, ttype, count = struct.unpack(endian + "HHI", f.read(8))
            raw = f.read(4)
            tags[tag] = _read_tag_values(f, endian, ttype, count, raw)
        return tags


def geotransform(path: str):
    """(x_min, y_max, pixel_w, pixel_h) from GeoTIFF tags — the subset of
    GDAL's GetGeoTransform the reference metadata stage consumes
    (reference pre_processing/data_pre_processing.py:19-77)."""
    tags = read_tags(path)
    scale = tags.get(33550)
    tiepoint = tags.get(33922)
    if not scale or not tiepoint or len(tiepoint) < 6:
        raise ValueError(f"{path} has no GeoTIFF georeferencing tags")
    # tiepoint: (i, j, k, x, y, z) raster->model anchor; scale: (sx, sy, sz)
    x_min = tiepoint[3] - tiepoint[0] * scale[0]
    y_max = tiepoint[4] + tiepoint[1] * scale[1]
    return x_min, y_max, scale[0], scale[1]


def imread(path: Union[str, "BinaryIO"]) -> np.ndarray:
    """Read a TIFF into an (H, W, C) array, or (H, W) when C == 1
    (matching tifffile's squeeze behavior the reference relies on at
    models/data.py:193,196)."""
    close = False
    if isinstance(path, (str, bytes)):
        f = open(path, "rb")
        close = True
    else:
        f = path
    try:
        header = f.read(8)
        if header[:2] == b"II":
            endian = "<"
        elif header[:2] == b"MM":
            endian = ">"
        else:
            raise ValueError("not a TIFF file")
        magic, ifd_offset = struct.unpack(endian + "HI", header[2:8])
        if magic != 42:
            raise ValueError("not a baseline TIFF")
        f.seek(ifd_offset)
        (num_entries,) = struct.unpack(endian + "H", f.read(2))
        tags = {}
        for _ in range(num_entries):
            tag, ttype, count = struct.unpack(endian + "HHI", f.read(8))
            raw = f.read(4)
            tags[tag] = _read_tag_values(f, endian, ttype, count, raw)

        width = tags[_TAG_WIDTH][0]
        length = tags[_TAG_LENGTH][0]
        spp = tags.get(_TAG_SPP, [1])[0]
        bits = tags.get(_TAG_BITS, [1])
        if isinstance(bits, list):
            bits = bits[0]
        compression = tags.get(_TAG_COMPRESSION, [1])[0]
        sample_format = tags.get(_TAG_SAMPLE_FORMAT, [1])
        if isinstance(sample_format, list):
            sample_format = sample_format[0]
        predictor = tags.get(_TAG_PREDICTOR, [1])[0]
        planar = tags.get(_TAG_PLANAR, [1])[0]
        if planar != 1:
            raise NotImplementedError("planar TIFF not supported")

        if sample_format == 3:
            dtype = {32: "f4", 64: "f8"}[bits]
        elif sample_format == 2:
            dtype = {8: "i1", 16: "i2", 32: "i4"}[bits]
        else:
            dtype = {1: "u1", 8: "u1", 16: "u2", 32: "u4"}[bits]
        dt = np.dtype(endian + dtype)

        offsets = tags[_TAG_STRIP_OFFSETS]
        counts = tags[_TAG_STRIP_COUNTS]
        chunks = []
        for off, cnt in zip(offsets, counts):
            f.seek(off)
            data = f.read(cnt)
            if compression == 8 or compression == 32946:
                data = zlib.decompress(data)
            elif compression == 5:
                data = _lzw_decode(data)
            elif compression != 1:
                raise NotImplementedError(f"TIFF compression {compression} not supported")
            chunks.append(data)
        buf = b"".join(chunks)
        arr = np.frombuffer(buf, dtype=dt, count=length * width * spp).reshape(
            length, width, spp
        )
        if predictor == 2:
            # horizontal differencing is defined for INTEGER samples
            # (predictor 3 is the float variant) — int64 cumsum on float
            # payloads would silently truncate fractions
            if dt.kind == "f":
                raise NotImplementedError(
                    "TIFF predictor 2 on floating-point samples not supported"
                )
            arr = np.cumsum(arr.astype(np.int64), axis=1).astype(dt).reshape(length, width, spp)
        elif predictor != 1:
            # e.g. predictor 3 (floating-point differencing): raise loudly
            # like unsupported compression, never decode garbage silently
            raise NotImplementedError(f"TIFF predictor {predictor} not supported")
        arr = arr.astype(arr.dtype.newbyteorder("="))
        if spp == 1:
            return arr[:, :, 0]
        return arr
    finally:
        if close:
            f.close()


def _lzw_decode(data: bytes) -> bytes:
    """TIFF-variant LZW (MSB-first codes, EarlyChange)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    bitpos = 0
    prev = None
    code_len = 9
    total_bits = len(data) * 8
    while bitpos + code_len <= total_bits:
        byte_idx = bitpos // 8
        chunk = int.from_bytes(data[byte_idx : byte_idx + 4].ljust(4, b"\0"), "big")
        code = (chunk >> (32 - (bitpos % 8) - code_len)) & ((1 << code_len) - 1)
        bitpos += code_len
        if code == CLEAR:
            table = table[:258]
            code_len = 9
            prev = None
            continue
        if code == EOI:
            break
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        else:
            entry = prev + prev[:1]
            table.append(entry)
        out += entry
        prev = entry
        if len(table) + 1 >= (1 << code_len) and code_len < 12:
            code_len += 1
    return bytes(out)


def imwrite(path: str, array: np.ndarray, compress: bool = False) -> None:
    """Write an (H, W), (H, W, 1) or (H, W, C) uint8/uint16/float32 array as
    a little-endian baseline TIFF (single strip)."""
    arr = np.ascontiguousarray(array)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, c = arr.shape
    if arr.dtype == np.float32:
        sample_format, bits = 3, 32
    elif arr.dtype == np.uint8:
        sample_format, bits = 1, 8
    elif arr.dtype == np.uint16:
        sample_format, bits = 1, 16
    else:
        raise NotImplementedError(f"dtype {arr.dtype} not supported")

    payload = arr.astype(arr.dtype.newbyteorder("<")).tobytes()
    compression = 1
    if compress:
        payload = zlib.compress(payload, 6)
        compression = 8

    photometric = 2 if c >= 3 else 1
    data_offset = 8
    ifd_offset = data_offset + len(payload)
    if ifd_offset % 2:
        payload += b"\0"
        ifd_offset += 1

    def entry(tag, ttype, count, value_bytes):
        return struct.pack("<HHI", tag, ttype, count) + value_bytes.ljust(4, b"\0")

    # BitsPerSample for c > 2 needs an external array.
    entries = []
    extra = b""
    extra_offset = None  # patched below

    tag_list = [
        (_TAG_WIDTH, 4, 1, struct.pack("<I", w)),
        (_TAG_LENGTH, 4, 1, struct.pack("<I", h)),
    ]
    num_entries_placeholder = 10
    bits_needed_external = c > 2
    ifd_size = 2 + 12 * num_entries_placeholder + 4
    bits_array_offset = ifd_offset + ifd_size

    if bits_needed_external:
        tag_list.append((_TAG_BITS, 3, c, struct.pack("<I", bits_array_offset)))
        extra = struct.pack("<" + "H" * c, *([bits] * c))
    else:
        tag_list.append((_TAG_BITS, 3, c, struct.pack("<" + "H" * c, *([bits] * c))))
    tag_list += [
        (_TAG_COMPRESSION, 3, 1, struct.pack("<H", compression)),
        (_TAG_PHOTOMETRIC, 3, 1, struct.pack("<H", photometric)),
        (_TAG_STRIP_OFFSETS, 4, 1, struct.pack("<I", data_offset)),
        (_TAG_SPP, 3, 1, struct.pack("<H", c)),
        (_TAG_ROWS_PER_STRIP, 4, 1, struct.pack("<I", h)),
        (_TAG_STRIP_COUNTS, 4, 1, struct.pack("<I", len(payload))),
        (_TAG_SAMPLE_FORMAT, 3, 1, struct.pack("<H", sample_format)),
    ]
    assert len(tag_list) == num_entries_placeholder
    tag_list.sort(key=lambda t: t[0])
    for tag, ttype, count, vb in tag_list:
        entries.append(entry(tag, ttype, count, vb))

    with open(path, "wb") as f:
        f.write(b"II" + struct.pack("<HI", 42, ifd_offset))
        f.write(payload)
        f.write(struct.pack("<H", len(entries)))
        for e in entries:
            f.write(e)
        f.write(struct.pack("<I", 0))  # next IFD
        f.write(extra)
