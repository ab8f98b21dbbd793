"""A pure-Python msgpack codec for the subset the checkpoint files use.

Covered: nil, bool, int (to 64 bits), float (64-bit on write; 32 and 64 on
read), str, bin 8/16/32, array, map, and ext with fixext.  ``packb``
writes what ``msgpack.packb(obj, use_bin_type=True)`` writes, byte for
byte: the smallest format for each value, floats as doubles, tuples as
arrays.  ``unpackb`` decodes as ``msgpack.unpackb(raw=False)`` does (maps
to dicts, arrays to lists), over a ``memoryview``: a bin payload comes back
as one slice of it, never walked byte by byte or copied, so a 175 MB
checkpoint decodes at the speed of its slices.  Bytes-like payloads (``bytes``,
``memoryview``) both encode as bin.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, List, Optional


class ExtType:
    """An ext value: an application type code (0-127) and its payload.
    ``data`` may be a list of byte chunks whose join is the payload."""

    __slots__ = ("code", "data")

    def __init__(self, code: int, data):
        if not 0 <= code <= 127:
            raise ValueError(f"ext type code {code} outside 0..127")
        self.code = code
        self.data = data


def _nbytes(data) -> int:
    if isinstance(data, list):
        return sum(memoryview(c).nbytes for c in data)
    return memoryview(data).nbytes


# ------------------------------------------------------------------ packing

def _pack_int(n: int, out: List) -> None:
    if 0 <= n < 0x80:
        out.append(struct.pack("B", n))
    elif -32 <= n < 0:
        out.append(struct.pack("b", n))
    elif n >= 0:
        if n <= 0xFF:
            out.append(struct.pack(">BB", 0xCC, n))
        elif n <= 0xFFFF:
            out.append(struct.pack(">BH", 0xCD, n))
        elif n <= 0xFFFFFFFF:
            out.append(struct.pack(">BI", 0xCE, n))
        elif n <= 0xFFFFFFFFFFFFFFFF:
            out.append(struct.pack(">BQ", 0xCF, n))
        else:
            raise OverflowError(f"integer {n} does not fit msgpack's 64 bits")
    elif n >= -0x80:
        out.append(struct.pack(">Bb", 0xD0, n))
    elif n >= -0x8000:
        out.append(struct.pack(">Bh", 0xD1, n))
    elif n >= -0x80000000:
        out.append(struct.pack(">Bi", 0xD2, n))
    elif n >= -0x8000000000000000:
        out.append(struct.pack(">Bq", 0xD3, n))
    else:
        raise OverflowError(f"integer {n} does not fit msgpack's 64 bits")


def _pack_len(n: int, fix: Optional[int], fix_max: int, codes, out: List, what: str) -> None:
    """The header of a str/bin/array/map/ext of length n: a fix form where
    there is one, else the 8/16/32-bit forms in ``codes`` (None: absent)."""
    if fix is not None and n <= fix_max:
        out.append(struct.pack("B", fix | n))
        return
    for code, fmt, limit in zip(codes, (">BB", ">BH", ">BI"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            out.append(struct.pack(fmt, code, n))
            return
    raise ValueError(f"{what} of {n} entries or bytes is too long for msgpack")


def bin_header(n: int) -> bytes:
    """The header of a bin of n bytes (the payload follows it)."""
    out: List = []
    _pack_len(n, None, 0, (0xC4, 0xC5, 0xC6), out, "bin")
    return out[0]


_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def pack_into(obj: Any, out: List, default: Optional[Callable[[Any], Any]] = None) -> None:
    """Append the encoding of ``obj`` to ``out`` as a list of chunks.
    ``default`` maps a value of another type to one that packs (or an
    ``ExtType``), as msgpack's ``default=`` does."""
    t = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif t is int:
        _pack_int(obj, out)
    elif t is float:
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif t is str:
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB), out, "str")
        out.append(data)
    elif t in (bytes, bytearray, memoryview):
        out.append(bin_header(_nbytes(obj)))
        out.append(obj)
    elif t in (list, tuple):
        _pack_len(len(obj), 0x90, 15, (None, 0xDC, 0xDD), out, "array")
        for v in obj:
            pack_into(v, out, default)
    elif t is dict:
        _pack_len(len(obj), 0x80, 15, (None, 0xDE, 0xDF), out, "map")
        for k, v in obj.items():
            pack_into(k, out, default)
            pack_into(v, out, default)
    elif t is ExtType:
        n = _nbytes(obj.data)
        if n in _FIXEXT:
            out.append(struct.pack("BB", _FIXEXT[n], obj.code))
        elif n <= 0xFF:
            out.append(struct.pack(">BBB", 0xC7, n, obj.code))
        elif n <= 0xFFFF:
            out.append(struct.pack(">BHB", 0xC8, n, obj.code))
        elif n <= 0xFFFFFFFF:
            out.append(struct.pack(">BIB", 0xC9, n, obj.code))
        else:
            raise ValueError(f"ext payload of {n} bytes is too long for msgpack")
        if isinstance(obj.data, list):
            out.extend(obj.data)
        else:
            out.append(obj.data)
    elif default is not None:
        converted = default(obj)
        if type(converted) is t:
            raise TypeError(f"cannot serialize {t.__name__} object")
        pack_into(converted, out, default)
    else:
        raise TypeError(f"cannot serialize {t.__name__} object")


def packb(obj: Any, default: Optional[Callable[[Any], Any]] = None) -> bytes:
    chunks: List = []
    pack_into(obj, chunks, default)
    return b"".join(chunks)


# ---------------------------------------------------------------- unpacking

class _Reader:
    __slots__ = ("buf", "pos", "ext_hook")

    def __init__(self, buf: memoryview, ext_hook):
        self.buf = buf
        self.pos = 0
        self.ext_hook = ext_hook

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("msgpack data ends inside a value")
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def value(self) -> Any:
        b = self.unpack("B", 1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):
            n = self.unpack(*{0xC4: (">B", 1), 0xC5: (">H", 2), 0xC6: (">I", 4)}[b])
            return self.take(n)
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack(*{0xC7: (">B", 1), 0xC8: (">H", 2), 0xC9: (">I", 4)}[b])
            return self.ext(n)
        if b == 0xCA:
            return self.unpack(">f", 4)
        if b == 0xCB:
            return self.unpack(">d", 8)
        ints = {0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
                0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8)}
        if b in ints:
            return self.unpack(*ints[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        if b in (0xD9, 0xDA, 0xDB):
            return self.str(self.unpack(*{0xD9: (">B", 1), 0xDA: (">H", 2), 0xDB: (">I", 4)}[b]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(*{0xDC: (">H", 2), 0xDD: (">I", 4)}[b]))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(*{0xDE: (">H", 2), 0xDF: (">I", 4)}[b]))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack("b", 1)
        data = self.take(n)
        if self.ext_hook is None:
            return ExtType(code, bytes(data))
        return self.ext_hook(code, data)


def unpackb(data, ext_hook: Optional[Callable[[int, memoryview], Any]] = None) -> Any:
    """Decode one msgpack value that spans all of ``data`` (bytes-like).
    A bin comes back as a ``memoryview`` into ``data`` (it compares equal
    to the ``bytes`` msgpack returns); ``ext_hook(code, payload_view)``
    decodes ext values (default: ``ExtType``)."""
    reader = _Reader(memoryview(data).cast("B"), ext_hook)
    value = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes of extra data after the msgpack value")
    return value
