"""msgpack in pure Python, for the subset that Flax checkpoints use
(flax.serialization.msgpack_serialize / msgpack_restore).

Types: nil, bool, int, float (written as float64), str, bin, arrays
(lists and tuples), maps with str keys (written in sorted key order, as
Flax's tree_map leaves them), and numpy arrays as ext type 1
whose payload is the msgpack array [shape, dtype name, raw C-order
bytes]; numpy scalars as ext type 3 with the same payload. Every value is
written in the smallest format that holds it, as msgpack-python writes
it, so a tree encodes to the bytes Flax writes for it. Flax's chunking of
arrays over 1 GiB is not supported: `packb` raises on such an array.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_ARRAY_BYTES = 2 ** 30  # Flax chunks arrays above this; the port does not


def _header(n: int, fix: int, fix_max: int, wide: Tuple[Tuple[int, str, int], ...]) -> bytes:
    """A length header: the fix form below fix_max, else the first wide
    (type byte, struct format, limit) form that holds n."""
    if n < fix_max:
        return bytes([fix | n])
    for code, fmt, limit in wide:
        if n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack length {n} too large")


_U8, _U16, _U32 = 0xFF, 0xFFFF, 0xFFFFFFFF


def _int(n: int) -> bytes:
    if 0 <= n < 128:
        return bytes([n])
    if -32 <= n < 0:
        return bytes([n & 0xFF])
    if n >= 0:
        for code, fmt, limit in ((0xCC, ">B", _U8), (0xCD, ">H", _U16),
                                 (0xCE, ">I", _U32), (0xCF, ">Q", 2 ** 64 - 1)):
            if n <= limit:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt, limit in ((0xD0, ">b", 2 ** 7), (0xD1, ">h", 2 ** 15),
                                 (0xD2, ">i", 2 ** 31), (0xD3, ">q", 2 ** 63)):
            if n >= -limit:
                return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"integer {n} does not fit msgpack")


def _bin_header(n: int) -> bytes:
    return _header(n, 0, 0, ((0xC4, ">B", _U8), (0xC5, ">H", _U16), (0xC6, ">I", _U32)))


def _ext(code: int, payload: List) -> List:
    n = sum(len(p) for p in payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = bytes([fixed[n]])
    else:
        head = _header(n, 0, 0, ((0xC7, ">B", _U8), (0xC8, ">H", _U16), (0xC9, ">I", _U32)))
    return [head, struct.pack(">b", code), *payload]


def _array_payload(a: np.ndarray) -> List:
    a = np.asarray(a, order="C")  # (np.ascontiguousarray makes a 0-d array 1-d)
    if a.nbytes > MAX_ARRAY_BYTES:
        raise ValueError(f"array of {a.nbytes} bytes: over the {MAX_ARRAY_BYTES} "
                         f"that one msgpack leaf holds unchunked")
    parts: List = []
    _pack([list(a.shape), a.dtype.name], parts)
    parts[0] = bytes([0x93])  # the 3-array [shape, name, data], not 2
    return parts + [_bin_header(a.nbytes), memoryview(a.reshape(-1).view(np.uint8))]


def _pack(obj: Any, parts: List) -> None:
    if obj is None:
        parts.append(b"\xc0")
    elif obj is True or obj is False:
        parts.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, np.ndarray):
        parts += _ext(EXT_NDARRAY, _array_payload(obj))
    elif isinstance(obj, np.generic):
        parts += _ext(EXT_NPSCALAR, _array_payload(np.asarray(obj)))
    elif isinstance(obj, int):
        parts.append(_int(obj))
    elif isinstance(obj, float):
        parts.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        parts += [_header(len(raw), 0xA0, 32, ((0xD9, ">B", _U8), (0xDA, ">H", _U16),
                                               (0xDB, ">I", _U32))), raw]
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        parts += [_bin_header(len(obj)), obj]
    elif isinstance(obj, (list, tuple)):
        parts.append(_header(len(obj), 0x90, 16, ((0xDC, ">H", _U16), (0xDD, ">I", _U32))))
        for item in obj:
            _pack(item, parts)
    elif isinstance(obj, dict):
        parts.append(_header(len(obj), 0x80, 16, ((0xDE, ">H", _U16), (0xDF, ">I", _U32))))
        if not all(isinstance(key, str) for key in obj):
            raise TypeError(f"msgpack map keys here are str, got {list(obj)}")
        for key in sorted(obj):
            _pack(key, parts)
            _pack(obj[key], parts)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """Encode a tree of dicts, lists and the scalar and array leaves above."""
    parts: List = []
    _pack(obj, parts)
    return b"".join(parts)


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends early")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.map(b & 0x0F)
        if b <= 0x9F:
            return self.array(b & 0x0F)
        if b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {  # type byte -> (length format, reader)
            0xC4: (">B", self.bin), 0xC5: (">H", self.bin), 0xC6: (">I", self.bin),
            0xC7: (">B", self.ext), 0xC8: (">H", self.ext), 0xC9: (">I", self.ext),
            0xD9: (">B", self.str), 0xDA: (">H", self.str), 0xDB: (">I", self.str),
            0xDC: (">H", self.array), 0xDD: (">I", self.array),
            0xDE: (">H", self.map), 0xDF: (">I", self.map),
        }
        if b in sized:
            fmt, read = sized[b]
            return read(self.unpack(fmt))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"msgpack type byte {b:#04x} is not supported")

    def bin(self, n: int) -> memoryview:
        return self.take(n)

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        payload = _Reader(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not supported")
        shape, name, data = payload.value()
        try:
            dtype = np.dtype(name)
        except TypeError:
            raise ValueError(f"array dtype {name!r} is not supported") from None
        a = np.frombuffer(data, dtype=dtype).reshape(shape)
        return a[()] if code == EXT_NPSCALAR else a


def unpackb(data) -> Any:
    """Decode one msgpack value. Arrays come back as read-only numpy views
    of `data`."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes after the msgpack value")
    return out
