"""Feather (Arrow IPC file) reader and writer for the Q-learning dataset
(counterpart of video_dqn_tpu/data/schema.py `read_feather` and
`write_feather`, pandas calls).

pandas writes Feather V2, which is the Arrow IPC file format
(https://arrow.apache.org/docs/format/Columnar.html#ipc-file-format):
the magic `ARROW1`, the schema and record-batch messages, a footer
flatbuffer that lists them, the footer's length and the magic again. The
card's machine has no pandas, pyarrow or flatbuffers package, so this
module parses the flatbuffers (Footer, Schema, Field, Message,
RecordBatch of File.fbs, Schema.fbs and Message.fbs) by hand.

`read_feather(path)` returns {column name: numpy array}, every record batch
concatenated:
  * int32, int64, float32, float64 and bool columns as numpy arrays of that
    dtype; a null in a float column reads as NaN (pyarrow writes pandas'
    NaN as a null), a null in any other column raises;
  * utf8 and large_utf8 columns as object arrays of str.
Buffers are uncompressed or LZ4_FRAME-compressed (pandas' default); the
LZ4 frames are decoded by the port's host library (csrc/host/lz4_frame.cc).
ZSTD and every other type raise.

`write_feather(columns, path)` writes {column name: numpy array} as one
uncompressed record batch: int64 and float64 columns as themselves (NaN
and inf kept as values, no validity bitmaps) and str columns as utf8. Its
flatbuffers are laid out front to back (`_FlatBufferWriter`), every
scalar at its natural alignment, so that pyarrow's verifier and pandas
read the file.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import _build

MAGIC = b"ARROW1"
# Schema.fbs `union Type` members this reader takes
_INT, _FLOAT, _UTF8, _BOOL, _LARGE_UTF8 = 2, 3, 5, 6, 20
_FLOAT_DTYPES = {1: np.float32, 2: np.float64}  # Precision: HALF = 0, SINGLE, DOUBLE
_CODECS = {0: "LZ4_FRAME", 1: "ZSTD"}
_RECORD_BATCH = 3  # Message.fbs `union MessageHeader`


class _Table:
    """A flatbuffer table: field i of its vtable, read on demand."""

    def __init__(self, buf: memoryview, pos: int):
        self.buf, self.pos = buf, pos
        self.vtable = pos - struct.unpack_from("<i", buf, pos)[0]
        self.vsize = struct.unpack_from("<H", buf, self.vtable)[0]

    def _field(self, i: int) -> int:
        at = 4 + 2 * i
        if at >= self.vsize:
            return 0
        off = struct.unpack_from("<H", self.buf, self.vtable + at)[0]
        return self.pos + off if off else 0

    def scalar(self, i: int, fmt: str, default=0):
        at = self._field(i)
        return struct.unpack_from("<" + fmt, self.buf, at)[0] if at else default

    def _target(self, i: int) -> int:
        at = self._field(i)
        return at + struct.unpack_from("<I", self.buf, at)[0] if at else 0

    def table(self, i: int) -> Optional["_Table"]:
        at = self._target(i)
        return _Table(self.buf, at) if at else None

    def string(self, i: int) -> str:
        at = self._target(i)
        if not at:
            return ""
        n = struct.unpack_from("<I", self.buf, at)[0]
        return bytes(self.buf[at + 4:at + 4 + n]).decode("utf-8")

    def tables(self, i: int) -> List["_Table"]:
        at = self._target(i)
        if not at:
            return []
        n = struct.unpack_from("<I", self.buf, at)[0]
        out = []
        for k in range(n):
            el = at + 4 + 4 * k
            out.append(_Table(self.buf, el + struct.unpack_from("<I", self.buf, el)[0]))
        return out

    def structs(self, i: int, fmt: str) -> List[tuple]:
        at = self._target(i)
        if not at:
            return []
        n = struct.unpack_from("<I", self.buf, at)[0]
        size = struct.calcsize("<" + fmt)
        return [struct.unpack_from("<" + fmt, self.buf, at + 4 + size * k) for k in range(n)]


def _root(buf: memoryview) -> _Table:
    return _Table(buf, struct.unpack_from("<I", buf, 0)[0])


def _field_type(field: _Table) -> Tuple[str, object]:
    """(kind, detail) of a schema Field: ('int', dtype), ('float', dtype),
    ('bool', None), ('utf8', offset dtype)."""
    name = field.string(0)
    if field.table(4) is not None:
        raise NotImplementedError(f"feather column {name!r} is dictionary-encoded")
    if field.tables(5):
        raise NotImplementedError(f"feather column {name!r} is a nested type")
    kind = field.scalar(2, "B")
    detail = field.table(3)
    if kind == _INT:
        bits, signed = detail.scalar(0, "i"), detail.scalar(1, "?")
        if bits not in (32, 64) or not signed:
            raise NotImplementedError(f"feather column {name!r}: {'' if signed else 'u'}"
                                      f"int{bits} is not read")
        return "int", np.dtype(np.int32 if bits == 32 else np.int64)
    if kind == _FLOAT:
        precision = detail.scalar(0, "h")
        if precision not in _FLOAT_DTYPES:
            raise NotImplementedError(f"feather column {name!r}: half floats are not read")
        return "float", np.dtype(_FLOAT_DTYPES[precision])
    if kind == _BOOL:
        return "bool", None
    if kind in (_UTF8, _LARGE_UTF8):
        return "utf8", np.dtype(np.int32 if kind == _UTF8 else np.int64)
    raise NotImplementedError(f"feather column {name!r} has Arrow type id {kind}, which "
                              f"this reader does not take")


def _lz4_decode(src: memoryview, size: int) -> np.ndarray:
    out = np.empty(size, np.uint8)
    src = np.frombuffer(src, np.uint8)
    got = _build.load_host().vdqn_lz4_frame_decode(src.ctypes.data, src.size,
                                                   out.ctypes.data, size)
    if got != size:
        raise ValueError(f"LZ4 frame decode gave {got} bytes, the buffer announces {size}")
    return out


class _Body:
    """The buffers of one record batch's body, decompressed as needed."""

    def __init__(self, data: memoryview, start: int, buffers, codec: Optional[int]):
        self.data, self.start, self.buffers, self.codec = data, start, buffers, codec
        self.next = 0

    def take(self) -> np.ndarray:
        offset, length = self.buffers[self.next]
        self.next += 1
        raw = self.data[self.start + offset:self.start + offset + length]
        if self.codec is None or length == 0:
            return np.frombuffer(raw, np.uint8)
        size = struct.unpack_from("<q", raw, 0)[0]
        if size == -1:  # stored uncompressed
            return np.frombuffer(raw[8:], np.uint8)
        return _lz4_decode(raw[8:], size)


def _validity(bits: np.ndarray, n: int, null_count: int) -> Optional[np.ndarray]:
    if null_count == 0:
        return None
    return np.unpackbits(bits, bitorder="little")[:n].astype(bool)


def _column(name: str, kind: str, detail, n: int, null_count: int, body: _Body) -> np.ndarray:
    valid = _validity(body.take(), n, null_count)
    if valid is not None and kind != "float":
        raise ValueError(f"feather column {name!r} has {null_count} nulls")
    if kind in ("int", "float"):
        values = body.take()[:n * detail.itemsize].view(detail).copy()
        if valid is not None:
            values[~valid] = np.nan
        return values
    if kind == "bool":
        return np.unpackbits(body.take(), bitorder="little")[:n].astype(bool)
    offsets = body.take()[:(n + 1) * detail.itemsize].view(detail)
    data = body.take().tobytes()
    out = np.empty(n, object)
    for i in range(n):
        out[i] = data[offsets[i]:offsets[i + 1]].decode("utf-8")
    return out


def _message(data: memoryview, offset: int) -> _Table:
    """The Message flatbuffer at a block's offset (after the 0xFFFFFFFF
    continuation marker of current writers)."""
    size = struct.unpack_from("<i", data, offset)[0]
    start = offset + 4
    if size == -1:
        size = struct.unpack_from("<i", data, start)[0]
        start += 4
    return _root(data[start:start + size])


def read_feather(path: str) -> Dict[str, np.ndarray]:
    """{column name: numpy array} of the Arrow IPC file at `path`."""
    with open(path, "rb") as f:
        raw = f.read()
    data = memoryview(raw)
    if len(raw) < 18 or raw[:6] != MAGIC or raw[-6:] != MAGIC:
        raise ValueError(f"{path} is not an Arrow IPC (feather V2) file")
    footer_len = struct.unpack_from("<i", data, len(raw) - 10)[0]
    footer = _root(data[len(raw) - 10 - footer_len:len(raw) - 10])
    fields = footer.table(1).tables(1)
    names = [fl.string(0) for fl in fields]
    types = [_field_type(fl) for fl in fields]
    if footer.structs(2, "qi4xq"):
        raise NotImplementedError(f"{path} has dictionary batches")
    parts: Dict[str, list] = {name: [] for name in names}
    for offset, meta_len, _ in footer.structs(3, "qi4xq"):
        message = _message(data, offset)
        if message.scalar(1, "B") != _RECORD_BATCH:
            raise ValueError(f"{path}: a footer block is not a record batch")
        batch = message.table(2)
        n = batch.scalar(0, "q")
        nodes = batch.structs(1, "qq")
        compression = batch.table(3)
        codec = None
        if compression is not None:
            codec = compression.scalar(0, "b")
            if codec != 0:
                raise NotImplementedError(
                    f"{path}: buffers compressed with {_CODECS.get(codec, codec)}; this "
                    f"reader takes uncompressed and LZ4_FRAME buffers only")
        body = _Body(data, offset + meta_len, batch.structs(2, "qq"), codec)
        for name, (kind, detail), (length, nulls) in zip(names, types, nodes):
            if length != n:
                raise ValueError(f"{path}: column {name!r} has {length} of {n} rows")
            parts[name].append(_column(name, kind, detail, n, nulls, body))
    out = {}
    for name, (kind, detail) in zip(names, types):
        if parts[name]:
            out[name] = np.concatenate(parts[name])
        else:
            out[name] = np.empty(0, object if kind == "utf8" else
                                 (bool if kind == "bool" else detail))
    return out


# -- writer ------------------------------------------------------------------
# A flatbuffer object to write: ("table", [(slot, struct format or "o" for an
# offset to another object, value)]), ("string", str), ("tables", [table]) or
# ("structs", struct format, [tuple]).
_METADATA_V5 = 4
_SCHEMA, _BODY_ALIGN = 1, 64


def _size(fmt: str) -> int:
    return 4 if fmt == "o" else struct.calcsize("<" + fmt)


class _FlatBufferWriter:
    """A flatbuffer laid out front to back: the root offset, then every
    object before the objects it points to, so that each offset (unsigned,
    forward) is known when its target is written; a table's vtable sits
    just before the table. Tables start 8-aligned and lay their fields out
    largest first, each at its own alignment."""

    def __init__(self):
        self.buf = bytearray(4)

    def _pad(self, align: int, extra: int = 0) -> None:
        self.buf += bytes(-(len(self.buf) + extra) % align)

    def _link(self, at: int, target: int) -> None:
        struct.pack_into("<I", self.buf, at, target - at)

    def write(self, obj) -> int:
        kind = obj[0]
        if kind == "string":
            data = obj[1].encode("utf-8")
            self._pad(4)
            at = len(self.buf)
            self.buf += struct.pack("<I", len(data)) + data + b"\0"
            return at
        if kind == "structs":
            _, fmt, items = obj
            self._pad(8, 4)  # the elements 8-aligned after the length
            at = len(self.buf)
            self.buf += struct.pack("<I", len(items))
            self.buf += b"".join(struct.pack("<" + fmt, *item) for item in items)
            return at
        if kind == "tables":
            items = obj[1]
            self._pad(4)
            at = len(self.buf)
            self.buf += struct.pack("<I", len(items)) + bytes(4 * len(items))
            for k, item in enumerate(items):
                self._link(at + 4 + 4 * k, self.write(item))
            return at
        fields = obj[1]
        slots = max((slot for slot, _, _ in fields), default=-1) + 1
        offsets, end = {}, 4  # the table opens with its vtable's soffset
        for slot, fmt, _ in sorted(fields, key=lambda f: -_size(f[1])):
            end += -end % _size(fmt)
            offsets[slot] = end
            end += _size(fmt)
        vsize = 4 + 2 * slots
        self._pad(8, vsize)
        vtable = len(self.buf)
        self.buf += struct.pack(f"<{2 + slots}H", vsize, end,
                                *(offsets.get(s, 0) for s in range(slots)))
        at = len(self.buf)
        body = bytearray(end)
        struct.pack_into("<i", body, 0, at - vtable)
        for slot, fmt, value in fields:
            if fmt != "o":
                struct.pack_into("<" + fmt, body, offsets[slot], value)
        self.buf += body
        for slot, fmt, value in fields:
            if fmt == "o":
                self._link(at + offsets[slot], self.write(value))
        return at

    def finish(self, root) -> bytes:
        self._link(0, self.write(root))
        self._pad(8)
        return bytes(self.buf)


def _column_buffers(name: str, values: np.ndarray) -> Tuple[tuple, List[bytes]]:
    """(the Field's type as (type id, type table), the column's buffers:
    an empty validity bitmap, then its data)."""
    if values.dtype.kind in "iu":
        return (_INT, ("table", [(0, "i", 64), (1, "?", True)])), \
            [b"", values.astype("<i8").tobytes()]
    if values.dtype.kind == "f":
        return (_FLOAT, ("table", [(0, "h", 2)])), [b"", values.astype("<f8").tobytes()]
    if values.dtype.kind in "OU" and all(isinstance(v, str) for v in values):
        data = [v.encode("utf-8") for v in values]
        ends = np.cumsum([0] + [len(d) for d in data], dtype=np.int64)
        if ends[-1] >= 2 ** 31:
            raise ValueError(f"feather column {name!r}: over 2 GiB of utf8")
        return (_UTF8, ("table", [])), [b"", ends.astype("<i4").tobytes(), b"".join(data)]
    raise TypeError(f"feather column {name!r}: write_feather takes int, float and str "
                    f"columns, not {values.dtype}")


def _encapsulated(header_type: int, header, body_length: int) -> bytes:
    """A Message flatbuffer after the continuation marker and its length."""
    fb = _FlatBufferWriter().finish(("table", [(0, "h", _METADATA_V5),
                                               (1, "B", header_type), (2, "o", header),
                                               (3, "q", body_length)]))
    return struct.pack("<Ii", 0xFFFFFFFF, len(fb)) + fb


def write_feather(columns: Dict[str, np.ndarray], path: str) -> None:
    """Write {column name: 1-D numpy array} (equal lengths, in the dict's
    order) as an uncompressed Arrow IPC file of one record batch."""
    arrays = {name: np.asarray(v) for name, v in columns.items()}
    lengths = {len(v) for v in arrays.values()}
    if len(lengths) > 1:
        raise ValueError(f"feather columns of different lengths: {sorted(lengths)}")
    n = lengths.pop() if lengths else 0
    fields, buffers, body = [], [], bytearray()
    for name, values in arrays.items():
        (type_id, type_table), raw = _column_buffers(name, values)
        fields.append(("table", [(0, "o", ("string", name)), (1, "?", True),
                                 (2, "B", type_id), (3, "o", type_table),
                                 (5, "o", ("tables", []))]))
        for part in raw:
            buffers.append((len(body), len(part)))
            body += part + bytes(-len(part) % _BODY_ALIGN)
    schema = ("table", [(0, "h", 0), (1, "o", ("tables", fields))])
    batch = ("table", [(0, "q", n), (1, "o", ("structs", "qq", [(n, 0)] * len(fields))),
                       (2, "o", ("structs", "qq", buffers))])
    out = bytearray(MAGIC + b"\0\0")
    out += _encapsulated(_SCHEMA, schema, 0)
    offset = len(out)
    meta = _encapsulated(_RECORD_BATCH, batch, len(body))
    out += meta + body
    footer = _FlatBufferWriter().finish(("table", [
        (0, "h", _METADATA_V5), (1, "o", schema), (2, "o", ("structs", "qi4xq", [])),
        (3, "o", ("structs", "qi4xq", [(offset, len(meta), len(body))]))]))
    out += footer + struct.pack("<i", len(footer)) + MAGIC
    with open(path, "wb") as f:
        f.write(out)
