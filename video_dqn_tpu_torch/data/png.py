"""PNG files from stdlib zlib and numpy (counterpart of PIL's
`Image.fromarray(img).save(path)`, which the JAX package calls for its
value maps, episode strips and panorama figures).

`save_png(path, image)` writes an (H, W, 3) uint8 array as 8-bit RGB
(colour type 2) and an (H, W) one as 8-bit grey (colour type 0): one IDAT
chunk of zlib level 6 over rows that each carry filter byte 0 (none).
The pixels decode to the array given; the bytes differ from PIL's, which
picks a filter per row. `read_png(path)` reads back what `save_png`
writes (8-bit grey or RGB, not interlaced, any filter byte but only
filter 0) and raises on anything else, on a bad CRC or a truncated file.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
COLOUR_TYPES = {1: 0, 3: 2}  # channels -> PNG colour type


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image) -> bytes:
    """The PNG file of an (H, W) grey or (H, W, 3) RGB uint8 image."""
    img = np.asarray(image)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or \
            (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"save_png takes (H, W) or (H, W, 3) uint8, got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    if h == 0 or w == 0 or h >= 2 ** 31 or w >= 2 ** 31:
        raise ValueError(f"save_png takes 1 to 2^31 - 1 rows and columns, got {h} x {w}")
    channels = 1 if img.ndim == 2 else 3
    rows = np.empty((h, 1 + w * channels), np.uint8)
    rows[:, 0] = 0  # filter: none
    rows[:, 1:] = img.reshape(h, w * channels)
    header = struct.pack(">IIBBBBB", w, h, 8, COLOUR_TYPES[channels], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def save_png(path: str, image) -> None:
    """Write an (H, W) grey or (H, W, 3) RGB uint8 image to `path` as a
    PNG file; raises with the path if it cannot be written."""
    data = encode_png(image)
    try:
        with open(path, "wb") as f:
            f.write(data)
    except OSError as e:
        raise OSError(f"PNG write failed for {path}: {e}") from e


def read_png(path: str) -> np.ndarray:
    """The pixels of a PNG file as `save_png` writes them: (H, W) for grey,
    (H, W, 3) for RGB, uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path} is not a PNG file")
    pos, header, idat = len(SIGNATURE), None, []
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{path} is truncated")
        length, kind = struct.unpack(">I", data[pos:pos + 4])[0], data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path} is truncated")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"{path}: bad CRC in its {kind.decode('latin-1')} chunk")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path} has no IHDR chunk")
    w, h, depth, colour, _, _, interlace = header
    channels = {v: k for k, v in COLOUR_TYPES.items()}.get(colour)
    if depth != 8 or channels is None or interlace != 0:
        raise ValueError(f"{path}: read_png reads 8-bit grey or RGB without interlace, "
                         f"not depth {depth}, colour type {colour}, interlace {interlace}")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if rows.size != h * (1 + w * channels):
        raise ValueError(f"{path}: {rows.size} bytes of pixel rows for {h} x {w}")
    rows = rows.reshape(h, 1 + w * channels)
    if rows[:, 0].any():
        raise ValueError(f"{path}: read_png reads rows of filter 0 only")
    out = rows[:, 1:].reshape((h, w) if channels == 1 else (h, w, 3))
    return out.copy()
