"""Batched JPEG decode for the training infeed (counterpart of
video_dqn_tpu/data/qlearning.py `_load_image`/`load_images` and of the
native stage video_dqn_tpu/data/native_decode.py `jpeg_batch`).

`load_images(paths, size)` decodes a list of JPEG files to (N, size, size,
3) uint8 in one call into the port's host library
(csrc/host/jpeg_decode.cc, a baseline decoder written for the port, built
at first use by _build.py), threaded across images. Per image it is
_load_image's transform: PIL's draft-mode scaled decode, the bilinear
resize of the smallest edge to `size` and the centre crop. A file the
decoder cannot read (progressive, arithmetic-coded, 12-bit, CMYK,
truncated, not a JPEG) raises with its path: there is no fallback.
"""

from __future__ import annotations

import ctypes
import os
from typing import Sequence

import numpy as np

from .. import _build

# csrc/host/jpeg_decode.cc `Status`
STATUS = {
    1: "cannot be read",
    2: "is not a JPEG file",
    3: "is a progressive JPEG (SOF2), which the decoder does not take",
    4: "is arithmetic-coded, which the decoder does not take",
    5: "has a sample precision other than 8 bits",
    6: "has other than 1 or 3 colour components (CMYK?)",
    7: "is corrupt",
    8: "has sampling factors the decoder does not take",
    9: "is truncated",
    10: "is a lossless or differential JPEG, which the decoder does not take",
    11: "is too large to decode",
}


def decode_threads() -> int:
    """VDQN_JPEG_THREADS, as for the JAX package's native stage: 0 (the
    default) means every hardware thread."""
    return int(os.environ.get("VDQN_JPEG_THREADS", "0"))


def load_images(paths: Sequence[str], size: int) -> np.ndarray:
    """(N, size, size, 3) uint8 frames of the JPEG files at `paths`, decoded
    on `decode_threads()` threads."""
    paths = [os.fsencode(p) for p in paths]
    n = len(paths)
    out = np.empty((n, size, size, 3), np.uint8)
    if n == 0:
        return out
    if size <= 0:
        raise ValueError(f"size must be positive, got {size}")
    status = np.zeros(n, np.int32)
    names = (ctypes.c_char_p * n)(*paths)
    lib = _build.load_host()
    failed = lib.vdqn_jpeg_decode_batch(
        ctypes.cast(names, ctypes.c_void_p), n, int(size), out.ctypes.data, status.ctypes.data,
        decode_threads())
    if failed:
        bad = np.flatnonzero(status)
        first = int(bad[0])
        raise RuntimeError(
            f"JPEG decode failed for {failed} of {n} files; "
            f"{os.fsdecode(paths[first])} {STATUS.get(int(status[first]), 'failed')}"
            + (f" (and {len(bad) - 1} more)" if len(bad) > 1 else ""))
    return out
