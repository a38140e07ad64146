"""Batched JPEG decode for the training infeed (counterpart of
video_dqn_tpu/data/qlearning.py `_load_image`/`load_images` and of the
native stage video_dqn_tpu/data/native_decode.py `jpeg_batch`), and the
batched writer of the simulator's frames (counterpart of PIL's
`Image.save`, which video_dqn_tpu/data/sim_dataset.py calls).

`load_images(paths, size)` decodes a list of JPEG files to (N, size, size,
3) uint8 in one call into the port's host library
(csrc/host/jpeg_decode.cc, a baseline decoder written for the port, built
at first use by _build.py), threaded across images. Per image it is
_load_image's transform: PIL's draft-mode scaled decode, the bilinear
resize of the smallest edge to `size` and the centre crop. A file the
decoder cannot read (progressive, arithmetic-coded, 12-bit, CMYK,
truncated, not a JPEG) raises with its path: there is no fallback.

`save_images(paths, images, quality=75)` writes (N, H, W, 3) uint8 RGB
frames as baseline JFIF files in one call into the same library
(csrc/host/jpeg_encode.cc), threaded across images as the decoder is: the
file libjpeg writes with its defaults (YCbCr 4:2:0, the Annex K tables
scaled to `quality`, the islow DCT), which is PIL's `save` at the same
quality, byte for byte. A file that cannot be written raises with its path.
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


# csrc/host/jpeg_encode.cc `Status`
ENCODE_STATUS = {
    1: "cannot be opened for writing",
    2: "could not be written in full",
    3: "has a size or quality the writer does not take",
    4: "is too large to encode",
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


def save_images(paths: Sequence[str], images, quality: int = 75) -> None:
    """Write each (H, W, 3) uint8 RGB frame of `images` ((N, H, W, 3), or a
    sequence of frames of one size) to the JPEG file at the matching path,
    on `decode_threads()` threads. `quality` is libjpeg's, 1 to 100 (75 is
    PIL's default; cv2's imwrite writes 95)."""
    paths = [os.fsencode(p) for p in paths]
    n = len(paths)
    images = np.ascontiguousarray(images)
    if n == 0 and images.size == 0:
        return
    if images.dtype != np.uint8 or images.ndim != 4 or images.shape[-1] != 3:
        raise ValueError(f"save_images takes (N, H, W, 3) uint8 RGB frames, got "
                         f"{images.dtype} {images.shape}")
    if images.shape[0] != n:
        raise ValueError(f"save_images got {n} paths for {images.shape[0]} frames")
    if not 1 <= quality <= 100:
        raise ValueError(f"quality must lie in 1..100, got {quality}")
    _, h, w, _ = images.shape
    status = np.zeros(n, np.int32)
    names = (ctypes.c_char_p * n)(*paths)
    failed = _build.load_host().vdqn_jpeg_encode_batch(
        ctypes.cast(names, ctypes.c_void_p), n, images.ctypes.data, int(h), int(w),
        int(quality), status.ctypes.data, decode_threads())
    if failed:
        bad = np.flatnonzero(status)
        first = int(bad[0])
        raise RuntimeError(
            f"JPEG write failed for {failed} of {n} files; "
            f"{os.fsdecode(paths[first])} {ENCODE_STATUS.get(int(status[first]), 'failed')}"
            + (f" (and {len(bad) - 1} more)" if len(bad) > 1 else ""))
