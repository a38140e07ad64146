"""The H.264 decoder of frame extraction: the Python side of
csrc/host/h264_decode.cc (in the host library, built at first use by
_build.py), the port's counterpart of the libavcodec decoder the JAX
package's decode stage runs (native/decode/decode.cc).

`H264Decoder` decodes access units (Annex B, as data/mp4.py hands them
over) in decoding order and keeps each picture under the caller's tag
until released. `decoded_frames(video)` drives it over an `Mp4Video` and
yields `(pts seconds, DecodedFrame)` for every shown frame in display
order (by the container's pts, as the decoder's output order is for a
conforming stream): a picture is released as soon as the caller resumes
the generator, so a frame's planes are copied out only where the caller
asks (`nv12()`, into the caller's arrays where given).

What the decoder takes (CABAC, progressive 8-bit 4:2:0: YouTube's and
x264's High and Main profile streams) and refuses is listed in the C++
source; a stream it refuses raises NotImplementedError, a malformed one
ValueError, each with the video's path. There is no other decoder.
"""

from __future__ import annotations

import ctypes
import time
from typing import Iterator, Optional, Tuple

import numpy as np

from .. import _build
from .mp4 import Mp4Video

_ERR_LEN = 512
_UNSUPPORTED = 3  # csrc/host/h264_decode.cc `Code`


class H264Decoder:
    """One decoding session; close() (or `with`) frees it."""

    def __init__(self, name: str = "stream"):
        self.name = name
        self._lib = _build.load_host()
        self._handle = self._lib.vdqn_h264_open()
        self._err = ctypes.create_string_buffer(_ERR_LEN)

    def __enter__(self) -> "H264Decoder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._handle:
            self._lib.vdqn_h264_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()

    def decode(self, access_unit: bytes, tag: int) -> None:
        """Decode one access unit; its picture is kept under `tag`."""
        status = self._lib.vdqn_h264_decode(self._handle, access_unit, len(access_unit), int(tag),
                                            self._err, _ERR_LEN)
        if status != 0:
            msg = f"{self.name}: H.264 {self._err.value.decode(errors='replace')}"
            raise NotImplementedError(msg) if status == _UNSUPPORTED else ValueError(msg)

    def size(self, tag: int) -> Tuple[int, int, bool]:
        """(width, height, full range) of the display area of the picture
        under `tag`."""
        info = (ctypes.c_int32 * 5)()
        if self._lib.vdqn_h264_info(self._handle, int(tag), info) != 0:
            raise KeyError(f"no picture held under tag {tag}")
        return info[0], info[1], bool(info[4])

    def nv12(self, tag: int, width: int, height: int, y: Optional[np.ndarray] = None,
             uv: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
        """The picture under `tag` as (luma (H, W), interleaved chroma
        (H/2, W)) uint8 planes, copied into `y` and `uv` where given
        (C-contiguous, of those shapes)."""
        y = np.empty((height, width), np.uint8) if y is None else y
        uv = np.empty((height // 2, width), np.uint8) if uv is None else uv
        if (y.shape, uv.shape) != ((height, width), (height // 2, width)) or not (
                y.flags.c_contiguous and uv.flags.c_contiguous and y.dtype == uv.dtype == np.uint8):
            raise ValueError(f"NV12 planes for {width}x{height} take contiguous uint8 arrays of "
                             f"{(height, width)} and {(height // 2, width)}")
        if self._lib.vdqn_h264_copy(self._handle, int(tag), y.ctypes.data, width, uv.ctypes.data,
                                    width) != 0:
            raise KeyError(f"no picture held under tag {tag}")
        return y, uv

    def release(self, tag: int) -> None:
        self._lib.vdqn_h264_release(self._handle, int(tag))


class DecodedFrame:
    """A decoded picture, valid until the generator that yielded it goes
    on."""

    def __init__(self, decoder: H264Decoder, tag: int, width: int, height: int):
        self._decoder, self._tag, self.width, self.height = decoder, tag, width, height

    def nv12(self, y: Optional[np.ndarray] = None, uv: Optional[np.ndarray] = None
             ) -> Tuple[np.ndarray, np.ndarray]:
        return self._decoder.nv12(self._tag, self.width, self.height, y, uv)


def decoded_frames(video: Mp4Video, timings: Optional[dict] = None
                   ) -> Iterator[Tuple[float, DecodedFrame]]:
    """(pts in seconds, frame) of every shown frame of `video` in display
    order. `timings`, where given, gains the host seconds of the demuxer
    ("demux") and of the decoder ("decode")."""
    clock = time.perf_counter
    seconds = video.seconds(video.pts)
    order = video.display_order()
    waiting = set()  # decoded shown samples not yet yielded
    at = 0
    with H264Decoder(video.path) as decoder:
        units = video.access_units()
        while True:
            t0 = clock()
            au = next(units, None)
            t1 = clock()
            if au is not None:
                decoder.decode(au.data, au.index)
            t2 = clock()
            if timings is not None:
                timings["demux"] = timings.get("demux", 0.0) + t1 - t0
                timings["decode"] = timings.get("decode", 0.0) + t2 - t1
            if au is None:
                break
            if not au.shown:  # outside the edit list: decoded, not shown
                decoder.release(au.index)
                continue
            waiting.add(au.index)
            while at < len(order) and int(order[at]) in waiting:
                i = int(order[at])
                width, height, full_range = decoder.size(i)
                if full_range:
                    raise NotImplementedError(
                        f"{video.path} signals full-range video, which swscale converts with "
                        "other coefficients; the port converts limited range only")
                yield float(seconds[i]), DecodedFrame(decoder, i, width, height)
                decoder.release(i)
                waiting.discard(i)
                at += 1
        if at != len(order):
            raise ValueError(f"{video.path}: {len(order) - at} shown samples were never decoded")
