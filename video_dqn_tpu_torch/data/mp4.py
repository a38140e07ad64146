"""The MP4 demuxer of frame extraction: the container half of the JAX
package's libavformat stage (native/decode/decode.cc), in the port's host
library (csrc/host/mp4_demux.cc, built at first use by _build.py).

`Mp4Video(path)` reads the H.264 video track of an mp4, plain or fragmented,
and holds its sample table: in decode order, each sample's pts and dts in
`timescale` ticks (the pts after the edit list, as libavformat applies it),
its key (sync) flag and whether it is shown (a sample outside the edit
list's media edit is decoded as a reference but not shown).
`access_units()` reads the samples as Annex B byte strings (start codes;
the SPS and PPS before each IDR), the decoder's input.

Any sample entry but avc1/avc3 (hvc1, hev1, av01, mp4v, encv, ...) raises a
ValueError that names its four-letter code; a truncated or malformed file
raises a ValueError with its path; a file that cannot be read an OSError.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass
from typing import Iterator, List

import numpy as np

from .. import _build

_ERR_LEN = 512
_OS_ERROR = 1   # csrc/host/mp4_demux.cc `Code`


@dataclass
class AccessUnit:
    index: int        # the sample's place in decode order
    data: bytes       # Annex B
    pts: int          # ticks, after the edit list
    key: bool
    shown: bool


def _raise(path: str, code: int, err) -> None:
    msg = f"{path}: {err.value.decode(errors='replace')}"
    raise OSError(msg) if code == _OS_ERROR else ValueError(msg)


class Mp4Video:
    """The video track of the mp4 at `path`; close() (or `with`) frees the
    demuxer."""

    def __init__(self, path):
        self.path = os.fspath(path)
        self._lib = _build.load_host()
        code = ctypes.c_int32()
        err = ctypes.create_string_buffer(_ERR_LEN)
        self._handle = self._lib.vdqn_mp4_open(os.fsencode(self.path), ctypes.byref(code), err,
                                               _ERR_LEN)
        if not self._handle:
            _raise(self.path, code.value, err)
        info = np.zeros(6, np.int64)
        self._lib.vdqn_mp4_info(self._handle, info.ctypes.data)
        n, self.timescale, self.width, self.height, self.nal_length_size, entry = (
            int(v) for v in info)
        self.codec = entry.to_bytes(4, "big").decode("latin-1")
        self.pts = np.zeros(n, np.int64)
        self.dts = np.zeros(n, np.int64)
        self.key = np.zeros(n, np.bool_)
        self.shown = np.zeros(n, np.bool_)
        self._bound = np.zeros(n, np.int64)
        self._lib.vdqn_mp4_samples(self._handle, self.pts.ctypes.data, self.dts.ctypes.data,
                                   self.key.ctypes.data, self.shown.ctypes.data,
                                   self._bound.ctypes.data)

    def __len__(self) -> int:
        return len(self.pts)

    def __enter__(self) -> "Mp4Video":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._handle:
            self._lib.vdqn_mp4_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()

    def seconds(self, ticks) -> np.ndarray:
        """ticks as the JAX package's decoder reckons a frame's time:
        pts * av_q2d(time_base), time_base 1 / timescale."""
        return np.asarray(ticks, np.int64) * (1.0 / self.timescale)

    def display_order(self) -> np.ndarray:
        """The shown samples' indices in display (pts) order."""
        shown = np.flatnonzero(self.shown)
        return shown[np.argsort(self.pts[shown], kind="stable")]

    def access_units(self, batch: int = 64) -> Iterator[AccessUnit]:
        """Every sample in decode order as Annex B, read `batch` samples a
        call."""
        if not self._handle:
            raise ValueError(f"{self.path}: the demuxer is closed")
        code = ctypes.c_int32()
        err = ctypes.create_string_buffer(_ERR_LEN)
        for first in range(0, len(self), batch):
            count = min(batch, len(self) - first)
            capacity = int(self._bound[first:first + count].sum())
            out = np.empty(capacity, np.uint8)
            ends = np.zeros(count, np.int64)
            got = self._lib.vdqn_mp4_read(self._handle, first, count, out.ctypes.data, capacity,
                                          ends.ctypes.data, ctypes.byref(code), err, _ERR_LEN)
            if got < 0:
                _raise(self.path, code.value, err)
            start = 0
            for k in range(count):
                i = first + k
                yield AccessUnit(i, out[start:ends[k]].tobytes(), int(self.pts[i]),
                                 bool(self.key[i]), bool(self.shown[i]))
                start = int(ends[k])


def demux(path) -> List[AccessUnit]:
    """Every access unit of the mp4 at `path`, in decode order."""
    with Mp4Video(path) as video:
        return list(video.access_units())
