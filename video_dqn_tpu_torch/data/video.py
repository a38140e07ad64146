"""Video -> frame extraction (counterpart of video_dqn_tpu/data/video.py
with its native engine): the paper's step from downloaded videos to 0.5 fps
JPEG frames, `<frames>/<vid>/%04d.jpg`.

The path: the MP4 demuxer and the H.264 decoder of the host library
(data/mp4.py, data/h264.py), the sampler, the NV12 -> RGB conversion of the
frames it keeps on the card (ops/nv12.py's kernel: each kept frame's planes
copied from the decoder into pinned staging, up to the card, converted, and
the RGB copied back into a pinned batch; its plain twin with device="cpu"),
and the host library's JPEG writer (data/jpeg.py save_images, quality 95 as
cv2's imwrite writes the JAX package's files, byte for byte the same file
for the same RGB).

The sampler is the JAX package's (native/decode/decode.cc:126-140): frames
in display order with their pts (seconds, after the edit list); a frame is
kept when t >= next - 1e-9, then next advances in steps of 1 / fps until it
passes t + 1e-9; next starts at 0; fps 0 keeps every frame.

`write_frames(frames, dest, fps, device)` is everything after the
decoder, over display-order (pts, frame) pairs whose frames have `width`,
`height` and `nv12(y, uv)` (the planes copied into the given arrays): the
sampler, the conversion and the writer. The decoder's frames and
`Nv12Frame`s over NV12 planes go through the same function.

Devices: `device=None` is the card and raises without CUDA; with
device="cpu" the conversion runs on the CPU. Decoding always runs on the
host: the card's NVDEC engines are not exposed on the machine the port
runs on.
"""

from __future__ import annotations

import os
import re
import shutil
import time
from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..ops.nv12 import nv12_to_rgb
from .h264 import decoded_frames
from .jpeg import save_images
from .mp4 import Mp4Video

JPEG_QUALITY = 95          # cv2.imwrite's default, the JAX package's writer
WRITE_BATCH = 16           # kept frames handed to the JPEG writer a call
_SLACK = 1e-9


class FrameSampler:
    """The JAX package's fixed-rate sampler over display-order frame times."""

    def __init__(self, fps: float):
        self.dt = 1.0 / fps if fps > 0 else 0.0
        self.next = 0.0

    def keep(self, t: float) -> bool:
        if self.dt <= 0:
            return True
        if t < self.next - _SLACK:
            return False
        while self.next <= t + _SLACK:
            self.next += self.dt
        return True


@dataclass
class Nv12Frame:
    """A decoded frame as NV12 planes (luma (H, W), chroma (H/2, W))."""
    y: np.ndarray
    uv: np.ndarray

    @property
    def width(self) -> int:
        return self.y.shape[1]

    @property
    def height(self) -> int:
        return self.y.shape[0]

    def nv12(self, y: np.ndarray, uv: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        y[...], uv[...] = self.y, self.uv
        return y, uv


class _Converter:
    """NV12 -> RGB of kept frames of one size into `rgb`, a host batch of
    `slots` frames: on a card the planes pass through pinned staging to
    the kernel and the RGB comes back into the pinned batch (synchronized
    before `convert` returns); on the CPU the twin writes the batch."""

    def __init__(self, device: torch.device, width: int, height: int, slots: int):
        self.device, self.size = device, (width, height)
        pinned = device.type == "cuda"
        self.rgb = torch.empty((slots, height, width, 3), dtype=torch.uint8, pin_memory=pinned)
        self.y = torch.empty((height, width), dtype=torch.uint8, pin_memory=pinned)
        self.uv = torch.empty((height // 2, width), dtype=torch.uint8, pin_memory=pinned)
        if pinned:
            self.y_dev = torch.empty_like(self.y, device=device)
            self.uv_dev = torch.empty_like(self.uv, device=device)

    def convert(self, frame, slot: int) -> None:
        frame.nv12(self.y.numpy(), self.uv.numpy())
        if self.device.type == "cpu":
            self.rgb[slot] = nv12_to_rgb(self.y, self.uv)
            return
        self.y_dev.copy_(self.y, non_blocking=True)
        self.uv_dev.copy_(self.uv, non_blocking=True)
        self.rgb[slot].copy_(nv12_to_rgb(self.y_dev, self.uv_dev), non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()


def sampled(frames: Iterable[Tuple[float, object]], fps: float) -> Iterator[object]:
    """The frames the sampler keeps, from display-order (pts, frame) pairs."""
    sampler = FrameSampler(fps)
    for t, frame in frames:
        if sampler.keep(t):
            yield frame


def write_frames(frames: Iterable[Tuple[float, object]], dest: str, fps: float = 0.5,
                 device=None, timings: Optional[dict] = None) -> int:
    """Sample display-order (pts, frame) pairs at `fps`, convert the kept
    frames to RGB on `device` (None: the card) and write them to
    dest/%04d.jpg from 0001 at quality 95.
    Returns the count. `timings`, where given, gains the host seconds of the
    conversion with its copy to the host ("convert") and of the writer
    ("write")."""
    device = resolve_device(device)
    os.makedirs(dest, exist_ok=True)
    clock = time.perf_counter
    timings = {} if timings is None else timings
    written, n, conv = 0, 0, None

    def flush():
        nonlocal written, n
        t0 = clock()
        paths = [os.path.join(dest, f"{written + k + 1:04d}.jpg") for k in range(n)]
        save_images(paths, conv.rgb[:n].numpy(), quality=JPEG_QUALITY)
        timings["write"] = timings.get("write", 0.0) + clock() - t0
        written, n = written + n, 0

    for frame in sampled(frames, fps):
        if conv is None or conv.size != (frame.width, frame.height):
            if n:
                flush()
            conv = _Converter(device, frame.width, frame.height, WRITE_BATCH)
        t0 = clock()
        conv.convert(frame, n)
        n += 1
        timings["convert"] = timings.get("convert", 0.0) + clock() - t0
        if n == WRITE_BATCH:
            flush()
    if n:
        flush()
    return written


def decode_frames(path: str, fps: float = 0.5, target=None, device=None) -> Iterator[np.ndarray]:
    """RGB uint8 (H, W, 3) frames of the mp4 at `path`, sampled at `fps`
    (0: every frame), converted on `device` (None: the card)."""
    if target is not None:
        raise NotImplementedError(
            "decode_frames(target=...), the resize fused into decoding, is not ported "
            "(ROADMAP.md queue 1, item 9)")
    dev = resolve_device(device)
    video = Mp4Video(path)

    def frames():
        conv = None
        with video:
            for frame in sampled(decoded_frames(video), fps):
                if conv is None or conv.size != (frame.width, frame.height):
                    conv = _Converter(dev, frame.width, frame.height, 1)
                conv.convert(frame, 0)
                yield conv.rgb[0].numpy().copy()

    return frames()


def extract_frames(video_path: str, dest: str, fps: float = 0.5, device=None,
                   timings: Optional[dict] = None) -> int:
    """Decode `video_path`, writing dest/%04d.jpg at `fps`, the kept frames
    converted on `device` (None: the card). Returns the number of frames
    written. `timings` gains the host seconds of the demuxer, the decoder,
    the conversion with its copies and the writer."""
    dev = resolve_device(device)
    with Mp4Video(video_path) as video:
        return write_frames(decoded_frames(video, timings), dest, fps, dev, timings)


def extract_all_frames(videos_dir: str, frames_dir: str, fps: float = 0.5,
                       device=None) -> List[str]:
    """Dump every <id>.mp4 under videos_dir in sorted order, skipping ids
    whose frame folder already exists (the resume); returns the ids
    extracted. A video whose extraction raises leaves no frame folder, so
    a resume takes it again."""
    dev = resolve_device(device)
    os.makedirs(frames_dir, exist_ok=True)
    done = []
    for name in sorted(os.listdir(videos_dir)):
        m = re.match(r"(.*)\.mp4$", name)
        if not m:
            continue
        vid = m.group(1)
        subdir = os.path.join(frames_dir, vid)
        if os.path.isdir(subdir):
            continue
        try:
            extract_frames(os.path.join(videos_dir, name), subdir, fps=fps, device=dev)
        except BaseException:
            shutil.rmtree(subdir, ignore_errors=True)
            raise
        done.append(vid)
    return done
