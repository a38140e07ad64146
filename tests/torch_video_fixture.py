"""The frame-extraction fixture of the port, shared by the CPU tests, the
card tests and chip_smoke.py phase 14 (jax-free: the card's machine has no
jax). tests/torch_video_util.py writes it (committed; rerun only to change
it):

    JAX_PLATFORMS=cpu python -m tests.torch_video_util

tests/data/torch_video/ holds
  small.mp4             160x120, 30 fps, 12 s: libx264 High (bframes 3,
                        keyint 12, crf 20) in an mp4 with edts/elst (media
                        time 2 frames), ctts and stss; 120 lines are coded
                        as 128, so the decoder's picture is cropped;
  small_fragmented.mp4  the samples of small.mp4 rewritten as moof/trun
                        fragments, a GOP each (mvex/trex, tfhd, tfdt, trun);
  hd720.mp4             1280x720, 30 fps, 20 s, moving content (2.8 MB);
  features/<name>.mp4   short x264 clips of the coding tools small.mp4 does
                        not use (`FEATURES`) and of streams the port's decoder
                        refuses (`REFUSED`);
  expected.npz          the oracle, from libavformat and libavcodec and from
                        the JAX package (`VIDEOS` each):
    <v>_timescale                   the track's mdhd timescale
    <v>_packet_pts, _packet_dts,    av_read_frame's packets in decode order:
    <v>_packet_flags, _packet_size  ticks, AV_PKT_FLAG_*, bytes
    <v>_frame_pts                   the decoded frames in display order, ticks
                                    (best_effort_timestamp)
    <v>_keep                        the indices into <v>_frame_pts of the
                                    frames the JAX package's
                                    decode_frames(fps=0.5) returns
    <v>_nv12_sha256                 SHA-256 of each kept frame's NV12 planes
                                    (the luma rows, then the interleaved
                                    chroma rows, W bytes a row)
    <v>_jpeg_sha256                 SHA-256 of each file the JAX package's
                                    extract_frames(fps=0.5) writes (0001.jpg
                                    on), for small and hd720
    small_all_nv12_sha256           every frame of small.mp4, display order
    feature_<name>_nv12_sha256,     every frame of a feature clip and its pts
    feature_<name>_frame_pts
    variant_<name>_packet_pts,      small.mp4 rewritten (torch_video_util
    _packet_flags, _frame_pts       VARIANTS): packets and frames
    small_nv12_y, small_nv12_uv     small.mp4's kept frames' NV12 planes
    small_rgb                       the JAX package's RGB frames of small.mp4
                                    at fps 0.5
"""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent / "data" / "torch_video"
# name: (x264 parameters, width, height, frames, content)
FEATURES = {
    "partitions": ("bframes=0:partitions=all:ref=3:subme=9:me=umh:mixed-refs=1", 96, 64, 10, "texture"),
    "temporal_direct": ("bframes=3:direct=temporal:b-pyramid=strict:weightb=1:ref=3", 96, 64, 12,
                        "texture"),
    "slices": ("bframes=2:slices=3:ref=2:partitions=all:direct=spatial", 96, 64, 10, "texture"),
    "scaling_matrix": ("cqm=jvt:bframes=2", 96, 64, 8, "texture"),
    "constrained_intra": ("constrained-intra=1:bframes=1", 96, 64, 8, "texture"),
    "weighted": ("bframes=2:weightp=2:weightb=1:ref=2", 96, 64, 16, "fade"),
    "cropped": ("bframes=2", 100, 70, 8, "texture"),
}
# name: (x264 parameters, width, height, frames, the decoder's reason)
REFUSED = {
    "cavlc": ("cabac=0", 64, 48, 4, "CAVLC"),
    "interlaced": ("interlaced=1", 64, 48, 4, "interlaced"),
    "lossless": ("qp=0", 64, 48, 4, "lossless"),
}


def feature_path(name: str) -> Path:
    return ROOT / "features" / f"{name}.mp4"

VIDEOS = ("small", "small_fragmented", "hd720")
# the videos extract_frames --dump runs over in the CLI checks
DUMP_VIDEOS = ("small", "hd720")
AV_PKT_FLAG_KEY, AV_PKT_FLAG_DISCARD = 1, 4


def path(video: str) -> Path:
    return ROOT / f"{video}.mp4"


def expected() -> dict:
    with np.load(ROOT / "expected.npz") as z:
        return {k: z[k] for k in z.files}


def nv12_sha256(y, uv) -> str:
    """SHA-256 of an NV12 frame: its (H, W) luma rows, then its (H/2, W)
    interleaved chroma rows."""
    h = hashlib.sha256(np.ascontiguousarray(y, np.uint8).tobytes())
    h.update(np.ascontiguousarray(uv, np.uint8).tobytes())
    return h.hexdigest()


def file_sha256(p) -> str:
    return hashlib.sha256(Path(p).read_bytes()).hexdigest()


def display_seconds(exp: dict, video: str) -> np.ndarray:
    """The display-order frame times as the JAX package's decoder reckons
    them: ticks * av_q2d(1 / timescale)."""
    return exp[f"{video}_frame_pts"] * (1.0 / float(exp[f"{video}_timescale"]))
