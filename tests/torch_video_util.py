"""Write the frame-extraction fixture, tests/data/torch_video/ (what it holds:
tests/torch_video_fixture.py). Committed; rerun only to change it:

    JAX_PLATFORMS=cpu python -m tests.torch_video_util

It needs the JAX package's native encoder and decoder (libx264 and
libav*), cv2 for the JAX package's frame writer, and a C compiler with
pkg-config's libavformat, libavcodec and libx264: the oracle and the
feature encoder below are small C helpers built into a temporary folder
(the oracle loaded with ctypes, as the test environment has no PyAV and
no ffmpeg CLI). The card's machine has none of these, so the fixture is
committed and regenerated only where they are installed.

`FEATURES` are short clips that x264 codes with the coding tools a
decoder must get right beyond small.mp4's (every partition size, explicit
and implicit weighted prediction, temporal direct, several slices, a
scaling matrix, constrained intra prediction, a cropped size); `REFUSED`
are clips the port's decoder refuses (CAVLC, interlaced, lossless).

`fragment(data)` rewrites an mp4's samples as moof/trun fragments, one a
GOP, with the moov's sample tables emptied and an mvex/trex added.
`VARIANTS` are small.mp4 rewritten with other edit lists, signed
composition offsets and a version-1 trun; `record_variants` adds
libavformat's reading of each to expected.npz, and the CPU tests rebuild
them (`variant(name)`) and hold the demuxer to it.
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from tests.torch_video_fixture import (AV_PKT_FLAG_DISCARD, FEATURES, REFUSED, ROOT,
                                       feature_path, file_sha256, nv12_sha256, path)

ORACLE_C = r"""
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <stdint.h>
#include <string.h>

static int open_video(const char* p, AVFormatContext** fmt) {
  *fmt = NULL;
  if (avformat_open_input(fmt, p, NULL, NULL) < 0) return -1;
  if (avformat_find_stream_info(*fmt, NULL) < 0) return -1;
  return av_find_best_stream(*fmt, AVMEDIA_TYPE_VIDEO, -1, -1, NULL, 0);
}

/* the video packets in decode order; returns their count */
long oracle_packets(const char* p, int64_t* pts, int64_t* dts, int32_t* flags,
                    int32_t* size, long cap, int32_t* tb) {
  AVFormatContext* fmt;
  int s = open_video(p, &fmt);
  if (s < 0) return -1;
  tb[0] = fmt->streams[s]->time_base.num;
  tb[1] = fmt->streams[s]->time_base.den;
  AVPacket* pkt = av_packet_alloc();
  long n = 0;
  while (av_read_frame(fmt, pkt) >= 0) {
    if (pkt->stream_index == s) {
      if (n < cap) {
        pts[n] = pkt->pts; dts[n] = pkt->dts; flags[n] = pkt->flags; size[n] = pkt->size;
      }
      n++;
    }
    av_packet_unref(pkt);
  }
  av_packet_free(&pkt);
  avformat_close_input(&fmt);
  return n;
}

typedef struct {
  AVFormatContext* fmt; AVCodecContext* dec; AVPacket* pkt; AVFrame* frame;
  int stream, flushed;
} Oracle;

void* oracle_open(const char* p, int* w, int* h) {
  Oracle* o = calloc(1, sizeof(Oracle));
  o->stream = open_video(p, &o->fmt);
  if (o->stream < 0) return NULL;
  AVStream* st = o->fmt->streams[o->stream];
  const AVCodec* codec = avcodec_find_decoder(st->codecpar->codec_id);
  o->dec = avcodec_alloc_context3(codec);
  avcodec_parameters_to_context(o->dec, st->codecpar);
  if (avcodec_open2(o->dec, codec, NULL) < 0) return NULL;
  o->pkt = av_packet_alloc();
  o->frame = av_frame_alloc();
  *w = o->dec->width; *h = o->dec->height;
  return o;
}

/* the next frame in display order as NV12 (W-byte rows): 1, 0 at the end,
   < 0 on error */
int oracle_next(void* handle, int64_t* pts, uint8_t* nv12) {
  Oracle* o = handle;
  for (;;) {
    int r = avcodec_receive_frame(o->dec, o->frame);
    if (r == 0) {
      AVFrame* f = o->frame;
      if (f->format != AV_PIX_FMT_YUV420P) return -3;
      int w = f->width, h = f->height;
      for (int y = 0; y < h; y++) memcpy(nv12 + (size_t)y * w, f->data[0] + (size_t)y * f->linesize[0], w);
      uint8_t* uv = nv12 + (size_t)w * h;
      for (int y = 0; y < h / 2; y++)
        for (int x = 0; x < w / 2; x++) {
          uv[(size_t)y * w + 2 * x] = f->data[1][(size_t)y * f->linesize[1] + x];
          uv[(size_t)y * w + 2 * x + 1] = f->data[2][(size_t)y * f->linesize[2] + x];
        }
      *pts = f->best_effort_timestamp;
      av_frame_unref(f);
      return 1;
    }
    if (r == AVERROR_EOF) return 0;
    if (r != AVERROR(EAGAIN)) return -1;
    if (o->flushed) return 0;
    for (;;) {
      if (av_read_frame(o->fmt, o->pkt) < 0) {
        avcodec_send_packet(o->dec, NULL);
        o->flushed = 1;
        break;
      }
      if (o->pkt->stream_index != o->stream) { av_packet_unref(o->pkt); continue; }
      r = avcodec_send_packet(o->dec, o->pkt);
      av_packet_unref(o->pkt);
      if (r < 0) return -2;
      break;
    }
  }
}

void oracle_close(void* handle) {
  Oracle* o = handle;
  av_frame_free(&o->frame);
  av_packet_free(&o->pkt);
  avcodec_free_context(&o->dec);
  avformat_close_input(&o->fmt);
  free(o);
}
"""


ENCODER_C = r"""
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
#include <stdio.h>
#include <stdlib.h>

static int drain(AVCodecContext* c, AVFormatContext* f, AVStream* s, AVPacket* p) {
  int r;
  while ((r = avcodec_receive_packet(c, p)) == 0) {
    av_packet_rescale_ts(p, c->time_base, s->time_base);
    p->stream_index = 0;
    if (av_interleaved_write_frame(f, p) < 0) return -1;
  }
  return r == AVERROR(EAGAIN) || r == AVERROR_EOF ? 0 : r;
}

/* encode n yuv420p frames (w x h, planes back to back) into an mp4 with
   libx264, preset fast, the x264 parameters given */
int encode(const char* out, int w, int h, int n, const uint8_t* yuv, const char* params) {
  const AVCodec* codec = avcodec_find_encoder_by_name("libx264");
  AVFormatContext* f = NULL;
  if (!codec || avformat_alloc_output_context2(&f, NULL, NULL, out) < 0) return -1;
  AVStream* s = avformat_new_stream(f, NULL);
  AVCodecContext* c = avcodec_alloc_context3(codec);
  c->width = w; c->height = h; c->pix_fmt = AV_PIX_FMT_YUV420P;
  c->time_base = (AVRational){1, 30}; c->framerate = (AVRational){30, 1};
  if (f->oformat->flags & AVFMT_GLOBALHEADER) c->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  av_opt_set(c->priv_data, "preset", "fast", 0);
  av_opt_set(c->priv_data, "x264-params", params, 0);
  if (avcodec_open2(c, codec, NULL) < 0) return -2;
  avcodec_parameters_from_context(s->codecpar, c);
  s->time_base = c->time_base;
  if (avio_open(&f->pb, out, AVIO_FLAG_WRITE) < 0 || avformat_write_header(f, NULL) < 0) return -3;
  AVFrame* fr = av_frame_alloc();
  fr->format = AV_PIX_FMT_YUV420P; fr->width = w; fr->height = h;
  av_frame_get_buffer(fr, 0);
  AVPacket* p = av_packet_alloc();
  const size_t size = (size_t)w * h * 3 / 2;
  for (int i = 0; i < n; i++) {
    const uint8_t* src = yuv + i * size;
    av_frame_make_writable(fr);
    for (int y = 0; y < h; y++) memcpy(fr->data[0] + y * fr->linesize[0], src + (size_t)y * w, w);
    for (int y = 0; y < h / 2; y++) {
      memcpy(fr->data[1] + y * fr->linesize[1], src + (size_t)w * h + (size_t)y * (w / 2), w / 2);
      memcpy(fr->data[2] + y * fr->linesize[2], src + (size_t)w * h * 5 / 4 + (size_t)y * (w / 2), w / 2);
    }
    fr->pts = i;
    if (avcodec_send_frame(c, fr) < 0 || drain(c, f, s, p) < 0) return -4;
  }
  if (avcodec_send_frame(c, NULL) < 0 || drain(c, f, s, p) < 0) return -5;
  av_write_trailer(f);
  avio_closep(&f->pb);
  av_packet_free(&p); av_frame_free(&fr); avcodec_free_context(&c); avformat_free_context(f);
  return 0;
}
"""


def build_helper(build_dir: str, name: str, source: str, packages: list) -> ctypes.CDLL:
    src = Path(build_dir) / f"{name}.c"
    lib = Path(build_dir) / f"lib{name}.so"
    src.write_text("#include <stdlib.h>\n#include <string.h>\n" + source)
    flags = subprocess.run(["pkg-config", "--cflags", "--libs", *packages], capture_output=True,
                           text=True, check=True).stdout.split()
    subprocess.run(["cc", "-O2", "-shared", "-fPIC", "-o", str(lib), str(src), *flags], check=True)
    return ctypes.CDLL(str(lib))


class Oracle:
    """libavformat's packets and libavcodec's frames of a video, through the
    C helper above."""

    def __init__(self, build_dir: str):
        self.lib = build_helper(build_dir, "oracle", ORACLE_C,
                                ["libavformat", "libavcodec", "libavutil"])
        self.lib.oracle_packets.restype = ctypes.c_long
        self.lib.oracle_packets.argtypes = [ctypes.c_char_p] + [ctypes.c_void_p] * 4 + [
            ctypes.c_long, ctypes.c_void_p]
        self.lib.oracle_open.restype = ctypes.c_void_p
        self.lib.oracle_open.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p]
        self.lib.oracle_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        self.lib.oracle_close.argtypes = [ctypes.c_void_p]

    def packets(self, p) -> dict:
        cap = 1 << 16
        out = {"pts": np.zeros(cap, np.int64), "dts": np.zeros(cap, np.int64),
               "flags": np.zeros(cap, np.int32), "size": np.zeros(cap, np.int32)}
        tb = np.zeros(2, np.int32)
        n = self.lib.oracle_packets(os.fsencode(p), *(a.ctypes.data for a in out.values()),
                                    cap, tb.ctypes.data)
        if not 0 <= n <= cap:
            raise RuntimeError(f"libavformat could not read {p} ({n})")
        if tb[0] != 1:
            raise RuntimeError(f"{p}: time base {tb[0]}/{tb[1]}, not 1/timescale")
        return {**{k: v[:n] for k, v in out.items()}, "timescale": int(tb[1])}

    def frames(self, p):
        """Yield (best_effort_timestamp, y (H, W), uv (H/2, W)) in display
        order."""
        w, h = ctypes.c_int(), ctypes.c_int()
        handle = self.lib.oracle_open(os.fsencode(p), ctypes.byref(w), ctypes.byref(h))
        if not handle:
            raise RuntimeError(f"libavcodec could not open {p}")
        try:
            buf = np.empty(w.value * h.value * 3 // 2, np.uint8)
            pts = ctypes.c_int64()
            while True:
                r = self.lib.oracle_next(handle, ctypes.byref(pts), buf.ctypes.data)
                if r == 0:
                    return
                if r < 0:
                    raise RuntimeError(f"libavcodec failed on {p} ({r})")
                y = buf[:w.value * h.value].reshape(h.value, w.value).copy()
                uv = buf[w.value * h.value:].reshape(h.value // 2, w.value).copy()
                yield pts.value, y, uv
        finally:
            self.lib.oracle_close(handle)


# -- ISO BMFF rewriting -------------------------------------------------------

CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"edts", b"dinf"}


def box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def full_box(kind: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return box(kind, struct.pack(">I", (version << 24) | flags) + payload)


def parse_boxes(data: bytes, start: int = 0, end: int = None) -> list:
    """[(kind, payload or children)] of the boxes in data[start:end]; the
    containers above are parsed into their children."""
    end = len(data) if end is None else end
    out = []
    while start < end:
        size, kind = struct.unpack_from(">I4s", data, start)
        head = 8
        if size == 1:
            size, head = struct.unpack_from(">Q", data, start + 8)[0], 16
        elif size == 0:
            size = end - start
        body = (start + head, start + size)
        out.append((kind, parse_boxes(data, *body) if kind in CONTAINERS
                    else data[body[0]:body[1]]))
        start += size
    return out


def write_boxes(boxes: list) -> bytes:
    return b"".join(box(k, write_boxes(v) if isinstance(v, list) else v) for k, v in boxes)


def find(boxes: list, *kinds: bytes):
    for k, v in boxes:
        if k == kinds[0]:
            return v if len(kinds) == 1 else find(v, *kinds[1:])
    raise KeyError(kinds[0])


def replace(boxes: list, kind: bytes, value) -> list:
    return [(k, value if k == kind else v) for k, v in boxes]


def _table(payload: bytes, fmt: str) -> list:
    n = struct.unpack_from(">I", payload, 4)[0]
    step = struct.calcsize(fmt)
    return [struct.unpack_from(fmt, payload, 8 + i * step) for i in range(n)]


def sample_table(data: bytes) -> dict:
    """The video track's samples of a non-fragmented mp4: offset, size,
    duration, composition offset and sync flag each, in decode order."""
    top = parse_boxes(data)
    stbl = find(find(top, b"moov"), b"trak", b"mdia", b"minf", b"stbl")
    sizes = [s for (s,) in _table(find(stbl, b"stsz")[4:], ">I")] if struct.unpack_from(
        ">I", find(stbl, b"stsz"), 4)[0] == 0 else None
    if sizes is None:
        raise ValueError("fixed-size stsz: not needed by the fixture")
    chunks = [o for (o,) in _table(find(stbl, b"stco"), ">I")]
    stsc = _table(find(stbl, b"stsc"), ">III")
    offsets = []
    for i, chunk in enumerate(chunks):
        per = next(n for first, n, _ in reversed(stsc) if first <= i + 1)
        pos = chunk
        for _ in range(per):
            offsets.append(pos)
            pos += sizes[len(offsets) - 1]
    durations = [d for n, d in _table(find(stbl, b"stts"), ">II") for _ in range(n)]
    ctts = [o for n, o in _table(find(stbl, b"ctts"), ">Ii") for _ in range(n)]
    sync = {s - 1 for (s,) in _table(find(stbl, b"stss"), ">I")}
    return {"offset": offsets, "size": sizes, "duration": durations, "cto": ctts,
            "sync": [i in sync for i in range(len(sizes))], "top": top}


def _rebuild_trak(data: bytes, change) -> bytes:
    """data with its moov's trak replaced by change(trak boxes)."""
    top = parse_boxes(data)
    moov = find(top, b"moov")
    moov = replace(moov, b"trak", change(find(moov, b"trak")))
    return write_boxes([(k, moov if k == b"moov" else v) for k, v in top])


def _elst(entries) -> bytes:
    """An edts box's children: one elst (version 0) of (duration in the
    movie timescale, media time) entries at rate 1."""
    return [(b"elst", struct.pack(">II", 0, len(entries)) + b"".join(
        struct.pack(">IiHH", d, t, 1, 0) for d, t in entries))]


def without_edit_list(data: bytes) -> bytes:
    return _rebuild_trak(data, lambda trak: [(k, v) for k, v in trak if k != b"edts"])


def with_edit_list(data: bytes, entries) -> bytes:
    return _rebuild_trak(data, lambda trak: replace(trak, b"edts", _elst(entries)))


def with_signed_ctts(data: bytes, shift: int) -> bytes:
    """No edit list, and a version-1 ctts whose offsets are shifted by
    `shift` (negative offsets, as an encoder writes them without an edit
    list)."""
    def change(trak):
        stbl = find(trak, b"mdia", b"minf", b"stbl")
        rows = _table(find(stbl, b"ctts"), ">Ii")
        ctts = struct.pack(">II", 1 << 24, len(rows)) + b"".join(
            struct.pack(">Ii", n, o + shift) for n, o in rows)
        minf = replace(find(trak, b"mdia", b"minf"), b"stbl", replace(stbl, b"ctts", ctts))
        trak = replace(trak, b"mdia", replace(find(trak, b"mdia"), b"minf", minf))
        return [(k, v) for k, v in trak if k != b"edts"]
    return _rebuild_trak(data, change)


def with_sample_entry(data: bytes, code: bytes) -> bytes:
    """data with its sample entry renamed (an hvc1 entry by hand)."""
    at = data.index(b"avc1", data.index(b"stsd"))
    return data[:at] + code + data[at + 4:]


def fragment(data: bytes, trun_version: int = 0, cto_shift: int = 0) -> bytes:
    """data's video samples rewritten as one moof + mdat a GOP (tfhd with
    default-base-is-moof, tfdt version 1, trun of `trun_version` with each
    sample's duration, size, flags and composition offset plus
    `cto_shift`); the moov keeps its boxes (the edit list too) with empty
    sample tables and gains an mvex/trex."""
    t = sample_table(data)
    moov = find(t["top"], b"moov")
    trak = find(moov, b"trak")
    tkhd = find(trak, b"tkhd")
    track_id = struct.unpack_from(">I", tkhd, 4 + (16 if tkhd[0] == 1 else 8))[0]
    stbl = find(trak, b"mdia", b"minf", b"stbl")
    empty = struct.pack(">II", 0, 0)
    new_stbl = [(b"stsd", find(stbl, b"stsd")), (b"stts", empty), (b"stsc", empty),
                (b"stsz", struct.pack(">III", 0, 0, 0)), (b"stco", empty)]
    minf = replace(find(trak, b"mdia", b"minf"), b"stbl", new_stbl)
    mdia = replace(find(trak, b"mdia"), b"minf", minf)
    new_trak = replace(trak, b"mdia", mdia)
    trex = full_box(b"trex", 0, 0, struct.pack(">IIIII", track_id, 1, 0, 0, 0))
    new_moov = [(k, v) for k, v in replace(moov, b"trak", new_trak) if k != b"udta"]
    out = [box(b"ftyp", b"iso5" + struct.pack(">I", 512) + b"iso5iso6mp41"),
           write_boxes([(b"moov", new_moov + [(b"mvex", [(b"trex", trex[8:])])])])]
    starts = [i for i, s in enumerate(t["sync"]) if s] + [len(t["size"])]
    dts = np.concatenate([[0], np.cumsum(t["duration"])])
    trun_flags = 0x000001 | 0x000100 | 0x000200 | 0x000400 | 0x000800
    for seq, (a, b) in enumerate(zip(starts[:-1], starts[1:])):
        entries = b"".join(struct.pack(">IIII", t["duration"][i], t["size"][i],
                                       0x02000000 if t["sync"][i] else 0x01010000,
                                       (t["cto"][i] + cto_shift) & 0xFFFFFFFF)
                           for i in range(a, b))
        payload = b"".join(data[t["offset"][i]:t["offset"][i] + t["size"][i]]
                           for i in range(a, b))

        def moof(data_offset: int) -> bytes:
            trun = full_box(b"trun", trun_version, trun_flags,
                            struct.pack(">Ii", b - a, data_offset) + entries)
            traf = box(b"traf", full_box(b"tfhd", 0, 0x020000, struct.pack(">I", track_id))
                       + full_box(b"tfdt", 1, 0, struct.pack(">Q", int(dts[a]))) + trun)
            return box(b"moof", full_box(b"mfhd", 0, 0, struct.pack(">I", seq + 1)) + traf)

        size = len(moof(0))
        out += [moof(size + 8), box(b"mdat", payload)]
    return b"".join(out)


# small.mp4 rewritten (movie timescale 1000, media timescale 15360, 512
# ticks a frame, media time 1024 in its own edit list): each variant's
# libavformat packets and libavcodec frames are in expected.npz as
# variant_<name>_packet_pts, _packet_flags and _frame_pts
FRAME, M = 512, 1024
VARIANTS = {
    "no_edit_list": without_edit_list,
    "empty_edit": lambda d: with_edit_list(d, [(500, -1), (12000, M)]),
    "late_edit": lambda d: with_edit_list(d, [(11667, M + 10 * FRAME)]),
    "short_edit": lambda d: with_edit_list(d, [(5000, M)]),
    "signed_ctts": lambda d: with_signed_ctts(d, -M),
    "fragmented_v1": lambda d: fragment(without_edit_list(d), trun_version=1, cto_shift=-M),
}


def variant(name: str) -> bytes:
    return VARIANTS[name](path("small").read_bytes())


# -- the videos -----------------------------------------------------------------

def small_frames(n: int = 360, w: int = 160, h: int = 120):
    """Soft colour waves that pan 2 pixels right and 1 down a frame, and a
    square that moves over them: every frame differs from the others."""
    yy, xx = np.mgrid[0:h + n, 0:w + 2 * n].astype(np.float64)
    waves = np.stack([128 + 20 * np.sin(xx / 23 + np.sin(yy / 31)),
                      128 + 20 * np.sin(yy / 19 + xx / 57),
                      128 + 20 * np.sin((xx + 2 * yy) / 41)], -1)
    for i in range(n):
        frame = waves[i:i + h, 2 * i:2 * i + w].copy()
        x0, y0 = (3 * i) % (w - 24), (2 * i) % (h - 24)
        frame[y0:y0 + 24, x0:x0 + 24] = (240, 60, 30)
        yield frame.astype(np.uint8)


def hd_frames(n: int = 600, w: int = 1280, h: int = 720, seed: int = 0):
    """A 20 s pan over soft waves with a few sharp lines, and six squares
    that move over it: motion everywhere, as in a walk-through, at about
    1.1 Mbit/s."""
    big_h, big_w = h + n // 4 + 1, w + 2 * n
    yy, xx = np.mgrid[0:big_h, 0:big_w].astype(np.float32)
    waves = np.stack([128 + 20 * np.sin(xx / 53 + np.sin(yy / 71) * 2),
                      128 + 20 * np.sin(yy / 37 + xx / 97),
                      128 + 20 * np.sin((xx + 2 * yy) / 83)], -1)
    waves[(xx.astype(int) % 512) < 2] = 220
    squares = np.random.default_rng(seed).integers(0, 256, (6, 3))
    for i in range(n):
        dx, dy = 2 * i, i // 4
        frame = waves[dy:dy + h, dx:dx + w].copy()
        for j, colour in enumerate(squares):
            x0 = int((w - 120) * (0.5 + 0.5 * np.sin(i / (23 + 7 * j) + j)))
            y0 = int((h - 120) * (0.5 + 0.5 * np.cos(i / (31 + 5 * j) + 2 * j)))
            frame[y0:y0 + 120, x0:x0 + 120] = colour
        yield frame.clip(0, 255).astype(np.uint8)


def clip_frames(w: int, h: int, n: int, content: str, seed: int = 0) -> np.ndarray:
    """(n, h * w * 3 / 2) yuv420p frames: a noisy texture that pans and
    brightens in steps (content "texture"), or fades out and in ("fade")."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w + 3 * n].astype(np.float64)
    texture = 128 + 50 * np.sin(xx / 5) * np.cos(yy / 7) + rng.normal(0, 12, xx.shape)
    out = []
    for i in range(n):
        y = texture[:, 3 * i:3 * i + w]
        if content == "fade":
            y = 128 + (y - 128) * abs(np.cos(i / 5)) - 40 * np.sin(i / 4)
        else:
            y = y + 4 * (i % 3)
        u = 128 + 40 * np.sin(xx[:h // 2, 3 * i:3 * i + w:2] / 9 + i / 3)
        v = 128 + 40 * np.cos(yy[:h // 2, :w:2] / 6 - i / 4)
        out.append(np.concatenate([np.clip(p, 0, 255).astype(np.uint8).ravel() for p in (y, u, v)]))
    return np.stack(out)


def encode_clip(encoder: ctypes.CDLL, path: Path, params: str, w: int, h: int, n: int,
                content: str) -> None:
    frames = np.ascontiguousarray(clip_frames(w, h, n, content))
    encoder.encode.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_char_p]
    rc = encoder.encode(os.fsencode(path), w, h, n, frames.ctypes.data, params.encode())
    if rc != 0:
        raise RuntimeError(f"encoding {path} failed ({rc})")


def record_features(exp: dict, oracle: Oracle, tmp: str) -> None:
    encoder = build_helper(tmp, "encoder", ENCODER_C, ["libavformat", "libavcodec", "libavutil"])
    (ROOT / "features").mkdir(exist_ok=True)
    for name, (params, w, h, n, content) in FEATURES.items():
        encode_clip(encoder, feature_path(name), params, w, h, n, content)
        frames = list(oracle.frames(feature_path(name)))
        shown = int((oracle.packets(feature_path(name))["flags"] & AV_PKT_FLAG_DISCARD == 0).sum())
        if len(frames) != shown:
            raise AssertionError(f"{name}: {len(frames)} frames decoded, {shown} shown")
        exp[f"feature_{name}_nv12_sha256"] = np.asarray([nv12_sha256(y, uv) for _, y, uv in frames])
        exp[f"feature_{name}_frame_pts"] = np.asarray([pts for pts, _, _ in frames], np.int64)
    for name, (params, w, h, n, _) in REFUSED.items():
        encode_clip(encoder, feature_path(name), params, w, h, n, "texture")


def record_variants(exp: dict, oracle: Oracle, tmp: str) -> None:
    for name in VARIANTS:
        p = Path(tmp) / f"{name}.mp4"
        p.write_bytes(variant(name))
        pk = oracle.packets(p)
        exp[f"variant_{name}_packet_pts"] = pk["pts"]
        exp[f"variant_{name}_packet_flags"] = pk["flags"]
        exp[f"variant_{name}_frame_pts"] = np.asarray([pts for pts, _, _ in oracle.frames(p)],
                                                      np.int64)


def regenerate() -> None:
    from video_dqn_tpu.data import native_decode, video

    ROOT.mkdir(parents=True, exist_ok=True)
    native_decode.encode_video(str(path("small")), small_frames(), fps=30)
    path("small_fragmented").write_bytes(fragment(path("small").read_bytes()))
    native_decode.encode_video(str(path("hd720")), hd_frames(), fps=30)
    exp = {}
    with tempfile.TemporaryDirectory() as tmp:
        oracle = Oracle(tmp)
        for v in ("small", "small_fragmented", "hd720"):
            p = str(path(v))
            pk = oracle.packets(p)
            exp[f"{v}_timescale"] = np.int64(pk["timescale"])
            for k in ("pts", "dts", "flags", "size"):
                exp[f"{v}_packet_{k}"] = pk[k]
            # JAX's frames: every one (hashed as they come, for the 720p
            # video) and the kept ones
            kept = list(native_decode.decode_frames(p, fps=0.5))
            digests, frame_pts, nv12 = [], [], []
            rgb_all = native_decode.decode_frames(p, fps=0)
            for (pts, y, uv), rgb in zip(oracle.frames(p), rgb_all):
                frame_pts.append(pts)
                digests.append(hash(rgb.tobytes()))
                nv12.append((y, uv) if v != "hd720" else nv12_sha256(y, uv))
            shown = int((pk["flags"] & AV_PKT_FLAG_DISCARD == 0).sum())
            if next(rgb_all, None) is not None or len(frame_pts) != shown:
                raise AssertionError(f"{v}: {len(frame_pts)} frames from the oracle, "
                                     f"{shown} packets shown, or JAX decodes more")
            index = {d: i for i, d in enumerate(digests)}
            if len(index) != len(digests):
                raise AssertionError(f"{v}: two frames are equal")
            keep = [index[hash(f.tobytes())] for f in kept]
            if keep != sorted(keep) or len(keep) < 6:
                raise AssertionError(f"{v}: kept frames {keep}")
            exp[f"{v}_frame_pts"] = np.asarray(frame_pts, np.int64)
            exp[f"{v}_keep"] = np.asarray(keep, np.int64)
            if v == "hd720":
                exp[f"{v}_nv12_sha256"] = np.asarray([nv12[i] for i in keep])
            else:
                exp[f"{v}_nv12_sha256"] = np.asarray([nv12_sha256(*nv12[i]) for i in keep])
            if v == "small":
                exp["small_all_nv12_sha256"] = np.asarray([nv12_sha256(*f) for f in nv12])
                exp["small_nv12_y"] = np.stack([nv12[i][0] for i in keep])
                exp["small_nv12_uv"] = np.stack([nv12[i][1] for i in keep])
                exp["small_rgb"] = np.stack(kept)
            if v in ("small", "hd720"):
                dest = Path(tmp) / v
                n = video.extract_frames(p, str(dest), fps=0.5, engine="native")
                if n != len(keep):
                    raise AssertionError(f"{v}: extract_frames wrote {n}, kept {len(keep)}")
                exp[f"{v}_jpeg_sha256"] = np.asarray(
                    [file_sha256(dest / f"{i:04d}.jpg") for i in range(1, n + 1)])
        record_variants(exp, oracle, tmp)
        record_features(exp, oracle, tmp)
    if not (exp["small_fragmented_nv12_sha256"] == exp["small_nv12_sha256"]).all():
        raise AssertionError("the fragmented file decodes to other frames")
    if (exp["small_packet_flags"] & AV_PKT_FLAG_DISCARD).any():
        raise AssertionError("small.mp4 has discarded packets")
    np.savez_compressed(ROOT / "expected.npz", **exp)
    for v in ("small", "small_fragmented", "hd720"):
        print(v, path(v).stat().st_size, "bytes,", len(exp[f"{v}_frame_pts"]), "frames, kept",
              exp[f"{v}_keep"].tolist())
    print("expected.npz", (ROOT / "expected.npz").stat().st_size, "bytes")


if __name__ == "__main__":
    regenerate()
