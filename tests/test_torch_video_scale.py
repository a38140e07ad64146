"""decode_frames(target=) of the port (video_dqn_tpu_torch/data/video.py,
ops/nv12_scale.py) on the CPU: swscale's scaled bilinear path, byte for
byte.

  * The twin against libswscale itself (a C helper built against it here),
    on seeded random, smooth and extreme planes at the fixture's targets
    and at shapes that take each output function: libswscale with its SIMD
    on and with it off (av_force_cpu_flags(0)) gives the same bytes at
    every one of them, and the twin gives those bytes, so no tolerance is
    needed anywhere.
  * The filter tables against the sizes swscale reports for the same
    context (SWS_PRINT_INFO), and the odd-width path against its notice.
  * decode_frames(..., target=, device="cpu") against the JAX package's
    native_decode.decode_frames(..., target=) (libavcodec and libswscale)
    on the committed clips: small.mp4 at six targets and hd720.mp4 at two,
    every frame equal.
  * The native size as a target converts as with no target (swscale's
    unscaled path, ops/nv12.py); the wrapper's batch form and its checks;
    the targets swscale reaches in two stages are refused.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from video_dqn_tpu.data import native_decode
from video_dqn_tpu_torch.data import video
from video_dqn_tpu_torch.ops.nv12_scale import (ScaleTables, nv12_scale_rgb,
                                                 nv12_scale_rgb_reference, scale_tables)
from tests import torch_port_util  # noqa: F401  (caps torch threads per worker)
from tests.torch_video_fixture import path
from tests.torch_video_util import build_helper

SWS_C = r"""
#include <libswscale/swscale.h>
#include <libavutil/cpu.h>
#include <libavutil/log.h>
#include <stdarg.h>
#include <stdio.h>

static char said[1 << 16];
static int said_len;

static void keep(void* avcl, int level, const char* fmt, va_list vl) {
  if (level <= AV_LOG_DEBUG && said_len < (int)sizeof(said))
    said_len += vsnprintf(said + said_len, sizeof(said) - said_len, fmt, vl);
}

const char* sws_said(void) { return said; }

/* yuv420p planes (W, W/2 and W/2 bytes a row) -> w x h RGB24, as the JAX
   package's decoder asks for it; simd 0 turns libswscale's SIMD off; log 1
   keeps what the context reports (SWS_PRINT_INFO) in sws_said() */
int sws_rgb(const uint8_t* y, const uint8_t* u, const uint8_t* v, int W, int H, uint8_t* out,
            int w, int h, int simd, int log) {
  av_force_cpu_flags(simd ? -1 : 0);
  said_len = 0;
  said[0] = 0;
  if (log) {
    av_log_set_level(AV_LOG_DEBUG);
    av_log_set_callback(keep);
  }
  struct SwsContext* c = sws_getContext(W, H, AV_PIX_FMT_YUV420P, w, h, AV_PIX_FMT_RGB24,
                                        SWS_BILINEAR | (log ? SWS_PRINT_INFO : 0), 0, 0, 0);
  int rc = -1;
  if (c) {
    const uint8_t* src[4] = {y, u, v, 0};
    int src_stride[4] = {W, W / 2, W / 2, 0};
    uint8_t* dst[4] = {out, 0, 0, 0};
    int dst_stride[4] = {3 * w, 0, 0, 0};
    rc = sws_scale(c, src, src_stride, 0, H, dst, dst_stride) == h ? 0 : -2;
    sws_freeContext(c);
  }
  av_log_set_callback(av_log_default_callback);
  av_log_set_level(AV_LOG_INFO);
  av_force_cpu_flags(-1);
  return rc;
}
"""

# (W, H, w, h): the fixture's targets, YouTube's 480p width, and shapes
# that take yuv2packed1 (one luma tap), yuv2packed2 (two taps each) and the
# odd-width path with each
SHAPES = [(160, 120, 64, 48), (160, 120, 80, 60), (160, 120, 320, 240), (160, 120, 63, 47),
          (160, 120, 161, 121), (1280, 720, 224, 224), (1280, 720, 342, 256),
          (1280, 720, 223, 167), (854, 480, 224, 224), (160, 120, 160, 240),
          (160, 120, 80, 120), (96, 64, 97, 64), (96, 64, 96, 63), (64, 48, 31, 200)]


@pytest.fixture(scope="module")
def sws(tmp_path_factory):
    lib = build_helper(str(tmp_path_factory.mktemp("sws")), "sws", SWS_C,
                       ["libswscale", "libavutil"])
    lib.sws_rgb.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] + \
        [ctypes.c_int] * 4
    lib.sws_said.restype = ctypes.c_char_p

    def run(y, u, v, w, h, simd=True, log=False):
        out = np.zeros((h, w, 3), np.uint8)
        rc = lib.sws_rgb(y.ctypes.data, u.ctypes.data, v.ctypes.data, y.shape[1], y.shape[0],
                         out.ctypes.data, w, h, int(simd), int(log))
        assert rc == 0, rc
        return out, lib.sws_said().decode()

    return run


def seeded_planes(W, H, kind, seed=0):
    """yuv420p planes: uniform noise, smooth ramps, or only 0 and 255 (the
    clipping and, on the odd-width path, the 32-bit wrap of yuv2rgb_write_full)."""
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return [rng.integers(0, 256, s, dtype=np.uint8)
                for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    if kind == "extreme":
        return [rng.choice(np.array([0, 255], np.uint8), s)
                for s in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    yy, xx = np.mgrid[0:H, 0:W]
    cy, cx = np.mgrid[0:H // 2, 0:W // 2]
    return [((3 * xx + 2 * yy) % 256).astype(np.uint8), ((5 * cx) % 256).astype(np.uint8),
            ((7 * cy + cx) % 256).astype(np.uint8)]


def nv12(y, u, v):
    uv = np.empty((u.shape[0], 2 * u.shape[1]), np.uint8)
    uv[:, 0::2], uv[:, 1::2] = u, v
    return torch.from_numpy(y), torch.from_numpy(uv)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "{}x{}-{}x{}".format(*s))
def test_twin_equals_libswscale(sws, shape):
    W, H, w, h = shape
    tables = scale_tables(W, H, w, h)
    for kind in ("noise", "smooth", "extreme"):
        planes = seeded_planes(W, H, kind)
        simd, _ = sws(*planes, w, h)
        plain, _ = sws(*planes, w, h, simd=False)
        np.testing.assert_array_equal(simd, plain, err_msg=f"libswscale SIMD vs C, {kind}")
        got = nv12_scale_rgb_reference(*nv12(*planes), tables).numpy()
        np.testing.assert_array_equal(got, simd, err_msg=kind)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "{}x{}-{}x{}".format(*s))
def test_tables_have_swscale_filter_sizes(sws, shape):
    """swscale reports each filter's size as it aligns it, in the order
    luma and chroma horizontal, luma and chroma vertical, and that it
    forces full-width chroma for an odd output width."""
    W, H, w, h = shape
    _, said = sws(*seeded_planes(W, H, "noise"), w, h, log=True)
    sizes = tuple(int(m) for m in re.findall(r"reducing / aligning filtersize \d+ -> (\d+)",
                                             said))
    tables = scale_tables(W, H, w, h)
    assert sizes == tables.sizes, said
    assert ("Forcing full internal H chroma due to odd output size" in said) == tables.full


JAX_TARGETS = [("small", (64, 48)), ("small", (80, 60)), ("small", (320, 240)),
               ("small", (63, 47)), ("small", (161, 121)), ("small", (160, 120)),
               ("small", (0, 60)), ("hd720", (224, 224)), ("hd720", (342, 256))]


@pytest.mark.parametrize("name,target", JAX_TARGETS,
                         ids=[f"{n}-{t[0]}x{t[1]}" for n, t in JAX_TARGETS])
def test_decode_frames_equals_jax(name, target):
    want = list(native_decode.decode_frames(str(path(name)), fps=0.5, target=target))
    got = list(video.decode_frames(str(path(name)), fps=0.5, target=target, device="cpu"))
    assert len(got) == len(want) > 0
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == np.uint8
        np.testing.assert_array_equal(g, w, err_msg=f"frame {k}")


def test_native_target_is_the_unscaled_path():
    frames = list(video.decode_frames(str(path("small")), fps=0.5, device="cpu"))
    for target in ((160, 120), (0, 0), (160, 0)):
        got = list(video.decode_frames(str(path("small")), fps=0.5, target=target,
                                       device="cpu"))
        assert len(got) == len(frames)
        for g, f in zip(got, frames):
            np.testing.assert_array_equal(g, f)


def test_batch_is_its_frames():
    tables = scale_tables(160, 120, 63, 47)
    y = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (3, 120, 160), np.uint8))
    uv = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (3, 60, 160), np.uint8))
    batch = nv12_scale_rgb(y, uv, tables)
    assert batch.shape == (3, 47, 63, 3)
    for k in range(3):
        torch.testing.assert_close(batch[k], nv12_scale_rgb(y[k], uv[k], tables), rtol=0, atol=0)


def test_wrapper_checks():
    tables = scale_tables(160, 120, 80, 60)
    y = torch.zeros((120, 160), dtype=torch.uint8)
    uv = torch.zeros((60, 160), dtype=torch.uint8)
    with pytest.raises(ValueError, match="tables for 160x120"):
        nv12_scale_rgb(y[:, :96], uv[:, :96], tables)
    with pytest.raises(ValueError, match="does not fit"):
        nv12_scale_rgb(y, uv[:30], tables)
    with pytest.raises(TypeError, match="uint8"):
        nv12_scale_rgb(y.float(), uv, tables)
    with pytest.raises(ValueError, match="planes on meta"):
        nv12_scale_rgb(y.to("meta"), uv.to("meta"), tables)
    with pytest.raises(ValueError, match="even sizes"):
        ScaleTables(161, 120, 80, 60)
    with pytest.raises(ValueError, match="unscaled path"):
        ScaleTables(160, 120, 160, 120)


@pytest.mark.parametrize("shape", [(390, 12, 1, 11), (288, 34, 2, 32), (160, 600, 80, 2)],
                         ids=lambda s: "{}x{}-{}x{}".format(*s))
def test_refuses_what_swscale_cascades(sws, shape):
    """A filter of 256 taps or more (a downscale of over 128 times on an
    axis) makes swscale scale in two stages, through a yuv420p image, whose
    bytes the one-stage twin does not give (a sweep of 25,506 random shapes
    differed at 18, all of them such): the port raises there."""
    W, H, w, h = shape
    _, said = sws(*seeded_planes(W, H, "noise"), w, h, log=True)
    assert "from yuv420p to yuv420p" in said, said
    with pytest.raises(ValueError, match="cascades"):
        ScaleTables(W, H, w, h)
