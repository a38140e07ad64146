"""The port's frame extraction on the CPU (the host library's demuxer and
decoder, the NV12 -> RGB twin) against the JAX package's native engine
(video_dqn_tpu/data/video.py, native_decode.py): the sampler keeps the
frames JAX's decode_frames(fps=0.5) returns; the twin equals JAX's frames
and swscale itself; the CPU seam, fed the committed NV12 planes, and the
whole path write the bytes JAX's extract_frames writes; decode_frames
gives JAX's frames, from the plain and the fragmented file alike; the
--dump CLI and extract_all_frames resume; and device=None needs the card
(tests/test_torch_cuda_video.py runs the kernel there)."""

import ctypes
import ctypes.util
import os

import numpy as np
import pytest
import torch

from video_dqn_tpu.data import native_decode
from video_dqn_tpu.data import video as jax_video
from video_dqn_tpu_torch import extract_frames as cli
from video_dqn_tpu_torch.data import video
from video_dqn_tpu_torch.data.mp4 import Mp4Video
from video_dqn_tpu_torch.ops.nv12 import nv12_to_rgb, nv12_to_rgb_reference
from tests import torch_port_util  # noqa: F401  (caps torch threads per worker)
from tests.torch_video_fixture import display_seconds, expected, feature_path, file_sha256, path

EXP = expected()


def kept(times, fps=0.5) -> list:
    sampler = video.FrameSampler(fps)
    return [i for i, t in enumerate(times) if sampler.keep(t)]


@pytest.mark.parametrize("name", ["small", "small_fragmented", "hd720"])
def test_sampler_keeps_the_frames_jax_keeps(name):
    # the oracle's display times, and the demuxer's own
    assert kept(display_seconds(EXP, name)) == EXP[f"{name}_keep"].tolist()
    with Mp4Video(path(name)) as m:
        assert kept(m.seconds(m.pts[m.display_order()])) == EXP[f"{name}_keep"].tolist()


def test_jax_keeps_those_frames_live():
    every = list(native_decode.decode_frames(str(path("small")), fps=0))
    index = {f.tobytes(): i for i, f in enumerate(every)}
    got = [index[f.tobytes()] for f in native_decode.decode_frames(str(path("small")), fps=0.5)]
    assert got == EXP["small_keep"].tolist()


def test_sampler_rule_at_its_edges():
    # a frame just inside the slack is kept; a gap moves the next sample past it
    assert kept([0.0, 0.9, 2.0 - 5e-10, 2.1, 3.99, 4.0]) == [0, 2, 5]
    assert kept([0.0, 1.0, 7.0, 7.5, 8.0 - 2e-9, 8.0]) == [0, 2, 5]
    assert kept([0.0, 0.1, 0.2], fps=0) == [0, 1, 2]
    assert kept([0.5, 1.0, 2.5]) == [0, 2]


def planes(k: int):
    return torch.from_numpy(EXP["small_nv12_y"][k]), torch.from_numpy(EXP["small_nv12_uv"][k])


def test_twin_equals_jax_frames():
    for k in range(len(EXP["small_keep"])):
        np.testing.assert_array_equal(nv12_to_rgb(*planes(k)).numpy(), EXP["small_rgb"][k])


def test_twin_takes_pitched_planes():
    y, uv = planes(0)
    wide_y = torch.zeros((120, 192), dtype=torch.uint8)
    wide_uv = torch.zeros((60, 192), dtype=torch.uint8)
    wide_y[:, :160], wide_uv[:, :160] = y, uv
    np.testing.assert_array_equal(nv12_to_rgb(wide_y[:, :160], wide_uv[:, :160]).numpy(),
                                  EXP["small_rgb"][0])
    with pytest.raises(ValueError, match="even"):
        nv12_to_rgb(y[:119], uv)


def swscale_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """What decode.cc's emit asks of swscale: yuv420p -> RGB24 at the same
    size, SWS_BILINEAR, a tight RGB stride."""
    lib = ctypes.CDLL(ctypes.util.find_library("swscale"))
    lib.sws_getContext.restype = ctypes.c_void_p
    lib.sws_getContext.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3
    lib.sws_scale.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    lib.sws_freeContext.argtypes = [ctypes.c_void_p]
    h, w = y.shape
    ctx = lib.sws_getContext(w, h, 0, w, h, 2, 2, None, None, None)  # yuv420p, rgb24, bilinear
    out = np.zeros((h, w, 3), np.uint8)
    src = (ctypes.c_void_p * 4)(y.ctypes.data, u.ctypes.data, v.ctypes.data, None)
    src_stride = (ctypes.c_int * 4)(w, w // 2, w // 2, 0)
    dst = (ctypes.c_void_p * 4)(out.ctypes.data, None, None, None)
    dst_stride = (ctypes.c_int * 4)(3 * w, 0, 0, 0)
    lib.sws_scale(ctx, src, src_stride, 0, h, dst, dst_stride)
    lib.sws_freeContext(ctx)
    return out


def test_twin_equals_swscale_on_every_chroma_pair():
    # 1024 x 512 pixels: each of the 65,536 (U, V) pairs on two 2x2 blocks,
    # seeded luma
    rng = np.random.default_rng(0)
    h, w = 512, 1024
    uv_pairs = np.arange(65536).reshape(256, 256)
    u = np.ascontiguousarray(np.tile(uv_pairs // 256, (1, 2)).astype(np.uint8))
    v = np.ascontiguousarray(np.tile(uv_pairs % 256, (1, 2)).astype(np.uint8))
    y = rng.integers(0, 256, (h, w), np.uint8)
    nv12_uv = np.stack([u, v], -1).reshape(h // 2, w)
    got = nv12_to_rgb_reference(torch.from_numpy(y), torch.from_numpy(nv12_uv)).numpy()
    np.testing.assert_array_equal(got, swscale_rgb(y, u, v))


class Unread:
    """A frame the sampler must skip: reading its planes fails the test."""
    width, height = 160, 120

    def nv12(self, y, uv):
        raise AssertionError("a frame the sampler skips was converted")


def seam_frames(name: str) -> list:
    """small.mp4's display-order frames as the decoder would hand them:
    the kept ones with their committed NV12 planes."""
    keep = {int(i): k for k, i in enumerate(EXP[f"{name}_keep"])}
    return [(t, video.Nv12Frame(EXP["small_nv12_y"][keep[i]], EXP["small_nv12_uv"][keep[i]])
             if i in keep else Unread())
            for i, t in enumerate(display_seconds(EXP, name))]


def test_cpu_seam_writes_the_jax_jpeg_bytes(tmp_path):
    timings = {}
    n = video.write_frames(seam_frames("small"), str(tmp_path / "port"), 0.5, "cpu", timings)
    jax_video.extract_frames(str(path("small")), str(tmp_path / "jax"), fps=0.5,
                             engine="native")
    names = sorted(os.listdir(tmp_path / "jax"))
    assert n == 6 and sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert [file_sha256(tmp_path / "port" / f) for f in names] == EXP["small_jpeg_sha256"].tolist()
    assert set(timings) == {"convert", "write"}


def test_the_whole_path_writes_the_jax_jpeg_bytes(tmp_path):
    timings = {}
    n = video.extract_frames(str(path("small")), str(tmp_path / "port"), 0.5, "cpu", timings)
    names = [f"{i:04d}.jpg" for i in range(1, n + 1)]
    assert n == 6 and sorted(os.listdir(tmp_path / "port")) == names
    assert [file_sha256(tmp_path / "port" / f) for f in names] == EXP["small_jpeg_sha256"].tolist()
    assert set(timings) == {"demux", "decode", "convert", "write"}


@pytest.mark.parametrize("name", ["small", "small_fragmented"])
def test_decode_frames_gives_jax_frames(name):
    every = list(video.decode_frames(str(path(name)), fps=0, device="cpu"))
    want = list(native_decode.decode_frames(str(path("small")), fps=0))
    assert len(every) == len(want) == 360
    for got, ref in zip(every, want):
        np.testing.assert_array_equal(got, ref)
    kept = list(video.decode_frames(str(path(name)), fps=0.5, device="cpu"))
    np.testing.assert_array_equal(np.stack(kept), EXP["small_rgb"])


def test_dump_cli_and_extract_all_frames_resume(tmp_path, capsys):
    videos, frames = tmp_path / "videos", tmp_path / "frames"
    videos.mkdir()
    for name in ("b", "a"):
        (videos / f"{name}.mp4").write_bytes(path("small").read_bytes())
    (videos / "notes.txt").write_text("not a video")
    assert cli.main(["-d", "--location", str(videos), "--frames", str(frames)],
                    device="cpu") == ["a", "b"]
    assert "extracted 2 videos" in capsys.readouterr().out
    for vid in ("a", "b"):
        names = sorted(os.listdir(frames / vid))
        assert [file_sha256(frames / vid / f) for f in names] == EXP["small_jpeg_sha256"].tolist()
    stamps = {p: p.stat().st_mtime_ns for p in frames.rglob("*.jpg")}
    (videos / "c.mp4").write_bytes(path("small_fragmented").read_bytes())
    assert video.extract_all_frames(str(videos), str(frames), device="cpu") == ["c"]
    assert cli.main(["-d", "--location", str(videos), "--frames", str(frames)], device="cpu") == []
    assert {p: p.stat().st_mtime_ns for p in frames.rglob("*.jpg") if p.parent.name != "c"} == stamps


def test_a_failed_video_leaves_no_frame_folder(tmp_path):
    # the CAVLC clip is refused after its frame folder was made; the resume
    # must take it again, not skip an empty folder
    videos, frames = tmp_path / "videos", tmp_path / "frames"
    videos.mkdir()
    (videos / "a.mp4").write_bytes(path("small").read_bytes())
    (videos / "b.mp4").write_bytes(feature_path("cavlc").read_bytes())
    with pytest.raises(NotImplementedError, match="CAVLC"):
        video.extract_all_frames(str(videos), str(frames), device="cpu")
    assert sorted(os.listdir(frames)) == ["a"]
    (videos / "b.mp4").write_bytes(path("small").read_bytes())
    assert video.extract_all_frames(str(videos), str(frames), device="cpu") == ["b"]
    assert len(os.listdir(frames / "b")) == len(EXP["small_keep"])


@pytest.mark.parametrize("entry", [
    lambda: video.decode_frames(str(path("small"))),
    lambda: video.extract_frames(str(path("small")), "unused"),
    lambda: video.extract_all_frames(str(path("small").parent), "unused"),
    lambda: cli.main(["-d", "--location", str(path("small").parent), "--frames", "unused"]),
], ids=["decode_frames", "extract_frames", "extract_all_frames", "cli_dump"])
def test_the_card_is_the_default(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
    assert not os.path.exists("unused")


def test_decode_frames_resize_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 9"):
        video.decode_frames(str(path("small")), target=(80, 60), device="cpu")
