"""Frame extraction on the card: the NV12 -> RGB kernel against its plain
twin (exact: integer arithmetic) on the committed fixture frames and on
pitched 1080p planes, small.mp4's RGB equal to the JAX package's frames,
the host decoder's frames on this machine equal to libavcodec's, and the
-d CLI writing the JAX package's JPEG files with one kernel launch a kept
frame.

Marked `cuda`: without a CUDA device each test skips. This file imports
neither jax nor the JAX package, so it also runs where only the port is
installed:

    python -m pytest --noconftest -q tests/test_torch_cuda_video.py
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from video_dqn_tpu_torch import extract_frames
from video_dqn_tpu_torch.data.h264 import decoded_frames
from video_dqn_tpu_torch.data.mp4 import Mp4Video
from video_dqn_tpu_torch.ops import nv12
# pytest puts tests/ on the path; `from tests import` could find another
# installed `tests` package on the card's machine
import torch_port_util  # noqa: F401  (caps torch threads per worker)
import torch_video_fixture as vfix

EXP = vfix.expected()


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the NV12 -> RGB kernel has no CPU mode")


@pytest.mark.cuda
def test_kernel_equals_twin_and_jax_on_the_fixture_frames():
    for k in range(len(EXP["small_keep"])):
        y = torch.from_numpy(EXP["small_nv12_y"][k]).cuda()
        uv = torch.from_numpy(EXP["small_nv12_uv"][k]).cuda()
        got = nv12.nv12_to_rgb(y, uv)
        assert torch.equal(got, nv12.nv12_to_rgb_reference(y, uv))
        np.testing.assert_array_equal(got.cpu().numpy(), EXP["small_rgb"][k])


@pytest.mark.cuda
@pytest.mark.parametrize("h, w", [(1080, 1920), (720, 1280), (6, 10)])
def test_kernel_equals_twin_on_pitched_planes(h, w):
    g = torch.Generator(device="cuda").manual_seed(0)
    y = torch.randint(0, 256, (h, w + 32), dtype=torch.uint8, device="cuda", generator=g)[:, :w]
    uv = torch.randint(0, 256, (h // 2, w + 32), dtype=torch.uint8, device="cuda", generator=g)[:, :w]
    nv12.LAUNCHES.clear()
    got = nv12.nv12_to_rgb(y, uv)
    torch.cuda.synchronize()
    assert nv12.LAUNCHES["nv12_rgb"] == 1
    assert got.shape == (h, w, 3) and torch.equal(got, nv12.nv12_to_rgb_reference(y, uv))


@pytest.mark.cuda
def test_host_decoder_on_this_machine_equals_libavcodec():
    with Mp4Video(vfix.path("small")) as video:
        got = [vfix.nv12_sha256(*f.nv12()) for _, f in decoded_frames(video)]
    assert got == EXP["small_all_nv12_sha256"].tolist()


@pytest.mark.cuda
def test_dump_cli_on_the_card(tmp_path):
    videos, frames = tmp_path / "videos", tmp_path / "frames"
    videos.mkdir()
    (videos / "small.mp4").symlink_to(vfix.path("small"))
    nv12.LAUNCHES.clear()
    with contextlib.redirect_stdout(io.StringIO()):
        assert extract_frames.main(["-d", "--location", str(videos), "--frames", str(frames)]) == ["small"]
    assert nv12.LAUNCHES["nv12_rgb"] == len(EXP["small_keep"])
    files = sorted((frames / "small").iterdir())
    assert [vfix.file_sha256(f) for f in files] == EXP["small_jpeg_sha256"].tolist()
    with contextlib.redirect_stdout(io.StringIO()):
        assert extract_frames.main(["-d", "--location", str(videos), "--frames", str(frames)]) == []
