"""Frame extraction on the card: the NV12 -> RGB kernel against its plain
twin (exact: integer arithmetic) on the committed fixture frames, one at a
time and as one batch, on pitched 1080p planes, on seeded batches of 16
frames at 1280x720, 1920x1080 and 854x480, on widths whose last columns
take the kernel's scalar path, and on planes that do not start on 16
bytes (the wrapper copies them first); small.mp4's RGB equal to the JAX package's frames, the host
decoder's frames on this machine equal to libavcodec's, and the -d CLI
writing the JAX package's JPEG files with one kernel launch a batch of up
to 16 kept frames. The scaled kernel (csrc/nv12_scale_rgb.cu, swscale's
bilinear scaler) against its twin, exact too, on seeded batches of 16 at
1280x720 to the Q-net's 224x224 and to other targets, from YouTube's
854-wide 480p, on the odd-width path, on 0/255 planes, and
decode_frames(target=) launching it once a kept frame.

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
from video_dqn_tpu_torch.data import video
from video_dqn_tpu_torch.ops import nv12, nv12_scale
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
def test_kernel_on_the_fixture_frames_as_one_batch():
    y = torch.from_numpy(EXP["small_nv12_y"]).cuda()
    uv = torch.from_numpy(EXP["small_nv12_uv"]).cuda()
    nv12.LAUNCHES.clear()
    got = nv12.nv12_to_rgb(y, uv)
    torch.cuda.synchronize()
    assert nv12.LAUNCHES["nv12_rgb"] == 1
    assert torch.equal(got, nv12.nv12_to_rgb_reference(y, uv))
    np.testing.assert_array_equal(got.cpu().numpy(), EXP["small_rgb"])


def seeded_planes(shape, seed=0, offset=0):
    """Seeded (N, H, W) luma and (N, H/2, W) chroma on the card, each
    starting `offset` bytes into its allocation."""
    n, h, w = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    planes = []
    for rows in (h, h // 2):
        flat = torch.randint(0, 256, (offset + n * rows * w,), dtype=torch.uint8, device="cuda",
                             generator=g)
        planes.append(flat[offset:].view(n, rows, w))
    return planes


# the main path's batch at 720p, YouTube's 1080p and 480p (854 wide: rows
# off 16 bytes, the flat path), and widths whose last 2 or 6 columns of a
# batch fall to the scalar path
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 720, 1280), (16, 1080, 1920), (16, 480, 854),
                                   (1, 2, 18), (3, 6, 18), (1, 2, 22)],
                         ids=["16x720p", "16x1080p", "16x480p", "1x2x18", "3x6x18", "1x2x22"])
def test_kernel_equals_twin_on_batches(shape):
    y, uv = seeded_planes(shape)
    nv12.LAUNCHES.clear()
    got = nv12.nv12_to_rgb(y, uv)
    torch.cuda.synchronize()
    assert nv12.LAUNCHES["nv12_rgb"] == 1
    assert got.shape == shape + (3,) and torch.equal(got, nv12.nv12_to_rgb_reference(y, uv))


# planes that start off 16 bytes: the wrapper copies them to 16 bytes first
@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 8])
@pytest.mark.parametrize("shape", [(2, 8, 32), (1, 6, 18)], ids=["2x8x32", "1x6x18"])
def test_kernel_equals_twin_off_16_bytes(shape, offset):
    y, uv = seeded_planes(shape, seed=offset, offset=offset)
    assert y.data_ptr() % 16 and uv.data_ptr() % 16
    got = nv12.nv12_to_rgb(y, uv)
    torch.cuda.synchronize()
    assert torch.equal(got, nv12.nv12_to_rgb_reference(y, uv))


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
    # one launch a batch of up to 16 kept frames: small.mp4 keeps 6
    assert nv12.LAUNCHES["nv12_rgb"] == -(-len(EXP["small_keep"]) // 16) == 1
    files = sorted((frames / "small").iterdir())
    assert [vfix.file_sha256(f) for f in files] == EXP["small_jpeg_sha256"].tolist()
    with contextlib.redirect_stdout(io.StringIO()):
        assert extract_frames.main(["-d", "--location", str(videos), "--frames", str(frames)]) == []


# (frames, H, W) -> (w, h): the Q-net's input and others from 720p, a
# source width off 16 (854), an upscale, the odd-width path (full-width
# chroma) and one luma tap (yuv2packed1)
SCALES = [((16, 720, 1280), (224, 224)), ((16, 720, 1280), (342, 256)),
          ((16, 720, 1280), (223, 167)), ((1, 720, 1280), (224, 224)),
          ((4, 480, 854), (224, 224)), ((3, 120, 160), (320, 240)), ((3, 120, 160), (63, 47)),
          ((3, 120, 160), (161, 121)), ((2, 64, 96), (97, 64)), ((2, 64, 96), (96, 63))]


@pytest.mark.cuda
@pytest.mark.parametrize("shape, target", SCALES,
                         ids=["{}x{}x{}-{}x{}".format(*s, *t) for s, t in SCALES])
def test_scale_kernel_equals_twin(shape, target):
    n, h, w = shape
    tables = nv12_scale.scale_tables(w, h, *target)
    for y, uv in (seeded_planes(shape), [p // 128 * 255 for p in seeded_planes(shape, seed=1)]):
        nv12_scale.LAUNCHES.clear()
        got = nv12_scale.nv12_scale_rgb(y, uv, tables)
        torch.cuda.synchronize()
        assert nv12_scale.LAUNCHES["nv12_scale_rgb"] == 1
        assert got.shape == (n, target[1], target[0], 3)
        assert torch.equal(got, nv12_scale.nv12_scale_rgb_reference(y, uv, tables))


@pytest.mark.cuda
@pytest.mark.parametrize("target", [(80, 60), (63, 47)])
def test_decode_frames_resizes_on_the_card(target):
    """One scaled launch a kept frame, each frame the twin of its committed
    planes; the native size launches the NV12 kernel instead."""
    tables = nv12_scale.scale_tables(160, 120, *target)
    nv12.LAUNCHES.clear()
    nv12_scale.LAUNCHES.clear()
    frames = list(video.decode_frames(str(vfix.path("small")), target=target))
    assert len(frames) == len(EXP["small_keep"])
    assert nv12_scale.LAUNCHES["nv12_scale_rgb"] == len(frames) and not nv12.LAUNCHES
    for k, frame in enumerate(frames):
        want = nv12_scale.nv12_scale_rgb_reference(torch.from_numpy(EXP["small_nv12_y"][k]),
                                                   torch.from_numpy(EXP["small_nv12_uv"][k]),
                                                   tables)
        np.testing.assert_array_equal(frame, want.numpy())
    nv12_scale.LAUNCHES.clear()
    native = list(video.decode_frames(str(vfix.path("small")), target=(160, 120)))
    assert nv12.LAUNCHES["nv12_rgb"] == len(native) and not nv12_scale.LAUNCHES
    np.testing.assert_array_equal(np.stack(native), EXP["small_rgb"])
