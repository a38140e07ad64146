"""The port's JPEG stage (data/jpeg.py over csrc/host/jpeg_decode.cc)
against the JAX package's PIL loader `_load_image` and its native stage:
mean |difference| under 3.0, the native stage's own bound
(tests/test_pipeline.py test_jpeg_batch_native_matches_pil_oracle), on
every kind of file the training frames come as; and the files it refuses."""

from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from video_dqn_tpu.data import native_decode
from video_dqn_tpu.data.qlearning import _load_image
from video_dqn_tpu_torch.data.jpeg import load_images
from tests import torch_port_util  # noqa: F401  (caps torch threads per worker)
from tests import torch_qdata

ROOT = Path(__file__).resolve().parents[1]
MEAN_BOUND = torch_qdata.MEAN_BOUND
# (width, height, save options): the frame kinds of a video frame dump
KINDS = {
    "landscape": (342, 256, {}),
    "portrait": (256, 342, {}),
    "tiny_upscale": (80, 60, {}),
    "720p_scaled": (1280, 720, {}),
    "1080p_scaled": (1920, 1080, {}),
    "444": (640, 360, {"subsampling": 0}),
    "422": (640, 360, {"subsampling": 1}),
    "grayscale": (640, 360, {"gray": True}),
    "restart_markers": (640, 360, {"restart_marker_rows": 1}),
    "optimized_huffman": (1280, 720, {"optimize": True}),
    "odd_size": (517, 333, {"restart_marker_blocks": 5}),
}


def smooth(width, height, seed):
    """Smooth colour gradients with mild noise, like tests/test_pipeline.py's."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    g = 128 + 80 * np.sin(xx / 37.0 + seed) + 40 * np.cos(yy / 23.0 + 2 * seed)
    g = (g + rng.normal(0, 4, (height, width))).clip(0, 255).astype(np.uint8)
    return np.stack([g, np.roll(g, 3, 0), np.roll(g, 7, 1)], axis=2)


def write(path, width, height, options, seed=0):
    options = dict(options)
    img = smooth(width, height, seed)
    Image.fromarray(img[..., 0] if options.pop("gray", False) else img).save(
        path, quality=90, **options)
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("jpeg")
    return {kind: write(d / f"{kind}.jpg", w, h, opts, seed=i)
            for i, (kind, (w, h, opts)) in enumerate(KINDS.items())}


@pytest.mark.parametrize("size", [96, 224])
@pytest.mark.parametrize("kind", list(KINDS))
def test_decode_matches_pil(files, kind, size):
    got = load_images([files[kind]], size)
    want = _load_image(files[kind], size)
    assert got.shape == (1, size, size, 3) and got.dtype == np.uint8
    diff = np.abs(got[0].astype(np.int16) - want.astype(np.int16))
    assert diff.mean() < MEAN_BOUND, (kind, size, diff.mean(), diff.max())


def test_decode_matches_the_native_stage(files):
    if not native_decode.available():
        pytest.skip("the JAX package's native decode library is not built here")
    paths = list(files.values())
    native, failed = native_decode.jpeg_batch(paths, 96)
    assert failed == []
    diff = np.abs(load_images(paths, 96).astype(np.int16) - native.astype(np.int16))
    assert diff.mean() < MEAN_BOUND, diff.mean()


def test_fixture_frames_match_the_committed_oracle(monkeypatch):
    monkeypatch.chdir(ROOT)  # the fixture's paths are relative to the repo root
    result = torch_qdata.check_oracle()  # raises where the port and the oracle differ
    assert result["frames"] == 32 and result["frame_mean_abs_diff_max"] < MEAN_BOUND


def test_threads_do_not_change_the_output(files, monkeypatch):
    paths = list(files.values()) * 3
    monkeypatch.setenv("VDQN_JPEG_THREADS", "1")
    one = load_images(paths, 64)
    for threads in ("0", "4"):  # 0: every hardware thread
        monkeypatch.setenv("VDQN_JPEG_THREADS", threads)
        assert np.array_equal(load_images(paths, 64), one)
    assert load_images([], 64).shape == (0, 64, 64, 3)


def test_refuses_what_it_cannot_decode_naming_the_file(files, tmp_path):
    img = Image.open(files["720p_scaled"])
    img.save(tmp_path / "progressive.jpg", quality=90, progressive=True)
    img.convert("CMYK").save(tmp_path / "cmyk.jpg", quality=90)
    raw = Path(files["720p_scaled"]).read_bytes()
    (tmp_path / "truncated.jpg").write_bytes(raw[:len(raw) // 2])
    (tmp_path / "not_a_jpeg.jpg").write_bytes(b"GIF89a")
    for name, reason in (("progressive", "progressive"), ("cmyk", "CMYK"),
                         ("truncated", "truncated"), ("not_a_jpeg", "not a JPEG"),
                         ("missing", "cannot be read")):
        path = str(tmp_path / f"{name}.jpg")
        with pytest.raises(RuntimeError, match=f"{path} .*{reason}"):
            load_images([files["landscape"], path], 64)
