"""The port's JPEG writer (data/jpeg.py save_images over
csrc/host/jpeg_encode.cc) against PIL's `Image.save`, which writes the JAX
package's simulator frames: the same file, byte for byte, at quality 75
(PIL's default) and the other qualities a caller passes, on noise,
renders, flat images and ragged sizes whose MCUs run past the image (and
so also the same pixels when PIL decodes both); a round trip through the
port's decoder; and the writes it refuses."""

import io
import os

import numpy as np
import pytest
from PIL import Image

from video_dqn_tpu_torch.eval.fixtures import make_furnished_house
from video_dqn_tpu_torch.data.jpeg import load_images, save_images
from tests import torch_port_util  # noqa: F401  (caps torch threads per worker)
from tests import torch_qdata

# (height, width): whole MCUs, luma blocks past the right or bottom edge
# (dummy blocks), an odd width and height (chroma edge replication), one
# pixel, and a strip
SIZES = [(16, 16), (33, 47), (17, 9), (8, 24), (1, 1), (7, 300), (224, 224), (100, 3)]
QUALITIES = [75, 95, 100, 50, 10, 1]


def pil_bytes(image: np.ndarray, quality: int) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def images_of(kind: str, h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == "flat_grey":
        return np.full((h, w, 3), 128, np.uint8)
    if kind == "flat_colour":
        return np.broadcast_to(rng.integers(0, 256, 3, dtype=np.uint8), (h, w, 3)).copy()
    yy, xx = np.mgrid[0:h, 0:w]  # saturated gradients: the clamps of every stage
    return np.stack([(xx * 7) % 256, (yy * 5) % 256, ((xx + yy) * 3) % 256],
                    -1).astype(np.uint8)


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("kind", ["noise", "flat_grey", "flat_colour", "gradient"])
def test_writer_equals_pil_byte_for_byte(tmp_path, kind, quality):
    images = [images_of(kind, h, w, seed) for seed, (h, w) in enumerate(SIZES)]
    for (h, w), image in zip(SIZES, images):
        path = tmp_path / f"{h}x{w}.jpg"
        save_images([str(path)], image[None], quality=quality)
        got, want = path.read_bytes(), pil_bytes(image, quality)
        assert got == want, (kind, quality, h, w, len(got), len(want))
        # and so PIL decodes both to the same pixels
        assert np.array_equal(np.asarray(Image.open(path)),
                              np.asarray(Image.open(io.BytesIO(want))))


def test_writer_equals_pil_on_renders(tmp_path):
    """A furnished-house walk's renders, in one threaded batch."""
    env, _ = make_furnished_house(size_px=64, seed=0)
    frames = []
    for action in [0, 1, 0, 0, 2, 0, 1, 1]:
        frames.append(np.array(env.get_observation()["rgb"], np.uint8))
        env.step(action)
    frames = np.stack(frames)
    paths = [str(tmp_path / f"{i:04d}.jpg") for i in range(len(frames))]
    save_images(paths, frames)
    for path, frame in zip(paths, frames):
        assert open(path, "rb").read() == pil_bytes(frame, 75)


def test_round_trip_through_the_port_decoder(tmp_path):
    """Renders and the committed frames at 224, written and decoded by the
    port: within the decoder's bound of the frames written (mean |diff|
    under MEAN_BOUND, the JAX native stage's own bound), and equal to what
    the decoder reads from PIL's file of the same frame."""
    env, _ = make_furnished_house(size_px=224, seed=0)
    frames = [np.array(env.get_observation()["rgb"], np.uint8)]
    frames += list(load_images([str(p) for p in torch_qdata.committed_frames()[:3]], 224))
    frames = np.stack(frames)
    paths = [str(tmp_path / f"{i}.jpg") for i in range(len(frames))]
    save_images(paths, frames, quality=75)
    back = load_images(paths, 224)
    for i in range(len(frames)):
        diff = np.abs(back[i].astype(np.int16) - frames[i]).mean()
        assert diff < torch_qdata.MEAN_BOUND, (i, diff)
    pil_paths = [str(tmp_path / f"pil{i}.jpg") for i in range(len(frames))]
    for path, frame in zip(pil_paths, frames):
        Image.fromarray(frame).save(path)
    assert np.array_equal(back, load_images(pil_paths, 224))


def test_threads_write_what_one_thread_writes(tmp_path, monkeypatch):
    frames = np.random.default_rng(3).integers(0, 256, (9, 40, 56, 3), dtype=np.uint8)
    one = [str(tmp_path / f"a{i}.jpg") for i in range(9)]
    many = [str(tmp_path / f"b{i}.jpg") for i in range(9)]
    monkeypatch.setenv("VDQN_JPEG_THREADS", "1")
    save_images(one, frames)
    monkeypatch.setenv("VDQN_JPEG_THREADS", "4")
    save_images(many, list(frames))  # a sequence of frames of one size
    for a, b in zip(one, many):
        assert open(a, "rb").read() == open(b, "rb").read()


def test_bad_writes_raise(tmp_path):
    frame = np.zeros((1, 8, 8, 3), np.uint8)
    missing = tmp_path / "no_such_dir" / "0001.jpg"
    with pytest.raises(RuntimeError, match=f"{missing}.*cannot be opened"):
        save_images([str(tmp_path / "ok.jpg"), str(missing)], np.concatenate([frame, frame]))
    assert os.path.exists(tmp_path / "ok.jpg")  # the other file is written
    with pytest.raises(ValueError, match="uint8"):
        save_images([str(tmp_path / "f.jpg")], frame.astype(np.float32))
    with pytest.raises(ValueError, match=r"\(N, H, W, 3\)"):
        save_images([str(tmp_path / "g.jpg")], frame[..., :1])
    with pytest.raises(ValueError, match="2 paths for 1 frames"):
        save_images([str(tmp_path / "h.jpg"), str(tmp_path / "i.jpg")], frame)
    with pytest.raises(ValueError, match="quality"):
        save_images([str(tmp_path / "j.jpg")], frame, quality=0)
    save_images([], np.zeros((0, 8, 8, 3), np.uint8))  # nothing to write
