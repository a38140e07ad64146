"""The port's PNG writer (video_dqn_tpu_torch/data/png.py) against PIL's
decoder, its own reader, and MetricsWriter.add_image against the JAX
package's file names. Every comparison is exact."""

import os

import numpy as np
import pytest
from PIL import Image

from video_dqn_tpu.core.metrics import MetricsWriter as JaxMetricsWriter
from video_dqn_tpu_torch.core.metrics import MetricsWriter
from video_dqn_tpu_torch.data.png import encode_png, read_png, save_png

SHAPES = [(1, 1, 3), (1, 1), (7, 13, 3), (5, 9), (3, 1, 3), (1500, 1500, 3)]


@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
def test_pil_decodes_the_array_given(tmp_path, shape):
    img = np.random.default_rng(len(shape) * 100 + shape[1]).integers(0, 256, shape, np.uint8)
    path = str(tmp_path / "a.png")
    save_png(path, img)
    with Image.open(path) as f:
        assert f.mode == ("RGB" if len(shape) == 3 else "L")
        got = np.asarray(f)
    assert got.shape == img.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(read_png(path), img)


def test_pixels_equal_pils_file(tmp_path):
    """Both writers' files decode to the same pixels (the bytes differ:
    PIL picks a filter a row)."""
    img = (np.arange(40 * 31 * 3) % 251).astype(np.uint8).reshape(40, 31, 3)
    Image.fromarray(img).save(tmp_path / "pil.png")
    save_png(str(tmp_path / "port.png"), img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port.png")),
                                  np.asarray(Image.open(tmp_path / "pil.png")))


def test_refuses_what_it_cannot_write_or_read(tmp_path):
    for bad in (np.zeros((2, 2, 4), np.uint8), np.zeros((2, 2), np.float32),
                np.zeros((0, 3, 3), np.uint8), np.zeros(5, np.uint8)):
        with pytest.raises(ValueError):
            encode_png(bad)
    with pytest.raises(OSError, match="no_such_dir"):
        save_png(str(tmp_path / "no_such_dir" / "a.png"), np.zeros((2, 2), np.uint8))
    data = bytearray(encode_png(np.full((4, 4, 3), 7, np.uint8)))
    data[40] ^= 1  # inside the IDAT chunk
    (tmp_path / "bad.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        read_png(str(tmp_path / "bad.png"))
    (tmp_path / "short.png").write_bytes(bytes(data[:30]))
    with pytest.raises(ValueError, match="truncated"):
        read_png(str(tmp_path / "short.png"))
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).convert("RGBA").save(tmp_path / "rgba.png")
    with pytest.raises(ValueError, match="colour type 6"):
        read_png(str(tmp_path / "rgba.png"))


def test_add_image_writes_jaxs_file_names(tmp_path):
    img = np.random.default_rng(3).integers(0, 256, (6, 10, 3), np.uint8)
    want = JaxMetricsWriter(str(tmp_path / "jax"), tensorboard=False)
    got = MetricsWriter(str(tmp_path / "port"))
    for tag, step in (("value_map_house/bed", 20), ("plain", 0)):
        want.add_image(tag, img, step)
        path = got.add_image(tag, img, step)
        assert os.path.basename(path) == f"{tag.replace('/', '_')}_{step}.png"
    got.add_scalar("loss", 1.5, 3)
    got.flush()
    want.close()
    got.close()
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        if name.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port" / name)),
                                          np.asarray(Image.open(tmp_path / "jax" / name)))
    # a failed write raises with its path (the JAX package passes over it)
    writer = MetricsWriter(str(tmp_path / "port2"))
    os.mkdir(tmp_path / "port2" / "taken_1.png")
    with pytest.raises(OSError, match="taken_1.png"):
        writer.add_image("taken", img, 1)
    writer.close()
