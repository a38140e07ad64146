"""The port's small modules against the JAX package's: the synthetic
dataset (every JPEG byte for byte, the feather's columns through the
port's reader and through pandas), synthetic_batch, StepTimer's scalars,
ImageStream, the utils, and the torch forms of the morphology (bit-equal
to the numpy forms and to the JAX package's jitted forms)."""

import time

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from video_dqn_tpu import utils as jax_utils
from video_dqn_tpu.core.metrics import MetricsWriter as JaxMetricsWriter
from video_dqn_tpu.core.metrics import read_metrics as jax_read_metrics
from video_dqn_tpu.core.profiling import StepTimer as JaxStepTimer
from video_dqn_tpu.data import image_streams as jax_image_streams
from video_dqn_tpu.data.synthetic import make_synthetic_dataset as jax_make_synthetic_dataset
from video_dqn_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from video_dqn_tpu.ops import morphology as jax_morphology
from video_dqn_tpu_torch import utils
from video_dqn_tpu_torch.core.metrics import MetricsWriter, read_metrics
from video_dqn_tpu_torch.core.profiling import StepTimer, trace
from video_dqn_tpu_torch.data.feather import read_feather
from video_dqn_tpu_torch.data.image_streams import ImageStream
from video_dqn_tpu_torch.data.jpeg import load_images
from video_dqn_tpu_torch.data.qlearning import QLearningBatcher
from video_dqn_tpu_torch.data.synthetic import make_synthetic_dataset, synthetic_batch
from video_dqn_tpu_torch.ops import morphology
from tests import torch_port_util  # noqa: F401  (caps torch threads per worker)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The same synthetic dataset written by each package: (port root,
    its feather, JAX root, its feather), at the defaults and at a second
    shape and seed."""
    out = {}
    for name, kw in (("defaults", {}),
                     ("other", dict(num_videos=3, frames_per_video=10, image_size=40, seed=9,
                                    stride=2))):
        port = tmp_path_factory.mktemp(f"port_{name}")
        jax = tmp_path_factory.mktemp(f"jax_{name}")
        out[name] = (port, make_synthetic_dataset(str(port), **kw),
                     jax, jax_make_synthetic_dataset(str(jax), **kw))
    return out


@pytest.mark.parametrize("name", ["defaults", "other"])
def test_every_jpeg_is_byte_equal_to_jaxs(trees, name):
    port, _, jax, _ = trees[name]
    mine = sorted(p.relative_to(port) for p in port.rglob("*.jpg"))
    theirs = sorted(p.relative_to(jax) for p in jax.rglob("*.jpg"))
    assert mine == theirs and len(mine) > 0
    for rel in mine:
        assert (port / rel).read_bytes() == (jax / rel).read_bytes(), rel


@pytest.mark.parametrize("name", ["defaults", "other"])
def test_feather_columns_equal_through_both_readers(trees, name):
    port, port_feather, jax, jax_feather = trees[name]

    def rooted(col):
        return [p.replace(str(port), str(jax)) for p in col]

    ours, theirs = read_feather(port_feather), read_feather(jax_feather)
    pd_ours, pd_theirs = pd.read_feather(port_feather), pd.read_feather(jax_feather)
    assert list(ours) == list(theirs) == list(pd_ours.columns) == list(pd_theirs.columns)
    for key in theirs:
        a, b = (ours[key], theirs[key]) if key not in ("before_image", "after_image") else \
            (rooted(ours[key]), list(theirs[key]))
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=key)
        c = pd_ours[key].tolist()
        c = rooted(c) if key in ("before_image", "after_image") else c
        np.testing.assert_array_equal(np.asarray(c), pd_theirs[key].to_numpy(), err_msg=key)
    # the port's batcher reads the tree as it reads JAX's
    kwargs = dict(one_action=True, inverse_actions=True, image_size=32, seed=1)
    a = QLearningBatcher(port_feather, **kwargs).get_batch(np.arange(8))
    b = QLearningBatcher(jax_feather, **kwargs).get_batch(np.arange(8))
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_synthetic_batch_equals_jaxs():
    for kw in ({}, dict(batch_size=3, num_frames=4, image_size=32, num_classes=2, seed=5)):
        got, want = synthetic_batch(**kw), jax_synthetic_batch(**kw)
        assert got.keys() == want.keys()
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_step_timer_writes_jaxs_scalars(tmp_path):
    logs = {}
    for tag, timer_cls, writer in (
            ("port", StepTimer, MetricsWriter(str(tmp_path / "port"))),
            ("jax", JaxStepTimer, JaxMetricsWriter(str(tmp_path / "jax"), tensorboard=False))):
        timer = timer_cls(writer=writer, prefix="perf")
        with timer.section(step=1, tag="train", items=10):
            time.sleep(0.01)
        with timer.section(step=2, tag="eval"):
            pass
        timer.start()
        assert timer.stop(3, items=4) >= 0
        writer.flush()
        logs[tag] = timer.summary()
    got = read_metrics(str(tmp_path / "port"))
    want = jax_read_metrics(str(tmp_path / "jax"))
    assert [(r["tag"], r["step"]) for r in got] == [(r["tag"], r["step"]) for r in want]
    assert [r["tag"] for r in got] == ["perf/train_sec", "perf/train_items_per_sec",
                                       "perf/eval_sec", "perf/step_sec",
                                       "perf/step_items_per_sec"]
    assert got[0]["value"] >= 0.01 and got[1]["value"] > 0
    assert logs["port"].keys() == logs["jax"].keys() == {"train", "eval", "step"}


def test_trace_writes_a_chrome_trace(tmp_path):
    path = tmp_path / "deep" / "trace.json"
    with trace(str(path), device="cpu") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert path.exists() and path.stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())
    if not torch.cuda.is_available():  # None is the card, as at every entry point
        with pytest.raises(RuntimeError, match="device='cpu'"):
            with trace(str(tmp_path / "card.json")):
                pass


def test_image_stream_equals_jaxs(trees, monkeypatch):
    """The same rows and batches as JAX's ImageStream over the same decoder
    (the two packages' JPEG decoders differ, so JAX's reads through the
    port's here); every item equals the port's decode of its paths."""
    port, _, _, _ = trees["other"]
    paths = sorted(str(p) for p in port.rglob("*.jpg"))
    pairs = np.array(paths[:14]).reshape(7, 2)
    monkeypatch.setattr(jax_image_streams, "load_images",
                        lambda p, size: load_images(list(p), size))
    got, want = ImageStream(pairs, image_size=24), jax_image_streams.ImageStream(pairs, 24)
    assert len(got) == len(want) == 7
    for i in range(7):
        for a, b, p in zip(got[i], want[i], pairs[i], strict=True):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, load_images([p], 24)[0])
    for a, b in zip(got.batches(3), want.batches(3), strict=True):
        assert len(a) == len(b) == 2
        for x, y in zip(a, b):
            assert x.shape == y.shape and x.dtype == np.uint8
            np.testing.assert_array_equal(x, y)


def test_utils_equal_jaxs():
    rng = np.random.default_rng(0)
    for items in ([1, 3, 3, 2], [3, 1, 1, 2], list(rng.integers(0, 5, 30)), [5]):
        assert utils.argmax(items) == jax_utils.argmax(items)
        assert utils.argmin(items) == jax_utils.argmin(items)
    pairs = [(0, 5), (1, 5), (2, 4)]
    assert utils.argmax(pairs, lambda x: x[1]) == jax_utils.argmax(pairs, lambda x: x[1])
    assert utils.argmin(pairs, lambda x: x[1]) == jax_utils.argmin(pairs, lambda x: x[1])
    a = np.arange(22)
    widths = [1, 3, 4, 1, 3, 4, 1, 5]
    for x, y in zip(utils.split_columns(a, widths), jax_utils.split_columns(a, widths),
                    strict=True):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        utils.split_columns(a, [10, 10])
    for length, dat in ((5, np.ones((3, 2))), (2, np.arange(4)), (3, np.zeros((0, 2))),
                        (3, np.arange(3.0))):
        got, want = utils.pad_to(length, dat), jax_utils.pad_to(length, dat)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    assert utils.padTo is utils.pad_to
    np.testing.assert_array_equal(utils.one_hot(3, 1), jax_utils.one_hot(3, 1))
    for n in (1, 3, 7, 9):
        lst = list(range(7))
        assert utils.chunks_num(lst, n) == jax_utils.chunks_num(lst, n)
        assert list(utils.chunks(lst, n)) == list(jax_utils.chunks(lst, n))
    for x, y in ((0.1, 2 * np.pi + 0.1), (3.0, -3.0), (-1.2, 2.5)):
        assert utils.angle_delta(x, y) == jax_utils.angle_delta(x, y)
    z = [(1, "a"), (2, "b")]
    assert utils.unzip(z) == jax_utils.unzip(z)
    for x, y in zip(utils.unzip_arrays(z), jax_utils.unzip_arrays(z), strict=True):
        np.testing.assert_array_equal(x, y)
    assert utils.rand_bool(0.5, np.random.default_rng(3)) == \
        jax_utils.rand_bool(0.5, np.random.default_rng(3))
    cols = {}
    utils.multi_add(cols, np.arange(6).reshape(3, 2), "x")
    assert list(cols) == ["x0", "x1"]
    np.testing.assert_array_equal(utils.multi_get(cols, "x"), np.arange(6).reshape(3, 2))


def test_torch_morphology_equals_the_numpy_and_jax_forms():
    rng = np.random.default_rng(0)
    masks = [rng.random((h, w)) < p for h, w, p in
             ((1, 1, 0.5), (1, 7, 0.7), (9, 1, 0.7), (17, 23, 0.6), (64, 48, 0.8),
              (5, 5, 1.0), (6, 4, 0.0))]
    for m in masks:
        t = torch.from_numpy(m)
        for fn, np_fn, jax_fn in ((morphology.binary_dilation_disk1,
                                   morphology.binary_dilation_disk1_np,
                                   jax_morphology.binary_dilation_disk1),
                                  (morphology.binary_erosion_disk1,
                                   morphology.binary_erosion_disk1_np,
                                   jax_morphology.binary_erosion_disk1)):
            got = fn(t)
            assert got.dtype == torch.bool and got.shape == t.shape
            np.testing.assert_array_equal(got.numpy(), np_fn(m))
            np.testing.assert_array_equal(got.numpy(), np.asarray(jax_fn(jnp.asarray(m))))
        for n in (0, 1, 2):
            got = morphology.open_n(t, n).numpy()
            np.testing.assert_array_equal(got, morphology.open_n_np(m, n))
            np.testing.assert_array_equal(got, np.asarray(jax_morphology.open_n(jnp.asarray(m), n)))
    # a float mask, as the JAX forms take
    f = torch.from_numpy(masks[3].astype(np.float32))
    np.testing.assert_array_equal(morphology.binary_dilation_disk1(f).numpy(),
                                  morphology.binary_dilation_disk1_np(masks[3]))
