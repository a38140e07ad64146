"""The port's frame filters (models/alexnet_places.py, data/filters.py)
against the JAX package's: the Places365 AlexNet carried across by
alexnet_state_dict_from_flax computes JAX's float32 logits (within 1e-4
relative), and the bridge inverts JAX's torchvision converter exactly;
the indoor classifier's probabilities within 1e-5 of JAX's, ties in the
top-10 broken as lax.top_k breaks them; the smoothers equal JAX's (scipy's
gaussian_filter1d) at every length, .5 ties included; and run_filter_pass
writes JAX's npy dicts and skips a video whose output exists. The models
run at B <= 4 and are built once per module."""

import os

import jax
import numpy as np
import pytest
import torch

from video_dqn_tpu.data import filters as jax_filters
from video_dqn_tpu.data import qlearning as jax_qlearning
from video_dqn_tpu.data.detect import StubDetector as JaxStubDetector
from video_dqn_tpu.models.alexnet_places import AlexNetPlaces365 as JaxAlexNet
from video_dqn_tpu.models.torch_convert import convert_alexnet_places
from video_dqn_tpu.ops.image import normalize_imagenet
from video_dqn_tpu_torch.data import filters
from video_dqn_tpu_torch.data.detect import StubDetector
from video_dqn_tpu_torch.data.jpeg import load_images, save_images
from video_dqn_tpu_torch.models.alexnet_places import AlexNetPlaces365, load_alexnet_places
from video_dqn_tpu_torch.models.bridge import alexnet_state_dict_from_flax
from video_dqn_tpu_torch.ops.resize_normalize import resize_normalize
from tests import torch_port_util  # noqa: F401  (caps torch threads per worker)
from tests.torch_port_util import free_passed_tmp_path  # noqa: F401  (frees a passed test's tmp_path)
from tests import torch_qdata
from tests.torch_frontend_util import (FC8, FRONT_SEED, INDOOR_BF16_ATOL, JAX_BF16_MAX_MOVE,
                                       JAX_BF16_SWAP_SHARE, bf16_against_f32,
                                       centred_alexnet_state_dict, centred_state_dict,
                                       front_batch, indoor_probabilities,
                                       seeded_alexnet_state_dict)

LOGIT_RTOL = 1e-4   # float32 logits against JAX's, relative to the largest
PROB_ATOL = 1e-5    # indoor probabilities against JAX's
MASK = filters.indoor_mask_vector()
JAX_MODEL = JaxAlexNet(dtype=np.float32)


def fixture_frames(n: int) -> np.ndarray:
    """n committed fixture frames decoded to 224 x 224."""
    return load_images([str(p) for p in torch_qdata.committed_frames()[:n]], 224)


def port_logits(model, images: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        return model(resize_normalize(torch.from_numpy(images), 224)).numpy()


def jax_classifier(params):
    return jax_filters.make_indoor_classifier(JAX_MODEL, params, MASK)


@pytest.fixture(scope="module")
def models():
    """(torchvision state dict, Flax params, port model): seeded weights
    with the indoor classes' biases shifted so that the fixture's 32
    frames centre on 0.5, carried to Flax by JAX's converter and back by
    the port's bridge."""
    seeded = AlexNetPlaces365().eval()
    seeded.load_state_dict(seeded_alexnet_state_dict(seed=0))
    sd = centred_state_dict(seeded.state_dict(), port_logits(seeded, fixture_frames(32)), MASK)
    params, _ = convert_alexnet_places({k: v.numpy() for k, v in sd.items()})
    port = AlexNetPlaces365().eval()
    port.load_state_dict(alexnet_state_dict_from_flax(params), strict=True)
    return sd, params, port


def test_bridge_inverts_the_jax_converter(models):
    sd, params, _ = models
    back = alexnet_state_dict_from_flax(params)
    assert back.keys() == sd.keys()
    for name, value in sd.items():
        assert torch.equal(back[name], value), name


def test_logits_match_jax(models):
    _, params, port = models
    images = fixture_frames(4)
    x = resize_normalize(torch.from_numpy(images), 224).permute(0, 2, 3, 1).numpy()
    want = np.asarray(JAX_MODEL.apply({"params": params}, x, False))
    got = port_logits(port, images)
    assert got.dtype == np.float32 and got.shape == (4, 365)
    assert np.abs(got - want).max() <= LOGIT_RTOL * np.abs(want).max()


def test_other_sizes_raise(models):
    _, _, port = models
    with pytest.raises(ValueError, match="224x224"):
        port(torch.zeros(1, 3, 192, 192))
    clf = filters.make_indoor_classifier(port, device="cpu")
    with pytest.raises(ValueError, match=r"\(B, 224, 224, 3\)"):
        clf(np.zeros((1, 200, 224, 3), np.uint8))


def test_indoor_probabilities_match_jax(models):
    _, params, port = models
    images = fixture_frames(4)
    want = jax_classifier(params)(images)
    got = filters.make_indoor_classifier(port, device="cpu")(images)
    assert got.dtype == np.float32 and got.shape == (4,)
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL)
    assert got.min() < 0.5 < got.max() or len(got) < 2  # the centring spreads them


JAX_MOVE_ATOL = 5e-4  # JAX's largest bf16 move against the pinned JAX_BF16_MAX_MOVE


def test_jax_bf16_moves_near_ties():
    """The JAX package's own bf16 classifier against its float32 one, on
    chip_smoke.py phase 12's weights and frames (the 64 distinct ones of
    its batches): some frame moves further than INDOOR_BF16_ATOL, each such
    frame a near tie of the 10th and 11th classes, and the rule phase 12
    holds the card to holds JAX too. Its largest move and its share of
    swapped frames, which bound the card's, are pinned here."""
    frames = fixture_frames(32)
    params, _ = convert_alexnet_places(
        {k: v.numpy() for k, v in centred_alexnet_state_dict(FRONT_SEED, frames).items()})
    images = front_batch(frames, 64)
    x = normalize_imagenet(images.astype(np.float32) / 255.0)
    l32, lbf = (np.asarray(jax.jit(lambda v, m=model: m.apply({"params": params}, v, False))(x),
                           np.float64) for model in (JAX_MODEL, JaxAlexNet()))
    out = bf16_against_f32(l32, lbf, indoor_probabilities(lbf, MASK), MASK)
    assert out["breaches"] == [], out
    assert out["beyond_frames"] > 0 and out["max_with_swaps"] > INDOOR_BF16_ATOL, out
    assert abs(out["max_with_swaps"] - JAX_BF16_MAX_MOVE) <= JAX_MOVE_ATOL, out
    assert out["swapped_frames"] == round(JAX_BF16_SWAP_SHARE * len(images)), out


def test_top10_ties_break_as_jax(models):
    """fc8 zeroed and its biases on a coarse grid: hundreds of classes tie
    in probability, and only the order among them picks the indoor mass."""
    sd, _, _ = models
    tied = dict(sd)
    tied[f"{FC8}.weight"] = torch.zeros_like(sd[f"{FC8}.weight"])
    tied[f"{FC8}.bias"] = torch.from_numpy(
        np.random.default_rng(1).integers(0, 3, 365).astype(np.float32))
    params, _ = convert_alexnet_places({k: v.numpy() for k, v in tied.items()})
    port = AlexNetPlaces365().eval()
    port.load_state_dict(tied)
    images = fixture_frames(2)
    want = jax_classifier(params)(images)
    got = filters.make_indoor_classifier(port, device="cpu")(images)
    np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL)
    # the first 10 of the top bias's classes, by index
    b = tied[f"{FC8}.bias"].numpy().astype(np.float64)
    tops = np.flatnonzero(b == b.max())
    p_top = np.exp(b.max()) / np.exp(b).sum()
    assert got[0] == pytest.approx(p_top * MASK[tops[:10]].sum(), abs=1e-6)
    assert MASK[tops[:10]].sum() != MASK[tops[-10:]].sum()  # another order would show


LENGTHS = [1, 5, 23, 30, 200]


def series(n: int, kind: str, rng) -> np.ndarray:
    if kind == "uniform":
        return rng.random(n)
    if kind == "halves":  # exact .5 ties after smoothing a constant 0.5
        return np.full(n, 0.5)
    return rng.integers(0, 3, n) / 2  # 0, .5 and 1: ties inside and at the edges


@pytest.mark.parametrize("n", LENGTHS)
def test_smoothers_match_jax(n):
    rng = np.random.default_rng(n)
    for kind in ("uniform", "halves", "grid"):
        values = series(n, kind, rng)
        want = jax_filters.gaussian_smooth_round(values)
        got = filters.gaussian_smooth_round(values)
        assert got.dtype == want.dtype and np.array_equal(got, want), (n, kind)
        flags = (rng.random(n) < 0.4).astype(np.int64)
        for window in (6, 4):
            want = jax_filters.smooth_binary_inplace(flags, window)
            got = filters.smooth_binary_inplace(flags, window)
            assert got.dtype == want.dtype and np.array_equal(got, want), (n, kind, window)
        want = jax_filters.filter_frames(values, flags)
        got = filters.filter_frames(values, flags)
        for key in ("indoor_locs", "person_locs"):
            assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key])


def test_gaussian_filter_is_scipys():
    """The numpy gaussian_filter1d against scipy's, bit for bit, where the
    series is shorter than the radius (24) and reflects more than once."""
    from scipy.ndimage import gaussian_filter1d

    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 24, 25, 49, 50, 97):
        for sigma in (6.0, 1.5):
            values = rng.random(n)
            assert np.array_equal(filters.gaussian_filter1d(values, sigma),
                                  gaussian_filter1d(values, sigma)), (n, sigma)


def test_tables_match_jax():
    assert filters.load_io_map() == jax_filters.load_io_map()
    assert filters.load_categories() == jax_filters.load_categories()
    assert np.array_equal(MASK, jax_filters.indoor_mask_vector())
    assert filters.PERSON_CLASS == jax_filters.PERSON_CLASS
    for labels in ([1, 2, 3], [5, 4, 3, 2, 6, 1], [], np.array([62, 1])):
        assert filters.person_in_top5(labels) == jax_filters.person_in_top5(labels)


class PersonEvery:
    """Labels with 'person' (1) among the first 5 where the frame's pixel sum is 0 mod
    3: a person detector whose flags vary along a video."""

    def __call__(self, images):
        return [np.array([62, 1] if int(im.astype(np.int64).sum()) % 3 == 0 else [62, 63, 64])
                for im in images]


@pytest.fixture(scope="module")
def frames_root(models, tmp_path_factory):
    """Three videos of 30, 5 and 23 frames at 224 x 224 from the committed
    fixture: runs of 12 frames the seeded model scores indoor, then 12 it
    scores outdoor, so that the smoothed probability crosses 0.5."""
    _, _, port = models
    root = tmp_path_factory.mktemp("filter_frames")
    images = fixture_frames(32)
    ranked = images[np.argsort(filters.make_indoor_classifier(port, device="cpu")(images))]
    high, low = ranked[16:], ranked[:16]
    rng = np.random.default_rng(0)
    for v, n in enumerate((30, 5, 23)):
        folder = root / f"vid{v:03d}"
        folder.mkdir()
        video = np.stack([(low if (i // 12) % 2 else high)[rng.integers(16)] for i in range(n)])
        save_images([str(folder / f"{i + 1:04d}.jpg") for i in range(n)], video)
    (root / "not_a_video.txt").write_text("skipped")
    return root


@pytest.mark.parametrize("person", ["stub", "person_every"])
def test_run_filter_pass_matches_jax(models, frames_root, tmp_path, monkeypatch, person):
    """Each package's pass with its own scorer and detector. The stub
    detector hashes the pixels and the two decoders differ by a mean
    |difference| under 3 (tests/test_torch_jpeg.py), so the JAX pass reads
    the frames through the port's decoder here."""
    _, params, port = models
    monkeypatch.setattr(jax_qlearning, "load_images", load_images)
    detectors = {"stub": (JaxStubDetector(), StubDetector()),
                 "person_every": (PersonEvery(), PersonEvery())}[person]

    def labels_of(detector):
        if isinstance(detector, PersonEvery):
            return detector
        return lambda images: [d["classes"][np.argsort(-d["scores"])] for d in detector(images)]

    want = jax_filters.run_filter_pass(str(frames_root), str(tmp_path / "jax"),
                                       jax_classifier(params), labels_of(detectors[0]),
                                       batch_size=4)
    scorer = filters.make_indoor_classifier(port, device="cpu")
    got = filters.run_filter_pass(str(frames_root), str(tmp_path / "port"), scorer,
                                  labels_of(detectors[1]), batch_size=4)
    assert sorted(got) == sorted(want) == ["vid000", "vid001", "vid002"]
    indoor = person_flags = 0
    for vid in want:
        a = np.load(want[vid], allow_pickle=True)[()]
        b = np.load(got[vid], allow_pickle=True)[()]
        assert a.keys() == b.keys() == {"indoor_locs", "person_locs"}
        for key in a:
            assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), (vid, key)
        indoor += len(b["indoor_locs"])
        person_flags += len(b["person_locs"])
    assert 0 < indoor < 58  # some frames in, some out
    if person == "person_every":
        assert 0 < person_flags < 58

    # resume: a video whose output exists is skipped
    os.remove(got["vid001"])
    stamp = os.stat(got["vid000"]).st_mtime_ns
    again = filters.run_filter_pass(str(frames_root), str(tmp_path / "port"), scorer,
                                    labels_of(detectors[1]), batch_size=4)
    assert list(again) == ["vid001"]
    assert os.stat(got["vid000"]).st_mtime_ns == stamp


def test_load_alexnet_places_forms(models, tmp_path):
    """A state dict, the reference's snapshot and the Places365 release's
    DataParallel form load strictly; a wrong name raises."""
    sd, _, port = models
    forms = {"plain.pth": sd, "snapshot.torch": {"model_state_dict": sd},
             "release.pth.tar": {"epoch": 90, "arch": "alexnet",
                                 "state_dict": {f"module.{k}": v for k, v in sd.items()}}}
    for name, blob in forms.items():
        torch.save(blob, tmp_path / name)
        model = load_alexnet_places(str(tmp_path / name), device="cpu")
        assert not model.training
        for k, v in model.state_dict().items():
            assert torch.equal(v, sd[k]), (name, k)
    torch.save({**sd, "classifier.7.weight": sd[f"{FC8}.weight"]}, tmp_path / "bad.pth")
    with pytest.raises(RuntimeError, match="classifier.7"):
        load_alexnet_places(str(tmp_path / "bad.pth"), device="cpu")
