"""The port's visualisation (video_dqn_tpu_torch/viz) against the JAX
package's video_dqn_tpu/viz on the same inputs: the colormap tables and
render_value_map byte for byte, crop_range and to_grid exactly, the grid
reader's cells, value maps and the all-class scorer within 1e-4 (float32
on the CPU, the same decoded pixels on both sides), the map figures, the
panorama strip and its captions exactly (against the committed golden
and JAX's cv2 text), vis_panorama's correlations within 1e-9 and its
figure's numbers and labels where they belong, and render_grid's JPEG
files byte for byte."""

import math
import os

import matplotlib
import numpy as np
import pytest

from video_dqn_tpu.data import qlearning as jax_qlearning
from video_dqn_tpu.sim.fake_env import FakeNavEnv as JaxFakeNavEnv
from video_dqn_tpu.viz import panorama as jax_panorama
from video_dqn_tpu.viz.render_grid import render_grid as jax_render_grid
from video_dqn_tpu.viz import value_map as jax_value_map
from video_dqn_tpu_torch.data.jpeg import load_images
from video_dqn_tpu_torch.data.png import read_png
from video_dqn_tpu_torch.sim.fake_env import FakeNavEnv
from video_dqn_tpu_torch.viz import colormaps, panorama, value_map
from video_dqn_tpu_torch.viz.text import put_text, text_width
from video_dqn_tpu_torch.viz.render_grid import render_grid
from tests import torch_port_util
from tests.torch_qdata import MEAN_BOUND

ATOL = 1e-4        # float32 forwards of the two packages on the same pixels
CORR_ATOL = 1e-9   # correlations of the same float64 values and distances
SIZE = 64          # the basic net's grid views
GOLDEN = os.path.join(os.path.dirname(__file__), "data", "join_images_golden.npz")


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """The JAX package's native raycaster, never its fallback."""
    torch_port_util.jax_native_libs()


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """A 6 x 6 grid of the seeded fake env at SIZE px, written by the JAX
    package (PIL's JPEGs)."""
    out = str(tmp_path_factory.mktemp("grid") / "house")
    jax_render_grid(JaxFakeNavEnv(image_size=SIZE, seed=3), out, resolution=6)
    return out


@pytest.fixture
def shared_pixels(monkeypatch):
    """The JAX grid reader decodes with the port's JPEG stage, so that both
    packages score the same pixels (the two decoders differ)."""
    monkeypatch.setattr(jax_qlearning, "_load_image",
                        lambda path, size: load_images([path], size)[0])


@pytest.mark.parametrize("name,table", [("viridis", colormaps.VIRIDIS),
                                        ("Wistia", colormaps.WISTIA)])
def test_colormaps_equal_matplotlibs(name, table):
    cmap = matplotlib.colormaps[name]
    np.testing.assert_array_equal(table, cmap(np.arange(256))[:, :3])
    x = np.concatenate([np.linspace(-0.2, 1.2, 4001), [0.0, 1.0, 1 / 256, 255 / 256,
                                                       np.nextafter(1.0, 0.0), np.nan]])
    for dtype in (np.float64, np.float32):
        np.testing.assert_array_equal(colormaps.apply(table, x.astype(dtype)),
                                      cmap(x.astype(dtype))[:, :3])
    values = np.random.default_rng(1).standard_normal(300).astype(np.float32)
    for lo, hi in ((-1.5, 2.0), (0.25, 0.25)):
        want = matplotlib.colors.Normalize(vmin=lo, vmax=hi)(values)
        np.testing.assert_array_equal(colormaps.normalize(values, lo, hi), want)


def value_map_case(case):
    rng = np.random.default_rng(7)
    vm = rng.standard_normal((12, 15)) - 0.5
    free = np.zeros((12, 15))
    free[2:9, 3:13] = 1
    free[5, 3:6] = 0
    marks, crop = [(2, 3), (8, 12), (0, 0), (-1, 4), (12, 3), (5, 20)], True
    if case == "constant":
        vm = np.full((12, 15), 0.37)
    elif case == "empty_free":
        free[:] = 0
    elif case == "no_crop":
        crop = False
    elif case == "float32":
        vm = vm.astype(np.float32)
    elif case == "no_marks":
        marks = None
    return vm, free, marks, crop


@pytest.mark.parametrize("case", ["negative", "constant", "empty_free", "no_crop",
                                  "float32", "no_marks"])
def test_render_value_map_is_byte_equal(case):
    vm, free, marks, crop = value_map_case(case)
    want = jax_value_map.render_value_map(vm, free, marks, crop=crop)
    got = value_map.render_value_map(vm, free, marks, crop=crop)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_crop_range_and_to_grid_equal_jaxs():
    free = np.zeros((9, 11))
    assert value_map.crop_range(free) == jax_value_map.crop_range(free)
    free[3:5, 2:9] = 1
    free[7, 10] = 1
    assert value_map.crop_range(free) == jax_value_map.crop_range(free) == ((3, 8), (2, 11))
    for point in ([0.0, 0.0, 0.0], [-30.0, 1.0, 40.0], [12.3, 0.0, -7.7], [24.99, 0, -25]):
        for res in (6, 64, 1500):
            assert value_map.to_grid(point, res) == jax_value_map.to_grid(point, res)


def test_join_images_equals_the_golden_strip():
    g = np.load(GOLDEN)
    np.testing.assert_array_equal(panorama.join_images(list(g["ims"])), g["plain"])
    ims = list(g["ims"][:5])
    np.testing.assert_array_equal(panorama.join_images(ims), jax_panorama.join_images(ims))


def test_captions_raise_naming_item_8b():
    """The captions that raised NotImplementedError naming item 8b until
    it was ported now draw what JAX draws."""
    ims = list(np.load(GOLDEN)["ims"])
    np.testing.assert_array_equal(panorama.join_images(ims, np.arange(12.0)),
                                  jax_panorama.join_images(ims, np.arange(12.0)))
    envs = FakeNavEnv(image_size=32, seed=3), JaxFakeNavEnv(image_size=32, seed=3)
    got, _ = panorama.panorama_strip(envs[0], scorer=lambda views: np.zeros(len(views)))
    want, _ = jax_panorama.panorama_strip(envs[1], scorer=lambda views: np.zeros(len(views)))
    np.testing.assert_array_equal(got, want)


def test_join_images_with_values_equals_the_golden_and_jaxs():
    g = np.load(GOLDEN)
    np.testing.assert_array_equal(
        panorama.join_images(list(g["ims"]), g["vals"], br_text="bed", bl_text="step 7"),
        g["annotated"])
    rng = np.random.default_rng(5)
    for n, (h, w) in ((12, (96, 128)), (12, (224, 224)), (5, (40, 300)), (4, (30, 64))):
        ims = [rng.integers(0, 256, (h, w, 3), np.uint8) for _ in range(n)]
        # negative values, values wider than their crop, one that runs
        # off its tile, NaN and inf
        values = np.concatenate([rng.normal(0, 10 ** rng.uniform(0, 6), n - 2), [-np.inf, np.nan]])
        for br, bl in (("", ""), ("Object Class: Dining Table", "Predicted Values"),
                       ("a much longer label than the strip is wide, on purpose", "x")):
            got = panorama.join_images(ims, values, br_text=br, bl_text=bl)
            want = jax_panorama.join_images(ims, values, br_text=br, bl_text=bl)
            np.testing.assert_array_equal(got, want, err_msg=f"{n} {h}x{w} {br!r}")


def test_panorama_strip_equals_jaxs():
    envs = FakeNavEnv(image_size=40, seed=2), JaxFakeNavEnv(image_size=40, seed=2)
    for env in envs:
        env.reset(reachable=False)
    got, scores = panorama.panorama_strip(envs[0], num_rotations=12)
    want, _ = jax_panorama.panorama_strip(envs[1], num_rotations=12)
    assert scores is None
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(envs[0].agent_state()[0], envs[1].agent_state()[0])


def test_panorama_strip_with_a_scorer_equals_jaxs():
    envs = FakeNavEnv(image_size=64, seed=2), JaxFakeNavEnv(image_size=64, seed=2)
    for env in envs:
        env.reset(reachable=False)

    def scorer(views):
        return views.reshape(len(views), -1).mean(axis=1) / 255.0 - 0.5

    got, scores = panorama.panorama_strip(envs[0], scorer=scorer, num_rotations=12)
    want, jax_scores = jax_panorama.panorama_strip(envs[1], scorer=scorer, num_rotations=12)
    np.testing.assert_array_equal(scores, jax_scores)
    assert got.shape == want.shape and got.shape[0] == 64 + panorama.CAPTION_H
    np.testing.assert_array_equal(got, want)


def test_grid_reader_finds_jaxs_cells(grid):
    got, want = value_map.VisualizationGrid(grid, SIZE), jax_value_map.VisualizationGrid(grid, SIZE)
    assert got.cells == want.cells and len(got) == len(want) > 4
    r, c = got.cells[len(got) // 2]
    cell = got.load_cell(r, c)
    assert cell.shape == (4, SIZE, SIZE, 3) and cell.dtype == np.uint8
    # the port's decoder against PIL's (JAX's reader), the bound data/jpeg.py is held to
    diff = np.abs(cell.astype(np.int16) - want.load_cell(r, c)).mean(axis=(1, 2, 3))
    assert diff.max() < MEAN_BOUND
    rows, cols, images = next(got.batches(3))
    assert images.shape == (3, 4, SIZE, SIZE, 3)
    np.testing.assert_array_equal(images[1], got.load_cell(rows[1], cols[1]))


@pytest.mark.parametrize("pano", [False, True], ids=["single_frame", "panorama"])
def test_value_maps_match_jax(grid, shared_pixels, pano):
    jm, params, stats, pm = torch_port_util.qnet_pair(extra_capacity=False, panorama=pano,
                                                      image_size=SIZE, seed=2)
    want = jax_value_map.build_value_maps(jm, params, stats, grid, pano, resolution=6,
                                          image_size=SIZE)
    got = value_map.build_value_maps(pm, grid, pano, resolution=6, image_size=SIZE,
                                     batch_size=5, device="cpu")
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got[1], np.stack(got[0]).max(0))
    np.testing.assert_array_equal(got[2], want[2])
    assert got[2].sum() == len(value_map.VisualizationGrid(grid))
    # orientations differ (the net sees other views), so the max is not one of them
    assert not np.array_equal(got[0][0], got[0][1])


def test_orientation_views_roll_as_jax():
    images = np.arange(2 * 4).reshape(2, 4, 1, 1, 1).repeat(3, axis=-1).astype(np.uint8)
    views = value_map.orientation_views(images, panorama=True)
    for ori in range(4):
        want = np.concatenate([images[:, ori:], images[:, :ori]], axis=1)
        np.testing.assert_array_equal(views[ori * 2:(ori + 1) * 2], want)
    single = value_map.orientation_views(images, panorama=False)
    for ori in range(4):
        np.testing.assert_array_equal(single[ori * 2:(ori + 1) * 2], images[:, ori:ori + 1])


@pytest.fixture(scope="module")
def nets96():
    return torch_port_util.qnet_pair(extra_capacity=False, panorama=False, image_size=96,
                                     seed=6)


@pytest.mark.parametrize("side", [96, 128], ids=["identity", "resized"])
def test_allclass_scorer_matches_jax(nets96, side):
    jm, params, stats, pm = nets96
    views = np.random.default_rng(side).integers(0, 256, (6, side, side, 3), np.uint8)
    want = jax_panorama.make_allclass_scorer(jm, params, stats, image_size=96)(views)
    scorer = panorama.make_allclass_scorer(pm, image_size=96, device="cpu")
    got = scorer(views)
    assert got.shape == (6, 5) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(scorer(views[:, None]), got)  # (V, F, H, W, 3) too


class House:
    object_locations_for_habitat_dest = {
        label: np.array([[1.0 + i, 0.0, -2.0 * i], [20.0, 0.0, 3.0], [-4.0, 2.5, 1.0]])
        for i, label in enumerate(["bed", "chair", "couch", "dining table", "toilet"])}


def test_map_figures_equal_jaxs(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    maps = [rng.standard_normal((40, 40, 5)) for _ in range(4)]
    free = (rng.random((40, 40)) < 0.3).astype(float)
    agg = np.stack(maps).max(0)
    for module in (value_map, jax_value_map):
        monkeypatch.setattr(module, "build_value_maps", lambda *a, **k: (maps, agg, free))
    np.save(tmp_path / "info.npy", {"agent_location": np.array([1.0, 0.0, 2.0]),
                                    "map_resolution": 40}, allow_pickle=True)
    want = jax_value_map.build_map_figures(None, None, None, House(), 0, str(tmp_path), False,
                                           resolution=40)
    got = value_map.build_map_figures(None, House(), 0, str(tmp_path), False, resolution=40)
    assert list(got) == list(want) and len(got) == 25
    for key in want:
        assert got[key].tobytes() == want[key].tobytes()
        assert got[key].shape == want[key].shape


def probe(env, goals_by_class, n=12, steps=4):
    """Each heading's drop in geodesic distance after `steps` forward
    steps, replayed apart from vis_panorama, and the heading's view."""
    pos, rot = env.agent_state()
    base = panorama.min_dists(env, goals_by_class, pos)
    drops, views = [], []
    for k in range(n):
        env.set_agent_state(pos, rot + 2 * math.pi * k / n)
        views.append(env.get_observation()["rgb"])
        for _ in range(steps):
            env.step(0)
        drops.append(base - panorama.min_dists(env, goals_by_class))
        env.set_agent_state(pos, rot)
    return np.stack(drops), views


def test_vis_panorama_correlations_match_jax(tmp_path):
    envs = FakeNavEnv(image_size=48, seed=3), JaxFakeNavEnv(image_size=48, seed=3)
    goals = []
    for env in envs:
        env.reset(reachable=False)
        goals.append([[env.sample_reachable_goal()] for _ in range(5)])
    np.testing.assert_array_equal(np.array(goals[0]), np.array(goals[1]))
    env, jenv = envs
    pos, rot = env.agent_state()
    expected, views = probe(env, goals[0])
    assert expected.std(axis=0).min() > 0, "the probe saw no distance change"

    out = str(tmp_path / "corr.png")
    for scorer, sign in ((lambda v: 2.0 * expected + 7.0, 1.0), (lambda v: -expected, -1.0)):
        figure, corrs = panorama.vis_panorama(env, scorer, goals[0], num=12, out_path=out,
                                              class_names=list("abcde"), probe_steps=4)
        _, want = jax_panorama.vis_panorama(jenv, scorer, goals[1], num=12, probe_steps=4)
        np.testing.assert_allclose(corrs, want, rtol=0, atol=CORR_ATOL)
        np.testing.assert_allclose(corrs, sign * np.ones(5), rtol=0, atol=CORR_ATOL)
        p2, r2 = env.agent_state()
        np.testing.assert_array_equal(p2, pos)
        assert r2 == rot
    strip = panorama.join_images(views)
    row_h = round(48 * panorama.ROW_RATIO / panorama.STRIP_RATIO)
    margin = figure.shape[1] - strip.shape[1]
    labels = [f"{name} r={c:.2f}" for name, c in zip("abcde", corrs)]
    assert margin == max(map(text_width, labels)) + 2 * panorama.LABEL_PAD
    assert figure.dtype == np.uint8 and figure.shape == (48 + 5 * row_h, margin + strip.shape[1], 3)
    np.testing.assert_array_equal(figure[:48, margin:], strip)
    assert (figure[:48, :margin] == 255).all()
    np.testing.assert_array_equal(read_png(out), figure)
    # each class row runs over Wistia's whole range, reversed like the strip
    # (the figure is the last call's, of the values -expected), where the
    # cell's number leaves the cell's colour
    cell = strip.shape[1] // 12
    wistia = (colormaps.WISTIA * 255).astype(np.uint8)
    for c in range(5):
        values = -expected[::-1, c]
        for i, want in ((np.argmin(values), wistia[0]), (np.argmax(values), wistia[-1])):
            band = figure[48 + c * row_h:48 + (c + 1) * row_h,
                          margin + i * cell:margin + (i + 1) * cell]
            number = put_text(np.full_like(band, 255), f"{values[i]:.2f}",
                              ((cell - text_width(f"{values[i]:.2f}")) // 2,
                               (row_h + panorama.DIGIT_H) // 2))
            blank = (number == 255).all(axis=-1)
            assert blank.any()
            np.testing.assert_array_equal(band[blank], np.broadcast_to(want, band[blank].shape))

    # a class with no goals gets NaN, not an error
    _, part = panorama.vis_panorama(env, lambda v: expected[:, :2], [goals[0][0], []], num=12,
                                    probe_steps=4)
    _, jpart = jax_panorama.vis_panorama(jenv, lambda v: expected[:, :2], [goals[1][0], []],
                                         num=12, probe_steps=4)
    assert np.isclose(part[0], 1.0) and np.isnan(part[1]) and np.isnan(jpart[1])
    assert abs(part[0] - jpart[0]) <= CORR_ATOL


def test_vis_panorama_numbers_land_in_their_cells():
    """At 224 px each cell holds its value's "%.2f", centred, drawn over
    the cell's Wistia colour (and nothing of it outside the cell), and the
    left margin each class's label, right-aligned on its row: `name r=`
    where the correlation is finite, the name alone where it is NaN."""
    env = FakeNavEnv(image_size=224, seed=3)
    env.reset(reachable=False)
    goals = [[env.sample_reachable_goal()] for _ in range(4)] + [[]]
    rng = np.random.default_rng(1)
    values = rng.normal(0, 3, (12, 5))
    names = ["bed", "chair", "couch", "dining table", ""]
    figure, corrs = panorama.vis_panorama(env, lambda v: values, goals, num=12,
                                          class_names=names, probe_steps=4)
    assert np.isnan(corrs[4]) and np.isfinite(corrs[:4]).all()
    strip_h = 224
    row_h = round(strip_h * panorama.ROW_RATIO / panorama.STRIP_RATIO)
    labels = [f"{n} r={c:.2f}" for n, c in zip(names[:4], corrs[:4])] + [""]
    margin = max(map(text_width, labels)) + 2 * panorama.LABEL_PAD
    cell = (figure.shape[1] - margin) // 12
    rows = values[::-1].T
    wistia = (colormaps.WISTIA * 255).astype(np.uint8)
    for c in range(5):
        top = strip_h + c * row_h
        normed = colormaps.normalize(rows[c], rows[c].min(), rows[c].max())
        colours = (colormaps.apply(colormaps.WISTIA, normed) * 255).astype(np.uint8)
        for i, v in enumerate(rows[c]):
            band = figure[top:top + row_h, margin + i * cell:margin + (i + 1) * cell]
            s = f"{v:.2f}"
            number = put_text(np.full_like(band, 255), s,
                              ((cell - text_width(s)) // 2, (row_h + panorama.DIGIT_H) // 2))
            ink = (number < 255).any(axis=-1)
            assert ink.sum() > 20, (c, i)  # the whole number fits its cell
            cols = np.flatnonzero(ink.any(axis=0))
            assert abs((cols[0] + cols[-1]) / 2 - (cell - 1) / 2) <= 2  # centred
            want = (colours[i].astype(np.uint32) * number + 127) // 255
            np.testing.assert_array_equal(band, want.astype(np.uint8))
        assert np.isin(colours, wistia).all()
        label = figure[top:top + row_h, :margin]
        want = put_text(np.full_like(label, 255), labels[c],
                        (margin - panorama.LABEL_PAD - text_width(labels[c]),
                         (row_h + panorama.DIGIT_H) // 2))
        np.testing.assert_array_equal(label, want)
        if labels[c]:
            ink_cols = np.flatnonzero((label < 255).any(axis=(0, 2)))
            assert ink_cols[-1] < margin - panorama.LABEL_PAD + 1  # right-aligned
    assert labels[3].startswith("dining table r=") and labels[4] == ""


def test_render_grid_writes_jaxs_files(tmp_path):
    envs = FakeNavEnv(image_size=48, seed=3), JaxFakeNavEnv(image_size=48, seed=3)
    counts = [render_grid(envs[0], str(tmp_path / "port"), resolution=6,
                                      agent_location=[1.0, 0.0, 2.0]),
              jax_render_grid(envs[1], str(tmp_path / "jax"), resolution=6,
                                          agent_location=[1.0, 0.0, 2.0])]
    assert counts[0] == counts[1] > 4
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert len(names) == 4 * counts[0] + 1
    for name in names:
        if name.endswith(".jpg"):
            assert (tmp_path / "port" / name).read_bytes() == \
                (tmp_path / "jax" / name).read_bytes(), name
    got, want = (np.load(tmp_path / tag / "info.npy", allow_pickle=True).item()
                 for tag in ("port", "jax"))
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got.pop("agent_location"), want.pop("agent_location"))
    assert got == want
