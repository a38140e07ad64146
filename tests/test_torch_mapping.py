"""The port's mapping ops against the JAX package's on the same seeded
inputs: camera geometry, the panorama's map delta, the morphology of the
traversible grid and the FMM solver."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_dqn_tpu.ops import binning as jax_binning
from video_dqn_tpu.ops import fmm as jax_fmm
from video_dqn_tpu.ops import geometry as jax_geometry
from video_dqn_tpu.ops import morphology as jax_morphology
from video_dqn_tpu_torch.ops import binning, fmm, geometry, morphology
from tests import torch_port_util  # caps torch threads per worker

GEOMETRY_ATOL = 1e-3   # cm, at depths up to 1,000 cm
ROTATION_ATOL = 1e-6
CELL_SHARE = 1e-4      # valid points allowed in another cell (expected 0)
MAP, Z_BINS, RES, HEIGHT = 461, (20.0, 125.0), 5.0, 125.0


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """The JAX package's native FMM and raycaster, never its fallbacks."""
    torch_port_util.jax_native_libs()


def depth_batch(seed, views=12, size=48):
    """Seeded depths in cm with zeros, > 990 cm, NaN and out-of-map values,
    cleaned as the mapper cleans them (> 990 and 0 become NaN)."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.0, 1000.0, (views, size, size)).astype(np.float32)
    d[rng.random(d.shape) < 0.05] = 0.0
    d[rng.random(d.shape) < 0.05] = 995.0
    d[rng.random(d.shape) < 0.05] = np.nan
    d[d > 990] = np.nan
    d[d == 0] = np.nan
    # poses near the map's edge, so that many points fall off the map
    locs = np.stack([rng.uniform(0.0, MAP * RES, views), rng.uniform(0.0, MAP * RES, views),
                     rng.uniform(-7.0, 7.0, views)], axis=1).astype(np.float32)
    return d, locs


@pytest.mark.parametrize("elevation", [0.0, -12.5])
def test_point_cloud_geocentric_and_pose_match_jax(elevation):
    d, locs = depth_batch(0, views=3)
    d = np.nan_to_num(d)
    cam = jax_geometry.get_camera_matrix(48, 48, 90)
    assert geometry.get_camera_matrix(48, 48, 90) == tuple(cam)
    want = jax_geometry.get_point_cloud_from_z(jnp.asarray(d), cam)
    got = geometry.get_point_cloud_from_z(torch.from_numpy(d), cam)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=GEOMETRY_ATOL)
    want = jax_geometry.make_geocentric(want, HEIGHT, elevation)
    got = geometry.make_geocentric(got, HEIGHT, elevation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=GEOMETRY_ATOL)
    for v in range(3):
        w = jax_geometry.transform_to_frame(want[v], jnp.asarray(locs[v]))
        g = geometry.transform_to_frame(got[v], torch.from_numpy(locs[v]))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=GEOMETRY_ATOL)
    # one call for every view's pose, as the map delta makes it
    both = geometry.transform_to_frame(got, torch.from_numpy(locs))
    np.testing.assert_allclose(both[2].numpy(), np.asarray(w), rtol=0, atol=GEOMETRY_ATOL)


@pytest.mark.parametrize("axis", [(1.0, 0.0, 0.0), (0.0, 0.0, 1.0), (1.0, 2.0, -0.5)])
def test_rodrigues_matches_jax(axis):
    angles = np.array([0.0, 1e-8, 0.3, -2.0, np.pi, 7.5], np.float32)
    got = geometry.rodrigues(axis, torch.from_numpy(angles)).numpy()
    assert got.shape == (6, 3, 3) and got.dtype == np.float32
    for a, g in zip(angles, got):
        want = np.asarray(jax_geometry.rodrigues(jnp.asarray(axis), jnp.float32(a)))
        np.testing.assert_allclose(g, want, rtol=0, atol=ROTATION_ATOL)


def cells_apart(got: np.ndarray, want: np.ndarray) -> int:
    """Points binned into another cell: half the summed count difference."""
    return int(np.abs(got - want).sum() // 2)


@pytest.mark.parametrize("seed", [0, 1])
def test_bin_points_matches_jax(seed):
    d, locs = depth_batch(seed, views=2)
    cam = jax_geometry.get_camera_matrix(48, 48, 90)
    # the camera at the map's left edge: points left of it fall off
    xyz = jax_geometry.get_point_cloud_from_z(jnp.asarray(d), cam)
    want = np.asarray(jax_binning.bin_points(xyz, MAP, Z_BINS, RES))
    got = binning.bin_points(torch.from_numpy(np.array(xyz)), MAP, Z_BINS, RES).numpy()
    valid = int(want.sum())
    assert got.dtype == np.float32 and got.shape == (MAP, MAP, 3)
    assert 0 < valid < np.isfinite(d).sum()  # some points fall off the map
    assert got.sum() == valid
    apart = cells_apart(got, want)
    print(f"bin_points: {apart} of {valid} valid points in another cell")
    assert apart <= CELL_SHARE * valid


@pytest.mark.parametrize("seed,elevation", [(2, 0.0), (3, 0.0), (4, 10.0)])
def test_panorama_map_delta_matches_jax(seed, elevation):
    d, locs = depth_batch(seed)
    cam = jax_geometry.get_camera_matrix(48, 48, 90)
    want = np.asarray(jax_binning.observations_to_map_delta(
        jnp.asarray(d), jnp.asarray(locs), cam, MAP, HEIGHT, Z_BINS, RES, elevation))
    got = binning.observations_to_map_delta(
        torch.from_numpy(d), torch.from_numpy(locs), cam, MAP, HEIGHT, Z_BINS, RES,
        elevation).numpy()
    valid = int(want.sum())
    assert 0 < valid < np.isfinite(d).sum()
    assert got.sum() == valid
    apart = cells_apart(got, want)
    print(f"map delta: {apart} of {valid} valid points in another cell")
    assert apart <= CELL_SHARE * valid


@pytest.mark.parametrize("n", [0, 1, 2, 3])
def test_morphology_matches_jax(n):
    rng = np.random.default_rng(n)
    mask = rng.random((37, 53)) < 0.7
    for name in ("binary_dilation_disk1_np", "binary_erosion_disk1_np"):
        np.testing.assert_array_equal(getattr(morphology, name)(mask),
                                      getattr(jax_morphology, name)(mask))
    np.testing.assert_array_equal(morphology.open_n_np(mask, n),
                                  jax_morphology.open_n_np(mask, n))
    # the numpy forms compute the jitted forms' function
    np.testing.assert_array_equal(morphology.open_n_np(mask, n),
                                  np.asarray(jax_morphology.open_n(jnp.asarray(mask), n)))


def fmm_grid(seed, shape=(61, 47)):
    rng = np.random.default_rng(seed)
    trav = rng.random(shape) < 0.8
    walls = np.argwhere(~trav)
    goals = [tuple(walls[0]), tuple(walls[1])]          # goals on obstacles
    free = np.argwhere(trav)
    goals += [tuple(free[len(free) // 2])]
    return trav, goals, tuple(free[len(free) // 3])


@pytest.mark.parametrize("bounded", ["none", "early_stop", "max_dist", "both"])
@pytest.mark.parametrize("seed", [0, 1])
def test_fmm_is_bit_equal_to_jax_native(seed, bounded):
    trav, goals, agent = fmm_grid(seed)
    kw = {"none": {}, "early_stop": {"early_stop": agent, "margin": 6.0},
          "max_dist": {"max_dist": 9.5},
          "both": {"early_stop": agent, "margin": 3.0, "max_dist": 30.0}}[bounded]
    before = trav.copy()
    for g in (goals[:1], goals):
        want = jax_fmm.fmm_distance(trav, g, engine="native", **kw)
        got = fmm.fmm_distance(trav, g, **kw)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(trav, before)  # the goal flips are undone
        assert np.isfinite(got).any() and np.isinf(got).any()
        # the oracle computes the same field
        np.testing.assert_allclose(fmm.fmm_distance(trav, g, engine="python", **kw), got,
                                   rtol=0, atol=1e-9)


def test_fmm_copies_what_it_cannot_share():
    trav, goals, _ = fmm_grid(5)
    want = fmm.fmm_distance(trav, goals)
    for grid in (trav.astype(np.uint8), np.asfortranarray(trav), trav[::1, ::1].copy()):
        np.testing.assert_array_equal(fmm.fmm_distance(grid, goals), want)
    with pytest.raises(ValueError, match="engine"):
        fmm.fmm_distance(trav, goals, engine="skfmm")
