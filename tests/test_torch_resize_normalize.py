"""The port's fused resize+normalize against the JAX package's: its plain
twin against resize_normalize_xla and the Pallas kernel (interpret mode),
its resample matrices, and the band tables its CUDA kernel reads."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from video_dqn_tpu.ops import image as jax_image
from video_dqn_tpu.ops import pallas_image as jax_pallas
from video_dqn_tpu_torch.ops import image as port_image
from video_dqn_tpu_torch.ops import resize_normalize as rn
from tests import torch_port_util  # noqa: F401  (caps torch threads per worker)

ATOL = 1e-5  # float32 sums of <= 255-scale values in another order


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("shape,out", [
    ((2, 48, 40, 3), 32),
    ((2, 16, 16, 3), 16),       # identity resample
    ((1, 256, 342, 3), 224),    # the dataset's frames to model size
])
def test_reference_matches_xla_twin(rng, shape, out):
    raw = rng.integers(0, 256, shape, np.uint8)
    want = np.asarray(jax_pallas.resize_normalize_xla(jnp.asarray(raw), out))
    got = rn.resize_normalize_reference(torch.from_numpy(raw), out)
    assert got.shape == (shape[0], 3, out, out)
    np.testing.assert_allclose(nhwc(got), want, atol=ATOL)


def test_reference_matches_pallas_interpret(rng):
    raw = rng.integers(0, 256, (2, 48, 40, 3), np.uint8)
    want = np.asarray(jax_pallas.resize_normalize_pallas(
        jnp.asarray(raw), 32, interpret=True))
    got = rn.resize_normalize_reference(torch.from_numpy(raw), 32)
    np.testing.assert_allclose(nhwc(got), want, atol=ATOL)


@pytest.mark.parametrize("src,dst", [
    (256, 224), (342, 224), (480, 224), (100, 224), (224, 224),
    (96, 96), (48, 32), (40, 32),
])
def test_resize_matrix_equals_jax(src, dst):
    np.testing.assert_array_equal(rn.resize_matrix(src, dst),
                                  jax_pallas.resize_matrix(src, dst))


@pytest.mark.parametrize("src,dst,k", [
    (256, 224, 3), (342, 224, 4), (480, 224, 5), (224, 224, 1), (96, 96, 1),
    (48, 32, 3),
])
def test_band_table_reproduces_dense_matrix(src, dst, k):
    m = rn.resize_matrix(src, dst)
    start, weights = rn.band_table(m)
    assert weights.shape == (dst, k)
    assert start.min() >= 0 and (start + k).max() <= src
    dense = np.zeros_like(m)
    for o in range(dst):
        dense[o, start[o]:start[o] + k] = weights[o]
    np.testing.assert_array_equal(dense, m)


def test_identity_resample_is_exact():
    np.testing.assert_array_equal(rn.resize_matrix(224, 224), np.eye(224))


def test_wrapper_on_cpu_is_the_twin(rng):
    raw = torch.from_numpy(rng.integers(0, 256, (2, 48, 40, 3), np.uint8))
    before = sum(rn.LAUNCHES.values())
    got = rn.resize_normalize(raw, 32)
    assert sum(rn.LAUNCHES.values()) == before  # the CPU path launches no kernel
    assert got.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(got, rn.resize_normalize_reference(raw, 32),
                               rtol=0, atol=0)


@pytest.mark.parametrize("shape,out", [((2, 48, 40, 3), 32), ((2, 16, 16, 3), 16)])
def test_wrapper_on_cpu_writes_bf16_as_the_cast_twin(rng, shape, out):
    raw = torch.from_numpy(rng.integers(0, 256, shape, np.uint8))
    before = sum(rn.LAUNCHES.values())
    got = rn.resize_normalize(raw, out, torch.bfloat16)
    assert sum(rn.LAUNCHES.values()) == before
    assert got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, rn.resize_normalize_reference(raw, out).to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.uint8])
def test_wrapper_rejects_other_output_dtypes(dtype):
    with pytest.raises(TypeError):
        rn.resize_normalize(torch.zeros((1, 8, 8, 3), dtype=torch.uint8), 8, dtype)


@pytest.mark.parametrize("h,w,out,identity", [
    (224, 224, 224, True), (96, 96, 96, True), (16, 16, 16, True),
    (224, 224, 96, False), (96, 96, 224, False), (224, 256, 224, False),
    (256, 224, 224, False), (256, 342, 224, False),
])
def test_identity_path_exactly_when_sizes_agree(h, w, out, identity):
    plan = rn.kernel_plan(h, w, out)
    assert plan.identity == identity
    if identity:
        assert plan == rn.Plan(identity=True)  # no tiles, no shared memory
    else:
        assert plan.rows_per_tile >= 1 and plan.smem_bytes > 0


def _tile_rows(out, rows_per_tile):
    return [range(o0, min(o0 + rows_per_tile, out))
            for o0 in range(0, out, rows_per_tile)]


@pytest.mark.parametrize("h,w,out,span", [
    (256, 342, 224, 11), (480, 640, 224, 20), (342, 256, 224, 15),
    (37, 53, 32, 11), (40, 50, 30, 12), (20, 30, 45, 6),
])
def test_banded_tile_plan_covers_every_tap(h, w, out, span):
    plan = rn.kernel_plan(h, w, out)
    start, weights = rn.band_table(rn.resize_matrix(h, out))
    k_h = weights.shape[1]
    assert np.all(np.diff(start) >= 0)  # band starts never decrease
    assert plan.rows_per_tile == rn.ROWS_PER_TILE and plan.span == span
    spans = []
    for rows in _tile_rows(out, plan.rows_per_tile):
        # the kernel stages [start[first row], start[last row] + K_h)
        lo, hi = start[rows[0]], start[rows[-1]] + k_h
        for o in rows:
            taps = np.flatnonzero(rn.resize_matrix(h, out)[o])
            assert lo <= taps.min() and taps.max() < hi
        spans.append(hi - lo)
    assert max(spans) == plan.span


@pytest.mark.parametrize("rows_per_tile", [1, 2, 4, 16])
def test_staged_span_covers_every_tap_at_other_tile_heights(rows_per_tile):
    # the tile heights that tools/banded_variants.py times, at 256 -> 224
    m = rn.resize_matrix(256, 224)
    start, weights = rn.band_table(m)
    spans = []
    for rows in _tile_rows(224, rows_per_tile):
        lo, hi = start[rows[0]], start[rows[-1]] + weights.shape[1]
        taps = np.flatnonzero(m[list(rows)].any(axis=0))
        assert lo <= taps.min() and taps.max() < hi
        spans.append(hi - lo)
    assert rn.staged_span(256, 224, rows_per_tile) == max(spans)


@pytest.mark.parametrize("dtype,region", [
    # the region holds the larger of 11 staged rows of 1026 bytes and the
    # 8x224x3 output tile, each with up to 15 bytes of phase and 7 bytes of
    # read-past, in 16-byte words
    (torch.float32, 16 * ((8 * 224 * 3 * 4 + 37) // 16)),   # the f32 tile
    (torch.bfloat16, 16 * ((11 * 1026 + 37) // 16)),        # the input rows
])
def test_banded_smem_bytes_match_the_kernel_layout(dtype, region):
    # 256x342 -> 224 at 8 rows a tile: f32 sums 8x3x344, then the shared
    # input/output region
    want = 4 * 8 * 3 * 344 + region
    plan = rn.kernel_plan(256, 342, 224, dtype.itemsize)
    assert plan.smem_bytes == want
    # the wrapper requests the plan's bytes
    launch = rn._prepared(256, 342, 224, dtype, torch.device("cpu"))
    assert launch.plan == plan and launch.args.smem_bytes == plan.smem_bytes
    assert launch.args.rows_per_tile == plan.rows_per_tile
    assert (launch.args.k_h, launch.args.k_w) == (3, 4)
    assert launch.args.out_bf16 == (dtype == torch.bfloat16)


@pytest.mark.parametrize("h,w,out", [
    (1080, 1920, 224),   # a 1080p frame to model size: 44 staged rows a tile
    (16, 20000, 8),      # one row's sums alone exceed the limit
])
def test_tile_plan_raises_past_the_shared_memory_limit(h, w, out):
    with pytest.raises(ValueError, match="shared memory"):
        rn.kernel_plan(h, w, out)


@pytest.mark.parametrize("bad", [
    torch.zeros((1, 8, 8, 3), dtype=torch.float32),
    torch.zeros((1, 8, 8, 4), dtype=torch.uint8),
    torch.zeros((8, 8, 3), dtype=torch.uint8),
    torch.zeros((1, 8, 16, 3), dtype=torch.uint8)[:, :, ::2],
])
def test_wrapper_rejects_bad_input(bad):
    with pytest.raises((TypeError, ValueError)):
        rn.resize_normalize(bad, 8)


def test_normalize_matches_jax(rng):
    raw = rng.integers(0, 256, (2, 8, 8, 3), np.uint8)
    want = np.asarray(jax_image.to_imgnet(jnp.asarray(raw)))
    got = port_image.to_imgnet(torch.from_numpy(raw)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    # the kernel's identity path computes the same function
    np.testing.assert_allclose(
        nhwc(rn.resize_normalize(torch.from_numpy(raw), 8)), want, atol=ATOL)
