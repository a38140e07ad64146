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
    before = rn.LAUNCHES
    got = rn.resize_normalize(raw, 32)
    assert rn.LAUNCHES == before  # the CPU path launches no kernel
    assert got.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(got, rn.resize_normalize_reference(raw, 32),
                               rtol=0, atol=0)


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
