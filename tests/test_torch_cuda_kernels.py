"""The port's CUDA kernels against their plain torch versions on the card.

Marked `cuda`: without a CUDA device each test skips. This file imports
neither jax nor the JAX package, so it also runs where only the port is
installed:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from video_dqn_tpu_torch.ops import resize_normalize as rn

ATOL = 1e-5  # float32 sums of <= 255-scale values in another order
BF16_RTOL = 2.0 ** -8  # half a bf16 ulp, relative


def frames(shape, seed=0):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=g)


def check(x, out, dtype):
    """One launch of the kernel's path for x, NCHW channels_last output of
    `dtype`; identity paths bit-equal to the plain version, banded ones
    within float32 reordering (plus half a bf16 ulp for bf16)."""
    path = "identity" if rn.kernel_plan(x.shape[1], x.shape[2], out).identity else "banded"
    before = rn.LAUNCHES[path, str(dtype)[6:]]
    got = rn.resize_normalize(x, out, dtype)
    torch.cuda.synchronize()
    assert rn.LAUNCHES[path, str(dtype)[6:]] == before + 1
    assert got.dtype == dtype and got.shape == (x.shape[0], 3, out, out)
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = rn.resize_normalize_reference(x, out)
    if path == "identity":
        assert torch.equal(got, want.to(dtype))
    else:
        err = (got.float() - want).abs()
        tol = ATOL + (BF16_RTOL * want.abs() if dtype == torch.bfloat16 else 0.0)
        assert bool((err <= tol).all()), float(err.max())


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,out", [
    ((96, 256, 342, 3), 224), ((96, 224, 224, 3), 224), ((12, 96, 96, 3), 96),
])
def test_cuda_kernel_matches_reference(shape, out, dtype):
    check(frames(shape), out, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,out", [
    ((1, 256, 342, 3), 224),    # one frame: one CTA row of tiles
    ((2, 37, 53, 3), 32),       # H*W*3 = 5883, not a multiple of 16
    ((2, 40, 50, 3), 30),       # OUT not a multiple of the 8-row tile
    ((2, 480, 640, 3), 224),    # K = 5 and 6 taps
    ((2, 20, 30, 3), 45),       # upsampling
    ((1, 17, 17, 3), 17),       # identity, 867 values: a tail of 3
], ids=["b1", "odd-bytes", "ragged-tile", "480x640", "upsample", "identity-tail"])
def test_cuda_kernel_ragged_shapes(shape, out, dtype):
    check(frames(shape, seed=1), out, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,out", [((3, 37, 53, 3), 32), ((3, 17, 17, 3), 17)],
                         ids=["banded", "identity"])
def test_cuda_kernel_unaligned_batch(shape, out, dtype):
    x = frames(shape, seed=2)[1:]  # starts 37*53*3 (or 867) bytes in
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    check(x, out, dtype)
