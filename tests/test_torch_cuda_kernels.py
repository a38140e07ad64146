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


@pytest.mark.cuda
@pytest.mark.parametrize("shape,out", [
    ((96, 256, 342, 3), 224), ((96, 224, 224, 3), 224), ((12, 96, 96, 3), 96),
])
def test_cuda_kernel_matches_reference(shape, out):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda", generator=g)
    before = rn.LAUNCHES
    got = rn.resize_normalize(x, out)
    torch.cuda.synchronize()
    assert rn.LAUNCHES == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    want = rn.resize_normalize_reference(x, out)
    assert (got - want).abs().max().item() <= ATOL
