"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None means the card. Without CUDA that raises: the port runs on
    the CPU only when the caller passes device="cpu" (as the tests do),
    never by falling back."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "video_dqn_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
