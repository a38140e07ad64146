"""ImageNet normalization on NHWC tensors (counterpart of
video_dqn_tpu/ops/image.py). The resize for the dataset side
(`imagenet_preprocess`) belongs to a later slice."""

from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_imagenet(batch: torch.Tensor) -> torch.Tensor:
    """float [0,1] NHWC -> ImageNet-normalized."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=batch.device)
    std = torch.as_tensor(IMAGENET_STD, device=batch.device)
    return (batch - mean) / std


def to_imgnet(batch_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC (already at target resolution) -> normalized float32."""
    return normalize_imagenet(batch_uint8.float() / 255.0)
