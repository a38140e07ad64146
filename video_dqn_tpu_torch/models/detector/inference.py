"""The detector behind the data pipeline's and the eval fusion's contracts
(counterpart of video_dqn_tpu/models/detector/inference.py):
`detector(images_uint8 (B, H, W, 3)) -> [{boxes, scores, classes}]` per
image, and `detector(image, class_label) -> (boxes, scores)` of one class
in one image.

A call copies the frames to the device, normalizes them with the identity
kernel (ops/resize_normalize.py normalize_u8; bf16 out on the card, where
the model runs under bf16 autocast as the JAX package runs the detector in
bf16; float32 on the CPU), runs MaskRCNN over the whole batch, and brings
the whole output back in one device-to-host copy.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..._device import resolve_device
from ...data.detect import COCO_TARGET_IDS
from ...ops.resize_normalize import normalize_u8
from ..bridge import load_torch_state_dict
from .convert import convert_maskrcnn
from .maskrcnn import MaskRCNN


class TorchDetector:
    """MaskRCNN on `device` (None: the card) behind the two call
    contracts, computing in bf16 under autocast on the card and in float32
    on the CPU. `calls` counts calls: one call is one fused reasoning stop
    in the eval policy (a stop's views arrive as one batch)."""

    def __init__(self, model: MaskRCNN, score_thresh: float = 0.05, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.on_card = self.device.type == "cuda"
        if self.on_card:
            self.model = self.model.to(memory_format=torch.channels_last)
        self.dtype = torch.bfloat16 if self.on_card else torch.float32
        self.score_thresh = score_thresh
        self.calls = 0

    @torch.no_grad()
    def run(self, images: np.ndarray) -> Dict[str, np.ndarray]:
        """uint8 (B, H, W, 3) -> {boxes (B, D, 4), scores (B, D), classes
        (B, D), valid (B, D)} as numpy, D = max_detections."""
        x = torch.from_numpy(np.ascontiguousarray(images, np.uint8))
        if self.on_card:
            x = x.pin_memory().to(self.device, non_blocking=True)
        x = normalize_u8(x, self.dtype)
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            out = self.model(x)
        # one device-to-host copy: (B, D, 7) = box, score, class, valid
        packed = torch.cat([out["boxes"], out["scores"][..., None],
                            out["classes"][..., None].float(),
                            out["valid"][..., None].float()], -1).cpu().numpy()
        return {"boxes": packed[..., :4], "scores": packed[..., 4],
                "classes": packed[..., 5].astype(np.int64), "valid": packed[..., 6] > 0}

    def __call__(self, images, class_label: Optional[str] = None):
        self.calls += 1
        images = np.asarray(images)
        single = images.ndim == 3
        if single:
            images = images[None]
        out = self.run(images)
        results: List[Dict] = []
        for i in range(images.shape[0]):
            keep = out["valid"][i] & (out["scores"][i] > self.score_thresh)
            results.append({"boxes": out["boxes"][i][keep], "scores": out["scores"][i][keep],
                            "classes": out["classes"][i][keep]})
        if class_label is not None:
            # the eval-fusion contract: (boxes, scores) of one class, one image
            det = results[0]
            mask = det["classes"] == COCO_TARGET_IDS.get(class_label)
            return det["boxes"][mask], det["scores"][mask]
        return results[0] if single else results


def load_detector(weights_path: str, with_masks: bool = False, score_thresh: float = 0.05,
                  device=None) -> TorchDetector:
    """MaskRCNN from a torchvision maskrcnn_resnet50_fpn checkpoint file
    (either naming; a {'model_state_dict': ...} snapshot too), on `device`
    (None: the card; raises without CUDA)."""
    device = resolve_device(device)
    model = MaskRCNN(with_masks=with_masks)
    model.load_state_dict(convert_maskrcnn(load_torch_state_dict(weights_path), with_masks),
                          strict=True)
    return TorchDetector(model, score_thresh, device)
