"""AlexNet-Places365, the indoor/outdoor scene classifier of the frame
filter (counterpart of video_dqn_tpu/models/alexnet_places.py
`AlexNetPlaces365`): torchvision's AlexNet topology with 365 classes.

    features:   conv 11x11/4 pad 2 -> 64, ReLU, max-pool 3/2;
                conv 5x5 pad 2 -> 192, ReLU, max-pool 3/2;
                conv 3x3 pad 1 -> 384, -> 256, -> 256, each with ReLU,
                max-pool 3/2 (pools VALID: no padding, floor)
    classifier: dropout, fc 9216 -> 4096, ReLU, dropout, fc 4096 -> 4096,
                ReLU, fc 4096 -> 365 logits

The parameters carry torchvision's names (`features.{0,3,6,8,10}`,
`classifier.{1,4,6}`), so the Places365 release and any torchvision-style
checkpoint load with strict=True. fc6 reads the pool5 map flattened in
torch's (C, H, W) order, as the checkpoint's rows are; the bridge
(`alexnet_state_dict_from_flax`) reorders a Flax kernel's (H, W, C) rows.
Like the JAX module it has no adaptive pool, so fc6 fits only a 6x6 pool5
map (224 px inputs): any other input raises ValueError. Under bf16
autocast fc8 still runs in float32, as the JAX module computes fc8.
"""

from __future__ import annotations

import torch
from torch import nn

from .._device import resolve_device
from .bridge import load_torch_state_dict

POOL5 = (256, 6, 6)   # the map fc6 flattens
INPUT_SIZE = 224      # the input side that gives it


class AlexNetPlaces365(nn.Module):
    def __init__(self, num_classes: int = 365):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 11, stride=4, padding=2), nn.ReLU(inplace=True),
            nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(inplace=True),
            nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(inplace=True),
            nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(inplace=True),
            nn.Conv2d(256, 256, 3, padding=1), nn.ReLU(inplace=True),
            nn.MaxPool2d(3, 2))
        c, h, w = POOL5
        self.classifier = nn.Sequential(
            nn.Dropout(0.5), nn.Linear(c * h * w, 4096), nn.ReLU(inplace=True),
            nn.Dropout(0.5), nn.Linear(4096, 4096), nn.ReLU(inplace=True),
            nn.Linear(4096, num_classes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: ImageNet-normalized (B, 3, 224, 224) -> float32 (B, 365) logits."""
        x = self.features(x)
        if tuple(x.shape[1:]) != POOL5:
            raise ValueError(f"AlexNetPlaces365 takes {INPUT_SIZE}x{INPUT_SIZE} inputs "
                             f"(a 6x6 pool5 map for fc6); this input gave a map of "
                             f"{tuple(x.shape[1:])}")
        x = self.classifier[:6](torch.flatten(x, 1))
        with torch.autocast(x.device.type, enabled=False):
            return self.classifier[6](x.float())


def load_alexnet_places(path: str, device=None) -> AlexNetPlaces365:
    """AlexNetPlaces365 in eval mode on `device` (None: the card; raises
    without CUDA) from a torchvision-named checkpoint file: a state dict,
    the reference's {'model_state_dict': ...} snapshot, or the Places365
    release's {'state_dict': ...} with DataParallel's `module.` prefixes."""
    device = resolve_device(device)
    sd = load_torch_state_dict(path)
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    model = AlexNetPlaces365()
    model.load_state_dict(sd, strict=True)
    return model.to(device).eval()
