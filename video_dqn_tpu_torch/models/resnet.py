"""ResNet-18 trunk (counterpart of video_dqn_tpu/models/resnet.py
`BasicBlock` and `ResNet18`).

Module names follow torchvision's resnet18 (`conv1`, `bn1`, `layerS.B.*`,
`downsample.{0,1}`, `fc`), which is the naming of the reference's `.torch`
checkpoints. BatchNorm uses eps 1e-5; the max-pool pads by 1. The JAX
package's space-to-depth stem (`Stem7x7(s2d=True)`) is a TPU layout trick
that computes the same function and is off by default there; it is not
ported.

Feature taps, as in the JAX module:
  - 'conv':   through layer4 -> (B, 512, H/32, W/32)
  - 'pool':   + global average pool -> (B, 512)
  - 'logits': + fc -> (B, num_classes)
"""

from __future__ import annotations

import torch
from torch import nn

TAPS = ("conv", "pool", "logits")


class BasicBlock(nn.Module):
    """Two 3x3 convs with identity (or 1x1-projected) skip."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout, eps=1e-5)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout, eps=1e-5)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride=stride, bias=False),
                nn.BatchNorm2d(cout, eps=1e-5),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(y + residual)


class ResNet18(nn.Module):
    """Stages of (2, 2, 2, 2) BasicBlocks at (64, 128, 256, 512) filters.
    Takes NCHW input; `fc` exists only for the 'logits' tap."""

    def __init__(self, features: str = "pool", num_classes: int = 1000):
        super().__init__()
        if features not in TAPS:
            raise ValueError(f"features must be one of {TAPS}, got {features!r}")
        self.tap = features
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=1e-5)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        cin = 64
        for stage, width in enumerate((64, 128, 256, 512)):
            stride = 2 if stage > 0 else 1
            setattr(self, f"layer{stage + 1}", nn.Sequential(
                BasicBlock(cin, width, stride), BasicBlock(width, width)))
            cin = width
        self.avgpool = nn.AdaptiveAvgPool2d(1)
        if features == "logits":
            self.fc = nn.Linear(512, num_classes)

    def trunk(self) -> list[nn.Module]:
        """The modules through layer4, in order (torchvision's
        children()[:-2])."""
        return [self.conv1, self.bn1, self.relu, self.maxpool,
                self.layer1, self.layer2, self.layer3, self.layer4]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for module in self.trunk():
            x = module(x)
        if self.tap == "conv":
            return x
        x = torch.flatten(self.avgpool(x), 1)
        if self.tap == "pool":
            return x
        return self.fc(x)
