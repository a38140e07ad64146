"""ResNet-18 trunk and the detector's ResNet-50 stages (counterpart of
video_dqn_tpu/models/resnet.py `BasicBlock`, `ResNet18`, `Bottleneck` and
`ResNet50Stages`).

Module names follow torchvision's resnet18 (`conv1`, `bn1`, `layerS.B.*`,
`downsample.{0,1}`, `fc`), which is the naming of the reference's `.torch`
checkpoints. BatchNorm uses eps 1e-5 and, in train mode, the Flax update
of its running statistics (`BatchNorm2d`); the max-pool pads by 1. The JAX
package's space-to-depth stem (`Stem7x7(s2d=True)`) is a TPU layout trick
that computes the same function and is off by default there; it is not
ported.

`ResNet50Stages` (the detector's backbone body) keeps torchvision's
resnet50 names too, so that the body of a maskrcnn_resnet50_fpn
checkpoint loads into it; its BatchNorm is `FrozenBatchNorm2d`, running
statistics only, as torchvision's detection backbones have it.

Feature taps of ResNet18, as in the JAX module:
  - 'conv':   through layer4 -> (B, 512, H/32, W/32)
  - 'pool':   + global average pool -> (B, 512)
  - 'logits': + fc -> (B, num_classes)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

TAPS = ("conv", "pool", "logits")


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d (eps 1e-5) whose train mode updates the running
    statistics as Flax's BatchNorm does: Flax momentum 0.9 is torch
    momentum 0.1, and the running variance moves toward the biased batch
    variance, where nn.BatchNorm2d takes the unbiased one. The batch is
    normalized by its biased statistics in both. Eval mode is
    nn.BatchNorm2d's. With `update_stats` False a train-mode forward
    leaves the running statistics alone (a checkpointed trunk's
    recomputation, models/qnet.py)."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=1e-5, momentum=0.1)
        self.update_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.update_stats:
            self._update_running_stats(x)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    @torch.no_grad()
    def _update_running_stats(self, x: torch.Tensor) -> None:
        var, mean = torch.var_mean(x.to(self.running_mean.dtype), dim=(0, 2, 3),
                                   unbiased=False)
        self.running_mean.lerp_(mean, self.momentum)
        self.running_var.lerp_(var, self.momentum)


class BasicBlock(nn.Module):
    """Two 3x3 convs with identity (or 1x1-projected) skip."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm2d(cout)
        self.relu = nn.ReLU(inplace=True)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride=stride, bias=False),
                BatchNorm2d(cout),
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
        self.bn1 = BatchNorm2d(64)
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


class FrozenBatchNorm2d(nn.Module):
    """BatchNorm from fixed statistics (eps 1e-5), as torchvision's
    detection backbones use it: the four tensors are buffers, and a
    state dict's `num_batches_tracked` is dropped on load."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        for name, value in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                            ("running_var", 1.0)):
            self.register_buffer(name, torch.full((num_features,), value))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 (x4) bottleneck with the stride on the 3x3, as
    torchvision's resnet50 has it."""

    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        cout = width * 4
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = FrozenBatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1, bias=False)
        self.bn2 = FrozenBatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, cout, 1, bias=False)
        self.bn3 = FrozenBatchNorm2d(cout)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride=stride, bias=False),
                FrozenBatchNorm2d(cout),
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + residual)


class ResNet50Stages(nn.Module):
    """ResNet-50 returning the C2..C5 stage outputs (strides 4, 8, 16, 32),
    the FPN's taps: the plain 7x7 stem and bottleneck stages (3, 4, 6, 3)
    at widths (64, 128, 256, 512). Takes NCHW input."""

    def __init__(self, stage_sizes=(3, 4, 6, 3), widths=(64, 128, 256, 512)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        cin = 64
        for stage, (n_blocks, width) in enumerate(zip(stage_sizes, widths)):
            blocks = []
            for block in range(n_blocks):
                blocks.append(Bottleneck(cin, width, 2 if stage > 0 and block == 0 else 1))
                cin = width * 4
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> tuple:
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        taps = []
        for stage in range(1, 5):
            x = getattr(self, f"layer{stage}")(x)
            taps.append(x)
        return tuple(taps)  # C2, C3, C4, C5
