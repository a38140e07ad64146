"""Inverse-action model (counterpart of video_dqn_tpu/models/inverse.py:31-86
`InverseActionModel`, `init_inverse`, `predict_actions`): classifies the
action {forward, left, right} taken between two frames.

A frozen ResNet18 trunk runs on the before and after frames stacked into
one batch of 2B (always on its BatchNorm running statistics, no
gradient), the two maps are concatenated on channels (before, then after:
1024), then conv 1x1 -> 256, conv 3x3 -> 256, conv 3x3 -> 64, each with
ReLU, flatten, fc -> 128 with ReLU and dropout 0.5 in training, fc -> 3
logits in float32, and it returns (softmax encoding, calibrated logits of
a float32 3 -> 3 linear on the logits). The two 3x3 convs pad VALID when
the trunk map is at least 5x5 (images of 160 px and more; 224 px gives a
3x3x64 = 576 flatten) and SAME below, as the JAX module switches.

Parameter names are the reference's (TorchInverseModel): the trunk as the
Sequential `resnet18.{0,1,4,5,6,7}` of torchvision's children, then
`conv1`, `conv2`, `conv3`, `fc1`, `fc2`, `fc_accuracy`, so a reference
`.torch` state dict loads with strict=True. `fc1` reads the flatten in
torch's (C, H, W) order; the bridge reorders it to Flax's (H, W, C).
Under bf16 autocast the softmax and `fc_accuracy` still run in float32.
"""

from __future__ import annotations

import torch
from torch import nn

from .qnet import init_qnet
from .resnet import ResNet18

KEEP = 0.5  # dropout keeps each fc1 unit with this probability


def trunk_side(image_size: int) -> int:
    """Side of the ResNet18 trunk's map: ceil(S / 32)."""
    return -(-image_size // 32)


def head_side(image_size: int) -> int:
    """Side of the map fc1 flattens: two VALID 3x3 convs take 4 off a
    trunk map of at least 5x5; below that they pad SAME."""
    t = trunk_side(image_size)
    return t - 4 if t >= 5 else t


class InverseActionModel(nn.Module):
    def __init__(self, image_size: int = 224, bottleneck_size: int = 3):
        super().__init__()
        self.image_size = image_size
        self.resnet18 = nn.Sequential(*ResNet18(features="conv").trunk())
        pad = 0 if trunk_side(image_size) >= 5 else 1
        self.conv1 = nn.Conv2d(1024, 256, 1)
        self.conv2 = nn.Conv2d(256, 256, 3, padding=pad)
        self.conv3 = nn.Conv2d(256, 64, 3, padding=pad)
        self.fc1 = nn.Linear(64 * head_side(image_size) ** 2, 128)
        self.fc2 = nn.Linear(128, bottleneck_size)
        self.fc_accuracy = nn.Linear(bottleneck_size, 3)
        self.resnet18.requires_grad_(False)

    def train(self, mode: bool = True) -> "InverseActionModel":
        """The head's mode; the trunk stays on its running statistics."""
        super().train(mode)
        self.resnet18.eval()
        return self

    def trunk_parameters(self) -> list:
        return list(self.resnet18.parameters())

    def head_parameters(self) -> list:
        return [p for name, p in self.named_parameters() if not name.startswith("resnet18.")]

    @torch.no_grad()
    def features(self, pair: torch.Tensor) -> torch.Tensor:
        """The frozen trunk on the stacked pair: (2B, 512, h, w)."""
        return self.resnet18(pair)

    def head(self, feats: torch.Tensor, train: bool = False,
             dropout_mask: torch.Tensor | None = None):
        """The trunk maps of the before frames, then the after frames ->
        (encoding, calibrated), float32 (B, 3). `dropout_mask` (B, 128),
        nonzero where fc1's unit is kept, is used in training; without one,
        torch's global generator draws it."""
        b = feats.shape[0] // 2
        x = torch.cat([feats[:b], feats[b:]], dim=1)
        x = torch.relu(self.conv1(x))
        x = torch.relu(self.conv2(x))
        x = torch.relu(self.conv3(x))
        x = torch.relu(self.fc1(x.reshape(b, -1)))
        if train:
            if dropout_mask is None:
                dropout_mask = torch.rand(x.shape, device=x.device) < KEEP
            x = torch.where(dropout_mask.bool(), x / KEEP, 0.0)
        logits = self.fc2(x).float()
        with torch.autocast(logits.device.type, enabled=False):
            return torch.softmax(logits, dim=-1), self.fc_accuracy(logits)

    def forward_pair(self, pair: torch.Tensor, train: bool = False,
                     dropout_mask: torch.Tensor | None = None):
        """pair: the normalized before frames, then the after frames, (2B,
        3, S, S) NCHW (channels_last memory, as the resize+normalize kernel
        writes it). Returns (encoding, calibrated)."""
        return self.head(self.features(pair), train, dropout_mask)

    def forward(self, before: torch.Tensor, after: torch.Tensor, train: bool = False,
                dropout_mask: torch.Tensor | None = None):
        """before, after: normalized float NHWC (B, S, S, 3), as the JAX
        module takes them. Returns (encoding, calibrated)."""
        pair = torch.cat([before, after]).permute(0, 3, 1, 2)
        return self.forward_pair(pair, train, dropout_mask)


def init_inverse(model: InverseActionModel, generator: torch.Generator) -> InverseActionModel:
    """Seeded init in place with the JAX package's initializers (lecun_normal
    kernels, zero biases, BatchNorm at scale 1, shift 0, statistics (0, 1)),
    as models/qnet.py init_qnet draws them."""
    return init_qnet(model, generator)


@torch.no_grad()
def predict_actions(model: InverseActionModel, before: torch.Tensor,
                    after: torch.Tensor) -> torch.Tensor:
    """Batch action labels: argmax over the calibrated logits."""
    return model(before, after, False)[1].argmax(dim=-1)
