"""Multi-class Q-network (counterpart of video_dqn_tpu/models/qnet.py).

ResNet18 trunk and one of two heads, output (B, num_classes, action_dim)
float32 Q-values:
  * 'extra_capacity': conv(512->64, 3x3 VALID) + ReLU, flatten per frame
    (64*h*w, CHW order as the reference), MLP 512 -> 256 -> A*C;
  * 'basic': global average pool 512 per frame -> Linear A*C.
All panorama frames are folded into the batch and run through the trunk
in one pass. Input is NHWC float, (B, F, H, W, 3) or (B, H, W, 3), as the
JAX module takes it; inside, the trunk runs NCHW in channels_last memory.

Parameter names are the reference's (HabitatDQNMultiAction): the trunk
under `resnet.*`, and the same modules again under `features.0`..`7` with
the head conv at `features.8`, because the reference's `features` is a
Sequential over the trunk's children; the MLP is `top.{0,2,4}` (or `top`
for basic). So a reference `.torch` checkpoint loads with strict=True once
its unused `resnet.fc.*` classifier is dropped.

With `remat` (TPU.REMAT, JAX's nn.remat of the trunk) a forward that
builds a graph keeps none of the trunk's activations: the backward
recomputes them (torch.utils.checkpoint, non-reentrant, so that the trunk's
parameters get gradients from frames that need none), and the
recomputation leaves the BatchNorm running statistics as the forward left
them, so a step updates them once, as JAX's does. Forwards without a
graph run as they would without it.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from .resnet import BatchNorm2d, ResNet18


def head_hw(image_size: int) -> int:
    """Side of the extra_capacity head's map: the trunk gives
    ceil(S/32), the 3x3 VALID head conv takes 2 off."""
    return -(-image_size // 32) - 2


class HabitatDQN(nn.Module):
    def __init__(self, action_dim: int = 3, num_classes: int = 5,
                 extra_capacity: bool = False, panorama: bool = True,
                 image_size: int = 224, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.action_dim = action_dim
        self.num_classes = num_classes
        self.extra_capacity = extra_capacity
        self.num_frames = 4 if panorama else 1
        self.image_size = image_size
        self.resnet = ResNet18(features="conv" if extra_capacity else "pool")
        trunk = self.resnet.trunk()
        if extra_capacity:
            side = head_hw(image_size)
            if side < 1:
                raise ValueError(
                    f"extra_capacity needs images of at least 65 px, got {image_size}")
            self.features = nn.Sequential(*trunk, nn.Conv2d(512, 64, 3))
            self.top = nn.Sequential(
                nn.Linear(64 * side * side * self.num_frames, 512), nn.ReLU(),
                nn.Linear(512, 256), nn.ReLU(),
                nn.Linear(256, action_dim * num_classes),
            )
        else:
            self.features = nn.Sequential(*trunk, self.resnet.avgpool)
            self.top = nn.Linear(512 * self.num_frames, action_dim * num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: float (B, F, H, W, 3), or (B, H, W, 3) when single-frame."""
        if x.dim() == 4:
            x = x[:, None]
        if x.shape[1] != self.num_frames:
            raise ValueError(
                f"expected {self.num_frames} frames, got shape {tuple(x.shape)}")
        b, f = x.shape[0], x.shape[1]
        # NHWC -> NCHW as a view: a contiguous NHWC tensor is channels_last
        x = x.reshape((b * f,) + x.shape[2:]).permute(0, 3, 1, 2)
        if self.remat and torch.is_grad_enabled():
            feats = checkpoint(self._trunk, x, use_reentrant=False,
                               context_fn=self._remat_contexts)
            feats = self.features[-1](feats)  # the head conv, or the pool
        else:
            feats = self.features(x)
        if self.extra_capacity:
            feats = torch.relu(feats)
        out = self.top(feats.reshape(b, -1))
        return out.float().reshape(b, self.num_classes, self.action_dim)

    def _trunk(self, x: torch.Tensor) -> torch.Tensor:
        for module in self.features[:-1]:
            x = module(x)
        return x

    def _remat_contexts(self):
        """(the forward's context, the recomputation's): the latter holds
        the trunk's running statistics still."""
        return contextlib.nullcontext(), self._statistics_held()

    @contextlib.contextmanager
    def _statistics_held(self):
        norms = [m for m in self.resnet.modules() if isinstance(m, BatchNorm2d)]
        for m in norms:
            m.update_stats = False
        try:
            yield
        finally:
            for m in norms:
                m.update_stats = True

    def set_train(self, mode: bool = True) -> "HabitatDQN":
        """The reference's set_train(): train mode, except that
        extra_capacity keeps the trunk's BatchNorm on its running
        statistics (its scale and shift still learn). A bare .train()
        would switch that trunk to batch statistics."""
        self.train(mode)
        if self.extra_capacity:
            self.resnet.eval()
        return self


def build_qnet(config, image_size: int = 224, device=None) -> HabitatDQN:
    """Mirror of the JAX build_qnet: VALUE_LEARNING/ONE_ACTION collapse to
    a single action head; PANORAMA or PREVIOUS_IMAGES enable 4-frame
    stacking; TPU.REMAT recomputes the trunk in the backward. Reads those
    keys and ARCHITECTURE from any attribute object. Returns the model in
    eval mode, channels_last, on `device` (None: the card)."""
    device = resolve_device(device)
    actions = 1 if (config.VALUE_LEARNING or config.ONE_ACTION) else 3
    tpu = getattr(config, "TPU", None)
    model = HabitatDQN(
        action_dim=actions,
        num_classes=5,
        extra_capacity=(config.ARCHITECTURE == "extra_capacity"),
        panorama=bool(config.PANORAMA or config.PREVIOUS_IMAGES),
        image_size=image_size,
        remat=bool(tpu.REMAT) if tpu is not None else False,
    )
    return model.to(device, memory_format=torch.channels_last).eval()


# Flax's lecun_normal draws a standard normal truncated to [-2, 2] and
# divides by its standard deviation, so that the kernel's variance is
# 1/fan_in (jax.nn.initializers.variance_scaling, "truncated_normal")
TRUNCATED_NORMAL_STD = 0.87962566103423978


@torch.no_grad()
def init_qnet(model: HabitatDQN, generator: torch.Generator) -> HabitatDQN:
    """Seeded init in place with the JAX package's initializers: conv and
    dense kernels lecun_normal (a standard normal truncated to [-2, 2],
    times sqrt(1/fan_in) / TRUNCATED_NORMAL_STD), biases 0, BatchNorm
    scale 1, shift 0, statistics (0, 1). `generator` is a CPU generator;
    the model may lie on any device."""
    for module in model.modules():
        if isinstance(module, (nn.Conv2d, nn.Linear)):
            w = module.weight
            draw = torch.empty(w.shape)
            nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=generator)
            w.copy_(draw * (1.0 / math.sqrt(w[0].numel()) / TRUNCATED_NORMAL_STD))
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.BatchNorm2d):
            module.reset_parameters()
    return model
