"""torchvision maskrcnn_resnet50_fpn checkpoints -> the port's MaskRCNN
(counterpart of video_dqn_tpu/models/detector/convert.py).

The port's modules carry torchvision's own names, so a checkpoint needs no
layout change: a model without the mask head drops the mask weights
(`convert_maskrcnn`), and the legacy flat names of torchvision < 0.13
(`backbone.fpn.inner_blocks.0.weight`, `rpn.head.conv.weight`,
`roi_heads.mask_head.mask_fcn1.weight`) become the >= 0.13
Conv2dNormActivation names (`...inner_blocks.0.0.weight`,
`rpn.head.conv.0.0.weight`, `roi_heads.mask_head.0.0.weight`) on every
MaskRCNN.load_state_dict (`rename_legacy`), so either naming loads with
strict=True.

The mask predictor's ConvTranspose2d weight stays torch's (in, out, kh,
kw) as it is: the port computes torchvision's masks. (The JAX converter
only permutes it to (kh, kw, in, out), and Flax's ConvTranspose then
applies the taps mirrored; models/bridge.py flips them when it carries
a Flax tree across, so that the port computes what the JAX package
computes.)
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import torch

# legacy (torchvision < 0.13) name -> the >= 0.13 name
_LEGACY = [(re.compile(r"^(backbone\.fpn\.(?:inner|layer)_blocks\.\d+)\.(weight|bias)$"),
            r"\1.0.\2"),
           (re.compile(r"^rpn\.head\.conv\.(weight|bias)$"), r"rpn.head.conv.0.0.\1"),
           (re.compile(r"^roi_heads\.mask_head\.mask_fcn(\d)\.(weight|bias)$"),
            lambda m: f"roi_heads.mask_head.{int(m[1]) - 1}.0.{m[2]}")]
# the mask weights, in either naming
MASK_PREFIXES = ("roi_heads.mask_head.", "roi_heads.mask_predictor.")


def rename_legacy(state_dict: Dict, prefix: str = "") -> None:
    """Rename, in place, the legacy names under `prefix` (MaskRCNN's
    load_state_dict pre-hook)."""
    for key in list(state_dict):
        if not key.startswith(prefix):
            continue
        name = key[len(prefix):]
        for pattern, repl in _LEGACY:
            if pattern.match(name):
                state_dict[prefix + pattern.sub(repl, name)] = state_dict.pop(key)
                break


def convert_maskrcnn(sd: Mapping[str, torch.Tensor],
                     with_masks: bool = False) -> Dict[str, torch.Tensor]:
    """A torchvision maskrcnn_resnet50_fpn state dict, in either naming ->
    the state dict of MaskRCNN(with_masks=with_masks): without the mask
    weights unless with_masks. Raises KeyError if the checkpoint lacks the
    mask weights that with_masks asks for."""
    if with_masks:
        if not any(k.startswith(MASK_PREFIXES[0]) for k in sd):
            raise KeyError("the checkpoint has no mask head (roi_heads.mask_head.*)")
        return dict(sd)
    return {k: v for k, v in sd.items() if not k.startswith(MASK_PREFIXES)}
