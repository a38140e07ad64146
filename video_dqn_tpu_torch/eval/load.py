"""Eval model loading (counterpart of video_dqn_tpu/eval/runner.py
`load_eval_model`)."""

from __future__ import annotations

import os

from .._device import resolve_device
from ..core.checkpoint import restore_checkpoint
from ..models.bridge import layout, load_torch_state_dict, qnet_state_dict_from_flax
from ..models.qnet import HabitatDQN, build_qnet


def load_eval_model(config, model_config, image_size: int = 224,
                    device=None) -> HabitatDQN:
    """Build the Q-net from `model_config` and load its weights, as the
    JAX package does: the reference `.torch` checkpoint at
    config.PRETRAINED_MODEL_LOCATION with no conversion (its trunk's
    unused 1000-way classifier `resnet.fc.*` is dropped), or else the
    online params and batch statistics of
    <model_config.folder>/models/sample<config.MODEL_NUMBER>.ckpt, written
    by either package. Every key must match (strict)."""
    device = resolve_device(device)
    loc = config.PRETRAINED_MODEL_LOCATION
    if not loc and not (hasattr(model_config, "folder") and hasattr(config, "MODEL_NUMBER")):
        raise ValueError(
            "load_eval_model reads a .torch checkpoint from PRETRAINED_MODEL_LOCATION "
            "or models/sample<MODEL_NUMBER>.ckpt under the model config's folder; "
            "neither is given")
    model = build_qnet(model_config, image_size=image_size, device=device)
    if loc:
        sd = {k: v for k, v in load_torch_state_dict(loc).items()
              if not k.startswith("resnet.fc.")}
    else:
        state = restore_checkpoint(os.path.join(model_config.folder, "models"),
                                   int(config.MODEL_NUMBER))
        sd = qnet_state_dict_from_flax(state["params"], state["batch_stats"], *layout(model))
    model.load_state_dict(sd, strict=True)
    return model
