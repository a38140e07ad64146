"""Eval model loading (counterpart of video_dqn_tpu/eval/runner.py
`load_eval_model`)."""

from __future__ import annotations

from .._device import resolve_device
from ..models.bridge import load_torch_state_dict
from ..models.qnet import HabitatDQN, build_qnet


def load_eval_model(config, model_config, image_size: int = 224,
                    device=None) -> HabitatDQN:
    """Build the Q-net from `model_config` and load the reference `.torch`
    checkpoint at config.PRETRAINED_MODEL_LOCATION with no conversion.
    The reference trunk carries torchvision's 1000-way classifier
    (`resnet.fc.*`), which the Q-net never reads; it is dropped, and every
    other key must match (strict). Reading the JAX package's
    sample<N>.ckpt (Flax msgpack) is not ported yet."""
    device = resolve_device(device)
    loc = config.PRETRAINED_MODEL_LOCATION
    if not loc:
        raise ValueError(
            "load_eval_model reads a .torch checkpoint from "
            "PRETRAINED_MODEL_LOCATION; sample<N>.ckpt is not supported yet")
    model = build_qnet(model_config, image_size=image_size, device=device)
    sd = load_torch_state_dict(loc)
    model.load_state_dict(
        {k: v for k, v in sd.items() if not k.startswith("resnet.fc.")},
        strict=True)
    return model
