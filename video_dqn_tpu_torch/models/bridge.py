"""Weights into the port: the JAX package's Flax Q-net trees (as numpy)
to a torch state dict, and the reference's `.torch` checkpoints.

The state dict uses the reference's naming, which is also the port's
HabitatDQN naming: `resnet.*` (torchvision), the trunk again under
`features.{0,1,4,5,6,7}`, the head conv `features.8`, and `top.{0,2,4}`
(or `top` for the basic head). This is the inverse of the JAX package's
torch->Flax converter (convert_qnet):
  * conv kernels HWIO -> OIHW; dense kernels (in, out) -> (out, in);
  * the first head dense reads a flattened map: Flax flattens each frame
    as (H, W, C), torch as (C, H, W), so its input columns are re-ordered
    per frame block;
  * BatchNorm scale/bias -> weight/bias, mean/var -> running stats.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

# index of each trunk module in the reference's `features` Sequential
_FEATURE_INDEX = {"conv1": 0, "bn1": 1, "layer1": 4, "layer2": 5,
                  "layer3": 6, "layer4": 7}


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))  # a copy: leaves may be read-only


def _conv(kernel) -> torch.Tensor:
    return _t(np.asarray(kernel).transpose(3, 2, 0, 1))  # HWIO -> OIHW


def _dense(kernel) -> torch.Tensor:
    return _t(np.asarray(kernel).T)  # (in, out) -> (out, in)


def _dense_from_hwc(kernel, c: int, h: int, w: int, frames: int) -> torch.Tensor:
    """Inverse of the converter's dense_kernel_chw: Flax rows ordered
    (frame, h, w, c) -> torch columns ordered (frame, c, h, w)."""
    k = np.asarray(kernel)
    out_dim = k.shape[1]
    if k.shape[0] != frames * h * w * c:
        raise ValueError(f"head dense has {k.shape[0]} inputs, expected "
                         f"{frames}*{h}*{w}*{c}")
    blocks = k.T.reshape(out_dim, frames, h, w, c).transpose(0, 1, 4, 2, 3)
    return _t(blocks.reshape(out_dim, frames * c * h * w))


def _bn(sd: Dict, prefix: str, params: Mapping, stats: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(params["scale"])
    sd[f"{prefix}.bias"] = _t(params["bias"])
    sd[f"{prefix}.running_mean"] = _t(stats["mean"])
    sd[f"{prefix}.running_var"] = _t(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


def _resnet18(params: Mapping, stats: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ResNet18 tree -> torchvision naming, without `fc`."""
    sd: Dict[str, torch.Tensor] = {"conv1.weight": _conv(params["conv1"]["kernel"])}
    _bn(sd, "bn1", params["bn1"], stats["bn1"])
    for stage in range(1, 5):
        for block in range(2):
            p, s = params[f"layer{stage}_{block}"], stats[f"layer{stage}_{block}"]
            t = f"layer{stage}.{block}"
            sd[f"{t}.conv1.weight"] = _conv(p["conv1"]["kernel"])
            _bn(sd, f"{t}.bn1", p["bn1"], s["bn1"])
            sd[f"{t}.conv2.weight"] = _conv(p["conv2"]["kernel"])
            _bn(sd, f"{t}.bn2", p["bn2"], s["bn2"])
            if "downsample_conv" in p:
                sd[f"{t}.downsample.0.weight"] = _conv(p["downsample_conv"]["kernel"])
                _bn(sd, f"{t}.downsample.1", p["downsample_bn"], s["downsample_bn"])
    return sd


def qnet_state_dict_from_flax(params: Mapping, batch_stats: Mapping,
                              extra_capacity: bool, num_frames: int,
                              head_hw: Tuple[int, int] = (5, 5)
                              ) -> Dict[str, torch.Tensor]:
    """Flax HabitatDQN (params, batch_stats), as numpy trees, -> the port's
    (and the reference's) state dict. `head_hw` is the extra_capacity head
    map: (5, 5) at 224 px, (2, 2) at 128, (1, 1) at 96."""
    trunk = _resnet18(params["resnet"], batch_stats["resnet"])
    sd = {f"resnet.{k}": v for k, v in trunk.items()}
    for k, v in trunk.items():
        head, _, rest = k.partition(".")
        sd[f"features.{_FEATURE_INDEX[head]}.{rest}"] = v
    if extra_capacity:
        sd["features.8.weight"] = _conv(params["head_conv"]["kernel"])
        sd["features.8.bias"] = _t(params["head_conv"]["bias"])
        sd["top.0.weight"] = _dense_from_hwc(params["top_dense1"]["kernel"], 64,
                                             head_hw[0], head_hw[1], num_frames)
        sd["top.0.bias"] = _t(params["top_dense1"]["bias"])
        for i, name in ((2, "top_dense2"), (4, "top_dense3")):
            sd[f"top.{i}.weight"] = _dense(params[name]["kernel"])
            sd[f"top.{i}.bias"] = _t(params[name]["bias"])
    else:
        sd["top.weight"] = _dense(params["top_dense1"]["kernel"])
        sd["top.bias"] = _t(params["top_dense1"]["bias"])
    return sd


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Read a torch checkpoint file, unwrapping the reference's
    {'model_state_dict': ...} snapshot format when present. Tensors and
    plain containers only (weights_only)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and "model_state_dict" in blob:
        blob = blob["model_state_dict"]
    return dict(blob)
