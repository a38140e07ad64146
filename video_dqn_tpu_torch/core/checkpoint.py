"""`sample<N>.ckpt` checkpoints in the JAX package's format
(counterpart of video_dqn_tpu/core/checkpoint.py).

A checkpoint is the Flax msgpack form of {"sample_number": N, "state":
tree}, where the tree is a TrainState state dict of numpy leaves
(train/dqn.py `flax_state_dict`), written atomically (tmp + rename) so a
crash mid-write never corrupts the latest snapshot. Either package reads
what the other writes."""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

from .msgpack import packb, unpackb


def checkpoint_path(models_dir: str, step: int) -> str:
    return os.path.join(models_dir, f"sample{step}.ckpt")


def save_checkpoint(models_dir: str, step: int, tree: Dict[str, Any]) -> str:
    os.makedirs(models_dir, exist_ok=True)
    payload = packb({"sample_number": step, "state": tree})
    path = checkpoint_path(models_dir, step)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, path)
    return path


def latest_checkpoint_step(models_dir: str) -> Optional[int]:
    if not os.path.isdir(models_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(models_dir)
             if (m := re.match(r"^sample(\d+)\.ckpt$", f))]
    return max(steps) if steps else None


def restore_checkpoint(models_dir: str, step: int) -> Dict[str, Any]:
    """The state tree of sample<step>.ckpt (numpy leaves)."""
    with open(checkpoint_path(models_dir, step), "rb") as f:
        raw = unpackb(f.read())
    if int(raw["sample_number"]) != step:
        raise ValueError(f"sample{step}.ckpt holds sample_number {raw['sample_number']}")
    return raw["state"]
