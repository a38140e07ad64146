"""Training scalars as newline-delimited JSON, `<run dir>/metrics.jsonl`,
and images as `<run dir>/<tag with "/" -> "_">_<step>.png` (counterpart of
video_dqn_tpu/core/metrics.py, which also mirrors both to tensorboardX when
it is installed; the port writes the files only). A failed image write
raises with its path, where the JAX package passes over it."""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional

from ..data.png import save_png


class MetricsWriter:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a", buffering=1)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._jsonl.write(json.dumps({"tag": tag, "value": float(value), "step": int(step),
                                      "ts": time.time()}) + "\n")

    def add_image(self, tag: str, image, step: int) -> str:
        """Write an HWC (or HW) uint8 image as a PNG next to the jsonl;
        returns its path."""
        path = os.path.join(self.log_dir, f"{tag.replace('/', '_')}_{step}.png")
        save_png(path, image)
        return path

    def flush(self) -> None:
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()


def read_metrics(log_dir: str, tag: Optional[str] = None) -> List[dict]:
    """The scalars in log_dir/metrics.jsonl, of one tag or all."""
    path = os.path.join(log_dir, "metrics.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        records = [json.loads(line) for line in f]
    return [r for r in records if tag is None or r["tag"] == tag]
