"""Training scalars as newline-delimited JSON, `<run dir>/metrics.jsonl`
(counterpart of video_dqn_tpu/core/metrics.py, which also mirrors them to
tensorboardX when it is installed; the port writes the JSON lines only)."""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional


class MetricsWriter:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a", buffering=1)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._jsonl.write(json.dumps({"tag": tag, "value": float(value), "step": int(step),
                                      "ts": time.time()}) + "\n")

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
