"""Crash-safe sharded result logger (counterpart of
video_dqn_tpu/core/disk_logger.py `DiskLogger`, `DiskReader`; shards
written by either package read in the other).

Each logger keeps its results in a dict and rewrites its own
uniquely-named shard on every `write` (np.save of the dict as a 1-element
object array, through a temporary file and one rename); shards rotate
after `checkpoint_time` seconds, so a crash loses at most one rotation
window. The reader merges every shard in mtime order (last writer wins),
which makes evaluation runs resumable and mergeable across processes.
"""

from __future__ import annotations

import os
import secrets
import time
from typing import Any, Dict

import numpy as np


class DiskLogger:
    def __init__(self, folder: str, checkpoint_time: float = 60 * 30):
        self.folder = folder
        self.checkpoint_time = checkpoint_time
        os.makedirs(folder, exist_ok=True)
        self._data: Dict[Any, Any] = {}
        self._new_shard()

    def _new_shard(self) -> None:
        self._shard_start = time.time()
        self._shard_id = f"{secrets.token_hex(8)}_{int(self._shard_start)}"
        self._data = {}

    @property
    def shard_path(self) -> str:
        return os.path.join(self.folder, f"{self._shard_id}.npy")

    def write(self, key: Any, value: Any) -> None:
        if time.time() - self._shard_start > self.checkpoint_time:
            self._new_shard()
        self._data[key] = value
        tmp = self.shard_path + ".tmp.npy"
        np.save(tmp, np.array([self._data], dtype=object), allow_pickle=True)
        os.replace(tmp, self.shard_path)


class DiskReader:
    def __init__(self, folder: str):
        self.folder = folder

    def data(self) -> Dict[Any, Any]:
        if not os.path.isdir(self.folder):
            return {}
        shards = [
            os.path.join(self.folder, f)
            for f in os.listdir(self.folder)
            if f.endswith(".npy") and not f.endswith(".tmp.npy")
        ]
        shards.sort(key=os.path.getmtime)
        merged: Dict[Any, Any] = {}
        for path in shards:
            try:
                d = np.load(path, allow_pickle=True)[0]
            except Exception:
                continue  # a shard torn by a crash is skipped
            merged.update(d)
        return merged
