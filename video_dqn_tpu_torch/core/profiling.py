"""Tracing and step timing (counterpart of video_dqn_tpu/core/profiling.py):
`trace`, a torch.profiler trace of a block written as a Chrome trace (the
evaluate CLI's -p), and `StepTimer`, which writes each timed section's
seconds and items/s through a MetricsWriter (core/metrics.py) under the
JAX package's tags."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

from torch.profiler import ProfilerActivity, profile

from .._device import resolve_device


@contextlib.contextmanager
def trace(path: str, device=None):
    """Profile the block (the host, and CUDA activity unless `device` is
    the CPU; None: the card, which raises without CUDA) and write its
    Chrome trace to `path`, whose folder is made. Yields the profiler."""
    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    prof.export_chrome_trace(path)


class StepTimer:
    """Host-clock timer of named sections; each stop writes
    `<prefix>/<tag>_sec` and, for more than one item,
    `<prefix>/<tag>_items_per_sec` through `writer`, and adds to the
    tag's total."""

    def __init__(self, writer=None, prefix: str = "perf"):
        self.writer = writer
        self.prefix = prefix
        self._t0: Optional[float] = None
        self._count = 0
        self._totals: Dict[str, float] = {}

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, step: int, items: int = 1, tag: str = "step") -> float:
        dt = time.perf_counter() - self._t0
        self._count += 1
        self._totals[tag] = self._totals.get(tag, 0.0) + dt
        if self.writer is not None:
            self.writer.add_scalar(f"{self.prefix}/{tag}_sec", dt, step)
            if items > 1:
                self.writer.add_scalar(f"{self.prefix}/{tag}_items_per_sec", items / dt, step)
        return dt

    @contextlib.contextmanager
    def section(self, step: int, tag: str, items: int = 1):
        self.start()
        yield
        self.stop(step, items, tag)

    def summary(self) -> Dict[str, float]:
        """Total seconds a tag."""
        return dict(self._totals)
