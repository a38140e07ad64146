"""Stall watchdog for long device-bound loops (counterpart of
video_dqn_tpu/core/watchdog.py `StallWatchdog`).

A training loop blocks at many points (a step's launch once the card's
queue is full, the host's read of the EMA loss at a log point, the copy to
the host at a checkpoint), so no single call can be wrapped with a
timeout. The loop `beat()`s on every iteration instead, and a daemon
thread fires when no beat lands within the deadline: it prints what to do
and `os._exit`s non-zero, since a normal exit would wait forever on the
very call that hung. The first deadline is separate (and may be longer) to
cover the first step's start-up work. With checkpoints on disk, the exit
composes with `train_q_network -r` into a restart that loses little.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Callable, Optional


class StallWatchdog:
    """Fire `on_stall(elapsed_s)` (default: print + os._exit(exit_code))
    when no `beat()` arrives within the deadline. Deadline is
    `first_timeout_s` until the first beat, then `timeout_s`. `stop()`
    disarms permanently."""

    def __init__(
        self,
        timeout_s: float,
        label: str = "train",
        first_timeout_s: Optional[float] = None,
        on_stall: Optional[Callable[[float], None]] = None,
        exit_code: int = 3,
    ):
        self.timeout_s = float(timeout_s)
        self.first_timeout_s = (
            float(first_timeout_s) if first_timeout_s is not None
            else self.timeout_s
        )
        self._label = label
        self._on_stall = on_stall
        self._exit_code = exit_code
        self._beaten = False
        self._last = time.monotonic()
        self._stop = threading.Event()
        # poll well inside the smallest deadline so a fire is never late by
        # more than ~20% of it
        self._poll_s = max(0.05, min(self.timeout_s, self.first_timeout_s) / 5.0)
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"stall-watchdog-{label}")
        self._thread.start()

    def beat(self) -> None:
        self._last = time.monotonic()
        self._beaten = True

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            deadline = self.timeout_s if self._beaten else self.first_timeout_s
            elapsed = time.monotonic() - self._last
            if elapsed > deadline:
                # stop() may have landed between the wait() and this check
                # (the loop returned from a slow final sync just as the
                # deadline crossed): never fire after disarm
                if self._stop.is_set():
                    return
                if self._on_stall is not None:
                    self._on_stall(elapsed)
                    return
                print(
                    f"[{self._label}] stall watchdog: no progress for "
                    f"{elapsed:.0f}s (deadline {deadline:.0f}s) — "
                    "device failure suspected. Checkpoints already "
                    "written are on disk; rerun with -r to resume from the "
                    "latest sample<N>.",
                    file=sys.stderr,
                    flush=True,
                )
                os._exit(self._exit_code)
