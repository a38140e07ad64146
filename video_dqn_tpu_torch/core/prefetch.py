"""Host-fed infeed: numpy batches to the card `depth` batches ahead
(counterpart of video_dqn_tpu/core/prefetch.py `prefetch_to_device`).

A producer thread pulls batches from the host iterator (decode, gather),
copies each into pinned host buffers and starts its host-to-device copies
with non_blocking on a copy stream of its own, so that the copies overlap
the train step running on the current stream. The consumer makes the
current stream wait for a batch's copy before it hands the batch out. On
the CPU the batches are wrapped as tensors and nothing is copied."""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch


def _pinned_copy(batch: Dict[str, np.ndarray], device: torch.device,
                 stream) -> Dict[str, torch.Tensor]:
    out = {}
    with torch.cuda.stream(stream):
        for k, v in batch.items():
            host = torch.empty(v.shape, dtype=torch.from_numpy(v[:0]).dtype, pin_memory=True)
            host.numpy()[...] = v
            # the caching host allocator keeps `host` until this copy is done
            out[k] = host.to(device, non_blocking=True)
    return out


def prefetch_to_device(batches: Iterator[Dict[str, np.ndarray]], device: torch.device,
                       depth: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield the batches of `batches` (dicts of numpy arrays) as dicts of
    tensors on `device`, with up to `depth` batches copied or in copy
    ahead of the one handed out. Closing the generator stops the
    producer."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in batches:
            yield {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        return
    stream = torch.cuda.Stream(device)
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        """q.put that gives up once the consumer has stopped."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            with torch.cuda.device(device):
                for batch in batches:
                    if stop.is_set():
                        return
                    tensors = _pinned_copy(batch, device, stream)
                    ready = torch.cuda.Event()
                    ready.record(stream)
                    if not put((tensors, ready)):
                        return
            put(done)
        except Exception as e:  # raised in the consumer
            put(e)

    thread = threading.Thread(target=producer, name="prefetch_to_device", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, Exception):
                raise item
            tensors, ready = item
            current = torch.cuda.current_stream(device)
            current.wait_event(ready)
            for t in tensors.values():
                t.record_stream(current)  # made on the copy stream, used on this one
            yield tensors
    finally:
        stop.set()
        thread.join(timeout=60)
