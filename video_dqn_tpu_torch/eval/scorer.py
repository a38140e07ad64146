"""Panorama scorers: uint8 views -> one Q-value per view (counterparts of
video_dqn_tpu/eval/evaluate.py `make_model_scorer` and
video_dqn_tpu/eval/batched_runner.py `make_multiclass_scorer`).

Every call runs the fused resize+normalize kernel on the views (an exact
identity resample when they are already at model size), then the Q-net,
and returns the max over actions of the Q of each view's goal class. On
the card the kernel writes bf16 and the forward runs under bf16 autocast
with float32 parameters; the scores come back as float32. On the CPU
(tests) everything runs in float32.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Callable

import numpy as np
import torch

from .._device import resolve_device
from ..ops.resize_normalize import resize_normalize


def q_values(model, images: torch.Tensor, image_size: int) -> torch.Tensor:
    """images: uint8 (B, F, H, W, 3) on the model's device -> the Q-net's
    (B, classes, actions) float32."""
    b, f = images.shape[0], images.shape[1]
    on_card = images.device.type == "cuda"
    # on the card the kernel writes bf16, which the first convolution reads
    # as it is, in place of autocast's cast of a float32 input
    x = resize_normalize(images.reshape((b * f,) + images.shape[2:]), image_size,
                         torch.bfloat16 if on_card else torch.float32)
    # (B*F, 3, S, S) channels_last is (B*F, S, S, 3) contiguous: both views
    x = x.permute(0, 2, 3, 1).reshape(b, f, image_size, image_size, 3)
    with torch.autocast(images.device.type, dtype=torch.bfloat16, enabled=on_card):
        return model(x)


def _scores(model, images: torch.Tensor, cls: torch.Tensor,
            image_size: int) -> torch.Tensor:
    """images: uint8 (B, F, H, W, 3) on the model's device; cls: (B,)."""
    q = q_values(model, images, image_size)
    return q[torch.arange(q.shape[0], device=q.device), cls].amax(dim=-1)


def as_views(images) -> np.ndarray:
    """uint8 (V, H, W, 3) or (V, F, H, W, 3) views as (V, F, H, W, 3)."""
    x = np.asarray(images)
    if x.ndim == 4:  # (V, H, W, 3) single-frame
        x = x[:, None]
    if x.dtype != np.uint8 or x.ndim != 5 or x.shape[-1] != 3:
        raise ValueError(f"views must be uint8 (V, F, H, W, 3), got "
                         f"{x.dtype} {x.shape}")
    return x


def place(model, device) -> torch.device:
    """Move `model` to `device` (None: the card) in channels_last, in eval
    mode; returns the device."""
    device = resolve_device(device)
    model.to(device, memory_format=torch.channels_last).eval()
    return device


def make_model_scorer(model, class_index: int, image_size: int = 224,
                      device=None) -> Callable:
    """Batched panorama scorer for one goal class: uint8 (V, F, H, W, 3)
    -> (V,) float32. ONE forward for all V views. Moves `model` to
    `device` (None: the card)."""
    device = place(model, device)

    def scorer(images_uint8) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(as_views(images_uint8))).to(device)
        cls = torch.full((x.shape[0],), class_index, device=device)
        with torch.no_grad():
            return _scores(model, x, cls, image_size).cpu().numpy()

    return scorer


def bucket_size(b: int) -> int:
    """Smallest 12*2^k >= b (12 is a reasoning stop's view count)."""
    target = 12
    while target < b:
        target *= 2
    return target


def make_multiclass_scorer(model, image_size: int = 224, bucket: bool = True,
                           device=None, devices=None) -> Callable:
    """Scorer for the batched runner: uint8 (B, F, H, W, 3) + (B,) class
    indices -> (B,) float32 max-over-actions Q of each view's own class,
    one forward for everything. Moves `model` to `device` (None: the card).

    `bucket` pads each ragged batch to the next 12*2^k rows by repeating
    the last row, so the card sees O(log K) shapes; pad scores are sliced
    off. `.dispatch` is non-blocking on the card: it copies through a
    pinned host buffer, enqueues the forward and the copy back to a pinned
    buffer, and records an event; `.gather` waits on that event.

    With `devices` (a list, which takes the place of `device`; JAX's scorer
    takes a mesh) the scorer is data parallel in this one process: `model`
    on the first device and a copy on each other, the batch padded to a multiple of their count (JAX's
    `target += (-target) % n_shard`), split into contiguous chunks, one a
    device, each dispatched without blocking, gathered in order."""
    devices = devices or [device]
    replicas = [model] + [copy.deepcopy(model) for _ in devices[1:]]
    places = [place(m, d) for m, d in zip(replicas, devices)]
    on_card = places[0].type == "cuda"
    n = len(replicas)

    def dispatch(images, cls):
        x = as_views(images)
        c = np.asarray(cls, np.int64).reshape(-1)
        b = x.shape[0]
        if c.shape != (b,):
            raise ValueError(f"need one class per view: {c.shape} for {b} views")
        if b == 0 or c.min() < 0 or c.max() >= model.num_classes:
            raise ValueError(f"bad request: {b} views, classes {c}")
        target = bucket_size(b) if bucket else b
        target += (-target) % n
        host_x = torch.empty((target,) + x.shape[1:], dtype=torch.uint8,
                             pin_memory=on_card)
        host_c = torch.empty((target,), dtype=torch.int64, pin_memory=on_card)
        host_x.numpy()[:b] = x
        host_x.numpy()[b:] = x[-1]
        host_c.numpy()[:b] = c
        host_c.numpy()[b:] = c[-1]
        chunk = target // n
        scores = []
        for i, (net, dev) in enumerate(zip(replicas, places)):
            rows = slice(i * chunk, (i + 1) * chunk)
            with torch.cuda.device(dev) if on_card else contextlib.nullcontext(), \
                    torch.no_grad():
                scores.append(_scores(net, host_x[rows].to(dev, non_blocking=True),
                                      host_c[rows].to(dev, non_blocking=True), image_size))
        if not on_card:
            return torch.cat(scores), [], b, (host_x, host_c)
        out = torch.empty((target,), dtype=scores[0].dtype, pin_memory=True)
        done = []
        for i, (s, dev) in enumerate(zip(scores, places)):
            with torch.cuda.device(dev):
                out[i * chunk:(i + 1) * chunk].copy_(s, non_blocking=True)
                done.append(torch.cuda.Event())
                done[-1].record()
        # the host buffers ride in the handle until the copies are done
        return out, done, b, (host_x, host_c)

    def gather(handle) -> np.ndarray:
        out, done, b, _ = handle
        for event in done:
            event.synchronize()
        return out[:b].numpy()

    def scorer(images, cls) -> np.ndarray:
        return gather(dispatch(images, cls))

    scorer.dispatch = dispatch
    scorer.gather = gather
    return scorer
