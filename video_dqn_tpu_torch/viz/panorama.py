"""Panorama strips and the value/distance analysis (counterpart of
video_dqn_tpu/viz/panorama.py).

`join_images` lays out the episode strip as the JAX package does: each
view centre-cropped to 2 * int((4/N - 0.05) * W / 2) columns, the views
in reverse order, the last column of each crop black. Its captions (the
per-view values and the two labels, cv2 text) are ROADMAP.md queue 1 item
8b: `join_images(..., values=...)` and `panorama_strip` with a scorer
raise NotImplementedError until then.

`make_allclass_scorer` scores views for every class in one forward, with
the resize+normalize kernel as its prologue (identity at the model's
size, banded at any other). `vis_panorama` computes JAX's per-class
correlations of each heading's value with its geodesic distance drop, and
draws its figure without text as a uint8 image: the strip over one row of
Wistia cells a class.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..data.png import save_png
from ..eval.scorer import as_views, place, q_values
from . import colormaps

# the figure's rows: the strip, then one value row a class (JAX's height ratios)
STRIP_RATIO, ROW_RATIO = 6.0, 0.5


def _captions_unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what}: the strip's captions (cv2 text) are not ported to "
        "video_dqn_tpu_torch yet (ROADMAP.md, queue 1, item 8b)")


def join_images(ims: Sequence[np.ndarray], values: Optional[Sequence[float]] = None,
                br_text: str = "", bl_text: str = "") -> np.ndarray:
    """The uint8 strip of `ims` ((H, W, 3) views of one size), right to
    left, as JAX's join_images without captions."""
    if values is not None:
        raise _captions_unported("join_images(values=...)")
    views = list(ims)[::-1]
    n = len(views)
    src_w = views[0].shape[1]
    half = int(((4.0 / n) - 0.05) * src_w / 2)
    crop_w = 2 * half
    center = src_w // 2
    strip = np.concatenate(
        [v[:, center - half:center + half] for v in views], axis=1).copy()
    strip[:, crop_w - 1::crop_w] = 0  # per-view separator columns
    return strip


def panorama_strip(env, scorer=None, num_rotations: int = 12):
    """A full in-place rotation of `env` as (strip, None). With a scorer
    the JAX package captions the strip with the views' values, which
    raises here (item 8b) before the env is touched."""
    if scorer is not None:
        raise _captions_unported("panorama_strip(scorer=...)")
    views = []
    for _ in range(num_rotations):
        ims, _, _, _ = env.step(1)
        rgb = np.asarray(ims["rgb"])
        views.append(rgb[0] if rgb.ndim == 4 else rgb)
    return join_images(views), None


def min_dists(env, goals_by_class, point=None) -> np.ndarray:
    """Per-class min geodesic distance from `point` (default: the agent)
    to each class's goals; inf for a class with no goals."""
    if point is None:
        point = env.agent_state()[0]
    out = []
    for goals in goals_by_class:
        if len(goals) == 0:
            out.append(float("inf"))
        else:
            out.append(min(env.geodesic_distance(point, g) for g in goals))
    return np.array(out, np.float64)


def make_allclass_scorer(model, image_size: int = 224, device=None) -> Callable:
    """uint8 (V, H, W, 3) or (V, F, H, W, 3) views -> (V, C) float32
    max-over-actions Q of every class, one forward a call. Moves `model`
    to `device` (None: the card) in eval mode. On the card the views go
    through a pinned host buffer (kept per shape), the kernel writes bf16
    and the forward runs under bf16 autocast; on the CPU all is float32."""
    device = place(model, device)
    on_card = device.type == "cuda"
    staging = {}

    def scorer(images_uint8) -> np.ndarray:
        x = as_views(images_uint8)
        if x.shape not in staging:
            staging.clear()
            staging[x.shape] = torch.empty(x.shape, dtype=torch.uint8, pin_memory=on_card)
        host = staging[x.shape]
        host.numpy()[...] = x
        with torch.no_grad():
            q = q_values(model, host.to(device, non_blocking=True), image_size)
            # the copy back waits for the forward, and so frees `host` again
            return q.amax(dim=-1).cpu().numpy()

    return scorer


def value_rows(values: np.ndarray, width: int, height: int) -> np.ndarray:
    """(C, N) values -> uint8 (C * height, N * width, 3): one row of
    Wistia cells a class, each row normalised over its own min and max,
    as imshow's autoscale does."""
    rows = []
    for row in values:
        x = colormaps.normalize(row, np.nanmin(row), np.nanmax(row)) \
            if np.isfinite(row).any() else np.full(row.shape, np.nan)
        rgb = (colormaps.apply(colormaps.WISTIA, x) * 255).astype(np.uint8)
        rows.append(np.repeat(np.repeat(rgb[None], height, axis=0), width, axis=1))
    return np.concatenate(rows, axis=0)


def vis_panorama(env, scorer_all, goals_by_class, num: int = 12, log: bool = False,
                 class_names: Optional[Sequence[str]] = None,
                 out_path: Optional[str] = None, probe_steps: int = 1):
    """The value/distance analysis at the agent's pose, as JAX's
    vis_panorama computes it: for each of `num` headings the view, then
    `probe_steps` forward steps and each class's drop in geodesic
    distance; every view scored in one `scorer_all` call ((num, C) values,
    log-scaled with `log`); corrs[c] = corrcoef(values[:, c],
    dist_drop[:, c]), NaN where a class has no goals or either side is
    flat. The agent is restored. Returns (figure, corrs): the figure is
    the uint8 image of `join_images(views)` over one Wistia row a class
    (heights 6 : 0.5), written to `out_path` as a PNG when given. The
    cell numbers and the class and r= labels wait for item 8b;
    `class_names` is taken for the JAX signature."""
    pos, rot = env.agent_state()
    n_classes = len(goals_by_class)
    base_dists = min_dists(env, goals_by_class, pos)

    views, dist_diffs = [], []
    for k in range(num):
        ang = rot + 2.0 * math.pi * k / num
        env.set_agent_state(pos, ang)
        rgb = np.asarray(env.get_observation()["rgb"])
        views.append(rgb[0] if rgb.ndim == 4 else rgb)
        for _ in range(probe_steps):
            env.step(0)
        dist_diffs.append(base_dists - min_dists(env, goals_by_class))
        env.set_agent_state(pos, ang)  # undo the probe steps
    env.set_agent_state(pos, rot)

    values = np.asarray(scorer_all(np.stack(views)), np.float64)  # (num, C)
    assert values.shape == (num, n_classes), values.shape
    if log:
        values = np.log(values)
    dist_diffs = np.stack(dist_diffs)

    corrs = np.full(n_classes, np.nan)
    for c in range(n_classes):
        d, v = dist_diffs[:, c], values[:, c]
        if np.all(np.isfinite(d)) and d.std() > 0 and v.std() > 0:
            corrs[c] = float(np.corrcoef(v, d)[0, 1])

    joined = join_images(views)
    cell_w = joined.shape[1] // num
    row_h = max(1, int(round(joined.shape[0] * ROW_RATIO / STRIP_RATIO)))
    # reversed view order, as the strip runs
    figure = np.concatenate([joined, value_rows(values[::-1].T, cell_w, row_h)], axis=0)
    if out_path:
        save_png(out_path, figure)
    return figure, corrs
