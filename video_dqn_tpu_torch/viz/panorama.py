"""Panorama strips and the value/distance analysis (counterpart of
video_dqn_tpu/viz/panorama.py).

`join_images` lays out the episode strip as the JAX package does: each
view centre-cropped to 2 * int((4/N - 0.05) * W / 2) columns, the views
in reverse order, the last column of each crop black; with `values`, a
50-px white caption row below it: each view's "%.2f" in a tile of its own
(so a long value clips at its crop), `bl_text` bottom left and `br_text`
right-aligned bottom right, drawn by viz/text.py pixel-equal to the JAX
package's cv2 text.

`make_allclass_scorer` scores views for every class in one forward, with
the resize+normalize kernel as its prologue (identity at the model's
size, banded at any other). `vis_panorama` computes JAX's per-class
correlations of each heading's value with its geodesic distance drop, and
draws its figure as a uint8 image where JAX draws a matplotlib figure:
the strip over one row of Wistia cells a class, each cell's value centred
in it, and each class's `name r=...` label right-aligned in a left margin.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..data.png import save_png
from ..eval.scorer import as_views, place, q_values
from . import colormaps
from .text import put_text, text_width

# the figure's rows: the strip, then one value row a class (JAX's height ratios)
STRIP_RATIO, ROW_RATIO = 6.0, 0.5
CAPTION_H = 50  # the white caption row under a strip with values
DIGIT_H = 11    # a digit's ink rises this far above the baseline
LABEL_PAD = 3   # white columns on either side of a class label


def _caption_tile(width: int, text: str, org) -> np.ndarray:
    """A white caption tile with `text` at `org`, clipped to the tile."""
    return put_text(np.full((CAPTION_H, width, 3), 255, np.uint8), text, org)


def join_images(ims: Sequence[np.ndarray], values: Optional[Sequence[float]] = None,
                br_text: str = "", bl_text: str = "") -> np.ndarray:
    """The uint8 strip of `ims` ((H, W, 3) views of one size), right to
    left, as JAX's join_images; with `values` (one a view, in the views'
    order) the caption row below it."""
    views = list(ims)[::-1]
    n = len(views)
    src_w = views[0].shape[1]
    half = int(((4.0 / n) - 0.05) * src_w / 2)
    crop_w = 2 * half
    center = src_w // 2
    strip = np.concatenate(
        [v[:, center - half:center + half] for v in views], axis=1).copy()
    strip[:, crop_w - 1::crop_w] = 0  # per-view separator columns
    if values is None:
        return strip
    caption = np.concatenate(
        [_caption_tile(crop_w, f"{v:.2f}", (15, 20)) for v in reversed(list(values))], axis=1)
    put_text(caption, br_text, (caption.shape[1] - text_width(br_text) - 10, 40))
    put_text(caption, bl_text, (10, 40))
    return np.concatenate((strip, caption), axis=0)


def panorama_strip(env, scorer=None, num_rotations: int = 12):
    """A full in-place rotation of `env`: (strip, scores). With a
    `scorer` ((V, H, W, 3) uint8 views -> (V,) scores) the strip is
    captioned with the negated scores, as JAX's is; else scores is None."""
    views = []
    for _ in range(num_rotations):
        ims, _, _, _ = env.step(1)
        rgb = np.asarray(ims["rgb"])
        views.append(rgb[0] if rgb.ndim == 4 else rgb)
    scores = None if scorer is None else np.asarray(scorer(np.stack(views)))
    return join_images(views, None if scores is None else -scores), scores


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
    as imshow's autoscale does, with each cell's "%.2f" centred in it and
    clipped to it."""
    rows = []
    for row in values:
        x = colormaps.normalize(row, np.nanmin(row), np.nanmax(row)) \
            if np.isfinite(row).any() else np.full(row.shape, np.nan)
        rgb = (colormaps.apply(colormaps.WISTIA, x) * 255).astype(np.uint8)
        band = np.repeat(np.repeat(rgb[None], height, axis=0), width, axis=1)
        for i, v in enumerate(row):
            text = f"{v:.2f}"
            put_text(band[:, i * width:(i + 1) * width], text,
                     ((width - text_width(text)) // 2, (height + DIGIT_H) // 2))
        rows.append(band)
    return np.concatenate(rows, axis=0)


def class_labels(names: Sequence[str], corrs: np.ndarray) -> list:
    """Each class's row label as JAX sets it: `name r=0.12`, `r=0.12`
    without a name, the name alone where the correlation is NaN."""
    labels = []
    for name, corr in zip(names, corrs):
        if np.isfinite(corr):
            labels.append(f"{name} r={corr:.2f}" if name else f"r={corr:.2f}")
        else:
            labels.append(name)
    return labels


def label_margin(labels: Sequence[str], top: int, row_h: int) -> np.ndarray:
    """The white left margin of the figure, as wide as the widest label
    and LABEL_PAD on either side (none without labels): the label of row
    c right-aligned and centred on it, clipped to its row."""
    widest = max((text_width(t) for t in labels), default=0)
    margin = np.full((top + row_h * len(labels), widest + 2 * LABEL_PAD if widest else 0, 3),
                     255, np.uint8)
    for c, text in enumerate(labels):
        band = margin[top + c * row_h:top + (c + 1) * row_h]
        put_text(band, text, (margin.shape[1] - LABEL_PAD - text_width(text),
                              (row_h + DIGIT_H) // 2))
    return margin


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
    (heights 6 : 0.5), each cell's value in it, and a left margin with
    each row's label (`class_labels` of `class_names`), written to
    `out_path` as a PNG when given."""
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
    labels = class_labels(list(class_names) if class_names else [""] * n_classes, corrs)
    figure = np.concatenate([label_margin(labels, joined.shape[0], row_h), figure], axis=1)
    if out_path:
        save_png(out_path, figure)
    return figure, corrs
