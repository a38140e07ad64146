"""ROIAlign as plain torch gathers (counterpart of
video_dqn_tpu/models/detector/roi_align.py, which is plain jnp too).

torchvision's semantics with aligned=False and sampling ratio 2: an ROI is
cut into out x out bins, each bin sampled at a 2 x 2 grid of bilinear
taps that are averaged; a tap outside the map is clamped to its edge, as
in the JAX package.

`multilevel_roi_align` assigns each ROI its FPN level (canonical size 224
at level 2 of P2..P5) and pools it from that level only. The JAX form
pools every ROI at all four levels and then picks one; this is the same
function at a quarter of the work, and without the four-level
intermediate, which for a 12-view stop of 1,000 ROIs an image would take
gigabytes. All levels of all images sit in one channels-last table of
(positions, C), and each tap gathers its row there: no per-level
selection, and the levels' sizes, offsets and scales are made on the
device once a shape, so no host synchronization.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Sequence, Tuple

import torch


def _bilinear_rows(y: torch.Tensor, x: torch.Tensor, h, w):
    """The four (row offset, weight) pairs of bilinear taps at (y, x) on an
    h x w map, clamped as the JAX package clamps: y to [0, h - 1] and x to
    [0, w - 1]. h and w are scalars or tensors broadcasting with y, x."""
    y = torch.clamp(torch.clamp(y, min=0.0), max=h - 1.0)
    x = torch.clamp(torch.clamp(x, min=0.0), max=w - 1.0)
    y0, x0 = torch.floor(y), torch.floor(x)
    y1 = torch.clamp(y0 + 1, max=h - 1.0)
    x1 = torch.clamp(x0 + 1, max=w - 1.0)
    wy1, wx1 = y - y0, x - x0
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1
    w_int = w if isinstance(w, (int, float)) else w.long()
    rows = lambda yy, xx: yy.long() * w_int + xx.long()  # noqa: E731
    return ((rows(y0, x0), wy0 * wx0), (rows(y0, x1), wy0 * wx1),
            (rows(y1, x0), wy1 * wx0), (rows(y1, x1), wy1 * wx1))


def _sample_grid(rois: torch.Tensor, scale, out_size: int, sampling_ratio: int):
    """Tap coordinates of each ROI (R, 4) in a map scaled by `scale` (a
    scalar or (R,)): ys (R, out*ratio) and xs (R, out*ratio), bin-major."""
    box = rois * (scale[:, None] if torch.is_tensor(scale) else scale)
    x1, y1, x2, y2 = box.unbind(-1)
    rw = torch.clamp(x2 - x1, min=1.0)
    rh = torch.clamp(y2 - y1, min=1.0)
    bin_h, bin_w = rh / out_size, rw / out_size
    i = torch.arange(out_size, device=rois.device, dtype=rois.dtype)
    s = torch.arange(sampling_ratio, device=rois.device, dtype=rois.dtype)
    frac = (i[:, None] + (s[None, :] + 0.5) / sampling_ratio).reshape(-1)  # (out*ratio,)
    return y1[:, None] + frac * bin_h[:, None], x1[:, None] + frac * bin_w[:, None]


def _pool(table: torch.Tensor, base: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
          h, w, out_size: int, sampling_ratio: int) -> torch.Tensor:
    """Average the bilinear taps of the grid ys x xs ((R, out*ratio) each)
    over each bin, reading rows `base + y * w + x` of `table` (N, C).
    Returns (R, out, out, C) in float32 (or the table's type if wider).
    One gather of (R * out * out, C) a tap and corner at a time, so the
    largest intermediate is one such gather."""
    r, k = ys.shape
    c = table.shape[1]
    ys = ys[:, :, None].expand(r, k, k)
    xs = xs[:, None, :].expand(r, k, k)
    hh = h if isinstance(h, (int, float)) else h[:, None, None]
    ww = w if isinstance(w, (int, float)) else w[:, None, None]
    out = torch.zeros((r, out_size, out_size, c), dtype=torch.promote_types(
        table.dtype, torch.float32), device=table.device)
    for sy in range(sampling_ratio):
        for sx in range(sampling_ratio):
            y = ys[:, sy::sampling_ratio, sx::sampling_ratio]
            x = xs[:, sy::sampling_ratio, sx::sampling_ratio]
            for rows, weight in _bilinear_rows(y, x, hh, ww):
                rows = rows + base.view(-1, 1, 1)
                taps = table.index_select(0, rows.reshape(-1)).view(r, out_size, out_size, c)
                out.add_(taps * weight[..., None])
    return out / (sampling_ratio * sampling_ratio)


def roi_align(feat: torch.Tensor, rois: torch.Tensor, spatial_scale: float,
              out_size: int = 7, sampling_ratio: int = 2) -> torch.Tensor:
    """feat (H, W, C) one map, rois (R, 4) in image pixels ->
    (R, out_size, out_size, C), the JAX package's layout."""
    h, w, c = feat.shape
    ys, xs = _sample_grid(rois, spatial_scale, out_size, sampling_ratio)
    base = torch.zeros(rois.shape[0], dtype=torch.long, device=rois.device)
    return _pool(feat.reshape(h * w, c), base, ys, xs, h, w, out_size, sampling_ratio)


def roi_levels(rois: torch.Tensor, num_levels: int, canonical_level: int = 2,
               canonical_size: float = 224.0) -> torch.Tensor:
    """FPN level of each ROI (FPN paper eq. 1, as in torchvision):
    floor(canonical + log2(sqrt(area) / canonical_size + 1e-9)), clamped to
    0..num_levels-1."""
    areas = (rois[..., 2] - rois[..., 0]) * (rois[..., 3] - rois[..., 1])
    target = torch.floor(canonical_level + torch.log2(
        torch.sqrt(torch.clamp(areas, min=1e-6)) / canonical_size + 1e-9))
    return torch.clamp(target, 0, num_levels - 1).to(torch.long)


@lru_cache(maxsize=64)
def _level_tables(shapes: Tuple[Tuple[int, int, int], ...], strides: Tuple[int, ...],
                  dtype: torch.dtype, device: torch.device):
    """Each level's (h, w), first row in the table and scale, for maps of
    (B, h, w) `shapes`: made once a shape and kept on the device (a tensor
    from host lists at every call would be a copy that synchronizes)."""
    sizes = torch.tensor([[h, w] for _, h, w in shapes], device=device)
    starts = torch.tensor([0] + [b * h * w for b, h, w in shapes], device=device).cumsum(0)[:-1]
    scales = torch.tensor([1.0 / s for s in strides], dtype=dtype, device=device)
    return sizes, starts, scales


def multilevel_roi_align(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                         strides: Sequence[int], out_size: int = 7,
                         sampling_ratio: int = 2) -> torch.Tensor:
    """feats: the FPN maps, (B, C, H_l, W_l) each; rois (B, R, 4) in image
    pixels -> (B*R, C, out_size, out_size), each ROI pooled from its
    assigned level only (the layout torchvision's box head flattens)."""
    b, r, _ = rois.shape
    c = feats[0].shape[1]
    dev = rois.device
    # one channels-last table of every level of every image
    table = torch.cat([f.permute(0, 2, 3, 1).reshape(-1, c) for f in feats])
    sizes, starts, scales = _level_tables(
        tuple((f.shape[0], f.shape[2], f.shape[3]) for f in feats), tuple(strides),
        rois.dtype, dev)
    flat = rois.reshape(b * r, 4)
    level = roi_levels(flat, len(feats))
    h, w = sizes[level, 0], sizes[level, 1]
    image = torch.arange(b, device=dev).repeat_interleave(r)
    base = starts[level] + image * h * w
    ys, xs = _sample_grid(flat, scales[level], out_size, sampling_ratio)
    pooled = _pool(table, base, ys, xs, h.to(rois.dtype), w.to(rois.dtype), out_size,
                   sampling_ratio)
    return pooled.permute(0, 3, 1, 2)
