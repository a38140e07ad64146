"""Fused uint8 resize + ImageNet normalize: the prologue of every scorer
call, and the port of the repo's one TPU kernel
(video_dqn_tpu/ops/pallas_image.py `resize_normalize_pallas`).

uint8 NHWC frames (B, H, W, 3) become the normalized float32 tensor the
trunk reads, (B, 3, OUT, OUT) NCHW in channels_last memory. The resample
is the antialiased triangle filter of `resize_matrix` (half-pixel
centres, edge-clamped taps, rows normalized to 1); at OUT == H == W the
matrix is exactly the identity, so the same kernel also replaces the
plain `x / 255` normalize at model size.

On a CUDA tensor `resize_normalize` launches the hand-written kernel in
csrc/resize_normalize.cu (and counts it in `LAUNCHES`) or raises; on a
CPU tensor it runs `resize_normalize_reference`, the plain torch twin
built from the same dense matrices.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from .. import _build
from .image import IMAGENET_MEAN, IMAGENET_STD

# Kernel launches since the last reset; chip_smoke.py reads it to show
# that the serving path went through the kernel.
LAUNCHES = 0

# (src, dst, device) -> (first column per output row, band weights, K)
_BANDS: dict = {}


@lru_cache(maxsize=64)
def resize_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) bilinear interpolation weights (triangle kernel, scaled
    for antialiasing on downscale; half-pixel centres). Read-only: the
    cache hands the same array to every caller."""
    scale = src / dst
    support = max(scale, 1.0)
    out = np.zeros((dst, src), np.float32)
    for d in range(dst):
        center = (d + 0.5) * scale - 0.5
        lo = int(np.floor(center - support))
        hi = int(np.ceil(center + support))
        xs = np.arange(lo, hi + 1)
        w = 1.0 - np.abs(xs - center) / support
        w = np.clip(w, 0.0, None)
        xs = np.clip(xs, 0, src - 1)
        for x, ww in zip(xs, w):
            out[d, x] += ww
        out[d] /= max(out[d].sum(), 1e-8)
    out.setflags(write=False)
    return out


def _norm_consts() -> tuple[np.ndarray, np.ndarray]:
    """255*mean and 1/(255*std) in float32, as the TPU kernel folds them."""
    return IMAGENET_MEAN * 255.0, 1.0 / (IMAGENET_STD * 255.0)


def band_table(m: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Padded band form of a dense (dst, src) resample matrix: for each
    output row the first column `start` and K weights m[row, start:start+K].

    Derived from the dense matrix's nonzeros, so the edge clamp (taps
    folded into pixel 0 and pixel src-1) is carried exactly. K is the
    widest row's span; a row's start is pulled left where start+K would
    pass src, so the kernel never reads out of range."""
    dst, src = m.shape
    nz = m != 0
    if not nz.any(axis=1).all():
        raise ValueError("resample matrix has an all-zero row")
    first = nz.argmax(axis=1)
    last = src - 1 - nz[:, ::-1].argmax(axis=1)
    k = int((last - first + 1).max())
    start = np.minimum(first, src - k).astype(np.int32)
    cols = start[:, None] + np.arange(k)
    return start, np.take_along_axis(m, cols, axis=1).astype(np.float32)


def _bands_on(src: int, dst: int, device: torch.device):
    key = (src, dst, device)
    if key not in _BANDS:
        start, weights = band_table(resize_matrix(src, dst))
        _BANDS[key] = (torch.tensor(start, device=device),
                       torch.tensor(weights, device=device),
                       weights.shape[1])
    return _BANDS[key]


def resize_normalize_reference(x_u8: torch.Tensor, out_size: int) -> torch.Tensor:
    """Plain torch twin of `resize_normalize_xla` (pallas_image.py:58-69):
    the same two dense interpolation matmuls, then the normalize. Not
    F.interpolate, whose antialias filter and borders differ."""
    _, h, w, _ = x_u8.shape
    mh = torch.tensor(resize_matrix(h, out_size), device=x_u8.device)
    mw = torch.tensor(resize_matrix(w, out_size), device=x_u8.device)
    y = torch.einsum("oh,bhwc->bowc", mh, x_u8.float())
    z = torch.einsum("pw,bowc->bopc", mw, y)
    mean, inv_std = (torch.tensor(a, device=x_u8.device) for a in _norm_consts())
    return ((z - mean) * inv_std).contiguous().permute(0, 3, 1, 2)


def resize_normalize(x_u8: torch.Tensor, out_size: int) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> normalized float32 (B, 3, OUT, OUT), NCHW in
    channels_last memory. CUDA tensors go through the kernel (launched on
    the current stream, no synchronize); CPU tensors through the twin."""
    global LAUNCHES
    if x_u8.dtype != torch.uint8:
        raise TypeError(f"resize_normalize takes uint8 frames, got {x_u8.dtype}")
    if x_u8.dim() != 4 or x_u8.shape[-1] != 3:
        raise ValueError(f"resize_normalize takes (B, H, W, 3), got {tuple(x_u8.shape)}")
    if not x_u8.is_contiguous():
        raise ValueError("resize_normalize takes a contiguous NHWC tensor")
    if out_size < 1:
        raise ValueError(f"out_size must be positive, got {out_size}")
    if x_u8.device.type == "cpu":
        return resize_normalize_reference(x_u8, out_size)
    if x_u8.device.type != "cuda":
        raise ValueError(f"resize_normalize runs on cuda or cpu, not {x_u8.device}")

    lib = _build.load()
    b, h, w, _ = x_u8.shape
    row_start, row_w, k_h = _bands_on(h, out_size, x_u8.device)
    col_start, col_w, k_w = _bands_on(w, out_size, x_u8.device)
    out = torch.empty((b, out_size, out_size, 3), dtype=torch.float32,
                      device=x_u8.device)
    mean, inv_std = _norm_consts()
    with torch.cuda.device(x_u8.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.vdqn_resize_normalize_u8(
            x_u8.data_ptr(), out.data_ptr(),
            row_start.data_ptr(), row_w.data_ptr(), k_h,
            col_start.data_ptr(), col_w.data_ptr(), k_w,
            b, h, w, out_size, out_size,
            *(ctypes.c_float(v) for v in mean),
            *(ctypes.c_float(v) for v in inv_std),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"resize_normalize kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out.permute(0, 3, 1, 2)


# The JAX package's name for this prologue (pallas_image.fused_preprocess).
fused_preprocess = resize_normalize
