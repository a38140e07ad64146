"""Fused uint8 resize + ImageNet normalize: the prologue of every scorer
call and, at identity size, of every train step (before and after
frames), and the port of the repo's one TPU kernel
(video_dqn_tpu/ops/pallas_image.py `resize_normalize_pallas`).

uint8 NHWC frames (B, H, W, 3) become the normalized tensor the trunk
reads, (B, 3, OUT, OUT) NCHW in channels_last memory, as float32 or as
bfloat16 (rounded to nearest even, the cast bf16 autocast would apply).
The resample is the antialiased triangle filter of `resize_matrix`
(half-pixel centres, edge-clamped taps, rows normalized to 1); at
OUT == H == W the matrix is exactly the identity, and the kernel takes its
elementwise path.

On a CUDA tensor `resize_normalize` launches the hand-written kernels in
csrc/resize_normalize.cu (and counts each launch in `LAUNCHES`) or
raises; on a CPU tensor it runs `resize_normalize_reference`, the plain
torch twin built from the same dense matrices.

`normalize_u8` is the normalize alone on frames of any H x W (the
detector's prologue): the identity kernel, which is flat over the
tensor's values, or on a CPU tensor `normalize_u8_reference`.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from .image import IMAGENET_MEAN, IMAGENET_STD

# Kernel launches since the last clear, by (path, output dtype), e.g.
# ("banded", "bfloat16"); chip_smoke.py reads it to show that the serving
# path went through the kernels.
LAUNCHES: Counter = Counter()

OUT_DTYPES = (torch.float32, torch.bfloat16)
ROWS_PER_TILE = 8          # output rows per CTA of the banded kernel
SMEM_LIMIT = 232_448       # bytes of shared memory one block may use on sm_90
MAX_BATCH = 65_535         # the banded kernel's grid.y


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


class _IdentityArgs(ctypes.Structure):
    """Arguments of vdqn_resize_normalize_identity (csrc/resize_normalize.cu)."""
    _fields_ = [("x", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("stream", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("out_bf16", ctypes.c_int), ("norm", ctypes.c_float * 6)]


class _BandedArgs(ctypes.Structure):
    """Arguments of vdqn_resize_normalize_banded (csrc/resize_normalize.cu)."""
    _fields_ = [(name, ctypes.c_void_p) for name in
                ("x", "out", "row_start", "row_w", "col_start", "col_w", "stream")]
    _fields_ += [(name, ctypes.c_int) for name in
                 ("k_h", "k_w", "h", "w", "out_size", "rows_per_tile", "smem_bytes",
                  "batch", "out_bf16")]
    _fields_ += [("norm", ctypes.c_float * 6)]


_NORM = tuple(float(v) for v in np.concatenate(_norm_consts()))


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


class Plan(NamedTuple):
    """How the kernel runs one (H, W) -> OUT resize. The identity path
    (H == W == OUT) has no tiles and no shared memory; the banded path
    stages up to `span` input rows per tile of `rows_per_tile` output rows
    in `smem_bytes` of shared memory."""
    identity: bool
    rows_per_tile: int = 0
    span: int = 0
    smem_bytes: int = 0


def _round4(n: int) -> int:
    return (n + 3) & ~3


def _phased_words(n_bytes: int) -> int:
    """Bytes of the 16-byte words that hold n_bytes starting at any of the
    16 alignment phases, plus the 7 bytes past them that the 32-bit reads
    of the last 4-byte column group may touch."""
    return 16 * ((n_bytes + 15 + 7 + 15) // 16)


def banded_smem_bytes(rows_per_tile: int, span: int, w: int, out_size: int,
                      out_itemsize: int) -> int:
    """Shared memory of one banded CTA, laid out as the kernel lays it out:
    f32 vertical sums (R, 3, W rounded up to 4), then one region for the
    staged input rows and, once they are read, the output tile (R, OUT, 3),
    each at its own 16-byte phase."""
    return 4 * rows_per_tile * 3 * _round4(w) + max(
        _phased_words(span * w * 3),
        _phased_words(rows_per_tile * out_size * 3 * out_itemsize))


@lru_cache(maxsize=64)
def kernel_plan(h: int, w: int, out_size: int, out_itemsize: int = 4) -> Plan:
    """The kernel's path and tiling for (H, W) -> OUT with output values of
    `out_itemsize` bytes: banded tiles of ROWS_PER_TILE output rows. Raises
    where such a tile needs more shared memory than a block has."""
    if h == w == out_size:
        return Plan(identity=True)
    span = staged_span(h, out_size, ROWS_PER_TILE)
    smem = banded_smem_bytes(ROWS_PER_TILE, span, w, out_size, out_itemsize)
    if smem > SMEM_LIMIT:
        raise ValueError(f"resize {h}x{w} -> {out_size} needs {smem} bytes of shared "
                         f"memory per tile, over the {SMEM_LIMIT} a block has")
    return Plan(False, ROWS_PER_TILE, span, smem)


def staged_span(h: int, out_size: int, rows_per_tile: int) -> int:
    """Input rows of the widest banded tile: a tile of output rows
    [o0, o1] stages [row_start[o0], row_start[o1] + K_h), which holds every
    tap of its rows because band starts never decrease."""
    row_start, row_w = band_table(resize_matrix(h, out_size))
    if np.any(np.diff(row_start) < 0):
        raise ValueError(f"band starts of {h} -> {out_size} decrease")
    first = row_start[::rows_per_tile]
    last = row_start[np.minimum(np.arange(0, out_size, rows_per_tile) + rows_per_tile,
                                out_size) - 1]
    return int((last + row_w.shape[1] - first).max())


class _Launch(NamedTuple):
    plan: Plan
    args: ctypes.Structure  # the kernel's arguments but the per-call ones
    tables: tuple           # the device tensors behind the pointers in args


_PREPARED: dict = {}


def _prepared(h: int, w: int, out_size: int, dtype: torch.dtype,
              device: torch.device) -> _Launch:
    """The banded plan, the band tables on `device` and the kernel's
    argument struct, made once per (H, W, OUT, output dtype, device); a
    call copies the struct and fills in its tensors, batch and stream."""
    key = (h, w, out_size, dtype, device)
    if key not in _PREPARED:
        plan = kernel_plan(h, w, out_size, dtype.itemsize)
        row_start, row_w = band_table(resize_matrix(h, out_size))
        col_start, col_w = band_table(resize_matrix(w, out_size))
        # the kernel reads the column weights transposed, (K_w, OUT)
        tables = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                       for a in (row_start, row_w, col_start, col_w.T))
        args = _BandedArgs(
            row_start=tables[0].data_ptr(), row_w=tables[1].data_ptr(),
            col_start=tables[2].data_ptr(), col_w=tables[3].data_ptr(),
            k_h=row_w.shape[1], k_w=col_w.shape[1], h=h, w=w, out_size=out_size,
            rows_per_tile=plan.rows_per_tile, smem_bytes=plan.smem_bytes,
            out_bf16=int(dtype == torch.bfloat16), norm=_NORM)
        _PREPARED[key] = _Launch(plan, args, tables)
    return _PREPARED[key]


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


def normalize_u8_reference(x_u8: torch.Tensor) -> torch.Tensor:
    """Plain torch twin of the identity kernel: (x - 255*mean) /
    (255*std) in float32 with the folded constants, (B, 3, H, W)."""
    mean, inv_std = (torch.tensor(a, device=x_u8.device) for a in _norm_consts())
    return ((x_u8.float() - mean) * inv_std).permute(0, 3, 1, 2)


def _check_frames(x_u8: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if dtype not in OUT_DTYPES:
        raise TypeError(f"{name} writes float32 or bfloat16, not {dtype}")
    if x_u8.dtype != torch.uint8:
        raise TypeError(f"{name} takes uint8 frames, got {x_u8.dtype}")
    if x_u8.dim() != 4 or x_u8.shape[-1] != 3:
        raise ValueError(f"{name} takes (B, H, W, 3), got {tuple(x_u8.shape)}")
    if not x_u8.is_contiguous():
        raise ValueError(f"{name} takes a contiguous NHWC tensor")
    if x_u8.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {x_u8.device}")


def _launch(x_u8: torch.Tensor, out_size: int, dtype: torch.dtype,
            identity: bool) -> torch.Tensor:
    """One launch of the kernel's identity (flat over the values: any H x W,
    out_size == H) or banded path on the current stream, no synchronize."""
    if x_u8.device.index != torch.cuda.current_device():
        with torch.cuda.device(x_u8.device):
            return _launch(x_u8, out_size, dtype, identity)
    lib = _build.load()
    b, h, w, _ = x_u8.shape
    shape = (b, h, w, 3) if identity else (b, out_size, out_size, 3)
    out = torch.empty(shape, dtype=dtype, device=x_u8.device)
    if identity:
        args = _IdentityArgs(out_bf16=int(dtype == torch.bfloat16), norm=_NORM,
                             n=x_u8.numel())
        entry = lib.vdqn_resize_normalize_identity
    else:
        launch = _prepared(h, w, out_size, dtype, x_u8.device)
        if b > MAX_BATCH:
            raise ValueError(f"resize_normalize resamples at most {MAX_BATCH} frames a call")
        args = type(launch.args).from_buffer_copy(launch.args)
        args.batch = b
        entry = lib.vdqn_resize_normalize_banded
    args.x, args.out = x_u8.data_ptr(), out.data_ptr()
    args.stream = torch.cuda.current_stream().cuda_stream
    err = entry(ctypes.byref(args))
    if err != 0:
        raise RuntimeError(f"resize_normalize kernel launch failed: CUDA error {err}")
    LAUNCHES["identity" if identity else "banded", str(dtype)[6:]] += 1
    return out.permute(0, 3, 1, 2)


def resize_normalize(x_u8: torch.Tensor, out_size: int,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> normalized (B, 3, OUT, OUT) of `dtype`
    (float32 or bfloat16), NCHW in channels_last memory. CUDA tensors go
    through the kernel (launched on the current stream, no synchronize);
    CPU tensors through the twin, cast to `dtype`."""
    _check_frames(x_u8, dtype, "resize_normalize")
    if out_size < 1:
        raise ValueError(f"out_size must be positive, got {out_size}")
    if x_u8.device.type == "cpu":
        return resize_normalize_reference(x_u8, out_size).to(dtype)
    _, h, w, _ = x_u8.shape
    return _launch(x_u8, out_size, dtype, kernel_plan(h, w, out_size).identity)


def normalize_u8(x_u8: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 (B, H, W, 3) of any H x W -> ImageNet-normalized (B, 3, H, W)
    of `dtype` (float32 or bfloat16), NCHW in channels_last memory: the
    identity kernel on a CUDA tensor, normalize_u8_reference cast to
    `dtype` on a CPU one."""
    _check_frames(x_u8, dtype, "normalize_u8")
    if x_u8.device.type == "cpu":
        return normalize_u8_reference(x_u8).to(dtype)
    return _launch(x_u8, x_u8.shape[1], dtype, identity=True)


# The JAX package's name for this prologue (pallas_image.fused_preprocess).
fused_preprocess = resize_normalize
