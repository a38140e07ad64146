"""NV12 -> RGB24 at another size: the resize fused into decoding, what the
JAX package's decode stage asks of swscale when decode_frames is given a
`target` (native/decode/decode.cc `emit`: sws_getContext(W, H, yuv420p ->
w x h RGB24, SWS_BILINEAR), no sws_setColorspaceDetails).

At another size swscale (libswscale 6.x) does not take the unscaled path
of ops/nv12.py. It scales in two passes and converts at the end, with
integer arithmetic of its own:

  1. Filter tables, built once for (W, H, w, h) by `initFilter`: for each
     output column (row) the first source column (row) and int16
     coefficients. The bilinear weights are computed in 64-bit fixed point
     (`1 - distance`, the distance scaled by w / W when downscaling, so a
     filter widens with the scale factor); near-zero taps are cut from
     both ends, the size is aligned (to 4 horizontally and to 2
     vertically, as swscale aligns on x86; a vertical size of 1 stays 1),
     a filter running past the source's edge is shifted back inside with
     the cut-off weight added to the edge tap, and the weights are made
     integers with an error-carrying rounding that sums them to 2^14
     (horizontal) or 2^12 (vertical). Luma and chroma are sited at pixel
     centres (swscale's default for 4:2:0).
  2. The horizontal pass, `hScale8To15`: each output sample is the
     coefficients' dot product with the 8-bit samples, >> 7, clipped to
     2^15 - 1. Chroma is scaled to half the output width, or, for an odd
     output width, to the full width (swscale then forces
     SWS_FULL_CHR_H_INT).
  3. The vertical pass and the RGB output, one of three functions a row,
     chosen by the vertical filters' sizes: `yuv2packedX` (the general
     filter, rounded), `yuv2packed2` (two taps each, truncated) or
     `yuv2packed1` (one luma tap; chroma from one row, or the mean of two
     where the second's weight is at least 1/2). With an even output
     width the RGB comes from swscale's `yuv2rgb` lookup tables
     (ff_yuv2rgb_c_init_tables), a 2-pixel pair sharing one chroma
     sample; with an odd one from `yuv2rgb_write_full`'s 16-bit
     coefficients at 2^22, per pixel. Both are BT.601 limited range.

The filter tables are the op's only floating-point part, and that part is
one comparison of a 64-bit sum with 0.002 of the unit weight. Everything
else is integer arithmetic, so the kernel, the twin and libswscale agree
bit for bit (tests/test_torch_video_scale.py holds the twin to
libswscale on random planes and to JAX's frames of the fixture videos).

`scale_tables(W, H, w, h)` builds the tables (cached). `nv12_scale_rgb(y,
uv, tables)` takes the luma plane (H, W) and the interleaved chroma plane
(H/2, W) as uint8 tensors, or (N, H, W) and (N, H/2, W) batches, and
returns (h, w, 3) or (N, h, w, 3) uint8 RGB. On CUDA tensors it launches
csrc/nv12_scale_rgb.cu once for the whole call (tight planes; others are
copied first) and counts the launch in `LAUNCHES`, or raises; on CPU
tensors it runs `nv12_scale_rgb_reference`, the plain torch twin.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Dict, Tuple

import numpy as np
import torch

from .. import _build

# launches of the kernel since the last clear; chip_smoke.py reads it
LAUNCHES: Counter = Counter()

H_ONE, V_ONE = 1 << 14, 1 << 12       # the unit weights of the two passes
H_ALIGN, V_ALIGN = 4, 2               # x86 filterAlign of the two passes
MAX_REDUCE_CUTOFF = 0.002             # SWS_MAX_REDUCE_CUTOFF
# a filter this long or longer makes swscale scale in two stages through a
# yuv420p image of the geometric mean size (RETCODE_USE_CASCADE), which
# the port does not do; it takes a downscale of over 128 times on an axis
MAX_FILTER_SIZE = 256
MODE_X, MODE_1, MODE_2 = 0, 1, 2      # yuv2packedX, yuv2packed1, yuv2packed2

# BT.601 (ff_yuv2rgb_coeffs' ITU-R 601 row) at limited range: crv, cbu,
# cgu, cgv
INV_TABLE = (104597, 132201, 25675, 53279)
TABLE_HEADROOM = 512                   # YUVRGB_TABLE_LUMA_HEADROOM
Y_TABLE_SIZE = 1024 + 2 * TABLE_HEADROOM
Y_TABLE_OFFSET = 326 + TABLE_HEADROOM  # yoffs at limited range
# yuv2rgb_write_full's coefficients (roundToInt16 of the above at 2^13)
FULL_Y_OFFSET, FULL_Y_COEFF = 8192, 9539
FULL_V2R, FULL_V2G, FULL_U2G, FULL_U2B = 13075, -6660, -3209, 16525


def _rounded_div(a: int, b: int) -> int:
    """C's ROUNDED_DIV (division truncating toward zero)."""
    n = a + (b >> 1) if a >= 0 else a - (b >> 1)
    q = abs(n) // b
    return q if n >= 0 else -q


def _trunc_div(a: int, b: int) -> int:
    """C's integer division (truncating toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _av_log2(v: int) -> int:
    return max(v, 1).bit_length() - 1


def init_filter(x_inc: int, src_w: int, dst_w: int, align: int,
                one: int) -> Tuple[np.ndarray, np.ndarray]:
    """libswscale's initFilter for SWS_BILINEAR, without source or
    destination filters, source and output sited at pixel centres:
    (positions int32 (dst_w,), coefficients int16 (dst_w, size))."""
    fone = 1 << (54 - min(_av_log2(src_w // dst_w), 8))
    if abs(x_inc - 0x10000) < 10:  # unscaled
        size = 1
        pos = list(range(dst_w))
        filt = [[fone] for _ in range(dst_w)]
    else:
        size = 1 + 2 if x_inc <= 1 << 16 else 1 + (2 * src_w + dst_w - 1) // dst_w
        size = max(min(size, src_w - 2), 1)
        pos, filt = [], []
        # the first output's centre in the source, in 2^-17 of a pixel
        # (get_local_pos: 128 / 256 of a pixel on both sides)
        x_dst_in_src = x_inc - 0x10000
        for _ in range(dst_w):
            xx = _trunc_div(x_dst_in_src - (size - 2) * (1 << 16), 1 << 17)
            pos.append(xx)
            row = []
            for _ in range(size):
                d = abs(xx * (1 << 17) - x_dst_in_src) << 13
                if x_inc > 1 << 16:
                    d = _trunc_div(d * dst_w, src_w)
                coeff = max((1 << 30) - d, 0) * (fone >> 30)
                row.append(coeff)
                xx += 1
            filt.append(row)
            x_dst_in_src += 2 * x_inc

    # reduce the size: shift near-zero taps out on the left, count them on
    # the right
    min_size = 0
    cutoff_limit = MAX_REDUCE_CUTOFF * fone
    for i in range(dst_w - 1, -1, -1):
        row = filt[i]
        kept = size
        cut = 0
        for _ in range(size):
            cut += abs(row[0])
            if float(cut) > cutoff_limit:
                break
            if i < dst_w - 1 and pos[i] >= pos[i + 1]:
                break
            row[:] = row[1:] + [0]
            pos[i] += 1
        cut = 0
        for j in range(size - 1, 0, -1):
            cut += abs(row[j])
            if float(cut) > cutoff_limit:
                break
            kept -= 1
        min_size = max(min_size, kept)
    if min_size == 1 and align == 2:  # x86: unscaled vertical filtering
        align = 1
    new_size = (min_size + align - 1) & ~(align - 1)
    filt = [(row + [0] * new_size)[:new_size] for row in filt]
    size = new_size

    # fix the borders
    for i in range(dst_w):
        row = filt[i]
        if pos[i] < 0:
            for j in range(1, size):
                left = max(j + pos[i], 0)
                row[left] += row[j]
                row[j] = 0
            pos[i] = 0
        if pos[i] + size > src_w:
            shift = pos[i] + min(size - src_w, 0)
            acc = 0
            for j in range(size - 1, -1, -1):
                if pos[i] + j >= src_w:
                    acc += row[j]
                    row[j] = 0
            for j in range(size - 1, -1, -1):
                row[j] = 0 if j < shift else row[j - shift]
            pos[i] -= shift
            row[src_w - 1 - pos[i]] += acc

    # normalise, carrying each rounding's error to the next tap
    out = np.zeros((dst_w, size), np.int16)
    for i in range(dst_w):
        total = (sum(filt[i]) + one // 2) // one or 1
        error = 0
        for j in range(size):
            v = filt[i][j] + error
            q = _rounded_div(v, total)
            out[i, j] = q
            error = v - q * total
    return np.asarray(pos, np.int32), out


def _inc(src: int, dst: int) -> int:
    """swscale's step between outputs, in 2^-16 of a source pixel."""
    return ((src << 16) + (dst >> 1)) // dst


def _mode(lum_size: int, chr_size: int) -> int:
    """packed_vscale's output function, by the vertical filters' sizes:
    packed1 (one luma tap, one or two chroma taps), packed2 (two taps
    each), else packedX. (swscale takes a 2-tap form for a row whose
    weights lie in 0..4096 and sum to 4096, which every bilinear row's
    do.)"""
    if lum_size == 1 and chr_size <= 2:
        return MODE_1
    return MODE_2 if lum_size == 2 and chr_size == 2 else MODE_X


class ScaleTables:
    """swscale's filter tables for (W, H) -> (w, h) and the output's form
    (`full`: the odd-width path). `device_tensors(device)` holds them on a
    device once."""

    def __init__(self, src_w: int, src_h: int, dst_w: int, dst_h: int):
        if min(src_w, src_h, dst_w, dst_h) < 1 or src_w % 2 or src_h % 2:
            raise ValueError(f"scaling {src_w}x{src_h} -> {dst_w}x{dst_h}: the source takes "
                             "even sizes (NV12) and every size is positive")
        if (src_w, src_h) == (dst_w, dst_h):
            raise ValueError("the native size is swscale's unscaled path (ops/nv12.py)")
        self.src, self.dst = (src_w, src_h), (dst_w, dst_h)
        self.full = dst_w % 2 == 1
        chr_src_w, chr_src_h = src_w // 2, src_h // 2
        chr_dst_w = dst_w if self.full else (dst_w + 1) // 2
        self.h_lum = init_filter(_inc(src_w, dst_w), src_w, dst_w, H_ALIGN, H_ONE)
        self.h_chr = init_filter(_inc(chr_src_w, chr_dst_w), chr_src_w, chr_dst_w, H_ALIGN,
                                 H_ONE)
        self.v_lum = init_filter(_inc(src_h, dst_h), src_h, dst_h, V_ALIGN, V_ONE)
        self.v_chr = init_filter(_inc(chr_src_h, dst_h), chr_src_h, dst_h, V_ALIGN, V_ONE)
        if max(self.sizes) >= MAX_FILTER_SIZE:
            raise ValueError(f"scaling {src_w}x{src_h} -> {dst_w}x{dst_h} takes filters of "
                             f"{self.sizes} taps: swscale cascades two scalers there, which "
                             "the port does not")
        self.mode = _mode(self.v_lum[1].shape[1], self.v_chr[1].shape[1])
        self._device: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    @property
    def sizes(self) -> Tuple[int, int, int, int]:
        """The four filters' sizes: luma and chroma horizontal, luma and
        chroma vertical."""
        return tuple(f[1].shape[1] for f in (self.h_lum, self.h_chr, self.v_lum, self.v_chr))

    def device_tensors(self, device: torch.device) -> Dict[str, torch.Tensor]:
        device = torch.device(device)
        if device not in self._device:
            t = {}
            for name in ("h_lum", "h_chr", "v_lum", "v_chr"):
                pos, coeff = getattr(self, name)
                t[name + "_pos"] = torch.from_numpy(pos).to(device)
                t[name + "_coeff"] = torch.from_numpy(coeff).to(device)
            for name, table in rgb_tables().items():
                t[name] = torch.from_numpy(table).to(device)
            self._device[device] = t
        return self._device[device]


@functools.lru_cache(maxsize=32)
def scale_tables(src_w: int, src_h: int, dst_w: int, dst_h: int) -> ScaleTables:
    return ScaleTables(src_w, src_h, dst_w, dst_h)


@functools.lru_cache(maxsize=None)
def rgb_tables() -> Dict[str, np.ndarray]:
    """ff_yuv2rgb_c_init_tables at 24 bits, BT.601 limited range, brightness
    0 and unit contrast and saturation: `y_table` (uint8, 2048) and, for a
    chroma value c in 0..255, the offsets into it of R (`r_v`), G (`g_u` +
    `g_v`) and B (`b_u`), the luma value added to each (int32, 256)."""
    crv, cbu, cgu, cgv = INV_TABLE[0], INV_TABLE[1], -INV_TABLE[2], -INV_TABLE[3]
    cy = (1 << 16) * 255 // 219
    oy = 16 << 16
    # contrast and saturation 1 << 16 leave them as they are
    cy = (cy * (1 << 16)) >> 16
    crv, cbu, cgu, cgv = ((c * (1 << 16) * (1 << 16)) >> 32 for c in (crv, cbu, cgu, cgv))
    crv, cbu, cgu, cgv = (_trunc_div(c * (1 << 16) + 0x8000, max(cy, 1))
                          for c in (crv, cbu, cgu, cgv))
    yb = -(384 << 16) - TABLE_HEADROOM * cy - oy
    y_table = np.empty(Y_TABLE_SIZE, np.uint8)
    for i in range(Y_TABLE_SIZE):
        y_table[i] = min(max((yb + 0x8000) >> 16, 0), 255)
        yb += cy
    c = np.arange(256, dtype=np.int64)

    def offsets(inc: int, base: int) -> np.ndarray:
        return (base - (inc >> 9) + ((c * inc) >> 16)).astype(np.int32)

    return {"y_table": y_table, "r_v": offsets(crv, Y_TABLE_OFFSET),
            "g_u": offsets(cgu, Y_TABLE_OFFSET), "g_v": offsets(cgv, 0),
            "b_u": offsets(cbu, Y_TABLE_OFFSET)}


def _check(y: torch.Tensor, uv: torch.Tensor, tables: ScaleTables) -> tuple:
    """(N, H, W) of an NV12 frame (N = 1) or batch that fits `tables`, or
    raises."""
    if y.dtype != torch.uint8 or uv.dtype != torch.uint8:
        raise TypeError(f"nv12_scale_rgb takes uint8 planes, got {y.dtype} and {uv.dtype}")
    if y.dim() not in (2, 3) or uv.dim() != y.dim():
        raise ValueError(f"nv12_scale_rgb takes (H, W) and (H/2, W) planes or (N, H, W) and "
                         f"(N, H/2, W) batches, got {tuple(y.shape)} and {tuple(uv.shape)}")
    n, h, w = (1, *y.shape) if y.dim() == 2 else y.shape
    if (w, h) != tables.src:
        raise ValueError(f"tables for {tables.src[0]}x{tables.src[1]}, planes of {w}x{h}")
    if n == 0:
        raise ValueError("nv12_scale_rgb takes at least one frame")
    if tuple(uv.shape) != tuple(y.shape[:-2]) + (h // 2, w):
        raise ValueError(f"chroma {tuple(uv.shape)} does not fit luma {tuple(y.shape)}")
    if y.device != uv.device or y.device.type not in ("cuda", "cpu"):
        raise ValueError(f"planes on {y.device} and {uv.device}")
    return n, h, w


def _hscale(plane: torch.Tensor, pos: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """hScale8To15 along the last axis: (..., n_src) -> (..., n_dst) int32.
    Taps past the edge (zero weights) read the last sample."""
    idx = (pos[:, None].long() + torch.arange(coeff.shape[1], device=pos.device)).clamp_(
        max=plane.shape[-1] - 1)
    taps = plane.to(torch.int32)[..., idx]
    return ((taps * coeff.to(torch.int32)).sum(-1, dtype=torch.int32) >> 7).clamp_(max=32767)


def _vtaps(lines: torch.Tensor, pos: torch.Tensor, coeff: torch.Tensor) -> tuple:
    """The vertical filter's rows of (..., R, n) lines for each output
    row: (taps (..., h, size, n), weighted sum (..., h, n))."""
    idx = (pos[:, None].long() + torch.arange(coeff.shape[1], device=pos.device)).clamp_(
        max=lines.shape[-2] - 1)
    taps = lines[..., idx, :]
    return taps, (taps * coeff.to(torch.int32)[:, :, None]).sum(-2, dtype=torch.int32)


def _vertical(lum: torch.Tensor, u: torch.Tensor, v: torch.Tensor, t: Dict[str, torch.Tensor],
              full: bool, mode: int) -> tuple:
    """Y, U and V as the output function takes them: 8-bit values for the
    lookup tables, or values at 2^9 (chroma centred) for
    yuv2rgb_write_full. packedX and packed1 round the vertical sum,
    packed2 truncates it."""
    shift, bias = (10, 1 << 26) if full else (19, 0)
    rounding = 0 if mode == MODE_2 else 1 << (shift - 1)
    _, sy = _vtaps(lum, t["v_lum_pos"], t["v_lum_coeff"])
    out = [(sy + rounding) >> shift]
    ccoeff = t["v_chr_coeff"]
    for plane in (u, v):
        taps, s = _vtaps(plane, t["v_chr_pos"], ccoeff)
        if mode != MODE_1:
            out.append((s + rounding - bias) >> shift)
            continue
        # packed1: the first chroma row where the second's weight is under
        # 1/2, else the two rows' mean
        alpha = ccoeff[:, 1, None] if ccoeff.shape[1] == 2 else torch.zeros_like(ccoeff)
        c0 = taps[..., 0, :]
        c1 = taps[..., -1, :]
        if full:
            one = torch.where(alpha < 2048, (c0 - (128 << 7)) * 4, (c0 + c1 - (128 << 8)) * 2)
        else:
            one = torch.where(alpha < 2048, (c0 + 64) >> 7, (c0 + c1 + 128) >> 8)
        out.append(one)
    return tuple(out)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def nv12_scale_rgb_reference(y: torch.Tensor, uv: torch.Tensor,
                             tables: ScaleTables) -> torch.Tensor:
    """The plain torch twin: swscale's integer steps as gathers and sums,
    (..., h, w, 3) uint8 for (..., H, W) luma."""
    _check(y, uv, tables)
    t = tables.device_tensors(y.device)
    lum = _hscale(y, t["h_lum_pos"], t["h_lum_coeff"])
    u = _hscale(uv[..., 0::2], t["h_chr_pos"], t["h_chr_coeff"])
    v = _hscale(uv[..., 1::2], t["h_chr_pos"], t["h_chr_coeff"])
    yy, uu, vv = _vertical(lum, u, v, t, tables.full, tables.mode)
    if tables.full:
        yy = ((yy - FULL_Y_OFFSET) * FULL_Y_COEFF + (1 << 21)).long()
        uu, vv = uu.long(), vv.long()
        rgb = torch.stack([yy + vv * FULL_V2R, yy + vv * FULL_V2G + uu * FULL_U2G,
                           yy + uu * FULL_U2B], dim=-1)
        return (_wrap32(rgb).clamp_(0, (1 << 30) - 1) >> 22).to(torch.uint8)
    uu = uu.clamp(0, 255).long().repeat_interleave(2, dim=-1)
    vv = vv.clamp(0, 255).long().repeat_interleave(2, dim=-1)
    yy = yy.long()
    index = torch.stack([yy + t["r_v"][vv], yy + t["g_u"][uu] + t["g_v"][vv],
                         yy + t["b_u"][uu]], dim=-1)
    return t["y_table"][index]


_TABLE_FIELDS = ("h_lum_pos", "h_lum_coeff", "h_chr_pos", "h_chr_coeff", "v_lum_pos",
                 "v_lum_coeff", "v_chr_pos", "v_chr_coeff", "y_table", "r_v", "g_u", "g_v",
                 "b_u")


class _ScaleArgs(ctypes.Structure):
    """Arguments of vdqn_nv12_scale_rgb (csrc/nv12_scale_rgb.cu `ScaleArgs`)."""
    _fields_ = ([(name, ctypes.c_void_p) for name in ("y", "uv", "out", *_TABLE_FIELDS,
                                                      "stream")]
                + [(name, ctypes.c_int) for name in (
                    "src_w", "src_h", "dst_w", "dst_h", "h_lum_size", "h_chr_size",
                    "v_lum_size", "v_chr_size", "frames", "full", "mode")])


def nv12_scale_rgb(y: torch.Tensor, uv: torch.Tensor, tables: ScaleTables) -> torch.Tensor:
    """(h, w, 3) uint8 RGB of an NV12 frame at the tables' output size, or
    (N, h, w, 3) of a batch: one launch of the kernel on the current stream
    for CUDA planes (no synchronize), the twin for CPU ones."""
    n, h, w = _check(y, uv, tables)
    if y.device.type == "cpu":
        return nv12_scale_rgb_reference(y, uv, tables)
    dst_w, dst_h = tables.dst
    if 3 * n * dst_h * dst_w >= 2 ** 31 or n * h * w >= 2 ** 31:
        raise ValueError(f"nv12_scale_rgb takes and gives under 2 GiB a call, got {n} frames "
                         f"of {w}x{h} -> {dst_w}x{dst_h}")
    lib = _build.load()
    y, uv = (t.contiguous() for t in (y, uv))
    t = tables.device_tensors(y.device)
    out = torch.empty(tuple(y.shape[:-2]) + (dst_h, dst_w, 3), dtype=torch.uint8,
                      device=y.device)
    sizes = dict(zip(("h_lum_size", "h_chr_size", "v_lum_size", "v_chr_size"), tables.sizes))
    args = _ScaleArgs(y=y.data_ptr(), uv=uv.data_ptr(), out=out.data_ptr(),
                      stream=torch.cuda.current_stream(y.device).cuda_stream,
                      src_w=w, src_h=h, dst_w=dst_w, dst_h=dst_h, frames=n,
                      full=int(tables.full), mode=tables.mode, **sizes,
                      **{name: t[name].data_ptr() for name in _TABLE_FIELDS})
    err = lib.vdqn_nv12_scale_rgb(ctypes.byref(args))
    if err != 0:
        raise RuntimeError(f"nv12_scale_rgb kernel launch failed: CUDA error {err}")
    LAUNCHES["nv12_scale_rgb"] += 1
    return out
