"""NV12 -> RGB24 at the native size: the colour conversion of frame
extraction, what the JAX package's decode stage asks of swscale for every
frame it keeps (native/decode/decode.cc `emit`: sws_getContext(W, H,
yuv420p -> RGB24, SWS_BILINEAR) with no sws_setColorspaceDetails).

At the same size, with an even height and without SWS_ACCURATE_RND,
swscale takes its unscaled yuv420p -> rgb path, and on x86 that path's SIMD
code: BT.601 limited-range coefficients (libswscale's ITU-R 601 table,
whatever colour space the stream signals) in 16-bit fixed point, each term
a signed multiply-high (floor of a * b / 2^16), the sums clamped to 0..255:

    y' = ((8 Y - 128) * 9539) >> 16
    R = y' + (((8 V - 1024) * 13075) >> 16)
    G = y' + (((8 U - 1024) * -3209) >> 16) + (((8 V - 1024) * -6660) >> 16)
    B = y' + (((8 U - 1024) * 16525) >> 16)

with the chroma of a 2x2 block applied to its four pixels (no chroma
interpolation). tests/test_torch_video.py holds it to libswscale itself on
every (U, V) pair and to JAX's frames of the fixture videos, exactly. (For
a width that is not a
multiple of 16, swscale's SIMD loop, given the tight RGB stride decode.cc
passes, leaves the last columns unwritten; the conversion here writes
every column by the formula.)

`nv12_to_rgb(y, uv)` takes the luma plane (H, W) and the interleaved
chroma plane (H/2, W) as uint8 tensors and returns (H, W, 3) uint8 RGB. On
a CUDA tensor it launches csrc/nv12_rgb.cu, which reads tight planes (a
plane with longer rows is copied tight first), and counts the launch in
`LAUNCHES`, or raises; on a CPU tensor it runs `nv12_to_rgb_reference`,
the plain torch twin.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from .. import _build

# launches of the kernel since the last clear; chip_smoke.py reads it
LAUNCHES: Counter = Counter()

# libswscale's 16-bit coefficients for ITU-R BT.601 limited range
# (ff_yuv2rgb_c_init_tables: ff_yuv2rgb_coeffs' 601 row scaled by 2^13,
# luma by 255/219)
Y_COEFF, Y_OFFSET, CHROMA_OFFSET = 9539, 128, 1024
V_TO_R, U_TO_G, V_TO_G, U_TO_B = 13075, -3209, -6660, 16525


class _Nv12Args(ctypes.Structure):
    """Arguments of vdqn_nv12_rgb (csrc/nv12_rgb.cu `Nv12Args`)."""
    _fields_ = [("y", ctypes.c_void_p), ("uv", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("stream", ctypes.c_void_p), ("width", ctypes.c_int), ("height", ctypes.c_int)]


def _check(y: torch.Tensor, uv: torch.Tensor) -> tuple:
    if y.dtype != torch.uint8 or uv.dtype != torch.uint8:
        raise TypeError(f"nv12_to_rgb takes uint8 planes, got {y.dtype} and {uv.dtype}")
    if y.dim() != 2 or uv.dim() != 2:
        raise ValueError(f"nv12_to_rgb takes (H, W) and (H/2, W) planes, got "
                         f"{tuple(y.shape)} and {tuple(uv.shape)}")
    h, w = y.shape
    if h % 2 or w % 2 or h == 0 or w == 0:
        raise ValueError(f"nv12_to_rgb takes even sizes (swscale's unscaled path), got {w}x{h}")
    if tuple(uv.shape) != (h // 2, w):
        raise ValueError(f"chroma plane {tuple(uv.shape)} does not fit luma {w}x{h}")
    if y.device != uv.device or y.device.type not in ("cuda", "cpu"):
        raise ValueError(f"planes on {y.device} and {uv.device}")
    return h, w


def nv12_to_rgb_reference(y: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """The plain torch twin: the same integer arithmetic, (H, W, 3) uint8."""
    _check(y, uv)
    luma = y.to(torch.int32)
    chroma = uv.to(torch.int32).repeat_interleave(2, dim=0)
    u = chroma[:, 0::2].repeat_interleave(2, dim=1) * 8 - CHROMA_OFFSET
    v = chroma[:, 1::2].repeat_interleave(2, dim=1) * 8 - CHROMA_OFFSET
    yy = ((luma * 8 - Y_OFFSET) * Y_COEFF) >> 16
    r = yy + ((v * V_TO_R) >> 16)
    g = yy + ((u * U_TO_G) >> 16) + ((v * V_TO_G) >> 16)
    b = yy + ((u * U_TO_B) >> 16)
    return torch.stack([r, g, b], dim=-1).clamp_(0, 255).to(torch.uint8)


def nv12_to_rgb(y: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) uint8 RGB of an NV12 frame: the kernel on the current
    stream for CUDA planes (no synchronize), the twin for CPU ones."""
    h, w = _check(y, uv)
    if y.device.type == "cpu":
        return nv12_to_rgb_reference(y, uv)
    lib = _build.load()
    y, uv = y.contiguous(), uv.contiguous()
    out = torch.empty((h, w, 3), dtype=torch.uint8, device=y.device)
    args = _Nv12Args(y=y.data_ptr(), uv=uv.data_ptr(), out=out.data_ptr(),
                     stream=torch.cuda.current_stream(y.device).cuda_stream, width=w, height=h)
    err = lib.vdqn_nv12_rgb(ctypes.byref(args))
    if err != 0:
        raise RuntimeError(f"nv12_rgb kernel launch failed: CUDA error {err}")
    LAUNCHES["nv12_rgb"] += 1
    return out
