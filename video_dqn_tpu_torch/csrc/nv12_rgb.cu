// NV12 -> RGB24 at the native size, hand-written for sm_90a: the colour
// conversion of every frame that frame extraction keeps.
//
// Replaces no TPU kernel: the JAX package converts on the host, with
// swscale (native/decode/decode.cc:111 `emit`, sws_getContext(W, H,
// yuv420p -> RGB24, SWS_BILINEAR), no sws_setColorspaceDetails). Here the
// host library's decoder (csrc/host/h264_decode.cc) hands over only the
// frames the sampler keeps, as tight NV12 planes, and the card converts
// them. The plain twin is ops/nv12.py `nv12_to_rgb_reference`.
//
// Arithmetic: swscale's unscaled yuv420p -> rgb path as its x86 SIMD code
// computes it (ops/nv12.py states the formula and the coefficients):
// BT.601 limited range in 16-bit fixed point, each term a signed
// multiply-high (floor of a * b / 2^16), the sums clamped to 0..255, and a
// 2x2 block's chroma sample applied to its four pixels. Every product fits
// an int and `>>` on a negative int is an arithmetic shift, the floor, so
// the kernel equals the twin and swscale bit for bit.
//
// Contract (the wrapper `nv12_to_rgb` checks): y (height, width), uv
// (height / 2, width: U and V interleaved) and out (height, width, 3), all
// contiguous; width and height even.
//
// Design: one thread a 2x2 block (one chroma pair), a 2-D grid of 32 x 8
// threads a CTA over the (width / 2, height / 2) blocks. A thread reads
// two 2-byte luma pairs and one 2-byte chroma pair and writes two rows of
// 6 bytes, byte stores. Bound: bytes; the frame's 1.5 bytes a pixel in
// and 3 out, read and written once (4.5 * W * H bytes at 3.35 TB/s:
// 4.1 us at 1280x720, 9.3 us at 1920x1080), against a few integer
// operations a pixel.

#include <cstdint>

#include <cuda_runtime.h>

// the wrapper's ops/nv12.py `_Nv12Args`
struct Nv12Args {
  const uint8_t* y;
  const uint8_t* uv;
  uint8_t* out;
  cudaStream_t stream;
  int width;
  int height;
};

namespace {

constexpr int kYCoeff = 9539, kYOffset = 128, kChromaOffset = 1024;
constexpr int kVToR = 13075, kUToG = -3209, kVToG = -6660, kUToB = 16525;

__device__ __forceinline__ uint8_t clamp_u8(int v) {
  return (uint8_t)min(max(v, 0), 255);
}

__device__ __forceinline__ void put_pixel(uint8_t* p, int luma, int r, int g, int b) {
  const int yy = ((luma * 8 - kYOffset) * kYCoeff) >> 16;
  p[0] = clamp_u8(yy + r);
  p[1] = clamp_u8(yy + g);
  p[2] = clamp_u8(yy + b);
}

__global__ void nv12_rgb_kernel(Nv12Args a) {
  const int bx = blockIdx.x * blockDim.x + threadIdx.x;  // chroma column
  const int by = blockIdx.y * blockDim.y + threadIdx.y;  // chroma row
  if (bx >= a.width / 2 || by >= a.height / 2) return;
  const uint8_t* c = a.uv + (long long)by * a.width + 2 * bx;
  const int u = c[0] * 8 - kChromaOffset;
  const int v = c[1] * 8 - kChromaOffset;
  const int r = (v * kVToR) >> 16;
  const int g = ((u * kUToG) >> 16) + ((v * kVToG) >> 16);
  const int b = (u * kUToB) >> 16;
  for (int row = 0; row < 2; row++) {
    const int y = 2 * by + row;
    const uint8_t* luma = a.y + (long long)y * a.width + 2 * bx;
    uint8_t* out = a.out + ((long long)y * a.width + 2 * bx) * 3;
    put_pixel(out, luma[0], r, g, b);
    put_pixel(out + 3, luma[1], r, g, b);
  }
}

}  // namespace

extern "C" int vdqn_nv12_rgb(const Nv12Args* a) {
  const dim3 block(32, 8);
  const dim3 grid((a->width / 2 + block.x - 1) / block.x, (a->height / 2 + block.y - 1) / block.y);
  nv12_rgb_kernel<<<grid, block, 0, a->stream>>>(*a);
  return (int)cudaGetLastError();
}
