// NV12 -> RGB24 at another size, hand-written for sm_90a: the resize fused
// into decoding, swscale's scaled bilinear path (libswscale 6.x, x86) bit
// for bit, one launch for a frame or a batch of frames of one size.
//
// Replaces no TPU kernel: the JAX package resizes on the host, with
// swscale (native/decode/decode.cc:111 `emit`, sws_getContext(W, H,
// yuv420p -> w x h RGB24, SWS_BILINEAR), when decode_frames is given a
// target). The plain twin is ops/nv12_scale.py `nv12_scale_rgb_reference`,
// which also states swscale's steps; the filter tables are built on the
// host by ops/nv12_scale.py `ScaleTables` and read here.
//
// What it computes, for output row r and column x of frame f:
//   * hScale8To15: a source row's samples under the horizontal filter of
//     x, hs = min((sum_t src[pos_x + t] * coeff_x[t]) >> 7, 32767); luma
//     at x, chroma (U and V from the interleaved plane) at x on the
//     odd-width path, at x / 2 otherwise;
//   * the vertical filter of r over the horizontally scaled rows, S =
//     sum_j hs(row pos_r + j) * vcoeff_r[j], rounded or truncated as the
//     output function does (`mode`, by the vertical filters' sizes:
//     yuv2packedX, yuv2packed1, yuv2packed2);
//   * the RGB: on the even-width path swscale's lookup tables
//     (y_table[Y + r_v[V]], y_table[Y + g_u[U] + g_v[V]],
//     y_table[Y + b_u[U]]), a pixel pair sharing one chroma sample; on the
//     odd-width path yuv2rgb_write_full's 16-bit coefficients at 2^22 in
//     wrapping 32-bit arithmetic, clipped to 30 bits, >> 22.
// Every step is integer arithmetic in the order the twin takes it (a
// filter's taps past the source's edge have zero weight and read the last
// sample, in both), so the kernel equals the twin bit for bit.
//
// Contract (the wrapper `nv12_scale_rgb` checks): y (frames, H, W), uv
// (frames, H / 2, W: U and V interleaved) and out (frames, h, w, 3), all
// contiguous; W and H even; the tables those of (W, H) -> (w, h); planes
// and out each under 2^31 bytes.
//
// Bound: bytes. 1.5 W H bytes read and 3 w h written a frame, each once:
// 1280x720 -> 224x224 moves 1.53 MB, 0.46 us at 3.35 TB/s (16 frames
// 7.3 us). The arithmetic is larger than on the unscaled path (a 720p ->
// 224 luma pixel takes 8 x 12 multiply-adds) but far below the card's
// integer rate, and a single frame is launch-bound.
//
// Design, simple first: one thread an output pixel pair (even width) or
// pixel (odd width), a CTA for every 256 of the whole batch in (frame,
// row, column) order. A thread recomputes the horizontal pass of each row
// its vertical filter takes, reading the source and the tables through
// the read-only cache (neighbouring threads share most of their taps and
// rows), and writes its 6 or 3 bytes. No shared memory, no staging pass.

#include <cstdint>

#include <cuda_runtime.h>

// the wrapper's ops/nv12_scale.py `_ScaleArgs`
struct ScaleArgs {
  const uint8_t* y;
  const uint8_t* uv;
  uint8_t* out;
  const int32_t* h_lum_pos;
  const int16_t* h_lum_coeff;
  const int32_t* h_chr_pos;
  const int16_t* h_chr_coeff;
  const int32_t* v_lum_pos;
  const int16_t* v_lum_coeff;
  const int32_t* v_chr_pos;
  const int16_t* v_chr_coeff;
  const uint8_t* y_table;
  const int32_t* r_v;
  const int32_t* g_u;
  const int32_t* g_v;
  const int32_t* b_u;
  cudaStream_t stream;
  int src_w, src_h, dst_w, dst_h;
  int h_lum_size, h_chr_size, v_lum_size, v_chr_size;
  int frames;
  int full;  // odd output width: full-width chroma, yuv2rgb_write_full
  int mode;  // the output function: ops/nv12_scale.py MODE_X, MODE_1, MODE_2
};

namespace {

constexpr int kThreads = 256;
constexpr int kMode1 = 1, kMode2 = 2;  // ops/nv12_scale.py MODE_1, MODE_2
// yuv2rgb_write_full's coefficients (ops/nv12_scale.py FULL_*)
constexpr int kFullYOffset = 8192, kFullYCoeff = 9539;
constexpr int kV2R = 13075, kV2G = -6660, kU2G = -3209, kU2B = 16525;

// hScale8To15 of one row at one output column: `step` bytes between
// samples (1 luma, 2 chroma), `n` samples in the row
__device__ __forceinline__ int hscale(const uint8_t* row, int step, int n, int pos,
                                      const int16_t* coeff, int size) {
  int s = 0;
  for (int t = 0; t < size; t++) {
    const int x = min(pos + t, n - 1);
    s += (int)__ldg(row + x * step) * (int)__ldg(coeff + t);
  }
  return min(s >> 7, 32767);
}

// a plane's vertical filter of output row r at one output column: the
// weighted sum, and the first two horizontally scaled rows (packed1)
struct Column {
  int sum, first, second;
};

__device__ __forceinline__ Column column(const uint8_t* plane, int step, int width, int rows,
                                         int stride, int hpos, const int16_t* hcoeff,
                                         int hsize, int vpos, const int16_t* vcoeff,
                                         int vsize) {
  Column c{0, 0, 0};
  for (int j = 0; j < vsize; j++) {
    const int row = min(vpos + j, rows - 1);
    const int hs = hscale(plane + (size_t)row * stride, step, width, hpos, hcoeff, hsize);
    c.sum += hs * (int)__ldg(vcoeff + j);
    if (j == 0) c.first = c.second = hs;
    if (j == 1) c.second = hs;
  }
  return c;
}

__device__ __forceinline__ int clip30(int v) { return min(max(v, 0), (1 << 30) - 1); }

__global__ void __launch_bounds__(kThreads) nv12_scale_rgb_kernel(const ScaleArgs a) {
  // a row's threads; the wrapper keeps out under 2^31 bytes, so every
  // index of the batch's items fits an int
  const int items = a.full ? a.dst_w : a.dst_w / 2;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.frames * a.dst_h * items) return;
  const int k = i % items;
  const int row = i / items;
  const int r = row % a.dst_h;
  const int f = row / a.dst_h;
  const uint8_t* y = a.y + (size_t)f * a.src_h * a.src_w;
  const uint8_t* uv = a.uv + (size_t)f * (a.src_h / 2) * a.src_w;
  uint8_t* out = a.out + ((size_t)f * a.dst_h + r) * a.dst_w * 3;

  const int mode = a.mode;
  const int full_shift = a.full ? 10 : 19;
  const int round = mode == kMode2 ? 0 : 1 << (full_shift - 1);
  const int vl = __ldg(a.v_lum_pos + r), vc = __ldg(a.v_chr_pos + r);
  const int16_t* vl_coeff = a.v_lum_coeff + r * a.v_lum_size;
  const int16_t* vc_coeff = a.v_chr_coeff + r * a.v_chr_size;
  const int alpha = a.v_chr_size >= 2 ? (int)__ldg(vc_coeff + 1) : 0;

  // chroma column k (U, then V): its value as the row's output function
  // takes it
  int chroma[2];
  const int hc = __ldg(a.h_chr_pos + k);
  for (int p = 0; p < 2; p++) {
    const Column c = column(uv + p, 2, a.src_w / 2, a.src_h / 2, a.src_w, hc,
                            a.h_chr_coeff + k * a.h_chr_size, a.h_chr_size, vc, vc_coeff,
                            a.v_chr_size);
    if (a.full) {
      chroma[p] = mode == kMode1 ? (alpha < 2048 ? (c.first - (128 << 7)) * 4
                                                 : (c.first + c.second - (128 << 8)) * 2)
                                 : (c.sum + round - (1 << 26)) >> 10;
    } else {
      chroma[p] = mode == kMode1 ? (alpha < 2048 ? (c.first + 64) >> 7
                                                 : (c.first + c.second + 128) >> 8)
                                 : (c.sum + round) >> 19;
    }
  }

  const int pixels = a.full ? 1 : 2;
  for (int q = 0; q < pixels; q++) {
    const int x = a.full ? k : 2 * k + q;
    const Column l = column(y, 1, a.src_w, a.src_h, a.src_w, __ldg(a.h_lum_pos + x),
                            a.h_lum_coeff + x * a.h_lum_size, a.h_lum_size, vl, vl_coeff,
                            a.v_lum_size);
    const int luma = (l.sum + round) >> full_shift;
    uint8_t* o = out + 3 * x;
    if (a.full) {
      const unsigned yy = (unsigned)((luma - kFullYOffset) * kFullYCoeff + (1 << 21));
      const unsigned u = (unsigned)chroma[0], v = (unsigned)chroma[1];
      o[0] = (uint8_t)(clip30((int)(yy + v * (unsigned)kV2R)) >> 22);
      o[1] = (uint8_t)(clip30((int)(yy + v * (unsigned)kV2G + u * (unsigned)kU2G)) >> 22);
      o[2] = (uint8_t)(clip30((int)(yy + u * (unsigned)kU2B)) >> 22);
    } else {
      const int u = min(max(chroma[0], 0), 255), v = min(max(chroma[1], 0), 255);
      o[0] = __ldg(a.y_table + luma + __ldg(a.r_v + v));
      o[1] = __ldg(a.y_table + luma + __ldg(a.g_u + u) + __ldg(a.g_v + v));
      o[2] = __ldg(a.y_table + luma + __ldg(a.b_u + u));
    }
  }
}

}  // namespace

extern "C" int vdqn_nv12_scale_rgb(const ScaleArgs* a) {
  const int items = a->full ? a->dst_w : a->dst_w / 2;
  const int total = a->frames * a->dst_h * items;
  nv12_scale_rgb_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0, a->stream>>>(*a);
  return (int)cudaGetLastError();
}
