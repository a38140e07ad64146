// Fused uint8 resize + ImageNet normalize, hand-written for sm_90a.
//
// Replaces the repo's one TPU kernel: video_dqn_tpu/ops/pallas_image.py
// `resize_normalize_pallas` (body `_kernel`, pl.pallas_call at :105). That
// kernel runs two dense MXU matmuls per image, Y = M_h @ X and
// Z = Y @ kron(M_w, I3)^T, against interpolation matrices that are almost
// all zeros. Here the wrapper (ops/resize_normalize.py) hands the kernel
// those matrices as padded band tables, derived from the dense matrices'
// nonzeros: for each output row (column) the first input row (column) and
// K weights. K is 1 at identity size and 3, 4 and 5 for 256, 342 and
// 480 -> 224. So each output pixel reads only its K_h x K_w input taps.
//
// Bound: memory. The function must read B*H*W*3 bytes and write
// B*OUT*OUT*3 floats; its arithmetic is a few FMAs per output value. At
// B=96, 256x342 -> 224 that is 25.2 MB + 57.8 MB, about 25 us at the H100
// SXM's 3.35 TB/s; at B=96, 224 -> 224 it is 14.5 MB + 57.8 MB, about 22 us.
//
// Design (the simple, right first version): one thread per output pixel
// (b, o, p) computes all three channels. A K_h x K_w band loop widens
// uint8 loads to f32 and accumulates in f32; the normalize is fused into
// the store, so nothing but the output touches device memory. The output
// is a contiguous (B, OUT, OUT, 3) f32 tensor, which the wrapper returns
// as an NCHW channels_last view with no copy. Input taps shared by
// neighbouring pixels are re-read through L1/L2 rather than staged in
// shared memory. The output's 4-byte floats are 70-80% of the bytes, so
// the next step is a bf16 output (and shared-memory staging of the input
// rows), not more arithmetic.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void resize_normalize_u8_kernel(
    const uint8_t* __restrict__ x, float* __restrict__ out,
    const int* __restrict__ row_start, const float* __restrict__ row_w, int k_h,
    const int* __restrict__ col_start, const float* __restrict__ col_w, int k_w,
    long long n_pixels, int h, int w, int out_h, int out_w,
    float3 mean, float3 inv_std) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n_pixels) return;
  const int p = static_cast<int>(idx % out_w);
  const int o = static_cast<int>((idx / out_w) % out_h);
  const long long b = idx / (static_cast<long long>(out_w) * out_h);

  const uint8_t* img = x + b * h * w * 3;
  const uint8_t* row0 = img + (static_cast<long long>(row_start[o]) * w + col_start[p]) * 3;
  const float* wr = row_w + static_cast<long long>(o) * k_h;
  const float* wc = col_w + static_cast<long long>(p) * k_w;

  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  for (int i = 0; i < k_h; ++i) {
    const uint8_t* px = row0 + static_cast<long long>(i) * w * 3;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int j = 0; j < k_w; ++j) {
      const float wj = wc[j];
      s0 = fmaf(wj, static_cast<float>(px[3 * j + 0]), s0);
      s1 = fmaf(wj, static_cast<float>(px[3 * j + 1]), s1);
      s2 = fmaf(wj, static_cast<float>(px[3 * j + 2]), s2);
    }
    const float wi = wr[i];
    a0 = fmaf(wi, s0, a0);
    a1 = fmaf(wi, s1, a1);
    a2 = fmaf(wi, s2, a2);
  }
  float* dst = out + idx * 3;
  dst[0] = (a0 - mean.x) * inv_std.x;
  dst[1] = (a1 - mean.y) * inv_std.y;
  dst[2] = (a2 - mean.z) * inv_std.z;
}

}  // namespace

// x: uint8 (batch, h, w, 3); out: f32 (batch, out_h, out_w, 3); both
// contiguous. row_start/row_w: int32 (out_h,) and f32 (out_h, k_h), with
// row_start[o] + k_h <= h; col_start/col_w likewise over w. Launches on
// `stream` and returns cudaGetLastError() (0 when the launch was taken).
extern "C" int vdqn_resize_normalize_u8(
    const void* x, void* out,
    const void* row_start, const void* row_w, int k_h,
    const void* col_start, const void* col_w, int k_w,
    int batch, int h, int w, int out_h, int out_w,
    float mean0, float mean1, float mean2,
    float inv0, float inv1, float inv2,
    void* stream) {
  const long long n_pixels = static_cast<long long>(batch) * out_h * out_w;
  if (n_pixels == 0) return static_cast<int>(cudaGetLastError());
  const unsigned blocks = static_cast<unsigned>((n_pixels + kThreads - 1) / kThreads);
  resize_normalize_u8_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<float*>(out),
      static_cast<const int*>(row_start), static_cast<const float*>(row_w), k_h,
      static_cast<const int*>(col_start), static_cast<const float*>(col_w), k_w,
      n_pixels, h, w, out_h, out_w,
      make_float3(mean0, mean1, mean2), make_float3(inv0, inv1, inv2));
  return static_cast<int>(cudaGetLastError());
}
