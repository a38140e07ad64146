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
// 480 -> 224. The output is written as T = float or __nv_bfloat16 (round
// to nearest even, the cast that bf16 autocast would apply to the float).
//
// Bound: memory. The function must read B*H*W*3 bytes and write
// B*OUT*OUT*3 values of T; its arithmetic is a few FMAs per value. At
// B=96 on an H100 SXM (3.35 TB/s, 700 W limit):
//   256x342 -> 224: 25.2 MB in; 57.8 MB f32 out (24.8 us) or 28.9 MB bf16
//                   out (16.2 us);
//   224 -> 224:     14.5 MB in; 57.8 MB f32 out (21.6 us) or 28.9 MB bf16
//                   out (12.9 us).
//
// Two kernels, each templated on T:
//
// * resize_normalize_identity_kernel, for H == W == OUT, where the resample
//   matrix is exactly the identity: a flat elementwise pass. A block of 256
//   threads stages 12 KB of input in shared memory, 48 bytes a thread as
//   three 16-byte loads (lcm(16, 3) = 48, so a block starts on channel 0),
//   neighbouring threads on neighbouring words; then each thread normalizes
//   4 (f32) or 8 (bf16) consecutive values at a time and writes them with
//   one 16-byte store, again neighbouring threads on neighbouring words. A
//   last partial block, and an input base that is not 16-byte aligned (a
//   sliced batch), are staged byte by byte. No division but by constants.
//
// * resize_normalize_banded_kernel, for every other size. Grid (output-row
//   tiles of R = 8 rows, images), 256 threads. A CTA stages the input rows
//   its tile needs, [row_start[o0], row_start[o_last] + K_h) -- a
//   contiguous byte range of the NHWC image, 11 rows of 1026 bytes at
//   256x342 -> 224 -- with asynchronous 16-byte copies (cp.async) of its
//   aligned words. A word may reach past the range into neighbouring rows
//   of the same tensor; only where it would leave the tensor are the
//   range's bytes read one by one. The band tables (8 KB at 256x342 ->
//   224, the same for every CTA) are read through L1. Then a
//   vertical pass (K_h taps, M_h first as in the JAX order; 4 input columns
//   a thread, read as one realigned 32-bit word per tap) fills channel-
//   planar f32 sums (R, 3, W) in shared memory; a horizontal pass (K_w taps
//   + the normalize; one output pixel a thread, neighbouring threads on
//   neighbouring pixels) writes the tile's contiguous (R, OUT, 3) output
//   block into shared memory, over the consumed input rows, at the 16-byte
//   phase of its place in `out`; and the block leaves with 16-byte stores,
//   neighbouring threads on neighbouring words. Index math is 32-bit and
//   incremental; the only 64-bit math is the image and block base, once
//   per CTA.
//
// What the design does about the four losses of the first version (one
// thread per output pixel):
//   1. 64-bit div/mod per thread: gone (cuobjdump -sass: no subroutine
//      call; the first version called one 3 times).
//   2. K_h*K_w*3 byte loads per pixel, re-read by neighbours through L1:
//      the input is read once per CTA with 16-byte copies; taps come from
//      shared memory 4 bytes or one f32 at a time, and the separable passes
//      do K_h + K_w taps per value instead of K_h*K_w. A byte becomes a
//      float by a byte permute into 2^23's mantissa and one subtraction,
//      not a quarter-rate I2F.
//   3. 4-byte stores at a 12-byte stride: every full store is 16 bytes and
//      a warp's stores cover consecutive bytes.
//   4. f32 output that the bf16 trunk recasts: T = bf16 halves the larger
//      part of the bytes, and the trunk reads the values as they are.
//
// What holds the banded kernel back (PERF.md): not its bytes (bf16 output
// saves little) nor occupancy (4-5 CTAs an SM; more rows or fewer did not
// help), but the shared-memory traffic and instructions of its two passes,
// which a CTA runs in turn between barriers while the memory system waits.
//
// Deliberately not used: tensor cores (the work is a few FLOPs per byte,
// far below the ~295 FLOP/byte where bf16 tensor cores become the limit,
// and the TPU's dense-matmul form would multiply zeros) and TMA (a 2-D
// tensor map needs row strides that are multiples of 16 bytes; a 256x342
// frame's rows are 1026 bytes; the CTA's staged rows are one contiguous
// range, which cp.async's 16-byte copies already read at full width).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;       // identity kernel
constexpr int kChunk = 48;          // identity kernel: input bytes per thread
constexpr int kTile = kThreads * kChunk;
constexpr int kBandThreads = 256;   // banded kernel

// 255*mean and 1/(255*std) per channel, folded as the TPU kernel does.
struct Norm {
  float m0, m1, m2, i0, i1, i2;
  __device__ __forceinline__ float operator()(float v, int ch) const {
    const float m = ch == 0 ? m0 : (ch == 1 ? m1 : m2);
    const float i = ch == 0 ? i0 : (ch == 1 ? i1 : i2);
    return (v - m) * i;
  }
};

// Byte k of b as a float without I2F (a quarter-rate instruction): one
// byte permute puts it in the low mantissa bits of 2^23, minus 2^23. Exact.
__device__ __forceinline__ float u8_to_f32(uint32_t b, int k) {
  return __uint_as_float(__byte_perm(b, 0x4b000000u, 0x7440 | k)) - 8388608.0f;
}

// Asynchronous global -> shared copies (cp.async): the thread goes on while
// the copy is in flight; cp_async_wait_all waits for this thread's copies.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// 16-byte vector stores of kVec values of T, and a scalar store.
template <typename T>
struct Out;

template <>
struct Out<float> {
  static constexpr int kVec = 4;
  static __device__ __forceinline__ void store(float* dst, const float* v) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ void store_one(float* dst, float v) { *dst = v; }
};

template <>
struct Out<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* dst, const float* v) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(pack(v[0], v[1]), pack(v[2], v[3]),
                                                pack(v[4], v[5]), pack(v[6], v[7]));
  }
  static __device__ __forceinline__ void store_one(__nv_bfloat16* dst, float v) {
    *dst = __float2bfloat16_rn(v);
  }
};

// Identity: a block stages kTile input bytes in shared memory (three
// 16-byte loads a thread, neighbouring threads on neighbouring words), then
// each thread normalizes kVec values at a time and stores them with one
// 16-byte store, neighbouring threads again on neighbouring words.
template <typename T>
__global__ void __launch_bounds__(kThreads) resize_normalize_identity_kernel(
    const uint8_t* __restrict__ x, T* __restrict__ out, long long n, int vec_in,
    Norm norm) {
  constexpr int kVec = Out<T>::kVec;
  __shared__ __align__(16) uint8_t s_x[kTile];
  const long long t0 = static_cast<long long>(blockIdx.x) * kTile;
  const int m = static_cast<int>(min(static_cast<long long>(kTile), n - t0));
  const uint8_t* src = x + t0;
  if (vec_in && m == kTile) {
#pragma unroll
    for (int k = 0; k < kChunk / 16; ++k) {
      const int i = threadIdx.x + k * kThreads;
      reinterpret_cast<uint4*>(s_x)[i] = __ldg(reinterpret_cast<const uint4*>(src) + i);
    }
  } else {  // a sliced batch's unaligned base, or the last tile
    for (int i = threadIdx.x; i < m; i += kThreads) s_x[i] = src[i];
  }
  __syncthreads();
  T* dst = out + t0;
#pragma unroll
  for (int j = 0; j < kChunk / kVec; ++j) {
    const int q = (threadIdx.x + j * kThreads) * kVec;  // first value; q % 3 is its channel
    if (q >= m) break;
    uint32_t word[2];
    if (kVec == 8) {
      const uint2 w2 = *reinterpret_cast<const uint2*>(s_x + q);
      word[0] = w2.x, word[1] = w2.y;
    } else {
      word[0] = *reinterpret_cast<const uint32_t*>(s_x + q);
    }
    float v[kVec];
    int ch = q % 3;
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      v[u] = norm(u8_to_f32(word[u / 4], u % 4), ch);
      ch = ch == 2 ? 0 : ch + 1;
    }
    if (q + kVec <= m) {
      Out<T>::store(dst + q, v);
    } else {
      for (int u = 0; q + u < m; ++u) Out<T>::store_one(dst + q + u, v[u]);
    }
  }
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

template <typename T>
__global__ void __launch_bounds__(kBandThreads) resize_normalize_banded_kernel(
    const uint8_t* __restrict__ x, T* __restrict__ out,
    const int* __restrict__ row_start, const float* __restrict__ row_w, int k_h,
    const int* __restrict__ col_start, const float* __restrict__ col_w, int k_w,
    int h, int w, int out_size, int rows_per_tile, Norm norm) {
  constexpr int kVec = Out<T>::kVec;
  const int w3 = 3 * w, wp = round4(w);
  // Shared memory (ops/resize_normalize.py `banded_smem_bytes` computes the
  // same bytes): f32 vertical sums, channel-planar (R, 3, round4(W)), then
  // the staged input bytes, reused for the output tile once the vertical
  // pass has read them. The band tables stay in global memory: every CTA
  // reads the same few KB, which L1 holds.
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_v = reinterpret_cast<float*>(smem);
  uint8_t* s_in = reinterpret_cast<uint8_t*>(s_v + rows_per_tile * 3 * wp);

  const int tid = threadIdx.x;
  const int o0 = blockIdx.x * rows_per_tile;
  const int rows = min(rows_per_tile, out_size - o0);
  const int r_lo = row_start[o0];
  const int n_in = (row_start[o0 + rows - 1] + k_h - r_lo) * w3;

  // Stage the input rows -- a contiguous byte range of the NHWC image --
  // with asynchronous 16-byte copies at the range's own alignment, so that
  // byte j of the range lands at s_in[phase + j]. A word may reach past the
  // range into the tensor's neighbouring rows; only where it would leave
  // the tensor are its bytes in the range read one by one.
  const uintptr_t g0 = reinterpret_cast<uintptr_t>(
      x + (static_cast<long long>(blockIdx.y) * h + r_lo) * w3);
  const uintptr_t g1 = g0 + n_in;
  const uintptr_t a0 = g0 & ~uintptr_t(15);
  const int phase = static_cast<int>(g0 - a0);
  const uintptr_t x0 = reinterpret_cast<uintptr_t>(x);
  const uintptr_t x1 = x0 + static_cast<uintptr_t>(gridDim.y) * h * w3;
  const int n_words = static_cast<int>((g1 - a0 + 15) >> 4);
  for (int i = tid; i < n_words; i += kBandThreads) {
    const uintptr_t ga = a0 + 16u * i;
    if (ga >= x0 && ga + 16 <= x1) {
      cp_async16(s_in + 16 * i, reinterpret_cast<const void*>(ga));
    } else {
      uint8_t b[16];
#pragma unroll
      for (int u = 0; u < 16; ++u)
        b[u] = ga + u >= g0 && ga + u < g1 ? *reinterpret_cast<const uint8_t*>(ga + u) : 0;
#pragma unroll
      for (int u = 0; u < 16; ++u) s_in[16 * i + u] = b[u];
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // Vertical pass, 4 neighbouring input columns (bytes of the NHWC row) of
  // one output row a thread, neighbouring threads on neighbouring columns:
  // each tap's 4 bytes come from the two aligned 32-bit words around them.
  // Columns past W*3 in the last group are computed and dropped.
  {
    const int groups = (w3 + 3) >> 2;
    const int dr = kBandThreads / groups, dg = kBandThreads - dr * groups;
    int r = tid / groups, g = tid - r * groups;
    for (int e = tid; e < rows * groups; e += kBandThreads) {
      const int a = phase + (__ldg(row_start + o0 + r) - r_lo) * w3 + 4 * g;
      const float* wr = row_w + (o0 + r) * k_h;
      float sum[4] = {0.f, 0.f, 0.f, 0.f};
      for (int i = 0; i < k_h; ++i) {
        const int ai = a + i * w3;
        const uint32_t* word = reinterpret_cast<const uint32_t*>(s_in + (ai & ~3));
        const uint32_t bytes = __funnelshift_r(word[0], word[1], 8 * (ai & 3));
        const float wt = __ldg(wr + i);
#pragma unroll
        for (int k = 0; k < 4; ++k) sum[k] = fmaf(wt, u8_to_f32(bytes, k), sum[k]);
      }
      // column c = 3*q + ch goes to channel plane ch at pixel q
      const int c = 4 * g, q = c / 3;
      int ch = c - 3 * q;
      float* v = s_v + (r * 3 + ch) * wp + q;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (c + u < w3) *v = sum[u];
        if (++ch == 3) ch = 0, v += 1 - 2 * wp;  // next pixel, plane 0
        else v += wp;
      }
      r += dr, g += dg;
      if (g >= groups) g -= groups, ++r;
    }
  }
  __syncthreads();

  // Horizontal pass + normalize, one output pixel (3 channels) a thread,
  // neighbouring threads on neighbouring pixels, into the output tile in
  // shared memory at the 16-byte phase of its place in `out`; then 16-byte
  // stores of the tile's contiguous (rows, OUT, 3) block, neighbouring
  // threads on neighbouring words.
  T* dst = out + (static_cast<long long>(blockIdx.y) * out_size + o0) * out_size * 3;
  const int shift = static_cast<int>((reinterpret_cast<uintptr_t>(dst) & 15) / sizeof(T));
  T* s_out = reinterpret_cast<T*>(s_in) + shift;
  {
    const int dr = kBandThreads / out_size, dp = kBandThreads - dr * out_size;
    int r = tid / out_size, p = tid - r * out_size;
    for (int k = tid; k < rows * out_size; k += kBandThreads) {
      const float* v = s_v + r * 3 * wp + __ldg(col_start + p);
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
      for (int j = 0; j < k_w; ++j) {
        const float wj = __ldg(col_w + j * out_size + p);
        s0 = fmaf(wj, v[j], s0);
        s1 = fmaf(wj, v[wp + j], s1);
        s2 = fmaf(wj, v[2 * wp + j], s2);
      }
      Out<T>::store_one(s_out + 3 * k + 0, norm(s0, 0));
      Out<T>::store_one(s_out + 3 * k + 1, norm(s1, 1));
      Out<T>::store_one(s_out + 3 * k + 2, norm(s2, 2));
      r += dr, p += dp;
      if (p >= out_size) p -= out_size, ++r;
    }
  }
  __syncthreads();
  const int n = rows * out_size * 3;
  const int n_out = (shift + n + kVec - 1) / kVec;
  T* base = dst - shift;  // 16-byte aligned; s_in holds base's words in order
  for (int i = tid; i < n_out; i += kBandThreads) {
    const int k0 = i * kVec - shift;
    if (k0 >= 0 && k0 + kVec <= n) {
      *reinterpret_cast<uint4*>(base + i * kVec) = reinterpret_cast<const uint4*>(s_in)[i];
    } else {
      for (int u = 0; u < kVec; ++u)
        if (k0 + u >= 0 && k0 + u < n) base[i * kVec + u] = s_out[k0 + u];
    }
  }
}

template <typename T>
int launch_identity(const void* x, void* out, long long n, Norm norm, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n + kTile - 1) / kTile);
  const int vec_in = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  resize_normalize_identity_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<T*>(out), n, vec_in, norm);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_banded(const void* x, void* out, const void* row_start, const void* row_w,
                  int k_h, const void* col_start, const void* col_w, int k_w, int batch,
                  int h, int w, int out_size, int rows_per_tile, int smem_bytes, Norm norm,
                  cudaStream_t stream) {
  // above 48 KB the kernel must be allowed more
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        resize_normalize_banded_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((out_size + rows_per_tile - 1) / rows_per_tile, batch);
  resize_normalize_banded_kernel<T><<<grid, kBandThreads, smem_bytes, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<T*>(out),
      static_cast<const int*>(row_start), static_cast<const float*>(row_w), k_h,
      static_cast<const int*>(col_start), static_cast<const float*>(col_w), k_w,
      h, w, out_size, rows_per_tile, norm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The C entries take their arguments as one struct, which the wrapper
// (ops/resize_normalize.py `_IdentityArgs`, `_BandedArgs`) mirrors and
// keeps filled between calls. norm is 255*mean then 1/(255*std) per
// channel; out_bf16 picks the output type (0: float, 1: bf16). Each entry
// launches on `stream` and returns the first CUDA error (0 when the launch
// was taken).

// Identity resample (H == W == OUT): x uint8 and out T, both n values,
// contiguous, out 16-byte aligned.
struct IdentityArgs {
  const void* x;
  void* out;
  void* stream;
  long long n;
  int out_bf16;
  float norm[6];
};

extern "C" int vdqn_resize_normalize_identity(const IdentityArgs* a) {
  if (reinterpret_cast<uintptr_t>(a->out) & 15) return static_cast<int>(cudaErrorMisalignedAddress);
  if (a->n == 0) return static_cast<int>(cudaGetLastError());
  const Norm norm{a->norm[0], a->norm[1], a->norm[2], a->norm[3], a->norm[4], a->norm[5]};
  const auto s = static_cast<cudaStream_t>(a->stream);
  return a->out_bf16 ? launch_identity<__nv_bfloat16>(a->x, a->out, a->n, norm, s)
                     : launch_identity<float>(a->x, a->out, a->n, norm, s);
}

// Banded resample: x uint8 (batch, h, w, 3), out T (batch, out_size,
// out_size, 3), both contiguous, batch <= 65535. row_start/row_w: int32
// (out_size,) and f32 (out_size, k_h), starts non-decreasing with
// row_start[o] + k_h <= h; col_start: int32 (out_size,) likewise over w;
// col_w: f32 (k_w, out_size), transposed. rows_per_tile output rows per
// CTA, with smem_bytes of dynamic shared memory, as ops/resize_normalize.py
// `kernel_plan` computes them.
struct BandedArgs {
  const void* x;
  void* out;
  const void* row_start;
  const void* row_w;
  const void* col_start;
  const void* col_w;
  void* stream;
  int k_h, k_w, h, w, out_size, rows_per_tile, smem_bytes, batch, out_bf16;
  float norm[6];
};

extern "C" int vdqn_resize_normalize_banded(const BandedArgs* a) {
  if (a->batch == 0) return static_cast<int>(cudaGetLastError());
  const Norm norm{a->norm[0], a->norm[1], a->norm[2], a->norm[3], a->norm[4], a->norm[5]};
  const auto s = static_cast<cudaStream_t>(a->stream);
  return a->out_bf16
      ? launch_banded<__nv_bfloat16>(a->x, a->out, a->row_start, a->row_w, a->k_h, a->col_start,
                                     a->col_w, a->k_w, a->batch, a->h, a->w, a->out_size,
                                     a->rows_per_tile, a->smem_bytes, norm, s)
      : launch_banded<float>(a->x, a->out, a->row_start, a->row_w, a->k_h, a->col_start,
                             a->col_w, a->k_w, a->batch, a->h, a->w, a->out_size,
                             a->rows_per_tile, a->smem_bytes, norm, s);
}
