// Greedy fixed-shape NMS over groups of score-sorted boxes, hand-written for
// sm_90a: an IoU bitmask spread over the card, then a warp-serial scan.
//
// Replaces no TPU kernel: video_dqn_tpu/models/detector/boxes.py `nms`
// (:115-143) is a lax.fori_loop of argmax and suppress that XLA compiles
// into one device program. In eager torch the same loop costs some eight
// launches an iteration, 1,000 iterations on each of the RPN's five levels
// and 100 in the final per-class pass, so the detector's two NMS stages
// are one call of vdqn_nms each. The plain twin is
// models/detector/boxes.py `nms_reference`, the JAX loop step for step.
//
// Contract (the wrapper `nms_groups` checks shapes and types):
//   boxes (G, n, 4) and scores (G, n), float32, each group in descending
//   score order (-inf last); keep (G, max_out) int32 and valid (G,
//   max_out) bool: the kept indices in score order, padded with 0 and
//   false; status (G,) int32: 1 where the group was out of order or held
//   NaN (the group then keeps nothing; the wrapper raises, or hands the
//   status to its caller to read later); workspace: from the wrapper, the
//   mask's G * ceil(n / 64) * n 64-bit words, then G * ceil(n / 64) ints.
// With the scores sorted, the JAX loop's argmax over the alive candidates
// is the first alive candidate, so the loop becomes a walk: a candidate
// with a finite score that is still alive is kept, then every later
// candidate whose IoU with it is above the threshold is suppressed; the
// walk stops after max_out kept or at the first -inf. The IoU is
// box_iou's, inter / (area_a + area_b - inter + 1e-9), with each
// operation rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn) so that no contraction into an FMA can flip a decision the
// twin makes; the comparison is the twin's strict `>`.
//
// Design: two kernels, launched back to back on the caller's stream.
//  1. nms_mask_kernel computes every IoU the walk could need, as a bitmask:
//     bit j of word (g, j / 64, i) is set where j > i and iou(i, j) is
//     above the threshold. One CTA of 64 threads a (group, 64-column
//     block, 64-row block) tile with the column block at or right of the
//     row block, a 1-D grid over the upper triangle's tiles only: 60 x 136
//     tiles for the RPN of 12 images. The column
//     block's boxes are staged in shared memory and each thread builds its
//     row's word; the mask is word-major, so a tile's 64 stores are
//     contiguous. Each decision is the twin's: the numerator and
//     denominator are rounded op by op as above, a fast quotient
//     (__fdividef, within 2 ulp) decides where it lies further than 1e-5
//     from the threshold, and __fdiv_rn decides the rest. A tile whose
//     row or column block starts at -inf is skipped: in a sorted group the
//     walk never reaches it (and an unsorted group keeps nothing, whatever
//     its mask holds).
//     The diagonal tiles also check the order of their block's scores
//     against the score before it (NaN fails) and count its finite scores,
//     an int a block in the workspace, so that no serial pass over the
//     scores is left for the scan.
//  2. nms_scan_kernel walks each group with one warp. It reads its blocks'
//     order checks (any failed: status 1, nothing kept) and finite counts
//     (their sum is L), then takes the row blocks below L in order. A
//     block's mask rows (its words from its own block to the last
//     below L) are staged in shared memory by cp.async, the next block's
//     while this one is walked, so a step waits on shared memory and not
//     on device memory. The 64 decisions inside a block are a chain on one
//     word, the block's "removed" bits: candidate t is kept where its bit
//     is clear, and a kept candidate ORs in its diagonal word. Every lane
//     runs that chain from broadcast reads, so the block's kept set ends as
//     one 64-bit word in every lane, with no shuffle and no barrier; the
//     lanes then write the kept indices in parallel and OR the kept rows
//     into the later removed words, a word a lane, 64 independent
//     shared-memory reads a word.
//
// Bound: operations, in the worst case. The function reads G*n*20 bytes and
// writes G*max_out*5; its work is the IoU of each kept candidate with the
// later alive ones, about 17 float operations a pair. chip_smoke.py counts
// the pairs that this run's data needs and states the bound from them.
// The mask computes more than that, every pair of a group below its first
// -inf, and the scan stays serial: 64 dependent steps a block, a block
// after the other.

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 64;  // candidates a row or column block: the bits of a mask word
constexpr int kWarp = 32;
constexpr unsigned kFullWarp = 0xffffffffu;

using u64 = unsigned long long;

// box_iou(a, b) of boxes as float4 (x1, y1, x2, y2), operation by operation,
// as its numerator and denominator: the IoU is __fdiv_rn(inter, denom).
__device__ __forceinline__ float2 iou_terms(float4 a, float area_a, float4 b) {
  const float area_b = __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
  const float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(w, h);
  return make_float2(inter, __fadd_rn(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-9f));
}

// Words of a group's mask row: one a 64-candidate block.
__host__ __device__ __forceinline__ int mask_words(int n) { return (n + kBlock - 1) / kBlock; }

// Shared-memory row pitch of the scan's staged blocks, in words: odd, so
// that the lanes' reads of one word of 32 rows fall in other banks.
__host__ __device__ __forceinline__ int staged_pitch(int n) { return mask_words(n) | 1; }

// Tiles of a group's upper triangle: (column block, row block) pairs with
// the row block at or left of the column block.
__host__ __device__ __forceinline__ long long triangle_tiles(int words) {
  return static_cast<long long>(words) * (words + 1) / 2;
}

// grid (G * triangle_tiles(words),), kBlock threads: CTA b is group b % G,
// tile b / G, the tiles taken column by column (column block cb holds row
// blocks 0 .. cb). A diagonal tile also checks its block's score order and
// counts its finite scores into info[g * words + block]: -1 where out of
// order (or NaN), else the count.
__global__ void __launch_bounds__(kBlock) nms_mask_kernel(
    const float4* __restrict__ boxes, const float* __restrict__ scores, u64* __restrict__ mask,
    int* __restrict__ info, int groups, int n, float threshold) {
  const long long g = blockIdx.x % groups;
  const int tile = static_cast<int>(blockIdx.x / groups);
  int cb = static_cast<int>((sqrtf(8.0f * tile + 1.0f) - 1.0f) * 0.5f);
  while (cb * (cb + 1) / 2 > tile) --cb;  // the float root may be one off
  while ((cb + 1) * (cb + 2) / 2 <= tile) ++cb;
  const int rb = tile - cb * (cb + 1) / 2;
  const float* gs = scores + g * n;
  const int t = threadIdx.x;
  const int words = mask_words(n);
  if (cb == rb) {
    const int j = rb * kBlock + t;
    const float s = j < n ? gs[j] : -INFINITY;
    const float prev = j == 0 ? INFINITY : j < n ? gs[j - 1] : -INFINITY;
    const int bad = __syncthreads_or(!(s <= prev));  // NaN fails the order too
    const int finite = __syncthreads_count(s > -INFINITY);
    if (t == 0) info[g * words + rb] = bad ? -1 : finite;
  }
  if (!(gs[rb * kBlock] > -INFINITY) || !(gs[cb * kBlock] > -INFINITY)) return;
  const float4* gb = boxes + g * n;
  __shared__ float4 s_col[kBlock];
  const int col = cb * kBlock + t;
  s_col[t] = col < n ? gb[col] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();
  const int i = rb * kBlock + t;
  if (i >= n) return;
  const float4 a = gb[i];
  const float area_a = __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
  // __fdividef is within 2 ulp of the rounded quotient for |denom| in
  // [2^-126, 2^126]; where it lies further than 1e-5 * max(1, |q|) from the
  // threshold it decides as the rounded one does, else (and at any NaN,
  // infinity or extreme denominator) the pair is decided again by __fdiv_rn
  u64 bits = 0, unsure = 0;
#pragma unroll 8
  for (int j = 0; j < kBlock; ++j) {
    const float2 f = iou_terms(a, area_a, s_col[j]);
    const float q = __fdividef(f.x, f.y);
    const bool sure = fabsf(q - threshold) > 1e-5f * fmaxf(1.0f, fabsf(q)) &&
                      fabsf(f.y) >= 1e-30f && fabsf(f.y) <= 1e30f;
    bits |= static_cast<u64>(sure && q > threshold) << j;
    unsure |= static_cast<u64>(!sure) << j;
  }
  for (; unsure; unsure &= unsure - 1) {
    const int j = __ffsll(static_cast<long long>(unsure)) - 1;
    const float2 f = iou_terms(a, area_a, s_col[j]);
    if (__fdiv_rn(f.x, f.y) > threshold) bits |= 1ull << j;
  }
  const int cols = n - cb * kBlock;
  if (cols < kBlock) bits &= (1ull << cols) - 1;
  if (cb == rb) bits &= t == kBlock - 1 ? 0ull : ~0ull << (t + 1);
  mask[(g * words + cb) * n + i] = bits;
}

// grid (G,), one warp; dynamic shared memory: two staged blocks of kBlock
// rows x staged_pitch(n) words, then mask_words(n) removed words.
__global__ void __launch_bounds__(kWarp) nms_scan_kernel(
    const u64* __restrict__ mask, const int* __restrict__ info, int* __restrict__ keep,
    bool* __restrict__ valid, int* __restrict__ status, int n, int max_out) {
  extern __shared__ __align__(16) u64 smem[];
  const int lane = threadIdx.x;
  const long long g = blockIdx.x;
  const int words = mask_words(n), pitch = staged_pitch(n);
  const u64* gm = mask + g * words * n;
  int* gk = keep + g * max_out;
  bool* gv = valid + g * max_out;

  // the blocks' order checks and finite counts, from the mask kernel
  int unsorted = 0, finite = 0;
  for (int b = lane; b < words; b += kWarp) {
    const int v = info[g * words + b];
    if (v < 0) unsorted = 1;
    finite += max(v, 0);
  }
  unsorted = __any_sync(kFullWarp, unsorted);
  finite = static_cast<int>(__reduce_add_sync(kFullWarp, static_cast<unsigned>(finite)));
  if (lane == 0) status[g] = unsorted;

  int count = 0;
  if (!unsorted) {
    // the row blocks the walk can reach: those that start below L
    const int blocks = mask_words(finite);
    u64* removed = smem + 2 * kBlock * pitch;
    for (int w = lane; w < blocks; w += kWarp) removed[w] = 0;
    // block rb's rows (below n), words rb .. blocks - 1, into its buffer as
    // [row][word - rb]
    auto stage = [&](int rb) {
      u64* dst = smem + (rb & 1) * kBlock * pitch;
      const int rows = min(kBlock, n - rb * kBlock);
      const int span = (blocks - rb) * kBlock;
      const u64* src = gm + static_cast<long long>(rb) * n + rb * kBlock;
#pragma unroll 4
      for (int e = lane; e < span; e += kWarp) {
        const int t = e % kBlock, k = e / kBlock;
        if (t < rows) __pipeline_memcpy_async(dst + t * pitch + k, src + k * n + t, sizeof(u64));
      }
    };
    if (blocks > 0) stage(0);
    __pipeline_commit();
    for (int rb = 0; rb < blocks; ++rb) {
      if (rb + 1 < blocks) stage(rb + 1);
      __pipeline_commit();  // one group an iteration, empty at the last block
      __pipeline_wait_prior(1);
      __syncwarp();
      const u64* rows = smem + (rb & 1) * kBlock * pitch;
      const int left = finite - rb * kBlock;  // >= 1
      const u64 past = left >= kBlock ? 0ull : ~0ull << left;
      // the chain: t is kept where its bit is clear, and then ORs in its
      // diagonal word (bits above t only), so a kept t's bit stays clear.
      // The diagonal words are loaded first, so that each step waits on
      // registers; a candidate in the upper half sets no bit of the lower.
      unsigned lo_diag[kBlock / 2], hi_diag[kBlock];
#pragma unroll
      for (int t = 0; t < kBlock; ++t) {
        const u64 d = rows[t * pitch];
        if (t < kBlock / 2) lo_diag[t] = static_cast<unsigned>(d);
        hi_diag[t] = static_cast<unsigned>(d >> 32);
      }
      const u64 start = removed[rb] | past;
      unsigned lo = static_cast<unsigned>(start), hi = static_cast<unsigned>(start >> 32);
#pragma unroll
      for (int t = 0; t < kBlock / 2; ++t) {
        const unsigned alive = ((lo >> t) & 1u) - 1u;  // all ones where t is kept
        lo |= lo_diag[t] & alive;
        hi |= hi_diag[t] & alive;
      }
#pragma unroll
      for (int t = kBlock / 2; t < kBlock; ++t) {
        hi |= hi_diag[t] & (((hi >> (t - kBlock / 2)) & 1u) - 1u);
      }
      u64 kept = ~((static_cast<u64>(hi) << 32) | lo);
      const int room = max_out - count;
      int got = __popcll(kept);
      if (got > room) {  // the walk ends at max_out: keep the block's first `room`
        u64 rest = kept;
        for (int c = 0; c < room; ++c) rest &= rest - 1;
        kept &= ~rest;
        got = room;
      }
      for (int t = lane; t < kBlock; t += kWarp) {
        if ((kept >> t) & 1ull) {
          const int pos = count + __popcll(kept & ((1ull << t) - 1));
          gk[pos] = rb * kBlock + t;
          gv[pos] = true;
        }
      }
      count += got;
      if (count == max_out) break;
      if (kept) {  // the kept rows into the later removed words, a word a lane
        for (int w = rb + 1 + lane; w < blocks; w += kWarp) {
          const u64* col = rows + (w - rb);
          u64 acc = 0;
#pragma unroll
          for (int t = 0; t < kBlock; ++t) acc |= col[t * pitch] & (0ull - ((kept >> t) & 1ull));
          removed[w] |= acc;
        }
      }
      __syncwarp();
    }
    __pipeline_wait_prior(0);
  }
  for (int k = count + lane; k < max_out; k += kWarp) {
    gk[k] = 0;
    gv[k] = false;
  }
}

}  // namespace

// The C entry takes its arguments as one struct, which the wrapper
// (models/detector/boxes.py `_NmsArgs`) mirrors field for field.
struct NmsArgs {
  const void* boxes;
  const void* scores;
  void* keep;
  void* valid;
  void* status;
  void* workspace;
  void* stream;
  int groups;
  int n;
  int max_out;
  float iou_threshold;
};

extern "C" int vdqn_nms(const NmsArgs* a) {
  // the scan's shared memory: 199,168 bytes at n = 12,288, within the 227 KB
  // a block may use
  const int smem = static_cast<int>(
      (2 * static_cast<size_t>(kBlock) * staged_pitch(a->n) + mask_words(a->n)) * sizeof(u64));
  // above 48 KB (n above 3,008: none of the detector's calls) the kernel
  // must be allowed more
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const auto stream = static_cast<cudaStream_t>(a->stream);
  const int words = mask_words(a->n);
  const long long ctas = a->groups * triangle_tiles(words);
  if (ctas > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  // the workspace: the mask, G * words * n words, then G * words block infos
  u64* mask = static_cast<u64*>(a->workspace);
  int* info = reinterpret_cast<int*>(mask + static_cast<size_t>(a->groups) * words * a->n);
  nms_mask_kernel<<<static_cast<unsigned>(ctas), kBlock, 0, stream>>>(
      static_cast<const float4*>(a->boxes), static_cast<const float*>(a->scores), mask, info,
      a->groups, a->n, a->iou_threshold);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_scan_kernel<<<a->groups, kWarp, smem, stream>>>(
      mask, info, static_cast<int*>(a->keep), static_cast<bool*>(a->valid),
      static_cast<int*>(a->status), a->n, a->max_out);
  return static_cast<int>(cudaGetLastError());
}
