// Greedy fixed-shape NMS over groups of score-sorted boxes, hand-written for
// sm_90a.
//
// Replaces no TPU kernel: video_dqn_tpu/models/detector/boxes.py `nms`
// (:115-143) is a lax.fori_loop of argmax and suppress that XLA compiles
// into one device program. In eager torch the same loop costs some eight
// launches an iteration, 1,000 iterations on each of the RPN's five levels
// and 100 in the final per-class pass, so the detector's two NMS stages
// are this one kernel each. The plain twin is
// models/detector/boxes.py `nms_reference`, the JAX loop step for step.
//
// Contract (the wrapper `nms_groups` checks shapes and types):
//   boxes (G, n, 4) and scores (G, n), float32, each group in descending
//   score order (-inf last); keep (G, max_out) int32 and valid (G,
//   max_out) bool: the kept indices in score order, padded with 0 and
//   false; status (G,) int32: 1 where the group was out of order or held
//   NaN (the group then keeps nothing and the wrapper raises).
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
// Design (simple on purpose; making it fast is later work): one CTA of 256
// threads a group. The group's boxes (16 bytes each) and alive flags (one
// byte each) are staged in shared memory; every thread walks the same
// order (thread 0 writes each kept index), and at each kept candidate all
// threads suppress the later ones in parallel, then meet at a barrier. A
// dead candidate costs one shared-memory read and no barrier.
//
// Bound: operations, in the worst case. The function reads G*n*20 bytes and
// writes G*max_out*5; its work is the IoU of each kept candidate with the
// later alive ones, about 17 float operations a pair. chip_smoke.py counts
// the pairs that this run's data needs and states the bound from them.
// What holds this design back is not either: the walk is sequential, a
// barrier per kept candidate, and only G CTAs run (60 for the RPN of 12
// images, fewer than the card's 132 SMs).

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// box_iou(a, b) of boxes as float4 (x1, y1, x2, y2), operation by operation.
__device__ __forceinline__ float iou(float4 a, float area_a, float4 b) {
  const float area_b = __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
  const float w = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.0f);
  const float h = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.0f);
  const float inter = __fmul_rn(w, h);
  const float denom = __fadd_rn(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-9f);
  return __fdiv_rn(inter, denom);
}

__global__ void __launch_bounds__(kThreads) nms_kernel(
    const float4* __restrict__ boxes, const float* __restrict__ scores,
    int* __restrict__ keep, bool* __restrict__ valid, int* __restrict__ status, int n,
    int max_out, float threshold) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* s_box = reinterpret_cast<float4*>(smem);
  unsigned char* s_alive = smem + static_cast<size_t>(n) * sizeof(float4);

  const long long g = blockIdx.x;
  const float4* gb = boxes + g * n;
  const float* gs = scores + g * n;
  int* gk = keep + g * max_out;
  bool* gv = valid + g * max_out;

  int unsorted = 0;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    s_box[j] = gb[j];
    s_alive[j] = 1;
    if (j > 0 && !(gs[j] <= gs[j - 1])) unsorted = 1;  // NaN fails too
  }
  if (n > 0 && isnan(gs[0])) unsorted = 1;
  for (int k = threadIdx.x; k < max_out; k += kThreads) {
    gk[k] = 0;
    gv[k] = false;
  }
  unsorted = __syncthreads_or(unsorted);
  if (threadIdx.x == 0) status[g] = unsorted;
  if (unsorted) return;

  int count = 0;  // the same in every thread: each reads s_alive after a barrier
  for (int i = 0; i < n && count < max_out; ++i) {
    if (!s_alive[i]) continue;
    if (!(gs[i] > -INFINITY)) break;  // sorted: the rest are -inf too
    if (threadIdx.x == 0) {
      gk[count] = i;
      gv[count] = true;
    }
    ++count;
    if (count == max_out) break;
    const float4 a = s_box[i];
    const float area_a = __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
    for (int j = i + 1 + threadIdx.x; j < n; j += kThreads) {
      if (s_alive[j] && iou(a, area_a, s_box[j]) > threshold) s_alive[j] = 0;
    }
    __syncthreads();
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
  void* stream;
  int groups;
  int n;
  int max_out;
  float iou_threshold;
};

extern "C" int vdqn_nms(const NmsArgs* a) {
  const size_t smem = static_cast<size_t>(a->n) * (sizeof(float4) + 1);
  cudaError_t err = cudaFuncSetAttribute(nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_kernel<<<a->groups, kThreads, smem, static_cast<cudaStream_t>(a->stream)>>>(
      static_cast<const float4*>(a->boxes), static_cast<const float*>(a->scores),
      static_cast<int*>(a->keep), static_cast<bool*>(a->valid), static_cast<int*>(a->status),
      a->n, a->max_out, a->iou_threshold);
  return static_cast<int>(cudaGetLastError());
}
