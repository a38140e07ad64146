// Fast-marching eikonal solver on a masked 2-D grid: the port's copy of
// native/fmm/fmm.cc, built into the port's host library
// (video_dqn_tpu_torch/_build.py, libvdqn_host.so) and called through
// video_dqn_tpu_torch/ops/fmm.py.
//
// Solves |grad T| = 1 with the first-order upwind discretization and a
// binary min-heap (what scikit-fmm does for a masked grid with the goal at
// 0 and dx = 1). The eval planner makes ~150 bounded solves per episode
// over a grid whose wavefront touches a small band, so a solve's O(n) work
// is only the +inf fill of its output:
//   * no `accepted` array: lazy heap deletion (a popped entry is final iff
//     its key equals the cell's current value);
//   * no mask copy: goal cells are flipped traversible in the caller's
//     buffer and restored before returning (single-threaded contract);
//   * the bounded variant's reset of tentative values walks only the
//     bounding box the wavefront touched.
//
// C ABI (ctypes):
//   vdqn_fmm_distance(mask, h, w, goals_y, goals_x, n_goals, out)
//     mask:  uint8[h*w], 1 = traversible, 0 = obstacle (masked out);
//            modified in place for the solve (goal unmask) and restored
//            on return: pass a buffer no other thread is reading
//     goals: arrays of n_goals seed cells (distance 0)
//     out:   float64[h*w]; +inf for unreached or masked cells
//   vdqn_fmm_distance_bounded(..., early_y, early_x, margin, max_dist, out)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <utility>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

struct HeapItem {
  double t;
  int idx;
  bool operator>(const HeapItem& o) const { return t > o.t; }
};

// Solve the quadratic for the upwind update at a cell given the smaller
// accepted neighbor values along x and y.
inline double solve_eikonal(double tx, double ty) {
  double tmin = std::min(tx, ty), tmax = std::max(tx, ty);
  if (tmax == kInf) return tmin + 1.0;
  double diff = tmax - tmin;
  if (diff >= 1.0) return tmin + 1.0;
  // (T - tx)^2 + (T - ty)^2 = 1
  double s = tx + ty;
  double disc = s * s - 2.0 * (tx * tx + ty * ty - 1.0);
  return 0.5 * (s + std::sqrt(disc));
}

// Shared solver core. `early_idx` < 0 disables the early-stop target;
// `max_dist` < 0 disables the hard bound. Returns the touched bounding
// box (y0, y1, x0, x1 inclusive; y0 > y1 when nothing was touched) and
// the final stop threshold via *stop_out (kInf for unbounded runs).
void march(uint8_t* mask, int h, int w, const int32_t* goals_y,
           const int32_t* goals_x, int n_goals, int early_idx, double margin,
           double max_dist, double* out, int* bbox, double* stop_out) {
  const int n = h * w;
  for (int i = 0; i < n; ++i) out[i] = kInf;

  // Goal cells are forced traversible, as the reference planner unmasks
  // the goal before solving. A waypoint whose cell was mapped as
  // an obstacle after selection must still yield a distance field. The
  // caller's mask is modified in place and restored by our caller.
  std::priority_queue<HeapItem, std::vector<HeapItem>, std::greater<HeapItem>>
      heap;
  int y0 = h, y1 = -1, x0 = w, x1 = -1;
  for (int g = 0; g < n_goals; ++g) {
    int y = goals_y[g], x = goals_x[g];
    if (y < 0 || y >= h || x < 0 || x >= w) continue;
    int idx = y * w + x;
    mask[idx] = 1;
    out[idx] = 0.0;
    heap.push({0.0, idx});
    y0 = std::min(y0, y); y1 = std::max(y1, y);
    x0 = std::min(x0, x); x1 = std::max(x1, x);
  }
  double stop_at = (max_dist >= 0) ? max_dist : kInf;

  const int dy[4] = {-1, 1, 0, 0};
  const int dx[4] = {0, 0, -1, 1};

  while (!heap.empty()) {
    HeapItem cur = heap.top();
    if (cur.t > stop_at) break;
    heap.pop();
    // lazy deletion: out[idx] only ever decreases, and a pop whose key
    // matches the current value is the cell's final (minimal) entry
    if (cur.t != out[cur.idx]) continue;
    if (cur.idx == early_idx) {
      double lim = cur.t + margin;
      if (lim < stop_at) stop_at = lim;
    }
    int cy = cur.idx / w, cx = cur.idx % w;
    for (int k = 0; k < 4; ++k) {
      int ny = cy + dy[k], nx = cx + dx[k];
      if (ny < 0 || ny >= h || nx < 0 || nx >= w) continue;
      int nidx = ny * w + nx;
      if (!mask[nidx]) continue;
      // upwind neighbors of the candidate
      double tx = kInf, ty = kInf;
      if (nx > 0 && mask[nidx - 1]) tx = std::min(tx, out[nidx - 1]);
      if (nx < w - 1 && mask[nidx + 1]) tx = std::min(tx, out[nidx + 1]);
      if (ny > 0 && mask[nidx - w]) ty = std::min(ty, out[nidx - w]);
      if (ny < h - 1 && mask[nidx + w]) ty = std::min(ty, out[nidx + w]);
      double t = solve_eikonal(tx, ty);
      if (t < out[nidx]) {
        out[nidx] = t;
        heap.push({t, nidx});
        y0 = std::min(y0, ny); y1 = std::max(y1, ny);
        x0 = std::min(x0, nx); x1 = std::max(x1, nx);
      }
    }
  }
  bbox[0] = y0; bbox[1] = y1; bbox[2] = x0; bbox[3] = x1;
  *stop_out = stop_at;
}

// Record goal cells' original mask bytes for restore (march() itself
// flips them traversible at seeding).
std::vector<std::pair<int, uint8_t>> flip_goals(uint8_t* mask, int h, int w,
                                                const int32_t* gy,
                                                const int32_t* gx, int n) {
  std::vector<std::pair<int, uint8_t>> saved;
  saved.reserve(n);
  for (int g = 0; g < n; ++g) {
    int y = gy[g], x = gx[g];
    if (y < 0 || y >= h || x < 0 || x >= w) continue;
    int idx = y * w + x;
    saved.emplace_back(idx, mask[idx]);
  }
  return saved;
}

void restore_goals(uint8_t* mask,
                   const std::vector<std::pair<int, uint8_t>>& saved) {
  for (auto it = saved.rbegin(); it != saved.rend(); ++it)
    mask[it->first] = it->second;
}

}  // namespace

extern "C" {

void vdqn_fmm_distance(uint8_t* mask, int h, int w, const int32_t* goals_y,
                       const int32_t* goals_x, int n_goals, double* out) {
  auto saved = flip_goals(mask, h, w, goals_y, goals_x, n_goals);
  int bbox[4];
  double stop_at;
  march(mask, h, w, goals_y, goals_x, n_goals, /*early_idx=*/-1,
        /*margin=*/0.0, /*max_dist=*/-1.0, out, bbox, &stop_at);
  restore_goals(mask, saved);
}

// Bounded variant: identical wavefront, but stops early when
//  (a) the target cell (early_y, early_x) has been accepted AND the next
//      heap distance exceeds accepted_target_dist + margin, or
//  (b) the next heap distance exceeds max_dist (when max_dist >= 0).
// Cells never accepted stay +inf. Because FMM accepts cells in
// non-decreasing distance order, every cell whose true distance is within
// the bound carries its exact full-solve value — the planner only reads
// cells near the agent, so bounded solves are drop-in.
void vdqn_fmm_distance_bounded(uint8_t* mask, int h, int w, const int32_t* goals_y,
                               const int32_t* goals_x, int n_goals, int early_y,
                               int early_x, double margin, double max_dist,
                               double* out) {
  auto saved = flip_goals(mask, h, w, goals_y, goals_x, n_goals);
  const int early_idx =
      (early_y >= 0 && early_y < h && early_x >= 0 && early_x < w)
          ? early_y * w + early_x
          : -1;
  int bbox[4];
  double stop_at;
  march(mask, h, w, goals_y, goals_x, n_goals, early_idx, margin, max_dist,
        out, bbox, &stop_at);
  restore_goals(mask, saved);
  // tentative (never-finalized) cells hold values > stop_at (their best
  // heap entries were above the cutoff when the march stopped): reset to
  // +inf, walking only the touched bounding box
  if (stop_at != kInf) {
    for (int y = bbox[0]; y <= bbox[1]; ++y) {
      double* row = out + (size_t)y * w;
      for (int x = bbox[2]; x <= bbox[3]; ++x) {
        if (row[x] > stop_at) row[x] = kInf;
      }
    }
  }
}

}  // extern "C"
