// Batched RGB-D raycasting over an occupancy grid: the port's copy of
// native/simcore/raycast.cc, built into the port's host library
// (video_dqn_tpu_torch/_build.py, libvdqn_host.so) and called through
// video_dqn_tpu_torch/sim/native_render.py.
//
// The renderer of the fake navigation env (sim/fake_env.py): V views in
// one call, z-buffer depth and a deterministic per-cell RGB. Its semantics
// follow the env's Python renderer (same DDA step, same shading), which
// stays as the test oracle.
//
// C ABI (ctypes):
//   vdqn_render_views(grid, gh, gw, cell,
//                     poses, n_views,        // (V, 3): x, z, theta
//                     size, xc, zc, f,       // camera
//                     wall_h, cam_h, max_depth,
//                     out_depth,             // (V, size, size) float32
//                     out_rgb)               // (V, size, size, 3) uint8

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

inline bool blocked(const uint8_t* grid, int gh, int gw, double cell,
                    double x, double z) {
  if (x < 0 || z < 0) return true;
  int zi = (int)(z / cell);
  int xi = (int)(x / cell);
  if (zi < 0 || zi >= gh || xi < 0 || xi >= gw) return true;
  return grid[zi * gw + xi] != 0;
}

inline double ray(const uint8_t* grid, int gh, int gw, double cell, double x,
                  double z, double dx, double dz, double max_depth) {
  const double step = cell / 4.0;
  double t = 0.0;
  while (t < max_depth) {
    t += step;
    if (blocked(grid, gh, gw, cell, x + dx * t, z + dz * t)) return t;
  }
  return max_depth;
}

}  // namespace

extern "C" {

void vdqn_render_views(const uint8_t* grid, int gh, int gw, double cell,
                       const double* poses, int n_views, int size, double xc,
                       double zc, double f, double wall_h, double cam_h,
                       double max_depth, float* out_depth, uint8_t* out_rgb) {
  std::vector<double> alphas(size), tan_beta(size);
  for (int i = 0; i < size; ++i) {
    alphas[i] = std::atan(((double)i - xc) / f);
  }
  for (int r = 0; r < size; ++r) {
    tan_beta[r] = (zc - (double)r) / f;  // tan of vertical angle per row
  }
  const double top = wall_h - cam_h;
  const double bot = -cam_h;

  for (int v = 0; v < n_views; ++v) {
    const double px = poses[v * 3 + 0];
    const double pz = poses[v * 3 + 1];
    const double ang = poses[v * 3 + 2];
    const double fx = -std::sin(ang), fz = -std::cos(ang);
    const double rx = -std::sin(ang - M_PI / 2.0),
                 rz = -std::cos(ang - M_PI / 2.0);

    for (int c = 0; c < size; ++c) {
      const double a = alphas[c];
      const double dx = fx * std::cos(a) + rx * std::sin(a);
      const double dz = fz * std::cos(a) + rz * std::sin(a);
      const double t = ray(grid, gh, gw, cell, px, pz, dx, dz, max_depth);
      const double zdepth = t * std::cos(a);
      // deterministic shading (as sim/fake_env.py FakeNavEnv._render_one)
      const double hit_x = px - std::sin(ang) * t;
      const double hue_d =
          std::fabs(std::sin(hit_x * 7.3) + std::cos(t * 3.1)) * 127.0;
      const uint8_t hue = (uint8_t)hue_d;
      double shade_d = 255.0 - zdepth * 24.0;
      if (shade_d < 30.0) shade_d = 30.0;
      if (shade_d > 255.0) shade_d = 255.0;
      const uint8_t shade = (uint8_t)shade_d;

      for (int r = 0; r < size; ++r) {
        const double h_at = zdepth * tan_beta[r];
        const bool on_wall = (h_at <= top) && (h_at >= bot);
        const double d = on_wall ? zdepth : max_depth;
        const size_t di = ((size_t)v * size + r) * size + c;
        out_depth[di] = (float)(d < max_depth ? d : max_depth);
        const size_t ri = di * 3;
        if (on_wall) {
          out_rgb[ri + 0] = shade;
          out_rgb[ri + 1] = hue;
          out_rgb[ri + 2] = (uint8_t)(255 - hue);
        } else {
          out_rgb[ri + 0] = 20;
          out_rgb[ri + 1] = 40;
          out_rgb[ri + 2] = 60;
        }
      }
    }
  }
}

}  // extern "C"
