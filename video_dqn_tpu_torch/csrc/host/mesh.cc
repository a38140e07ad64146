// BVH-accelerated triangle raycasting over a scene mesh: the port's copy of
// native/simcore/mesh.cc, built into the port's host library
// (video_dqn_tpu_torch/_build.py, libvdqn_host.so) and called through
// video_dqn_tpu_torch/sim/native_mesh.py. It renders the mesh simulator's
// RGB-D views (sim/mesh_env.py) and answers its navigability probes.
//
// Geometry conventions match sim/interface.py: +y up, forward at yaw a is
// (-sin a, 0, -cos a), camera pinhole (xc, zc, f), z-buffer depth.
//
// C ABI (ctypes, handle-based):
//   vdqn_mesh_create(vertices f32[n*3], n_verts, faces i32[m*3], n_faces,
//                    colors u8[n*3] | NULL) -> handle
//   vdqn_mesh_destroy(handle)
//   vdqn_mesh_bounds(handle, out f32[6])                 // min xyz, max xyz
//   vdqn_mesh_render(handle, poses f64[V*4] (x,y,z,yaw), V,
//                    size, xc, zc, f, max_depth,
//                    out_depth f32[V*size*size], out_rgb u8[V*size*size*3])
//   vdqn_mesh_floor_probe(handle, xz f64[N*2], N, y_from, max_drop,
//                         clearance, out_y f32[N], out_ok u8[N])
//   vdqn_mesh_floor_levels(handle, xz f64[N*2], N, y_from, y_min, clearance,
//                          max_levels, out_y f32[N*L], out_ok u8[N*L],
//                          out_count i32[N])
//   vdqn_mesh_column_blocked(handle, xz f64[N*2], y_lo f32[N], y_hi f32[N],
//                            N, radius, out_blocked u8[N])
//   vdqn_mesh_raycast(handle, origins f32[N*3], dirs f32[N*3], N,
//                     out_t f32[N], out_tri i32[N])
//
// Every helper lives in an anonymous namespace, so nothing but the vdqn_
// entries is exported beside the library's other sources.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();

struct V3 {
  float x, y, z;
};

inline V3 v3(float x, float y, float z) { return {x, y, z}; }
inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline V3 vmin(V3 a, V3 b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline V3 vmax(V3 a, V3 b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
  V3 lo{kInf, kInf, kInf};
  V3 hi{-kInf, -kInf, -kInf};
  void grow(V3 p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  void grow(const AABB& b) {
    lo = vmin(lo, b.lo);
    hi = vmax(hi, b.hi);
  }
};

// Slab test; returns entry t or +inf. inv_d components may be +/-inf.
inline float aabb_hit(const AABB& b, V3 o, V3 inv_d, float tmax) {
  float t1 = (b.lo.x - o.x) * inv_d.x, t2 = (b.hi.x - o.x) * inv_d.x;
  float tmin_ = std::min(t1, t2), tmax_ = std::max(t1, t2);
  t1 = (b.lo.y - o.y) * inv_d.y;
  t2 = (b.hi.y - o.y) * inv_d.y;
  tmin_ = std::max(tmin_, std::min(t1, t2));
  tmax_ = std::min(tmax_, std::max(t1, t2));
  t1 = (b.lo.z - o.z) * inv_d.z;
  t2 = (b.hi.z - o.z) * inv_d.z;
  tmin_ = std::max(tmin_, std::min(t1, t2));
  tmax_ = std::min(tmax_, std::max(t1, t2));
  if (tmax_ < std::max(tmin_, 0.0f) || tmin_ > tmax) return kInf;
  return tmin_;
}

struct BVHNode {
  AABB box;
  int left = -1;   // internal: child index; leaf: first tri index
  int count = 0;   // leaf: number of tris; 0 for internal
  int right = -1;
};

struct Mesh {
  std::vector<V3> verts;
  std::vector<int32_t> faces;   // 3 per tri
  std::vector<uint8_t> colors;  // 3 per vert, may be empty
  std::vector<int> tri_order;   // BVH leaf ordering
  std::vector<BVHNode> nodes;
  AABB bounds;

  V3 tri_v(int tri, int k) const { return verts[faces[3 * tri + k]]; }
};

void build_bvh(Mesh& m) {
  const int n = (int)(m.faces.size() / 3);
  m.tri_order.resize(n);
  std::vector<V3> centroids(n);
  std::vector<AABB> tri_boxes(n);
  for (int i = 0; i < n; ++i) {
    m.tri_order[i] = i;
    AABB b;
    b.grow(m.tri_v(i, 0));
    b.grow(m.tri_v(i, 1));
    b.grow(m.tri_v(i, 2));
    tri_boxes[i] = b;
    centroids[i] = (b.lo + b.hi) * 0.5f;
    m.bounds.grow(b);
  }
  m.nodes.clear();
  m.nodes.reserve(2 * n);

  // iterative median-split build over [start, end) ranges of tri_order
  struct Task {
    int node, start, end;
  };
  m.nodes.push_back({});
  std::vector<Task> stack{{0, 0, n}};
  while (!stack.empty()) {
    Task t = stack.back();
    stack.pop_back();
    BVHNode& node = m.nodes[t.node];
    AABB box;
    for (int i = t.start; i < t.end; ++i) box.grow(tri_boxes[m.tri_order[i]]);
    node.box = box;
    int count = t.end - t.start;
    if (count <= 4) {
      node.left = t.start;
      node.count = count;
      continue;
    }
    // split on the widest centroid axis at the median
    AABB cbox;
    for (int i = t.start; i < t.end; ++i) cbox.grow(centroids[m.tri_order[i]]);
    V3 ext = cbox.hi - cbox.lo;
    int axis = 0;
    if (ext.y > ext.x && ext.y >= ext.z) axis = 1;
    else if (ext.z > ext.x && ext.z > ext.y) axis = 2;
    int mid = t.start + count / 2;
    std::nth_element(
        m.tri_order.begin() + t.start, m.tri_order.begin() + mid,
        m.tri_order.begin() + t.end, [&](int a, int b) {
          const float* ca = &centroids[a].x;
          const float* cb = &centroids[b].x;
          return ca[axis] < cb[axis];
        });
    int li = (int)m.nodes.size();
    m.nodes.push_back({});
    m.nodes.push_back({});
    // NOTE: node reference may dangle after push_back; re-index.
    m.nodes[t.node].left = li;
    m.nodes[t.node].right = li + 1;
    m.nodes[t.node].count = 0;
    stack.push_back({li, t.start, mid});
    stack.push_back({li + 1, mid, t.end});
  }
}

// Moller-Trumbore. Returns t or +inf; fills u, v barycentrics.
inline float tri_hit(const Mesh& m, int tri, V3 o, V3 d, float& u, float& v) {
  V3 p0 = m.tri_v(tri, 0), p1 = m.tri_v(tri, 1), p2 = m.tri_v(tri, 2);
  V3 e1 = p1 - p0, e2 = p2 - p0;
  V3 pv = cross(d, e2);
  float det = dot(e1, pv);
  if (std::fabs(det) < 1e-9f) return kInf;
  float inv = 1.0f / det;
  V3 tv = o - p0;
  u = dot(tv, pv) * inv;
  if (u < -1e-6f || u > 1.0f + 1e-6f) return kInf;
  V3 qv = cross(tv, e1);
  v = dot(d, qv) * inv;
  if (v < -1e-6f || u + v > 1.0f + 1e-6f) return kInf;
  float t = dot(e2, qv) * inv;
  return t > 1e-6f ? t : kInf;
}

struct Hit {
  float t = kInf;
  int tri = -1;
  float u = 0, v = 0;
};

Hit trace(const Mesh& m, V3 o, V3 d, float tmax) {
  Hit best;
  best.t = tmax;
  if (m.nodes.empty()) return best;
  V3 inv_d = {1.0f / d.x, 1.0f / d.y, 1.0f / d.z};
  int stack[64];
  int sp = 0;
  stack[sp++] = 0;
  while (sp > 0) {
    const BVHNode& node = m.nodes[stack[--sp]];
    if (aabb_hit(node.box, o, inv_d, best.t) == kInf) continue;
    if (node.count > 0) {
      for (int i = 0; i < node.count; ++i) {
        int tri = m.tri_order[node.left + i];
        float u = 0, v = 0;
        float t = tri_hit(m, tri, o, d, u, v);
        if (t < best.t) {
          best.t = t;
          best.tri = tri;
          best.u = u;
          best.v = v;
        }
      }
    } else {
      if (sp + 2 <= 64) {
        stack[sp++] = node.left;
        stack[sp++] = node.right;
      }
    }
  }
  if (best.tri < 0) best.t = kInf;
  return best;
}

inline V3 face_normal(const Mesh& m, int tri) {
  V3 n = cross(m.tri_v(tri, 1) - m.tri_v(tri, 0),
               m.tri_v(tri, 2) - m.tri_v(tri, 0));
  float len = std::sqrt(dot(n, n));
  return len > 0 ? n * (1.0f / len) : v3(0, 1, 0);
}

// Exact triangle-AABB overlap (Akenine-Moller separating axis test).
bool tri_box_overlap(V3 c, V3 half, V3 a, V3 b, V3 cc) {
  // move triangle into box space
  V3 v0 = a - c, v1 = b - c, v2 = cc - c;
  V3 e0 = v1 - v0, e1 = v2 - v1, e2 = v0 - v2;

  auto axis_test = [&](V3 ax) {
    float p0 = dot(v0, ax), p1 = dot(v1, ax), p2 = dot(v2, ax);
    float mn = std::min({p0, p1, p2}), mx = std::max({p0, p1, p2});
    float r = half.x * std::fabs(ax.x) + half.y * std::fabs(ax.y) +
              half.z * std::fabs(ax.z);
    return !(mn > r || mx < -r);
  };

  // 9 cross-product axes
  const V3 edges[3] = {e0, e1, e2};
  for (const V3& e : edges) {
    if (!axis_test(v3(0, -e.z, e.y))) return false;
    if (!axis_test(v3(e.z, 0, -e.x))) return false;
    if (!axis_test(v3(-e.y, e.x, 0))) return false;
  }
  // 3 box axes (AABB of triangle vs box)
  if (std::min({v0.x, v1.x, v2.x}) > half.x ||
      std::max({v0.x, v1.x, v2.x}) < -half.x)
    return false;
  if (std::min({v0.y, v1.y, v2.y}) > half.y ||
      std::max({v0.y, v1.y, v2.y}) < -half.y)
    return false;
  if (std::min({v0.z, v1.z, v2.z}) > half.z ||
      std::max({v0.z, v1.z, v2.z}) < -half.z)
    return false;
  // triangle plane vs box
  V3 n = cross(e0, e1);
  float d = -dot(n, v0);
  float r = half.x * std::fabs(n.x) + half.y * std::fabs(n.y) +
            half.z * std::fabs(n.z);
  return std::fabs(d) <= r;
}

// Any triangle overlapping the AABB [lo, hi]? BVH query.
bool box_occupied(const Mesh& m, V3 lo, V3 hi) {
  if (m.nodes.empty()) return false;
  V3 c = (lo + hi) * 0.5f, half = (hi - lo) * 0.5f;
  int stack[64];
  int sp = 0;
  stack[sp++] = 0;
  while (sp > 0) {
    const BVHNode& node = m.nodes[stack[--sp]];
    if (node.box.lo.x > hi.x || node.box.hi.x < lo.x ||
        node.box.lo.y > hi.y || node.box.hi.y < lo.y ||
        node.box.lo.z > hi.z || node.box.hi.z < lo.z)
      continue;
    if (node.count > 0) {
      for (int i = 0; i < node.count; ++i) {
        int tri = m.tri_order[node.left + i];
        if (tri_box_overlap(c, half, m.tri_v(tri, 0), m.tri_v(tri, 1),
                            m.tri_v(tri, 2)))
          return true;
      }
    } else if (sp + 2 <= 64) {
      stack[sp++] = node.left;
      stack[sp++] = node.right;
    }
  }
  return false;
}

}  // namespace

extern "C" {

void* vdqn_mesh_create(const float* vertices, int n_verts, const int32_t* faces,
                  int n_faces, const uint8_t* colors) {
  Mesh* m = new Mesh();
  m->verts.resize(n_verts);
  std::memcpy(m->verts.data(), vertices, sizeof(float) * 3 * n_verts);
  m->faces.assign(faces, faces + 3 * (size_t)n_faces);
  if (colors != nullptr) m->colors.assign(colors, colors + 3 * (size_t)n_verts);
  build_bvh(*m);
  return m;
}

void vdqn_mesh_destroy(void* h) { delete (Mesh*)h; }

void vdqn_mesh_bounds(void* h, float* out6) {
  Mesh* m = (Mesh*)h;
  out6[0] = m->bounds.lo.x;
  out6[1] = m->bounds.lo.y;
  out6[2] = m->bounds.lo.z;
  out6[3] = m->bounds.hi.x;
  out6[4] = m->bounds.hi.y;
  out6[5] = m->bounds.hi.z;
}

// Batched pinhole RGB-D render. Depth is z-buffer depth (distance along the
// camera forward axis), matching the habitat depth sensor the planner's
// unprojection assumes. Pixels with no hit within max_depth render at
// max_depth with a dark background color.
namespace {

void render_rows(const Mesh* m, const double* p, int size, double xc,
                 double zc, double f, float maxd, int r0, int r1,
                 float* dview, uint8_t* cview) {
    V3 origin = v3((float)p[0], (float)p[1], (float)p[2]);
    float a = (float)p[3];
    V3 fwd = v3(-std::sin(a), 0.0f, -std::cos(a));
    V3 right = v3(std::cos(a), 0.0f, -std::sin(a));
    V3 up = v3(0.0f, 1.0f, 0.0f);
    for (int r = r0; r < r1; ++r) {
      float vv = (float)((zc - r) / f);
      for (int c = 0; c < size; ++c) {
        float uu = (float)((c - xc) / f);
        // dir has unit forward component -> hit param t IS the z-depth
        V3 dir = fwd + right * uu + up * vv;
        Hit hit = trace(*m, origin, dir, maxd);
        size_t pix = (size_t)r * size + c;
        if (hit.tri < 0) {
          dview[pix] = maxd;
          cview[3 * pix + 0] = 20;
          cview[3 * pix + 1] = 40;
          cview[3 * pix + 2] = 60;
          continue;
        }
        dview[pix] = hit.t;
        // Lambert shade * vertex color (or tri-hash albedo)
        V3 n = face_normal(*m, hit.tri);
        V3 ldir = v3(0.4f, 0.8f, 0.45f);  // fixed light
        float lambert = 0.35f + 0.65f * std::fabs(dot(n, ldir));
        float cr, cg, cb;
        if (!m->colors.empty()) {
          int i0 = m->faces[3 * hit.tri], i1 = m->faces[3 * hit.tri + 1],
              i2 = m->faces[3 * hit.tri + 2];
          float w0 = 1.0f - hit.u - hit.v;
          cr = w0 * m->colors[3 * i0] + hit.u * m->colors[3 * i1] +
               hit.v * m->colors[3 * i2];
          cg = w0 * m->colors[3 * i0 + 1] + hit.u * m->colors[3 * i1 + 1] +
               hit.v * m->colors[3 * i2 + 1];
          cb = w0 * m->colors[3 * i0 + 2] + hit.u * m->colors[3 * i1 + 2] +
               hit.v * m->colors[3 * i2 + 2];
        } else {
          uint32_t hsh = (uint32_t)hit.tri * 2654435761u;
          cr = 60.0f + (float)(hsh & 127);
          cg = 60.0f + (float)((hsh >> 7) & 127);
          cb = 60.0f + (float)((hsh >> 14) & 127);
        }
        cview[3 * pix + 0] = (uint8_t)std::min(255.0f, cr * lambert);
        cview[3 * pix + 1] = (uint8_t)std::min(255.0f, cg * lambert);
        cview[3 * pix + 2] = (uint8_t)std::min(255.0f, cb * lambert);
      }
    }
}

}  // namespace

void vdqn_mesh_render(void* h, const double* poses, int n_views, int size,
                 double xc, double zc, double f, double max_depth,
                 float* out_depth, uint8_t* out_rgb) {
  Mesh* m = (Mesh*)h;
  const float maxd = (float)max_depth;
  // rows split across hardware threads (deterministic: each pixel is
  // written by exactly one thread); single-threaded when 1 core.
  unsigned hw = std::thread::hardware_concurrency();
  int n_threads = (int)std::min<unsigned>(hw ? hw : 1, 16);
  for (int view = 0; view < n_views; ++view) {
    const double* p = poses + 4 * view;
    float* dview = out_depth + (size_t)view * size * size;
    uint8_t* cview = out_rgb + (size_t)view * size * size * 3;
    if (n_threads <= 1 || size < 2 * n_threads) {
      render_rows(m, p, size, xc, zc, f, maxd, 0, size, dview, cview);
      continue;
    }
    std::vector<std::thread> pool;
    int chunk = (size + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
      int r0 = t * chunk, r1 = std::min(size, r0 + chunk);
      if (r0 >= r1) break;
      pool.emplace_back(render_rows, m, p, size, xc, zc, f, maxd, r0, r1,
                        dview, cview);
    }
    for (auto& th : pool) th.join();
  }
}

// Floor probe: drop a ray straight down from (x, y_from, z); the floor is
// the first hit within max_drop. ok=1 iff a floor was found AND a ray cast
// back up from just above it travels at least `clearance` meters unblocked
// (the agent-height free-space test habitat's navmesh encodes).
void vdqn_mesh_floor_probe(void* h, const double* xz, int n, double y_from,
                      double max_drop, double clearance, float* out_y,
                      uint8_t* out_ok) {
  Mesh* m = (Mesh*)h;
  for (int i = 0; i < n; ++i) {
    V3 o = v3((float)xz[2 * i], (float)y_from, (float)xz[2 * i + 1]);
    Hit down = trace(*m, o, v3(0, -1, 0), (float)max_drop);
    if (down.tri < 0) {
      out_y[i] = NAN;
      out_ok[i] = 0;
      continue;
    }
    // reject steep surfaces (walls/ramps steeper than ~45 deg are not floor)
    V3 nrm = face_normal(*m, down.tri);
    float floor_y = o.y - down.t;
    out_y[i] = floor_y;
    if (std::fabs(nrm.y) < 0.7f) {
      out_ok[i] = 0;
      continue;
    }
    V3 up_o = v3(o.x, floor_y + 0.05f, o.z);
    Hit up = trace(*m, up_o, v3(0, 1, 0), (float)clearance);
    out_ok[i] = (up.tri < 0) ? 1 : 0;
  }
}

// Peeling probe: walk DOWN each column from y_from to y_min, recording every
// surface (up to max_levels) — upper floors occlude lower ones for a single
// drop ray, so multi-floor scenes need the peel. Per surface: its height and
// the walkability bit (slope + clearance, as in mesh_floor_probe).
void vdqn_mesh_floor_levels(void* h, const double* xz, int n, double y_from,
                       double y_min, double clearance, int max_levels,
                       float* out_y, uint8_t* out_ok, int32_t* out_count) {
  Mesh* m = (Mesh*)h;
  for (int i = 0; i < n; ++i) {
    double x = xz[2 * i], z = xz[2 * i + 1];
    double y = y_from;
    int found = 0;
    while (found < max_levels && y > y_min) {
      V3 o = v3((float)x, (float)y, (float)z);
      Hit down = trace(*m, o, v3(0, -1, 0), (float)(y - y_min));
      if (down.tri < 0) break;
      float fy = (float)y - down.t;
      V3 nrm = face_normal(*m, down.tri);
      uint8_t ok = 0;
      if (std::fabs(nrm.y) >= 0.7f) {
        V3 up_o = v3((float)x, fy + 0.05f, (float)z);
        Hit up = trace(*m, up_o, v3(0, 1, 0), (float)clearance);
        ok = (up.tri < 0) ? 1 : 0;
      }
      out_y[(size_t)i * max_levels + found] = fy;
      out_ok[(size_t)i * max_levels + found] = ok;
      ++found;
      y = fy - 0.05;
    }
    out_count[i] = found;
  }
}

// Column-blocked test: does any triangle intersect the box
// [x-r, x+r] x [y_lo_i, y_hi_i] x [z-r, z+r]? This is the voxelization
// step a Recast navmesh build performs: wall faces crossing the agent
// height band above a floor surface make the column unwalkable, which
// (with connected-component filtering in sim/mesh_env.py) excludes
// enclosed voids like hollow wall interiors.
void vdqn_mesh_column_blocked(void* h, const double* xz, const float* y_lo,
                         const float* y_hi, int n, double radius,
                         uint8_t* out_blocked) {
  Mesh* m = (Mesh*)h;
  float r = (float)radius;
  for (int i = 0; i < n; ++i) {
    V3 lo = v3((float)xz[2 * i] - r, y_lo[i], (float)xz[2 * i + 1] - r);
    V3 hi = v3((float)xz[2 * i] + r, y_hi[i], (float)xz[2 * i + 1] + r);
    out_blocked[i] = box_occupied(*m, lo, hi) ? 1 : 0;
  }
}

void vdqn_mesh_raycast(void* h, const float* origins, const float* dirs, int n,
                  float* out_t, int32_t* out_tri) {
  Mesh* m = (Mesh*)h;
  for (int i = 0; i < n; ++i) {
    V3 o = v3(origins[3 * i], origins[3 * i + 1], origins[3 * i + 2]);
    V3 d = v3(dirs[3 * i], dirs[3 * i + 1], dirs[3 * i + 2]);
    Hit hit = trace(*m, o, d, kInf);
    out_t[i] = hit.t;
    out_tri[i] = hit.tri;
  }
}

}  // extern "C"
