// Native host-side runtime of the PyTorch port: its own copy of the JAX
// package's csrc/native.cpp (the same code and C interface).
//
// The reference implements its BVH builder and OBJ loader in C++
// (BVH Ray Tracer/8599RayTracerGUI/src/BVH.h:106-185 builder;
//  vendored OBJ_Loader.h parser).  This is the host-side scene and BVH
// preprocessing before arrays go to the device.  The flattened-BVH
// contract (preorder nodes + skip links + leaf-contiguous triangle order)
// is identical to the numpy builder in ops/bvh.py, so either serves any
// scene.
//
// Build: utils/native.py compiles it with g++ at first use into
// build/native/ at the root of the checkout, and loads it with ctypes.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <limits>
#include <numeric>
#include <sstream>
#include <string>
#include <vector>

namespace {

struct Vec3 {
  double x, y, z;
};

struct BuildContext {
  const double* verts;  // n_tris * 9
  std::vector<Vec3> tmin, tmax, centroid;
  float* node_min;
  float* node_max;
  int32_t* node_skip;
  int32_t* leaf_first;
  int32_t* leaf_count;
  int32_t* order;
  int64_t n_nodes = 0;
  int64_t n_ordered = 0;
  int64_t leaf_size = 4;
};

// Recursive median-split emit, preorder with skip links.  Mirrors the
// reference's rule (split at count/2 on the longest axis of the centroid
// bounds, stable order) and ops/bvh.py::build_bvh exactly.
void emit(BuildContext& ctx, std::vector<int64_t>& idx, int64_t lo,
          int64_t hi) {
  const int64_t me = ctx.n_nodes++;
  Vec3 bmin{std::numeric_limits<double>::infinity(),
            std::numeric_limits<double>::infinity(),
            std::numeric_limits<double>::infinity()};
  Vec3 bmax{-bmin.x, -bmin.y, -bmin.z};
  for (int64_t k = lo; k < hi; ++k) {
    const Vec3& a = ctx.tmin[idx[k]];
    const Vec3& b = ctx.tmax[idx[k]];
    bmin.x = std::min(bmin.x, a.x); bmin.y = std::min(bmin.y, a.y);
    bmin.z = std::min(bmin.z, a.z);
    bmax.x = std::max(bmax.x, b.x); bmax.y = std::max(bmax.y, b.y);
    bmax.z = std::max(bmax.z, b.z);
  }
  ctx.node_min[me * 3 + 0] = static_cast<float>(bmin.x);
  ctx.node_min[me * 3 + 1] = static_cast<float>(bmin.y);
  ctx.node_min[me * 3 + 2] = static_cast<float>(bmin.z);
  ctx.node_max[me * 3 + 0] = static_cast<float>(bmax.x);
  ctx.node_max[me * 3 + 1] = static_cast<float>(bmax.y);
  ctx.node_max[me * 3 + 2] = static_cast<float>(bmax.z);

  const int64_t count = hi - lo;
  if (count <= ctx.leaf_size) {
    ctx.leaf_first[me] = static_cast<int32_t>(ctx.n_ordered);
    ctx.leaf_count[me] = static_cast<int32_t>(count);
    for (int64_t k = lo; k < hi; ++k)
      ctx.order[ctx.n_ordered++] = static_cast<int32_t>(idx[k]);
  } else {
    ctx.leaf_first[me] = -1;
    ctx.leaf_count[me] = 0;
    Vec3 cmin{std::numeric_limits<double>::infinity(),
              std::numeric_limits<double>::infinity(),
              std::numeric_limits<double>::infinity()};
    Vec3 cmax{-cmin.x, -cmin.y, -cmin.z};
    for (int64_t k = lo; k < hi; ++k) {
      const Vec3& c = ctx.centroid[idx[k]];
      cmin.x = std::min(cmin.x, c.x); cmin.y = std::min(cmin.y, c.y);
      cmin.z = std::min(cmin.z, c.z);
      cmax.x = std::max(cmax.x, c.x); cmax.y = std::max(cmax.y, c.y);
      cmax.z = std::max(cmax.z, c.z);
    }
    const double ex = cmax.x - cmin.x, ey = cmax.y - cmin.y,
                 ez = cmax.z - cmin.z;
    // numpy argmax picks the FIRST max; replicate exactly.
    int axis = 0;
    double best = ex;
    if (ey > best) { best = ey; axis = 1; }
    if (ez > best) { best = ez; axis = 2; }

    std::stable_sort(idx.begin() + lo, idx.begin() + hi,
                     [&](int64_t a, int64_t b) {
                       const Vec3& ca = ctx.centroid[a];
                       const Vec3& cb = ctx.centroid[b];
                       const double va = axis == 0 ? ca.x : axis == 1 ? ca.y : ca.z;
                       const double vb = axis == 0 ? cb.x : axis == 1 ? cb.y : cb.z;
                       return va < vb;
                     });
    const int64_t half = count / 2;  // reference BVH.h:170 median
    emit(ctx, idx, lo, lo + half);
    emit(ctx, idx, lo + half, hi);
  }
  ctx.node_skip[me] = static_cast<int32_t>(ctx.n_nodes);
}

}  // namespace

extern "C" {

// Build a flattened BVH.  verts: n_tris*9 doubles (a,b,c per triangle).
// Output buffers must hold >= 2*n_tris nodes / n_tris order entries.
// Returns the node count (>0) or -1 on error.
int64_t crt_build_bvh(const double* verts, int64_t n_tris, int64_t leaf_size,
                      float* node_min, float* node_max, int32_t* node_skip,
                      int32_t* leaf_first, int32_t* leaf_count,
                      int32_t* order) {
  if (n_tris <= 0 || leaf_size <= 0) return -1;
  BuildContext ctx;
  ctx.verts = verts;
  ctx.leaf_size = leaf_size;
  ctx.node_min = node_min;
  ctx.node_max = node_max;
  ctx.node_skip = node_skip;
  ctx.leaf_first = leaf_first;
  ctx.leaf_count = leaf_count;
  ctx.order = order;
  ctx.tmin.resize(n_tris);
  ctx.tmax.resize(n_tris);
  ctx.centroid.resize(n_tris);
  for (int64_t i = 0; i < n_tris; ++i) {
    const double* t = verts + i * 9;
    Vec3 mn{t[0], t[1], t[2]}, mx{t[0], t[1], t[2]};
    for (int c = 1; c < 3; ++c) {
      mn.x = std::min(mn.x, t[c * 3 + 0]); mx.x = std::max(mx.x, t[c * 3 + 0]);
      mn.y = std::min(mn.y, t[c * 3 + 1]); mx.y = std::max(mx.y, t[c * 3 + 1]);
      mn.z = std::min(mn.z, t[c * 3 + 2]); mx.z = std::max(mx.z, t[c * 3 + 2]);
    }
    ctx.tmin[i] = mn;
    ctx.tmax[i] = mx;
    ctx.centroid[i] = Vec3{(mn.x + mx.x) * 0.5, (mn.y + mx.y) * 0.5,
                           (mn.z + mx.z) * 0.5};
  }
  std::vector<int64_t> idx(n_tris);
  std::iota(idx.begin(), idx.end(), 0);
  emit(ctx, idx, 0, n_tris);
  return ctx.n_nodes;
}

// ---- OBJ parsing (reimplements the subset of the vendored OBJ_Loader.h the
// framework uses: v/vt/f with fan triangulation and negative indices). ----

namespace {
struct ObjData {
  std::vector<double> verts;              // flat xyz
  std::vector<double> uvs;                // flat uv
  std::vector<std::array<int64_t, 6>> tris;  // v0,v1,v2,t0,t1,t2 (0-based, -1 none)
};

bool parse_obj_file(const char* path, ObjData& out) {
  std::ifstream f(path);
  if (!f) return false;
  std::string line;
  std::vector<std::pair<int64_t, int64_t>> corners;
  while (std::getline(f, line)) {
    if (line.empty() || line[0] == '#') continue;
    std::istringstream ss(line);
    std::string tag;
    ss >> tag;
    if (tag == "v") {
      double x = 0, y = 0, z = 0;
      ss >> x >> y >> z;
      out.verts.insert(out.verts.end(), {x, y, z});
    } else if (tag == "vt") {
      double u = 0, v = 0;
      ss >> u >> v;
      out.uvs.insert(out.uvs.end(), {u, v});
    } else if (tag == "f") {
      corners.clear();
      std::string corner;
      while (ss >> corner) {
        int64_t vi = 0, ti = 0;
        const size_t s1 = corner.find('/');
        if (s1 == std::string::npos) {
          vi = std::stoll(corner);
        } else {
          vi = std::stoll(corner.substr(0, s1));
          const size_t s2 = corner.find('/', s1 + 1);
          const std::string tpart =
              corner.substr(s1 + 1, s2 == std::string::npos
                                        ? std::string::npos
                                        : s2 - s1 - 1);
          if (!tpart.empty()) ti = std::stoll(tpart);
        }
        const int64_t nv = static_cast<int64_t>(out.verts.size() / 3);
        const int64_t nt = static_cast<int64_t>(out.uvs.size() / 2);
        const int64_t v0 = vi > 0 ? vi - 1 : nv + vi;
        const int64_t t0 = ti == 0 ? -1 : (ti > 0 ? ti - 1 : nt + ti);
        corners.emplace_back(v0, t0);
      }
      for (size_t k = 1; k + 1 < corners.size(); ++k)
        out.tris.push_back({corners[0].first, corners[k].first,
                            corners[k + 1].first, corners[0].second,
                            corners[k].second, corners[k + 1].second});
    }
  }
  return true;
}
}  // namespace

// Pass 1: count triangles.  Returns n_tris or -1.
int64_t crt_obj_count(const char* path) {
  ObjData data;
  if (!parse_obj_file(path, data)) return -1;
  return static_cast<int64_t>(data.tris.size());
}

// Pass 2: fill tris (n*9 doubles) and uv (n*6 doubles).  has_uv set to 1 if
// any face carried texture coordinates.  Returns n_tris or -1.
int64_t crt_obj_load(const char* path, double* tris, double* uv,
                     int32_t* has_uv) {
  ObjData data;
  if (!parse_obj_file(path, data)) return -1;
  *has_uv = 0;
  for (size_t i = 0; i < data.tris.size(); ++i) {
    const auto& t = data.tris[i];
    for (int c = 0; c < 3; ++c) {
      const int64_t vi = t[c];
      tris[i * 9 + c * 3 + 0] = data.verts[vi * 3 + 0];
      tris[i * 9 + c * 3 + 1] = data.verts[vi * 3 + 1];
      tris[i * 9 + c * 3 + 2] = data.verts[vi * 3 + 2];
      const int64_t ti = t[3 + c];
      if (ti >= 0) {
        *has_uv = 1;
        uv[i * 6 + c * 2 + 0] = data.uvs[ti * 2 + 0];
        uv[i * 6 + c * 2 + 1] = data.uvs[ti * 2 + 1];
      } else {
        uv[i * 6 + c * 2 + 0] = 0.0;
        uv[i * 6 + c * 2 + 1] = 0.0;
      }
    }
  }
  return static_cast<int64_t>(data.tris.size());
}

}  // extern "C"
