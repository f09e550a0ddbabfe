// cluster_tri.cuh — the triangle loops over one cluster of the cluster-major
// triangle table (rows of 16 floats: v0 e1 e2 n mid idx pad), shared by the
// sweeps of csrc/fused_mesh.cu and csrc/coherent.cu.
//
// A block stages the cluster's CS x 16 floats in shared memory with a
// cooperative float4 load (stage_cluster); each thread then runs
// Moller-Trumbore over the CS rows, reading them as broadcasts.  The
// arithmetic and its order are those of the TPU kernels' triangle loops
// (cpu_based_ray_tracer_tpu/ops/fused_mesh.py _tri_loop_nearest /
// _tri_loop_occl, ops/coherent.py _sweep_kernel); the including files are
// built with -fmad=false and without fast math.

#pragma once

#include <cuda_runtime.h>

namespace cluster_tri {

constexpr int NF = 16;          // floats per triangle row (MESH_NF)
constexpr float DET_EPS = 1e-12f;

// Cluster c of `tri` into `tile4` (CS * NF / 4 float4).  Every thread of the
// block calls it; the caller brackets it with __syncthreads.
__device__ __forceinline__ void stage_cluster(float4* tile4,
                                              const float* __restrict__ tri,
                                              int c, int words4) {
  const float4* src =
      reinterpret_cast<const float4*>(tri) + (size_t)c * words4;
  for (int w = threadIdx.x; w < words4; w += blockDim.x) tile4[w] = src[w];
}

// Nearest hit over the cluster's rows: best_t takes every accepted t below
// it, in row order (so the first row at the least t wins).  Returns the row
// of the last update, or -1 when no row beat best_t.
__device__ __forceinline__ int nearest_rows(const float* tile, int cs,
                                            float ox, float oy, float oz,
                                            float dx, float dy, float dz,
                                            float t_min, float& best_t) {
  int best_k = -1;
  for (int k = 0; k < cs; ++k) {
    const float* T = tile + k * NF;
    const float v0x = T[0], v0y = T[1], v0z = T[2];
    const float e1x = T[3], e1y = T[4], e1z = T[5];
    const float e2x = T[6], e2y = T[7], e2z = T[8];
    const float s1x = dy * e2z - dz * e2y;
    const float s1y = dz * e2x - dx * e2z;
    const float s1z = dx * e2y - dy * e2x;
    const float det = s1x * e1x + s1y * e1y + s1z * e1z;
    const bool okd = fabsf(det) > DET_EPS;
    const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
    const float s2x = sy * e1z - sz * e1y;
    const float s2y = sz * e1x - sx * e1z;
    const float s2z = sx * e1y - sy * e1x;
    const float inv = 1.0f / (okd ? det : 1.0f);
    const float t = (s2x * e2x + s2y * e2y + s2z * e2z) * inv;
    const float b1 = (s1x * sx + s1y * sy + s1z * sz) * inv;
    const float b2 = (s2x * dx + s2y * dy + s2z * dz) * inv;
    if (okd && (t > t_min) && (b1 >= 0.0f) && (b2 >= 0.0f) &&
        (1.0f - b1 - b2 >= 0.0f) && (t < best_t)) {
      best_t = t;
      best_k = k;
    }
  }
  return best_k;
}

// Any hit within (t_min, lim] over the cluster's rows, by the division-free
// accept (numerators against |det|-scaled bounds); stops at the first.
__device__ __forceinline__ bool occluded_rows(const float* tile, int cs,
                                              float ox, float oy, float oz,
                                              float dx, float dy, float dz,
                                              float lim, float t_min) {
  for (int k = 0; k < cs; ++k) {
    const float* T = tile + k * NF;
    const float v0x = T[0], v0y = T[1], v0z = T[2];
    const float e1x = T[3], e1y = T[4], e1z = T[5];
    const float e2x = T[6], e2y = T[7], e2z = T[8];
    const float s1x = dy * e2z - dz * e2y;
    const float s1y = dz * e2x - dx * e2z;
    const float s1z = dx * e2y - dy * e2x;
    const float det = s1x * e1x + s1y * e1y + s1z * e1z;
    const bool okd = fabsf(det) > DET_EPS;
    const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
    const float s2x = sy * e1z - sz * e1y;
    const float s2y = sz * e1x - sx * e1z;
    const float s2z = sx * e1y - sy * e1x;
    const float sd = det >= 0.0f ? 1.0f : -1.0f;
    const float adet = det * sd;
    const float tn = s2x * e2x + s2y * e2y + s2z * e2z;
    const float b1n = s1x * sx + s1y * sy + s1z * sz;
    const float b2n = s2x * dx + s2y * dy + s2z * dz;
    const float tsd = tn * sd;
    if (okd && (tsd > t_min * adet) && (tsd <= lim * adet) &&
        (b1n * sd >= 0.0f) && (b2n * sd >= 0.0f) &&
        ((det - b1n - b2n) * sd >= 0.0f))
      return true;
  }
  return false;
}

}  // namespace cluster_tri
