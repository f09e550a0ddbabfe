// cluster_tri.cuh — the triangle loops over one cluster of the cluster-major
// triangle table (rows of 16 floats: v0 e1 e2 n mid idx pad), shared by the
// sweeps of csrc/fused_mesh.cu and csrc/coherent.cu.
//
// A block stages the cluster's CS x 16 floats in shared memory, with a
// cooperative float4 load (stage_cluster) or with 16-byte asynchronous
// copies that land while the previous cluster is tested
// (stage_cluster_async + wait_staged); each thread then runs
// Moller-Trumbore over the CS rows, reading each row's vertex and edges as
// three float4 broadcasts.  The arithmetic and its order are those of the
// TPU kernels' triangle loops (cpu_based_ray_tracer_tpu/ops/fused_mesh.py
// _tri_loop_nearest / _tri_loop_occl, ops/coherent.py _sweep_kernel); the
// including files are built with -fmad=false and without fast math.

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

// Cluster c of `tri` into `tile4` by cp.async (16 bytes a copy, L2 only),
// as one commit group of this thread's copies; wait_staged() waits for
// them.  The caller's barrier after the wait makes every thread's copies
// visible to the block.
__device__ __forceinline__ void stage_cluster_async(float4* tile4,
                                                    const float* __restrict__ tri,
                                                    int c, int words4) {
  const float4* src =
      reinterpret_cast<const float4*>(tri) + (size_t)c * words4;
  for (int w = threadIdx.x; w < words4; w += blockDim.x) {
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(tile4 + w));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src + w)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_staged() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Row k's v0 e1 e2 (floats 0-8 of its 16) by three float4 reads.
__device__ __forceinline__ void load_row(const float* tile, int k, float& v0x,
                                         float& v0y, float& v0z, float& e1x,
                                         float& e1y, float& e1z, float& e2x,
                                         float& e2y, float& e2z) {
  const float4* T4 = reinterpret_cast<const float4*>(tile + k * NF);
  const float4 a = T4[0], b = T4[1], c = T4[2];
  v0x = a.x; v0y = a.y; v0z = a.z;
  e1x = a.w; e1y = b.x; e1z = b.y;
  e2x = b.z; e2y = b.w; e2z = c.x;
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
    float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
    load_row(tile, k, v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z);
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
    float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
    load_row(tile, k, v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z);
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
