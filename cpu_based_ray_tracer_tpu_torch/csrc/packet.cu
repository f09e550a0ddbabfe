// packet.cu — packet-culled nearest-triangle intersector for Hopper (sm_90a).
//
// Replaces: cpu_based_ray_tracer_tpu/ops/packet.py::_kernel, the Pallas TPU
// kernel launched by _nearest_padded from packet.nearest.
//
// What bounds it on this card: arithmetic on the clusters that pass the
// cull.  Each (ray block, cluster) pair costs a 25-operation slab test per
// ray; a pair whose vote passes costs ~50 operations per ray and triangle
// (Moller-Trumbore over CS triangles).  The bytes are small beside that:
// 24 bytes of ray in and 8 out per ray, and 48 bytes per triangle read
// once per passing pair (from L2 after the first block).
//
// What the design does about it:
//   - one CUDA block per block of rays, one thread per ray; the block walks
//     the clusters in order and votes with __syncthreads_or on whether any
//     of its rays crosses the cluster's AABB nearer than its best hit (the
//     TPU kernel's jnp.any(live) + lax.cond), so coherent camera and shadow
//     rays skip most clusters;
//   - a passing cluster's CS x 12 floats are loaded cooperatively into
//     shared memory; every thread then reads the same triangle at the same
//     time (a broadcast) and keeps (t, slot) in registers;
//   - clusters stream from global memory one at a time, so the triangle
//     count has no residency limit; the kernel loops over exactly C
//     clusters (no padded tail) and maps the winning slot to the original
//     triangle index itself.
//
// Semantics (the TPU kernel's): within a cluster the lowest row at the
// minimum t; across clusters a cluster replaces the best hit only when
// strictly nearer; -1 on a miss.  Built with -fmad=false and without
// --use_fast_math, operation order as in the TPU kernel, so the plain
// PyTorch version (ops/packet.py::nearest_plain) agrees bit for bit.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float NO_HIT = FLT_MAX;
constexpr float DET_EPS = 1e-12f;
constexpr int TRI_W = 12, AABB_W = 8;
// Rays per CUDA block, the unit of the cull vote (ops/packet.py: BLOCK).
constexpr int BLOCK = 256;

__device__ __forceinline__ float safe_inv(float v) {
  const float tiny = v < 0.0f ? -1e-20f : 1e-20f;
  return 1.0f / (fabsf(v) < 1e-20f ? tiny : v);
}

__global__ void packet_kernel(const float* __restrict__ aabb,
                              const float* __restrict__ tri,
                              const int* __restrict__ tri_id, int n_clusters,
                              int cs, const float* __restrict__ o,
                              const float* __restrict__ d, int R, float t_min,
                              float* __restrict__ t_out,
                              int* __restrict__ idx_out) {
  extern __shared__ float tile[];
  const int ray = blockIdx.x * BLOCK + threadIdx.x;
  const bool valid = ray < R;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 1.f;
  if (valid) {
    ox = o[3 * ray]; oy = o[3 * ray + 1]; oz = o[3 * ray + 2];
    dx = d[3 * ray]; dy = d[3 * ray + 1]; dz = d[3 * ray + 2];
  }
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);
  float best_t = NO_HIT;
  int best_slot = -1;
  const int words = cs * TRI_W;

  for (int c = 0; c < n_clusters; ++c) {
    // --- cluster AABB slab test, nearer than the best hit so far ------------
    const float* B = aabb + c * AABB_W;
    const float tx0 = (__ldg(B + 0) - ox) * ix;
    const float tx1 = (__ldg(B + 3) - ox) * ix;
    const float ty0 = (__ldg(B + 1) - oy) * iy;
    const float ty1 = (__ldg(B + 4) - oy) * iy;
    const float tz0 = (__ldg(B + 2) - oz) * iz;
    const float tz1 = (__ldg(B + 5) - oz) * iz;
    const float t_in = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                             fminf(tz0, tz1));
    const float t_out = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                              fmaxf(tz0, tz1));
    const bool live = valid && (t_out >= 0.0f) && (t_in <= t_out) &&
                      (t_in <= best_t);
    if (!__syncthreads_or(live)) continue;   // no ray of the block crosses

    const float* src = tri + (size_t)c * words;
    for (int i = threadIdx.x; i < words; i += BLOCK) tile[i] = src[i];
    __syncthreads();

    if (valid) {
      float t_c = NO_HIT;
      int i_c = 0;
      for (int row = 0; row < cs; ++row) {
        const float* T = tile + row * TRI_W;
        const float v0x = T[0], v0y = T[1], v0z = T[2];
        const float e1x = T[3], e1y = T[4], e1z = T[5];
        const float e2x = T[6], e2y = T[7], e2z = T[8];
        const float s1x = dy * e2z - dz * e2y;
        const float s1y = dz * e2x - dx * e2z;
        const float s1z = dx * e2y - dy * e2x;
        const float det = s1x * e1x + s1y * e1y + s1z * e1z;
        const bool okd = fabsf(det) > DET_EPS;
        const float inv_det = okd ? 1.0f / det : 0.0f;
        const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
        const float s2x = sy * e1z - sz * e1y;
        const float s2y = sz * e1x - sx * e1z;
        const float s2z = sx * e1y - sy * e1x;
        const float t = (s2x * e2x + s2y * e2y + s2z * e2z) * inv_det;
        const float b1 = (s1x * sx + s1y * sy + s1z * sz) * inv_det;
        const float b2 = (s2x * dx + s2y * dy + s2z * dz) * inv_det;
        const bool ok = okd && (t > t_min) && (b1 >= 0.0f) && (b2 >= 0.0f) &&
                        (1.0f - b1 - b2 >= 0.0f);
        // Strictly nearer: the lowest row wins at equal t.
        if (ok && t < t_c) {
          t_c = t;
          i_c = row;
        }
      }
      if (t_c < best_t) {
        best_t = t_c;
        best_slot = c * cs + i_c;
      }
    }
    __syncthreads();   // the tile is rewritten by the next passing cluster
  }
  if (valid) {
    t_out[ray] = best_t;
    idx_out[ray] = best_slot >= 0 ? tri_id[best_slot] : -1;
  }
}

}  // namespace

// Nearest hit of R > 0 rays (o, d: (R, 3) f32) against C clusters of CS
// triangles (aabb (C, 8), tri (C, CS, 12) f32, tri_id (C*CS,) i32), on
// `stream`.  Writes t (R,) f32 and the original triangle index (R,) i32 (-1
// on a miss).  Returns cudaGetLastError().
extern "C" int packet_nearest(const float* aabb, const float* tri,
                              const int* tri_id, int n_clusters, int cs,
                              const float* o, const float* d, int R,
                              float t_min, float* t, int* idx, void* stream) {
  if (cs <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)cs * TRI_W * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        packet_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (R + BLOCK - 1) / BLOCK;
  packet_kernel<<<blocks, BLOCK, smem, (cudaStream_t)stream>>>(
      aabb, tri, tri_id, n_clusters, cs, o, d, R, t_min, t, idx);
  return (int)cudaGetLastError();
}
