// packet.cu — cluster-culled nearest-triangle intersector for Hopper
// (sm_90a).
//
// Replaces: cpu_based_ray_tracer_tpu/ops/packet.py::_kernel, the Pallas TPU
// kernel launched by _nearest_padded from packet.nearest.
//
// What bounds it on this card: arithmetic on the clusters a ray's warp
// crosses.  Each (ray, cluster) pair costs a ~30-operation padded slab
// test; each (warp, cluster) pair where a ray of the warp crosses the box
// costs ~50 operations per ray and triangle (Moller-Trumbore over CS
// triangles).  The bytes are small beside that: 24 bytes of ray in and 8
// out per ray, and 48 bytes per triangle staged once per crossing block
// (from L2 after the first block).
//
// What the design does about it:
//   - work items are (256-ray block, cluster slice) pairs: the C clusters
//     are cut into K contiguous slices, K = cluster_tri::split_count's
//     count for R rays (the slices of the fused mesh sweep), so that the
//     blocks fill the card's resident block slots SWEEP_WAVES times over
//     whatever R is: a 16,384-ray launch (64 ray blocks) takes 16 slices;
//   - a block walks its slice in cluster order, stages only the clusters
//     whose padded box (cluster_tri::crosses_box) one of its rays crosses,
//     with cp.async copies into two shared-memory buffers, so the next
//     crossed cluster's CS x 48 B land while the current one is tested;
//   - a ray tests a staged cluster only when it crosses its box, so a warp
//     none of whose rays crosses it skips the Moller-Trumbore loop;
//   - with K > 1 each slice writes its (t, slot) per ray, and the last
//     block of the ray block to finish (a ticket per ray block, after a
//     __threadfence) combines them in slice order and sets the ticket back
//     to 0.  The walk and the ticket are cluster_tri::walk_slice and
//     last_slice, shared with csrc/fused_mesh.cu's sweep.
//
// Semantics: a ray's result is the nearest hit over the clusters whose
// padded box it crosses: within a cluster the lowest row at the minimum t;
// across clusters (slices included) a later cluster wins only when
// strictly nearer; -1 on a miss.  That set depends on the ray alone, not
// on its block, its warp or the slices, so every schedule gives the same
// bits; the pad keeps the cull conservative (a ray that hits a triangle
// crosses its cluster's box), so the result is the unculled scan's, as the
// TPU kernel's is (its block vote culls by each ray's best hit so far,
// which the slices do not know).  Built with
// -fmad=false and without --use_fast_math, operation order as in the TPU
// kernel, so the plain PyTorch version (ops/packet.py::nearest_plain)
// agrees bit for bit.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

#include "cluster_tri.cuh"

namespace {

constexpr float NO_HIT = FLT_MAX;
constexpr int TRI_W = 12, AABB_W = 8;
// Rays per CUDA block (ops/packet.py: BLOCK).
constexpr int BLOCK = cluster_tri::RAY_BLOCK;

__device__ __forceinline__ float safe_inv(float v) {
  const float tiny = v < 0.0f ? -1e-20f : 1e-20f;
  return 1.0f / (fabsf(v) < 1e-20f ? tiny : v);
}

__global__ void __launch_bounds__(BLOCK)
packet_kernel(const float* __restrict__ aabb, const float* __restrict__ tri,
              const int* __restrict__ tri_id, int n_clusters, int cs,
              const float* __restrict__ o, const float* __restrict__ d, int R,
              float t_min, int K, int* part, int* __restrict__ tickets,
              float* __restrict__ t_out, int* __restrict__ idx_out) {
  extern __shared__ float4 tile4[];
  const int rb = blockIdx.x / K, k = blockIdx.x - rb * K;
  const int ray = rb * BLOCK + threadIdx.x;
  const bool valid = ray < R;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 1.f;
  if (valid) {
    ox = o[3 * ray]; oy = o[3 * ray + 1]; oz = o[3 * ray + 2];
    dx = d[3 * ray]; dy = d[3 * ray + 1]; dz = d[3 * ray + 2];
  }
  const float ivx = safe_inv(dx), ivy = safe_inv(dy), ivz = safe_inv(dz);
  const float o_mag = fmaxf(fmaxf(fabsf(ox), fabsf(oy)), fabsf(oz));
  const float t_lo = fminf(t_min, 0.0f);
  const int j0 = (int)((long long)n_clusters * k / K);
  const int j1 = (int)((long long)n_clusters * (k + 1) / K);
  float best_t = NO_HIT;
  int slot = -1;
  cluster_tri::walk_slice<false>(
      tile4, tri, cs * TRI_W / 4, j0, j1, [] { return true; },
      [&](int q) {
        return valid && cluster_tri::crosses_box(aabb + (size_t)q * AABB_W,
                                                 ox, oy, oz, o_mag, ivx, ivy,
                                                 ivz, t_lo, 0.0f, false);
      },
      [](int q) { return q; },
      [&](int j, const float* tile, bool mine) {
        // a ray tests exactly the clusters whose box it crosses
        if (!mine) return;
        const int kk = cluster_tri::nearest_rows<TRI_W>(
            tile, cs, ox, oy, oz, dx, dy, dz, t_min, best_t);
        if (kk >= 0) slot = j * cs + kk;
      });
  if (K > 1) {
    if (valid) {
      part[(size_t)(2 * k) * R + ray] = __float_as_int(best_t);
      part[(size_t)(2 * k + 1) * R + ray] = slot;
    }
    if (!cluster_tri::last_slice(tickets, rb, K) || !valid) return;
    // The slices in cluster order; partials from other blocks are read
    // past L1 (__ldcg).
    best_t = NO_HIT;
    slot = -1;
    for (int s = 0; s < K; ++s) {
      const float t =
          __int_as_float(__ldcg(part + (size_t)(2 * s) * R + ray));
      if (t < best_t) {
        best_t = t;
        slot = __ldcg(part + (size_t)(2 * s + 1) * R + ray);
      }
    }
  }
  if (valid) {
    t_out[ray] = best_t;
    idx_out[ray] = slot >= 0 ? tri_id[slot] : -1;
  }
}

size_t tile_smem(int cs) { return 2 * (size_t)cs * TRI_W * sizeof(float); }

cudaError_t allow_smem(int cs) {
  if (tile_smem(cs) <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(packet_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)tile_smem(cs));
}

}  // namespace

// The kernel's resident blocks per SM for clusters of cs triangles, and the
// SM count: out[0], out[1] (ops/packet.py sizes the slices by them), asked
// of the runtime once per device and cluster size.  Launches nothing.
extern "C" int packet_slots(int cs, int* out) {
  static int seen_dev = -1, seen_cs = -1, seen_per_sm = 0, seen_n_sm = 0;
  if (cs <= 0) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev != seen_dev || cs != seen_cs) {
    e = cudaDeviceGetAttribute(&seen_n_sm, cudaDevAttrMultiProcessorCount,
                               dev);
    if (e == cudaSuccess) e = allow_smem(cs);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &seen_per_sm, packet_kernel, BLOCK, tile_smem(cs));
    if (e != cudaSuccess) return (int)e;
    seen_dev = dev;
    seen_cs = cs;
  }
  out[0] = seen_per_sm;
  out[1] = seen_n_sm;
  return (int)cudaSuccess;
}

// Nearest hit of R > 0 rays (o, d: (R, 3) f32) against C clusters of CS
// triangles (aabb (C, 8), tri (C, CS, 12) f32, tri_id (C*CS,) i32), on
// `stream`, the clusters cut into K slices (K = 1, or K <= min(C,
// SPLIT_MAX)); for K > 1, part (2 K R i32) and tickets (ceil(R / 256) i32,
// zero, left zero) are scratch.  Writes t (R,) f32 and the original triangle index
// (R,) i32 (-1 on a miss).  Returns cudaGetLastError().
extern "C" int packet_nearest(const float* aabb, const float* tri,
                              const int* tri_id, int n_clusters, int cs,
                              const float* o, const float* d, int R,
                              float t_min, int K, int* part, int* tickets,
                              float* t, int* idx, void* stream) {
  if (cs <= 0 || R <= 0 || n_clusters < 0 || K < 1 ||
      K > cluster_tri::SPLIT_MAX || (K > 1 && K > n_clusters) ||
      (K > 1 && (part == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(cs);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (R + BLOCK - 1) / BLOCK;
  packet_kernel<<<blocks * K, BLOCK, tile_smem(cs), (cudaStream_t)stream>>>(
      aabb, tri, tri_id, n_clusters, cs, o, d, R, t_min, K, part, tickets, t,
      idx);
  return (int)cudaGetLastError();
}
