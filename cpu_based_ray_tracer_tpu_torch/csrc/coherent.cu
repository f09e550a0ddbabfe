// coherent.cu — the shortlist intersector for coherent ray sets on Hopper
// (sm_90a): exact per-tile cluster work lists, then a sweep of each tile's
// list only.
//
// Replaces the Pallas TPU kernels of cpu_based_ray_tracer_tpu/ops/
// coherent.py:
//   mask_kernel  <- _mask_kernel (:86, launched by _shortlists :134), with
//                   the per-tile OR that the JAX package does in XLA
//                   (:149-151) fused in;
//   sweep_kernel <- _sweep_kernel (:165, launched by nearest :282).
// The mask kernel also serves the fused mesh-MC stepper's
// shortlist-streaming mode (ops/fused_mesh.py _mesh_pass :1103-1107) over
// packed rays, with the packed count read on the device.
//
// Layout: rays are (P, Hp, Wp) f32 planes, P = 6 [o d] or 7 [o d lim],
// Hp a multiple of 32 and Wp of 128; a tile is a 32 x 128 rectangle of
// lanes, tile = (y / 32) * (Wp / 128) + x / 128 (packed rays are planes of
// Wp = 128: a tile is 4,096 consecutive rays).
//
// What bounds them on this card, and what the design does about it:
//   - mask: C slab tests of ~22 f32 operations a lane, against 24-28 bytes
//     of rays read and 4 bytes a lane per 32 clusters written: operations
//     for more than a few dozen clusters.  One thread per lane; the AABBs
//     are staged in shared memory, 1,024 clusters (24 KB) at a time, and
//     read as broadcasts.  Each thread builds a 32-cluster word in a
//     register, writes it to its mask plane (when the caller asks for the
//     planes: the lists need only the tile words), and the warp ORs its 32 words
//     (__reduce_or_sync: a warp lies in one tile) into the tile's word with
//     one atomicOr.
//   - sweep: listed clusters x 128 triangles x ~48 f32 operations a lane.
//     16 blocks of 256 threads share each 4,096-lane tile and its list;
//     each listed cluster's 128 x 16 floats (8 KB) are staged in shared
//     memory by a cooperative float4 load and read as broadcasts
//     (csrc/cluster_tri.cuh, the body of fused_mesh.cu's nearest sweep).
//     The TPU kernel keeps the whole table resident in SMEM; here it stays
//     in device memory, and the L2 holds it.
//
// Numerics: -fmad=false, no fast math, the TPU kernels' operation order
// (1.0f / x is an IEEE division), as the plain versions in ops/coherent.py.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

#include "cluster_tri.cuh"

namespace {

constexpr int MASK_BLOCK = 256;
constexpr int SWEEP_BLOCK = 256;
constexpr int TILE_H = 32, TILE_W = 128, TILE = TILE_H * TILE_W;
constexpr int AABB_CHUNK = 1024;  // clusters staged at once (a multiple of 32)
constexpr int AABB_W = 8;         // floats per AABB row: min xyz, max xyz, pad
constexpr float NO_HIT = FLT_MAX;

// 1 / v with |v| raised to at least 1e-20, keeping its sign.
__device__ __forceinline__ float sinv(float v) {
  const float tiny = v < 0.0f ? -1e-20f : 1e-20f;
  return 1.0f / (fabsf(v) < 1e-20f ? tiny : v);
}

__global__ void __launch_bounds__(MASK_BLOCK)
mask_kernel(const float* __restrict__ aabb, int n_cl,
            const float* __restrict__ rays, bool has_lim, int hp, int wp,
            float t_min, const int* __restrict__ cnt,
            uint32_t* __restrict__ masks, uint32_t* __restrict__ tile_words) {
  __shared__ float box[AABB_CHUNK * 6];
  const size_t n_lanes = (size_t)hp * wp;
  const int lane = blockIdx.x * MASK_BLOCK + threadIdx.x;  // < n_lanes
  const int y = lane / wp, x = lane - y * wp;
  const int tile = (y / TILE_H) * (wp / TILE_W) + x / TILE_W;
  const int b32 = (n_cl + 31) / 32;
  // packed rays: only the first *cnt lanes (at most all) are rays
  const bool active = cnt == nullptr || lane < *cnt;
  float ox = 0.f, oy = 0.f, oz = 0.f, ivx = 0.f, ivy = 0.f, ivz = 0.f;
  float hi_bound = 0.f;
  if (active) {
    ox = rays[lane];
    oy = rays[n_lanes + lane];
    oz = rays[2 * n_lanes + lane];
    ivx = sinv(rays[3 * n_lanes + lane]);
    ivy = sinv(rays[4 * n_lanes + lane]);
    ivz = sinv(rays[5 * n_lanes + lane]);
    if (has_lim) hi_bound = rays[6 * n_lanes + lane] * 1.000001f + 1e-5f;
  }
  const float t_lo = fminf(t_min, 0.0f);
  for (int c0 = 0; c0 < n_cl; c0 += AABB_CHUNK) {
    const int nc = min(AABB_CHUNK, n_cl - c0);
    __syncthreads();  // the previous chunk is no longer read
    for (int w = threadIdx.x; w < nc * 6; w += MASK_BLOCK)
      box[w] = aabb[(size_t)(c0 + w / 6) * AABB_W + w % 6];
    __syncthreads();
    for (int w0 = 0; w0 < nc; w0 += 32) {
      uint32_t word = 0u;
      if (active) {
        const int nb = min(32, nc - w0);
        for (int j = 0; j < nb; ++j) {
          const float* A = box + (w0 + j) * 6;
          const float tx0 = (A[0] - ox) * ivx, tx1 = (A[3] - ox) * ivx;
          const float ty0 = (A[1] - oy) * ivy, ty1 = (A[4] - oy) * ivy;
          const float tz0 = (A[2] - oz) * ivz, tz1 = (A[5] - oz) * ivz;
          const float t_in = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                                   fminf(tz0, tz1));
          const float t_out = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                                    fmaxf(tz0, tz1));
          bool crossed = (t_out >= t_lo) && (t_in <= t_out);
          if (has_lim) crossed = crossed && (t_in <= hi_bound);
          if (crossed) word |= 1u << j;
        }
      }
      const int w = (c0 + w0) / 32;
      if (masks != nullptr) masks[(size_t)w * n_lanes + lane] = word;
      const uint32_t tile_or = __reduce_or_sync(0xffffffffu, word);
      if ((threadIdx.x & 31) == 0 && tile_or != 0u)
        atomicOr(&tile_words[(size_t)tile * b32 + w], tile_or);
    }
  }
}

__global__ void __launch_bounds__(SWEEP_BLOCK)
sweep_kernel(const float* __restrict__ tri, int n_cl, int cs,
             const float* __restrict__ rays, int hp, int wp,
             const int* __restrict__ ids, const int* __restrict__ cnts,
             float t_min, float* __restrict__ out) {
  extern __shared__ float4 tile4[];
  constexpr int PER_TILE = TILE / SWEEP_BLOCK;   // blocks per tile
  constexpr int ROWS = SWEEP_BLOCK / TILE_W;     // lane rows per block
  const int tile = blockIdx.x / PER_TILE;
  const int sub = blockIdx.x - tile * PER_TILE;
  const int gw = wp / TILE_W;
  const int ty = tile / gw, tx = tile - ty * gw;
  const int y = ty * TILE_H + sub * ROWS + threadIdx.x / TILE_W;
  const int x = tx * TILE_W + threadIdx.x % TILE_W;
  const size_t n_lanes = (size_t)hp * wp;
  const size_t lane = (size_t)y * wp + x;
  // The count is the tile's: a block with an empty list skips the loop and
  // its barriers as a whole.
  const int n = cnts[tile];
  float best_t = NO_HIT, bidx = -1.0f;
  if (n > 0) {
    const float ox = rays[lane], oy = rays[n_lanes + lane];
    const float oz = rays[2 * n_lanes + lane];
    const float dx = rays[3 * n_lanes + lane], dy = rays[4 * n_lanes + lane];
    const float dz = rays[5 * n_lanes + lane];
    const int* list = ids + (size_t)tile * n_cl;
    const int words4 = cs * cluster_tri::NF / 4;
    const float* tl = reinterpret_cast<const float*>(tile4);
    for (int j = 0; j < n; ++j) {
      __syncthreads();  // the previous cluster is no longer read
      cluster_tri::stage_cluster(tile4, tri, list[j], words4);
      __syncthreads();
      const int k = cluster_tri::nearest_rows(tl, cs, ox, oy, oz, dx, dy, dz,
                                              t_min, best_t);
      if (k >= 0) bidx = tl[k * cluster_tri::NF + 13];
    }
  }
  out[lane] = best_t;
  out[n_lanes + lane] = bidx;
}

bool bad_planes(int hp, int wp) {
  return hp <= 0 || wp <= 0 || hp % TILE_H != 0 || wp % TILE_W != 0;
}

}  // namespace

// Each entry point launches one kernel on `stream` and returns
// cudaGetLastError().

// The mask pass: rays (n_planes, hp, wp) -> masks (ceil(n_cl / 32), hp, wp)
// u32 (bit c % 32 of word c / 32: the lane's segment crosses cluster c's
// AABB; not written when masks is null), and ORs each word into tile_words
// (tiles, ceil(n_cl / 32)), which the caller zeroes.  n_planes 7: the segment ends at lim * 1.000001 +
// 1e-5.  cnt (nullable): only the first *cnt lanes are rays (all of them
// when *cnt >= hp * wp), the others get 0 words.
extern "C" int coherent_mask(const float* aabb, int n_cl, const float* rays,
                             int n_planes, int hp, int wp, float t_min,
                             const int* cnt, uint32_t* masks,
                             uint32_t* tile_words, void* stream) {
  if (n_cl <= 0 || (n_planes != 6 && n_planes != 7) || bad_planes(hp, wp))
    return (int)cudaErrorInvalidValue;
  const int blocks = (int)((size_t)hp * wp / MASK_BLOCK);
  mask_kernel<<<blocks, MASK_BLOCK, 0, (cudaStream_t)stream>>>(
      aabb, n_cl, rays, n_planes == 7, hp, wp, t_min, cnt, masks, tile_words);
  return (int)cudaGetLastError();
}

// The shortlist sweep: rays (6, hp, wp), the cluster table tri (n_cl, cs,
// 16), per tile ids[tile * n_cl + j] for j < cnts[tile] -> out (2, hp, wp):
// the nearest t (FLT_MAX on a miss) and the triangle index of slot 13 (-1).
extern "C" int coherent_sweep(const float* tri, int n_cl, int cs,
                              const float* rays, int hp, int wp,
                              const int* ids, const int* cnts, float t_min,
                              float* out, void* stream) {
  if (n_cl <= 0 || cs <= 0 || cs * cluster_tri::NF % 4 != 0 ||
      bad_planes(hp, wp))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)cs * cluster_tri::NF * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (int)((size_t)hp * wp / SWEEP_BLOCK);
  sweep_kernel<<<blocks, SWEEP_BLOCK, smem, (cudaStream_t)stream>>>(
      tri, n_cl, cs, rays, hp, wp, ids, cnts, t_min, out);
  return (int)cudaGetLastError();
}
