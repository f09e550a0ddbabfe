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
//   - sweep: ~48 f32 operations (~65 instructions) a triangle test, so
//     the triangles a ray tests.  A tile's list is the union of its 4,096
//     lanes' boxes (7.5 of 58 clusters for bvh_stage_scene(4)'s camera
//     rays), while a ray crosses a few, and within a crossed cluster of
//     128 rows it can hit only the rows near its line.  So a ray tests a
//     listed cluster's padded box, and in a cluster it crosses the boxes
//     of its groups of 8 consecutive rows (part of a BVH leaf's patch; the
//     block forms them from the staged rows), and runs Moller-Trumbore
//     only over the rows of the groups it crosses.  Lanes go to threads in
//     16 x 16 squares of a tile, warps in 4 x 8 squares: a compact
//     footprint crosses fewer boxes than a row.  Work items are (256-lane ray
//     block, list slice) pairs, as the split sweeps of csrc/fused_mesh.cu
//     and csrc/packet.cu, so that tiles with long lists are shared out; a
//     block stages only the clusters one of its rays crosses, 8 KB each by
//     cp.async into two shared buffers, the next while the current one is
//     tested, read as broadcasts (csrc/cluster_tri.cuh).  The TPU kernel
//     keeps the whole table resident in SMEM and tests every listed
//     triangle; here the table stays in device memory, and the L2 holds
//     it.
//
// Numerics: -fmad=false, no fast math, the TPU kernels' operation order
// (1.0f / x is an IEEE division), as the plain versions in ops/coherent.py.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "cluster_tri.cuh"

namespace {

constexpr int MASK_BLOCK = 256;
constexpr int SWEEP_BLOCK = 256;
// Rows of a staged cluster a sub-box covers: the BVH leaves the clusters
// are cut from hold 8 to 16 triangles (ops/fused_mesh.py
// build_smem_clusters), so a run of 8 rows is a compact patch (8 measured
// faster than 16 and 32).  A cluster is a whole number of groups (the
// table's rows come in eights, as the JAX package's layout needs) of at
// most SWEEP_BLOCK rows (one thread a row; ops/coherent.py pack_coherent
// refuses other cluster sizes).
constexpr int GROUP_ROWS = 8;
constexpr int MAX_GROUPS = SWEEP_BLOCK / GROUP_ROWS;
constexpr int TILE_H = 32, TILE_W = 128, TILE = TILE_H * TILE_W;
// A sweep block's lanes: a 16 x 16 square of its tile, in warps of 4 x 8
// lanes, whose rays cross fewer boxes than a row of 32 or of 256 does.
constexpr int BLOCK_H = 16, BLOCK_W = 16, WARP_H = 4, WARP_W = 8;
static_assert(BLOCK_H * BLOCK_W == SWEEP_BLOCK && WARP_H * WARP_W == 32 &&
              TILE_H % BLOCK_H == 0 && TILE_W % BLOCK_W == 0 &&
              BLOCK_H % WARP_H == 0 && BLOCK_W % WARP_W == 0,
              "the blocks tile a tile and the warps a block");
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

// The boxes of the staged cluster's groups of GROUP_ROWS rows into gbox:
// thread r takes row r's corners v0, v0 + e1, v0 + e2, and the lanes of a
// group reduce them by shuffles (ops/coherent.py group_boxes_plain).
// Every thread of the block calls it; it ends with a barrier.
__device__ __forceinline__ void group_boxes(const float* tl, int cs,
                                            float (*gbox)[6]) {
  const int r = threadIdx.x;
  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  if (r < cs) {
    const float* T = tl + r * cluster_tri::NF;
    for (int a = 0; a < 3; ++a) {
      const float v = T[a], v1 = v + T[3 + a], v2 = v + T[6 + a];
      lo[a] = fminf(fminf(v, v1), v2);
      hi[a] = fmaxf(fmaxf(v, v1), v2);
    }
  }
  for (int o = GROUP_ROWS / 2; o > 0; o >>= 1)
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(0xffffffffu, lo[a], o));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(0xffffffffu, hi[a], o));
    }
  if (r % GROUP_ROWS == 0 && r < cs)
    for (int a = 0; a < 3; ++a) {
      gbox[r / GROUP_ROWS][a] = lo[a];
      gbox[r / GROUP_ROWS][3 + a] = hi[a];
    }
  __syncthreads();
}

// The sweep's work items are (ray block, list slice) pairs: block b = rb * K
// + k takes ray block rb (SWEEP_BLOCK lanes: a 16 x 16 square of a tile)
// and slice k of K of its tile's list (positions [n k / K, n (k + 1) / K)
// of a list of n).  A ray tests a row only when it crosses the padded
// boxes of the row's cluster and of the row's group
// (cluster_tri::crosses_box, conservative: a ray that hits a triangle
// crosses both), and a block stages only the clusters one of its rays
// crosses, by cp.async into two buffers, the next while the current one
// is tested (cluster_tri::walk_slice).  Within a slice the first row at
// the least t wins (a skipped row holds no hit); with K > 1 each slice
// writes its (t, index) per lane to `part`, and the last block of the ray
// block to finish (cluster_tri::last_slice) keeps a later slice only when
// it is strictly nearer: the serial sweep's rule, so every K gives its
// bits.
__global__ void __launch_bounds__(SWEEP_BLOCK)
sweep_kernel(const float* __restrict__ tri, const float* __restrict__ aabb,
             int n_cl, int cs, const float* __restrict__ rays, int hp,
             int wp, const int* __restrict__ ids, const int* __restrict__ cnts,
             float t_min, int K, int* part, int* __restrict__ tickets,
             float* __restrict__ out) {
  extern __shared__ float4 tile4[];
  __shared__ float gbox[MAX_GROUPS][6];
  constexpr int PER_TILE = TILE / SWEEP_BLOCK;   // ray blocks per tile
  const int rb = blockIdx.x / K, k = blockIdx.x - rb * K;
  const int tile = rb / PER_TILE;
  const int sub = rb - tile * PER_TILE;
  const int gw = wp / TILE_W;
  const int ty = tile / gw, tx = tile - ty * gw;
  // a ray block is BLOCK_H x BLOCK_W lanes of its tile, a warp WARP_H x
  // WARP_W of them
  const int warp = threadIdx.x / 32, wl = threadIdx.x % 32;
  constexpr int BLOCKS_W = TILE_W / BLOCK_W, WARPS_W = BLOCK_W / WARP_W;
  const int y = ty * TILE_H + (sub / BLOCKS_W) * BLOCK_H +
                (warp / WARPS_W) * WARP_H + wl / WARP_W;
  const int x = tx * TILE_W + (sub % BLOCKS_W) * BLOCK_W +
                (warp % WARPS_W) * WARP_W + wl % WARP_W;
  const size_t n_lanes = (size_t)hp * wp;
  const size_t lane = (size_t)y * wp + x;
  const float ox = rays[lane], oy = rays[n_lanes + lane];
  const float oz = rays[2 * n_lanes + lane];
  const float dx = rays[3 * n_lanes + lane], dy = rays[4 * n_lanes + lane];
  const float dz = rays[5 * n_lanes + lane];
  const float ivx = sinv(dx), ivy = sinv(dy), ivz = sinv(dz);
  const float o_mag = fmaxf(fmaxf(fabsf(ox), fabsf(oy)), fabsf(oz));
  const float t_lo = fminf(t_min, 0.0f);
  const int* list = ids + (size_t)tile * n_cl;
  const int n = cnts[tile];
  const int j0 = (int)((long long)n * k / K);
  const int j1 = (int)((long long)n * (k + 1) / K);
  float best_t = NO_HIT, bidx = -1.0f;
  cluster_tri::walk_slice<false>(
      tile4, tri, cs * cluster_tri::NF / 4, j0, j1, [] { return true; },
      [&](int q) {
        return cluster_tri::crosses_box(aabb + (size_t)list[q] * AABB_W, ox,
                                        oy, oz, o_mag, ivx, ivy, ivz, t_lo,
                                        0.0f, false);
      },
      [&](int q) { return list[q]; },
      [&](int, const float* tl, bool mine) {
        // A ray tests the rows of a group whose box it crosses, in a
        // cluster whose box it crosses; a warp none of whose rays crosses
        // a box skips it.  Rows in order, the first at the least t wins.
        group_boxes(tl, cs, gbox);
        if (!__any_sync(0xffffffffu, mine)) return;
        for (int g = 0; g * GROUP_ROWS < cs; ++g) {
          const bool in = mine && cluster_tri::crosses_box(
                                      gbox[g], ox, oy, oz, o_mag, ivx, ivy,
                                      ivz, t_lo, 0.0f, false);
          if (!__any_sync(0xffffffffu, in)) continue;
          if (in) {
            const float* rows = tl + g * GROUP_ROWS * cluster_tri::NF;
            const int kk = cluster_tri::nearest_rows(
                rows, GROUP_ROWS, ox, oy, oz, dx, dy, dz, t_min, best_t);
            if (kk >= 0) bidx = rows[kk * cluster_tri::NF + 13];
          }
        }
      });
  if (K > 1) {
    part[(2 * k) * n_lanes + lane] = __float_as_int(best_t);
    part[(2 * k + 1) * n_lanes + lane] = __float_as_int(bidx);
    if (!cluster_tri::last_slice(tickets, rb, K)) return;
    // The slices in list order; partials from other blocks are read past
    // L1 (__ldcg).
    best_t = NO_HIT;
    bidx = -1.0f;
    for (int s = 0; s < K; ++s) {
      const float t = __int_as_float(__ldcg(part + (2 * s) * n_lanes + lane));
      if (t < best_t) {
        best_t = t;
        bidx = __int_as_float(__ldcg(part + (2 * s + 1) * n_lanes + lane));
      }
    }
  }
  out[lane] = best_t;
  out[n_lanes + lane] = bidx;
}

bool bad_planes(int hp, int wp) {
  return hp <= 0 || wp <= 0 || hp % TILE_H != 0 || wp % TILE_W != 0;
}

size_t tile_smem(int cs) {
  return 2 * (size_t)cs * cluster_tri::NF * sizeof(float);
}

cudaError_t allow_smem(int cs) {
  if (tile_smem(cs) <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(sweep_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)tile_smem(cs));
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

// The sweep's resident blocks per SM for clusters of cs triangles, and the
// SM count: out[0], out[1] (ops/coherent.py sizes the slices by them),
// asked of the runtime once per device and cluster size.  Launches nothing.
extern "C" int coherent_sweep_slots(int cs, int* out) {
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
          &seen_per_sm, sweep_kernel, SWEEP_BLOCK, tile_smem(cs));
    if (e != cudaSuccess) return (int)e;
    seen_dev = dev;
    seen_cs = cs;
  }
  out[0] = seen_per_sm;
  out[1] = seen_n_sm;
  return (int)cudaSuccess;
}

// The shortlist sweep: rays (6, hp, wp), the cluster table tri (n_cl, cs,
// 16) and its boxes aabb (n_cl, 8), per tile ids[tile * n_cl + j] for j <
// cnts[tile] -> out (2, hp, wp): the nearest t (FLT_MAX on a miss) and the
// triangle index of slot 13 (-1).  Each tile's list is cut into K slices
// (1 <= K <= SPLIT_MAX); for K > 1, part (2 K hp wp i32) and tickets
// (hp wp / 256 i32, zero, left zero) are scratch.
extern "C" int coherent_sweep(const float* tri, const float* aabb, int n_cl,
                              int cs, const float* rays, int hp, int wp,
                              const int* ids, const int* cnts, float t_min,
                              int K, int* part, int* tickets, float* out,
                              void* stream) {
  if (n_cl <= 0 || cs <= 0 || cs > SWEEP_BLOCK || cs % GROUP_ROWS != 0 ||
      bad_planes(hp, wp) || K < 1 || K > cluster_tri::SPLIT_MAX ||
      (K > 1 && (part == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(cs);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (int)((size_t)hp * wp / SWEEP_BLOCK);
  sweep_kernel<<<blocks * K, SWEEP_BLOCK, tile_smem(cs),
                 (cudaStream_t)stream>>>(tri, aabb, n_cl, cs, rays, hp, wp,
                                         ids, cnts, t_min, K, part, tickets,
                                         out);
  return (int)cudaGetLastError();
}
