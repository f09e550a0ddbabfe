// coherent.cu — the shortlist intersector for coherent ray sets on Hopper
// (sm_90a): exact per-tile cluster work lists, then a sweep of each tile's
// list only.
//
// Replaces the Pallas TPU kernels of cpu_based_ray_tracer_tpu/ops/
// coherent.py:
//   mask_kernel  <- _mask_kernel (:86, launched by _shortlists :134), with
//                   the per-tile OR and the lists that the JAX package
//                   makes in XLA (:149-158) fused in;
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
//   - mask: a slab test is ~22 f32 operations (~30 instructions) against
//     24-28 bytes of rays read and 4 bytes a lane per 32 clusters written:
//     the tests a lane issues.  A ray crosses a few of the C boxes (4.7 of
//     58 on bvh_stage_scene(4)'s camera rays, ~5 of 1,280 on the 164k
//     cell), and the clusters come in BVH preorder, so 32 consecutive
//     ones are a compact patch.  So a lane tests a box per 32-cluster word,
//     in a crossed word a box per 4 clusters (4 measured faster than 2, 8
//     and 32), and in a crossed group its 4 clusters; the boxes are read by
//     the warp at one address (float4 rows, L1), not staged.  Where the
//     words are many (packed rays against a big mesh), a lane's words are
//     cut into slices taken by threads of their own, so that the small
//     grid fills the card, and the warp shares its (lane, box) pairs out
//     over its lanes: a warp of packed rays crosses ~6x the boxes a lane
//     does.  A warp lies in one tile; its words are ORed into the
//     block's in shared memory, and the tile's last block ORs its
//     blocks' words and writes the tile's list, so the lists cost no
//     launch of their own.  On packed rays a block past the count only
//     writes its zero mask words.
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
constexpr int AABB_W = 8;         // floats per AABB row: min xyz, max xyz, pad
// The mask pass's boxes: a box per 32-cluster word and, inside it, a box
// per group of MASK_GROUP clusters (LEVEL_ROWS rows of AABB_W floats a
// word: ops/coherent.py level_boxes).  A lane's words may be cut into up
// to MAX_WORD_SLICES slices, each taken by a thread of its own.
constexpr int MASK_GROUP = 4;
constexpr int GROUPS_PER_WORD = 32 / MASK_GROUP;
constexpr int LEVEL_ROWS = 1 + GROUPS_PER_WORD;
static_assert(32 * GROUPS_PER_WORD <= 256 && GROUPS_PER_WORD < 32,
              "a (lane, group) pair's code is a byte, a lane's groups a mask");
constexpr int MAX_WORD_SLICES = 8;
static_assert(TILE % MASK_BLOCK == 0 && MASK_BLOCK / MAX_WORD_SLICES >= 32,
              "a mask block's lanes lie in one tile, in whole warps");
constexpr float NO_HIT = FLT_MAX;

// 1 / v with |v| raised to at least 1e-20, keeping its sign.
__device__ __forceinline__ float sinv(float v) {
  const float tiny = v < 0.0f ? -1e-20f : 1e-20f;
  return 1.0f / (fabsf(v) < 1e-20f ? tiny : v);
}

// The slab test of the mask pass: does the ray's segment from t_lo (up to
// hi with a lim plane) cross the box at `row` (min xyz, max xyz, pad: two
// float4, read by the whole warp at one address)?  The TPU kernel's
// operations in its order.
struct MaskRay {
  float ox, oy, oz, ivx, ivy, ivz, t_lo, hi;
};

__device__ __forceinline__ bool slab_crossed(const float* __restrict__ row,
                                             const MaskRay& r, bool has_lim) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(row));
  const float4 b = __ldg(reinterpret_cast<const float4*>(row) + 1);
  const float tx0 = (a.x - r.ox) * r.ivx, tx1 = (a.w - r.ox) * r.ivx;
  const float ty0 = (a.y - r.oy) * r.ivy, ty1 = (b.x - r.oy) * r.ivy;
  const float tz0 = (a.z - r.oz) * r.ivz, tz1 = (b.y - r.oz) * r.ivz;
  const float t_in = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                           fminf(tz0, tz1));
  const float t_out = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                            fmaxf(tz0, tz1));
  const bool crossed = (t_out >= r.t_lo) && (t_in <= t_out);
  return has_lim ? crossed && (t_in <= r.hi) : crossed;
}

// A ray's fields from lane `src` of the warp (every lane calls it).
__device__ __forceinline__ MaskRay ray_of(const MaskRay& r, int src) {
  MaskRay q;
  q.ox = __shfl_sync(0xffffffffu, r.ox, src);
  q.oy = __shfl_sync(0xffffffffu, r.oy, src);
  q.oz = __shfl_sync(0xffffffffu, r.oz, src);
  q.ivx = __shfl_sync(0xffffffffu, r.ivx, src);
  q.ivy = __shfl_sync(0xffffffffu, r.ivy, src);
  q.ivz = __shfl_sync(0xffffffffu, r.ivz, src);
  q.t_lo = r.t_lo;
  q.hi = __shfl_sync(0xffffffffu, r.hi, src);
  return q;
}

// The lane's word w: the clusters it crosses in the word's crossed groups
// (lv: the word's box, then its groups').  Every lane of the warp calls
// it.  The warp runs a level's tests for the union of its lanes where the
// lanes that need them are many (a coherent warp), and otherwise as a
// list of (lane, box) pairs shared out over the warp, each lane testing
// with the pair's ray (shuffled from its lane): the same tests, so the
// same bits, in fewer rounds when the lanes cross different boxes (the
// packed rays of the fused mesh stepper).  `owner` and `pair` are the
// warp's scratch (32 and 32 * GROUPS_PER_WORD bytes), `acc` its 32 words.
__device__ __forceinline__ uint32_t word_bits(
    const float* __restrict__ aabb, const float* __restrict__ lv, int w,
    int n_cl, const MaskRay& r, bool active, bool has_lim, uint8_t* owner,
    uint8_t* pair, uint32_t* acc) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const bool in_w = active && slab_crossed(lv, r, has_lim);
  const unsigned wm = __ballot_sync(0xffffffffu, in_w);
  if (wm == 0u) return 0u;
  const int ng = min(GROUPS_PER_WORD,
                     (n_cl - w * 32 + MASK_GROUP - 1) / MASK_GROUP);
  // the group boxes, for the lanes that cross the word
  constexpr int OWNERS = 32 / GROUPS_PER_WORD;   // lanes a round serves
  uint32_t gbits = 0u;
  const int nw = __popc(wm);
  if (nw > 4 * OWNERS) {
    if (in_w)
      for (int g = 0; g < ng; ++g)
        if (slab_crossed(lv + (1 + g) * AABB_W, r, has_lim)) gbits |= 1u << g;
  } else {
    const int rank = __popc(wm & below);
    if (in_w) owner[rank] = (uint8_t)lane;
    __syncwarp();
    for (int rd = 0; rd * OWNERS < nw; ++rd) {
      const int k = rd * OWNERS + lane / GROUPS_PER_WORD;
      const int g = lane % GROUPS_PER_WORD;
      const MaskRay q = ray_of(r, k < nw ? owner[k] : lane);
      const bool hit = k < nw && g < ng &&
                       slab_crossed(lv + (1 + g) * AABB_W, q, has_lim);
      const unsigned bal = __ballot_sync(0xffffffffu, hit);
      if (in_w && rank / OWNERS == rd)
        gbits = (bal >> (rank % OWNERS * GROUPS_PER_WORD)) &
                ((1u << GROUPS_PER_WORD) - 1u);
    }
    __syncwarp();
  }
  // the clusters of the crossed groups
  const unsigned g_or = __reduce_or_sync(0xffffffffu, gbits);
  if (g_or == 0u) return 0u;
  const int npair = __popc(gbits);
  int incl = npair;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  constexpr int PER_ROUND = 32 / MASK_GROUP;     // pairs a round tests
  uint32_t word = 0u;
  if ((total + PER_ROUND - 1) / PER_ROUND + 1 >= 2 * __popc(g_or)) {
    for (int g = 0; g < ng; ++g) {
      if (!((g_or >> g) & 1u)) continue;
      if ((gbits >> g) & 1u) {
        const int c0 = w * 32 + g * MASK_GROUP;
        const int nb = min(MASK_GROUP, n_cl - c0);
#pragma unroll
        for (int j = 0; j < MASK_GROUP; ++j)
          if (j < nb &&
              slab_crossed(aabb + (size_t)(c0 + j) * AABB_W, r, has_lim))
            word |= 1u << (g * MASK_GROUP + j);
      }
    }
    return word;
  }
  int at = incl - npair;
  for (unsigned b = gbits; b != 0u; b &= b - 1u)
    pair[at++] = (uint8_t)(lane * GROUPS_PER_WORD + __ffs(b) - 1);
  acc[lane] = 0u;
  __syncwarp();
  for (int rd = 0; rd * PER_ROUND < total; ++rd) {
    const int p = rd * PER_ROUND + lane / MASK_GROUP;
    const int j = lane % MASK_GROUP;
    const int code = p < total ? pair[p] : lane * GROUPS_PER_WORD;
    const int src = code / GROUPS_PER_WORD, g = code % GROUPS_PER_WORD;
    const MaskRay q = ray_of(r, src);
    const int c = w * 32 + g * MASK_GROUP + j;
    if (p < total && c < n_cl &&
        slab_crossed(aabb + (size_t)c * AABB_W, q, has_lim))
      atomicOr(&acc[src], 1u << (g * MASK_GROUP + j));
  }
  __syncwarp();
  word = acc[lane];
  __syncwarp();
  return word;
}

// The mask pass and the lists.  A lane's words are cut into S slices
// (S = 1, 2, 4 or 8: more threads where the words are many, so that a small
// grid of packed rays still fills the card); block b takes L = MASK_BLOCK /
// S consecutive lanes of tile b / (TILE / L), thread t slice t / L of lane
// t % L (a warp: 32 lanes, one slice).  A lane tests the box of each
// 32-cluster word of its slice, in a crossed word the boxes of its groups
// of MASK_GROUP clusters, and in a crossed group its clusters' boxes
// (word_bits: the warp's union of boxes, or its (lane, box) pairs).  A
// word's or a group's box holds its members' boxes, and the rounded slab
// arithmetic is monotone in the box's sides, so a ray that crosses a
// member crosses it: no bit is lost (ops/coherent.py level_boxes,
// mask_plain).  The warps OR their words into the block's words in shared
// memory, the block writes them to its slot of `part`, and the last block
// of the tile to finish (a ticket per tile) ORs the tile's partials into
// its tile words and, when ids is given, writes the tile's list: the set
// bits in ascending cluster order, then the unset ones, and their count.
// On packed rays (cnt) a block whose first lane is at or past *cnt writes
// only its zero mask words, and no one reads its partials.
template <int S>
__global__ void __launch_bounds__(MASK_BLOCK)
mask_kernel(const float* __restrict__ aabb, const float* __restrict__ levels,
            int n_cl, const float* __restrict__ rays, bool has_lim, int hp,
            int wp, float t_min, const int* __restrict__ cnt,
            uint32_t* __restrict__ masks, uint32_t* __restrict__ tile_words,
            uint32_t* part, int* __restrict__ tickets, int* __restrict__ ids,
            int* __restrict__ cnts) {
  extern __shared__ uint32_t sw[];  // b32 words: the block's, then the tile's
  __shared__ uint8_t owner_s[MASK_BLOCK / 32][32];
  __shared__ uint8_t pair_s[MASK_BLOCK / 32][32 * GROUPS_PER_WORD];
  __shared__ uint32_t acc_s[MASK_BLOCK / 32][32];
  constexpr int L = MASK_BLOCK / S, per_tile = TILE / L;
  const int b32 = (n_cl + 31) / 32;
  const int tile = blockIdx.x / per_tile;
  const int sub = blockIdx.x - tile * per_tile;
  const int gw = wp / TILE_W;
  const int ty = tile / gw, tx = tile - ty * gw;
  const size_t n_lanes = (size_t)hp * wp;
  // lane i of the tile's TILE_H x TILE_W, row-major
  const auto lane_of = [&](int i) {
    return (long long)(ty * TILE_H + i / TILE_W) * wp + tx * TILE_W +
           i % TILE_W;
  };
  const int slice = threadIdx.x / L;
  const size_t lane = (size_t)lane_of(sub * L + threadIdx.x % L);
  const int w0 = slice * b32 / S, w1 = (slice + 1) * b32 / S;
  // packed rays: only the first *cnt lanes (at most all) are rays
  const long long n_act = cnt == nullptr ? (long long)n_lanes : *cnt;
  if (lane_of(sub * L) < n_act) {
    for (int w = threadIdx.x; w < b32; w += MASK_BLOCK) sw[w] = 0u;
    __syncthreads();
    const bool active = (long long)lane < n_act;
    MaskRay r = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, fminf(t_min, 0.0f), 0.f};
    if (active) {
      r.ox = rays[lane];
      r.oy = rays[n_lanes + lane];
      r.oz = rays[2 * n_lanes + lane];
      r.ivx = sinv(rays[3 * n_lanes + lane]);
      r.ivy = sinv(rays[4 * n_lanes + lane]);
      r.ivz = sinv(rays[5 * n_lanes + lane]);
      if (has_lim) r.hi = rays[6 * n_lanes + lane] * 1.000001f + 1e-5f;
    }
    const int wi = threadIdx.x / 32;
    for (int w = w0; w < w1; ++w) {
      // Where a lane's words are sliced (the clusters are many: the 164k
      // cell's packed rays), word_bits; else a warp runs the boxes its
      // lanes cross, fused (camera and shadow rays: measured faster than
      // word_bits there).
      const float* lv = levels + (size_t)w * LEVEL_ROWS * AABB_W;
      uint32_t word = 0u;
      if (S > 1) {
        word = word_bits(aabb, lv, w, n_cl, r, active, has_lim, owner_s[wi],
                         pair_s[wi], acc_s[wi]);
      } else {
        const bool in_w = active && slab_crossed(lv, r, has_lim);
        if (__any_sync(0xffffffffu, in_w)) {
#pragma unroll
          for (int g = 0; g < GROUPS_PER_WORD; ++g) {
            const int c0 = w * 32 + g * MASK_GROUP;
            if (c0 >= n_cl) break;
            const bool in_g =
                in_w && slab_crossed(lv + (1 + g) * AABB_W, r, has_lim);
            if (!__any_sync(0xffffffffu, in_g)) continue;
            if (in_g) {
              const int nb = min(MASK_GROUP, n_cl - c0);
#pragma unroll
              for (int j = 0; j < MASK_GROUP; ++j)
                if (j < nb && slab_crossed(aabb + (size_t)(c0 + j) * AABB_W,
                                           r, has_lim))
                  word |= 1u << (g * MASK_GROUP + j);
            }
          }
        }
      }
      if (masks != nullptr) masks[(size_t)w * n_lanes + lane] = word;
      const uint32_t warp_or = __reduce_or_sync(0xffffffffu, word);
      if ((threadIdx.x & 31) == 0 && warp_or != 0u) atomicOr(&sw[w], warp_or);
    }
    __syncthreads();
    for (int w = threadIdx.x; w < b32; w += MASK_BLOCK)
      part[(size_t)blockIdx.x * b32 + w] = sw[w];
  } else if (masks != nullptr) {
    for (int w = w0; w < w1; ++w) masks[(size_t)w * n_lanes + lane] = 0u;
  }
  if (!cluster_tri::last_slice(tickets, tile, per_tile)) return;

  // The tile's last block: the tile's words are the OR of the partials of
  // its blocks that hold a ray (the others' words are 0), read past L1.
  int n_sub = 0;
  while (n_sub < per_tile && lane_of(n_sub * L) < n_act) ++n_sub;
  const uint32_t* tp = part + (size_t)tile * per_tile * b32;
  for (int w = threadIdx.x; w < b32; w += MASK_BLOCK) {
    uint32_t acc = 0u;
    for (int s = 0; s < n_sub; ++s) acc |= __ldcg(tp + (size_t)s * b32 + w);
    sw[w] = acc;
    tile_words[(size_t)tile * b32 + w] = acc;
  }
  if (ids == nullptr) return;
  __syncthreads();
  // The list: cluster c goes to its rank among the set bits or, after all
  // of them, to its rank among the unset ones.  A pass of MASK_BLOCK
  // clusters covers MASK_BLOCK / 32 whole words, thread t's word being
  // the pass's t / 32-th.
  int n_set = 0;
  for (int w = 0; w < b32; ++w) n_set += __popc(sw[w]);
  if (threadIdx.x == 0) cnts[tile] = n_set;
  int* list = ids + (size_t)tile * n_cl;
  int before = 0;  // set bits of the earlier passes
  for (int base = 0; base < n_cl; base += MASK_BLOCK) {
    const int c = base + threadIdx.x;
    const int w0 = base / 32, w = c / 32;
    int set = before;
    for (int v = w0; v < w && v < b32; ++v) set += __popc(sw[v]);
    const uint32_t word = w < b32 ? sw[w] : 0u;
    set += __popc(word & ((1u << (c & 31)) - 1u));
    if (c < n_cl) list[(word >> (c & 31)) & 1u ? set : n_set + (c - set)] = c;
    for (int v = w0; v < w0 + MASK_BLOCK / 32 && v < b32; ++v)
      before += __popc(sw[v]);
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

// The mask pass and the shortlists: rays (n_planes, hp, wp), the cluster
// boxes aabb (n_cl, 8) and their word and group boxes levels
// (ceil(n_cl / 32), LEVEL_ROWS, 8) -> masks (ceil(n_cl / 32), hp, wp) u32
// (bit c % 32 of word c / 32: the lane's segment crosses cluster c's AABB;
// not written when masks is null) and the tiles' ORs tile_words (tiles,
// ceil(n_cl / 32)); with ids, per tile ids[tile * n_cl + j] (the crossed
// clusters ascending, then the others) and cnts[tile], their number.
// n_planes 7: the segment ends at lim * 1.000001 + 1e-5.  cnt (nullable):
// only the first *cnt lanes are rays (all of them when *cnt >= hp * wp),
// the others get 0 words.  part (hp wp / 32 * ceil(n_cl / 32) u32) and
// tickets (tiles i32, zero, left zero) are scratch.
extern "C" int coherent_mask(const float* aabb, const float* levels, int n_cl,
                             const float* rays, int n_planes, int hp, int wp,
                             float t_min, const int* cnt, uint32_t* masks,
                             uint32_t* tile_words, uint32_t* part,
                             int* tickets, int* ids, int* cnts,
                             void* stream) {
  const size_t smem = (size_t)(n_cl + 31) / 32 * sizeof(uint32_t);
  if (n_cl <= 0 || (n_planes != 6 && n_planes != 7) || bad_planes(hp, wp) ||
      smem > 48 * 1024 || tile_words == nullptr || part == nullptr ||
      tickets == nullptr || (ids == nullptr) != (cnts == nullptr))
    return (int)cudaErrorInvalidValue;
  // a slice of at least 4 words a thread, up to MAX_WORD_SLICES slices
  const int b32 = (n_cl + 31) / 32;
  int S = 1;
  while (S < MAX_WORD_SLICES && 8 * S <= b32) S *= 2;
  const int blocks = (int)((size_t)hp * wp / (MASK_BLOCK / S));
  const auto go = [&](auto kernel) {
    kernel<<<blocks, MASK_BLOCK, smem, (cudaStream_t)stream>>>(
        aabb, levels, n_cl, rays, n_planes == 7, hp, wp, t_min, cnt, masks,
        tile_words, part, tickets, ids, cnts);
  };
  static_assert(MAX_WORD_SLICES <= 8, "a kernel for each slice count");
  if (S == 1) go(mask_kernel<1>);
  if (S == 2) go(mask_kernel<2>);
  if (S == 4) go(mask_kernel<4>);
  if (S == 8) go(mask_kernel<8>);
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
