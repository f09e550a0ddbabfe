// fused_mesh.cu — the fused mesh Monte Carlo bounce step for Hopper
// (sm_90a): five launches per step over lanes kept in pixel order, with
// the mesh work compacted.
//
// Replaces the Pallas TPU kernels of cpu_based_ray_tracer_tpu/ops/
// fused_mesh.py launched by _run_steps / _mesh_pass:
//   k1_kernel          <- _k1_kernel (:226, body _k1_body :239)
//   sweep_kernel<false> <- _mesh_nearest_kernel (:915, _tri_loop_nearest)
//   k1b_kernel         <- _k1b_kernel (:1142)
//   sweep_kernel<true>  <- _mesh_occl_kernel (:943, _tri_loop_occl)
//   k2_kernel          <- _k2_kernel (:388)
//   group_*_kernel     the packed main and shadow rays sorted by the
//                       cluster boxes they cross, before each resident
//                       sweep (a Hopper addition: the TPU kernels sweep
//                       in pack order);
//   sweep_kernel<occl> with lists <- _mesh_sl_kernel (:984), the
//                       shortlist-streaming sweep: each 4,096-ray tile
//                       sweeps only the clusters its list names (the lists
//                       come from the mask pass of csrc/coherent.cu).
//
// What bounds them on this card, and what the design does about it:
//   - K1, K1b and K2 are one thread per lane over a few dozen unrolled
//     "small" primitives and predicate AABBs; a few hundred to a few
//     thousand f32 operations against ~40-100 bytes of lane planes read and
//     written, so near the balance of the FP32 pipes and HBM.  The tables
//     (smalls, spheres, materials, lights, sky, predicate AABBs, camera)
//     are copied into shared memory at block start; a warp reads the same
//     row at the same time, so each read is a broadcast.
//   - The sweep is arithmetic: packed rays x clusters x triangles x ~48
//     f32 operations of Moller-Trumbore (~65 instructions without FMA),
//     with no culling (as the TPU kernel) or, with lists, over the listed
//     clusters only.  The packed rays alone are too few blocks to fill
//     the card (the caps are an eighth or a sixteenth of the lanes), so
//     the list is split too: K blocks sweep K contiguous slices of a ray
//     block's list and combine their partial results in list order.  A
//     tile's list is the union of its 4,096 rays' cluster boxes (most of
//     the mesh on the 164k cell), while a ray crosses a few: each ray tests
//     each listed cluster's box, and a warp none of whose rays crosses it
//     skips the cluster (a block that none crosses does not stage it).
//     One thread per packed ray; each cluster's CS x 16 floats are
//     double-buffered in shared memory by cp.async copies that overlap the
//     previous cluster's tests, and read as broadcasts
//     (csrc/cluster_tri.cuh).  The occlusion sweep stops testing a ray once
//     it is occluded (an any-hit OR: the result is the same).
//   - The pack (K1, K1b) is stable inside a block and contiguous per
//     block: a warp ballot + popcount gives each lane its rank, a scan of
//     the 8 warp counts in shared memory the block's count, and one
//     atomicAdd per block its base; the (base, count) pair goes to the
//     offsets table.  Blocks land in any order, so the sweeps write their
//     results back by lane id, never by position.
//
// Numerics: built with -fmad=false and without --use_fast_math; every
// expression keeps the TPU kernels' operation order, as the plain PyTorch
// versions in ops/fused_mesh.py do.  The RNG, camera-ray, light-sample and
// shadow-test code is that of csrc/fused_mc.cu.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

#include "cluster_tri.cuh"

// Field for field the _CParams structure of ops/fused_mesh.py.  At file
// scope: the extern "C" entry points take it, and a type of an unnamed
// namespace would give them internal linkage.
struct Params {
  int R, n_pix, pixel_offset, width, height;
  int n_stri, n_sph, n_light, n_mat, n_pred, n_clusters, cs;
  int cap_main, cap_shadow, max_depth, stop_after;
  int off_ssph, off_mat, off_light, off_sky, off_pred, off_cam, n_words;
  uint32_t seed;
  float t_min, eps_offset, rr_survival, inv_rr, shadow_tol, aspect;
};

namespace {

using cluster_tri::crosses_box;   // the padded box cull (cluster_tri.cuh)
using cluster_tri::split_count;   // the slices of a ray block's list
using cluster_tri::SPLIT_MAX;
using cluster_tri::SWEEP_WAVES;

constexpr int NF = 16;            // floats per cluster triangle row (MESH_NF)
constexpr int PACK_BLOCK = 256;   // lanes per K1/K1b block (ops/fused_mesh.py)
constexpr int SWEEP_BLOCK = cluster_tri::RAY_BLOCK;  // rays per sweep block
constexpr int LIST_TILE = 4096;   // packed rays per shortlist tile
constexpr int LANE_BLOCK = 256;   // lanes per K2 block
constexpr int STRI_W = 16, SSPH_W = 8, MAT_W = 8, LGT_W = 16, AABB_W = 8;
constexpr float NO_HIT = FLT_MAX;
constexpr float DET_EPS = 1e-12f;
constexpr float TWO_PI = 6.28318530717958647692f;  // f32(2 pi)
constexpr float INV_PI = 0.31830988618379067154f;  // f32(1 / pi)
constexpr uint32_t N_STREAMS = 8, JITTER = 0, SCATTER = 2, LIGHT = 4;

__device__ __forceinline__ void pcg4d(uint32_t& a, uint32_t& b, uint32_t& c,
                                      uint32_t& d) {
  const uint32_t mul = 1664525u, inc = 1013904223u;
  a = a * mul + inc;
  b = b * mul + inc;
  c = c * mul + inc;
  d = d * mul + inc;
  a = a + b * d;
  b = b + c * a;
  c = c + a * b;
  d = d + b * c;
  a = a ^ (a >> 16);
  b = b ^ (b >> 16);
  c = c ^ (c >> 16);
  d = d ^ (d >> 16);
  a = a + b * d;
  b = b + c * a;
  c = c + a * b;
  d = d + b * c;
}

// Top 24 bits -> [0, 1); the integer fits a float exactly.
__device__ __forceinline__ float unit(uint32_t x) {
  return (float)(int)(x >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ void uniforms4(uint32_t seed, uint32_t pix,
                                          int sample, int bounce,
                                          uint32_t stream, float u[4]) {
  uint32_t a = pix, b = (uint32_t)sample;
  uint32_t c = (uint32_t)bounce * N_STREAMS + stream, d = seed;
  pcg4d(a, b, c, d);
  u[0] = unit(a);
  u[1] = unit(b);
  u[2] = unit(c);
  u[3] = unit(d);
}

__device__ __forceinline__ void norm3(float& x, float& y, float& z) {
  const float inv = rsqrtf(fmaxf(x * x + y * y + z * z, 1e-24f));
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

// 1 / v with |v| raised to at least 1e-20, keeping its sign.
__device__ __forceinline__ float sinv(float v) {
  const float tiny = v < 0.0f ? -1e-20f : 1e-20f;
  return 1.0f / (fabsf(v) < 1e-20f ? tiny : v);
}

// Does the segment [t_lo, hi_bound] of a ray (o, 1 / iv) cross the box A
// (min xyz, max xyz)?
__device__ __forceinline__ bool slab_crosses(const float* A, float ox,
                                             float oy, float oz, float ivx,
                                             float ivy, float ivz,
                                             float t_lo, float hi_bound) {
  const float tx0 = (A[0] - ox) * ivx, tx1 = (A[3] - ox) * ivx;
  const float ty0 = (A[1] - oy) * ivy, ty1 = (A[4] - oy) * ivy;
  const float tz0 = (A[2] - oz) * ivz, tz1 = (A[5] - oz) * ivz;
  const float t_in = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                           fminf(tz0, tz1));
  const float t_out = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                            fmaxf(tz0, tz1));
  return (t_out >= t_lo) && (t_in <= t_out) && (t_in <= hi_bound);
}

// The mesh predicate: does the segment [min(t_min, 0), t_hi * slack] of the
// ray (o, d) cross any of the n AABBs?  Conservative by the slack: a lane it
// misses would skip its mesh test.
__device__ bool crosses_any(const float* aabb, int n, float ox, float oy,
                            float oz, float dx, float dy, float dz,
                            float t_min, float t_hi) {
  const float ivx = sinv(dx), ivy = sinv(dy), ivz = sinv(dz);
  const float hi_bound = t_hi * 1.000001f + 1e-5f;
  const float t_lo = fminf(t_min, 0.0f);
  bool crossed = false;
  for (int b = 0; b < n; ++b)
    crossed = crossed || slab_crosses(aabb + b * AABB_W, ox, oy, oz, ivx,
                                      ivy, ivz, t_lo, hi_bound);
  return crossed;
}

// K1's mesh predicate, crosses_any by fewer tests.  `hull` is a box that
// holds the n boxes (their least minima and greatest maxima), tested first:
// a slab end (a - o) * iv is monotone in the box coordinate a, so each
// axis's interval of the hull holds that of every box, and a segment that
// crosses a box crosses the hull.  A lane that misses the hull misses every
// box; the others test the boxes in order and stop at the first crossed
// one (the predicate is their OR).  Either way the result is crosses_any's.
// (K1b keeps crosses_any: the exit alone measured slower.)
__device__ bool crosses_any_in_hull(const float* aabb, const float* hull,
                                    int n, float ox, float oy, float oz,
                                    float dx, float dy, float dz, float t_min,
                                    float t_hi) {
  const float ivx = sinv(dx), ivy = sinv(dy), ivz = sinv(dz);
  const float hi_bound = t_hi * 1.000001f + 1e-5f;
  const float t_lo = fminf(t_min, 0.0f);
  if (n <= 0 ||
      !slab_crosses(hull, ox, oy, oz, ivx, ivy, ivz, t_lo, hi_bound))
    return false;
  for (int b = 0; b < n; ++b)
    if (slab_crosses(aabb + b * AABB_W, ox, oy, oz, ivx, ivy, ivz, t_lo,
                     hi_bound))
      return true;
  return false;
}

// Stable block-level pack: the slot of a predicate lane (the block's base
// + the lane's rank in lane order), -1 for the others.  Every thread of
// the block calls it: it holds two barriers.  `wsm` is shared memory for
// PACK_BLOCK / 32 + 1 ints.  Row blockIdx.x of `offs` gets (base, count).
__device__ int block_pack(bool pred, int* wsm, int* cnt, int* offs) {
  const int warp = threadIdx.x >> 5, lid = threadIdx.x & 31;
  const unsigned ballot = __ballot_sync(0xffffffffu, pred);
  if (lid == 0) wsm[warp] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int w = 0; w < PACK_BLOCK / 32; ++w) {
      const int c = wsm[w];
      wsm[w] = run;
      run += c;
    }
    const int base = atomicAdd(cnt, run);
    wsm[PACK_BLOCK / 32] = base;
    offs[2 * blockIdx.x] = base;
    offs[2 * blockIdx.x + 1] = run;
  }
  __syncthreads();
  if (!pred) return -1;
  return wsm[PACK_BLOCK / 32] + wsm[warp] + __popc(ballot & ((1u << lid) - 1u));
}

__device__ __forceinline__ void load_tables(float* sm, const float* tables,
                                            int n_words) {
  for (int i = threadIdx.x; i < n_words; i += blockDim.x) sm[i] = tables[i];
  __syncthreads();
}

// --- K1: smalls intersect, mesh predicate, pack of the crossing rays -------

__global__ void __launch_bounds__(PACK_BLOCK)
k1_kernel(const Params p, const float* __restrict__ tables,
          const float* __restrict__ sf, float* __restrict__ hf,
          float* __restrict__ mr, int* __restrict__ mr_id,
          int* __restrict__ offs, int* __restrict__ cnt) {
  extern __shared__ float sm[];
  __shared__ int wsm[PACK_BLOCK / 32 + 1];
  __shared__ float hull[6];
  // the predicate boxes' hull: thread j < 6 reduces coordinate j
  if (threadIdx.x < 6 && p.n_pred > 0) {
    const int j = threadIdx.x;
    float h = tables[p.off_pred + j];
    for (int b = 1; b < p.n_pred; ++b) {
      const float a = tables[p.off_pred + b * AABB_W + j];
      h = j < 3 ? fminf(h, a) : fmaxf(h, a);
    }
    hull[j] = h;
  }
  load_tables(sm, tables, p.n_words);
  const float* stri = sm;
  const float* ssph = sm + p.off_ssph;
  const float* aabb = sm + p.off_pred;
  const int R = p.R;
  const int lane = blockIdx.x * PACK_BLOCK + threadIdx.x;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  bool pred = false;
  if (lane < R) {
    ox = sf[lane]; oy = sf[R + lane]; oz = sf[2 * R + lane];
    dx = sf[3 * R + lane]; dy = sf[4 * R + lane]; dz = sf[5 * R + lane];
    float best_t = NO_HIT, bnx = 0.f, bny = 0.f, bnz = 0.f, bmid = -1.f;
    for (int n = 0; n < p.n_stri; ++n) {
      const float* T = stri + n * STRI_W;
      const float v0x = T[0], v0y = T[1], v0z = T[2];
      const float e1x = T[3], e1y = T[4], e1z = T[5];
      const float e2x = T[6], e2y = T[7], e2z = T[8];
      const float s1x = dy * e2z - dz * e2y;
      const float s1y = dz * e2x - dx * e2z;
      const float s1z = dx * e2y - dy * e2x;
      const float det = s1x * e1x + s1y * e1y + s1z * e1z;
      const bool okd = fabsf(det) > DET_EPS;
      const float inv = 1.0f / (okd ? det : 1.0f);
      const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
      const float s2x = sy * e1z - sz * e1y;
      const float s2y = sz * e1x - sx * e1z;
      const float s2z = sx * e1y - sy * e1x;
      const float t = (s2x * e2x + s2y * e2y + s2z * e2z) * inv;
      const float b1 = (s1x * sx + s1y * sy + s1z * sz) * inv;
      const float b2 = (s2x * dx + s2y * dy + s2z * dz) * inv;
      if (okd && (t > p.t_min) && (b1 >= 0.0f) && (b2 >= 0.0f) &&
          (1.0f - b1 - b2 >= 0.0f) && (t < best_t)) {
        best_t = t;
        bnx = T[9]; bny = T[10]; bnz = T[11];
        bmid = T[12];
      }
    }
    for (int m = 0; m < p.n_sph; ++m) {
      const float* S = ssph + m * SSPH_W;
      const float cx = S[0], cy = S[1], cz = S[2], rad = S[3];
      const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
      const float a_q = dx * dx + dy * dy + dz * dz;
      const float hb = ocx * dx + ocy * dy + ocz * dz;
      const float c_q = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
      const float disc = hb * hb - a_q * c_q;
      const bool okq = disc > 0.0f;
      const float sq = sqrtf(okq ? disc : 1.0f);
      const float t_near = (-hb - sq) / a_q;
      const float t_far = (-hb + sq) / a_q;
      const bool near_ok = okq && (t_near > p.t_min);
      const bool far_ok = okq && (t_far > p.t_min);
      const float ts = near_ok ? t_near : (far_ok ? t_far : NO_HIT);
      if (ts < best_t) {
        const float inv_r = 1.0f / (rad == 0.0f ? 1.0f : rad);
        const float hpx = ox + ts * dx, hpy = oy + ts * dy, hpz = oz + ts * dz;
        best_t = ts;
        bnx = (hpx - cx) * inv_r;
        bny = (hpy - cy) * inv_r;
        bnz = (hpz - cz) * inv_r;
        bmid = S[4];
      }
    }
    hf[lane] = best_t;
    hf[R + lane] = bnx;
    hf[2 * R + lane] = bny;
    hf[3 * R + lane] = bnz;
    hf[4 * R + lane] = bmid;
    // the mesh winner's planes, "no hit" until the nearest sweep writes them
    hf[5 * R + lane] = NO_HIT;
    hf[6 * R + lane] = 0.0f;
    hf[7 * R + lane] = 0.0f;
    hf[8 * R + lane] = 0.0f;
    hf[9 * R + lane] = -1.0f;
    const bool valid = (uint32_t)(lane + p.pixel_offset) < (uint32_t)p.n_pix;
    pred = valid && crosses_any_in_hull(aabb, hull, p.n_pred, ox, oy, oz,
                                        dx, dy, dz, p.t_min, best_t);
  }
  const int slot = block_pack(pred, wsm, cnt, offs);
  if (slot >= 0 && slot < p.cap_main) {
    const int cap = p.cap_main;
    mr[slot] = ox;
    mr[cap + slot] = oy;
    mr[2 * cap + slot] = oz;
    mr[3 * cap + slot] = dx;
    mr[4 * cap + slot] = dy;
    mr[5 * cap + slot] = dz;
    mr_id[slot] = lane;
  }
}

// --- the cluster sweep: nearest hit or any-hit occlusion of packed rays ----
//
// Without lists (ids == nullptr) every ray block sweeps every cluster.  With
// lists (the shortlist-streaming mode) it sweeps only the clusters that its
// 4,096-ray tile's list names: ids[tile * n_clusters + j] for j < cnts[tile],
// in list order; the triangle loops are the same.
//
// The list is split into K contiguous slices, each swept by its own block
// of the same 256 rays (grid: ray blocks x k_max; block (rb, k) takes slice
// k of K, and blocks with k >= K leave at once).  K comes from the packed
// count on the device: enough blocks to fill `target` block slots (the
// resident blocks of the card times SWEEP_WAVES), at most k_max.
// With K = 1 the block writes its result itself.  Otherwise each slice
// writes a partial result per ray to `part`, and the combine takes them in
// slice order:
//   - nearest: (t, row of tri) of the slice's winner; the combine keeps a
//     later slice only when strictly nearer, which is the serial sweep's
//     rule (the first row at the least t wins: t does not depend on the
//     running best), so t, normal and material id are the serial sweep's;
//   - occlusion: one flag per ray that every slice sets when it finds an
//     occluder (zero at launch); a slice stops testing a ray at its own
//     first accepted row or once another slice has set the flag, and the
//     combine reads the flag: the OR of the slices, whichever finish
//     first.
// The combine runs in the last block of the ray block to finish (a ticket
// per ray block, taken after a __threadfence); a second launch for it
// measured no faster.  Inside a block the clusters are
// double-buffered in shared memory: the next cluster's cp.async copies are
// in flight while cluster j is tested.  Only clusters whose box (padded,
// see crosses_box) a ray of the block crosses are staged, and a warp tests
// a staged cluster only when one of its rays crosses the box: each listed
// cluster costs a box test and a barrier, a crossed one its triangles.
// The occlusion sweep leaves the list once every ray of the block is
// occluded (the barrier's OR of the rays still open).

// The nearest result of row `slot` of tri (-1: no hit) into out at `lane`.
__device__ __forceinline__ void write_nearest(const float* __restrict__ tri,
                                              float* __restrict__ out, int R,
                                              int lane, float best_t,
                                              int slot) {
  float bnx = 0.f, bny = 0.f, bnz = 0.f, bmid = -1.f;
  if (slot >= 0) {
    const float* T = tri + (size_t)slot * NF;
    bnx = T[9]; bny = T[10]; bnz = T[11];
    bmid = T[12];
  }
  out[lane] = best_t;
  out[R + lane] = bnx;
  out[2 * R + lane] = bny;
  out[3 * R + lane] = bnz;
  out[4 * R + lane] = bmid;
}

// Packed ray i's K partial results, in slice order, into its lane's output.
// Partials come from other blocks: read past L1 (__ldcg).
template <bool OCCL>
__device__ __forceinline__ void combine_ray(const Params& p,
                                            const float* __restrict__ tri,
                                            const int* __restrict__ ray_id,
                                            int cap, int K, const int* part,
                                            float* __restrict__ out, int i) {
  const int lane = ray_id[i];
  if (OCCL) {
    out[lane] = __ldcg(part + i) ? 1.0f : 0.0f;
    return;
  }
  float best_t = NO_HIT;
  int slot = -1;
  for (int k = 0; k < K; ++k) {
    const float t = __int_as_float(__ldcg(part + (size_t)(2 * k) * cap + i));
    if (t < best_t) {
      best_t = t;
      slot = __ldcg(part + (size_t)(2 * k + 1) * cap + i);
    }
  }
  write_nearest(tri, out, p.R, lane, best_t, slot);
}

template <bool OCCL>
__global__ void __launch_bounds__(SWEEP_BLOCK)
sweep_kernel(const Params p, const float* __restrict__ tri,
             const float* __restrict__ aabb,
             const float* __restrict__ rays, const int* __restrict__ ray_id,
             int cap, const int* __restrict__ cnt,
             const int* __restrict__ ids, const int* __restrict__ cnts,
             int target, int k_max, int* part, int* __restrict__ tickets,
             float* __restrict__ out) {
  extern __shared__ float4 tile4[];
  const int n = min(*cnt, cap);
  const int rb = blockIdx.x / k_max, k = blockIdx.x - rb * k_max;
  const int i0 = rb * SWEEP_BLOCK;
  const int K = split_count(n, target, k_max);
  // A block past the packed rays or past the K slices leaves at once; in a
  // live block every thread joins every copy and barrier below.
  if (i0 >= n || k >= K) return;
  const int i = i0 + threadIdx.x;
  const bool live = i < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float lim = 0.f;
  if (live) {
    ox = rays[i]; oy = rays[cap + i]; oz = rays[2 * cap + i];
    dx = rays[3 * cap + i]; dy = rays[4 * cap + i]; dz = rays[5 * cap + i];
    if (OCCL) lim = rays[6 * cap + i];
  }
  const int tile_i = i0 / LIST_TILE;
  const int* list = ids ? ids + (size_t)tile_i * p.n_clusters : nullptr;
  const int n_list = ids ? cnts[tile_i] : p.n_clusters;
  const int j0 = (int)((long long)n_list * k / K);
  const int j1 = (int)((long long)n_list * (k + 1) / K);
  float best_t = NO_HIT;
  int slot = -1;
  bool occ = false;
  // The ray's slab-test terms: the unbounded line (nearest) or the segment
  // up to lim (occlusion), with the mask pass's slack (csrc/coherent.cu).
  const float ivx = sinv(dx), ivy = sinv(dy), ivz = sinv(dz);
  const float o_mag = fmaxf(fmaxf(fabsf(ox), fabsf(oy)), fabsf(oz));
  const float t_lo = fminf(p.t_min, 0.0f);
  const float hi_bound = OCCL ? lim * 1.000001f + 1e-5f : 0.0f;
  const int words4 = p.cs * NF / 4;
  auto cluster = [&](int q) { return list ? list[q] : q; };
  cluster_tri::walk_slice<OCCL>(
      tile4, tri, words4, j0, j1,
      [&] {
        // another slice found this ray's occluder
        if (K > 1 && live && !occ && __ldcg(part + i)) occ = true;
        return live && !occ;
      },
      [&](int q) {
        return live && !(OCCL && occ) &&
               crosses_box(aabb + (size_t)cluster(q) * AABB_W, ox, oy, oz,
                           o_mag, ivx, ivy, ivz, t_lo, hi_bound, OCCL);
      },
      cluster,
      [&](int j, const float* tile, bool mine) {
        // A warp none of whose rays crosses the cluster's box skips it;
        // the box test is conservative, as the lists' own (every ray that
        // hits a triangle crosses its cluster's box), so the results stay
        // the unculled sweep's.
        if (!__any_sync(0xffffffffu, mine) || !live || (OCCL && occ)) return;
        if (OCCL) {
          occ = cluster_tri::occluded_rows(tile, p.cs, ox, oy, oz, dx, dy,
                                           dz, lim, p.t_min);
          if (occ && K > 1) __stcg(part + i, 1);
        } else {
          const int kk = cluster_tri::nearest_rows(tile, p.cs, ox, oy, oz,
                                                   dx, dy, dz, p.t_min,
                                                   best_t);
          if (kk >= 0) slot = cluster(j) * p.cs + kk;
        }
      });
  if (K == 1) {
    if (!live) return;
    if (OCCL)
      out[ray_id[i]] = occ ? 1.0f : 0.0f;
    else
      write_nearest(tri, out, p.R, ray_id[i], best_t, slot);
    return;
  }
  if (live && !OCCL) {
    part[(size_t)(2 * k) * cap + i] = __float_as_int(best_t);
    part[(size_t)(2 * k + 1) * cap + i] = slot;
  }
  if (cluster_tri::last_slice(tickets, rb, K) && live)
    combine_ray<OCCL>(p, tri, ray_id, cap, K, part, out, i);
}

// --- grouping the packed rays by the cluster boxes they cross -------------
//
// Before each resident sweep, the packed rays are sorted by a key of the
// boxes each crosses (bit c % GROUP_BITS for cluster c, the sweep's own
// padded crosses_box: over the unbounded line for the main rays, over the
// segment up to lim for the shadow rays), so that the 32 rays of a warp
// cross the same few boxes and the sweep's per-warp cull skips the rest.
// A counting sort on the device: group_key_kernel computes the keys and
// their histogram (per block in shared memory, then added to the global
// one), group_scan_kernel turns the histogram into each key's first
// position, group_scatter_kernel moves the (6, cap) main or (7, cap)
// shadow rays and their lane ids there (one atomicAdd per key per warp,
// __match_any_sync).  The order inside a key is the atomics', so it varies
// from run to run: the sweeps write by lane id, and a ray's tests do not
// depend on the warp that runs them (an occluded ray stops at its own
// first occluder, in cluster order), so every order gives the same
// results.

constexpr int GROUP_BITS = 12;
constexpr int GROUP_KEYS = 1 << GROUP_BITS;

// The keys a table of n_clusters clusters can give (fewer clusters than
// GROUP_BITS: a smaller histogram).
__host__ __device__ __forceinline__ int group_keys(int n_clusters) {
  return 1 << (n_clusters < GROUP_BITS ? n_clusters : GROUP_BITS);
}
constexpr int GROUP_BLOCK = 256;
constexpr int SCAN_THREADS = 1024;

template <bool OCCL>
__global__ void __launch_bounds__(GROUP_BLOCK)
group_key_kernel(const Params p, const float* __restrict__ aabb,
                 const float* __restrict__ rays, int cap,
                 const int* __restrict__ cnt, int* __restrict__ keys,
                 int* __restrict__ hist) {
  __shared__ int h[GROUP_KEYS];
  const int n = min(*cnt, cap);
  if ((int)blockIdx.x * GROUP_BLOCK >= n) return;
  const int n_keys = group_keys(p.n_clusters);
  for (int k = threadIdx.x; k < n_keys; k += GROUP_BLOCK) h[k] = 0;
  __syncthreads();
  const int i = blockIdx.x * GROUP_BLOCK + threadIdx.x;
  if (i < n) {
    const float ox = rays[i], oy = rays[cap + i], oz = rays[2 * cap + i];
    const float ivx = sinv(rays[3 * cap + i]), ivy = sinv(rays[4 * cap + i]);
    const float ivz = sinv(rays[5 * cap + i]);
    const float o_mag = fmaxf(fmaxf(fabsf(ox), fabsf(oy)), fabsf(oz));
    const float t_lo = fminf(p.t_min, 0.0f);
    // the sweep's own terms (sweep_kernel)
    const float hi_bound =
        OCCL ? rays[6 * cap + i] * 1.000001f + 1e-5f : 0.0f;
    int key = 0;
    for (int c = 0; c < p.n_clusters; ++c)
      if (crosses_box(aabb + (size_t)c * AABB_W, ox, oy, oz, o_mag, ivx, ivy,
                      ivz, t_lo, hi_bound, OCCL))
        key |= 1 << (c % GROUP_BITS);
    keys[i] = key;
    atomicAdd(h + key, 1);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n_keys; k += GROUP_BLOCK)
    if (h[k]) atomicAdd(hist + k, h[k]);
}

// hist[k] <- the sum of hist[j] for j < k, in place, for k < n_keys (one
// block).
__global__ void __launch_bounds__(SCAN_THREADS)
group_scan_kernel(int* __restrict__ hist, int n_keys) {
  constexpr int PER = GROUP_KEYS / SCAN_THREADS;
  __shared__ int warp_sum[SCAN_THREADS / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int v[PER], own = 0;
  for (int k = 0; k < PER; ++k) {
    v[k] = t * PER + k < n_keys ? hist[t * PER + k] : 0;
    own += v[k];
  }
  int x = own;   // inclusive scan of the threads' sums in the warp
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sum[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    warp_sum[lane] = w;
  }
  __syncthreads();
  int excl = x - own + (warp > 0 ? warp_sum[warp - 1] : 0);
  for (int k = 0; k < PER; ++k) {
    if (t * PER + k < n_keys) hist[t * PER + k] = excl;
    excl += v[k];
  }
}

__global__ void __launch_bounds__(GROUP_BLOCK)
group_scatter_kernel(const float* __restrict__ rays, int n_planes,
                     const int* __restrict__ ray_id, int cap,
                     const int* __restrict__ cnt,
                     const int* __restrict__ keys, int* __restrict__ cursor,
                     float* __restrict__ g_rays, int* __restrict__ g_id) {
  const int n = min(*cnt, cap);
  const int i = blockIdx.x * GROUP_BLOCK + threadIdx.x;
  if (i >= n) return;
  const int key = keys[i];
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(__activemask(), key);
  const int leader = __ffs(peers) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(cursor + key, __popc(peers));
  base = __shfl_sync(peers, base, leader);
  const int pos = base + __popc(peers & ((1u << lane) - 1u));
  for (int k = 0; k < n_planes; ++k)
    g_rays[(size_t)k * cap + pos] = rays[(size_t)k * cap + i];
  g_id[pos] = ray_id[i];
}

// --- K1b: merge, shading point, NEE sample, shadow predicate, pack ---------

__global__ void __launch_bounds__(PACK_BLOCK)
k1b_kernel(const Params p, const float* __restrict__ tables,
           const float* __restrict__ sf, const int* __restrict__ si,
           const float* __restrict__ hf, float* __restrict__ kb,
           float* __restrict__ sr, int* __restrict__ sr_id,
           int* __restrict__ offs, int* __restrict__ cnt) {
  extern __shared__ float sm[];
  __shared__ int wsm[PACK_BLOCK / 32 + 1];
  load_tables(sm, tables, p.n_words);
  const float* mat = sm + p.off_mat;
  const float* lgt = sm + p.off_light;
  const float* sky = sm + p.off_sky;
  const float* aabb = sm + p.off_pred;
  const int R = p.R;
  const int lane = blockIdx.x * PACK_BLOCK + threadIdx.x;
  float px = 0.f, py = 0.f, pz = 0.f, wlx = 0.f, wly = 0.f, wlz = 0.f;
  float lim = 0.f;
  bool pred = false;
  if (lane < R) {
    const float ox = sf[lane], oy = sf[R + lane], oz = sf[2 * R + lane];
    const float dx = sf[3 * R + lane], dy = sf[4 * R + lane];
    const float dz = sf[5 * R + lane];
    const int s = si[lane], bb = si[R + lane];
    const float ts = hf[lane], tm = hf[5 * R + lane];
    // the smalls win ties, as ops/intersect does
    const bool is_mesh = tm < ts;
    const int j = is_mesh ? 5 : 0;
    const float t = is_mesh ? tm : ts;
    float nx = hf[(j + 1) * R + lane], ny = hf[(j + 2) * R + lane];
    float nz = hf[(j + 3) * R + lane];
    const float mid = hf[(j + 4) * R + lane];
    norm3(nx, ny, nz);
    if (!((nx * dx + ny * dy + nz * dz) < 0.0f)) {
      nx = -nx;
      ny = -ny;
      nz = -nz;
    }
    const bool hit = t < NO_HIT;
    const float t_pt = hit ? t : 1.0f;
    px = ox + t_pt * dx + nx * p.eps_offset;
    py = oy + t_pt * dy + ny * p.eps_offset;
    pz = oz + t_pt * dz + nz * p.eps_offset;

    float ef = 0.0f;
    for (int k = 0; k < p.n_mat; ++k)
      if (mid == (float)k) ef = mat[k * MAT_W + 6];
    const uint32_t pix = (uint32_t)(lane + p.pixel_offset);
    const bool valid = pix < (uint32_t)p.n_pix;
    bool alive_sh = valid && hit && (ef < 0.5f) && (mid >= 0.0f);

    // NEE light sample, the streams and operations of K2's
    const float light_total = sky[6];
    float ul[4];
    uniforms4(p.seed, pix, s, bb, LIGHT, ul);
    const float budget = ul[0] * light_total;
    int le = 0;
    for (int e = 1; e < p.n_light; ++e)
      if (lgt[(e - 1) * LGT_W + 15] <= budget) le = e;
    const float* L = lgt + le * LGT_W;
    const float xw = 1.0f - sqrtf(ul[1]);
    const float w1 = (1.0f - xw) * ul[2];
    const float w2 = (1.0f - xw) * (1.0f - ul[2]);
    const float lpx = L[0] + w1 * L[3] + w2 * L[6];
    const float lpy = L[1] + w1 * L[4] + w2 * L[7];
    const float lpz = L[2] + w1 * L[5] + w2 * L[8];
    const float tlx = lpx - px, tly = lpy - py, tlz = lpz - pz;
    const float dist = sqrtf(fmaxf(tlx * tlx + tly * tly + tlz * tlz, 0.0f));
    const float invd = 1.0f / fmaxf(dist, 1e-20f);
    wlx = tlx * invd;
    wly = tly * invd;
    wlz = tlz * invd;
    lim = dist - p.shadow_tol;
    // zero-weight pruning: K2 scales NEE by (cos_s >= 0)
    const float cos_s = wlx * nx + wly * ny + wlz * nz;
    alive_sh = alive_sh && (cos_s > 0.0f) && (light_total > 0.0f);
    pred = alive_sh && crosses_any(aabb, p.n_pred, px, py, pz, wlx, wly, wlz,
                                   p.t_min, lim);
    kb[lane] = t;
    kb[R + lane] = nx;
    kb[2 * R + lane] = ny;
    kb[3 * R + lane] = nz;
    kb[4 * R + lane] = mid;
    kb[5 * R + lane] = px;
    kb[6 * R + lane] = py;
    kb[7 * R + lane] = pz;
    kb[8 * R + lane] = 0.0f;  // the mesh-occlusion flag, for the sweep
  }
  const int slot = block_pack(pred, wsm, cnt, offs);
  if (slot >= 0 && slot < p.cap_shadow) {
    const int cap = p.cap_shadow;
    sr[slot] = px;
    sr[cap + slot] = py;
    sr[2 * cap + slot] = pz;
    sr[3 * cap + slot] = wlx;
    sr[4 * cap + slot] = wly;
    sr[5 * cap + slot] = wlz;
    sr[6 * cap + slot] = lim;
    sr_id[slot] = lane;
  }
}

// --- K2: shading, NEE, RR, scatter, regeneration ----------------------------

__global__ void __launch_bounds__(LANE_BLOCK)
k2_kernel(const Params p, const float* __restrict__ tables,
          const float* __restrict__ kb, float* __restrict__ sf,
          int* __restrict__ si) {
  extern __shared__ float sm[];
  load_tables(sm, tables, p.n_words);
  const int lane = blockIdx.x * LANE_BLOCK + threadIdx.x;
  if (lane >= p.R) return;
  const int R = p.R;
  const float* stri = sm;
  const float* ssph = sm + p.off_ssph;
  const float* mat = sm + p.off_mat;
  const float* lgt = sm + p.off_light;
  const float* sky = sm + p.off_sky;
  const float* cam = sm + p.off_cam;

  const float light_total = sky[6];
  const bool light_valid = light_total > 0.0f;
  const float light_pdf =
      light_valid ? 1.0f / fmaxf(light_total, 1e-20f) : 0.0f;
  const bool gated = p.stop_after > 0;
  const uint32_t pix = (uint32_t)(lane + p.pixel_offset);
  const bool valid = pix < (uint32_t)p.n_pix;

  const float t_hit = kb[lane];
  const float nxp = kb[R + lane], nyp = kb[2 * R + lane];
  const float nzp = kb[3 * R + lane], midp = kb[4 * R + lane];
  const float hx = kb[5 * R + lane], hy = kb[6 * R + lane];
  const float hz = kb[7 * R + lane];
  const bool occ_mesh = kb[8 * R + lane] > 0.5f;
  int s = si[lane], bb = si[R + lane], nd = si[2 * R + lane];
  float dx = sf[3 * R + lane], dy = sf[4 * R + lane], dz = sf[5 * R + lane];
  float tpx = sf[6 * R + lane], tpy = sf[7 * R + lane], tpz = sf[8 * R + lane];
  float cux = sf[9 * R + lane], cuy = sf[10 * R + lane];
  float cuz = sf[11 * R + lane];
  float axp = sf[12 * R + lane], ayp = sf[13 * R + lane];
  float azp = sf[14 * R + lane];

  // material by id
  float al0 = 0.f, al1 = 0.f, al2 = 0.f, em0 = 0.f, em1 = 0.f, em2 = 0.f;
  float bef = 0.f;
  for (int k = 0; k < p.n_mat; ++k) {
    if (midp == (float)k) {
      const float* M = mat + k * MAT_W;
      al0 = M[0]; al1 = M[1]; al2 = M[2];
      em0 = M[3]; em1 = M[4]; em2 = M[5];
      bef = M[6];
    }
  }
  const bool hit = t_hit < NO_HIT;
  const bool hit_emissive = hit && (bef > 0.5f);
  const bool is_primary = bb == 0;
  const bool armed = nd < p.stop_after;
  const bool alive0 = gated ? (valid && armed) : valid;

  // Primary miss -> sky; primary emissive hit -> emission.
  float dux = dx, duy = dy, duz = dz;
  norm3(dux, duy, duz);
  const float skyw = 0.5f * (duy + 1.0f);
  const bool add_sky = alive0 && !hit && is_primary;
  const bool add_emi = alive0 && hit_emissive && is_primary;
  const float drx = (add_sky ? ((1.0f - skyw) * sky[0] + skyw * sky[3]) : 0.0f)
                    + (add_emi ? em0 : 0.0f);
  const float dry = (add_sky ? ((1.0f - skyw) * sky[1] + skyw * sky[4]) : 0.0f)
                    + (add_emi ? em1 : 0.0f);
  const float drz = (add_sky ? ((1.0f - skyw) * sky[2] + skyw * sky[5]) : 0.0f)
                    + (add_emi ? em2 : 0.0f);
  cux = cux + tpx * drx;
  cuy = cuy + tpy * dry;
  cuz = cuz + tpz * drz;

  const bool alive = alive0 && hit && !hit_emissive;

  // --- NEE: K1b's light sample; the smalls shadow test OR the mesh flag ----
  float ul[4];
  uniforms4(p.seed, pix, s, bb, LIGHT, ul);
  const float budget = ul[0] * light_total;
  int le = 0;
  for (int e = 1; e < p.n_light; ++e)
    if (lgt[(e - 1) * LGT_W + 15] <= budget) le = e;
  const float* L = lgt + le * LGT_W;
  const float xw = 1.0f - sqrtf(ul[1]);
  const float w1 = (1.0f - xw) * ul[2];
  const float w2 = (1.0f - xw) * (1.0f - ul[2]);
  const float lpx = L[0] + w1 * L[3] + w2 * L[6];
  const float lpy = L[1] + w1 * L[4] + w2 * L[7];
  const float lpz = L[2] + w1 * L[5] + w2 * L[8];
  const float tlx = lpx - hx, tly = lpy - hy, tlz = lpz - hz;
  const float dist = sqrtf(fmaxf(tlx * tlx + tly * tly + tlz * tlz, 0.0f));
  const float invd = 1.0f / fmaxf(dist, 1e-20f);
  const float wlx = tlx * invd, wly = tly * invd, wlz = tlz * invd;
  const bool flip_l = (L[9] * -wlx + L[10] * -wly + L[11] * -wlz) < 0.0f;
  const float lnx2 = flip_l ? -L[9] : L[9];
  const float lny2 = flip_l ? -L[10] : L[10];
  const float lnz2 = flip_l ? -L[11] : L[11];

  bool occluded = occ_mesh;
  const float lim = dist - p.shadow_tol;
  for (int n = 0; n < p.n_stri; ++n) {
    const float* T = stri + n * STRI_W;
    const float v0x = T[0], v0y = T[1], v0z = T[2];
    const float e1x = T[3], e1y = T[4], e1z = T[5];
    const float e2x = T[6], e2y = T[7], e2z = T[8];
    const float s1x = wly * e2z - wlz * e2y;
    const float s1y = wlz * e2x - wlx * e2z;
    const float s1z = wlx * e2y - wly * e2x;
    const float det = s1x * e1x + s1y * e1y + s1z * e1z;
    const bool okd = fabsf(det) > DET_EPS;
    const float sd = det >= 0.0f ? 1.0f : -1.0f;
    const float adet = det * sd;
    const float sx = hx - v0x, sy = hy - v0y, sz = hz - v0z;
    const float s2x = sy * e1z - sz * e1y;
    const float s2y = sz * e1x - sx * e1z;
    const float s2z = sx * e1y - sy * e1x;
    const float tn = s2x * e2x + s2y * e2y + s2z * e2z;
    const float b1n = s1x * sx + s1y * sy + s1z * sz;
    const float b2n = s2x * wlx + s2y * wly + s2z * wlz;
    const float tsd = tn * sd;
    occluded = occluded ||
               (okd && (tsd > p.t_min * adet) && (tsd <= lim * adet) &&
                (b1n * sd >= 0.0f) && (b2n * sd >= 0.0f) &&
                ((det - b1n - b2n) * sd >= 0.0f));
  }
  for (int m = 0; m < p.n_sph; ++m) {
    const float* S = ssph + m * SSPH_W;
    const float cx = S[0], cy = S[1], cz = S[2], rad = S[3];
    const float ocx = hx - cx, ocy = hy - cy, ocz = hz - cz;
    const float a_q = wlx * wlx + wly * wly + wlz * wlz;
    const float hb = ocx * wlx + ocy * wly + ocz * wlz;
    const float c_q = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
    const float disc = hb * hb - a_q * c_q;
    const bool okq = disc > 0.0f;
    const float sq = sqrtf(okq ? disc : 1.0f);
    const float t_near = (-hb - sq) / a_q;
    const float t_far = (-hb + sq) / a_q;
    const float ts = (okq && (t_near > p.t_min))
                         ? t_near
                         : ((okq && (t_far > p.t_min)) ? t_far : NO_HIT);
    occluded = occluded || (ts <= lim);
  }
  const float vis = occluded ? 0.0f : 1.0f;

  const float cos_s = wlx * nxp + wly * nyp + wlz * nzp;
  const float cos_l = -(wlx * lnx2 + wly * lny2 + wlz * lnz2);
  const float geom = cos_s * cos_l / fmaxf(dist * dist, 1e-20f);
  const float brdf_ok = (cos_s >= 0.0f ? 1.0f : 0.0f) * INV_PI;
  const float scale = (geom / fmaxf(light_pdf, 1e-20f)) * vis * brdf_ok;
  if (alive && light_valid) {
    cux = cux + tpx * (L[12] * al0 * scale);
    cuy = cuy + tpy * (L[13] * al1 * scale);
    cuz = cuz + tpz * (L[14] * al2 * scale);
  }

  // --- indirect: RR + uniform hemisphere -----------------------------------
  float us[4];
  uniforms4(p.seed, pix, s, bb, SCATTER, us);
  const bool survive = us[2] < p.rr_survival;
  const bool use_x = fabsf(nxp) > fabsf(nyp);
  float yx = use_x ? nzp : 0.0f;
  float yy = use_x ? 0.0f : nzp;
  float yz = use_x ? -nxp : -nyp;
  norm3(yx, yy, yz);
  const float xx = yy * nzp - yz * nyp;
  const float xy = yz * nxp - yx * nzp;
  const float xz = yx * nyp - yy * nxp;
  const float z = us[0];
  const float r_xy = sqrtf(fmaxf(0.0f, 1.0f - z * z));
  const float phi = TWO_PI * us[1];
  const float cp = cosf(phi), sp = sinf(phi);
  const float wix = r_xy * cp * xx + r_xy * sp * yx + z * nxp;
  const float wiy = r_xy * cp * xy + r_xy * sp * yy + z * nyp;
  const float wiz = r_xy * cp * xz + r_xy * sp * yz + z * nzp;
  const float cos_i = wix * nxp + wiy * nyp + wiz * nzp;
  const float w_ok = (cos_i >= 0.0f ? 1.0f : 0.0f) * INV_PI;
  const float wt = cos_i * TWO_PI * p.inv_rr * w_ok;
  const bool continues = alive && survive;
  if (continues) {
    tpx = tpx * (al0 * wt);
    tpy = tpy * (al1 * wt);
    tpz = tpz * (al2 * wt);
  }

  // --- persistent-wavefront bookkeeping ------------------------------------
  const bool cont = continues && (bb + 1 < p.max_depth);
  const bool done = gated ? (!cont && armed) : !cont;
  if (done) {
    axp = axp + cux;
    ayp = ayp + cuy;
    azp = azp + cuz;
    nd += 1;
    s += 1;
    cux = 0.0f;
    cuy = 0.0f;
    cuz = 0.0f;
  }
  float ox, oy, oz;
  if (cont) {
    ox = hx; oy = hy; oz = hz;
    dx = wix; dy = wiy; dz = wiz;
    bb += 1;
  } else {
    // the camera ray of the lane's next sample (s already advanced)
    float uj[4];
    uniforms4(p.seed, pix, s, 0, JITTER, uj);
    const float pxf = (float)(pix % (uint32_t)p.width);
    const float pyf = (float)(pix / (uint32_t)p.width);
    const float ndc_x = (pxf + uj[0]) / (float)p.width * 2.0f - 1.0f;
    const float ndc_y = -((pyf + uj[1]) / (float)p.height * 2.0f - 1.0f);
    const float tan_half = cam[12];
    const float ta = tan_half * p.aspect;
    const float a = ndc_x * ta;
    const float b = ndc_y * tan_half;
    dx = a * cam[3] + b * cam[6] + cam[9];
    dy = a * cam[4] + b * cam[7] + cam[10];
    dz = a * cam[5] + b * cam[8] + cam[11];
    norm3(dx, dy, dz);
    ox = cam[0]; oy = cam[1]; oz = cam[2];
    tpx = 1.0f; tpy = 1.0f; tpz = 1.0f;
    bb = 0;
  }

  si[lane] = s;
  si[R + lane] = bb;
  si[2 * R + lane] = nd;
  si[3 * R + lane] += alive ? 1 : 0;
  sf[0 * R + lane] = ox;  sf[1 * R + lane] = oy;  sf[2 * R + lane] = oz;
  sf[3 * R + lane] = dx;  sf[4 * R + lane] = dy;  sf[5 * R + lane] = dz;
  sf[6 * R + lane] = tpx; sf[7 * R + lane] = tpy; sf[8 * R + lane] = tpz;
  sf[9 * R + lane] = cux; sf[10 * R + lane] = cuy; sf[11 * R + lane] = cuz;
  sf[12 * R + lane] = axp; sf[13 * R + lane] = ayp; sf[14 * R + lane] = azp;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

size_t sweep_smem(int cs) { return 2 * (size_t)cs * NF * sizeof(float); }

// Resident blocks of the sweep on this device: (blocks per SM, SMs), asked
// of the runtime once per device and cluster size.
template <bool OCCL>
cudaError_t sweep_slots(int cs, int* per_sm, int* n_sm) {
  static int seen_dev = -1, seen_cs = -1, seen_per_sm = 0, seen_n_sm = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev != seen_dev || cs != seen_cs) {
    e = cudaDeviceGetAttribute(&seen_n_sm, cudaDevAttrMultiProcessorCount,
                               dev);
    if (e == cudaSuccess) e = allow_smem(sweep_kernel<OCCL>, sweep_smem(cs));
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &seen_per_sm, sweep_kernel<OCCL>, SWEEP_BLOCK, sweep_smem(cs));
    if (e != cudaSuccess) return e;
    seen_dev = dev;
    seen_cs = cs;
  }
  *per_sm = seen_per_sm;
  *n_sm = seen_n_sm;
  return cudaSuccess;
}

template <bool OCCL>
int sweep(const Params* p, const float* tri, const float* aabb,
          const float* rays, const int* ray_id, int cap, const int* cnt,
          const int* ids, const int* cnts, int k_max, int* part,
          int* tickets, float* out, void* stream) {
  if (cap <= 0 || p->cs <= 0 || p->cs * NF % 4 != 0 || k_max < 1 ||
      k_max > SPLIT_MAX ||
      (k_max > 1 && (part == nullptr || tickets == nullptr)) ||
      (ids != nullptr && cap % LIST_TILE != 0))
    return (int)cudaErrorInvalidValue;
  int per_sm = 0, n_sm = 0;
  const cudaError_t e = sweep_slots<OCCL>(p->cs, &per_sm, &n_sm);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int target = per_sm * n_sm * SWEEP_WAVES;
  const int ray_blocks = (cap + SWEEP_BLOCK - 1) / SWEEP_BLOCK;
  sweep_kernel<OCCL><<<ray_blocks * k_max, SWEEP_BLOCK, sweep_smem(p->cs),
                       (cudaStream_t)stream>>>(*p, tri, aabb, rays, ray_id,
                                               cap, cnt, ids, cnts, target,
                                               k_max, part, tickets, out);
  return (int)cudaGetLastError();
}

int group(const Params* p, bool occl, const float* aabb, const float* rays,
          const int* ray_id, int cap, const int* cnt, int* keys, int* hist,
          float* g_rays, int* g_id, cudaStream_t stream) {
  if (cap <= 0 || p->n_clusters <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (cap + GROUP_BLOCK - 1) / GROUP_BLOCK;
  if (occl)
    group_key_kernel<true><<<blocks, GROUP_BLOCK, 0, stream>>>(
        *p, aabb, rays, cap, cnt, keys, hist);
  else
    group_key_kernel<false><<<blocks, GROUP_BLOCK, 0, stream>>>(
        *p, aabb, rays, cap, cnt, keys, hist);
  group_scan_kernel<<<1, SCAN_THREADS, 0, stream>>>(
      hist, group_keys(p->n_clusters));
  group_scatter_kernel<<<blocks, GROUP_BLOCK, 0, stream>>>(
      rays, occl ? 7 : 6, ray_id, cap, cnt, keys, hist, g_rays, g_id);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point launches one kernel on `stream` and returns
// cudaGetLastError().  Planes are row-major (rows, R) or (rows, cap);
// `tables` is stri | ssph | mat | light | sky | pred_aabb | cam16 at the
// offsets in `p`; `cnt` is this step's packed population (added to by the
// packers, read by the sweeps).

// K1: reads sf (15, R) rows 0-5; writes hf (10, R), mr (6, cap_main),
// mr_id, offs (ceil(R / 256), 2) and adds to *cnt.
extern "C" int fused_mesh_k1(const Params* p, const float* tables,
                             const float* sf, float* hf, float* mr,
                             int* mr_id, int* offs, int* cnt, void* stream) {
  if (p->R <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)p->n_words * sizeof(float);
  const cudaError_t e = allow_smem(k1_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (p->R + PACK_BLOCK - 1) / PACK_BLOCK;
  k1_kernel<<<blocks, PACK_BLOCK, smem, (cudaStream_t)stream>>>(
      *p, tables, sf, hf, mr, mr_id, offs, cnt);
  return (int)cudaGetLastError();
}

// The cluster sweep.  tri (n_clusters, cs, 16) and its cluster boxes aabb
// (n_clusters, 8).  occl 0, nearest: rays (6, cap) [o d] -> (t, n,
// material id) into out (5, R) at the rays' lanes; occl 1: rays (7, cap)
// [p w_l lim] -> 1.0 / 0.0 into out (R,) at the rays' lanes.  ids / cnts
// null: every cluster; else the shortlists, ids (cap / 4096, n_clusters)
// and cnts (cap / 4096,), cap a whole number of tiles.  k_max (1 to 16)
// bounds the list slices per ray block; part (2 k_max cap i32 nearest; cap
// i32 occlusion, zero) and tickets (ray blocks i32, zero, left zero) are
// scratch for k_max > 1.
extern "C" int fused_mesh_sweep(const Params* p, int occl, const float* tri,
                                const float* aabb, const float* rays,
                                const int* ray_id, int cap, const int* cnt,
                                const int* ids, const int* cnts, int k_max,
                                int* part, int* tickets, float* out,
                                void* stream) {
  if ((ids == nullptr) != (cnts == nullptr)) return (int)cudaErrorInvalidValue;
  return occl ? sweep<true>(p, tri, aabb, rays, ray_id, cap, cnt, ids, cnts,
                            k_max, part, tickets, out, stream)
              : sweep<false>(p, tri, aabb, rays, ray_id, cap, cnt, ids, cnts,
                             k_max, part, tickets, out, stream);
}

// The sweep's resident blocks per SM for clusters of cs triangles, and the
// SM count: out[0], out[1].  Launches nothing.
extern "C" int fused_mesh_sweep_slots(int occl, int cs, int* out) {
  if (cs <= 0 || cs * NF % 4 != 0) return (int)cudaErrorInvalidValue;
  return (int)(occl ? sweep_slots<true>(cs, out, out + 1)
                    : sweep_slots<false>(cs, out, out + 1));
}

// The grouping of the first min(*cnt, cap) packed rays and their lane ids
// by the boxes of the n_clusters cluster boxes aabb (n_clusters, 8) they
// cross: occl 0, the main rays (6, cap) [o d] over the unbounded line;
// occl 1, the shadow rays (7, cap) [p w_l lim] over the segment up to lim.
// keys (cap,) i32 in pack order; hist (GROUP_KEYS,) i32, zero (GROUP_BITS
// is ops/fused_mesh.py's too), left holding each key's first position plus
// its count; g_rays (6 or 7, cap) and g_id (cap,) the rays and ids in key
// order.  Three launches.
extern "C" int fused_mesh_group(const Params* p, int occl, const float* aabb,
                                const float* rays, const int* ray_id, int cap,
                                const int* cnt, int* keys, int* hist,
                                float* g_rays, int* g_id, void* stream) {
  return group(p, occl != 0, aabb, rays, ray_id, cap, cnt, keys, hist, g_rays,
               g_id, (cudaStream_t)stream);
}

// K1b: reads sf rows 0-5, si (4, R) rows 0-1 and hf; writes kb (9, R),
// sr (7, cap_shadow), sr_id, offs and adds to *cnt.
extern "C" int fused_mesh_k1b(const Params* p, const float* tables,
                              const float* sf, const int* si, const float* hf,
                              float* kb, float* sr, int* sr_id, int* offs,
                              int* cnt, void* stream) {
  if (p->R <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)p->n_words * sizeof(float);
  const cudaError_t e = allow_smem(k1b_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (p->R + PACK_BLOCK - 1) / PACK_BLOCK;
  k1b_kernel<<<blocks, PACK_BLOCK, smem, (cudaStream_t)stream>>>(
      *p, tables, sf, si, hf, kb, sr, sr_id, offs, cnt);
  return (int)cudaGetLastError();
}

// K2: reads kb and the state; writes sf (15, R) and si rows 0-2, adds the
// step's shadow rays to si row 3.
extern "C" int fused_mesh_k2(const Params* p, const float* tables,
                             const float* kb, float* sf, int* si,
                             void* stream) {
  if (p->R <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)p->n_words * sizeof(float);
  const cudaError_t e = allow_smem(k2_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (p->R + LANE_BLOCK - 1) / LANE_BLOCK;
  k2_kernel<<<blocks, LANE_BLOCK, smem, (cudaStream_t)stream>>>(
      *p, tables, kb, sf, si);
  return (int)cudaGetLastError();
}
