// cluster_tri.cuh — the triangle loops over one cluster of a cluster-major
// triangle table, shared by the sweeps of csrc/fused_mesh.cu, csrc/coherent.cu
// and csrc/packet.cu (rows of W floats beginning v0 e1 e2: 16 in the fused
// mesh table, v0 e1 e2 n mid idx pad; 12 in the packet table, v0 e1 e2 pad),
// and what the split sweeps share: the padded cluster-box cull, the slice
// count, the walk of one slice with its double buffer, and the ticket that
// elects a ray block's last slice.
//
// A block stages the cluster's CS x W floats in shared memory with 16-byte
// asynchronous copies that land while the previous cluster is tested
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

// Row k's v0 e1 e2 (floats 0-8 of its W) by three float4 reads.
template <int W = NF>
__device__ __forceinline__ void load_row(const float* tile, int k, float& v0x,
                                         float& v0y, float& v0z, float& e1x,
                                         float& e1y, float& e1z, float& e2x,
                                         float& e2y, float& e2z) {
  static_assert(W % 4 == 0 && W >= 12, "float4 rows, v0 e1 e2 first");
  const float4* T4 = reinterpret_cast<const float4*>(tile + k * W);
  const float4 a = T4[0], b = T4[1], c = T4[2];
  v0x = a.x; v0y = a.y; v0z = a.z;
  e1x = a.w; e1y = b.x; e1z = b.y;
  e2x = b.z; e2y = b.w; e2z = c.x;
}

// Nearest hit over the cluster's rows: best_t takes every accepted t below
// it, in row order (so the first row at the least t wins).  Returns the row
// of the last update, or -1 when no row beat best_t.
template <int W = NF>
__device__ __forceinline__ int nearest_rows(const float* tile, int cs,
                                            float ox, float oy, float oz,
                                            float dx, float dy, float dz,
                                            float t_min, float& best_t) {
  int best_k = -1;
  for (int k = 0; k < cs; ++k) {
    float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
    load_row<W>(tile, k, v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z);
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

// --- the cluster cull and the slices of the split sweeps -----------------

constexpr int RAY_BLOCK = 256;  // rays per sweep block (fused_mesh, packet)
constexpr int SPLIT_MAX = 16;   // most cluster slices per ray block
// Block slots the slices fill: the card's resident sweep blocks times this
// (1, 2, 4 and 8 measured; 8 the fastest on the 164k cell).
constexpr int SWEEP_WAVES = 8;

// Slices per ray block of RAY_BLOCK rays for n rays: ceil(target / ray
// blocks), clamped to [1, k_max].
__host__ __device__ __forceinline__ int split_count(int n, int target,
                                                    int k_max) {
  const int nb = (n + RAY_BLOCK - 1) / RAY_BLOCK;
  if (nb <= 0) return 1;
  const int k = (target + nb - 1) / nb;
  return k < 1 ? 1 : (k > k_max ? k_max : k);
}

// Does the ray cross box A (min xyz, max xyz), each side pushed out by
// 1e-4 of the box's extent plus the largest coordinate magnitude of the box
// and of the ray's origin (o_mag), and 1e-6?  The slab test of the mask
// pass (csrc/coherent.cu), with the line's t from min(t_min, 0) (and, for
// a segment, up to hi_bound); iv are the direction's safe reciprocals.
// The margin keeps it conservative against the triangle test's rounding,
// so a ray that hits a triangle crosses the box.  The rounding of both
// tests grows with the coordinates' magnitude, not with the box's extent
// (a box flat in one axis has none), so the pad scales with both
// (ops/fused_mesh.py crosses_box_plain is the same test in PyTorch).
__device__ __forceinline__ bool crosses_box(const float* __restrict__ A,
                                            float ox, float oy, float oz,
                                            float o_mag, float ivx, float ivy,
                                            float ivz, float t_lo,
                                            float hi_bound, bool segment) {
  const float mag = fmaxf(
      o_mag, fmaxf(fmaxf(fmaxf(fabsf(A[0]), fabsf(A[1])),
                         fmaxf(fabsf(A[2]), fabsf(A[3]))),
                   fmaxf(fabsf(A[4]), fabsf(A[5]))));
  const float mx = 1e-4f * ((A[3] - A[0]) + mag) + 1e-6f;
  const float my = 1e-4f * ((A[4] - A[1]) + mag) + 1e-6f;
  const float mz = 1e-4f * ((A[5] - A[2]) + mag) + 1e-6f;
  const float tx0 = (A[0] - mx - ox) * ivx, tx1 = (A[3] + mx - ox) * ivx;
  const float ty0 = (A[1] - my - oy) * ivy, ty1 = (A[4] + my - oy) * ivy;
  const float tz0 = (A[2] - mz - oz) * ivz, tz1 = (A[5] + mz - oz) * ivz;
  const float t_in = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)),
                           fminf(tz0, tz1));
  const float t_out = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)),
                            fmaxf(tz0, tz1));
  return (t_out >= t_lo) && (t_in <= t_out) && (!segment || t_in <= hi_bound);
}

// Walks positions [j0, j1) of a cluster slice in order; every thread of the
// block calls it.  probe(q): does this thread's ray need position q?  A
// position is staged when a ray of the block needs it (one barrier a
// probe).  With STOP, busy() (does this thread's ray still need testing?)
// is OR-ed over the block before each search, and the walk ends when no
// ray is busy.  Staged positions go by cp.async into two buffers of words4
// float4 each, the next while the current is visited: visit(q, tile, mine)
// runs, by every thread, for each staged position, mine the thread's probe
// of it.  cluster(q) is the position's cluster in `tri`.
template <bool STOP, class Busy, class Probe, class Cluster, class Visit>
__device__ __forceinline__ void walk_slice(float4* tile4,
                                           const float* __restrict__ tri,
                                           int words4, int j0, int j1,
                                           Busy busy, Probe probe,
                                           Cluster cluster, Visit visit) {
  // The next position at or after q that a ray of the block needs (j1:
  // none), and this thread's probe of it.
  auto seek = [&](int q, bool& mine) {
    if (STOP && !__syncthreads_or(busy())) return j1;
    for (; q < j1; ++q) {
      mine = probe(q);
      if (__syncthreads_or(mine)) return q;
    }
    return j1;
  };
  int cur = 0;   // the buffer position j is staged in
  bool mine = false;
  int j = seek(j0, mine);
  if (j < j1) stage_cluster_async(tile4, tri, cluster(j), words4);
  while (j < j1) {
    wait_staged();   // this thread's copies of position j
    // Every copy of position j has landed, and the other buffer is no
    // longer read: it takes the next position a ray of the block needs.
    __syncthreads();
    bool mine_next = false;
    const int jn = seek(j + 1, mine_next);
    if (jn < j1)
      stage_cluster_async(tile4 + (cur ^ 1) * words4, tri, cluster(jn),
                          words4);
    visit(j, reinterpret_cast<const float*>(tile4 + cur * words4), mine);
    j = jn;
    mine = mine_next;
    cur ^= 1;
  }
}

// Is this block the last of ray block rb's K slices to finish?  Every thread
// calls it after writing its partials, which are made visible before the
// ticket is taken.  The last block sets the ticket back to 0, so the
// tickets serve the next launch on the stream.
__device__ __forceinline__ bool last_slice(int* tickets, int rb, int K) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(tickets + rb, 1) == K - 1;
    if (last) tickets[rb] = 0;
  }
  __syncthreads();
  return last;
}

}  // namespace cluster_tri
