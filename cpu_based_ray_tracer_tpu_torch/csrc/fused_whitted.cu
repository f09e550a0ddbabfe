// fused_whitted.cu — the whole Whitted ray tree per pixel in one launch,
// for Hopper (sm_90a).
//
// Replaces: cpu_based_ray_tracer_tpu/ops/fused_whitted.py::_kernel, the
// Pallas TPU kernel launched by _run from render_fused.
//
// What bounds it on this card: arithmetic.  Per pixel and tree level, each
// live queue slot runs a nearest-hit pass over every primitive, one
// occlusion pass per point light, Blinn-Phong, the exact polarized Fresnel
// term and two child rays — about 1,700 f32 operations per live slot on
// the reference scene (2 triangles, 2 spheres, 2 lights, 3 materials)
// against 16 bytes read and 16 written per pixel.  The FP32 pipes, not
// memory, are the limit.
//
// What the design does about it: the live work of a block, not the
// union of its warps'.  On the reference scene a floor or sky pixel ends
// after the first level and a glass pixel keeps two live slots for all six
// levels (one hits the glass, the other the floor, the sky or the diffuse
// sphere), so a thread a pixel would run each of the Q slot sections, and
// in it the Blinn-Phong and the specular branch, for the whole warp when
// one lane needs it.  Here a block of WB pixels keeps its queues (7 floats a
// slot) and a record for each slot (its hit, then its term or its two
// children) in shared memory, and each level:
//   - lists its live (pixel, slot) items (a ballot and one shared atomic
//     a warp) and every thread traces them: nearest hit over every
//     primitive, a miss's sky term, the hit kept for the next run;
//   - runs the Blinn-Phong items (shadow rays to every point light), then
//     the specular items (Fresnel, reflect, Snell: the two children), each
//     list compacted, so a warp runs one branch;
//   - hands each pixel back to its thread, which adds its slots' terms in
//     slot order and keeps the top Q of its 2Q candidates by the Batcher
//     network or, when every candidate past the first two weighs 0 (only
//     the slot-0 item had children), by the network's first
//     compare-swap, the only one that can swap then.
// The scene tables sit in shared memory too; the threads of a warp read
// the same primitive at the same time.
//
// Numerics: built with -fmad=false and without --use_fast_math; every
// expression keeps the TPU kernel's operation order.  jax.lax.rsqrt
// becomes 1.0f / sqrtf (rsqrtf is approximate), jnp.mod a floor mod,
// jnp.power powf.  The plain PyTorch version (ops/fused_whitted.py::
// _tree_plain) runs the same algorithm.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TRI_W = 20, SPH_W = 8, MAT_W = 12, LGT_W = 8;
constexpr float NO_HIT = FLT_MAX;
constexpr float DET_EPS = 1e-12f;
constexpr float DIFFUSE_GLOSSY = 3.0f, REFLECTIVE = 4.0f;
constexpr float REFLECTIVE_REFRACTIVE = 5.0f, TEX_CHESSBOARD = 1.0f;

struct Params {
  int off_sph, off_mat, off_light, off_sky, off_chess, off_cam, words;
  int n_tri, n_sph, n_mat, n_light, n_pix, depth;
  float t_min, eps;
};

struct Slot {
  float w, ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ void norm3(float& x, float& y, float& z) {
  const float inv = 1.0f / sqrtf(fmaxf(x * x + y * y + z * z, 1e-24f));
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

// jnp.mod(x, 1.0): the remainder with the divisor's sign.  x - truncf(x)
// is fmodf(x, 1.0f) to the value (exact: the integer part is x's to within
// a factor 2, or x is an integer), but for the sign of a zero, which no
// caller reads (it compares the result with 0.5); fmodf is a loop.
__device__ __forceinline__ float floor_mod1(float x) {
  float m = x - truncf(x);
  if (m != 0.0f && m < 0.0f) m = m + 1.0f;
  return m;
}

__device__ __forceinline__ float sphere_t(float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          const float* S, float t_min) {
  const float ocx = ox - S[0], ocy = oy - S[1], ocz = oz - S[2];
  const float rad = S[3];
  const float a_q = dx * dx + dy * dy + dz * dz;
  const float hb = ocx * dx + ocy * dy + ocz * dz;
  const float c_q = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
  const float disc = hb * hb - a_q * c_q;
  // a miss is NO_HIT whatever the roots: skip the root and the divisions
  if (!(disc > 0.0f)) return NO_HIT;
  const float sq = sqrtf(disc);
  const float t_near = (-hb - sq) / a_q;
  const float t_far = (-hb + sq) / a_q;
  return (t_near > t_min) ? t_near : ((t_far > t_min) ? t_far : NO_HIT);
}

// Moller-Trumbore: returns the accept flag; t, b1, b2 out.
__device__ __forceinline__ bool tri_hit(float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        const float* T, float t_min, float& t,
                                        float& b1, float& b2) {
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
  t = (s2x * e2x + s2y * e2y + s2z * e2z) * inv;
  b1 = (s1x * sx + s1y * sy + s1z * sz) * inv;
  b2 = (s2x * dx + s2y * dy + s2z * dz) * inv;
  return okd && (t > t_min) && (b1 >= 0.0f) && (b2 >= 0.0f) &&
         (1.0f - b1 - b2 >= 0.0f);
}

__device__ __forceinline__ float nearest_t(const Params& p, const float* tri,
                                           const float* sph, float ox,
                                           float oy, float oz, float dx,
                                           float dy, float dz) {
  float best_t = NO_HIT;
  for (int i = 0; i < p.n_tri; ++i) {
    float t, b1, b2;
    const bool ok = tri_hit(ox, oy, oz, dx, dy, dz, tri + i * TRI_W,
                            p.t_min, t, b1, b2);
    if (ok && (t < best_t)) best_t = t;
  }
  for (int m = 0; m < p.n_sph; ++m)
    best_t = fminf(best_t,
                   sphere_t(ox, oy, oz, dx, dy, dz, sph + m * SPH_W, p.t_min));
  return best_t;
}

__device__ __forceinline__ void cswap(Slot* c, int a, int b) {
  // Descending by weight; swap only when strictly larger (the TPU kernel's
  // `wb > wa`), so equal weights keep their order.
  if (c[b].w > c[a].w) {
    const Slot t = c[a];
    c[a] = c[b];
    c[b] = t;
  }
}

template <int Q>
__device__ __forceinline__ void sort_net(Slot* c);

template <>
__device__ __forceinline__ void sort_net<2>(Slot* c) {
  cswap(c, 0, 1); cswap(c, 2, 3); cswap(c, 0, 2); cswap(c, 1, 3);
  cswap(c, 1, 2);
}

template <>
__device__ __forceinline__ void sort_net<4>(Slot* c) {
  cswap(c, 0, 1); cswap(c, 2, 3); cswap(c, 4, 5); cswap(c, 6, 7);
  cswap(c, 0, 2); cswap(c, 1, 3); cswap(c, 4, 6); cswap(c, 5, 7);
  cswap(c, 1, 2); cswap(c, 5, 6); cswap(c, 0, 4); cswap(c, 1, 5);
  cswap(c, 2, 6); cswap(c, 3, 7); cswap(c, 2, 4); cswap(c, 3, 5);
  cswap(c, 1, 2); cswap(c, 3, 4); cswap(c, 5, 6);
}

// The block's pixels and their queues in shared memory, behind the scene
// tables: structure of arrays, item j = q * WB + t is slot q of the
// block's pixel t.
constexpr int WB = 128;          // threads and pixels a block
constexpr int SLOT_F = 7;        // w, origin, direction
constexpr int HIT_F = 9;         // hit point, normal, material id, u, v
constexpr int REC_F = 2 * SLOT_F;  // the hit, then its two children
enum ItemKind : int { K_NONE = 0, K_ADD = 1, K_DIFFUSE = 2, K_SPECULAR = 3 };

template <int Q>
struct Queues {
  float* slot;   // [SLOT_F][Q * WB]
  float* rec;    // [REC_F][Q * WB]: the hit; then a term's rgb in 0..2,
                 //  or a specular item's children (candidates 2q, 2q + 1)
  int* kind;     // [Q * WB]
  int* live;     // [Q * WB]: the level's live items
  int* work;     // [Q * WB]: Blinn-Phong items from the front, specular
                 //  items from the back
  int* count;    // [3]: live, Blinn-Phong, specular
  __device__ Queues(float* base) {
    slot = base;
    rec = slot + SLOT_F * Q * WB;
    kind = reinterpret_cast<int*>(rec + REC_F * Q * WB);
    live = kind + Q * WB;
    work = live + Q * WB;
    count = work + Q * WB;
  }
  static constexpr size_t words() {
    return (size_t)(SLOT_F + REC_F + 3) * Q * WB + 3;
  }
};

// Appends index v to list[count[c]...] for the lanes of the warp where
// `take` holds (one shared atomic a warp).
__device__ __forceinline__ void append(bool take, int v, int* list, int* ctr,
                                       bool from_back, int n) {
  const unsigned m = __ballot_sync(0xffffffffu, take);
  if (m == 0u) return;
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == __ffs(m) - 1) base = atomicAdd(ctr, __popc(m));
  base = __shfl_sync(0xffffffffu, base, __ffs(m) - 1);
  if (take) {
    const int pos = base + __popc(m & ((1u << lane) - 1u));
    list[from_back ? n - 1 - pos : pos] = v;
  }
}

// The material row of material id mid: the last k with mid == k, as the
// TPU kernel's chain of selects.
struct Mat {
  float kind, alr, alg, alb, ior, kd, ks, sxp, tex;
};
__device__ __forceinline__ Mat material(const Params& p, const float* mat,
                                        float mid) {
  Mat m = {-1.0f, 0.f, 0.f, 0.f, 1.0f, 0.f, 0.f, 1.0f, 0.f};
  for (int k = 0; k < p.n_mat; ++k) {
    if (mid == (float)k) {
      const float* M = mat + k * MAT_W;
      m = {M[0], M[1], M[2], M[3], M[4], M[5], M[6], M[7], M[8]};
    }
  }
  return m;
}

// A level's live slot: its nearest hit; a miss's term (w * sky), or the
// hit kept for its Blinn-Phong or specular item.
template <int Q>
__device__ __forceinline__ void trace_item(const Params& p, const float* sm,
                                           Queues<Q>& qs, int j) {
  constexpr int N = Q * WB;
  const float* tri = sm;
  const float* sph = sm + p.off_sph;
  const float w = qs.slot[j];
  const float ox = qs.slot[N + j], oy = qs.slot[2 * N + j];
  const float oz = qs.slot[3 * N + j], dx = qs.slot[4 * N + j];
  const float dy = qs.slot[5 * N + j], dz = qs.slot[6 * N + j];
  float best_t = NO_HIT, nx = 0.f, ny = 0.f, nz = 0.f, mid = -1.0f;
  float bu = 0.f, bv = 0.f;
  for (int i = 0; i < p.n_tri; ++i) {
    const float* T = tri + i * TRI_W;
    float t, b1, b2;
    const bool ok = tri_hit(ox, oy, oz, dx, dy, dz, T, p.t_min, t, b1, b2)
                    && (t < best_t);
    if (ok) {
      const float b0 = 1.0f - b1 - b2;
      best_t = t;
      nx = T[9]; ny = T[10]; nz = T[11];
      mid = T[12];
      bu = T[13] * b0 + T[15] * b1 + T[17] * b2;
      bv = T[14] * b0 + T[16] * b1 + T[18] * b2;
    }
  }
  for (int m = 0; m < p.n_sph; ++m) {
    const float* S = sph + m * SPH_W;
    const float ts = sphere_t(ox, oy, oz, dx, dy, dz, S, p.t_min);
    if (ts < best_t) {
      const float rad = S[3];
      const float inv_r = 1.0f / (rad == 0.0f ? 1.0f : rad);
      const float hx = ox + ts * dx, hy = oy + ts * dy, hz = oz + ts * dz;
      best_t = ts;
      nx = (hx - S[0]) * inv_r;
      ny = (hy - S[1]) * inv_r;
      nz = (hz - S[2]) * inv_r;
      mid = S[4];
      bu = 0.0f;
      bv = 0.0f;
    }
  }
  int kind = K_NONE;
  if (!(best_t < NO_HIT)) {
    const float* sky = sm + p.off_sky;
    qs.rec[j] = w * sky[0];
    qs.rec[N + j] = w * sky[1];
    qs.rec[2 * N + j] = w * sky[2];
    kind = K_ADD;
  } else {
    norm3(nx, ny, nz);
    const float hx = ox + best_t * dx;
    const float hy = oy + best_t * dy;
    const float hz = oz + best_t * dz;
    const float mk = material(p, sm + p.off_mat, mid).kind;
    if (mk == DIFFUSE_GLOSSY) kind = K_DIFFUSE;
    if (mk == REFLECTIVE || mk == REFLECTIVE_REFRACTIVE) kind = K_SPECULAR;
    const float r[HIT_F] = {hx, hy, hz, nx, ny, nz, mid, bu, bv};
#pragma unroll
    for (int f = 0; f < HIT_F; ++f) qs.rec[f * N + j] = r[f];
  }
  qs.kind[j] = kind;
}

// A Blinn-Phong item: shadow rays to every point light, the chessboard
// texture; its term goes to rec 0..2.
template <int Q>
__device__ __forceinline__ void diffuse_item(const Params& p, const float* sm,
                                             Queues<Q>& qs, int j) {
  constexpr int N = Q * WB;
  const float* tri = sm;
  const float* sph = sm + p.off_sph;
  const float* lgt = sm + p.off_light;
  const float* chess = sm + p.off_chess;
  const float w = qs.slot[j];
  const float dx = qs.slot[4 * N + j], dy = qs.slot[5 * N + j];
  const float dz = qs.slot[6 * N + j];
  const float hx = qs.rec[j], hy = qs.rec[N + j], hz = qs.rec[2 * N + j];
  const float nx = qs.rec[3 * N + j], ny = qs.rec[4 * N + j];
  const float nz = qs.rec[5 * N + j];
  const Mat m = material(p, sm + p.off_mat, qs.rec[6 * N + j]);
  const float bu = qs.rec[7 * N + j], bv = qs.rec[8 * N + j];
  const float chess_f = chess[6];
  const bool fx = floor_mod1(bu * chess_f) > 0.5f;
  const bool fy = floor_mod1(bv * chess_f) > 0.5f;
  const float pat = (fx != fy) ? 1.0f : 0.0f;
  const bool use_chess = m.tex == TEX_CHESSBOARD;
  const float colr = use_chess ? chess[0] + (chess[3] - chess[0]) * pat : m.alr;
  const float colg = use_chess ? chess[1] + (chess[4] - chess[1]) * pat : m.alg;
  const float colb = use_chess ? chess[2] + (chess[5] - chess[2]) * pat : m.alb;
  const bool inside = (dx * nx + dy * ny + dz * nz) < 0.0f;
  const float sgn = inside ? 1.0f : -1.0f;
  const float px = hx + sgn * nx * p.eps;
  const float py = hy + sgn * ny * p.eps;
  const float pz = hz + sgn * nz * p.eps;
  float dsr = 0.f, dsg = 0.f, dsb = 0.f, ssr = 0.f, ssg = 0.f, ssb = 0.f;
  for (int li = 0; li < p.n_light; ++li) {
    const float* L = lgt + li * LGT_W;
    const float tlx = L[0] - hx, tly = L[1] - hy, tlz = L[2] - hz;
    const float dist2 = tlx * tlx + tly * tly + tlz * tlz;
    const float inv_l = 1.0f / sqrtf(fmaxf(dist2, 1e-24f));
    const float ldx = tlx * inv_l, ldy = tly * inv_l, ldz = tlz * inv_l;
    const float occ_t = nearest_t(p, tri, sph, px, py, pz, ldx, ldy, ldz);
    const bool vis = !(occ_t * occ_t < dist2);
    const float cos_l = fabsf(ldx * nx + ldy * ny + ldz * nz);
    const float mdn = -(ldx * nx + ldy * ny + ldz * nz);
    const float rx = -ldx - 2.0f * mdn * nx;
    const float ry = -ldy - 2.0f * mdn * ny;
    const float rz = -ldz - 2.0f * mdn * nz;
    const float spec = powf(fmaxf(0.0f, -(rx * dx + ry * dy + rz * dz)),
                            m.sxp);
    const float visf = vis ? 1.0f : 0.0f;
    dsr = dsr + visf * L[3] * cos_l;
    dsg = dsg + visf * L[4] * cos_l;
    dsb = dsb + visf * L[5] * cos_l;
    ssr = ssr + visf * spec * L[3];
    ssg = ssg + visf * spec * L[4];
    ssb = ssb + visf * spec * L[5];
  }
  qs.rec[j] = w * (dsr * colr * m.kd + ssr * m.ks);
  qs.rec[N + j] = w * (dsg * colg * m.kd + ssg * m.ks);
  qs.rec[2 * N + j] = w * (dsb * colb * m.kd + ssb * m.ks);
  qs.kind[j] = K_ADD;
}

// A specular item: the exact polarized Fresnel term, the reflected and the
// refracted child (the pixel's candidates 2q and 2q + 1) into its record.
template <int Q>
__device__ __forceinline__ void specular_item(const Params& p,
                                              const float* sm, Queues<Q>& qs,
                                              int j) {
  constexpr int N = Q * WB;
  const float w = qs.slot[j];
  const float dx = qs.slot[4 * N + j], dy = qs.slot[5 * N + j];
  const float dz = qs.slot[6 * N + j];
  const float hx = qs.rec[j], hy = qs.rec[N + j], hz = qs.rec[2 * N + j];
  const float nx = qs.rec[3 * N + j], ny = qs.rec[4 * N + j];
  const float nz = qs.rec[5 * N + j];
  const Mat m = material(p, sm + p.off_mat, qs.rec[6 * N + j]);
  const float ior = m.ior;
  const bool is_glass = m.kind == REFLECTIVE_REFRACTIVE;
  const float cos_i = fminf(fmaxf(dx * nx + dy * ny + dz * nz, -1.0f), 1.0f);
  const bool outside = cos_i < 0.0f;
  const float eta_in = outside ? 1.0f : ior;
  const float eta_out = outside ? ior : 1.0f;
  const float ci = fabsf(cos_i);
  const float si = sqrtf(fmaxf(0.0f, 1.0f - ci * ci));
  const float st = eta_in / eta_out * si;
  const bool tir_f = st >= 1.0f;
  const float ct = sqrtf(fmaxf(0.0f, 1.0f - st * st));
  const float rs = (eta_in * ci - eta_out * ct) / (eta_in * ci + eta_out * ct);
  const float rp = (eta_in * ct - eta_out * ci) / (eta_in * ct + eta_out * ci);
  const float fres = tir_f ? 1.0f : 0.5f * (rs * rs + rp * rp);

  const float ddn = dx * nx + dy * ny + dz * nz;
  float rfx = dx - 2.0f * ddn * nx;
  float rfy = dy - 2.0f * ddn * ny;
  float rfz = dz - 2.0f * ddn * nz;
  norm3(rfx, rfy, rfz);
  const float eta_r = outside ? 1.0f / ior : ior;
  const float nsx = outside ? nx : -nx;
  const float nsy = outside ? ny : -ny;
  const float nsz = outside ? nz : -nz;
  const float kk = 1.0f - eta_r * eta_r * (1.0f - ci * ci);
  const float sq = sqrtf(fmaxf(kk, 0.0f));
  const bool tir2 = kk < 0.0f;
  float ttx = tir2 ? 0.0f : eta_r * dx + (eta_r * ci - sq) * nsx;
  float tty = tir2 ? 0.0f : eta_r * dy + (eta_r * ci - sq) * nsy;
  float ttz = tir2 ? 0.0f : eta_r * dz + (eta_r * ci - sq) * nsz;
  const float tnorm2 = ttx * ttx + tty * tty + ttz * ttz;
  norm3(ttx, tty, ttz);
  const bool tir = tnorm2 < 0.5f;

  const float sg_r = ((rfx * nx + rfy * ny + rfz * nz) < 0.0f) ? -1.0f : 1.0f;
  const float sg_t = ((ttx * nx + tty * ny + ttz * nz) < 0.0f) ? -1.0f : 1.0f;
  const float c0[SLOT_F] = {w * fres, hx + sg_r * nx * p.eps,
                            hy + sg_r * ny * p.eps, hz + sg_r * nz * p.eps,
                            rfx, rfy, rfz};
  const float c1[SLOT_F] = {(is_glass && !tir) ? w * (1.0f - fres) : 0.0f,
                            hx + sg_t * nx * p.eps, hy + sg_t * ny * p.eps,
                            hz + sg_t * nz * p.eps, ttx, tty, ttz};
#pragma unroll
  for (int f = 0; f < SLOT_F; ++f) {
    qs.rec[f * N + j] = c0[f];
    qs.rec[(SLOT_F + f) * N + j] = c1[f];
  }
}

// One block of WB pixels walks its trees level by level.  Each level the
// block lists its live (pixel, slot) items and every thread traces them
// (trace_item), so no lane runs a dead slot; then the Blinn-Phong and the
// specular items, each list in a run of its own so that a warp runs one
// branch; then each pixel's thread adds its slots' terms in slot order
// (the sums, and their bits, of the one-thread-a-pixel tree) and keeps
// the top Q of its 2Q candidates.
template <int Q>
__global__ void __launch_bounds__(WB)
whitted_kernel(const Params p, const float* __restrict__ tables_g,
               const float* __restrict__ dirs, float* __restrict__ out) {
  constexpr int N = Q * WB;
  extern __shared__ float sm[];
  for (int i = threadIdx.x; i < p.words; i += WB) sm[i] = tables_g[i];
  Queues<Q> qs(sm + ((p.words + 3) & ~3));
  const int t = threadIdx.x;
  const int pix = blockIdx.x * WB + t;
  const bool mine = pix < p.n_pix;     // lanes past the image stay dead
  {
    const float* cam = sm + p.off_cam;
    __syncthreads();
    const float s0[SLOT_F] = {
        mine ? 1.0f : 0.0f, cam[0], cam[1], cam[2],
        mine ? dirs[pix] : 0.f, mine ? dirs[p.n_pix + pix] : 0.f,
        mine ? dirs[2 * p.n_pix + pix] : 0.f};
#pragma unroll
    for (int f = 0; f < SLOT_F; ++f) qs.slot[f * N + t] = s0[f];
#pragma unroll
    for (int q = 1; q < Q; ++q) qs.slot[q * WB + t] = 0.0f;
  }
  float rr = 0.0f, rg = 0.0f, rb = 0.0f, trunc = 0.0f;

  for (int lv = 0; lv <= p.depth; ++lv) {
    if (t < 3) qs.count[t] = 0;
    __syncthreads();
    // the live items
#pragma unroll
    for (int q = 0; q < Q; ++q)
      append(qs.slot[q * WB + t] > 0.0f, q * WB + t, qs.live, qs.count,
             false, N);
    __syncthreads();
    const int n_live = qs.count[0];
    if (n_live == 0) break;             // a dead level adds only zeros
    for (int i0 = 0; i0 < n_live; i0 += WB) {
      const int i = i0 + t;
      int kind = K_NONE, j = 0;
      if (i < n_live) {
        j = qs.live[i];
        trace_item<Q>(p, sm, qs, j);
        kind = qs.kind[j];
      }
      append(kind == K_DIFFUSE, j, qs.work, qs.count + 1, false, N);
      append(kind == K_SPECULAR, j, qs.work, qs.count + 2, true, N);
    }
    __syncthreads();
    const int n_diff = qs.count[1], n_spec = qs.count[2];
    for (int i = t; i < n_diff + n_spec; i += WB) {
      if (i < n_diff)
        diffuse_item<Q>(p, sm, qs, qs.work[i]);
      else
        specular_item<Q>(p, sm, qs, qs.work[N - 1 - (i - n_diff)]);
    }
    __syncthreads();
    // the pixel's terms in slot order, then its top Q candidates
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int j = q * WB + t;
      if (qs.slot[j] > 0.0f && qs.kind[j] == K_ADD) {
        rr = rr + qs.rec[j];
        rg = rg + qs.rec[N + j];
        rb = rb + qs.rec[2 * N + j];
      }
    }
    // The candidates: a live specular slot's two children, else weight 0.
    // When every candidate past the first two weighs exactly 0 (they are
    // never below 0), the network's only swap is its first, (0, 1): the
    // others would move a 0 ahead of a weight >= 0 or of another 0.
    bool spec[Q];
    float cw[2 * Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int j = q * WB + t;
      spec[q] = qs.slot[j] > 0.0f && qs.kind[j] == K_SPECULAR;
      cw[2 * q] = spec[q] ? qs.rec[j] : 0.0f;
      cw[2 * q + 1] = spec[q] ? qs.rec[SLOT_F * N + j] : 0.0f;
    }
    bool two = !(cw[0] < 0.0f) && !(cw[1] < 0.0f);
#pragma unroll
    for (int k = 2; k < 2 * Q; ++k) two = two && cw[k] == 0.0f;
    Slot c[2 * Q];
#pragma unroll
    for (int k = 0; k < 2 * Q; ++k) {
      const float* R = qs.rec + (k % 2) * SLOT_F * N + (k / 2) * WB + t;
      if (spec[k / 2] && (k < 2 || !two))
        c[k] = {R[0], R[N], R[2 * N], R[3 * N], R[4 * N], R[5 * N],
                R[6 * N]};
      else
        c[k] = {cw[k], 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    }
    if (two) {
      cswap(c, 0, 1);
    } else {
      sort_net<Q>(c);
#pragma unroll
      for (int k = Q; k < 2 * Q; ++k) trunc = trunc + c[k].w;
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float s[SLOT_F] = {c[q].w, c[q].ox, c[q].oy, c[q].oz,
                               c[q].dx, c[q].dy, c[q].dz};
#pragma unroll
      for (int f = 0; f < SLOT_F; ++f) qs.slot[f * N + q * WB + t] = s[f];
    }
  }

  if (mine) {
    out[pix] = rr;
    out[p.n_pix + pix] = rg;
    out[2 * p.n_pix + pix] = rb;
    out[3 * p.n_pix + pix] = trunc;
  }
}

template <int Q>
cudaError_t launch(const Params& p, const float* tables, const float* dirs,
                   float* out, cudaStream_t stream) {
  const size_t smem =
      ((size_t)((p.words + 3) & ~3) + Queues<Q>::words()) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        whitted_kernel<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (p.n_pix + WB - 1) / WB;
  whitted_kernel<Q><<<blocks, WB, smem, stream>>>(p, tables, dirs, out);
  return cudaGetLastError();
}

}  // namespace

// Evaluates the depth-`depth` Whitted tree of each of n_pix > 0 pixels with a `queue`-slot
// queue (2 or 4) on `stream`.  `tables` is the concatenation
// tri (max(n_tri,1), 20) | sph (max(n_sph,1), 8) | mat (n_mat, 12)
// | light (max(n_light,1), 8) | sky (8) | chess (8) | cam (8), `words`
// floats in all; `dirs` is (3, n_pix) f32; `out` is (4, n_pix) f32: rgb and
// the truncated weight.  Returns cudaGetLastError().
extern "C" int fused_whitted_tree(const float* tables, int words, int n_tri,
                                  int n_sph, int n_mat, int n_light,
                                  const float* dirs, float* out, int n_pix,
                                  int depth, int queue, float t_min, float eps,
                                  void* stream) {
  Params p;
  p.n_tri = n_tri;
  p.n_sph = n_sph;
  p.n_mat = n_mat;
  p.n_light = n_light;
  p.off_sph = (n_tri > 1 ? n_tri : 1) * TRI_W;
  p.off_mat = p.off_sph + (n_sph > 1 ? n_sph : 1) * SPH_W;
  p.off_light = p.off_mat + n_mat * MAT_W;
  p.off_sky = p.off_light + (n_light > 1 ? n_light : 1) * LGT_W;
  p.off_chess = p.off_sky + 8;
  p.off_cam = p.off_chess + 8;
  p.words = words;
  if (p.off_cam + 8 != words) return (int)cudaErrorInvalidValue;
  p.n_pix = n_pix;
  p.depth = depth;
  p.t_min = t_min;
  p.eps = eps;
  const cudaStream_t s = (cudaStream_t)stream;
  if (queue == 4) return (int)launch<4>(p, tables, dirs, out, s);
  if (queue == 2) return (int)launch<2>(p, tables, dirs, out, s);
  return (int)cudaErrorInvalidValue;
}
