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
// What the design does about it:
//   - one thread per pixel; the Q-slot queue (7 floats a slot), rgb and the
//     truncated weight stay in registers for the whole tree (Q is a
//     template parameter, so every slot and candidate index is static and
//     the Batcher network compiles to selects on registers);
//   - the scene tables are copied into shared memory at block start; the
//     threads of a warp read the same primitive at the same time;
//   - work is skipped per thread where the TPU kernel skipped per tile: a
//     dead slot (weight <= 0) emits two zero-weight candidates without
//     tracing, and a thread whose queue holds no live slot stops (a dead
//     level adds only zeros).
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

// jnp.mod(x, 1.0): the remainder with the divisor's sign.
__device__ __forceinline__ float floor_mod1(float x) {
  float m = fmodf(x, 1.0f);
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
  const bool okq = disc > 0.0f;
  const float sq = sqrtf(okq ? disc : 1.0f);
  const float t_near = (-hb - sq) / a_q;
  const float t_far = (-hb + sq) / a_q;
  return (okq && (t_near > t_min)) ? t_near
         : ((okq && (t_far > t_min)) ? t_far : NO_HIT);
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

template <int Q>
__global__ void __launch_bounds__(128)
whitted_kernel(const Params p, const float* __restrict__ tables_g,
               const float* __restrict__ dirs, float* __restrict__ out) {
  extern __shared__ float sm[];
  for (int i = threadIdx.x; i < p.words; i += blockDim.x) sm[i] = tables_g[i];
  __syncthreads();

  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= p.n_pix) return;           // lanes past the image stay inert
  const float* tri = sm;
  const float* sph = sm + p.off_sph;
  const float* mat = sm + p.off_mat;
  const float* lgt = sm + p.off_light;
  const float* sky = sm + p.off_sky;
  const float* chess = sm + p.off_chess;
  const float* cam = sm + p.off_cam;
  const float chess_f = chess[6];

  // Slot 0 is the primary ray; the rest dead.
  Slot slots[Q];
  slots[0] = {1.0f, cam[0], cam[1], cam[2], dirs[pix], dirs[p.n_pix + pix],
              dirs[2 * p.n_pix + pix]};
#pragma unroll
  for (int q = 1; q < Q; ++q) slots[q] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float rr = 0.0f, rg = 0.0f, rb = 0.0f, trunc = 0.0f;

  for (int lv = 0; lv <= p.depth; ++lv) {
    bool any_alive = false;
#pragma unroll
    for (int q = 0; q < Q; ++q) any_alive = any_alive || (slots[q].w > 0.0f);
    if (!any_alive) break;              // a dead level adds only zeros

    Slot cand[2 * Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float w = slots[q].w;
      if (!(w > 0.0f)) {
        cand[2 * q] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        cand[2 * q + 1] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        continue;
      }
      const float ox = slots[q].ox, oy = slots[q].oy, oz = slots[q].oz;
      const float dx = slots[q].dx, dy = slots[q].dy, dz = slots[q].dz;

      // --- nearest hit: (t, raw normal, material id, uv) ---------------------
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
      const bool hit = best_t < NO_HIT;
      norm3(nx, ny, nz);
      const float t_pt = hit ? best_t : 1.0f;
      const float hx = ox + t_pt * dx;
      const float hy = oy + t_pt * dy;
      const float hz = oz + t_pt * dz;

      // --- material row --------------------------------------------------------
      float kind = -1.0f, alr = 0.f, alg = 0.f, alb = 0.f, ior = 1.0f;
      float kd = 0.f, ks = 0.f, sxp = 1.0f, tex = 0.f;
      for (int k = 0; k < p.n_mat; ++k) {
        if (mid == (float)k) {
          const float* M = mat + k * MAT_W;
          kind = M[0]; alr = M[1]; alg = M[2]; alb = M[3]; ior = M[4];
          kd = M[5]; ks = M[6]; sxp = M[7]; tex = M[8];
        }
      }

      // --- chessboard ------------------------------------------------------------
      const bool fx = floor_mod1(bu * chess_f) > 0.5f;
      const bool fy = floor_mod1(bv * chess_f) > 0.5f;
      const float pat = (fx != fy) ? 1.0f : 0.0f;
      const bool use_chess = tex == TEX_CHESSBOARD;
      const float colr = use_chess ? chess[0] + (chess[3] - chess[0]) * pat : alr;
      const float colg = use_chess ? chess[1] + (chess[4] - chess[1]) * pat : alg;
      const float colb = use_chess ? chess[2] + (chess[5] - chess[2]) * pat : alb;

      // --- miss -> sky -------------------------------------------------------------
      if (!hit) {
        rr = rr + w * sky[0];
        rg = rg + w * sky[1];
        rb = rb + w * sky[2];
      }

      // --- Diffuse_Glossy -> Blinn-Phong with shadow rays -------------------------
      const bool is_diff = hit && (kind == DIFFUSE_GLOSSY);
      if (is_diff) {
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
                                  sxp);
          const float visf = vis ? 1.0f : 0.0f;
          dsr = dsr + visf * L[3] * cos_l;
          dsg = dsg + visf * L[4] * cos_l;
          dsb = dsb + visf * L[5] * cos_l;
          ssr = ssr + visf * spec * L[3];
          ssg = ssg + visf * spec * L[4];
          ssb = ssb + visf * spec * L[5];
        }
        rr = rr + w * (dsr * colr * kd + ssr * ks);
        rg = rg + w * (dsg * colg * kd + ssg * ks);
        rb = rb + w * (dsb * colb * kd + ssb * ks);
      }

      // --- specular children: exact polarized Fresnel, reflect, Snell -------------
      const bool is_refl = hit && (kind == REFLECTIVE);
      const bool is_glass = hit && (kind == REFLECTIVE_REFRACTIVE);
      if (!(is_refl || is_glass)) {
        cand[2 * q] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        cand[2 * q + 1] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        continue;
      }
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
      cand[2 * q] = {w * fres, hx + sg_r * nx * p.eps, hy + sg_r * ny * p.eps,
                     hz + sg_r * nz * p.eps, rfx, rfy, rfz};
      cand[2 * q + 1] = {(is_glass && !tir) ? w * (1.0f - fres) : 0.0f,
                         hx + sg_t * nx * p.eps, hy + sg_t * ny * p.eps,
                         hz + sg_t * nz * p.eps, ttx, tty, ttz};
    }

    // --- top-Q of the 2Q candidates by throughput ---------------------------------
    sort_net<Q>(cand);
#pragma unroll
    for (int q = 0; q < Q; ++q) slots[q] = cand[q];
#pragma unroll
    for (int q = Q; q < 2 * Q; ++q) trunc = trunc + cand[q].w;
  }

  out[pix] = rr;
  out[p.n_pix + pix] = rg;
  out[2 * p.n_pix + pix] = rb;
  out[3 * p.n_pix + pix] = trunc;
}

template <int Q>
cudaError_t launch(const Params& p, const float* tables, const float* dirs,
                   float* out, cudaStream_t stream) {
  const size_t smem = (size_t)p.words * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        whitted_kernel<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int threads = 128;
  const int blocks = (p.n_pix + threads - 1) / threads;
  whitted_kernel<Q><<<blocks, threads, smem, stream>>>(p, tables, dirs, out);
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
