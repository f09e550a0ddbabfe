// fused_rtiow.cu — equal-spp RTIOW sphere path tracer for Hopper (sm_90a):
// the offline prototype's and the NPPT stage's whole render in one launch.
//
// Replaces: cpu_based_ray_tracer_tpu/ops/fused_rtiow.py::_kernel, the
// Pallas TPU kernel launched by _run from render_fused.
//
// What bounds it on this card: arithmetic.  Each live lane-step runs one
// ray/sphere quadratic per sphere (~28 f32 operations; 6 spheres in the
// NPPT scene), then a miss's sky term (~28) or a hit's shading (~41 plus
// 14-64 for its material's branch; the sphere/ball sample has a sin, a cos
// and a pow), plus each finished sample's next primary ray, against 60
// bytes of lane state read and written once per pixel.  Most lane-steps
// are misses (about 70% early in the NPPT render).
//
// What the design does about it:
//   - one launch per render (fused_rtiow_render): as many threads as the
//     card holds at once; each takes a pixel from a global counter
//     (warp-aggregated atomicAdd), steps it until its last sample is done,
//     writes its state back and takes the next pixel.  No lane idles while
//     pixels remain, and the host neither polls nor schedules chunks.  The
//     RNG is stateless (pixel, sample, bounce, stream) and a lane's state
//     changes only by its own steps, so the result of a pixel does not
//     depend on which thread, launch or step runs it: the image is the
//     lockstep schedule's, bit for bit;
//   - the step branches on what the ray meets (rtiow_step): a miss
//     computes the sky term only; a hit that may continue computes the
//     facing normal and then its material's branch only (the sphere/ball
//     sample for Lambert and metal, Schlick and Snell for dielectric); a
//     lane at its depth cap only ends its sample.  Each expression keeps
//     its form and order, so the step's results are those of the
//     every-branch step it replaced;
//   - the lane state (12 f32: o, d, tp, acc; 3 i32: s, b, n_done) stays in
//     registers; the sphere, material, sky and camera tables are copied
//     into shared memory at block start and read as broadcasts;
//   - the camera mode and the diffuse model are template parameters.
//   fused_rtiow_steps keeps the step mode (n_steps steps of every lane, the
//   counterpart of the TPU kernel's launch) on the same rtiow_step.
//
// Numerics: built with -fmad=false and without --use_fast_math, so every
// a*b+c rounds twice, as in the JAX package and in the plain PyTorch
// version (ops/fused_rtiow.py::_steps_plain); the operation order of every
// expression is the TPU kernel's.  (1 - cos)^5 is x * ((x * x) * (x * x)),
// the products XLA expands the integer power into; u^(1/3) is powf, as
// torch.pow on the card; rsqrtf, as torch.rsqrt on the card (the plain
// version normalizes with ops/fused.py::_norm3, as csrc/fused_mc.cu).

#include <cfloat>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SPH_W = 8, MAT_W = 8;
constexpr int TERM_BATCH = 4;   // terms a pixel's sum loads at once
constexpr float NO_HIT = FLT_MAX;
constexpr float TWO_PI = 6.28318530717958647692f;  // f32(2 pi)
constexpr float ONE_THIRD = 1.0f / 3.0f;           // f32(1 / 3)
constexpr uint32_t N_STREAMS = 8, JITTER = 0, SCATTER = 2;
// scene.py material kinds and diffuse models
constexpr float LAMBERT = 0.0f, METAL = 1.0f, DIELECTRIC = 2.0f;
constexpr int DIFFUSE_IN_SPHERE = 0, DIFFUSE_ON_SPHERE = 1,
              DIFFUSE_IN_HEMISPHERE = 2;

struct Params {
  int off_mat, off_sky, off_cam, scene_words;
  int n_sph, n_mat;
  uint32_t seed;
  int R, n_pix, width, height, n_steps;
  float t_min, aspect;
  int max_depth, spp;
};

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

// The primary ray of sample s through the stage's camera.
template <bool THINLENS>
__device__ __forceinline__ void primary(const Params& p, const float* cam,
                                        uint32_t pix, float pxf, float pyf,
                                        int s, float& ox, float& oy,
                                        float& oz, float& dx, float& dy,
                                        float& dz) {
  float j[4];
  uniforms4(p.seed, pix, s, 0, JITTER, j);
  if (THINLENS) {
    // cam: origin lower_left horizontal vertical u v lens_radius
    const float u = (pxf + j[0]) / (float)p.width;
    const float v = (((float)p.height - 1.0f - pyf) + j[1]) / (float)p.height;
    const float r_d = sqrtf(j[2]) * cam[18];
    const float phi = TWO_PI * j[3];
    const float dx_ = r_d * cosf(phi), dy_ = r_d * sinf(phi);
    ox = cam[0] + (cam[12] * dx_ + cam[15] * dy_);
    oy = cam[1] + (cam[13] * dx_ + cam[16] * dy_);
    oz = cam[2] + (cam[14] * dx_ + cam[17] * dy_);
    dx = cam[3] + u * cam[6] + v * cam[9] - ox;
    dy = cam[4] + u * cam[7] + v * cam[10] - oy;
    dz = cam[5] + u * cam[8] + v * cam[11] - oz;
  } else {
    // cam: position right true_up forward tan_half
    const float ndc_x = (pxf + j[0]) / (float)p.width * 2.0f - 1.0f;
    const float ndc_y = -((pyf + j[1]) / (float)p.height * 2.0f - 1.0f);
    const float a = ndc_x * (cam[12] * p.aspect);
    const float b = ndc_y * cam[12];
    ox = cam[0];
    oy = cam[1];
    oz = cam[2];
    dx = a * cam[3] + b * cam[6] + cam[9];
    dy = a * cam[4] + b * cam[7] + cam[10];
    dz = a * cam[5] + b * cam[8] + cam[11];
  }
  norm3(dx, dy, dz);
}

struct Lane {
  float ox, oy, oz, dx, dy, dz, tpx, tpy, tpz, axp, ayp, azp;
  int s, bb, nd;
};

__device__ __forceinline__ void load_lane(Lane& L, const float* sf,
                                          const int* si, int R, int lane) {
  L.s = si[lane]; L.bb = si[R + lane]; L.nd = si[2 * R + lane];
  L.ox = sf[0 * R + lane]; L.oy = sf[1 * R + lane]; L.oz = sf[2 * R + lane];
  L.dx = sf[3 * R + lane]; L.dy = sf[4 * R + lane]; L.dz = sf[5 * R + lane];
  L.tpx = sf[6 * R + lane]; L.tpy = sf[7 * R + lane];
  L.tpz = sf[8 * R + lane];
  L.axp = sf[9 * R + lane]; L.ayp = sf[10 * R + lane];
  L.azp = sf[11 * R + lane];
}

__device__ __forceinline__ void store_lane(const Lane& L, float* sf, int* si,
                                           int R, int lane) {
  si[lane] = L.s; si[R + lane] = L.bb; si[2 * R + lane] = L.nd;
  sf[0 * R + lane] = L.ox;  sf[1 * R + lane] = L.oy;
  sf[2 * R + lane] = L.oz;  sf[3 * R + lane] = L.dx;
  sf[4 * R + lane] = L.dy;  sf[5 * R + lane] = L.dz;
  sf[6 * R + lane] = L.tpx; sf[7 * R + lane] = L.tpy;
  sf[8 * R + lane] = L.tpz; sf[9 * R + lane] = L.axp;
  sf[10 * R + lane] = L.ayp; sf[11 * R + lane] = L.azp;
}

// sphere_from(u0, u1): uniform on the unit sphere.
__device__ __forceinline__ void sphere_sample(const float u[4], float& spx,
                                              float& spy, float& spz) {
  const float z_s = 1.0f - 2.0f * u[0];
  const float r_xy = sqrtf(fmaxf(0.0f, 1.0f - z_s * z_s));
  const float phi = TWO_PI * u[1];
  spx = r_xy * cosf(phi);
  spy = r_xy * sinf(phi);
  spz = z_s;
}

// ball_from = sphere_from * u2^(1/3).
__device__ __forceinline__ void ball_sample(const float u[4], float spx,
                                            float spy, float spz, float& blx,
                                            float& bly, float& blz) {
  const float cbrt = powf(u[2], ONE_THIRD);
  blx = spx * cbrt;
  bly = spy * cbrt;
  blz = spz * cbrt;
}

// One step of one lane: the nearest sphere; a miss adds throughput * sky;
// a hit below the depth cap scatters by its material (only that branch is
// computed); a finished sample counts and the lane starts its next one
// (a finished lane, nd >= spp, only regenerates its ray, as the every-lane
// step does).  Returns whether the step added to the accumulator; the
// term it added is (cr, cg, cb).
template <bool THINLENS, int DIFFUSE>
__device__ __forceinline__ bool rtiow_step(const Params& p, const float* sph,
                                           const float* mat, const float* sky,
                                           const float* cam, uint32_t pix,
                                           float pxf, float pyf, bool valid,
                                           Lane& L, float& cr, float& cg,
                                           float& cb) {
  const bool alive = valid && L.nd < p.spp;
  bool added = false;
  bool cont = false;
  float best_t = NO_HIT, sdx = 0.f, sdy = 0.f, sdz = 0.f;
  if (alive) {
    // --- nearest sphere, near-then-far roots ------------------------------
    float bnx = 0.f, bny = 0.f, bnz = 0.f, bmid = -1.0f;
    const float ox = L.ox, oy = L.oy, oz = L.oz;
    const float dx = L.dx, dy = L.dy, dz = L.dz;
    for (int m = 0; m < p.n_sph; ++m) {
      const float* S = sph + m * SPH_W;
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
      const float ts = (okq && t_near > p.t_min)
                           ? t_near
                           : ((okq && t_far > p.t_min) ? t_far : NO_HIT);
      if (ts < best_t) {
        // (p - c) / radius: a negative radius flips the normal (bubbles).
        const float inv_r = 1.0f / (rad == 0.0f ? 1.0f : rad);
        best_t = ts;
        bnx = (ox + ts * dx - cx) * inv_r;
        bny = (oy + ts * dy - cy) * inv_r;
        bnz = (oz + ts * dz - cz) * inv_r;
        bmid = S[4];
      }
    }

    if (!(best_t < NO_HIT)) {
      // --- a miss adds throughput * sky -----------------------------------
      float dux = dx, duy = dy, duz = dz;
      norm3(dux, duy, duz);
      const float skyw = 0.5f * (duy + 1.0f);
      cr = L.tpx * ((1.0f - skyw) * sky[0] + skyw * sky[3]);
      cg = L.tpy * ((1.0f - skyw) * sky[1] + skyw * sky[4]);
      cb = L.tpz * ((1.0f - skyw) * sky[2] + skyw * sky[5]);
      L.axp = L.axp + cr;
      L.ayp = L.ayp + cg;
      L.azp = L.azp + cb;
      added = true;
    } else if (L.bb + 1 < p.max_depth) {
      // --- facing normal, material row by id -------------------------------
      float gnx = bnx, gny = bny, gnz = bnz;
      norm3(gnx, gny, gnz);
      const bool front = (gnx * dx + gny * dy + gnz * dz) < 0.0f;
      const float nx = front ? gnx : -gnx;
      const float ny = front ? gny : -gny;
      const float nz = front ? gnz : -gnz;
      float kind = -1.0f, alr = 0.f, alg = 0.f, alb = 0.f, ior = 1.0f,
            fuzz = 0.f;
      for (int k = 0; k < p.n_mat; ++k) {
        if (bmid == (float)k) {
          const float* M = mat + k * MAT_W;
          kind = M[0];
          alr = M[1]; alg = M[2]; alb = M[3];
          ior = M[4];
          fuzz = M[5];
        }
      }
      float u[4];
      uniforms4(p.seed, pix, L.s, L.bb, SCATTER, u);
      if (kind == LAMBERT) {
        // --- the diffuse model chosen by the config ------------------------
        float spx, spy, spz, ldx, ldy, ldz;
        sphere_sample(u, spx, spy, spz);
        if (DIFFUSE == DIFFUSE_ON_SPHERE) {  // the default
          ldx = nx + spx; ldy = ny + spy; ldz = nz + spz;
        } else {
          float blx, bly, blz;
          ball_sample(u, spx, spy, spz, blx, bly, blz);
          if (DIFFUSE == DIFFUSE_IN_SPHERE) {
            ldx = nx + blx; ldy = ny + bly; ldz = nz + blz;
          } else {  // DIFFUSE_IN_HEMISPHERE
            const bool inh = (blx * nx + bly * ny + blz * nz) > 0.0f;
            ldx = inh ? blx : -blx;
            ldy = inh ? bly : -bly;
            ldz = inh ? blz : -blz;
          }
        }
        if (fabsf(ldx) < 1e-8f && fabsf(ldy) < 1e-8f && fabsf(ldz) < 1e-8f) {
          ldx = nx; ldy = ny; ldz = nz;
        }
        sdx = ldx; sdy = ldy; sdz = ldz;
        cont = true;
      } else {
        float dux = dx, duy = dy, duz = dz;
        norm3(dux, duy, duz);
        const float ddn = dux * nx + duy * ny + duz * nz;
        const float rfx = dux - 2.0f * ddn * nx;
        const float rfy = duy - 2.0f * ddn * ny;
        const float rfz = duz - 2.0f * ddn * nz;
        if (kind == METAL) {
          // --- mirror + fuzz, absorbed below the surface -------------------
          float spx, spy, spz, blx, bly, blz;
          sphere_sample(u, spx, spy, spz);
          ball_sample(u, spx, spy, spz, blx, bly, blz);
          sdx = rfx + fuzz * blx;
          sdy = rfy + fuzz * bly;
          sdz = rfz + fuzz * blz;
          cont = (sdx * nx + sdy * ny + sdz * nz) > 0.0f;
        } else {
          // --- DIELECTRIC (and a kind of no row): Schlick coin or total
          // internal reflection ----------------------------------------------
          const float eta = front ? 1.0f / ior : ior;
          const float cos_t = fminf(-(dux * nx + duy * ny + duz * nz), 1.0f);
          const float sin_t = sqrtf(fmaxf(0.0f, 1.0f - cos_t * cos_t));
          const bool cannot = eta * sin_t > 1.0f;
          float r0 = (1.0f - eta) / (1.0f + eta);
          r0 = r0 * r0;
          const float x = 1.0f - cos_t, x2 = x * x;
          const float refl_p = r0 + (1.0f - r0) * (x * (x2 * x2));
          if (cannot || (refl_p > u[3])) {
            sdx = rfx; sdy = rfy; sdz = rfz;
          } else {
            const float sin2r = eta * eta * fmaxf(0.0f, 1.0f - cos_t * cos_t);
            const float cosr = sqrtf(fmaxf(0.0f, 1.0f - sin2r));
            const bool tir = sin2r > 1.0f;
            sdx = tir ? 0.0f : eta * dux + (eta * cos_t - cosr) * nx;
            sdy = tir ? 0.0f : eta * duy + (eta * cos_t - cosr) * ny;
            sdz = tir ? 0.0f : eta * duz + (eta * cos_t - cosr) * nz;
          }
          cont = true;
        }
      }
      if (cont) {
        norm3(sdx, sdy, sdz);
        const bool is_g = kind == DIELECTRIC;
        L.tpx = L.tpx * (is_g ? 1.0f : alr);
        L.tpy = L.tpy * (is_g ? 1.0f : alg);
        L.tpz = L.tpz * (is_g ? 1.0f : alb);
      }
    }
    if (!cont) {
      L.nd += 1;
      L.s += 1;
    }
  }

  // --- the lane continues its path or starts its next sample --------------
  if (cont) {
    L.ox = L.ox + best_t * L.dx;
    L.oy = L.oy + best_t * L.dy;
    L.oz = L.oz + best_t * L.dz;
    L.dx = sdx; L.dy = sdy; L.dz = sdz;
    L.bb += 1;
  } else {
    primary<THINLENS>(p, cam, pix, pxf, pyf, L.s, L.ox, L.oy, L.oz, L.dx,
                      L.dy, L.dz);
    L.tpx = 1.0f; L.tpy = 1.0f; L.tpz = 1.0f;
    L.bb = 0;
  }
  return added;
}

__device__ __forceinline__ void load_tables(float* sm, const float* scene_g,
                                            int words) {
  for (int i = threadIdx.x; i < words; i += blockDim.x) sm[i] = scene_g[i];
  __syncthreads();
}

// Step mode: every lane, n_steps steps, state in place.
template <bool THINLENS, int DIFFUSE>
__global__ void __launch_bounds__(256)
fused_rtiow_kernel(const Params p, const float* __restrict__ scene_g,
                   float* __restrict__ sf, int* __restrict__ si) {
  extern __shared__ float sm[];
  load_tables(sm, scene_g, p.scene_words);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.R) return;
  const uint32_t pix = (uint32_t)lane;
  const bool valid = pix < (uint32_t)p.n_pix;
  const float pxf = (float)(lane % p.width);
  const float pyf = (float)(lane / p.width);
  Lane L;
  load_lane(L, sf, si, p.R, lane);
  float cr, cg, cb;
  for (int step = 0; step < p.n_steps; ++step)
    rtiow_step<THINLENS, DIFFUSE>(p, sm, sm + p.off_mat, sm + p.off_sky,
                                  sm + p.off_cam, pix, pxf, pyf, valid, L,
                                  cr, cg, cb);
  store_lane(L, sf, si, p.R, lane);
}

// The next pixel for each calling thread, one atomicAdd per coalesced
// group of a warp.
__device__ __forceinline__ int claim(int* next) {
  namespace cg = cooperative_groups;
  cg::coalesced_group g = cg::coalesced_threads();
  int base = 0;
  if (g.thread_rank() == 0) base = atomicAdd(next, (int)g.size());
  return g.shfl(base, 0) + (int)g.thread_rank();
}

// Where the render keeps the terms of a pixel's later sample chunks: chunk
// k >= 1 of pixel x writes its count to counts[(k - 1) * R + x] and its
// terms, in sample order, to contrib[((k - 1) * R + x) * cap + j] (rgb and
// a pad, cap = the longest chunk's samples).  tickets (R,) start at zero.
struct Chunks {
  int n, cap;
  float4* contrib;
  int* counts;
  int* tickets;
};

// One work item: chunk k of pixel `lane`, its samples up to s1, and the
// terms it has recorded.
struct Item {
  int lane, k, s1, n_terms;
  float pxf, pyf;
};

template <bool THINLENS>
__device__ __forceinline__ void start_item(const Params& p, const float* cam,
                                           const float* sf, const int* si,
                                           int C, int w, Item& it, Lane& L) {
  it.lane = w / C;
  it.k = w - it.lane * C;
  it.s1 = (int)((long long)p.spp * (it.k + 1) / C);
  it.n_terms = 0;
  it.pxf = (float)(it.lane % p.width);
  it.pyf = (float)(it.lane / p.width);
  if (it.k == 0) {
    load_lane(L, sf, si, p.R, it.lane);
    return;
  }
  L.s = L.nd = (int)((long long)p.spp * it.k / C);
  L.bb = 0;
  L.tpx = L.tpy = L.tpz = 1.0f;
  L.axp = L.ayp = L.azp = 0.0f;
  primary<THINLENS>(p, cam, (uint32_t)it.lane, it.pxf, it.pyf, L.s, L.ox,
                    L.oy, L.oz, L.dx, L.dy, L.dz);
}

__device__ __forceinline__ size_t term_slot(int R, const Item& it) {
  return (size_t)(it.k - 1) * R + it.lane;
}

template <bool THINLENS>
__device__ __forceinline__ void finish_item(const Params& p, const float* cam,
                                            float* sf, int* si,
                                            const Chunks& ch, const Item& it,
                                            Lane& L) {
  const int R = p.R, C = ch.n, lane = it.lane;
  if (C == 1) {
    store_lane(L, sf, si, R, lane);
    return;
  }
  // Nothing but chunk 0's sum goes to the planes before the pixel's last
  // chunk is done: chunk 0 may still be reading its starting state.
  if (it.k == 0) {
    sf[9 * R + lane] = L.axp;
    sf[10 * R + lane] = L.ayp;
    sf[11 * R + lane] = L.azp;
  } else {
    ch.counts[term_slot(R, it)] = it.n_terms;
  }
  __threadfence();   // this chunk's writes before its ticket
  if (atomicAdd(ch.tickets + lane, 1) != C - 1) return;
  // The pixel's last chunk to finish: chunk 0's sum, then each later
  // chunk's terms in sample order.
  float ar = it.k == 0 ? L.axp : __ldcg(sf + 9 * R + lane);
  float ag = it.k == 0 ? L.ayp : __ldcg(sf + 10 * R + lane);
  float ab = it.k == 0 ? L.azp : __ldcg(sf + 11 * R + lane);
  for (int kk = 1; kk < C; ++kk) {
    const size_t sl = (size_t)(kk - 1) * R + lane;
    const int n = __ldcg(ch.counts + sl);
    const float4* t = ch.contrib + sl * ch.cap;
    // TERM_BATCH loads in flight, then their sums in order
    for (int j0 = 0; j0 < n; j0 += TERM_BATCH) {
      float4 b[TERM_BATCH];
#pragma unroll
      for (int j = 0; j < TERM_BATCH; ++j)
        if (j0 + j < n) b[j] = __ldcg(t + j0 + j);
#pragma unroll
      for (int j = 0; j < TERM_BATCH; ++j) {
        if (j0 + j < n) {
          ar = ar + b[j].x;
          ag = ag + b[j].y;
          ab = ab + b[j].z;
        }
      }
    }
  }
  // The pixel's final state, as its last sample leaves it: the ray of
  // sample spp, unit throughput, bounce 0.
  L.s = L.nd = p.spp;
  L.bb = 0;
  L.tpx = L.tpy = L.tpz = 1.0f;
  primary<THINLENS>(p, cam, (uint32_t)lane, it.pxf, it.pyf, L.s, L.ox, L.oy,
                    L.oz, L.dx, L.dy, L.dz);
  L.axp = ar;
  L.ayp = ag;
  L.azp = ab;
  store_lane(L, sf, si, R, lane);
}

// Render mode: each thread takes work items from *next (zero at launch)
// until none is left.  Item w is chunk w % C of pixel w / C, its samples
// [spp k / C, spp (k + 1) / C).  Chunk 0 starts from the state planes
// (sample 0's ray of the stage's camera) and accumulates; a later chunk
// starts from its first sample's regenerated ray and records each term it
// adds.  A thread that finishes its item takes the next one at once,
// inside the step loop, so the other lanes of its warp keep stepping.
// With C = 1 the thread writes the lane state back.  With C > 1 the last
// chunk of a pixel to finish (a ticket per pixel, taken after a
// __threadfence) adds the recorded terms to chunk 0's sum in sample order,
// so the sum is the lockstep schedule's bit for bit, and writes the state
// the pixel's last sample leaves.
template <bool THINLENS, int DIFFUSE>
__global__ void __launch_bounds__(256, 4)
fused_rtiow_render_kernel(const Params p, const float* __restrict__ scene_g,
                          float* __restrict__ sf, int* __restrict__ si,
                          int* __restrict__ next, const Chunks ch) {
  extern __shared__ float sm[];
  load_tables(sm, scene_g, p.scene_words);
  const float* cam = sm + p.off_cam;
  const int items = p.R * ch.n;
  int w = claim(next);
  if (w >= items) return;
  Item it;
  Lane L;
  start_item<THINLENS>(p, cam, sf, si, ch.n, w, it, L);
  while (true) {
    if (L.nd >= it.s1) {
      finish_item<THINLENS>(p, cam, sf, si, ch, it, L);
      w = claim(next);
      if (w >= items) break;
      start_item<THINLENS>(p, cam, sf, si, ch.n, w, it, L);
      continue;
    }
    float cr, cg, cb;
    const bool added = rtiow_step<THINLENS, DIFFUSE>(
        p, sm, sm + p.off_mat, sm + p.off_sky, cam, (uint32_t)it.lane,
        it.pxf, it.pyf, true, L, cr, cg, cb);
    if (it.k > 0 && added)
      ch.contrib[term_slot(p.R, it) * ch.cap + it.n_terms++] =
          make_float4(cr, cg, cb, 0.0f);
  }
}

size_t scene_smem(const Params& p) {
  return (size_t)p.scene_words * sizeof(float);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// Resident blocks of the render kernel: (blocks per SM, SMs).
template <bool THINLENS, int DIFFUSE>
cudaError_t render_slots(size_t smem, int* per_sm, int* n_sm) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = allow_smem(fused_rtiow_render_kernel<THINLENS, DIFFUSE>, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, fused_rtiow_render_kernel<THINLENS, DIFFUSE>, 256, smem);
  return e;
}

template <bool THINLENS>
cudaError_t render_slots_diffuse(int diffuse_model, size_t smem, int* per_sm,
                                 int* n_sm) {
  switch (diffuse_model) {
    case DIFFUSE_IN_SPHERE:
      return render_slots<THINLENS, DIFFUSE_IN_SPHERE>(smem, per_sm, n_sm);
    case DIFFUSE_ON_SPHERE:
      return render_slots<THINLENS, DIFFUSE_ON_SPHERE>(smem, per_sm, n_sm);
    case DIFFUSE_IN_HEMISPHERE:
      return render_slots<THINLENS, DIFFUSE_IN_HEMISPHERE>(smem, per_sm, n_sm);
    default:
      return cudaErrorInvalidValue;
  }
}

// What the render mode takes besides the planes: the work-item counter
// (zero) and the sample chunks.
struct RenderArgs {
  int* next;
  Chunks ch;
};

// mode 0: n_steps steps of every lane; 1: the whole render.
template <bool THINLENS, int DIFFUSE>
int launch(const Params& p, int mode, const float* scene, float* sf,
           int* si, const RenderArgs& ra, cudaStream_t stream) {
  const size_t smem = scene_smem(p);
  const int threads = 256;
  if (mode == 0) {
    const cudaError_t e =
        allow_smem(fused_rtiow_kernel<THINLENS, DIFFUSE>, smem);
    if (e != cudaSuccess) return (int)e;
    const int blocks = (p.R + threads - 1) / threads;
    fused_rtiow_kernel<THINLENS, DIFFUSE><<<blocks, threads, smem, stream>>>(
        p, scene, sf, si);
    return (int)cudaGetLastError();
  }
  int per_sm = 0, n_sm = 0;
  const cudaError_t e = render_slots<THINLENS, DIFFUSE>(smem, &per_sm, &n_sm);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long items = (long long)p.R * ra.ch.n;
  const long long need = (items + threads - 1) / threads;
  const int blocks = (int)(per_sm * n_sm < need ? per_sm * n_sm : need);
  fused_rtiow_render_kernel<THINLENS, DIFFUSE>
      <<<blocks, threads, smem, stream>>>(p, scene, sf, si, ra.next, ra.ch);
  return (int)cudaGetLastError();
}

template <bool THINLENS>
int launch_diffuse(const Params& p, int diffuse_model, int mode,
                   const float* scene, float* sf, int* si,
                   const RenderArgs& ra, cudaStream_t stream) {
  switch (diffuse_model) {
    case DIFFUSE_IN_SPHERE:
      return launch<THINLENS, DIFFUSE_IN_SPHERE>(p, mode, scene, sf, si, ra,
                                                 stream);
    case DIFFUSE_ON_SPHERE:
      return launch<THINLENS, DIFFUSE_ON_SPHERE>(p, mode, scene, sf, si, ra,
                                                 stream);
    case DIFFUSE_IN_HEMISPHERE:
      return launch<THINLENS, DIFFUSE_IN_HEMISPHERE>(p, mode, scene, sf, si,
                                                     ra, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int run(const float* scene, int scene_words, int n_sph, int n_mat,
        uint32_t seed, float* sf, int* si, int R, int n_pix, int width,
        int height, int n_steps, float t_min, float aspect, int max_depth,
        int spp, int diffuse_model, int thinlens, int mode,
        const RenderArgs& ra, void* stream) {
  Params p;
  p.n_sph = n_sph;
  p.n_mat = n_mat;
  p.off_mat = (n_sph > 1 ? n_sph : 1) * SPH_W;
  p.off_sky = p.off_mat + n_mat * MAT_W;
  p.off_cam = p.off_sky + 8;
  p.scene_words = scene_words;
  if (p.off_cam + 24 != scene_words) return (int)cudaErrorInvalidValue;
  // the render mode runs the image's pixels only, in 1 to spp chunks
  if (mode == 1 &&
      (R != n_pix || ra.next == nullptr || ra.ch.n < 1 || ra.ch.n > spp ||
       (long long)R * ra.ch.n > 0x7fffffff ||
       (ra.ch.n > 1 && (ra.ch.contrib == nullptr || ra.ch.counts == nullptr ||
                        ra.ch.tickets == nullptr ||
                        ra.ch.cap < (spp + ra.ch.n - 1) / ra.ch.n))))
    return (int)cudaErrorInvalidValue;
  p.seed = seed;
  p.R = R;
  p.n_pix = n_pix;
  p.width = width;
  p.height = height;
  p.n_steps = n_steps;
  p.t_min = t_min;
  p.aspect = aspect;
  p.max_depth = max_depth;
  p.spp = spp;
  const cudaStream_t st = (cudaStream_t)stream;
  return thinlens ? launch_diffuse<true>(p, diffuse_model, mode, scene, sf,
                                         si, ra, st)
                  : launch_diffuse<false>(p, diffuse_model, mode, scene, sf,
                                          si, ra, st);
}

}  // namespace

// Advances every lane of the (12, R) f32 / (3, R) i32 state planes by
// n_steps steps, in place, on `stream`.  `scene` is the concatenation
// sph (max(n_sph, 1), 8) | mat (n_mat, 8) | sky (8) | cam (24),
// `scene_words` floats in all.  `thinlens`: 1 for the thin-lens camera, 0
// for the perspective one.  Returns cudaGetLastError().
extern "C" int fused_rtiow_steps(const float* scene, int scene_words,
                                 int n_sph, int n_mat, uint32_t seed,
                                 float* sf, int* si, int R, int n_pix,
                                 int width, int height, int n_steps,
                                 float t_min, float aspect, int max_depth,
                                 int spp, int diffuse_model, int thinlens,
                                 void* stream) {
  return run(scene, scene_words, n_sph, n_mat, seed, sf, si, R, n_pix, width,
             height, n_steps, t_min, aspect, max_depth, spp, diffuse_model,
             thinlens, 0, RenderArgs{}, stream);
}

// Runs every pixel (R == n_pix) of the state planes to its last sample in
// one launch, in place; the planes end as the step mode leaves them once
// every lane is done.  `next`: an int the caller zeroes.  Each pixel's
// samples run in `chunks` chunks (1 to spp); for chunks > 1, scratch of
// (chunks - 1) * R * cap * 4 f32 `contrib` and (chunks - 1) * R i32
// `counts`, cap >= ceil(spp / chunks), and R i32 `tickets` the caller
// zeroes.
extern "C" int fused_rtiow_render(const float* scene, int scene_words,
                                  int n_sph, int n_mat, uint32_t seed,
                                  float* sf, int* si, int R, int width,
                                  int height, float t_min, float aspect,
                                  int max_depth, int spp, int diffuse_model,
                                  int thinlens, int chunks, int cap,
                                  float* contrib, int* counts, int* tickets,
                                  int* next, void* stream) {
  const RenderArgs ra{next,
                      Chunks{chunks, cap, reinterpret_cast<float4*>(contrib),
                             counts, tickets}};
  return run(scene, scene_words, n_sph, n_mat, seed, sf, si, R, R, width,
             height, 0, t_min, aspect, max_depth, spp, diffuse_model,
             thinlens, 1, ra, stream);
}

// The render kernel's resident blocks of 256 per SM and the SM count, for
// a scene of scene_words floats, into out[0], out[1].  Launches nothing.
extern "C" int fused_rtiow_render_slots(int scene_words, int diffuse_model,
                                        int thinlens, int* out) {
  if (scene_words <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)scene_words * sizeof(float);
  return (int)(thinlens ? render_slots_diffuse<true>(diffuse_model, smem,
                                                     out, out + 1)
                        : render_slots_diffuse<false>(diffuse_model, smem,
                                                      out, out + 1));
}
