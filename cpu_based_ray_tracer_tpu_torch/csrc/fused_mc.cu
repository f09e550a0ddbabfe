// fused_mc.cu — persistent-wavefront Monte Carlo bounce kernel for Hopper
// (sm_90a), the Cornell path tracer's whole bounce step in one launch.
//
// Replaces: cpu_based_ray_tracer_tpu/ops/fused.py::_kernel, the Pallas TPU
// kernel launched by _run from wavefront_steps_fused (plain and stop_after
// modes) and from single_sample_gbuffer (single_path mode: quota 1, the
// sample index pinned, the primary hit's 8-plane G-buffer written at the
// launch's first step — the Denoiser frame).
//
// What bounds it on this card: arithmetic.  Each live lane-step runs two
// Moller-Trumbore passes over every triangle (main hit, then the shadow
// ray), ~100 f32 operations per triangle, about 3,200 per lane-step on the
// 32-triangle Cornell box, against 76 bytes of lane state read and written
// once per lane (not per step).  It is bound by the FP32 pipes
// (132 SMs x 128 lanes per clock), not by memory.  In the gated modes most
// lane-steps of a launch fall on lanes whose quota is met: a 16-step
// single_path launch holds paths of about 3 steps, and the 4-spp render's
// 96 steps about 12 live steps a pixel.
//
// What the design does about it:
//   - persistent threads, as many as the card keeps resident, take lanes
//     from a counter; a thread steps its lane in registers until the lane
//     has run the launch's n_steps or has retired, writes it once and
//     takes the next.  A lane retires (stop_after and single_path) at the
//     end of the step that meets its quota: that step regenerated its path
//     and left cur and acc unchanged by adding 0, so every later step would
//     regenerate the same camera ray, add +0 and count nothing, and the
//     planes are those of the lockstep launch, bit for bit (a lane that
//     enters the launch at that fixed point takes no step).  As in the TPU
//     kernel, the NEE term and the finished sample are added masked (+0
//     where they add nothing).  Finished lanes cost no steps, and no
//     thread waits for its warp's slowest lane (the refill is inside the
//     step loop).  The plain mode keeps every lane for n_steps;
//   - the scene pack (triangles, spheres, lights, sky, camera words) is
//     copied into shared memory at block start; every thread of a warp
//     reads the same primitive at the same time, so each read is a
//     broadcast;
//   - the shadow test is the division-free accept of the TPU kernel: sign
//     comparisons of the numerators against |det|-scaled bounds, no
//     reciprocal per triangle;
//   - the triangle rows are read from shared memory as float4; the main
//     pass keeps the winning triangle's index and reads its attributes
//     once after the loop, and is unrolled by two; the light sample and
//     the shadow test run only for a lane that traces a shadow ray (alive
//     and a light to sample), the NEE term added only there.  Each leaves
//     every result as it was, bit for bit.
//
// Numerics: built with -fmad=false and without --use_fast_math, so every
// a*b+c rounds twice, as in the JAX package and in the plain PyTorch
// version (ops/fused.py::_steps_plain); the operation order of every
// expression is the TPU kernel's.  rsqrtf matches torch.rsqrt on CUDA.

#include <cfloat>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int TRI_W = 20, SPH_W = 16, LGT_W = 16;
constexpr float NO_HIT = FLT_MAX;
constexpr float DET_EPS = 1e-12f;
constexpr float TWO_PI = 6.28318530717958647692f;  // f32(2 pi)
constexpr float INV_PI = 0.31830988618379067154f;  // f32(1 / pi)
constexpr uint32_t N_STREAMS = 8, JITTER = 0, SCATTER = 2, LIGHT = 4;

struct Params {
  int off_sph, off_light, off_sky, off_cam, scene_words;
  int n_tri, n_sph, n_light;
  uint32_t seed;
  int R, n_pix, width, height, n_steps;
  float t_min, eps_offset, rr_survival, inv_rr, shadow_tol, aspect;
  int max_depth, stop_after;
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

// A lane's state: the (15, R) f32 planes [o d tp cur acc] and the (4, R)
// i32 planes [s b n_done shadow rays of this launch].
struct Lane {
  float ox, oy, oz, dx, dy, dz, tpx, tpy, tpz, cux, cuy, cuz, axp, ayp, azp;
  int s, bb, nd, nsh;
};

__device__ __forceinline__ void load_lane(const float* sf, const int* si,
                                          int R, int lane, Lane& L) {
  L.s = si[lane]; L.bb = si[R + lane]; L.nd = si[2 * R + lane]; L.nsh = 0;
  L.ox = sf[0 * R + lane]; L.oy = sf[1 * R + lane]; L.oz = sf[2 * R + lane];
  L.dx = sf[3 * R + lane]; L.dy = sf[4 * R + lane]; L.dz = sf[5 * R + lane];
  L.tpx = sf[6 * R + lane]; L.tpy = sf[7 * R + lane];
  L.tpz = sf[8 * R + lane];
  L.cux = sf[9 * R + lane]; L.cuy = sf[10 * R + lane];
  L.cuz = sf[11 * R + lane];
  L.axp = sf[12 * R + lane]; L.ayp = sf[13 * R + lane];
  L.azp = sf[14 * R + lane];
}

__device__ __forceinline__ void store_lane(float* sf, int* si, int R,
                                           int lane, const Lane& L) {
  si[lane] = L.s; si[R + lane] = L.bb; si[2 * R + lane] = L.nd;
  si[3 * R + lane] = L.nsh;
  sf[0 * R + lane] = L.ox; sf[1 * R + lane] = L.oy; sf[2 * R + lane] = L.oz;
  sf[3 * R + lane] = L.dx; sf[4 * R + lane] = L.dy; sf[5 * R + lane] = L.dz;
  sf[6 * R + lane] = L.tpx; sf[7 * R + lane] = L.tpy;
  sf[8 * R + lane] = L.tpz;
  sf[9 * R + lane] = L.cux; sf[10 * R + lane] = L.cuy;
  sf[11 * R + lane] = L.cuz;
  sf[12 * R + lane] = L.axp; sf[13 * R + lane] = L.ayp;
  sf[14 * R + lane] = L.azp;
}

// v0, e1, e2 of a triangle row (TRI_W floats, 16-byte aligned).
__device__ __forceinline__ void tri_edges(const float* T, float v[9]) {
  const float4 a = *reinterpret_cast<const float4*>(T);
  const float4 b = *reinterpret_cast<const float4*>(T + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  v[8] = T[8];
}

// The camera ray of sample s of pixel pix (the JITTER stream), in the
// operation order of camera.perspective_ray_at.
__device__ __forceinline__ void camera_ray(const Params& p, const float* cam,
                                           uint32_t pix, int s, float pxf,
                                           float pyf, float& x, float& y,
                                           float& z) {
  float uj[4];
  uniforms4(p.seed, pix, s, 0, JITTER, uj);
  const float tan_half = cam[12];
  const float ndc_x = (pxf + uj[0]) / (float)p.width * 2.0f - 1.0f;
  const float ndc_y = -((pyf + uj[1]) / (float)p.height * 2.0f - 1.0f);
  const float ta = tan_half * p.aspect;
  const float a = ndc_x * ta;
  const float b = ndc_y * tan_half;
  x = a * cam[3] + b * cam[6] + cam[9];
  y = a * cam[4] + b * cam[7] + cam[10];
  z = a * cam[5] + b * cam[8] + cam[11];
  norm3(x, y, z);
}

__device__ __forceinline__ bool same_bits(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b);
}

// x + 0 == x bit for bit (false for -0.0 and for a NaN the add would
// change).
__device__ __forceinline__ bool adds_zero_exactly(float x) {
  return same_bits(x + 0.0f, x);
}

// cur and acc unchanged by adding 0, what a step of a lane whose quota is
// met adds to each.
__device__ __forceinline__ bool sums_settled(const Lane& L) {
  return adds_zero_exactly(L.cux) && adds_zero_exactly(L.cuy) &&
         adds_zero_exactly(L.cuz) && adds_zero_exactly(L.axp) &&
         adds_zero_exactly(L.ayp) && adds_zero_exactly(L.azp);
}

// A stop_after lane that a step leaves as it is: quota met, its path just
// regenerated (b = 0, o the camera, d the camera ray of sample s, tp = 1),
// and its sums settled.  It also counts nothing, and regenerates the same
// ray at every later step.  A step at whose end a lane's quota is met
// leaves the lane there but for its sums: the step that meets the quota
// adds cur to acc, and -0.0 + -0.0 stays -0.0 where the next step's +0
// would make it +0.0.
__device__ __forceinline__ bool at_fixed_point(const Params& p,
                                               const float* cam, uint32_t pix,
                                               float pxf, float pyf,
                                               const Lane& L) {
  if (!(L.nd >= p.stop_after && L.bb == 0 && sums_settled(L) &&
        same_bits(L.ox, cam[0]) &&
        same_bits(L.oy, cam[1]) && same_bits(L.oz, cam[2]) &&
        same_bits(L.tpx, 1.0f) && same_bits(L.tpy, 1.0f) &&
        same_bits(L.tpz, 1.0f)))
    return false;
  float x, y, z;
  camera_ray(p, cam, pix, L.s, pxf, pyf, x, y, z);
  return same_bits(L.dx, x) && same_bits(L.dy, y) && same_bits(L.dz, z);
}

// One bounce step of one lane, the TPU kernel's step in its operation
// order.  SINGLE_PATH: a template parameter, so the plain and stop_after
// modes compile without the G-buffer code.  `first`: the lane's first step
// of the launch (single_path writes the G-buffer there).
template <bool SINGLE_PATH>
__device__ __forceinline__ void mc_step(const Params& p, const float* tri,
                                        const float* sph, const float* lgt,
                                        const float* sky, const float* cam,
                                        uint32_t pix, bool valid, float pxf,
                                        float pyf, bool first, float* gb,
                                        int lane, Lane& L) {
  const int R = p.R;
  const float light_total = sky[6];
  const bool light_valid = light_total > 0.0f;
  const float light_pdf =
      light_valid ? 1.0f / fmaxf(light_total, 1e-20f) : 0.0f;
  const int quota = SINGLE_PATH ? 1 : p.stop_after;
  const bool gated = quota > 0;
  const float ox = L.ox, oy = L.oy, oz = L.oz;
  const float dx = L.dx, dy = L.dy, dz = L.dz;
  const bool armed = L.nd < quota;
  const bool alive0 = gated ? (valid && armed) : valid;

  // --- main intersect: Moller-Trumbore over triangles, then spheres ---------
  float best_t = NO_HIT, bnx = 0.f, bny = 0.f, bnz = 0.f;
  float al0 = 0.f, al1 = 0.f, al2 = 0.f, em0 = 0.f, em1 = 0.f, em2 = 0.f;
  float bef = 0.f;
  float bpid = 0.f;  // global primitive id (single_path's G-buffer)
  int best_n = -1;   // the winning triangle, its attributes read after
#pragma unroll 2
  for (int n = 0; n < p.n_tri; ++n) {
    float v[9];
    tri_edges(tri + n * TRI_W, v);
    const float v0x = v[0], v0y = v[1], v0z = v[2];
    const float e1x = v[3], e1y = v[4], e1z = v[5];
    const float e2x = v[6], e2y = v[7], e2z = v[8];
    const float s1x = dy * e2z - dz * e2y;
    const float s1y = dz * e2x - dx * e2z;
    const float s1z = dx * e2y - dy * e2x;
    const float det = s1x * e1x + s1y * e1y + s1z * e1z;
    const bool okd = fabsf(det) > DET_EPS;
    const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
    const float s2x = sy * e1z - sz * e1y;
    const float s2y = sz * e1x - sx * e1z;
    const float s2z = sx * e1y - sy * e1x;
    const float tn = s2x * e2x + s2y * e2y + s2z * e2z;
    const float b1n = s1x * sx + s1y * sy + s1z * sz;
    const float b2n = s2x * dx + s2y * dy + s2z * dz;
    const float inv = 1.0f / (okd ? det : 1.0f);
    const float t = tn * inv;
    const float b1 = b1n * inv;
    const float b2 = b2n * inv;
    const bool ok = okd && (t > p.t_min) && (b1 >= 0.0f) && (b2 >= 0.0f) &&
                    (1.0f - b1 - b2 >= 0.0f) && (t < best_t);
    if (ok) {
      best_t = t;
      best_n = n;
    }
  }
  if (best_n >= 0) {
    const float* T = tri + best_n * TRI_W;
    bnx = T[9]; bny = T[10]; bnz = T[11];
    al0 = T[12]; al1 = T[13]; al2 = T[14];
    em0 = T[15]; em1 = T[16]; em2 = T[17];
    bef = T[18];
  }
  if (SINGLE_PATH) bpid = (float)(best_n + 1);
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
    const bool near_ok = okq && (t_near > p.t_min);
    const bool far_ok = okq && (t_far > p.t_min);
    const float ts = near_ok ? t_near : (far_ok ? t_far : NO_HIT);
    if (ts < best_t) {
      // Geometric normal (p - c) / radius: a negative radius flips it.
      const float inv_r = 1.0f / (rad == 0.0f ? 1.0f : rad);
      const float hpx = ox + ts * dx, hpy = oy + ts * dy, hpz = oz + ts * dz;
      best_t = ts;
      bnx = (hpx - cx) * inv_r;
      bny = (hpy - cy) * inv_r;
      bnz = (hpz - cz) * inv_r;
      al0 = S[4]; al1 = S[5]; al2 = S[6];
      em0 = S[7]; em1 = S[8]; em2 = S[9];
      bef = S[10];
      if (SINGLE_PATH) bpid = (float)(p.n_tri + m + 1);
    }
  }

  const bool hit = best_t < NO_HIT;
  const bool hit_emissive = hit && (bef > 0.5f);
  const bool is_primary = L.bb == 0;

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
  L.cux = L.cux + L.tpx * drx;
  L.cuy = L.cuy + L.tpy * dry;
  L.cuz = L.cuz + L.tpz * drz;

  const bool alive = alive0 && hit && !hit_emissive;
  L.nsh += alive ? 1 : 0;

  // Facing normal + epsilon-offset shading point.
  const bool front = (bnx * dx + bny * dy + bnz * dz) < 0.0f;
  float gnx = bnx, gny = bny, gnz = bnz;
  norm3(gnx, gny, gnz);
  const float nxp = front ? gnx : -gnx;
  const float nyp = front ? gny : -gny;
  const float nzp = front ? gnz : -gnz;
  const float t_pt = hit ? best_t : 1.0f;
  const float hx = ox + t_pt * dx + nxp * p.eps_offset;
  const float hy = oy + t_pt * dy + nyp * p.eps_offset;
  const float hz = oz + t_pt * dz + nzp * p.eps_offset;
  if (SINGLE_PATH && first) {
    // The primary hit: world position without the eps offset, facing
    // normal, global primitive id (-1 on a miss), contributor flag.
    gb[0 * R + lane] = ox + t_pt * dx;
    gb[1 * R + lane] = oy + t_pt * dy;
    gb[2 * R + lane] = oz + t_pt * dz;
    gb[3 * R + lane] = nxp;
    gb[4 * R + lane] = nyp;
    gb[5 * R + lane] = nzp;
    gb[6 * R + lane] = hit ? bpid : -1.0f;
    gb[7 * R + lane] = hit ? 1.0f : 0.0f;
  }

  // --- NEE: one area-light sample -------------------------------------------
  if (alive && light_valid) {
    float ul[4];
    uniforms4(p.seed, pix, L.s, L.bb, LIGHT, ul);
    const float budget = ul[0] * light_total;
    int le = 0;
    for (int e = 1; e < p.n_light; ++e)
      if (lgt[(e - 1) * LGT_W + 15] <= budget) le = e;
    const float* Lr = lgt + le * LGT_W;
    const float xw = 1.0f - sqrtf(ul[1]);
    const float w1 = (1.0f - xw) * ul[2];
    const float w2 = (1.0f - xw) * (1.0f - ul[2]);
    const float lpx = Lr[0] + w1 * Lr[3] + w2 * Lr[6];
    const float lpy = Lr[1] + w1 * Lr[4] + w2 * Lr[7];
    const float lpz = Lr[2] + w1 * Lr[5] + w2 * Lr[8];
    const float tlx = lpx - hx, tly = lpy - hy, tlz = lpz - hz;
    const float dist = sqrtf(fmaxf(tlx * tlx + tly * tly + tlz * tlz, 0.0f));
    const float invd = 1.0f / fmaxf(dist, 1e-20f);
    const float wlx = tlx * invd, wly = tly * invd, wlz = tlz * invd;
    const bool flip_l = (Lr[9] * -wlx + Lr[10] * -wly + Lr[11] * -wlz) < 0.0f;
    const float lnx2 = flip_l ? -Lr[9] : Lr[9];
    const float lny2 = flip_l ? -Lr[10] : Lr[10];
    const float lnz2 = flip_l ? -Lr[11] : Lr[11];

    // Shadow ray: occluded iff any hit lands at t <= dist - tol, with the
    // division-free accept (numerators against |det|-scaled bounds).
    bool occluded = false;
    const float lim = dist - p.shadow_tol;
    for (int n = 0; n < p.n_tri; ++n) {
      float v[9];
      tri_edges(tri + n * TRI_W, v);
      const float v0x = v[0], v0y = v[1], v0z = v[2];
      const float e1x = v[3], e1y = v[4], e1z = v[5];
      const float e2x = v[6], e2y = v[7], e2z = v[8];
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
      const float* S = sph + m * SPH_W;
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
    L.cux = L.cux + L.tpx * (Lr[12] * al0 * scale);
    L.cuy = L.cuy + L.tpy * (Lr[13] * al1 * scale);
    L.cuz = L.cuz + L.tpz * (Lr[14] * al2 * scale);
  } else {
    // The TPU kernel adds its masked NEE term, +0 here: -0.0 becomes +0.0.
    L.cux = L.cux + 0.0f;
    L.cuy = L.cuy + 0.0f;
    L.cuz = L.cuz + 0.0f;
  }

  // --- indirect: RR + uniform hemisphere ------------------------------------
  float us[4];
  uniforms4(p.seed, pix, L.s, L.bb, SCATTER, us);
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
    L.tpx = L.tpx * (al0 * wt);
    L.tpy = L.tpy * (al1 * wt);
    L.tpz = L.tpz * (al2 * wt);
  }

  // --- persistent-wavefront bookkeeping -------------------------------------
  const bool cont = continues && (L.bb + 1 < p.max_depth);
  const bool done = gated ? (!cont && armed) : !cont;
  // The masked adds of the TPU kernel, +0 where they add nothing.
  L.axp = L.axp + (done ? L.cux : 0.0f);
  L.ayp = L.ayp + (done ? L.cuy : 0.0f);
  L.azp = L.azp + (done ? L.cuz : 0.0f);
  if (done) {
    L.nd += 1;
    if (!SINGLE_PATH) L.s += 1;
    L.cux = 0.0f;
    L.cuy = 0.0f;
    L.cuz = 0.0f;
  }
  if (cont) {
    L.ox = hx; L.oy = hy; L.oz = hz;
    L.dx = wix; L.dy = wiy; L.dz = wiz;
    L.bb += 1;
  } else {
    // Regenerate the camera ray of the lane's next sample (s is already
    // advanced).
    camera_ray(p, cam, pix, L.s, pxf, pyf, L.dx, L.dy, L.dz);
    L.ox = cam[0]; L.oy = cam[1]; L.oz = cam[2];
    L.tpx = 1.0f; L.tpy = 1.0f; L.tpz = 1.0f;
    L.bb = 0;
  }
}

// The next lane for each calling thread, one atomicAdd per coalesced group
// of a warp.
__device__ __forceinline__ int claim(int* next) {
  namespace cg = cooperative_groups;
  cg::coalesced_group g = cg::coalesced_threads();
  int base = 0;
  if (g.thread_rank() == 0) base = atomicAdd(next, (int)g.size());
  return g.shfl(base, 0) + (int)g.thread_rank();
}

// The scene pack into shared memory; its tables.
struct Tables {
  const float *tri, *sph, *lgt, *sky, *cam;
};

__device__ __forceinline__ Tables load_tables(const Params& p,
                                              const float* scene_g,
                                              float* sm) {
  for (int i = threadIdx.x; i < p.scene_words; i += blockDim.x)
    sm[i] = scene_g[i];
  __syncthreads();
  return Tables{sm, sm + p.off_sph, sm + p.off_light, sm + p.off_sky,
                sm + p.off_cam};
}

// The plain mode (every lane regenerates forever, so none retires): one
// thread per lane for all n_steps, the TPU kernel's schedule.
__global__ void __launch_bounds__(256)
fused_mc_kernel(const Params p, const float* __restrict__ scene_g,
                float* __restrict__ sf, int* __restrict__ si) {
  extern __shared__ float4 sm4[];
  const Tables tb = load_tables(p, scene_g, reinterpret_cast<float*>(sm4));
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.R) return;
  Lane L;
  load_lane(sf, si, p.R, lane, L);
  const uint32_t pix = (uint32_t)lane;
  const bool valid = pix < (uint32_t)p.n_pix;
  const float pxf = (float)(lane % p.width), pyf = (float)(lane / p.width);
  for (int step = 0; step < p.n_steps; ++step)
    mc_step<false>(p, tb.tri, tb.sph, tb.lgt, tb.sky, tb.cam, pix, valid,
                   pxf, pyf, false, nullptr, lane, L);
  store_lane(sf, si, p.R, lane, L);
}

// The gated modes (stop_after, single_path): persistent threads, as many
// as the card keeps resident.  Each takes a lane from the counter `next`,
// steps it until it has run the launch's n_steps or retires (its quota met
// and its sums settled at the end of a step, which leaves it at the step's
// fixed point, so the planes are the lockstep launch's), writes the lane's
// state once and takes the next lane.  The refill sits inside the step
// loop: a thread never waits for its warp.  A stop_after lane that enters
// at the fixed point takes no step (its shadow-ray count is written as 0;
// its other planes are already what the launch leaves).
template <bool SINGLE_PATH>
__global__ void __launch_bounds__(256)
fused_mc_retire_kernel(const Params p, const float* __restrict__ scene_g,
                       float* __restrict__ sf, int* __restrict__ si,
                       float* __restrict__ gb, int* __restrict__ next) {
  extern __shared__ float4 sm4[];
  const Tables tb = load_tables(p, scene_g, reinterpret_cast<float*>(sm4));
  const int R = p.R;
  const int quota = SINGLE_PATH ? 1 : p.stop_after;
  Lane L;
  int lane = -1, step = 0;
  uint32_t pix = 0;
  bool valid = false;
  float pxf = 0.0f, pyf = 0.0f;
  bool need = true;
  while (true) {
    if (need) {
      if (lane >= 0) store_lane(sf, si, R, lane, L);
      lane = claim(next);
      if (lane >= R) break;
      load_lane(sf, si, R, lane, L);
      pix = (uint32_t)lane;
      valid = pix < (uint32_t)p.n_pix;
      pxf = (float)(lane % p.width);
      pyf = (float)(lane / p.width);
      step = 0;
      if (!SINGLE_PATH && at_fixed_point(p, tb.cam, pix, pxf, pyf, L)) {
        si[3 * R + lane] = 0;
        lane = -1;
        continue;
      }
      need = false;
    }
    mc_step<SINGLE_PATH>(p, tb.tri, tb.sph, tb.lgt, tb.sky, tb.cam, pix,
                         valid, pxf, pyf, step == 0, gb, lane, L);
    ++step;
    need = step >= p.n_steps || (L.nd >= quota && sums_settled(L));
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

constexpr int THREADS = 256;

size_t scene_smem(const Params& p) {
  return (size_t)p.scene_words * sizeof(float);
}

int launch_plain(const Params& p, const float* scene, float* sf, int* si,
                 cudaStream_t stream) {
  const cudaError_t e = allow_smem(fused_mc_kernel, scene_smem(p));
  if (e != cudaSuccess) return (int)e;
  const int blocks = (p.R + THREADS - 1) / THREADS;
  fused_mc_kernel<<<blocks, THREADS, scene_smem(p), stream>>>(
      p, scene, sf, si);
  return (int)cudaGetLastError();
}

template <bool SINGLE_PATH>
int launch_retire(const Params& p, const float* scene, float* sf, int* si,
                  float* gb, int* next, cudaStream_t stream) {
  const auto kernel = fused_mc_retire_kernel<SINGLE_PATH>;
  const size_t smem = scene_smem(p);
  cudaError_t e = allow_smem(kernel, smem);
  int dev = 0, n_sm = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int need = (p.R + THREADS - 1) / THREADS;
  const int blocks = per_sm * n_sm < need ? per_sm * n_sm : need;
  kernel<<<blocks, THREADS, smem, stream>>>(p, scene, sf, si, gb, next);
  return (int)cudaGetLastError();
}

}  // namespace

// Advances every lane of the (15, R) f32 / (4, R) i32 state planes by
// n_steps (>= 1) bounces, in place, on `stream`.  `scene` is the
// concatenation tri (n_tri, 20) | sph (max(n_sph, 1), 16) | light
// (n_light, 16) | sky (8) | cam (16), `scene_words` floats in all.  With
// single_path != 0 the (8, R) f32 G-buffer `gb` is written (stop_after is
// then ignored).  `next` is one int, zero: the lane counter of the gated
// modes (stop_after > 0, single_path).
// Returns cudaGetLastError().
extern "C" int fused_mc_steps(const float* scene, int scene_words, int n_tri,
                              int n_sph, int n_light, uint32_t seed,
                              float* sf, int* si, int R, int n_pix, int width,
                              int height, int n_steps, float t_min,
                              float eps_offset, float rr_survival,
                              float inv_rr, float shadow_tol, float aspect,
                              int max_depth, int stop_after, int single_path,
                              float* gb, int* next, void* stream) {
  Params p;
  p.n_tri = n_tri;
  p.n_sph = n_sph;
  p.n_light = n_light;
  p.off_sph = n_tri * TRI_W;
  p.off_light = p.off_sph + (n_sph > 1 ? n_sph : 1) * SPH_W;
  p.off_sky = p.off_light + n_light * LGT_W;
  p.off_cam = p.off_sky + 8;
  p.scene_words = scene_words;
  if (p.off_cam + 16 != scene_words || R <= 0 || n_steps < 1)
    return (int)cudaErrorInvalidValue;
  p.seed = seed;
  p.R = R;
  p.n_pix = n_pix;
  p.width = width;
  p.height = height;
  p.n_steps = n_steps;
  p.t_min = t_min;
  p.eps_offset = eps_offset;
  p.rr_survival = rr_survival;
  p.inv_rr = inv_rr;
  p.shadow_tol = shadow_tol;
  p.aspect = aspect;
  p.max_depth = max_depth;
  p.stop_after = stop_after;
  const cudaStream_t st = (cudaStream_t)stream;
  if (single_path) {
    if (gb == nullptr || next == nullptr) return (int)cudaErrorInvalidValue;
    return launch_retire<true>(p, scene, sf, si, gb, next, st);
  }
  if (stop_after > 0) {
    if (next == nullptr) return (int)cudaErrorInvalidValue;
    return launch_retire<false>(p, scene, sf, si, nullptr, next, st);
  }
  return launch_plain(p, scene, sf, si, st);
}
