// fused_mc.cu — persistent-wavefront Monte Carlo bounce kernel for Hopper
// (sm_90a), the Cornell path tracer's whole bounce step in one launch.
//
// Replaces: cpu_based_ray_tracer_tpu/ops/fused.py::_kernel, the Pallas TPU
// kernel launched by _run from wavefront_steps_fused (plain and stop_after
// modes) and from single_sample_gbuffer (single_path mode: quota 1, the
// sample index pinned, the primary hit's 8-plane G-buffer written at the
// launch's first step — the Denoiser frame).
//
// What bounds it on this card: arithmetic.  Each lane-step runs two
// Moller-Trumbore passes over every triangle (main hit, then the shadow
// ray), ~100 f32 operations per triangle, about 3,200 per lane-step on the
// 32-triangle Cornell box, against 76 bytes of lane state read and written
// once per launch (not per step).  It is bound by the FP32 pipes
// (132 SMs x 128 lanes per clock), not by memory.
//
// What the design does about it:
//   - one thread per lane; the lane state (15 f32 + 4 i32) stays in
//     registers for all n_steps bounces and touches device memory once
//     in, once out;
//   - the scene pack (triangles, spheres, lights, sky, camera words) is
//     copied into shared memory at block start; every thread of a warp
//     reads the same primitive at the same time, so each read is a
//     broadcast;
//   - the shadow test is the division-free accept of the TPU kernel: sign
//     comparisons of the numerators against |det|-scaled bounds, no
//     reciprocal per triangle.
//
// Numerics: built with -fmad=false and without --use_fast_math, so every
// a*b+c rounds twice, as in the JAX package and in the plain PyTorch
// version (ops/fused.py::_steps_plain); the operation order of every
// expression is the TPU kernel's.  rsqrtf matches torch.rsqrt on CUDA.

#include <cfloat>
#include <cstdint>
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

// SINGLE_PATH: a template parameter, so the plain and stop_after modes
// compile to the kernel they were before the mode existed.
template <bool SINGLE_PATH>
__global__ void __launch_bounds__(256)
fused_mc_kernel(const Params p, const float* __restrict__ scene_g,
                float* __restrict__ sf, int* __restrict__ si,
                float* __restrict__ gb) {
  extern __shared__ float sm[];
  for (int i = threadIdx.x; i < p.scene_words; i += blockDim.x)
    sm[i] = scene_g[i];
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.R) return;
  const int R = p.R;
  const float* tri = sm;
  const float* sph = sm + p.off_sph;
  const float* lgt = sm + p.off_light;
  const float* sky = sm + p.off_sky;
  const float* cam = sm + p.off_cam;

  const float px_ = cam[0], py_ = cam[1], pz_ = cam[2];
  const float rx_ = cam[3], ry_ = cam[4], rz_ = cam[5];
  const float ux_ = cam[6], uy_ = cam[7], uz_ = cam[8];
  const float fx_ = cam[9], fy_ = cam[10], fz_ = cam[11];
  const float tan_half = cam[12];
  const float light_total = sky[6];
  const bool light_valid = light_total > 0.0f;
  const float light_pdf =
      light_valid ? 1.0f / fmaxf(light_total, 1e-20f) : 0.0f;
  const float width_f = (float)p.width, height_f = (float)p.height;
  const int quota = SINGLE_PATH ? 1 : p.stop_after;
  const bool gated = quota > 0;

  const uint32_t pix = (uint32_t)lane;
  const bool valid = pix < (uint32_t)p.n_pix;
  const float pxf = (float)(lane % p.width);
  const float pyf = (float)(lane / p.width);

  int s = si[lane], bb = si[R + lane], nd = si[2 * R + lane], nsh = 0;
  float ox = sf[0 * R + lane], oy = sf[1 * R + lane], oz = sf[2 * R + lane];
  float dx = sf[3 * R + lane], dy = sf[4 * R + lane], dz = sf[5 * R + lane];
  float tpx = sf[6 * R + lane], tpy = sf[7 * R + lane], tpz = sf[8 * R + lane];
  float cux = sf[9 * R + lane], cuy = sf[10 * R + lane];
  float cuz = sf[11 * R + lane];
  float axp = sf[12 * R + lane], ayp = sf[13 * R + lane];
  float azp = sf[14 * R + lane];

  for (int step = 0; step < p.n_steps; ++step) {
    const bool armed = nd < quota;
    const bool alive0 = gated ? (valid && armed) : valid;

    // --- main intersect: Moller-Trumbore over triangles, then spheres -----
    float best_t = NO_HIT, bnx = 0.f, bny = 0.f, bnz = 0.f;
    float al0 = 0.f, al1 = 0.f, al2 = 0.f, em0 = 0.f, em1 = 0.f, em2 = 0.f;
    float bef = 0.f;
    float bpid = 0.f;  // global primitive id (single_path's G-buffer)
    for (int n = 0; n < p.n_tri; ++n) {
      const float* T = tri + n * TRI_W;
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
      const bool ok = okd && (t > p.t_min) && (b1 >= 0.0f) && (b2 >= 0.0f) &&
                      (1.0f - b1 - b2 >= 0.0f) && (t < best_t);
      if (ok) {
        best_t = t;
        bnx = T[9]; bny = T[10]; bnz = T[11];
        al0 = T[12]; al1 = T[13]; al2 = T[14];
        em0 = T[15]; em1 = T[16]; em2 = T[17];
        bef = T[18];
        if (SINGLE_PATH) bpid = (float)(n + 1);
      }
    }
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
    const bool is_primary = bb == 0;

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
    nsh += alive ? 1 : 0;

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
    if (SINGLE_PATH && step == 0) {
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

    // --- NEE: one area-light sample ------------------------------------------
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

    // Shadow ray: occluded iff any hit lands at t <= dist - tol, with the
    // division-free accept (numerators against |det|-scaled bounds).
    bool occluded = false;
    const float lim = dist - p.shadow_tol;
    for (int n = 0; n < p.n_tri; ++n) {
      const float* T = tri + n * TRI_W;
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
      if (!SINGLE_PATH) s += 1;
      cux = 0.0f;
      cuy = 0.0f;
      cuz = 0.0f;
    }
    if (cont) {
      ox = hx; oy = hy; oz = hz;
      dx = wix; dy = wiy; dz = wiz;
      bb += 1;
    } else {
      // Regenerate the camera ray of the lane's next sample (s is already
      // advanced), same operation order as camera.perspective_ray_at.
      float uj[4];
      uniforms4(p.seed, pix, s, 0, JITTER, uj);
      const float ndc_x = (pxf + uj[0]) / width_f * 2.0f - 1.0f;
      const float ndc_y = -((pyf + uj[1]) / height_f * 2.0f - 1.0f);
      const float ta = tan_half * p.aspect;
      const float a = ndc_x * ta;
      const float b = ndc_y * tan_half;
      float pdx = a * rx_ + b * ux_ + fx_;
      float pdy = a * ry_ + b * uy_ + fy_;
      float pdz = a * rz_ + b * uz_ + fz_;
      norm3(pdx, pdy, pdz);
      ox = px_; oy = py_; oz = pz_;
      dx = pdx; dy = pdy; dz = pdz;
      tpx = 1.0f; tpy = 1.0f; tpz = 1.0f;
      bb = 0;
    }
  }

  si[lane] = s;
  si[R + lane] = bb;
  si[2 * R + lane] = nd;
  si[3 * R + lane] = nsh;
  sf[0 * R + lane] = ox;  sf[1 * R + lane] = oy;  sf[2 * R + lane] = oz;
  sf[3 * R + lane] = dx;  sf[4 * R + lane] = dy;  sf[5 * R + lane] = dz;
  sf[6 * R + lane] = tpx; sf[7 * R + lane] = tpy; sf[8 * R + lane] = tpz;
  sf[9 * R + lane] = cux; sf[10 * R + lane] = cuy; sf[11 * R + lane] = cuz;
  sf[12 * R + lane] = axp; sf[13 * R + lane] = ayp; sf[14 * R + lane] = azp;
}

}  // namespace

// Advances every lane of the (15, R) f32 / (4, R) i32 state planes by
// n_steps bounces, in place, on `stream`.  `scene` is the concatenation
// tri (n_tri, 20) | sph (max(n_sph, 1), 16) | light (n_light, 16) | sky (8)
// | cam (16), `scene_words` floats in all.  With single_path != 0 the
// (8, R) f32 G-buffer `gb` is written (stop_after is then ignored).
// Returns cudaGetLastError().
extern "C" int fused_mc_steps(const float* scene, int scene_words, int n_tri,
                              int n_sph, int n_light, uint32_t seed,
                              float* sf, int* si, int R, int n_pix, int width,
                              int height, int n_steps, float t_min,
                              float eps_offset, float rr_survival,
                              float inv_rr, float shadow_tol, float aspect,
                              int max_depth, int stop_after, int single_path,
                              float* gb, void* stream) {
  Params p;
  p.n_tri = n_tri;
  p.n_sph = n_sph;
  p.n_light = n_light;
  p.off_sph = n_tri * TRI_W;
  p.off_light = p.off_sph + (n_sph > 1 ? n_sph : 1) * SPH_W;
  p.off_sky = p.off_light + n_light * LGT_W;
  p.off_cam = p.off_sky + 8;
  p.scene_words = scene_words;
  if (p.off_cam + 16 != scene_words) return (int)cudaErrorInvalidValue;
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
  if (single_path && gb == nullptr) return (int)cudaErrorInvalidValue;
  const auto kernel =
      single_path ? fused_mc_kernel<true> : fused_mc_kernel<false>;
  const size_t smem = (size_t)scene_words * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = 256;
  const int blocks = (R + threads - 1) / threads;
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(p, scene, sf, si,
                                                          gb);
  return (int)cudaGetLastError();
}
