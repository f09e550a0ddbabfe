// fused_rtiow.cu — equal-spp RTIOW sphere path tracer for Hopper (sm_90a):
// the offline prototype's and the NPPT stage's whole scatter step in one
// launch.
//
// Replaces: cpu_based_ray_tracer_tpu/ops/fused_rtiow.py::_kernel, the
// Pallas TPU kernel launched by _run from render_fused.
//
// What bounds it on this card: arithmetic.  Each lane-step runs one
// ray/sphere quadratic per sphere (~30 f32 operations; 6 spheres in the
// NPPT scene) and ~180 operations of shading (sky, facing normal, the
// sphere/ball sample with a sin, a cos and a pow, metal, the dielectric's
// Schlick and Snell, the scatter normalization) plus the regeneration of
// finished lanes' primary rays, against 60 bytes of lane state read and
// written once per launch (not per step).  It is bound by the FP32 pipes,
// not by memory.
//
// What the design does about it:
//   - one thread per lane; the lane state (12 f32: o, d, tp, acc; 3 i32: s,
//     b, n_done) stays in registers for all n_steps steps and touches device
//     memory once in, once out;
//   - the sphere, material, sky and camera tables are copied into shared
//     memory at block start; every thread of a warp reads the same row at
//     the same time, so each read is a broadcast;
//   - the camera mode and the diffuse model are template parameters: no
//     per-step branch on them.
//
// Numerics: built with -fmad=false and without --use_fast_math, so every
// a*b+c rounds twice, as in the JAX package and in the plain PyTorch
// version (ops/fused_rtiow.py::_steps_plain); the operation order of every
// expression is the TPU kernel's.  (1 - cos)^5 is x * ((x * x) * (x * x)),
// the products XLA expands the integer power into; u^(1/3) is powf, as
// torch.pow on the card; rsqrtf, as torch.rsqrt on the card (the plain
// version normalizes with ops/fused.py::_norm3, as csrc/fused_mc.cu).

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SPH_W = 8, MAT_W = 8;
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

template <bool THINLENS, int DIFFUSE>
__global__ void __launch_bounds__(256)
fused_rtiow_kernel(const Params p, const float* __restrict__ scene_g,
                   float* __restrict__ sf, int* __restrict__ si) {
  extern __shared__ float sm[];
  for (int i = threadIdx.x; i < p.scene_words; i += blockDim.x)
    sm[i] = scene_g[i];
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.R) return;
  const int R = p.R;
  const float* sph = sm;
  const float* mat = sm + p.off_mat;
  const float* sky = sm + p.off_sky;
  const float* cam = sm + p.off_cam;

  const uint32_t pix = (uint32_t)lane;
  const bool valid = pix < (uint32_t)p.n_pix;
  const float pxf = (float)(lane % p.width);
  const float pyf = (float)(lane / p.width);

  int s = si[lane], bb = si[R + lane], nd = si[2 * R + lane];
  float ox = sf[0 * R + lane], oy = sf[1 * R + lane], oz = sf[2 * R + lane];
  float dx = sf[3 * R + lane], dy = sf[4 * R + lane], dz = sf[5 * R + lane];
  float tpx = sf[6 * R + lane], tpy = sf[7 * R + lane], tpz = sf[8 * R + lane];
  float axp = sf[9 * R + lane], ayp = sf[10 * R + lane];
  float azp = sf[11 * R + lane];

  for (int step = 0; step < p.n_steps; ++step) {
    const bool alive = valid && nd < p.spp;

    // --- nearest sphere, near-then-far roots --------------------------------
    float best_t = NO_HIT, bnx = 0.f, bny = 0.f, bnz = 0.f, bmid = -1.0f;
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
    const bool hit = best_t < NO_HIT;

    // --- a miss adds throughput * sky ----------------------------------------
    float dux = dx, duy = dy, duz = dz;
    norm3(dux, duy, duz);
    const float skyw = 0.5f * (duy + 1.0f);
    if (alive && !hit) {
      axp = axp + tpx * ((1.0f - skyw) * sky[0] + skyw * sky[3]);
      ayp = ayp + tpy * ((1.0f - skyw) * sky[1] + skyw * sky[4]);
      azp = azp + tpz * ((1.0f - skyw) * sky[2] + skyw * sky[5]);
    }

    // --- facing normal, material row by id -----------------------------------
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
    uniforms4(p.seed, pix, s, bb, SCATTER, u);
    // sphere_from, and ball_from = sphere_from * u3^(1/3)
    const float z_s = 1.0f - 2.0f * u[0];
    const float r_xy = sqrtf(fmaxf(0.0f, 1.0f - z_s * z_s));
    const float phi = TWO_PI * u[1];
    const float spx = r_xy * cosf(phi), spy = r_xy * sinf(phi), spz = z_s;
    const float cbrt = powf(u[2], ONE_THIRD);
    const float blx = spx * cbrt, bly = spy * cbrt, blz = spz * cbrt;

    // --- LAMBERT: the diffuse model chosen by the config -------------------
    float ldx, ldy, ldz;
    if (DIFFUSE == DIFFUSE_IN_SPHERE) {
      ldx = nx + blx; ldy = ny + bly; ldz = nz + blz;
    } else if (DIFFUSE == DIFFUSE_IN_HEMISPHERE) {
      const bool inh = (blx * nx + bly * ny + blz * nz) > 0.0f;
      ldx = inh ? blx : -blx; ldy = inh ? bly : -bly; ldz = inh ? blz : -blz;
    } else {  // DIFFUSE_ON_SPHERE, the default
      ldx = nx + spx; ldy = ny + spy; ldz = nz + spz;
    }
    if (fabsf(ldx) < 1e-8f && fabsf(ldy) < 1e-8f && fabsf(ldz) < 1e-8f) {
      ldx = nx; ldy = ny; ldz = nz;
    }

    // --- METAL: mirror + fuzz, absorbed below the surface --------------------
    const float ddn = dux * nx + duy * ny + duz * nz;
    const float rfx = dux - 2.0f * ddn * nx;
    const float rfy = duy - 2.0f * ddn * ny;
    const float rfz = duz - 2.0f * ddn * nz;
    const float mdx = rfx + fuzz * blx, mdy = rfy + fuzz * bly,
                mdz = rfz + fuzz * blz;
    const bool metal_ok = (mdx * nx + mdy * ny + mdz * nz) > 0.0f;

    // --- DIELECTRIC: Schlick coin or total internal reflection ---------------
    const float eta = front ? 1.0f / ior : ior;
    const float cos_t = fminf(-(dux * nx + duy * ny + duz * nz), 1.0f);
    const float sin_t = sqrtf(fmaxf(0.0f, 1.0f - cos_t * cos_t));
    const bool cannot = eta * sin_t > 1.0f;
    float r0 = (1.0f - eta) / (1.0f + eta);
    r0 = r0 * r0;
    const float x = 1.0f - cos_t, x2 = x * x;
    const float refl_p = r0 + (1.0f - r0) * (x * (x2 * x2));
    const bool do_refl = cannot || (refl_p > u[3]);
    const float sin2r = eta * eta * fmaxf(0.0f, 1.0f - cos_t * cos_t);
    const float cosr = sqrtf(fmaxf(0.0f, 1.0f - sin2r));
    const bool tir = sin2r > 1.0f;
    const float rrx = tir ? 0.0f : eta * dux + (eta * cos_t - cosr) * nx;
    const float rry = tir ? 0.0f : eta * duy + (eta * cos_t - cosr) * ny;
    const float rrz = tir ? 0.0f : eta * duz + (eta * cos_t - cosr) * nz;

    const bool is_l = kind == LAMBERT, is_m = kind == METAL,
               is_g = kind == DIELECTRIC;
    float sdx = is_l ? ldx : (is_m ? mdx : (do_refl ? rfx : rrx));
    float sdy = is_l ? ldy : (is_m ? mdy : (do_refl ? rfy : rry));
    float sdz = is_l ? ldz : (is_m ? mdz : (do_refl ? rfz : rrz));
    norm3(sdx, sdy, sdz);
    const bool survive = alive && hit && (metal_ok || !is_m);
    if (survive) {
      tpx = tpx * (is_g ? 1.0f : alr);
      tpy = tpy * (is_g ? 1.0f : alg);
      tpz = tpz * (is_g ? 1.0f : alb);
    }

    // --- the lane continues its path or starts its next sample ---------------
    const bool cont = survive && (bb + 1 < p.max_depth);
    if (alive && !cont) {
      nd += 1;
      s += 1;
    }
    if (cont) {
      ox = ox + best_t * dx;
      oy = oy + best_t * dy;
      oz = oz + best_t * dz;
      dx = sdx; dy = sdy; dz = sdz;
      bb += 1;
    } else {
      primary<THINLENS>(p, cam, pix, pxf, pyf, s, ox, oy, oz, dx, dy, dz);
      tpx = 1.0f; tpy = 1.0f; tpz = 1.0f;
      bb = 0;
    }
  }

  si[lane] = s;
  si[R + lane] = bb;
  si[2 * R + lane] = nd;
  sf[0 * R + lane] = ox;  sf[1 * R + lane] = oy;  sf[2 * R + lane] = oz;
  sf[3 * R + lane] = dx;  sf[4 * R + lane] = dy;  sf[5 * R + lane] = dz;
  sf[6 * R + lane] = tpx; sf[7 * R + lane] = tpy; sf[8 * R + lane] = tpz;
  sf[9 * R + lane] = axp; sf[10 * R + lane] = ayp; sf[11 * R + lane] = azp;
}

template <bool THINLENS, int DIFFUSE>
int launch(const Params& p, const float* scene, float* sf, int* si,
           cudaStream_t stream) {
  const size_t smem = (size_t)p.scene_words * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_rtiow_kernel<THINLENS, DIFFUSE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = 256;
  const int blocks = (p.R + threads - 1) / threads;
  fused_rtiow_kernel<THINLENS, DIFFUSE><<<blocks, threads, smem, stream>>>(
      p, scene, sf, si);
  return (int)cudaGetLastError();
}

template <bool THINLENS>
int launch_diffuse(const Params& p, int diffuse_model, const float* scene,
                   float* sf, int* si, cudaStream_t stream) {
  switch (diffuse_model) {
    case DIFFUSE_IN_SPHERE:
      return launch<THINLENS, DIFFUSE_IN_SPHERE>(p, scene, sf, si, stream);
    case DIFFUSE_ON_SPHERE:
      return launch<THINLENS, DIFFUSE_ON_SPHERE>(p, scene, sf, si, stream);
    case DIFFUSE_IN_HEMISPHERE:
      return launch<THINLENS, DIFFUSE_IN_HEMISPHERE>(p, scene, sf, si, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
  Params p;
  p.n_sph = n_sph;
  p.n_mat = n_mat;
  p.off_mat = (n_sph > 1 ? n_sph : 1) * SPH_W;
  p.off_sky = p.off_mat + n_mat * MAT_W;
  p.off_cam = p.off_sky + 8;
  p.scene_words = scene_words;
  if (p.off_cam + 24 != scene_words) return (int)cudaErrorInvalidValue;
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
  return thinlens ? launch_diffuse<true>(p, diffuse_model, scene, sf, si, st)
                  : launch_diffuse<false>(p, diffuse_model, scene, sf, si, st);
}
