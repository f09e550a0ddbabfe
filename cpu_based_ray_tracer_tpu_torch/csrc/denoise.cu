// denoise.cu — one level of the Denoiser's edge-avoiding a-trous
// joint-bilateral filter for Hopper (sm_90a).
//
// Replaces: the eager PyTorch operations of one level of
// ops/denoise.py::joint_bilateral_atrous (its plain twin
// _atrous_level_plain: 24 off-center taps of some 30 element-wise
// operations each over padded copies of the frame).  The JAX package runs
// the same filter as plain XLA; there is no TPU kernel.
//
// What bounds it on this card: arithmetic.  A pixel's 24 off-center taps
// cost ~85 single operations each (acosf and expf among them, three IEEE
// divisions and a square root); the bytes are four planes in and one out,
// 40 + 12 bytes a pixel, and the whole working set (~30 MB at 896 x 896)
// stays in the 50 MB L2, so the taps' reuse comes from L1 / L2.
//
// What the design does about it: one thread a pixel in 32 x 8 blocks (a
// warp reads along a row), the center's guidance in registers, the 25
// taps unrolled in the plain loop's order with read-only loads.  One
// launch a level: level i + 1 reads level i's output 2 * 2^(i+1) pixels
// away, so fusing levels would need a grid-wide barrier.
//
// Semantics, bit equal to _atrous_level_plain on the card (built with
// -fmad=false and without --use_fast_math: IEEE division and square root,
// the full-precision acosf / expf PyTorch's kernels call):
//   - taps ty then tx, 0..4, at (ty - 2, tx - 2) * step; a tap outside the
//     frame adds 0 * 0 in the plain loop and is skipped here; a tap on a
//     non-contributor pixel has weight 0 and adds 0 * its color;
//   - the center tap's weight is 1 if the center contributes, else 0;
//   - any other tap's weight, operation for operation as _tap_weight
//     computes it: sum3(v) = (v.x + v.y) + v.z, d_pos = sum3(dp * dp) * wp,
//     d_col = sum3(dc * dc) * wc with dc against the level's input color at
//     the center, ang = acosf(clamp(sum3(n' * n), 0, 1)), d_nrm = (ang *
//     ang) * wn, cop = sum3(n * dp / sqrtf(max(sum3(dp * dp), 1e-24))),
//     d_cop = (cop * cop) * wcp, w = expf(-(((d_pos + d_col) + d_nrm) +
//     d_cop));
//   - c_sum += w * color' and w_sum += w tap by tap; out = c_sum /
//     max(w_sum, 1e-20);
//   - the last level clamps to [0, 1] when asked, then a non-contributor
//     pixel takes the filter's input color `orig` instead.
// clamp and max are torch.clamp's on the card: a NaN passes through.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BX = 32, BY = 8;

__device__ __forceinline__ float clamp_t(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float clamp_min_t(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__global__ void __launch_bounds__(BX * BY)
atrous_level_kernel(const float* __restrict__ color,
                    const float* __restrict__ pos,
                    const float* __restrict__ nrm,
                    const uint8_t* __restrict__ con,
                    const float* __restrict__ orig, float* __restrict__ out,
                    int h, int w, int step, float wp, float wc, float wn,
                    float wcp, int last, int clamp) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= w || y >= h) return;
  const int64_t i = (int64_t)y * w + x;
  const float cx = __ldg(color + 3 * i), cy = __ldg(color + 3 * i + 1),
              cz = __ldg(color + 3 * i + 2);
  const float px = __ldg(pos + 3 * i), py = __ldg(pos + 3 * i + 1),
              pz = __ldg(pos + 3 * i + 2);
  const float nx = __ldg(nrm + 3 * i), ny = __ldg(nrm + 3 * i + 1),
              nz = __ldg(nrm + 3 * i + 2);
  float sx = 0.0f, sy = 0.0f, sz = 0.0f, ws = 0.0f;
#pragma unroll
  for (int ty = 0; ty < 5; ++ty) {
    const int yy = y + (ty - 2) * step;
#pragma unroll
    for (int tx = 0; tx < 5; ++tx) {
      const int xx = x + (tx - 2) * step;
      if (yy < 0 || yy >= h || xx < 0 || xx >= w) continue;
      const int64_t j = (int64_t)yy * w + xx;
      const float qx = __ldg(color + 3 * j), qy = __ldg(color + 3 * j + 1),
                  qz = __ldg(color + 3 * j + 2);
      float wt = 0.0f;
      if (__ldg(con + j) != 0) {
        if (ty == 2 && tx == 2) {
          wt = 1.0f;
        } else {
          const float dpx = __ldg(pos + 3 * j) - px;
          const float dpy = __ldg(pos + 3 * j + 1) - py;
          const float dpz = __ldg(pos + 3 * j + 2) - pz;
          const float pp = (dpx * dpx + dpy * dpy) + dpz * dpz;
          const float d_pos = pp * wp;
          const float dcx = qx - cx, dcy = qy - cy, dcz = qz - cz;
          const float d_col = ((dcx * dcx + dcy * dcy) + dcz * dcz) * wc;
          const float nn = (__ldg(nrm + 3 * j) * nx +
                            __ldg(nrm + 3 * j + 1) * ny) +
                           __ldg(nrm + 3 * j + 2) * nz;
          const float ang = acosf(clamp_t(nn, 0.0f, 1.0f));
          const float d_nrm = (ang * ang) * wn;
          const float len = sqrtf(clamp_min_t(pp, 1e-24f));
          const float cop = (nx * (dpx / len) + ny * (dpy / len)) +
                            nz * (dpz / len);
          const float d_cop = (cop * cop) * wcp;
          wt = expf(-(((d_pos + d_col) + d_nrm) + d_cop));
        }
      }
      sx = sx + wt * qx;
      sy = sy + wt * qy;
      sz = sz + wt * qz;
      ws = ws + wt;
    }
  }
  const float d = clamp_min_t(ws, 1e-20f);
  float ox = sx / d, oy = sy / d, oz = sz / d;
  if (last) {
    if (clamp) {
      ox = clamp_t(ox, 0.0f, 1.0f);
      oy = clamp_t(oy, 0.0f, 1.0f);
      oz = clamp_t(oz, 0.0f, 1.0f);
    }
    if (__ldg(con + i) == 0) {
      ox = __ldg(orig + 3 * i);
      oy = __ldg(orig + 3 * i + 1);
      oz = __ldg(orig + 3 * i + 2);
    }
  }
  out[3 * i] = ox;
  out[3 * i + 1] = oy;
  out[3 * i + 2] = oz;
}

}  // namespace

// One a-trous level of an h x w frame on `stream`: color, pos, nrm (h, w, 3)
// f32 and con (h, w) bool in, out (h, w, 3) f32 (not color); taps dilated
// by step; wp, wc, wn, wcp the four guidance weights 1 / (2 sigma^2).  With
// last != 0 the filter's last level: clamp to [0, 1] if clamp != 0, then
// orig (h, w, 3), the filter's input color, at non-contributor pixels.
// Returns cudaGetLastError().
extern "C" int denoise_atrous_level(const float* color, const float* pos,
                                    const float* nrm, const uint8_t* con,
                                    const float* orig, float* out, int h,
                                    int w, int step, float wp, float wc,
                                    float wn, float wcp, int last, int clamp,
                                    void* stream) {
  if (h <= 0 || w <= 0 || step <= 0 || out == color ||
      (last && orig == nullptr) || (h + BY - 1) / BY > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((w + BX - 1) / BX, (h + BY - 1) / BY), block(BX, BY);
  atrous_level_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      color, pos, nrm, con, orig, out, h, w, step, wp, wc, wn, wcp, last,
      clamp);
  return (int)cudaGetLastError();
}
