// Warped bilateral-ZNCC photometric cost for K plane hypotheses — the hot
// op of the PatchMatch solve, written for Hopper (sm_90a).
//
// Replaces two TPU kernels of the JAX package and computes their function:
//   * acmmp_tpu/ops/pallas_ncc.py:108 multiview_zncc_pallas (per-hypothesis
//     grid; here K = 1), and
//   * acmmp_tpu/ops/pallas_ncc.py:542 _kshared_call (one visit scores a
//     K-stack; here K = 2, 3 or 8).
// For every output pixel p of the (possibly parity-packed) grid, source
// view v < n_views and hypothesis k, it warps the T patch taps of p through
// the plane-induced homography of plane k (rank-1 form p00 + di*u + dj*t,
// pallas_ncc.py:292-322), reads the uint8 source bilinearly with exact f32
// weights after clamping to the view's true extent (core/geometry.py:219),
// accumulates the bilateral-weighted source sums against the reference-side
// weights the wrapper precomputes, and writes
//   clip(1 - covar / sqrt(max(var_ref * var_src, 1e-30)), 0, cost_max),
// or cost_max when a variance is below min_var, when the warped centre
// falls outside the source, or when v >= n_views (pallas_ncc.py:489-499).
//
// What bounds it here: not the bytes (the 8 uint8 sources of a
// 1600x1184 problem take 15 MB and stay in the 50 MB L2; planes, tap
// weights and costs stream once), but the per-tap work: four dependent
// byte gathers and about 40 FP32 operations, including an IEEE
// reciprocal, per (hypothesis, view, tap, pixel). The design keeps that
// work plain: one thread per output pixel, blockIdx.y over views so a
// padded view slot costs one store per hypothesis, the tap loop outside
// the hypothesis loop so each tap's w / w*ref pair is loaded once for all
// K, and every source byte read through the read-only path (__ldg). The
// TPU kernel's u8x4 row-word packing, phase copies, per-tap row-scan
// bounding boxes and VMEM gates existed only because Mosaic's gather is
// slow; none of them is carried over.
//
// The moments are accumulated over centred values: reference taps minus
// the reference pixel's own value (the wrapper does that side), source
// samples minus the source sample at the centre warp. The ZNCC is
// shift-invariant, and centring keeps the one-pass variance
// E[v^2] - E[v]^2 well conditioned in f32. At 1600x1184 the 8-bit patches
// are smooth (variances below 1 against v^2 ~ 4e4): there the uncentred
// form of the JAX package misses an f64 evaluation by more than the ZNCC
// bar on ~24% of costs, and flips the min_var degenerate test.
//
// A K-stack must be bitwise equal to K launches at K = 1 (the JAX package
// pins this for its kernels, test_k_shared_matches_per_k). So the
// per-hypothesis arithmetic is written with explicit rounding intrinsics
// and fmaf only: nothing is left to the compiler's FMA contraction, and no
// arithmetic depends on K. Build without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// consts layout: [0, 9) the reference K^{-T} row-major, then per view
// kViewStride floats from kHeader: A (9, row-major), B (3), width, height.
constexpr int kHeader = 16;
constexpr int kViewStride = 16;
constexpr int kBlock = 128;

struct Hyp {
  float px, py, pz;   // centre warp (homogeneous)
  float ux, uy, uz;   // d p / d di
  float tx, ty, tz;   // d p / d dj
  float c_src;        // source sample at the centre warp (the shift)
  bool in_bounds;
};

__device__ __forceinline__ float nan_to_zero(float a) {
  return isnan(a) ? 0.0f : a;
}

// Bilinear read of the uint8 view at the homogeneous point (px, py, pz),
// clamped to the true extent [0, sx_max] x [0, sy_max], exact f32 weights.
__device__ __forceinline__ float sample(const uint8_t* __restrict__ img,
                                        int Ws, float px, float py, float pz,
                                        float sx_max, float sy_max,
                                        int xi_max, int yi_max) {
  const float inv_pz = __frcp_rn(pz);
  // NaN guard before the clamp, so no index is formed from a NaN
  const float sx =
      fminf(fmaxf(nan_to_zero(__fmul_rn(px, inv_pz)), 0.0f), sx_max);
  const float sy =
      fminf(fmaxf(nan_to_zero(__fmul_rn(py, inv_pz)), 0.0f), sy_max);
  const float xf = floorf(sx);
  const float yf = floorf(sy);
  const float fx = __fsub_rn(sx, xf);
  const float fy = __fsub_rn(sy, yf);
  const int x0 = (int)xf;
  const int y0 = (int)yf;
  const int x1 = min(x0 + 1, xi_max);
  const int y1 = min(y0 + 1, yi_max);
  const float v00 = (float)__ldg(img + (size_t)y0 * Ws + x0);
  const float v01 = (float)__ldg(img + (size_t)y1 * Ws + x0);
  const float v10 = (float)__ldg(img + (size_t)y0 * Ws + x1);
  const float v11 = (float)__ldg(img + (size_t)y1 * Ws + x1);
  const float a0 = __fsub_rn(1.0f, fx);
  const float top = __fmaf_rn(fx, v10, __fmul_rn(a0, v00));
  const float bot = __fmaf_rn(fx, v11, __fmul_rn(a0, v01));
  return __fmaf_rn(fy, bot, __fmul_rn(__fsub_rn(1.0f, fy), top));
}

template <int K>
__global__ void __launch_bounds__(kBlock) zncc_kernel(
    const float4* __restrict__ planes,   // [K, npix] (nx, ny, nz, w)
    const uint8_t* __restrict__ src,     // [V, Hs, Ws]
    const float* __restrict__ w_taps,    // [T, npix]
    const float* __restrict__ wr_taps,   // [T, npix]
    const float* __restrict__ refsums,   // [3, npix] sum_w, sum_ref, sum_ref2
    const float* __restrict__ consts,    // [kHeader + kViewStride * V]
    const float2* __restrict__ taps,     // [T] (di, dj)
    float* __restrict__ out,             // [K, npix, V]
    int V, int n_views, int Hg, int W, int Hs, int Ws, int T,
    float oy, float ox, int row_pack_off, float cost_max, float min_var) {
  const int npix = Hg * W;
  const int p = blockIdx.x * kBlock + threadIdx.x;
  const int v = blockIdx.y;
  if (p >= npix) return;
  if (v >= n_views) {
#pragma unroll
    for (int k = 0; k < K; ++k) out[((size_t)k * npix + p) * V + v] = cost_max;
    return;
  }

  const int i = p / W;
  const int j = p - i * W;
  const int rr = row_pack_off >= 0 ? 2 * i + ((row_pack_off + j) & 1) : i;
  const float yy = __fadd_rn((float)rr, oy);
  const float xx = __fadd_rn((float)j, ox);

  const float* c = consts + kHeader + v * kViewStride;
  const float a00 = __ldg(c + 0), a01 = __ldg(c + 1), a02 = __ldg(c + 2);
  const float a10 = __ldg(c + 3), a11 = __ldg(c + 4), a12 = __ldg(c + 5);
  const float a20 = __ldg(c + 6), a21 = __ldg(c + 7), a22 = __ldg(c + 8);
  const float b0 = __ldg(c + 9), b1 = __ldg(c + 10), b2 = __ldg(c + 11);
  const float sw = __ldg(c + 12), sh = __ldg(c + 13);
  const float sx_max = __fsub_rn(sw, 1.0f);
  const float sy_max = __fsub_rn(sh, 1.0f);
  const int xi_max = (int)sx_max;
  const int yi_max = (int)sy_max;
  // A q for the centre pixel, shared by every hypothesis
  const float aq0 = __fadd_rn(__fmaf_rn(a01, yy, __fmul_rn(a00, xx)), a02);
  const float aq1 = __fadd_rn(__fmaf_rn(a11, yy, __fmul_rn(a10, xx)), a12);
  const float aq2 = __fadd_rn(__fmaf_rn(a21, yy, __fmul_rn(a20, xx)), a22);

  const uint8_t* img = src + (size_t)v * Hs * Ws;
  float kr[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) kr[q] = __ldg(consts + q);

  Hyp h[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float4 pl = __ldg(planes + (size_t)k * npix + p);
    // m = K_r^{-T} n, 1/w
    const float m0 = __fmaf_rn(kr[2], pl.z,
                               __fmaf_rn(kr[1], pl.y, __fmul_rn(kr[0], pl.x)));
    const float m1 = __fmaf_rn(kr[5], pl.z,
                               __fmaf_rn(kr[4], pl.y, __fmul_rn(kr[3], pl.x)));
    const float m2 = __fmaf_rn(kr[8], pl.z,
                               __fmaf_rn(kr[7], pl.y, __fmul_rn(kr[6], pl.x)));
    const float iw = __frcp_rn(pl.w);
    const float m0i = __fmul_rn(m0, iw);
    const float m1i = __fmul_rn(m1, iw);
    const float mq =
        __fmul_rn(__fadd_rn(__fmaf_rn(m1, yy, __fmul_rn(m0, xx)), m2), iw);
    h[k].px = __fmaf_rn(-b0, mq, aq0);
    h[k].py = __fmaf_rn(-b1, mq, aq1);
    h[k].pz = __fmaf_rn(-b2, mq, aq2);
    h[k].ux = __fmaf_rn(-b0, m0i, a00);
    h[k].uy = __fmaf_rn(-b1, m0i, a10);
    h[k].uz = __fmaf_rn(-b2, m0i, a20);
    h[k].tx = __fmaf_rn(-b0, m1i, a01);
    h[k].ty = __fmaf_rn(-b1, m1i, a11);
    h[k].tz = __fmaf_rn(-b2, m1i, a21);
    const float cx = __fdiv_rn(h[k].px, h[k].pz);
    const float cy = __fdiv_rn(h[k].py, h[k].pz);
    h[k].in_bounds = (cx >= 0.0f) && (cx < sw) && (cy >= 0.0f) && (cy < sh);
    h[k].c_src = sample(img, Ws, h[k].px, h[k].py, h[k].pz, sx_max, sy_max,
                        xi_max, yi_max);
  }

  float s_src[K], s_src2[K], s_rs[K];
#pragma unroll
  for (int k = 0; k < K; ++k) s_src[k] = s_src2[k] = s_rs[k] = 0.0f;

  for (int t = 0; t < T; ++t) {
    const float2 d = __ldg(taps + t);
    const float wt = __ldg(w_taps + (size_t)t * npix + p);
    const float wrt = __ldg(wr_taps + (size_t)t * npix + p);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const Hyp& hk = h[k];
      const float px = __fmaf_rn(d.y, hk.tx, __fmaf_rn(d.x, hk.ux, hk.px));
      const float py = __fmaf_rn(d.y, hk.ty, __fmaf_rn(d.x, hk.uy, hk.py));
      const float pz = __fmaf_rn(d.y, hk.tz, __fmaf_rn(d.x, hk.uz, hk.pz));
      const float val = __fsub_rn(
          sample(img, Ws, px, py, pz, sx_max, sy_max, xi_max, yi_max),
          hk.c_src);
      const float wv = __fmul_rn(wt, val);
      s_src[k] = __fadd_rn(s_src[k], wv);
      s_src2[k] = __fmaf_rn(wv, val, s_src2[k]);
      s_rs[k] = __fmaf_rn(wrt, val, s_rs[k]);
    }
  }

  const float sum_w = __ldg(refsums + p);
  const float sum_ref = __ldg(refsums + (size_t)npix + p);
  const float sum_ref2 = __ldg(refsums + 2 * (size_t)npix + p);
  const float inv_sum_w = __frcp_rn(sum_w);
  const float mean_ref = __fmul_rn(sum_ref, inv_sum_w);
  const float var_ref = __fsub_rn(__fmul_rn(sum_ref2, inv_sum_w),
                                  __fmul_rn(mean_ref, mean_ref));
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float mean_src = __fmul_rn(s_src[k], inv_sum_w);
    const float var_src = __fsub_rn(__fmul_rn(s_src2[k], inv_sum_w),
                                    __fmul_rn(mean_src, mean_src));
    const float covar = __fsub_rn(__fmul_rn(s_rs[k], inv_sum_w),
                                  __fmul_rn(mean_ref, mean_src));
    const float denom =
        __fsqrt_rn(fmaxf(__fmul_rn(var_ref, var_src), 1e-30f));
    const float ncc =
        fminf(fmaxf(__fsub_rn(1.0f, __fdiv_rn(covar, denom)), 0.0f), cost_max);
    const bool degenerate = (var_ref < min_var) || (var_src < min_var);
    const float cost = (degenerate || !h[k].in_bounds) ? cost_max : ncc;
    out[((size_t)k * npix + p) * V + v] = cost;
  }
}

template <int K>
cudaError_t launch(const void* planes, const void* src, const void* w_taps,
                   const void* wr_taps, const void* refsums,
                   const void* consts, const void* taps, void* out, int V,
                   int n_views, int Hg, int W, int Hs, int Ws, int T,
                   float oy, float ox, int row_pack_off, float cost_max,
                   float min_var, cudaStream_t stream) {
  const int npix = Hg * W;
  const dim3 grid((npix + kBlock - 1) / kBlock, V);
  zncc_kernel<K><<<grid, kBlock, 0, stream>>>(
      static_cast<const float4*>(planes), static_cast<const uint8_t*>(src),
      static_cast<const float*>(w_taps), static_cast<const float*>(wr_taps),
      static_cast<const float*>(refsums), static_cast<const float*>(consts),
      static_cast<const float2*>(taps), static_cast<float*>(out), V, n_views,
      Hg, W, Hs, Ws, T, oy, ox, row_pack_off, cost_max, min_var);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for an unsupported K.
extern "C" int acmmp_zncc_launch(
    int K, const void* planes, const void* src, const void* w_taps,
    const void* wr_taps, const void* refsums, const void* consts,
    const void* taps, void* out, int V, int n_views, int Hg, int W, int Hs,
    int Ws, int T, float oy, float ox, int row_pack_off, float cost_max,
    float min_var, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1:
      return launch<1>(planes, src, w_taps, wr_taps, refsums, consts, taps,
                       out, V, n_views, Hg, W, Hs, Ws, T, oy, ox,
                       row_pack_off, cost_max, min_var, s);
    case 2:
      return launch<2>(planes, src, w_taps, wr_taps, refsums, consts, taps,
                       out, V, n_views, Hg, W, Hs, Ws, T, oy, ox,
                       row_pack_off, cost_max, min_var, s);
    case 3:
      return launch<3>(planes, src, w_taps, wr_taps, refsums, consts, taps,
                       out, V, n_views, Hg, W, Hs, Ws, T, oy, ox,
                       row_pack_off, cost_max, min_var, s);
    case 8:
      return launch<8>(planes, src, w_taps, wr_taps, refsums, consts, taps,
                       out, V, n_views, Hg, W, Hs, Ws, T, oy, ox,
                       row_pack_off, cost_max, min_var, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
