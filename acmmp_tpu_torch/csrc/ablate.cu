// Ablation modes of the warped bilateral-ZNCC kernel (csrc/zncc.cu) at
// K = 8, for cost decomposition on Hopper (sm_90a).
//
// Replaces the TPU kernel of tools/prop_ablate.py:97 ablate_call (its
// pallas_call at :399), a replica of the JAX package's K-stack ZNCC kernel
// with switches that turn parts of its work off. zncc.cu has no row scan
// and no bounding boxes, so each mode keeps the TPU tool's name and asks
// the same question of zncc.cu's own tap loop: its placement (homography
// step, IEEE reciprocal, NaN guard, clamps, floor_u23), its one 2x2 word
// gather, and its bilinear, centring and moment arithmetic. The modes
// (ops/ablate.py holds their plain versions):
//   first     zncc.cu's first design, frozen (one thread per pixel holding
//             all 8 hypotheses, blockIdx.y over views, four byte gathers
//             per tap through floorf and (int) casts): the yardstick that
//             chip_smoke.py times zncc.cu against and holds it bitwise to;
//   full      zncc.cu K = 8 as it is: one thread per (pixel, hypothesis)
//             under the same __launch_bounds__, one block per (pixel
//             chunk, view), the tap weights staged by cp.async into
//             shared memory, one 32-bit 2x2 word gather per tap, no
//             conversion instruction in the tap loop, the same centred
//             moments; bitwise equal to zncc.cu;
//   noext     the placement and the word gather kept; no bilinear,
//             centring or moments: s_src += w_t * (v00 + v01 + v10 +
//             v11). The centre sample c_src seeds s_src2, which no tap
//             updates, so the set-up stays as in full;
//   nobounds  the placement only at tap 0 (homography step, reciprocal,
//             NaN guard, clamps, floor_u23); tap t reads at tap 0's corner
//             + (di_t - di_0, dj_t - dj_0), clamped to the view in exact
//             f32 integers, with tap 0's fractions;
//   noscan    no gather: the word is a run-time zero (the element index
//             masked by a zero argument, so nvcc keeps the byte selects
//             and the arithmetic on it), and each read's word offset is
//             summed into one unsigned word whose 1e-30 leak enters the
//             output, so the placement stays;
//   f32take   full on the float4 2x2 quads of the widened 8-bit sources
//             (ops/cuda_ncc.py pack_2x2_f32): zncc.cu's float
//             instantiation, bitwise equal to full and to zncc.cu's float
//             instantiation on the same quads.
// Each accumulator a mode keeps reaches the output, so nvcc removes only
// what the mode removes; the tap loop's SASS of each mode, which
// chip_smoke.py prints, shows it.
//
// The current design's modes share zncc.cu's device code (zncc_tap.cuh:
// the block shape, the staging, floor_u23, byte_f32, the 2x2 reads, the
// placement and the bilinear); their kernel is zncc.cu's kernel for one
// view (no batch index) with the mode as a template parameter. The first
// design is its own code, kept as it was written (namespace first below),
// and also built on f32 sources, the yardstick of zncc.cu's float
// instantiation on real-valued sources.
//
// What bounds it: the per-tap work, not the bytes. FP32 operations per
// (hypothesis, view, tap, pixel), an FMA counted as two, not counting the
// exact 2^23 additions and byte selects that stand in for the conversion
// unit (chip_smoke.py's ABLATE_OPS_PER_TAP_EVAL):
//   first, full, noscan, f32take  41: the tap's homography step 12, the
//             reciprocal 1, the placement 10 (2 mul, 4 min/max, 2 floor, 2
//             sub), the bilinear 11, the centring and moments 7 (zncc.cu's
//             "about 40");
//   noext     26: the homography step, reciprocal and placement less its
//             two fractions (21), then 3 adds, 1 mul and 1 add;
//   nobounds  24: the corner step (2 add, 4 min/max), the bilinear 11 and
//             the centring and moments 7.
// chip_smoke.py bounds each mode by its own count and by the source bytes
// it reads per source pixel: 1 (first's bytes), 4 (the 2x2 words of full,
// noext and nobounds), none (noscan), 16 (f32take's quads).

#include <cuda_runtime.h>
#include <stdint.h>

#include "zncc_tap.cuh"

namespace {

// ---- the first design, frozen ----
namespace first {

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

// sample's placement: the clamped integer corner and the fractions of the
// homogeneous point (px, py, pz) in [0, sx_max] x [0, sy_max]
__device__ __forceinline__ void place(float px, float py, float pz,
                                      float sx_max, float sy_max, int& x0,
                                      int& y0, float& fx, float& fy) {
  const float inv_pz = __frcp_rn(pz);
  // NaN guard before the clamp, so no index is formed from a NaN
  const float sx =
      fminf(fmaxf(nan_to_zero(__fmul_rn(px, inv_pz)), 0.0f), sx_max);
  const float sy =
      fminf(fmaxf(nan_to_zero(__fmul_rn(py, inv_pz)), 0.0f), sy_max);
  const float xf = floorf(sx);
  const float yf = floorf(sy);
  fx = __fsub_rn(sx, xf);
  fy = __fsub_rn(sy, yf);
  x0 = (int)xf;
  y0 = (int)yf;
}

// the offsets of the four pixels a bilinear read at corner (x0, y0) takes,
// (x0, y0), (x0, y1), (x1, y0), (x1, y1), the far side clamped to the view
__device__ __forceinline__ void corners(int Ws, int x0, int y0, int xi_max,
                                        int yi_max, size_t o[4]) {
  const int x1 = min(x0 + 1, xi_max);
  const int y1 = min(y0 + 1, yi_max);
  o[0] = (size_t)y0 * Ws + x0;
  o[1] = (size_t)y1 * Ws + x0;
  o[2] = (size_t)y0 * Ws + x1;
  o[3] = (size_t)y1 * Ws + x1;
}

__device__ __forceinline__ float bilerp(float v00, float v01, float v10,
                                        float v11, float fx, float fy) {
  const float a0 = __fsub_rn(1.0f, fx);
  const float top = __fmaf_rn(fx, v10, __fmul_rn(a0, v00));
  const float bot = __fmaf_rn(fx, v11, __fmul_rn(a0, v01));
  return __fmaf_rn(fy, bot, __fmul_rn(__fsub_rn(1.0f, fy), top));
}

// sample's reads and bilinear at a given corner and fractions
template <typename Src>
__device__ __forceinline__ float sample_at(const Src* __restrict__ img,
                                           int Ws, int x0, int y0, float fx,
                                           float fy, int xi_max,
                                           int yi_max) {
  size_t o[4];
  corners(Ws, x0, y0, xi_max, yi_max, o);
  return bilerp((float)__ldg(img + o[0]), (float)__ldg(img + o[1]),
                (float)__ldg(img + o[2]), (float)__ldg(img + o[3]), fx, fy);
}

// the first design's sample, on u8 or f32 sources: bilinear read of the
// view at the homogeneous point (px, py, pz)
template <typename Src>
__device__ __forceinline__ float sample(const Src* __restrict__ img, int Ws,
                                        float px, float py, float pz,
                                        float sx_max, float sy_max,
                                        int xi_max, int yi_max) {
  int x0, y0;
  float fx, fy;
  place(px, py, pz, sx_max, sy_max, x0, y0, fx, fy);
  return sample_at(img, Ws, x0, y0, fx, fy, xi_max, yi_max);
}

template <int K, typename Src>
__global__ void __launch_bounds__(kBlock) first_kernel(
    const float4* __restrict__ planes,   // [K, npix] (nx, ny, nz, w)
    const Src* __restrict__ src,         // [V, Hs, Ws]
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

  const Src* img = src + (size_t)v * Hs * Ws;
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

}  // namespace first

// ---- the current design's modes ----
enum class Mode : int { kFull = 0, kNoExt = 1, kNoBounds = 2, kNoScan = 3 };

using S8 = Shape<8>;

// noscan's read: the placement and the word's byte selects and bilinear,
// on the run-time zero word (element e masked by `zero`); the word offset
// within the view goes into `acc` instead of into a load
__device__ __forceinline__ float zero_sample(unsigned voff, int Ws, float px,
                                             float py, float pz,
                                             float sx_max, float sy_max,
                                             uint32_t zero, unsigned& acc) {
  int x0, y0;
  float xf, yf, fx, fy;
  place(px, py, pz, sx_max, sy_max, x0, y0, xf, yf, fx, fy);
  const unsigned off = (unsigned)(y0 * Ws + x0);
  acc += off;
  float v00, v10, v01, v11;
  unpack((voff + off) & zero, v00, v10, v01, v11);
  return bilerp(v00, v10, v01, v11, fx, fy);
}

// zncc.cu's zncc_kernel<8, Src, false> (one view, no batch index), with
// the mode switching part of its tap loop off
template <Mode M, typename Src>
__global__ void __launch_bounds__(S8::kThreads, S8::kMinBlocks)
    ablate_kernel(const float4* __restrict__ planes,   // [8, npix] (n, w)
                  const Src* __restrict__ src,   // [V, Hs, Ws] 2x2 each
                  const float* __restrict__ w_taps,    // [T, npix]
                  const float* __restrict__ wr_taps,   // [T, npix]
                  const float* __restrict__ refsums,   // [3, npix]
                  const float* __restrict__ consts,    // [kHeader + 16 V]
                  const float2* __restrict__ taps,     // [T] (di, dj)
                  float* __restrict__ out,             // [8, npix, V]
                  int V, int n_views, int Hg, int W, int Hs, int Ws, int T,
                  float oy, float ox, int row_pack_off, float cost_max,
                  float min_var, uint32_t zero) {
  using S = S8;
  extern __shared__ float2 smem[];   // [T] taps, then [T][kPix] (w, wr)
  const int npix = Hg * W;
  const int lane = threadIdx.x % S::kPix;   // pixel within the block
  const int k = threadIdx.x / S::kPix;      // hypothesis
  // views are the fastest grid index, as in zncc.cu
  const int chunk = blockIdx.x / V;
  const int v = blockIdx.x - chunk * V;
  const int p = chunk * S::kPix + lane;
  if (v >= n_views) {
    if (p < npix) out[((size_t)k * npix + p) * V + v] = cost_max;
    return;
  }
  const int pc = min(p, npix - 1);

  float2* s_taps = smem;
  float2* s_w = smem + T;
  for (int t = threadIdx.x; t < T; t += S::kThreads)
    cp_async(s_taps + t, taps + t, 8);
  for (int t = k; t < T; t += S::kK) {
    float2* dst = s_w + t * S::kPix + lane;
    cp_async(&dst->x, w_taps + (size_t)t * npix + pc, 4);
    cp_async(&dst->y, wr_taps + (size_t)t * npix + pc, 4);
  }
  cp_async_commit();

  // set-up, while the copies land
  const int i = pc / W;
  const int j = pc - i * W;
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
  // A q for the centre pixel
  const float aq0 = __fadd_rn(__fmaf_rn(a01, yy, __fmul_rn(a00, xx)), a02);
  const float aq1 = __fadd_rn(__fmaf_rn(a11, yy, __fmul_rn(a10, xx)), a12);
  const float aq2 = __fadd_rn(__fmaf_rn(a21, yy, __fmul_rn(a20, xx)), a22);

  // view v's 2x2 elements; V * Hs * Ws < 2^31 (the wrapper)
  const unsigned voff = (unsigned)(v * Hs * Ws);
  float kr[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) kr[q] = __ldg(consts + q);

  const float4 pl = __ldg(planes + (size_t)k * npix + pc);
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
  Hyp h;
  h.px = __fmaf_rn(-b0, mq, aq0);
  h.py = __fmaf_rn(-b1, mq, aq1);
  h.pz = __fmaf_rn(-b2, mq, aq2);
  h.ux = __fmaf_rn(-b0, m0i, a00);
  h.uy = __fmaf_rn(-b1, m0i, a10);
  h.uz = __fmaf_rn(-b2, m0i, a20);
  h.tx = __fmaf_rn(-b0, m1i, a01);
  h.ty = __fmaf_rn(-b1, m1i, a11);
  h.tz = __fmaf_rn(-b2, m1i, a21);
  const float cx = __fdiv_rn(h.px, h.pz);
  const float cy = __fdiv_rn(h.py, h.pz);
  const bool in_bounds = (cx >= 0.0f) && (cx < sw) && (cy >= 0.0f) &&
                         (cy < sh);
  unsigned acc = 0;   // noscan: the summed word offsets
  float c_src;
  if constexpr (M == Mode::kNoScan) {
    c_src = zero_sample(voff, Ws, h.px, h.py, h.pz, sx_max, sy_max, zero,
                        acc);
  } else {
    c_src = sample(src, voff, Ws, h.px, h.py, h.pz, sx_max, sy_max);
  }

  cp_async_wait_all();
  __syncthreads();
  if (p >= npix) return;

  // nobounds: tap 0's placement, once; its corner less tap 0's offset and
  // its fractions serve every tap
  float xb = 0.0f, yb = 0.0f, fx0 = 0.0f, fy0 = 0.0f;
  if constexpr (M == Mode::kNoBounds) {
    const float2 d0 = s_taps[0];
    int x0, y0;
    float xf, yf;
    place(__fmaf_rn(d0.y, h.tx, __fmaf_rn(d0.x, h.ux, h.px)),
          __fmaf_rn(d0.y, h.ty, __fmaf_rn(d0.x, h.uy, h.py)),
          __fmaf_rn(d0.y, h.tz, __fmaf_rn(d0.x, h.uz, h.pz)), sx_max, sy_max,
          x0, y0, xf, yf, fx0, fy0);
    xb = __fsub_rn(xf, d0.x);
    yb = __fsub_rn(yf, d0.y);
  }

  float s_src = 0.0f, s_src2 = 0.0f, s_rs = 0.0f;
  if constexpr (M == Mode::kNoExt) s_src2 = c_src;
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    const float2 d = s_taps[t];
    const float2 ww = s_w[t * S::kPix + lane];
    const float wt = ww.x;
    const float wrt = ww.y;
    float val;
    if constexpr (M == Mode::kNoBounds) {
      // tap 0's corner stepped by the tap's offset and clamped, all exact
      // f32 integers; the integer from the mantissa as in floor_u23
      const float xs = fminf(fmaxf(__fadd_rn(xb, d.x), 0.0f), sx_max);
      const float ys = fminf(fmaxf(__fadd_rn(yb, d.y), 0.0f), sy_max);
      const int x0 = __float_as_int(__fadd_rn(xs, kTwo23)) - kTwo23Bits;
      const int y0 = __float_as_int(__fadd_rn(ys, kTwo23)) - kTwo23Bits;
      float v00, v10, v01, v11;
      corners(src, voff + (unsigned)(y0 * Ws + x0), v00, v10, v01, v11);
      val = __fsub_rn(bilerp(v00, v10, v01, v11, fx0, fy0), c_src);
    } else {
      const float px = __fmaf_rn(d.y, h.tx, __fmaf_rn(d.x, h.ux, h.px));
      const float py = __fmaf_rn(d.y, h.ty, __fmaf_rn(d.x, h.uy, h.py));
      const float pz = __fmaf_rn(d.y, h.tz, __fmaf_rn(d.x, h.uz, h.pz));
      if constexpr (M == Mode::kNoExt) {
        int x0, y0;
        float xf, yf, fx, fy;
        place(px, py, pz, sx_max, sy_max, x0, y0, xf, yf, fx, fy);
        float v00, v10, v01, v11;
        corners(src, voff + (unsigned)(y0 * Ws + x0), v00, v10, v01, v11);
        s_src = __fadd_rn(
            s_src,
            __fmul_rn(wt, __fadd_rn(__fadd_rn(__fadd_rn(v00, v10), v01),
                                    v11)));
        continue;
      } else if constexpr (M == Mode::kNoScan) {
        val = __fsub_rn(zero_sample(voff, Ws, px, py, pz, sx_max, sy_max,
                                    zero, acc),
                        c_src);
      } else {
        val = __fsub_rn(sample(src, voff, Ws, px, py, pz, sx_max, sy_max),
                        c_src);
      }
    }
    const float wv = __fmul_rn(wt, val);
    s_src = __fadd_rn(s_src, wv);
    s_src2 = __fmaf_rn(wv, val, s_src2);
    s_rs = __fmaf_rn(wrt, val, s_rs);
  }

  const float sum_w = __ldg(refsums + p);
  const float sum_ref = __ldg(refsums + (size_t)npix + p);
  const float sum_ref2 = __ldg(refsums + 2 * (size_t)npix + p);
  const float inv_sum_w = __frcp_rn(sum_w);
  const float mean_ref = __fmul_rn(sum_ref, inv_sum_w);
  const float var_ref = __fsub_rn(__fmul_rn(sum_ref2, inv_sum_w),
                                  __fmul_rn(mean_ref, mean_ref));
  const float mean_src = __fmul_rn(s_src, inv_sum_w);
  const float var_src = __fsub_rn(__fmul_rn(s_src2, inv_sum_w),
                                  __fmul_rn(mean_src, mean_src));
  const float covar = __fsub_rn(__fmul_rn(s_rs, inv_sum_w),
                                __fmul_rn(mean_ref, mean_src));
  const float denom = __fsqrt_rn(fmaxf(__fmul_rn(var_ref, var_src), 1e-30f));
  const float ncc =
      fminf(fmaxf(__fsub_rn(1.0f, __fdiv_rn(covar, denom)), 0.0f), cost_max);
  const bool degenerate = (var_ref < min_var) || (var_src < min_var);
  float cost = (degenerate || !in_bounds) ? cost_max : ncc;
  if constexpr (M == Mode::kNoScan)
    cost = __fadd_rn(cost, __fmul_rn(1e-30f, (float)acc));
  out[((size_t)k * npix + p) * V + v] = cost;
}

// A launch's arguments, as the C entry takes them
struct Args {
  const void *planes, *src, *w_taps, *wr_taps, *refsums, *consts, *taps;
  void* out;
  int V, n_views, Hg, W, Hs, Ws, T;
  float oy, ox;
  int row_pack_off;
  float cost_max, min_var;
};

// The variants a C mode number names: mode 0 the first design (on f32
// sources when src_f32), 1 full, 2 noext, 3 nobounds, 4 noscan, 5 f32take
template <typename Src>
struct First {};
template <Mode M, typename Src>
struct Current {};

template <typename Src>
auto kernel_of(First<Src>) {
  return first::first_kernel<8, Src>;
}
template <Mode M, typename Src>
auto kernel_of(Current<M, Src>) {
  return ablate_kernel<M, Src>;
}

// the dynamic shared memory each variant uses itself
template <typename Src>
size_t need_of(First<Src>, int) {
  return 0;
}
template <Mode M, typename Src>
size_t need_of(Current<M, Src>, int T) {
  return smem_bytes<8>(T);
}

template <typename Src>
void launch(First<Src>, const Args& a, size_t smem, cudaStream_t stream) {
  const int npix = a.Hg * a.W;
  const dim3 grid((npix + first::kBlock - 1) / first::kBlock, a.V);
  first::first_kernel<8, Src><<<grid, first::kBlock, smem, stream>>>(
      static_cast<const float4*>(a.planes), static_cast<const Src*>(a.src),
      static_cast<const float*>(a.w_taps),
      static_cast<const float*>(a.wr_taps),
      static_cast<const float*>(a.refsums),
      static_cast<const float*>(a.consts), static_cast<const float2*>(a.taps),
      static_cast<float*>(a.out), a.V, a.n_views, a.Hg, a.W, a.Hs, a.Ws, a.T,
      a.oy, a.ox, a.row_pack_off, a.cost_max, a.min_var);
}

template <Mode M, typename Src>
void launch(Current<M, Src>, const Args& a, size_t smem,
            cudaStream_t stream) {
  const int npix = a.Hg * a.W;
  const dim3 grid(((npix + S8::kPix - 1) / S8::kPix) * a.V);
  ablate_kernel<M, Src><<<grid, S8::kThreads, smem, stream>>>(
      static_cast<const float4*>(a.planes), static_cast<const Src*>(a.src),
      static_cast<const float*>(a.w_taps),
      static_cast<const float*>(a.wr_taps),
      static_cast<const float*>(a.refsums),
      static_cast<const float*>(a.consts), static_cast<const float2*>(a.taps),
      static_cast<float*>(a.out), a.V, a.n_views, a.Hg, a.W, a.Hs, a.Ws, a.T,
      a.oy, a.ox, a.row_pack_off, a.cost_max, a.min_var, 0u);
}

// the threads of a variant's block
template <typename Src>
int threads_of(First<Src>) {
  return first::kBlock;
}
template <Mode M, typename Src>
int threads_of(Current<M, Src>) {
  return S8::kThreads;
}

// f(variant) for a C mode number and source flag
template <typename F>
int dispatch(int mode, int src_f32, F f) {
  if (src_f32 != 0 && (mode != 0 || src_f32 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case 0:
      return src_f32 ? f(First<float>{}) : f(First<uint8_t>{});
    case 1:
      return f(Current<Mode::kFull, uint32_t>{});
    case 2:
      return f(Current<Mode::kNoExt, uint32_t>{});
    case 3:
      return f(Current<Mode::kNoBounds, uint32_t>{});
    case 4:
      return f(Current<Mode::kNoScan, uint32_t>{});
    case 5:
      return f(Current<Mode::kFull, float4>{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// A launch's dynamic shared memory (at least what the variant uses) sets
// how many blocks an SM holds: chip_smoke.py also times every mode at
// `full`'s blocks per SM, so that a mode's saving is its removed work and
// not another block per SM. It is set before each launch, so a launch
// asking for 0 runs as zncc.cu's does.
template <typename Var>
cudaError_t configure(Var var, size_t smem) {
  return cudaFuncSetAttribute(kernel_of(var),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename Var>
size_t smem_of(Var var, int T, int smem) {
  const size_t need = need_of(var, T);
  return need > (size_t)smem ? need : (size_t)smem;
}

}  // namespace

// Plain C entry points (loaded with ctypes); `mode` and `src_f32` as in
// dispatch. K is 8. `src` points at the sources the mode reads: bytes (or
// f32 with src_f32) [V, Hs, Ws] for the first design, 2x2 words
// [V, Hs, Ws] (int32) for full, noext, nobounds and noscan, 2x2 quads
// [V, Hs, Ws, 4] (f32) for f32take. `smem` is the dynamic shared memory
// to ask for (the mode's own if that is more). The launch returns
// cudaGetLastError() after it, or the error of setting the shared-memory
// attribute, or cudaErrorInvalidValue for another mode.
extern "C" int acmmp_ablate_launch(
    int mode, int src_f32, const void* planes, const void* src,
    const void* w_taps, const void* wr_taps, const void* refsums,
    const void* consts, const void* taps, void* out, int V, int n_views,
    int Hg, int W, int Hs, int Ws, int T, float oy, float ox,
    int row_pack_off, float cost_max, float min_var, int smem,
    void* stream) {
  const Args a{planes, src, w_taps, wr_taps, refsums, consts, taps, out,
               V, n_views, Hg, W, Hs, Ws, T, oy, ox, row_pack_off,
               cost_max, min_var};
  return dispatch(mode, src_f32, [&](auto var) {
    const size_t bytes = smem_of(var, T, smem);
    cudaError_t e = configure(var, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    launch(var, a, bytes, static_cast<cudaStream_t>(stream));
    return static_cast<int>(cudaGetLastError());
  });
}

// The blocks of `mode` an SM holds with T taps at the given dynamic shared
// memory, by the runtime's occupancy calculator, into *blocks, and the
// threads of its block into *threads.
extern "C" int acmmp_ablate_occupancy(int mode, int T, int smem, int* blocks,
                                      int* threads) {
  return dispatch(mode, 0, [&](auto var) {
    const size_t bytes = smem_of(var, T, smem);
    cudaError_t e = configure(var, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    *threads = threads_of(var);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel_of(var), threads_of(var), bytes));
  });
}
