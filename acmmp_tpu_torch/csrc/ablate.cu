// Ablation modes of the warped bilateral-ZNCC kernel (csrc/zncc.cu), for
// cost decomposition on Hopper (sm_90a).
//
// Replaces the TPU kernel of tools/prop_ablate.py:97 ablate_call (its
// pallas_call at :399), a replica of the JAX package's K-stack ZNCC kernel
// with switches that turn parts of its work off. zncc.cu has no row scan
// and no bounding boxes, so each mode keeps the TPU tool's name and asks
// the same question of zncc.cu's own structure: its per-tap placement
// (homography, IEEE reciprocal, NaN guard, clamps, floors), its four
// dependent byte reads, and its bilinear and moment arithmetic. The modes
// (ops/ablate.py holds their plain versions):
//   full      zncc.cu's K-stack, unchanged;
//   noext     placement and the four reads per tap kept; no bilinear
//             weights, centring or moments: s_src += w_t * (v00 + v01 +
//             v10 + v11). The centre sample c_src seeds s_src2, which no
//             tap updates, so nvcc keeps the set-up as in full;
//   nobounds  placement only at tap 0 of each hypothesis; tap t reads at
//             tap 0's corner + (di_t - di_0, dj_t - dj_0), clamped with
//             integer min/max, with tap 0's fractions;
//   noscan    no source reads: every sample is a run-time zero (an
//             argument, so nvcc cannot fold the arithmetic on it); the
//             read offsets are summed into one unsigned word whose 1e-30
//             leak enters the output, so their arithmetic stays;
//   f32take   full on the sources widened to f32 (mode 4 below; the
//             widening is done once by the wrapper, outside the launch).
// Each accumulator a mode keeps reaches the output, so nvcc removes only
// what the mode removes; the LDG and MUFU.RCP counts of each mode's SASS,
// which chip_smoke.py prints, show it.
//
// The code is a copy of zncc.cu:67-227 with the mode as a template
// parameter: `full` instantiates exactly zncc.cu's arithmetic, with its
// rounding intrinsics and fmaf, and is built with the same NVCC_FLAGS.
// zncc.cu stays untouched (it is on the solver's path); chip_smoke.py
// holds `full` bitwise equal to zncc.cu at K = 8 and f32take bitwise
// equal to full, which guards the copy against drift. Only K = 8, the
// propagation stack, is built.
//
// What bounds it: as zncc.cu, the per-tap work, not the bytes. FP32
// operations per (hypothesis, view, tap, pixel), an FMA counted as two
// (chip_smoke.py's ABLATE_OPS_PER_TAP_EVAL):
//   full, f32take, noscan  41: the tap's homography 12, the reciprocal 1,
//             the placement 10 (2 mul, 4 min/max, 2 floor, 2 sub), the
//             bilinear 11, the centring and moments 7 (zncc.cu's "about
//             40" is this tally);
//   noext     26: the homography, reciprocal and placement less its two
//             fractions (21), then 3 adds, 1 mul and 1 add;
//   nobounds  18: the bilinear and the centring and moments.
// chip_smoke.py bounds each mode by its own count and by the source bytes
// it reads (none in noscan, 4 per pixel in f32take).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeader = 16;
constexpr int kViewStride = 16;
constexpr int kBlock = 128;
constexpr int kK = 8;

enum class Mode : int { kFull = 0, kNoExt = 1, kNoBounds = 2, kNoScan = 3 };

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

// sample's reads and bilinear at a given corner and fractions (nobounds
// calls it with tap 0's fractions)
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

// zncc.cu's sample, on u8 or f32 sources: bilinear read of the view at
// the homogeneous point (px, py, pz)
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

// noext: sample's placement and reads, the four values summed unweighted
__device__ __forceinline__ float raw_sum(const uint8_t* __restrict__ img,
                                         int Ws, float px, float py,
                                         float pz, float sx_max,
                                         float sy_max, int xi_max,
                                         int yi_max) {
  int x0, y0;
  float fx, fy;
  place(px, py, pz, sx_max, sy_max, x0, y0, fx, fy);
  size_t o[4];
  corners(Ws, x0, y0, xi_max, yi_max, o);
  return __fadd_rn(__fadd_rn(__fadd_rn((float)__ldg(img + o[0]),
                                       (float)__ldg(img + o[1])),
                             (float)__ldg(img + o[2])),
                   (float)__ldg(img + o[3]));
}

// noscan: sample's placement and arithmetic on zero samples; the four
// read offsets go into `acc` instead of into loads
__device__ __forceinline__ float zero_sample(int Ws, float px, float py,
                                             float pz, float sx_max,
                                             float sy_max, int xi_max,
                                             int yi_max, float zero,
                                             unsigned& acc) {
  int x0, y0;
  float fx, fy;
  place(px, py, pz, sx_max, sy_max, x0, y0, fx, fy);
  size_t o[4];
  corners(Ws, x0, y0, xi_max, yi_max, o);
  acc += (unsigned)(o[0] + o[1] + o[2] + o[3]);
  return bilerp(zero, zero, zero, zero, fx, fy);
}

template <int K, Mode M, typename Src>
__global__ void __launch_bounds__(kBlock) ablate_kernel(
    const float4* __restrict__ planes,   // [K, npix] (nx, ny, nz, w)
    const Src* __restrict__ src,         // [V, Hs, Ws]
    const float* __restrict__ w_taps,    // [T, npix]
    const float* __restrict__ wr_taps,   // [T, npix]
    const float* __restrict__ refsums,   // [3, npix] sum_w, sum_ref, sum_ref2
    const float* __restrict__ consts,    // [kHeader + kViewStride * V]
    const float2* __restrict__ taps,     // [T] (di, dj)
    float* __restrict__ out,             // [K, npix, V]
    int V, int n_views, int Hg, int W, int Hs, int Ws, int T,
    float oy, float ox, int row_pack_off, float cost_max, float min_var,
    float zero) {
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

  unsigned acc = 0;   // noscan: the summed read offsets
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
    if constexpr (M == Mode::kNoScan) {
      h[k].c_src = zero_sample(Ws, h[k].px, h[k].py, h[k].pz, sx_max, sy_max,
                               xi_max, yi_max, zero, acc);
    } else {
      h[k].c_src = sample(img, Ws, h[k].px, h[k].py, h[k].pz, sx_max, sy_max,
                          xi_max, yi_max);
    }
  }

  // nobounds: tap 0's placement, once per hypothesis
  int x00[K], y00[K];
  float fx0[K], fy0[K];
  const float2 d0 = __ldg(taps);
  if constexpr (M == Mode::kNoBounds) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const Hyp& hk = h[k];
      place(__fmaf_rn(d0.y, hk.tx, __fmaf_rn(d0.x, hk.ux, hk.px)),
            __fmaf_rn(d0.y, hk.ty, __fmaf_rn(d0.x, hk.uy, hk.py)),
            __fmaf_rn(d0.y, hk.tz, __fmaf_rn(d0.x, hk.uz, hk.pz)), sx_max,
            sy_max, x00[k], y00[k], fx0[k], fy0[k]);
    }
  }

  float s_src[K], s_src2[K], s_rs[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    s_src[k] = s_src2[k] = s_rs[k] = 0.0f;
    if constexpr (M == Mode::kNoExt) s_src2[k] = h[k].c_src;
  }

  for (int t = 0; t < T; ++t) {
    const float2 d = __ldg(taps + t);
    const float wt = __ldg(w_taps + (size_t)t * npix + p);
    const float wrt = __ldg(wr_taps + (size_t)t * npix + p);
    const int ddi = (int)d.x - (int)d0.x;
    const int ddj = (int)d.y - (int)d0.y;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const Hyp& hk = h[k];
      if constexpr (M == Mode::kNoExt) {
        const float px = __fmaf_rn(d.y, hk.tx, __fmaf_rn(d.x, hk.ux, hk.px));
        const float py = __fmaf_rn(d.y, hk.ty, __fmaf_rn(d.x, hk.uy, hk.py));
        const float pz = __fmaf_rn(d.y, hk.tz, __fmaf_rn(d.x, hk.uz, hk.pz));
        s_src[k] = __fadd_rn(
            s_src[k], __fmul_rn(wt, raw_sum(img, Ws, px, py, pz, sx_max,
                                            sy_max, xi_max, yi_max)));
      } else {
        float val;
        if constexpr (M == Mode::kNoBounds) {
          const int x0 = min(max(x00[k] + ddi, 0), xi_max);
          const int y0 = min(max(y00[k] + ddj, 0), yi_max);
          val = __fsub_rn(
              sample_at(img, Ws, x0, y0, fx0[k], fy0[k], xi_max, yi_max),
              hk.c_src);
        } else {
          const float px =
              __fmaf_rn(d.y, hk.tx, __fmaf_rn(d.x, hk.ux, hk.px));
          const float py =
              __fmaf_rn(d.y, hk.ty, __fmaf_rn(d.x, hk.uy, hk.py));
          const float pz =
              __fmaf_rn(d.y, hk.tz, __fmaf_rn(d.x, hk.uz, hk.pz));
          if constexpr (M == Mode::kNoScan) {
            val = __fsub_rn(zero_sample(Ws, px, py, pz, sx_max, sy_max,
                                        xi_max, yi_max, zero, acc),
                            hk.c_src);
          } else {
            val = __fsub_rn(
                sample(img, Ws, px, py, pz, sx_max, sy_max, xi_max, yi_max),
                hk.c_src);
          }
        }
        const float wv = __fmul_rn(wt, val);
        s_src[k] = __fadd_rn(s_src[k], wv);
        s_src2[k] = __fmaf_rn(wv, val, s_src2[k]);
        s_rs[k] = __fmaf_rn(wrt, val, s_rs[k]);
      }
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
    float cost = (degenerate || !h[k].in_bounds) ? cost_max : ncc;
    if constexpr (M == Mode::kNoScan)
      cost = __fadd_rn(cost, __fmul_rn(1e-30f, (float)acc));
    out[((size_t)k * npix + p) * V + v] = cost;
  }
}

// A launch's dynamic shared memory (the kernel uses none) and shared-memory
// carveout preference (percent of the SM's most, or -1 for the driver's
// default) set how many blocks an SM holds: chip_smoke.py gives every mode
// the occupancy of the one with the most registers, so that a mode's
// saving is its removed work and not a fourth block per SM. Both are set
// before each launch, so a launch with 0 and -1 runs as the plain <<<>>>.
template <Mode M, typename Src>
cudaError_t configure(int smem, int carveout) {
  const auto fn = ablate_kernel<kK, M, Src>;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(
      fn, cudaFuncAttributePreferredSharedMemoryCarveout, carveout);
}

template <Mode M, typename Src>
struct Variant {
  static constexpr Mode kMode = M;
  using Source = Src;
};

// f(Variant<...>{}) for a C mode number: 0 full, 1 noext, 2 nobounds,
// 3 noscan (u8 sources), 4 f32take (full on f32 sources)
template <typename F>
int dispatch(int mode, F f) {
  switch (mode) {
    case 0:
      return f(Variant<Mode::kFull, uint8_t>{});
    case 1:
      return f(Variant<Mode::kNoExt, uint8_t>{});
    case 2:
      return f(Variant<Mode::kNoBounds, uint8_t>{});
    case 3:
      return f(Variant<Mode::kNoScan, uint8_t>{});
    case 4:
      return f(Variant<Mode::kFull, float>{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes); `mode` as in dispatch. K is
// 8. The launch returns cudaGetLastError() after it, or the error of
// setting the occupancy attributes, or cudaErrorInvalidValue for another
// mode.
extern "C" int acmmp_ablate_launch(
    int mode, const void* planes, const void* src, const void* w_taps,
    const void* wr_taps, const void* refsums, const void* consts,
    const void* taps, void* out, int V, int n_views, int Hg, int W, int Hs,
    int Ws, int T, float oy, float ox, int row_pack_off, float cost_max,
    float min_var, float zero, int smem, int carveout, void* stream) {
  return dispatch(mode, [&](auto variant) {
    using Var = decltype(variant);
    using Src = typename Var::Source;
    cudaError_t e = configure<Var::kMode, Src>(smem, carveout);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int npix = Hg * W;
    const dim3 grid((npix + kBlock - 1) / kBlock, V);
    ablate_kernel<kK, Var::kMode, Src>
        <<<grid, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const float4*>(planes), static_cast<const Src*>(src),
            static_cast<const float*>(w_taps),
            static_cast<const float*>(wr_taps),
            static_cast<const float*>(refsums),
            static_cast<const float*>(consts),
            static_cast<const float2*>(taps), static_cast<float*>(out), V,
            n_views, Hg, W, Hs, Ws, T, oy, ox, row_pack_off, cost_max,
            min_var, zero);
    return static_cast<int>(cudaGetLastError());
  });
}

// The blocks of `mode` an SM holds at the given dynamic shared memory and
// carveout, by the runtime's occupancy calculator, into *blocks.
extern "C" int acmmp_ablate_occupancy(int mode, int smem, int carveout,
                                      int* blocks) {
  return dispatch(mode, [&](auto variant) {
    using Var = decltype(variant);
    cudaError_t e = configure<Var::kMode, typename Var::Source>(smem,
                                                                carveout);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, ablate_kernel<kK, Var::kMode, typename Var::Source>, kBlock,
        smem));
  });
}
