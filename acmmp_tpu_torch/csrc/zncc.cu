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
// pallas_ncc.py:292-322), reads the source bilinearly with exact f32
// weights after clamping to the view's true extent (core/geometry.py:219),
// accumulates the bilateral-weighted source sums against the reference-side
// weights the wrapper precomputes, and writes
//   clip(1 - covar / sqrt(max(var_ref * var_src, 1e-30)), 0, cost_max),
// or cost_max when a variance is below min_var, when the warped centre
// falls outside the source, or when v >= n_views (pallas_ncc.py:489-499).
//
// What bounds it here: not the bytes (the sources' 2x2 words of a
// 1600x1184 / 8-source problem are a 63 MB tensor, read view by view;
// planes, tap weights and costs stream), but the per-tap work of each
// (hypothesis, view, tap, pixel): the placement (a 3-row homography step,
// an IEEE reciprocal, the NaN guard, clamps and floors), one dependent
// gather, and the bilinear and moment arithmetic, about 40 FP32
// operations in all.
// The first design of this kernel (one thread per pixel holding all K
// hypotheses, four byte gathers per tap; csrc/ablate.cu's `first` mode
// keeps it) used 137 registers at K = 8, so an SM held 12 warps, too few
// to hide the chain of dependent loads, and spent 8 conversion-class
// instructions per (hypothesis, tap) (4 u8->f32, 2 floorf, 2 float->int
// casts), a class NVIDIA's throughput table for compute capability 9.0
// rates at an eighth of the FP32 FMA. This design answers each:
//   * one thread per (output pixel, hypothesis): a warp covers 32
//     neighbouring pixels of one hypothesis and a block stacks the K
//     hypotheses of kPix pixels (Shape below). One block per (pixel
//     chunk, view), the view the fastest index of the grid: a padded view
//     slot costs one store per (pixel, hypothesis), and the V blocks of a
//     chunk run together, so its tap weights (288 bytes a pixel at 36
//     taps) leave device memory once, where a view-major grid streamed
//     them once per view. A thread keeps one hypothesis and three
//     accumulators, under 64 registers (__launch_bounds__), so an SM holds
//     at least 30 warps (chip_smoke.py prints ptxas's registers and the
//     occupancy calculator's blocks per SM);
//   * for K > 1 the block's tap weights w and w * ref_c are copied once,
//     by cp.async, into shared memory and read there by every hypothesis
//     warp (one 8-byte LDS per tap). K = 1 reads them straight from global
//     memory: a block reads each value once, the chunk's other views find
//     it in L2, and staging would only take shared memory from the L1
//     cache that serves the gathers;
//   * the wrapper packs each source into 2x2 words (ops/cuda_ncc.py
//     pack_2x2): word (y, x) holds the bytes at (y, x), (y, x1), (y1, x)
//     and (y1, x1), the far side clamped to the view's true extent as the
//     bilinear read clamps it. A tap reads one 32-bit word through the
//     read-only path instead of four dependent bytes;
//   * no conversion-class instruction in the tap loop: a byte becomes f32
//     as 0x4B0000bb (= 2^23 + bb, one PRMT) minus 2^23, and floor(s) with
//     its integer comes from r = s + 2^23 rounded down (byte_f32 and
//     floor_u23 below); both are exact, so every rounded f32 value is the
//     one floorf, (int) and (float) gave.
// The tap loop is kept rolled (#pragma unroll 1): one word gather and one
// reciprocal per iteration, which chip_smoke.py reads from the SASS.
//
// Two source types, one template (the Src parameter), both branches of
// the JAX kernels (pallas_ncc.py:166-174, PatchMatchParams.ncc_src_u8):
//   * uint32_t, the 8-bit sources as 2x2 words (above), the default;
//   * float4, float sources as 2x2 quads of f32 (ops/cuda_ncc.py
//     pack_2x2_f32, the same order and clamp): one 16-byte gather per tap,
//     no byte select. The JAX kernel stores float sources as bf16 only to
//     fit the TPU's VMEM; ncc_src_u8=False means float sampling, as the
//     jnp oracle and the plain version compute it, so this reads f32. The
//     quads take 16 bytes a source pixel (252 MB at 1600x1184 / 8
//     sources, against 63 MB of words), which the card's memory affords;
//     four scalar loads from one f32 map would put four dependent gathers
//     back into the tap loop.
// Everything else, placement, bilinear, moments and epilogue, is the same
// code: a byte becomes f32 exactly, so on u8-valued floats the float4
// instantiation gives the uint32_t one's bits.
//
// One launch serves a batch of B reference views (the batched executor,
// acmmp_tpu_torch/pipeline/batched.py): blockIdx.y is the view b of the
// batch. Each view has its own sources, reference-side weights and sums,
// constants and true source count, so the views of a batch may pad
// different slots; the hypothesis stacks and costs are candidate-major,
// planes [K, B, npix] and costs [K, B, npix, V], the solver's layout. The
// B source counts ride in the kernel's parameters (ViewCounts, read from
// the constant bank), so a padded slot's block exits before any load.
// Every offset of view b is a row index built from the block-uniform b
// (with per-thread 64-bit offsets, ptxas recomputed the pixel index
// inside the K = 1 tap loop: 88 SASS instructions a tap against 78), so
// the tap loop keeps its instructions, and a view's costs are bitwise
// those of a launch of that view alone. A launch of one view (B = 1)
// runs the instantiation without a batch (kBatch false, b = 0), whose
// code is the single-view kernel's: with the batch index the K = 8
// launch took 1.5% longer, and chip_smoke.py phase 6, which times it in
// turns against the first design, allows 1% over the recorded ratio.
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
// pins this for its kernels, test_k_shared_matches_per_k), and this design
// bitwise equal to the first one. So the per-hypothesis arithmetic is
// written with explicit rounding intrinsics and fmaf only, in the first
// design's order: nothing is left to the compiler's FMA contraction, and
// no arithmetic depends on K. Build without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

// the block shape, staging, byte and floor tricks and the bilinear
// sample, shared with csrc/ablate.cu
#include "zncc_tap.cuh"

namespace {

// the largest batch of one launch, and its views' true source counts
constexpr int kMaxBatch = 256;
struct ViewCounts {
  int n[kMaxBatch];
};

template <int K, typename Src, bool kBatch>
__global__ void __launch_bounds__(Shape<K>::kThreads, Shape<K>::kMinBlocks)
    zncc_kernel(const float4* __restrict__ planes,   // [K, B, npix] (n, w)
                const Src* __restrict__ src,   // [B, V, Hs, Ws] 2x2 each
                const float* __restrict__ w_taps,    // [B, T, npix]
                const float* __restrict__ wr_taps,   // [B, T, npix]
                const float* __restrict__ refsums,   // [B, 3, npix]
                const float* __restrict__ consts,    // [B, kHeader + 16 V]
                const float2* __restrict__ taps,     // [T] (di, dj)
                const ViewCounts n_views,            // [B]
                float* __restrict__ out,             // [K, B, npix, V]
                int B, int V, int Hg, int W, int Hs, int Ws, int T,
                float oy, float ox, int row_pack_off, float cost_max,
                float min_var) {
  using S = Shape<K>;
  extern __shared__ float2 smem[];   // [T] taps, then [T][kPix] (w, wr)
  const int npix = Hg * W;
  const int lane = threadIdx.x % S::kPix;   // pixel within the block
  const int k = threadIdx.x / S::kPix;      // hypothesis
  // views are the fastest grid index: the V blocks of a pixel chunk run
  // together, so its tap weights come from device memory once, then L2
  const int chunk = blockIdx.x / V;
  const int v = blockIdx.x - chunk * V;
  const int p = chunk * S::kPix + lane;
  // view b of the batch (0 in a launch of one view, B = 1): row
  // kb = k * B + b of the hypotheses and costs, rows b * T + t of the tap
  // weights, b * 3 + r of the reference sums, and b's block of the
  // constants and sources
  const int b = kBatch ? static_cast<int>(blockIdx.y) : 0;
  const int kb = kBatch ? k * B + b : k;
  if (v >= n_views.n[b]) {
    if (p < npix) out[((size_t)kb * npix + p) * V + v] = cost_max;
    return;
  }
  const int tb = b * T;
  const float* cb = consts + b * (kHeader + kViewStride * V);
  // the ragged block's extra threads work on the last pixel and store
  // nothing; they take part in the staging and the barrier
  const int pc = min(p, npix - 1);

  float2* s_taps = smem;
  float2* s_w = smem + T;
  for (int t = threadIdx.x; t < T; t += S::kThreads)
    cp_async(s_taps + t, taps + t, 8);
  if constexpr (S::kStage) {
    for (int t = k; t < T; t += K) {
      float2* dst = s_w + t * S::kPix + lane;
      cp_async(&dst->x, w_taps + (size_t)(tb + t) * npix + pc, 4);
      cp_async(&dst->y, wr_taps + (size_t)(tb + t) * npix + pc, 4);
    }
  }
  cp_async_commit();

  // set-up, while the copies land
  const int i = pc / W;
  const int j = pc - i * W;
  const int rr = row_pack_off >= 0 ? 2 * i + ((row_pack_off + j) & 1) : i;
  const float yy = __fadd_rn((float)rr, oy);
  const float xx = __fadd_rn((float)j, ox);

  const float* c = cb + kHeader + v * kViewStride;
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

  // view (b, v)'s 2x2 elements; B * V * Hs * Ws < 2^31 (the wrapper)
  const unsigned voff = (unsigned)((b * V + v) * Hs * Ws);
  float kr[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) kr[q] = __ldg(cb + q);

  const float4 pl = __ldg(planes + (size_t)kb * npix + pc);
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
  const float c_src =
      sample(src, voff, Ws, h.px, h.py, h.pz, sx_max, sy_max);

  cp_async_wait_all();
  __syncthreads();
  if (p >= npix) return;

  float s_src = 0.0f, s_src2 = 0.0f, s_rs = 0.0f;
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    const float2 d = s_taps[t];
    float wt, wrt;
    if constexpr (S::kStage) {
      const float2 ww = s_w[t * S::kPix + lane];
      wt = ww.x;
      wrt = ww.y;
    } else {
      wt = __ldg(w_taps + (size_t)(tb + t) * npix + p);
      wrt = __ldg(wr_taps + (size_t)(tb + t) * npix + p);
    }
    const float px = __fmaf_rn(d.y, h.tx, __fmaf_rn(d.x, h.ux, h.px));
    const float py = __fmaf_rn(d.y, h.ty, __fmaf_rn(d.x, h.uy, h.py));
    const float pz = __fmaf_rn(d.y, h.tz, __fmaf_rn(d.x, h.uz, h.pz));
    const float val =
        __fsub_rn(sample(src, voff, Ws, px, py, pz, sx_max, sy_max), c_src);
    const float wv = __fmul_rn(wt, val);
    s_src = __fadd_rn(s_src, wv);
    s_src2 = __fmaf_rn(wv, val, s_src2);
    s_rs = __fmaf_rn(wrt, val, s_rs);
  }

  const float sum_w = __ldg(refsums + (size_t)(3 * b) * npix + p);
  const float sum_ref = __ldg(refsums + (size_t)(3 * b + 1) * npix + p);
  const float sum_ref2 = __ldg(refsums + (size_t)(3 * b + 2) * npix + p);
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
  out[((size_t)kb * npix + p) * V + v] =
      (degenerate || !in_bounds) ? cost_max : ncc;
}

template <int K, typename Src>
cudaError_t launch(const void* planes, const void* src, const void* w_taps,
                   const void* wr_taps, const void* refsums,
                   const void* consts, const void* taps,
                   const ViewCounts& n_views, void* out, int B, int V, int Hg,
                   int W, int Hs, int Ws, int T, float oy, float ox,
                   int row_pack_off, float cost_max, float min_var,
                   cudaStream_t stream) {
  using S = Shape<K>;
  const auto kernel = B > 1 ? zncc_kernel<K, Src, true>
                            : zncc_kernel<K, Src, false>;
  const size_t smem = smem_bytes<K>(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int npix = Hg * W;
  const dim3 grid(((npix + S::kPix - 1) / S::kPix) * V, B);
  kernel<<<grid, S::kThreads, smem, stream>>>(
      static_cast<const float4*>(planes), static_cast<const Src*>(src),
      static_cast<const float*>(w_taps), static_cast<const float*>(wr_taps),
      static_cast<const float*>(refsums), static_cast<const float*>(consts),
      static_cast<const float2*>(taps), n_views, static_cast<float*>(out), B,
      V, Hg, W, Hs, Ws, T, oy, ox, row_pack_off, cost_max, min_var);
  return cudaGetLastError();
}

template <int K, typename Src>
cudaError_t occupancy(int T, int batched, int* blocks, int* threads) {
  *threads = Shape<K>::kThreads;
  const auto kernel = batched ? zncc_kernel<K, Src, true>
                              : zncc_kernel<K, Src, false>;
  const size_t smem = smem_bytes<K>(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, Shape<K>::kThreads, smem);
}

// f(Shape<K>{}, Src{}) for a supported K and source type (src_f32: 0 the
// 2x2 words of 8-bit sources, 1 the 2x2 quads of float sources)
template <typename F>
int dispatch(int K, int src_f32, F f) {
  if (src_f32 != 0 && src_f32 != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto by_type = [&](auto shape) {
    return src_f32 ? static_cast<int>(f(shape, float4{}))
                   : static_cast<int>(f(shape, uint32_t{}));
  };
  switch (K) {
    case 1:
      return by_type(Shape<1>{});
    case 2:
      return by_type(Shape<2>{});
    case 3:
      return by_type(Shape<3>{});
    case 8:
      return by_type(Shape<8>{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes). `src` points at the sources'
// 2x2 words [B, V, Hs, Ws] (int32) when src_f32 is 0, at their 2x2 quads
// [B, V, Hs, Ws, 4] (f32) when it is 1; `n_views` at the B views' true
// source counts on the host. The launch returns cudaGetLastError() after
// it, or cudaErrorInvalidValue for an unsupported K or source type or a
// batch outside [1, kMaxBatch].
extern "C" int acmmp_zncc_launch(
    int K, int src_f32, const void* planes, const void* src,
    const void* w_taps, const void* wr_taps, const void* refsums,
    const void* consts, const void* taps, const int* n_views, void* out,
    int B, int V, int Hg, int W, int Hs, int Ws, int T, float oy, float ox,
    int row_pack_off, float cost_max, float min_var, void* stream) {
  if (B < 1 || B > kMaxBatch) return static_cast<int>(cudaErrorInvalidValue);
  ViewCounts counts = {};
  for (int b = 0; b < B; ++b) counts.n[b] = n_views[b];
  return dispatch(K, src_f32, [&](auto shape, auto src_type) {
    return launch<decltype(shape)::kK, decltype(src_type)>(
        planes, src, w_taps, wr_taps, refsums, consts, taps, counts, out, B,
        V, Hg, W, Hs, Ws, T, oy, ox, row_pack_off, cost_max, min_var,
        static_cast<cudaStream_t>(stream));
  });
}

// The blocks of zncc_kernel<K, Src, batched> an SM holds with T taps, by
// the runtime's occupancy calculator, into *blocks, and the threads of a
// block into *threads.
extern "C" int acmmp_zncc_occupancy(int K, int src_f32, int T, int batched,
                                    int* blocks, int* threads) {
  return dispatch(K, src_f32, [&](auto shape, auto src_type) {
    return occupancy<decltype(shape)::kK, decltype(src_type)>(
        T, batched, blocks, threads);
  });
}
