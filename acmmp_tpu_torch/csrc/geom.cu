// Geometric-consistency cost for K plane hypotheses, written for Hopper
// (sm_90a).
//
// Replaces acmmp_tpu/ops/pallas_geom.py:49 geom_consistency_cost_pallas
// and computes its function (ComputeGeomConsistencyCost,
// src/ACMMP.cu:518-543). For every output pixel p of the full grid or the
// parity-packed half grid, source view v < n_views and hypothesis k:
//   d   = depth of plane k at p;
//   Xw  = world point of (p, d) in the reference camera;
//   u,w = projection of Xw into view v;
//   sd  = view v's depth map at the truncated (u, w), clamped to the view's
//         true extent;
//   Xs  = world point of (u, w, sd) in view v;
//   b   = projection of Xs into the reference camera;
// and it writes min(|p - b|, max_cost), or max_cost where sd <= 0, where
// the error is NaN, or for v >= n_views (a padded slot: nothing is read).
// Packed pixel (i, j) is full-grid row 2i + (off0 + j) % 2
// (pallas_geom.py:100-105); the port's solver has no tiles, so the grid's
// origin is (0, 0).
//
// Arithmetic: f32, in the order of the plain version (ops/geom.py, the
// JAX oracle's staged form: world_point -> project -> nearest read ->
// world_point -> project, each 3x3 product summed j = 0, 1, 2), with
// explicit __fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn so that no FMA
// contraction moves a truncation knife-edge, and no division becomes a
// reciprocal. The source coordinates are made finite (NaN -> 0) and
// clamped in float before an integer is formed: torch and CUDA convert
// NaN to an integer differently, and for finite coordinates this equals
// the oracle's truncate-then-clip. Both designs below compute the same
// rounded operations, so each is bitwise equal to the plain version.
// Build without --use_fast_math.
//
// Operations: 141 FP32 operations per (k, v, pixel) and 6 per (v, pixel),
// an FMA counted as two (chip_smoke.py's GEOM_OPS_PER_EVAL and
// GEOM_OPS_PER_PIXEL_VIEW). Of the 141, 32 depend on k only (the plane's
// depth 8, its reference world point 24) and 109 on (k, v) (the
// projection into v 35, the two index clamps 6, v's world point 24, the
// projection back 35, the error 9); the 6 are the pixel's two terms of
// the plane depth (4) and v's two clamp limits (2). The function moves a
// 16-byte plane per (k, pixel), a 4-byte depth per (v, source pixel) and a
// 4-byte cost per (k, v, pixel): at K = 8 and 8 views 23 operations per
// byte, at K = 1 about 14, either side of the card's balance point of 20
// (67 TFLOP/s over 3.35 TB/s).
//
// What bounds it here, and the design. The first design (geom_first_
// kernel below, kept frozen as the bitwise and timing yardstick, never on
// the main path) ran one thread per (pixel, view) with blockIdx.y over
// views and the K hypotheses looped inside. Read from its source, four
// things held it at 10-13x its bound: each warp's 32 stores landed V
// floats apart in the [K, Hg, W, V] output, so every 32-byte sector was
// written 4 bytes at a time by 8 passes over the grid (partial-sector
// writes, 242 MB of them at K = 8); the 121 MB plane stack, larger than
// the 50 MB L2, was read from device memory once per view; the plane's
// depth and reference world point (3 of its 9 IEEE divisions per (k, v))
// were redone for every view; and every thread loaded 42 camera constants
// through __ldg. This design answers each:
//   * one thread per (output pixel, hypothesis), the views looped inside
//     the thread: the plane is read once, and its depth and world point
//     computed once per (k, pixel); the view loop holds 6 IEEE divisions
//     and one square root per (k, v), where the first design had 9 and
//     one;
//   * a block covers kBlock neighbouring pixels of one hypothesis, so a
//     warp's plane reads are 32 consecutive float4; the hypothesis is the
//     fastest grid index, so the K blocks of a pixel chunk run together
//     and read the same band of the source depth maps (the resident
//     blocks' bands, about 340 source rows a view at 1600x1184, stay in
//     L2 where the whole maps, 63 MB, do not), and the grid walks the
//     reference rows in order;
//   * each thread writes its V costs contiguously, out[(k npix + p) V + v]:
//     where V is a multiple of 4 the views go in fours, one 16-byte store
//     each (two per thread at V = 8, so a warp writes 1 KB contiguous);
//     otherwise one 4-byte store per view (phase 3c's V = 5);
//   * the camera constants (24 + 24 V floats) are staged once per block in
//     shared memory.
// What bounds it now: the instructions it issues. On the H100 ptxas gives
// it 47-48 registers (10 blocks of 128 threads per SM by the occupancy
// calculator), and its view loop holds about 250 SASS instructions per
// (k, v): the 109 FP32 operations, the 6 IEEE divisions' Newton steps and
// checks, the square root's, the clamps and the constants re-read from
// shared memory (about 21 LDS a view). At 1600x1184, K = 8 and 8 views
// that is 1.5e10 instructions, about 0.45 ms at the card's issue rate,
// against 0.13 ms for its FP32 operations alone. chip_smoke.py prints
// the registers and blocks per SM (phase 6) and reads the view loop's
// reciprocals and stores from the SASS (phase 9d).

#include <cuda_runtime.h>

namespace {

// consts layout (floats): reference K (9), R (9), t (3) from 0; then per
// view, kViewStride floats from kHeader: K (9), R (9), t (3), width,
// height. All 3x3 matrices row-major.
constexpr int kHeader = 24;
constexpr int kViewStride = 24;
constexpr int kBlock = 128;
// ptxas keeps the redesign under 64 registers: at least 8 blocks (32
// warps) per SM
constexpr int kMinBlocks = 8;

// sum_j m[j] * v[j], j = 0, 1, 2 in order (geometry.matvec's row sum)
__device__ __forceinline__ float dot3(float m0, float m1, float m2, float v0,
                                      float v1, float v2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(m0, v0), __fmul_rn(m1, v1)),
                   __fmul_rn(m2, v2));
}

// NaN -> 0, clamp to [0, hi] in float, then truncate
__device__ __forceinline__ int clamp_index(float a, float hi) {
  const float f = isnan(a) ? 0.0f : a;
  return (int)fminf(fmaxf(f, 0.0f), hi);
}

// ---- the redesign: the camera constants read from shared memory ----

// world point of pixel (x, y) at depth d (geometry.world_point) in the
// camera of constants c (K at 0, R at 9, t at 18): backproject, then
// R^T (X - t)
__device__ __forceinline__ void world_point(const float* c, float x, float y,
                                            float d, float w[3]) {
  const float X0 = __fdiv_rn(__fmul_rn(d, __fsub_rn(x, c[2])), c[0]);
  const float X1 = __fdiv_rn(__fmul_rn(d, __fsub_rn(y, c[5])), c[4]);
  const float e0 = __fsub_rn(X0, c[18]);
  const float e1 = __fsub_rn(X1, c[19]);
  const float e2 = __fsub_rn(d, c[20]);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    w[i] = dot3(c[9 + i], c[12 + i], c[15 + i], e0, e1, e2);
}

// pixel coordinates of world point w (geometry.project): K (R w + t)
__device__ __forceinline__ void project(const float* c, const float w[3],
                                        float& u, float& v) {
  float xc[3], h[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    xc[i] = __fadd_rn(dot3(c[9 + 3 * i], c[10 + 3 * i], c[11 + 3 * i], w[0],
                           w[1], w[2]),
                      c[18 + i]);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    h[i] = dot3(c[3 * i], c[3 * i + 1], c[3 * i + 2], xc[0], xc[1], xc[2]);
  u = __fdiv_rn(h[0], h[2]);
  v = __fdiv_rn(h[1], h[2]);
}

// the (k, v) part: view v's cost of the reference world point xw of pixel
// (xx, yy); cv is v's constants, dmap its depth map
__device__ __forceinline__ float view_cost(const float* ref, const float* cv,
                                           const float* __restrict__ dmap,
                                           int Ws, const float xw[3],
                                           float xx, float yy,
                                           float max_cost) {
  const float sx_max = __fsub_rn(cv[21], 1.0f);
  const float sy_max = __fsub_rn(cv[22], 1.0f);
  float u, w;
  project(cv, xw, u, w);
  const int ui = clamp_index(u, sx_max);
  const int wi = clamp_index(w, sy_max);
  const float sd = __ldg(dmap + (size_t)wi * Ws + ui);
  float xs[3];
  world_point(cv, u, w, sd, xs);
  float bu, bv;
  project(ref, xs, bu, bv);
  const float dx = __fsub_rn(xx, bu);
  const float dy = __fsub_rn(yy, bv);
  float err = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
  err = isnan(err) ? max_cost : fminf(err, max_cost);
  return sd <= 0.0f ? max_cost : err;
}

// kVec4: V is a multiple of 4 and each thread's costs go in 16-byte stores
template <bool kVec4>
__global__ void __launch_bounds__(kBlock, kMinBlocks) geom_kernel(
    const float4* __restrict__ planes,  // [K, npix] (nx, ny, nz, w)
    const float* __restrict__ depths,   // [V, Hs, Ws]
    const float* __restrict__ consts,   // [kHeader + kViewStride * V]
    float* __restrict__ out,            // [K, npix, V]
    int K, int V, int n_views, int Hg, int W, int Hs, int Ws,
    int row_pack_off, float max_cost) {
  extern __shared__ float s_consts[];   // consts, staged once per block
  const int n_consts = kHeader + kViewStride * V;
  for (int q = threadIdx.x; q < n_consts; q += kBlock)
    s_consts[q] = __ldg(consts + q);
  __syncthreads();

  const int npix = Hg * W;
  // the hypothesis is the fastest grid index: the K blocks of a pixel
  // chunk run together on the same depth-map band
  const int chunk = blockIdx.x / K;
  const int k = blockIdx.x - chunk * K;
  const int p = chunk * kBlock + threadIdx.x;
  if (p >= npix) return;

  const int i = p / W;
  const int j = p - i * W;
  const int rr = row_pack_off >= 0 ? 2 * i + ((row_pack_off + j) & 1) : i;
  const float yy = (float)rr;
  const float xx = (float)j;
  const float* ref = s_consts;

  // the k part: geometry.depth_from_plane, then the reference world point
  const float fx = ref[0], fy = ref[4];
  const float xmc = __fsub_rn(xx, ref[2]);
  const float ymc_r = __fmul_rn(__fdiv_rn(fx, fy), __fsub_rn(yy, ref[5]));
  const float4 pl = __ldg(planes + (size_t)k * npix + p);
  const float denom =
      __fadd_rn(__fadd_rn(__fmul_rn(xmc, pl.x), __fmul_rn(ymc_r, pl.y)),
                __fmul_rn(fx, pl.z));
  const float d = __fdiv_rn(__fmul_rn(-pl.w, fx), denom);
  float xw[3];
  world_point(ref, xx, yy, d, xw);

  // the (k, v) part: V costs, contiguous
  float* o = out + ((size_t)k * npix + p) * V;
  const size_t map = (size_t)Hs * Ws;
  if constexpr (kVec4) {
#pragma unroll 1
    for (int v0 = 0; v0 < V; v0 += 4) {
      float c[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int v = v0 + q;
        c[q] = v < n_views
                   ? view_cost(ref, s_consts + kHeader + v * kViewStride,
                               depths + v * map, Ws, xw, xx, yy, max_cost)
                   : max_cost;
      }
      *reinterpret_cast<float4*>(o + v0) = make_float4(c[0], c[1], c[2], c[3]);
    }
  } else {
#pragma unroll 1
    for (int v = 0; v < V; ++v)
      o[v] = v < n_views
                 ? view_cost(ref, s_consts + kHeader + v * kViewStride,
                             depths + v * map, Ws, xw, xx, yy, max_cost)
                 : max_cost;
  }
}

size_t smem_bytes(int V) {
  return sizeof(float) * (size_t)(kHeader + kViewStride * V);
}

// the redesign's instantiation for V views
template <typename F>
cudaError_t by_vec(int V, F f) {
  return V % 4 == 0 ? f(geom_kernel<true>) : f(geom_kernel<false>);
}

cudaError_t launch(int K, const void* planes, const void* depths,
                   const void* consts, void* out, int V, int n_views, int Hg,
                   int W, int Hs, int Ws, int row_pack_off, float max_cost,
                   cudaStream_t stream) {
  const int npix = Hg * W;
  const size_t smem = smem_bytes(V);
  const dim3 grid(((npix + kBlock - 1) / kBlock) * K);
  return by_vec(V, [&](auto kernel) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    kernel<<<grid, kBlock, smem, stream>>>(
        static_cast<const float4*>(planes), static_cast<const float*>(depths),
        static_cast<const float*>(consts), static_cast<float*>(out), K, V,
        n_views, Hg, W, Hs, Ws, row_pack_off, max_cost);
    return cudaGetLastError();
  });
}

// ---- the first design, frozen: the bitwise and timing yardstick ----

struct Cam {
  float k[9], r[9], t[3];
};

__device__ __forceinline__ void load_cam(const float* __restrict__ c,
                                         Cam& cam) {
#pragma unroll
  for (int q = 0; q < 9; ++q) cam.k[q] = __ldg(c + q);
#pragma unroll
  for (int q = 0; q < 9; ++q) cam.r[q] = __ldg(c + 9 + q);
#pragma unroll
  for (int q = 0; q < 3; ++q) cam.t[q] = __ldg(c + 18 + q);
}

// world point of pixel (x, y) at depth d (geometry.world_point):
// backproject, then R^T (X - t)
__device__ __forceinline__ void world_point(const Cam& c, float x, float y,
                                            float d, float w[3]) {
  const float X0 = __fdiv_rn(__fmul_rn(d, __fsub_rn(x, c.k[2])), c.k[0]);
  const float X1 = __fdiv_rn(__fmul_rn(d, __fsub_rn(y, c.k[5])), c.k[4]);
  const float e0 = __fsub_rn(X0, c.t[0]);
  const float e1 = __fsub_rn(X1, c.t[1]);
  const float e2 = __fsub_rn(d, c.t[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    w[i] = dot3(c.r[i], c.r[3 + i], c.r[6 + i], e0, e1, e2);
}

// pixel coordinates of world point w (geometry.project): K (R w + t)
__device__ __forceinline__ void project(const Cam& c, const float w[3],
                                        float& u, float& v) {
  float xc[3], h[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    xc[i] = __fadd_rn(dot3(c.r[3 * i], c.r[3 * i + 1], c.r[3 * i + 2], w[0],
                           w[1], w[2]),
                      c.t[i]);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    h[i] = dot3(c.k[3 * i], c.k[3 * i + 1], c.k[3 * i + 2], xc[0], xc[1],
                xc[2]);
  u = __fdiv_rn(h[0], h[2]);
  v = __fdiv_rn(h[1], h[2]);
}

// one thread per (output pixel, view), blockIdx.y over views, the K
// hypotheses looped inside
template <int K>
__global__ void __launch_bounds__(kBlock) geom_first_kernel(
    const float4* __restrict__ planes,  // [K, npix] (nx, ny, nz, w)
    const float* __restrict__ depths,   // [V, Hs, Ws]
    const float* __restrict__ consts,   // [kHeader + kViewStride * V]
    float* __restrict__ out,            // [K, npix, V]
    int V, int n_views, int Hg, int W, int Hs, int Ws, int row_pack_off,
    float max_cost) {
  const int npix = Hg * W;
  const int p = blockIdx.x * kBlock + threadIdx.x;
  const int v = blockIdx.y;
  if (p >= npix) return;
  if (v >= n_views) {
#pragma unroll
    for (int k = 0; k < K; ++k) out[((size_t)k * npix + p) * V + v] = max_cost;
    return;
  }

  const int i = p / W;
  const int j = p - i * W;
  const int rr = row_pack_off >= 0 ? 2 * i + ((row_pack_off + j) & 1) : i;
  const float yy = (float)rr;
  const float xx = (float)j;

  Cam ref, src;
  load_cam(consts, ref);
  const float* cv = consts + kHeader + v * kViewStride;
  load_cam(cv, src);
  const float sx_max = __fsub_rn(__ldg(cv + 21), 1.0f);
  const float sy_max = __fsub_rn(__ldg(cv + 22), 1.0f);
  const float* dmap = depths + (size_t)v * Hs * Ws;

  // geometry.depth_from_plane's pixel terms
  const float fx = ref.k[0], fy = ref.k[4];
  const float xmc = __fsub_rn(xx, ref.k[2]);
  const float ymc_r = __fmul_rn(__fdiv_rn(fx, fy), __fsub_rn(yy, ref.k[5]));

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float4 pl = __ldg(planes + (size_t)k * npix + p);
    const float denom = __fadd_rn(
        __fadd_rn(__fmul_rn(xmc, pl.x), __fmul_rn(ymc_r, pl.y)),
        __fmul_rn(fx, pl.z));
    const float d = __fdiv_rn(__fmul_rn(-pl.w, fx), denom);

    float xw[3];
    world_point(ref, xx, yy, d, xw);
    float u, w;
    project(src, xw, u, w);
    const int ui = clamp_index(u, sx_max);
    const int wi = clamp_index(w, sy_max);
    const float sd = __ldg(dmap + (size_t)wi * Ws + ui);

    float xs[3];
    world_point(src, u, w, sd, xs);
    float bu, bv;
    project(ref, xs, bu, bv);
    const float dx = __fsub_rn(xx, bu);
    const float dy = __fsub_rn(yy, bv);
    float err = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
    err = isnan(err) ? max_cost : fminf(err, max_cost);
    out[((size_t)k * npix + p) * V + v] = sd <= 0.0f ? max_cost : err;
  }
}

template <int K>
cudaError_t launch_first(const void* planes, const void* depths,
                         const void* consts, void* out, int V, int n_views,
                         int Hg, int W, int Hs, int Ws, int row_pack_off,
                         float max_cost, cudaStream_t stream) {
  const int npix = Hg * W;
  const dim3 grid((npix + kBlock - 1) / kBlock, V);
  geom_first_kernel<K><<<grid, kBlock, 0, stream>>>(
      static_cast<const float4*>(planes), static_cast<const float*>(depths),
      static_cast<const float*>(consts), static_cast<float*>(out), V, n_views,
      Hg, W, Hs, Ws, row_pack_off, max_cost);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launch returns
// cudaGetLastError() after it, or cudaErrorInvalidValue for an
// unsupported K (the redesign takes any K >= 1; the first design is built
// for the solver's 1, 5 and 8).
extern "C" int acmmp_geom_launch(int K, const void* planes, const void* depths,
                                 const void* consts, void* out, int V,
                                 int n_views, int Hg, int W, int Hs, int Ws,
                                 int row_pack_off, float max_cost,
                                 void* stream) {
  if (K < 1 || V < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(K, planes, depths, consts, out, V, n_views,
                                 Hg, W, Hs, Ws, row_pack_off, max_cost,
                                 static_cast<cudaStream_t>(stream)));
}

// The first design, for chip_smoke.py's bitwise check and timing in turns
// and the cuda-marked test; never on the main path.
extern "C" int acmmp_geom_first_launch(int K, const void* planes,
                                       const void* depths, const void* consts,
                                       void* out, int V, int n_views, int Hg,
                                       int W, int Hs, int Ws, int row_pack_off,
                                       float max_cost, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1:
      return launch_first<1>(planes, depths, consts, out, V, n_views, Hg, W,
                             Hs, Ws, row_pack_off, max_cost, s);
    case 5:
      return launch_first<5>(planes, depths, consts, out, V, n_views, Hg, W,
                             Hs, Ws, row_pack_off, max_cost, s);
    case 8:
      return launch_first<8>(planes, depths, consts, out, V, n_views, Hg, W,
                             Hs, Ws, row_pack_off, max_cost, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The blocks of the redesign an SM holds for V views, by the runtime's
// occupancy calculator, into *blocks, and the threads of a block into
// *threads.
extern "C" int acmmp_geom_occupancy(int V, int* blocks, int* threads) {
  if (V < 1) return static_cast<int>(cudaErrorInvalidValue);
  *threads = kBlock;
  const size_t smem = smem_bytes(V);
  return static_cast<int>(by_vec(V, [&](auto kernel) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                         kBlock, smem);
  }));
}
