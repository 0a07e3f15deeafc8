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
// contraction moves a truncation knife-edge. The source coordinates are
// made finite (NaN -> 0) and clamped in float before an integer is formed:
// torch and CUDA convert NaN to an integer differently, and for finite
// coordinates this equals the oracle's truncate-then-clip. Build without
// --use_fast_math.
//
// What bounds it here: neither clearly. Per (k, v, pixel) it does 141
// FP32 operations (plane depth 8, two world points 24 each, two
// projections 35 each, two index clamps 6, the error 9), plus 6 per
// (v, pixel) outside the k loop, against a 16-byte plane read shared by
// the V views, a 4-byte depth read and a 4-byte store: at K=8 and 8 views
// that is 23 operations per byte the function must move, at K=1 about 14,
// either side of the card's balance point of 20 (67 TFLOP/s over
// 3.35 TB/s). The design keeps it plain: one thread per output pixel,
// blockIdx.y over views so a padded slot costs one store per hypothesis,
// K looped inside, the camera constants read once per thread through the
// read-only path, and the depth read one __ldg of const float* __restrict__
// (no row-scan gather, no resident depth block: both existed only because
// Mosaic's gather is slow).
//
// First thing for a later redesign: at 1600x1184 the 8 f32 source depth
// maps take 63 MB, more than the H100's 50 MB L2, and each view's reads
// follow the projection of the reference grid into that view. Reading
// them as f16, or ordering blocks so the views' windows stay resident,
// are the levers; the output layout [K, Hg, W, V] also makes each warp's
// stores V floats apart.

#include <cuda_runtime.h>

namespace {

// consts layout (floats): reference K (9), R (9), t (3) from 0; then per
// view, kViewStride floats from kHeader: K (9), R (9), t (3), width,
// height. All 3x3 matrices row-major.
constexpr int kHeader = 24;
constexpr int kViewStride = 24;
constexpr int kBlock = 128;

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

// sum_j m[j] * v[j], j = 0, 1, 2 in order (geometry.matvec's row sum)
__device__ __forceinline__ float dot3(float m0, float m1, float m2, float v0,
                                      float v1, float v2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(m0, v0), __fmul_rn(m1, v1)),
                   __fmul_rn(m2, v2));
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

// NaN -> 0, clamp to [0, hi] in float, then truncate
__device__ __forceinline__ int clamp_index(float a, float hi) {
  const float f = isnan(a) ? 0.0f : a;
  return (int)fminf(fmaxf(f, 0.0f), hi);
}

template <int K>
__global__ void __launch_bounds__(kBlock) geom_kernel(
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
cudaError_t launch(const void* planes, const void* depths, const void* consts,
                   void* out, int V, int n_views, int Hg, int W, int Hs,
                   int Ws, int row_pack_off, float max_cost,
                   cudaStream_t stream) {
  const int npix = Hg * W;
  const dim3 grid((npix + kBlock - 1) / kBlock, V);
  geom_kernel<K><<<grid, kBlock, 0, stream>>>(
      static_cast<const float4*>(planes), static_cast<const float*>(depths),
      static_cast<const float*>(consts), static_cast<float*>(out), V, n_views,
      Hg, W, Hs, Ws, row_pack_off, max_cost);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for an unsupported K.
extern "C" int acmmp_geom_launch(int K, const void* planes, const void* depths,
                                 const void* consts, void* out, int V,
                                 int n_views, int Hg, int W, int Hs, int Ws,
                                 int row_pack_off, float max_cost,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1:
      return launch<1>(planes, depths, consts, out, V, n_views, Hg, W, Hs, Ws,
                       row_pack_off, max_cost, s);
    case 5:
      return launch<5>(planes, depths, consts, out, V, n_views, Hg, W, Hs, Ws,
                       row_pack_off, max_cost, s);
    case 8:
      return launch<8>(planes, depths, consts, out, V, n_views, Hg, W, Hs, Ws,
                       row_pack_off, max_cost, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
