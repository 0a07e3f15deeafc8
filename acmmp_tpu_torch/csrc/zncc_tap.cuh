// The per-tap device code of the warped bilateral-ZNCC kernel's current
// design, shared by csrc/zncc.cu (the kernel) and csrc/ablate.cu (its
// ablation modes), so that both compile the same instructions: the block
// shape, the cp.async staging, the exact byte and floor tricks, the 2x2
// element reads and the bilinear sample. zncc.cu's source note explains
// the design. Everything here is inlined into the kernels.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// consts layout: [0, 9) the reference K^{-T} row-major, then per view
// kViewStride floats from kHeader: A (9, row-major), B (3), width, height.
constexpr int kHeader = 16;
constexpr int kViewStride = 16;
// 2^23 and its f32 bit pattern: the f32 spacing in [2^23, 2^24) is 1
constexpr float kTwo23 = 8388608.0f;
constexpr int kTwo23Bits = 0x4B000000;
// __byte_perm selector for byte n of x under the three high bytes of
// kTwo23Bits (0x00, 0x00, 0x4B): kByteSelect + n gives 0x4B0000bb
constexpr unsigned kByteSelect = 0x7540;

// A block: K hypothesis rows of kPix pixels each (256 threads at K = 1, 2
// and 8; 192 at K = 3). kMinBlocks asks ptxas for at most 64 registers.
template <int K>
struct Shape {
  static constexpr int kK = K;
  static constexpr int kPix = K >= 8 ? 32 : 32 * (8 / K);
  static constexpr int kThreads = K * kPix;
  static constexpr int kMinBlocks = 65536 / (64 * kThreads);
  static constexpr bool kStage = K > 1;
};

// dynamic shared memory of a launch: the taps, then for K > 1 the block's
// (w, w * ref_c) per tap and pixel
template <int K>
size_t smem_bytes(int T) {
  using S = Shape<K>;
  return sizeof(float2) * (size_t)T * (1 + (S::kStage ? S::kPix : 0));
}

struct Hyp {
  float px, py, pz;   // centre warp (homogeneous)
  float ux, uy, uz;   // d p / d di
  float tx, ty, tz;   // d p / d dj
};

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float nan_to_zero(float a) {
  return isnan(a) ? 0.0f : a;
}

// floorf(s) and (int)floorf(s) for 0 <= s < 2^23 without the conversion
// unit: s + 2^23 rounded down is 2^23 + floor(s) exactly, whose bit
// pattern is kTwo23Bits + floor(s)
__device__ __forceinline__ float floor_u23(float s, int& i) {
  const float r = __fadd_rd(s, kTwo23);
  i = __float_as_int(r) - kTwo23Bits;
  return __fsub_rn(r, kTwo23);
}

// byte n of q as f32, exactly: (2^23 + byte) - 2^23
template <int n>
__device__ __forceinline__ float byte_f32(uint32_t q) {
  return __fsub_rn(
      __int_as_float(__byte_perm(q, kTwo23Bits, kByteSelect + n)), kTwo23);
}

// The pixels (y0, x0), (y0, x1), (y1, x0), (y1, x1) of one 2x2 word of
// bytes, as f32 through the mantissa
__device__ __forceinline__ void unpack(uint32_t q, float& v00, float& v10,
                                       float& v01, float& v11) {
  v00 = byte_f32<0>(q);
  v10 = byte_f32<1>(q);
  v01 = byte_f32<2>(q);
  v11 = byte_f32<3>(q);
}

// The pixels (y0, x0), (y0, x1), (y1, x0), (y1, x1) of a bilinear read
// from element e of the sources, as f32: a 2x2 word of bytes through the
// mantissa, or a 2x2 quad of floats as it is
__device__ __forceinline__ void corners(const uint32_t* __restrict__ src,
                                        unsigned e, float& v00, float& v10,
                                        float& v01, float& v11) {
  unpack(__ldg(src + e), v00, v10, v01, v11);
}

__device__ __forceinline__ void corners(const float4* __restrict__ src,
                                        unsigned e, float& v00, float& v10,
                                        float& v01, float& v11) {
  const float4 q = __ldg(src + e);
  v00 = q.x;
  v10 = q.y;
  v01 = q.z;
  v11 = q.w;
}

// A bilinear read's placement of the homogeneous point (px, py, pz):
// the point clamped to the true extent [0, sx_max] x [0, sy_max], its
// integer corner (x0, y0), the corner as f32 (xf, yf) and the fractions
// (fx, fy)
__device__ __forceinline__ void place(float px, float py, float pz,
                                      float sx_max, float sy_max, int& x0,
                                      int& y0, float& xf, float& yf,
                                      float& fx, float& fy) {
  const float inv_pz = __frcp_rn(pz);
  // NaN guard before the clamp, so no index is formed from a NaN
  const float sx =
      fminf(fmaxf(nan_to_zero(__fmul_rn(px, inv_pz)), 0.0f), sx_max);
  const float sy =
      fminf(fmaxf(nan_to_zero(__fmul_rn(py, inv_pz)), 0.0f), sy_max);
  xf = floor_u23(sx, x0);
  yf = floor_u23(sy, y0);
  fx = __fsub_rn(sx, xf);
  fy = __fsub_rn(sy, yf);
}

// the bilinear blend of the four pixels at fractions (fx, fy), exact f32
// weights
__device__ __forceinline__ float bilerp(float v00, float v10, float v01,
                                        float v11, float fx, float fy) {
  const float a0 = __fsub_rn(1.0f, fx);
  const float top = __fmaf_rn(fx, v10, __fmul_rn(a0, v00));
  const float bot = __fmaf_rn(fx, v11, __fmul_rn(a0, v01));
  return __fmaf_rn(fy, bot, __fmul_rn(__fsub_rn(1.0f, fy), top));
}

// Bilinear read of view v's 2x2 elements (from element voff = v * Hs * Ws
// of src) at the homogeneous point (px, py, pz), clamped to the true
// extent [0, sx_max] x [0, sy_max], exact f32 weights
template <typename Src>
__device__ __forceinline__ float sample(const Src* __restrict__ src,
                                        unsigned voff, int Ws, float px,
                                        float py, float pz, float sx_max,
                                        float sy_max) {
  int x0, y0;
  float xf, yf, fx, fy;
  place(px, py, pz, sx_max, sy_max, x0, y0, xf, yf, fx, fy);
  // an unsigned 32-bit index (V * Hs * Ws < 2^31) is one wide
  // multiply-add off src
  float v00, v10, v01, v11;
  corners(src, voff + (unsigned)(y0 * Ws + x0), v00, v10, v01, v11);
  return bilerp(v00, v10, v01, v11, fx, fy);
}

}  // namespace
