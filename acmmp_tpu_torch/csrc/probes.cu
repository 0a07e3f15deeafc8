// Lane probes on one (8, 128) tile of int32 words, for Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package's probe tools:
//   * tools/mosaic_probe.py:57 run (pallas_call :58) with its kernels
//     k_taa_i32 (:36), k_taa_axis0_i32 (:53), k_dyn_shift (:40) and
//     k_unpack (:45): a lane gather along each axis, a per-lane variable
//     logical shift, a byte unpack;
//   * tools/prop_ablate.py:436 nan_take_probe (pallas_call :461) with its
//     kernels k_i32 (:451) and k_f32 (:455): a gather and select on int32
//     words, and the same through float registers, which must keep every
//     bit pattern (signalling NaNs included).
// ops/probes.py holds the plain versions.
//
// Design: one block of 8 x 128 threads, one per word, the tile staged in
// shared memory as the VMEM tile's counterpart. A gather over 128 lanes is
// a shared-memory read on Hopper (__shfl_sync reaches only the 32 lanes of
// a warp). The f32 probe stages the words as floats (__int_as_float),
// gathers and selects floats, and stores __float_as_int: loads, stores and
// selects move the bits as they are, and no arithmetic touches a float, so
// no NaN is quieted. An index outside its axis is clamped into it, so the
// kernel never reads outside the tile (the probes' indices lie inside).
//
// What bounds it: neither bytes (12-16 KB) nor operations (a few per
// word), but the launch: it is one block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 8;
constexpr int kLanes = 128;

enum Probe : int {
  kTaaAxis1 = 0,
  kTaaAxis0 = 1,
  kDynShift = 2,
  kUnpack4 = 3,
  kTakeSelectI32 = 4,
  kTakeSelectF32 = 5,
};

template <int P>
__global__ void __launch_bounds__(kRows * kLanes) probe_kernel(
    const int32_t* __restrict__ w,      // [8, 128] words
    const int32_t* __restrict__ aux,    // [8, 128] indices or shifts
    const uint8_t* __restrict__ sel,    // [8, 128] bool
    void* __restrict__ out) {           // [8, 128] int32 or float32
  __shared__ int32_t tile[kRows][kLanes];
  __shared__ float ftile[kRows][kLanes];
  const int c = threadIdx.x;
  const int r = threadIdx.y;
  const int i = r * kLanes + c;
  const int32_t word = w[i];
  if (P == kTakeSelectF32) {
    ftile[r][c] = __int_as_float(word);
  } else {
    tile[r][c] = word;
  }
  __syncthreads();

  int32_t* out_i = static_cast<int32_t*>(out);
  float* out_f = static_cast<float*>(out);
  if (P == kTaaAxis1) {
    out_i[i] = tile[r][min(max(aux[i], 0), kLanes - 1)];
  } else if (P == kTaaAxis0) {
    const int q = ((aux[i] % kRows) + kRows) % kRows;   // floor mod
    out_i[i] = tile[q][c];
  } else if (P == kDynShift) {
    const unsigned s = static_cast<unsigned>(aux[i]);
    const unsigned u = static_cast<unsigned>(tile[r][c]);
    out_f[i] = s < 32u ? (float)((u >> s) & 0xFFu) : 0.0f;
  } else if (P == kUnpack4) {
    const unsigned u = static_cast<unsigned>(tile[r][c]);
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      acc = __fadd_rn(acc, (float)((u >> (8 * k)) & 0xFFu));
    out_f[i] = acc;
  } else if (P == kTakeSelectI32) {
    const int32_t g = tile[r][min(max(aux[i], 0), kLanes - 1)];
    out_i[i] = sel[i] ? g : tile[r][c];
  } else {
    const float g = ftile[r][min(max(aux[i], 0), kLanes - 1)];
    const float f = sel[i] ? g : ftile[r][c];
    out_i[i] = __float_as_int(f);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). `probe` numbers the kernels as
// the Probe enum above. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for another number.
extern "C" int acmmp_probe_launch(int probe, const void* w, const void* aux,
                                  const void* sel, void* out,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kLanes, kRows);
  const int32_t* wi = static_cast<const int32_t*>(w);
  const int32_t* ai = static_cast<const int32_t*>(aux);
  const uint8_t* si = static_cast<const uint8_t*>(sel);
  switch (probe) {
    case kTaaAxis1:
      probe_kernel<kTaaAxis1><<<1, block, 0, s>>>(wi, ai, si, out);
      break;
    case kTaaAxis0:
      probe_kernel<kTaaAxis0><<<1, block, 0, s>>>(wi, ai, si, out);
      break;
    case kDynShift:
      probe_kernel<kDynShift><<<1, block, 0, s>>>(wi, ai, si, out);
      break;
    case kUnpack4:
      probe_kernel<kUnpack4><<<1, block, 0, s>>>(wi, ai, si, out);
      break;
    case kTakeSelectI32:
      probe_kernel<kTakeSelectI32><<<1, block, 0, s>>>(wi, ai, si, out);
      break;
    case kTakeSelectF32:
      probe_kernel<kTakeSelectF32><<<1, block, 0, s>>>(wi, ai, si, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
