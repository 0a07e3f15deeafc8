// Nearest read of multi-channel maps at integer coordinates, written for
// Hopper (sm_90a): fusion's source-map sampler.
//
// Replaces acmmp_tpu/ops/pallas_sample.py:32 gather2d_pallas and computes
// its function (the plain version is ops/sample.py::gather2d). For every
// view v, channel c and output pixel p:
//   out[v, c, p] = valid[v, p] ? maps[v, c, rr[v, p], cc[v, p]] : 0.
// Valid lanes carry in-range indices (the caller clips them); an invalid
// lane's indices are garbage (a NaN or infinite projection) and are never
// read, so no address is formed from them. Values move as whole f32 words
// with no arithmetic, so the kernel is bitwise equal to the plain version.
//
// What bounds it here: bytes. Per (v, p) it reads rr, cc (4 bytes each)
// and valid (1 byte), and per channel one 4-byte map word and one 4-byte
// store; there is no arithmetic beyond the address. Counting every input
// read once and the output written once, 1600x1184 with 8 views and 4
// channels moves 621 MB: 0.185 ms at 3.35 TB/s.
//
// Design: the Pallas kernel's row-scan over (8, 128) chunks of a resident
// map plane, with lane selects and compare-accumulate, exists because the
// TPU has no fast 2D gather. Here the read is a direct indexed load: one
// thread per (view, output pixel), blockIdx.y over views; rr, cc and
// valid are read coalesced; each channel's word is one __ldg through the
// read-only path; each channel's stores are coalesced. Neighbouring
// reference pixels project to neighbouring source pixels, so a warp's map
// reads fall on a few cache lines and L2 serves the reuse. The channel
// loop is unrolled for fusion's two widths (C = 4 plain, C = 8 for the
// prior-aware fusion's two candidates) so a thread's C loads are in
// flight together.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

// C > 0: the channel count, loops unrolled; C == 0: n_chan at run time.
template <int C>
__global__ void __launch_bounds__(kBlock)
    gather2d_kernel(const float* __restrict__ maps,
                    const int32_t* __restrict__ rr,
                    const int32_t* __restrict__ cc,
                    const uint8_t* __restrict__ valid,
                    float* __restrict__ out, int n_chan, int Hs, int Ws,
                    int npix) {
  const int p = blockIdx.x * kBlock + threadIdx.x;
  if (p >= npix) return;
  const int v = blockIdx.y;
  const int nc = C > 0 ? C : n_chan;
  const size_t lane = (size_t)v * npix + p;
  const size_t plane = (size_t)Hs * Ws;
  float* o = out + (size_t)v * nc * npix + p;
  if (!__ldg(valid + lane)) {
    // an invalid lane reads neither its indices nor the maps
#pragma unroll
    for (int c = 0; c < nc; ++c) o[(size_t)c * npix] = 0.0f;
    return;
  }
  const float* m = maps + (size_t)v * nc * plane +
                   (size_t)__ldg(rr + lane) * Ws + __ldg(cc + lane);
#pragma unroll
  for (int c = 0; c < nc; ++c) o[(size_t)c * npix] = __ldg(m + c * plane);
}

template <int C>
cudaError_t launch(const void* maps, const void* rr, const void* cc,
                   const void* valid, void* out, int V, int n_chan, int Hs,
                   int Ws, int npix, cudaStream_t stream) {
  const dim3 grid((npix + kBlock - 1) / kBlock, V);
  gather2d_kernel<C><<<grid, kBlock, 0, stream>>>(
      static_cast<const float*>(maps), static_cast<const int32_t*>(rr),
      static_cast<const int32_t*>(cc), static_cast<const uint8_t*>(valid),
      static_cast<float*>(out), n_chan, Hs, Ws, npix);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns cudaGetLastError()
// after the launch. C = 4 and C = 8 run unrolled; any other channel count
// takes the runtime loop.
extern "C" int acmmp_gather2d_launch(const void* maps, const void* rr,
                                     const void* cc, const void* valid,
                                     void* out, int V, int C, int Hs, int Ws,
                                     int H, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int npix = H * W;
  switch (C) {
    case 4:
      return launch<4>(maps, rr, cc, valid, out, V, C, Hs, Ws, npix, s);
    case 8:
      return launch<8>(maps, rr, cc, valid, out, V, C, Hs, Ws, npix, s);
    default:
      return launch<0>(maps, rr, cc, valid, out, V, C, Hs, Ws, npix, s);
  }
}
