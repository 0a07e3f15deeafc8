// The bilinear resize of the port's multi-scale loader and fusion
// (io/dense_folder.py::resize_image): OpenCV's half-pixel convention, the
// source coordinate in f64, f32 weights and a 4-term f32 sum; u8 rounds as
// v + 0.5 truncated. The two functions are the JAX package's native
// formula word for word, and kernels/_build.py::load_host builds this file
// with that library's compiler and flags (g++ -O3 -fopenmp -shared -fPIC),
// so wherever g++ contracts the sum into FMAs it does so in both and the
// two packages rescale an image to the same bits. Exposed as a plain C ABI
// for ctypes.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

void an_resize_bilinear_f32(const float* src, int32_t sh, int32_t sw,
                            float* dst, int32_t dh, int32_t dw,
                            int32_t channels) {
  const double sy = (double)sh / dh;
  const double sx = (double)sw / dw;
#pragma omp parallel for schedule(static)
  for (int32_t r = 0; r < dh; ++r) {
    double fy = (r + 0.5) * sy - 0.5;
    if (fy < 0) fy = 0;
    if (fy > sh - 1) fy = sh - 1;
    int32_t y0 = (int32_t)fy;
    int32_t y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    float wy = (float)(fy - y0);
    for (int32_t c = 0; c < dw; ++c) {
      double fx = (c + 0.5) * sx - 0.5;
      if (fx < 0) fx = 0;
      if (fx > sw - 1) fx = sw - 1;
      int32_t x0 = (int32_t)fx;
      int32_t x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      float wx = (float)(fx - x0);
      for (int32_t ch = 0; ch < channels; ++ch) {
        const float v00 = src[((size_t)y0 * sw + x0) * channels + ch];
        const float v01 = src[((size_t)y0 * sw + x1) * channels + ch];
        const float v10 = src[((size_t)y1 * sw + x0) * channels + ch];
        const float v11 = src[((size_t)y1 * sw + x1) * channels + ch];
        dst[((size_t)r * dw + c) * channels + ch] =
            v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy) +
            v10 * (1 - wx) * wy + v11 * wx * wy;
      }
    }
  }
}

void an_resize_bilinear_u8(const uint8_t* src, int32_t sh, int32_t sw,
                           uint8_t* dst, int32_t dh, int32_t dw,
                           int32_t channels) {
  const double sy = (double)sh / dh;
  const double sx = (double)sw / dw;
#pragma omp parallel for schedule(static)
  for (int32_t r = 0; r < dh; ++r) {
    double fy = (r + 0.5) * sy - 0.5;
    if (fy < 0) fy = 0;
    if (fy > sh - 1) fy = sh - 1;
    int32_t y0 = (int32_t)fy;
    int32_t y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
    float wy = (float)(fy - y0);
    for (int32_t c = 0; c < dw; ++c) {
      double fx = (c + 0.5) * sx - 0.5;
      if (fx < 0) fx = 0;
      if (fx > sw - 1) fx = sw - 1;
      int32_t x0 = (int32_t)fx;
      int32_t x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
      float wx = (float)(fx - x0);
      for (int32_t ch = 0; ch < channels; ++ch) {
        const float v00 = src[((size_t)y0 * sw + x0) * channels + ch];
        const float v01 = src[((size_t)y0 * sw + x1) * channels + ch];
        const float v10 = src[((size_t)y1 * sw + x0) * channels + ch];
        const float v11 = src[((size_t)y1 * sw + x1) * channels + ch];
        float v = v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy) +
                  v10 * (1 - wx) * wy + v11 * wx * wy;
        dst[((size_t)r * dw + c) * channels + ch] = (uint8_t)(v + 0.5f);
      }
    }
  }
}

}  // extern "C"
