// Device functions of the transform and the quantizer shared by kernel C3
// (tq.cu) and kernel C5 (partition.cu): HM's rounding shift, the 16-bit
// clamp, int32 products that wrap as the reference's do, the dead-zone
// quantizer and the flat dequantizer of one coefficient, and the two
// matrix-product stages of the 2-D transforms.
#pragma once

#include "common.cuh"

namespace {

__device__ __forceinline__ int rshift_round(int x, int shift) {
  return (x + (1 << (shift - 1))) >> shift;
}

__device__ __forceinline__ int clip16(int v) { return clip3(-32768, 32767, v); }

// int32 products that wrap like the reference's
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int dequant1(int level, int dqs, int dqsh) {
  return clip16(wadd(wmul(level, dqs), 1 << (dqsh - 1)) >> dqsh);
}

// HM's dead-zone quantizer of one coefficient (the reference's quant)
__device__ __forceinline__ int quant1(int c, int qs, int qoff, int qbits) {
  const int lev = wadd(wmul(iabs(c), qs), qoff) >> qbits;
  return clip16(wmul(isign(c), lev));
}

// out[k][x] = round(sum_j M[k][j] * X[j][x]) (transpose_m: M[j][k])
__device__ void stage_rows(const int32_t *M, const int32_t *X, int32_t *Y,
                           int n, int transpose_m, int shift, int clamp) {
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
    const int kk = i / n, x = i % n;
    int s = 0;
    for (int j = 0; j < n; ++j)
      s += (transpose_m ? M[j * n + kk] : M[kk * n + j]) * X[j * n + x];
    s = rshift_round(s, shift);
    Y[i] = clamp ? clip16(s) : s;
  }
}

// out[y][k] = round(sum_j X[y][j] * M[k][j]) (transpose_m: M[j][k])
__device__ void stage_cols(const int32_t *M, const int32_t *X, int32_t *Y,
                           int n, int transpose_m, int shift, int clamp) {
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
    const int y = i / n, kk = i % n;
    int s = 0;
    for (int j = 0; j < n; ++j)
      s += X[y * n + j] * (transpose_m ? M[j * n + kk] : M[kk * n + j]);
    s = rshift_round(s, shift);
    Y[i] = clamp ? clip16(s) : s;
  }
}

}  // namespace
