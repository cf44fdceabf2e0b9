// Device code of motion compensation shared by kernel C8 (interp.cu),
// kernel C10 (inter_arms.cu), kernels C11 and C12 (warp.cuh) and kernel
// C14 (ss_scan.cu): the 8-tap quarter-pel luma and 4-tap eighth-pel chroma
// filters of H.265 8.5.3.3.3 as two separable int32 stages with 14-bit
// intermediates, run unconditionally (phase 0 is the identity through both
// stages), bit-exact with hevc_hop_tpu/ops/interp.py filter_2d; and C8's
// work on one block with its epilogues (mc_write_block).
#pragma once

#include "common.cuh"

namespace {

__constant__ int kLumaTaps[4][8] = {
    {0, 0, 0, 64, 0, 0, 0, 0},
    {-1, 4, -10, 58, 17, -5, 1, 0},
    {-1, 4, -11, 40, 40, -11, 4, -1},
    {0, 1, -5, 17, 58, -10, 4, -1}};

__constant__ int kChromaTaps[8][4] = {
    {0, 64, 0, 0},    {-2, 58, 10, -2}, {-4, 54, 16, -2}, {-6, 46, 28, -4},
    {-4, 36, 36, -4}, {-4, 28, 46, -6}, {-2, 16, 54, -4}, {-2, 10, 58, -2}};

// Where a block's samples are read from: rows clamped to [row_lo, row_hi]
// (the block's own picture), columns to [0, w - 1].
struct Src {
  const int32_t *p;
  int stride, row_lo, row_hi, w;
};

// Shared-memory words mc_block needs for an n x n block (window + mid).
__host__ __device__ __forceinline__ int mc_smem_words(int n, int chroma) {
  const int t = chroma ? 4 : 8, win = n + t - 1;
  return win * win + win * n;
}

// The n x n prediction of the block at (px, py) with the quarter-pel luma
// MV (mvx, mvy), by the CTA's threads, into out (row stride n). scratch
// holds mc_smem_words(n, chroma) words of shared memory. The window is read
// with L2-coherent loads: a persistent caller (kernel C14) reads recon that
// CTAs on other SMs wrote earlier in the same launch. Ends with a barrier,
// so out may be read at once.
__device__ void mc_block(const Src &s, int px, int py, int mvx, int mvy,
                         int n, int chroma, int bit_depth, int32_t *scratch,
                         int32_t *out) {
  const int t = chroma ? 4 : 8;
  const int sh = chroma ? 3 : 2, mask = chroma ? 7 : 3;
  const int fx = mvx & mask, fy = mvy & mask;
  const int x0 = px + (mvx >> sh) - (t / 2 - 1);
  const int y0 = py + (mvy >> sh) - (t / 2 - 1);
  const int W = n + t - 1;
  int32_t *win = scratch;        // [W][W]
  int32_t *mid = scratch + W * W;  // [W][n]
  const int headroom = 14 - bit_depth;
  const int shift1 = 6 - headroom;
  const int off1 = -(8192 << shift1);
  const int shift2 = 6 + headroom;
  const int off2 = (8192 << 6) + (1 << (shift2 - 1));
  const int maxv = (1 << bit_depth) - 1;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < W * W; i += nt) {
    const int y = clip3(s.row_lo, s.row_hi, y0 + i / W);
    const int x = clip3(0, s.w - 1, x0 + i % W);
    win[i] = __ldcg(s.p + (long long)y * s.stride + x);
  }
  __syncthreads();
  for (int i = tid; i < W * n; i += nt) {
    const int r = i / n, c = i % n;
    int acc = 0;
    for (int k = 0; k < t; ++k)
      acc += win[r * W + c + k] *
             (chroma ? kChromaTaps[fx][k] : kLumaTaps[fx][k]);
    mid[i] = (acc + off1) >> shift1;
  }
  __syncthreads();
  for (int i = tid; i < n * n; i += nt) {
    const int r = i / n, c = i % n;
    int acc = 0;
    for (int k = 0; k < t; ++k)
      acc += mid[(r + k) * n + c] *
             (chroma ? kChromaTaps[fy][k] : kLumaTaps[fy][k]);
    out[i] = clip3(0, maxv, (acc + off2) >> shift2);
  }
  __syncthreads();
}

// Kernel C8's work on one block at (px, py) of src with the quarter-pel
// luma MV (mvx, mvy): rows clamped to the block's own picture (on the
// stacked chroma plane, a block at or below hc_off reads [hc_off, hc_off +
// h_real), others [0, h_real)), the prediction written to out [n*n], or,
// with resi, clip(prediction + residual) written into dst (src's row
// stride). sm holds mc_smem_words(n, chroma) + n * n words. Ends with a
// barrier.
__device__ void mc_write_block(const Src &src, int hc_off, int h_real,
                               int px, int py, int mvx, int mvy, int n,
                               int chroma, int bit_depth, int32_t *out,
                               const int32_t *resi, int resi_stride,
                               int32_t *dst, int32_t *sm) {
  Src s = src;
  s.row_lo = (chroma && py >= hc_off) ? hc_off : 0;
  s.row_hi = s.row_lo + h_real - 1;
  int32_t *pred = sm + mc_smem_words(n, chroma);
  mc_block(s, px, py, mvx, mvy, n, chroma, bit_depth, sm, pred);
  const int nn = n * n, maxv = (1 << bit_depth) - 1;
  for (int i = threadIdx.x; i < nn; i += blockDim.x) {
    if (resi != nullptr) {
      const long long y = py + i / n, x = px + i % n;
      dst[y * src.stride + x] =
          clip3(0, maxv, pred[i] + resi[y * resi_stride + x]);
    } else {
      out[i] = pred[i];
    }
  }
  __syncthreads();
}

}  // namespace
