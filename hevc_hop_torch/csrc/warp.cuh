// Device code of the GT corner warp, shared by kernel C11 (warp.cu),
// kernel C12 (gt_search.cu) and kernel C14 (ss_scan.cu):
// hevc_hop_tpu/ops/warp.py warp_blocks and _trunc_div_tz, bit-exact; and
// C11's plane-entry work on one block (gt_pred_block).
//
// The warp is affine: every map coordinate is an exact rational ax / d with
// d = 2 (2n - 1), so one output sample is a handful of int32 products, a
// truncating division, a bilinear sum over four window samples and a
// rounding half up. |num| stays below 9 d^2 (2^bd - 1), about 1.5e8 at
// n = 32 and 10 bit, far below 2^31.
#pragma once

#include "interp.cuh"

namespace {

// One block's warp: the map ax = axx * x + axy * y + ax0 (and ay), the
// central block's offset in the [2n, 2n] window, the NSS clamp.
struct WarpGeom {
  int n, off, nssg, lim, d;
  int axx, axy, ax0, ayx, ayy, ay0;
};

// c4: the corner offsets (TL, TR, BR, BL) as (x, y) pairs, full pel, or
// half pel with half (the chroma form). BR is not read: the warp is affine.
__device__ __forceinline__ WarpGeom warp_geom(int n, const int *c4,
                                              int half) {
  WarpGeom g;
  const int gs = 2 * n, w = gs - 1, s = half ? 1 : 2;
  g.n = n;
  g.d = 2 * w;
  g.off = gs / 2 - n / 2;
  g.nssg = n / 2;
  g.lim = n / 2 + n - 1;
  const int cx0 = c4[0] * s, cx1 = c4[2] * s + 2 * w, cx3 = c4[6] * s;
  const int cy0 = c4[1] * s, cy1 = c4[3] * s, cy3 = c4[7] * s + 2 * w;
  g.axx = cx1 - cx0;
  g.axy = cx3 - cx0;
  g.ax0 = cx0 * w;
  g.ayx = cy1 - cy0;
  g.ayy = cy3 - cy0;
  g.ay0 = cy0 * w;
  return g;
}

// The coded corners (TL, TR, BR, 6 ints) plus the affine BL = TL + BR - TR
__device__ __forceinline__ void gt4(const int *gtc, int *c4) {
  for (int k = 0; k < 6; ++k) c4[k] = gtc[k];
  c4[6] = gtc[0] + gtc[4] - gtc[2];
  c4[7] = gtc[1] + gtc[5] - gtc[3];
}

// Output sample i (raster order in the n x n block) of the warp of win
// ([2n, 2n], row stride ws). Sets knife when the reference's float64 may
// round this sample the other way: a coordinate exactly on a truncation
// boundary that matters (negative, or at the clamp), or the rounding
// exactly half way. kN > 0 is n as a compile-time constant (g's n):
// the divisions by d = 2 (2n - 1) and 2 d^2 are then by constants.
template <int kN = 0>
__device__ __forceinline__ int warp_sample(const WarpGeom &g,
                                           const int32_t *win, int ws, int i,
                                           int maxv, int &knife) {
  const int n = kN ? kN : g.n, d = kN ? 2 * (2 * kN - 1) : g.d;
  const int off = kN ? kN / 2 : g.off, nssg = kN ? kN / 2 : g.nssg;
  const int lim = kN ? kN / 2 + kN - 1 : g.lim;
  const int xg = off + i % n, yg = off + i / n;
  const int ax = g.axx * xg + g.axy * yg + g.ax0;
  const int ay = g.ayx * xg + g.ayy * yg + g.ay0;
  const int xt = ax / d, yt = ay / d;   // toward zero, as C's (Int)
  const int pn = ax - xt * d, qn = ay - yt * d;
  const int xu = xt - off, yu = yt - off;
  const int xi = clip3(-nssg, lim - 1, xu);
  const int yi = clip3(-nssg, lim - 1, yu);
  const int32_t *r0 = win + (yi + nssg) * ws + xi + nssg;
  const int32_t *r1 = r0 + ws;
  int num = (d - qn) * ((d - pn) * r0[0] + pn * r0[1]) +
            qn * ((d - pn) * r1[0] + pn * r1[1]);
  num = clip3(0, maxv * d * d, num);
  const int t = 2 * num + d * d, dd2 = 2 * d * d;
  if ((pn == 0 && (ax < 0 || xu <= -nssg || xu >= lim)) ||
      (qn == 0 && (ay < 0 || yu <= -nssg || yu >= lim)) || t % dd2 == 0)
    knife = 1;
  return t / dd2;
}

// Shared-memory words of gt_pred_block for an n x n block
__host__ __device__ inline int gt_pred_words(int n, int chroma) {
  const int ws = 2 * n;
  return ws * ws + (chroma ? mc_smem_words(ws, 1) : 0);
}

// Kernel C11's plane-entry work on one block at (px, py) of src with the
// full-pel anchor (vx, vy) and the coded corners gtc [6]: the window
// staged (luma: the clamped [2n, 2n] samples around the anchor, rows
// [0, h_real); chroma: the (2n+3)^2 samples of the block's own picture of
// the stacked plane interpolated at the anchor's chroma phase), warped, and
// the prediction written to out [n*n], or, with resi, clip(prediction +
// residual) written into plane (src's row stride). Window loads are
// L2-coherent. sm holds gt_pred_words(n, chroma) words. Ends with a
// barrier.
__device__ void gt_pred_block(const Src &src, int hc_off, int h_real,
                              int px, int py, int vx, int vy,
                              const int32_t *gtc, int n, int chroma,
                              int bit_depth, int32_t *out,
                              const int32_t *resi, int resi_stride,
                              int32_t *plane, int32_t *sm) {
  const int ws = 2 * n, nn = n * n;
  int32_t *win = sm;
  Src s = src;
  if (chroma) {
    s.row_lo = py >= hc_off ? hc_off : 0;
    s.row_hi = s.row_lo + h_real - 1;
    // the (2n+3)^2 window at the chroma phase of the full-pel luma MV:
    // 4 * v in eighth-pel chroma units
    mc_block(s, px - n / 2, py - n / 2, 4 * vx, 4 * vy, ws, 1, bit_depth,
             sm + ws * ws, win);
  } else {
    const int x0 = px + vx - n / 2, y0 = py + vy - n / 2;
    for (int i = threadIdx.x; i < ws * ws; i += blockDim.x) {
      const int y = clip3(0, h_real - 1, y0 + i / ws);
      const int x = clip3(0, s.w - 1, x0 + i % ws);
      win[i] = __ldcg(s.p + (long long)y * s.stride + x);
    }
    __syncthreads();
  }
  int c4[8];
  gt4(gtc, c4);
  const WarpGeom g = warp_geom(n, c4, chroma);
  const int maxv = (1 << bit_depth) - 1;
  int knife = 0;
  for (int i = threadIdx.x; i < nn; i += blockDim.x) {
    const int v = warp_sample(g, win, ws, i, maxv, knife);
    if (resi != nullptr) {
      const long long y = py + i / n, x = px + i % n;
      plane[y * src.stride + x] =
          clip3(0, maxv, v + resi[y * resi_stride + x]);
    } else {
      out[i] = v;
    }
  }
  __syncthreads();
}

}  // namespace
