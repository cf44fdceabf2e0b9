// Device code of the GT corner warp, shared by kernel C11 (warp.cu),
// kernel C12 (gt_search.cu) and kernel C14 (ss_scan.cu):
// hevc_hop_tpu/ops/warp.py warp_blocks and _trunc_div_tz, bit-exact; and
// C11's work on a block's plane (gt_luma_block, gt_chroma_block), on a
// CU's cb and cr in one pass (gt_chroma_pair: C12's chroma check, which
// in C14 also writes the chroma predictions) and on a decode CU's three
// planes in one pass (gt_cu).
//
// The warp is affine: every map coordinate is an exact rational ax / d with
// d = 2 (2n - 1), so one output sample is a handful of int32 products, a
// truncating division, a bilinear sum over four window samples and a
// rounding half up. |num| stays below 9 d^2 (2^bd - 1), about 1.5e8 at
// n = 32 and 10 bit, far below 2^31. n is a template parameter at every
// call, so the divisions by d and 2 d^2 are by constants.
//
// Windows are staged as interp.cuh stages them (stage_windows: int16, a
// CU's loads in flight together before the one barrier). The chroma
// window is interpolated at the anchor's chroma phase (0 or 4 per axis; a
// phase-0 axis a copy) by interp.cuh's mc_filter into int16 [2m, 2m]
// shared memory, then warped.
#pragma once

#include "interp.cuh"

namespace {

// One block's warp: the map ax = axx * x + axy * y + ax0 (and ay)
struct WarpGeom {
  int axx, axy, ax0, ayx, ayy, ay0;
};

// c4: the corner offsets (TL, TR, BR, BL) as (x, y) pairs, full pel, or
// half pel with half (the chroma form). BR is not read: the warp is affine.
__device__ __forceinline__ WarpGeom warp_geom(int n, const int *c4,
                                              int half) {
  WarpGeom g;
  const int w = 2 * n - 1, s = half ? 1 : 2;
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

// Output sample i (raster order in the kN x kN block) of the warp of win
// ([2 kN, 2 kN], row stride ws, int32 or int16 samples). Sets knife when
// the reference's float64 may round this sample the other way: a
// coordinate exactly on a truncation boundary that matters (negative, or
// at the clamp), or the rounding exactly half way.
template <int kN, typename T>
__device__ __forceinline__ int warp_sample(const WarpGeom &g, const T *win,
                                           int ws, int i, int maxv,
                                           int &knife) {
  constexpr int d = 2 * (2 * kN - 1), off = kN / 2, nssg = kN / 2;
  constexpr int lim = kN / 2 + kN - 1, dd2 = 2 * d * d;
  const int xg = off + i % kN, yg = off + i / kN;
  const int ax = g.axx * xg + g.axy * yg + g.ax0;
  const int ay = g.ayx * xg + g.ayy * yg + g.ay0;
  const int xt = ax / d, yt = ay / d;   // toward zero, as C's (Int)
  const int pn = ax - xt * d, qn = ay - yt * d;
  const int xu = xt - off, yu = yt - off;
  const int xi = clip3(-nssg, lim - 1, xu);
  const int yi = clip3(-nssg, lim - 1, yu);
  const T *r0 = win + (yi + nssg) * ws + xi + nssg;
  const T *r1 = r0 + ws;
  int num = (d - qn) * ((d - pn) * r0[0] + pn * r0[1]) +
            qn * ((d - pn) * r1[0] + pn * r1[1]);
  num = clip3(0, maxv * d * d, num);
  const int t = 2 * num + d * d;
  if ((pn == 0 && (ax < 0 || xu <= -nssg || xu >= lim)) ||
      (qn == 0 && (ay < 0 || yu <= -nssg || yu >= lim)) || t % dd2 == 0)
    knife = 1;
  return t / dd2;
}

// The warp of an N x N block (half: the chroma form) from its staged
// window win [2N, 2N], by thread t of nthr; put(r, c, v) takes each
// sample. Returns the OR of the thread's knife flags.
template <int N, typename T, class Put>
__device__ __forceinline__ int gt_warp(const WarpGeom &g, const T *win,
                                       int maxv, int t, int nthr,
                                       const Put &put) {
  int knife = 0;
  for (int i = t; i < N * N; i += nthr)
    put(i / N, i % N, warp_sample<N>(g, win, 2 * N, i, maxv, knife));
  return knife;
}

// Named barrier kId (1..15) of `threads` threads (whole warps): the warps
// of one plane wait for each other, the CTA's others go on. The id is a
// constant, so that ptxas counts the barriers the kernel uses.
template <int kId>
__device__ __forceinline__ void bar_sync(int threads) {
  asm volatile("bar.sync %0, %1;" ::"n"(kId), "r"(threads) : "memory");
}
__device__ __forceinline__ void plane_sync(int p, int threads) {
  if (p)
    bar_sync<2>(threads);
  else
    bar_sync<1>(threads);
}

// An epilogue that writes only where out is given (C12's chroma check
// without C14's prediction slots)
struct PutIf {
  int32_t *out;
  int stride;
  __device__ __forceinline__ void operator()(int r, int c, int v) const {
    if (out != nullptr) out[r * stride + c] = v;
  }
};

// The chroma GT window job of the M x M block at (cx, cy) of s (its
// picture's rows) with the full-pel luma anchor (vx, vy): the (2M+3)^2
// samples around (cx, cy) - M/2 at the chroma MV 4 v (eighth pel)
template <int M>
__device__ __forceinline__ McJob gt_chroma_job(const Src &s, int cx, int cy,
                                               int vx, int vy) {
  return McJob{s, cx - M / 2, cy - M / 2, 4 * vx, 4 * vy};
}

// Shared-memory words (int16 windows)
template <int N>
__host__ __device__ constexpr int gt_luma_words() {
  return words16(4 * N * N);
}
template <int M>
__host__ __device__ constexpr int gt_chroma_words() {
  return mc_block_words<2 * M, true>() + words16(4 * M * M);
}
template <int M>
__host__ __device__ constexpr int gt_pair_words() {
  return 2 * gt_chroma_words<M>();
}
template <int N>
__host__ __device__ constexpr int gt_cu_words() {
  return gt_luma_words<N>() + gt_pair_words<N / 2>();
}

// Kernel C11's luma form on one N x N block at (px, py) of s (rows of its
// picture) with the full-pel anchor (vx, vy) and the corners c4, by the
// CTA's 8 warps: the clamped [2N, 2N] window staged (one barrier), warped,
// put. No barrier at the end.
template <int N, class Put>
__device__ __forceinline__ void gt_luma_block(const Src &s, int px, int py,
                                              int vx, int vy, const int *c4,
                                              int bit_depth, int32_t *sm,
                                              const Put &put) {
  int16_t *win = reinterpret_cast<int16_t *>(sm);
  stage_windows<2 * N>(StageWin{s, px + vx - N / 2, py + vy - N / 2, win});
  __syncthreads();
  gt_warp<N>(warp_geom(N, c4, 0), win, (1 << bit_depth) - 1, threadIdx.x,
             blockDim.x, put);
}

// Kernel C11's chroma form on one M x M block (job: gt_chroma_job), by the
// CTA's 8 warps: the window staged, a barrier, interpolated into int16
// [2M, 2M], a barrier, warped in half-pel units, put. No barrier at the
// end.
template <int M, class Put>
__device__ __forceinline__ void gt_chroma_block(const McJob &j,
                                                const int *c4, int bit_depth,
                                                int32_t *sm, const Put &put) {
  int16_t *raw = reinterpret_cast<int16_t *>(sm);
  int16_t *fw = raw + 2 * mc_block_words<2 * M, true>();
  int x0, y0, fx, fy;
  mc_origin<2 * M, true>(j, x0, y0, fx, fy);
  stage_windows<McGeom<2 * M, true>::kW>(StageWin{j.s, x0, y0, raw});
  __syncthreads();
  const McShifts k = mc_shifts(bit_depth);
  mc_filter<2 * M, true>(raw, fx, fy, k, threadIdx.x, blockDim.x,
                         PutShared16{fw, 2 * M});
  __syncthreads();
  gt_warp<M>(warp_geom(M, c4, 1), fw, k.maxv, threadIdx.x, blockDim.x, put);
}

// Kernel C11's chroma form on a CU's cb and cr in one pass (jobs:
// gt_chroma_job), by the CTA's 8 warps: both windows staged behind one
// barrier; cb interpolated and warped on warps 0-3, cr on warps 4-7, each
// plane's warps joined by a named barrier between the two steps. Returns,
// on every thread, whether any sample of either plane sits on a knife edge
// (a CTA-wide OR, which is the body's last barrier).
template <int M, class Put>
__device__ __forceinline__ int gt_chroma_pair(const McJob &cb,
                                              const McJob &cr, const int *c4,
                                              int bit_depth, int32_t *sm,
                                              const Put &pcb,
                                              const Put &pcr) {
  constexpr int kRaw = 2 * mc_block_words<2 * M, true>();   // int16
  const int p = threadIdx.x >> 7, t = threadIdx.x & 127;
  int16_t *base = reinterpret_cast<int16_t *>(sm);
  int16_t *raw = base + p * 2 * gt_chroma_words<M>();
  int16_t *fw = raw + kRaw;
  int x0, y0, fx, fy, x1, y1, fx1, fy1;
  mc_origin<2 * M, true>(cb, x0, y0, fx, fy);
  mc_origin<2 * M, true>(cr, x1, y1, fx1, fy1);
  constexpr int kW = McGeom<2 * M, true>::kW;
  stage_windows<kW, kW>(
      StageWin{cb.s, x0, y0, base},
      StageWin{cr.s, x1, y1, base + 2 * gt_chroma_words<M>()});
  __syncthreads();
  const McShifts k = mc_shifts(bit_depth);
  mc_filter<2 * M, true>(raw, p ? fx1 : fx, p ? fy1 : fy, k, t, 128,
                         PutShared16{fw, 2 * M});
  plane_sync(p, 128);
  const int knife = gt_warp<M>(warp_geom(M, c4, 1), fw, k.maxv, t, 128,
                               p ? pcr : pcb);
  return __syncthreads_or(knife);
}

// Kernel C14's GT prediction of a decode CU in one pass, by the CTA's 8
// warps: the N x N luma at (px, py) of ys with the full-pel anchor (vx,
// vy), and the chroma jobs cb and cr (gt_chroma_job, N/2 x N/2), with the
// coded corners gtc; the three windows' loads issued before their stores
// and the one barrier; luma warped on warps 0-3, cb interpolated and
// warped on warps 4-5, cr on warps 6-7 (a named barrier for each chroma
// plane's two steps). No barrier at the end.
template <int N, class PutY, class PutC>
__device__ __forceinline__ void gt_cu(const Src &ys, int px, int py, int vx,
                                      int vy, const McJob &cb,
                                      const McJob &cr, const int32_t *gtc,
                                      int bit_depth, int32_t *sm,
                                      const PutY &pluma, const PutC &pcb,
                                      const PutC &pcr) {
  constexpr int M = N / 2, kRaw = 2 * mc_block_words<2 * M, true>();
  const int warp = threadIdx.x >> 5;
  int16_t *wy = reinterpret_cast<int16_t *>(sm);
  int16_t *rb = wy + 2 * gt_luma_words<N>();
  int16_t *rr = rb + 2 * gt_chroma_words<M>();
  int x0, y0, fx, fy, x1, y1, fx1, fy1;
  mc_origin<2 * M, true>(cb, x0, y0, fx, fy);
  mc_origin<2 * M, true>(cr, x1, y1, fx1, fy1);
  constexpr int kW = McGeom<2 * M, true>::kW;
  stage_windows<2 * N, kW, kW>(
      StageWin{ys, px + vx - N / 2, py + vy - N / 2, wy},
      StageWin{cb.s, x0, y0, rb}, StageWin{cr.s, x1, y1, rr});
  int c4[8];
  gt4(gtc, c4);
  __syncthreads();
  const McShifts k = mc_shifts(bit_depth);
  if (warp < 4) {
    gt_warp<N>(warp_geom(N, c4, 0), wy, k.maxv, threadIdx.x, 128, pluma);
    return;
  }
  const int p = warp >= 6, t = threadIdx.x & 63;
  int16_t *raw = p ? rr : rb, *fw = raw + kRaw;
  mc_filter<2 * M, true>(raw, p ? fx1 : fx, p ? fy1 : fy, k, t, 64,
                         PutShared16{fw, 2 * M});
  plane_sync(p, 64);
  gt_warp<M>(warp_geom(M, c4, 1), fw, k.maxv, t, 64, p ? pcr : pcb);
}

}  // namespace
