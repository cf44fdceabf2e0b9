// Device code of motion compensation shared by kernel C8 (interp.cu),
// kernel C10 (inter_arms.cu), kernels C11 and C12 (warp.cuh) and kernel
// C14 (ss_scan.cu): the 8-tap quarter-pel luma and 4-tap eighth-pel chroma
// filters of H.265 8.5.3.3.3 as two separable int32 stages with 14-bit
// intermediates, bit-exact with hevc_hop_tpu/ops/interp.py filter_2d (a
// phase-0 axis is the identity through its stage, so it is taken as a
// copy); the window staging (stage_windows); and C8's work on one block
// (mc_block_n) and on a CU's planes in one pass (mc_cu, mc_pair).
//
// The block size n and the plane are template parameters, so the index
// arithmetic divides by constants and the taps sit in registers. A window
// is staged as int16 (samples of up to 10 bits), consecutive threads on
// consecutive columns, every window's loads of a CU issued before the
// stores and the one barrier. Both filter stages then run in one pass: a
// thread owns a column of a run of rows and slides the first stage's t
// rows down it in registers (as inter_arms.cuh mc_warp), and the epilogue
// writes each sample from its register. The bodies end without a barrier:
// a caller that reads the output from shared memory, or reuses the
// window's shared memory, syncs first.
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

// s with the rows of the picture a block at row y reads: luma [0, h_real);
// on the stacked chroma plane a block at or below hc_off [hc_off, hc_off +
// h_real), others [0, h_real)
__device__ __forceinline__ Src picture_rows(const Src &s, int chroma,
                                            int hc_off, int h_real, int y) {
  Src o = s;
  o.row_lo = (chroma && y >= hc_off) ? hc_off : 0;
  o.row_hi = o.row_lo + h_real - 1;
  return o;
}

// The window side of an n x n block's filter (n + t - 1)
template <int N, bool kChroma>
struct McGeom {
  static constexpr int kTaps = kChroma ? 4 : 8;
  static constexpr int kW = N + kTaps - 1;
  static constexpr int kShift = kChroma ? 3 : 2, kMask = kChroma ? 7 : 3;
};

// int16 words rounded up to whole int32 words
__host__ __device__ constexpr int words16(int n) { return (n + 1) / 2; }

// One window to stage: the w x w samples at (x0, y0) of s (rows clamped
// to [s.row_lo, s.row_hi], columns to [0, s.w - 1]) into dst (int16, row
// stride w)
struct StageWin {
  Src s;
  int x0, y0;
  int16_t *dst;
};

// Sample i of window w (width kW, raster order), L2-coherent: kernel C14
// reads recon that CTAs on other SMs wrote earlier in its launch
template <int kW>
__device__ __forceinline__ int stage_load(const StageWin &w, int i) {
  const int y = clip3(w.s.row_lo, w.s.row_hi, w.y0 + i / kW);
  const int x = clip3(0, w.s.w - 1, w.x0 + i % kW);
  return __ldcg(w.s.p + (long long)y * w.s.stride + x);
}

// Up to three windows of widths kW0, kW1, kW2 (0: none) staged by the
// CTA's threads as int16: their samples in one raster list (window after
// window), thread t taking t, t + blockDim.x, ...; kBatch of a thread's
// loads issued into registers before their stores, so that the windows'
// loads are in flight together (a CU's in one batch up to 8 x 256
// samples: 16x16 and smaller CUs, and the chroma pair of a 16x16 GT CU;
// a batch of 16 spilled more in C14's kernels at their 128 registers).
// The caller's barrier follows.
template <int kW0, int kW1 = 0, int kW2 = 0>
__device__ __forceinline__ void stage_windows(const StageWin &w0,
                                              const StageWin &w1 = {},
                                              const StageWin &w2 = {}) {
  constexpr int n0 = kW0 * kW0, n1 = kW1 * kW1, n2 = kW2 * kW2;
  constexpr int total = n0 + n1 + n2, kBatch = 8;
  const int nt = blockDim.x;
  for (int base = threadIdx.x; base < total; base += kBatch * nt) {
    int v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + j * nt;
      if (i < n0)
        v[j] = stage_load<kW0>(w0, i);
      else if (i < n0 + n1)
        v[j] = stage_load<kW1 ? kW1 : 1>(w1, i - n0);
      else if (i < total)
        v[j] = stage_load<kW2 ? kW2 : 1>(w2, i - n0 - n1);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + j * nt;
      if (i < n0)
        w0.dst[i] = (int16_t)v[j];
      else if (i < n0 + n1)
        w1.dst[i - n0] = (int16_t)v[j];
      else if (i < total)
        w2.dst[i - n0 - n1] = (int16_t)v[j];
    }
  }
}

// The reference's shifts, offsets and clip for bit_depth
struct McShifts {
  int off1, shift1, off2, shift2, maxv;
};

__device__ __forceinline__ McShifts mc_shifts(int bit_depth) {
  const int headroom = 14 - bit_depth;
  McShifts k;
  k.shift1 = 6 - headroom;
  k.off1 = -(8192 << k.shift1);
  k.shift2 = 6 + headroom;
  k.off2 = (8192 << 6) + (1 << (k.shift2 - 1));
  k.maxv = (1 << bit_depth) - 1;
  return k;
}

// Epilogues: where sample (r, c) of a block goes.
// The prediction, int32 (global or shared memory), row stride `stride`
struct PutPred {
  int32_t *out;
  int stride;
  __device__ __forceinline__ void operator()(int r, int c, int v) const {
    out[r * stride + c] = v;
  }
};
// The prediction, int16 in shared memory (an interpolated GT window)
struct PutShared16 {
  int16_t *out;
  int stride;
  __device__ __forceinline__ void operator()(int r, int c, int v) const {
    out[r * stride + c] = (int16_t)v;
  }
};
// clip(prediction + residual) into dst at the block (px, py), dst and resi
// each with its own row stride
struct PutRecon {
  const int32_t *resi;
  int resi_stride;
  int32_t *dst;
  int dst_stride, px, py, maxv;
  __device__ __forceinline__ void operator()(int r, int c, int v) const {
    const long long y = py + r, x = px + c;
    dst[y * dst_stride + x] = clip3(0, maxv, v + resi[y * resi_stride + x]);
  }
};

// Both filter stages of the N x N block over its staged window win (int16,
// row stride kW) at phase (fx, fy), by thread t of nthr (t < nthr, nthr >=
// N): thread t takes column t % N of the run t / N of rows (the N rows cut
// into min(N, nthr / N) runs) and slides the first stage's kTaps rows down
// it in registers; put(r, c, v) takes each sample. A phase-0 axis is a
// copy: its stage is the identity scaled by 64, computed so; both at phase
// 0, the window's sample itself. ops/interp.py mc_filter_walk is its walk.
template <int N, bool kChroma, class Put>
__device__ __forceinline__ void mc_filter(const int16_t *win, int fx, int fy,
                                          const McShifts &k, int t, int nthr,
                                          const Put &put) {
  using G = McGeom<N, kChroma>;
  constexpr int T = G::kTaps, W = G::kW, C = T / 2 - 1;
  const int runs = nthr / N < N ? nthr / N : N;
  if (t >= runs * N) return;
  const int rows = (N + runs - 1) / runs;
  const int c = t % N, r0 = (t / N) * rows;
  if (r0 >= N) return;
  const int r1 = r0 + rows < N ? r0 + rows : N;
  const int16_t *p = win + c;
  if (fx == 0 && fy == 0) {
    for (int r = r0; r < r1; ++r)
      put(r, c, clip3(0, k.maxv, p[(r + C) * W + C]));
    return;
  }
  int hx[T], hy[T];
#pragma unroll
  for (int j = 0; j < T; ++j) {
    if constexpr (kChroma) {
      hx[j] = kChromaTaps[fx][j];
      hy[j] = kChromaTaps[fy][j];
    } else {
      hx[j] = kLumaTaps[fx][j];
      hy[j] = kLumaTaps[fy][j];
    }
  }
  auto first = [&](int r) {
    const int16_t *q = p + r * W;
    int acc = 0;
    if (fx == 0) {
      acc = 64 * q[C];
    } else {
#pragma unroll
      for (int j = 0; j < T; ++j) acc += q[j] * hx[j];
    }
    return (acc + k.off1) >> k.shift1;
  };
  if (fy == 0) {
    for (int r = r0; r < r1; ++r)
      put(r, c, clip3(0, k.maxv, (64 * first(r + C) + k.off2) >> k.shift2));
    return;
  }
  int mid[T];
#pragma unroll
  for (int j = 0; j < T - 1; ++j) mid[j] = first(r0 + j);
  for (int r = r0; r < r1; ++r) {
    mid[T - 1] = first(r + T - 1);
    int acc = 0;
#pragma unroll
    for (int j = 0; j < T; ++j) acc += mid[j] * hy[j];
    put(r, c, clip3(0, k.maxv, (acc + k.off2) >> k.shift2));
#pragma unroll
    for (int j = 0; j < T - 1; ++j) mid[j] = mid[j + 1];
  }
}

// One block's MC: its source rows (picture_rows), its position and its
// quarter-pel luma MV (the eighth-pel chroma MV in 4:2:0)
struct McJob {
  Src s;
  int px, py, mvx, mvy;
};

// The window's top-left and the phase of job j for an N x N block
template <int N, bool kChroma>
__device__ __forceinline__ void mc_origin(const McJob &j, int &x0, int &y0,
                                          int &fx, int &fy) {
  using G = McGeom<N, kChroma>;
  fx = j.mvx & G::kMask;
  fy = j.mvy & G::kMask;
  x0 = j.px + (j.mvx >> G::kShift) - (G::kTaps / 2 - 1);
  y0 = j.py + (j.mvy >> G::kShift) - (G::kTaps / 2 - 1);
}

// Shared-memory words of mc_block_n
template <int N, bool kChroma>
__host__ __device__ constexpr int mc_block_words() {
  return words16(McGeom<N, kChroma>::kW * McGeom<N, kChroma>::kW);
}

// Kernel C8's work on one N x N block by the CTA's threads (at least N):
// the window staged into sm (mc_block_words), one barrier, both stages,
// put. No barrier at the end.
template <int N, bool kChroma, class Put>
__device__ __forceinline__ void mc_block_n(const McJob &j, int bit_depth,
                                           int32_t *sm, const Put &put) {
  using G = McGeom<N, kChroma>;
  int x0, y0, fx, fy;
  mc_origin<N, kChroma>(j, x0, y0, fx, fy);
  int16_t *win = reinterpret_cast<int16_t *>(sm);
  stage_windows<G::kW>(StageWin{j.s, x0, y0, win});
  __syncthreads();
  mc_filter<N, kChroma>(win, fx, fy, mc_shifts(bit_depth), threadIdx.x,
                        blockDim.x, put);
}

// Shared-memory words of mc_cu for N x N luma (cb and cr N/2)
template <int N>
__host__ __device__ constexpr int mc_cu_words() {
  return mc_block_words<N, false>() + 2 * mc_block_words<N / 2, true>();
}

// Kernel C14's MC of a decode CU in one pass, by the CTA's 8 warps: the
// N x N luma job y and the N/2 x N/2 chroma jobs cb and cr; the three
// windows' loads issued before their stores and the one barrier, then
// luma on warps 0-5, cb on warp 6, cr on warp 7. No barrier at the end.
template <int N, class PutY, class PutC>
__device__ __forceinline__ void mc_cu(const McJob &y, const McJob &cb,
                                      const McJob &cr, int bit_depth,
                                      int32_t *sm, const PutY &py,
                                      const PutC &pcb, const PutC &pcr) {
  constexpr int M = N / 2;
  using GY = McGeom<N, false>;
  using GC = McGeom<M, true>;
  const int warp = threadIdx.x >> 5;
  int16_t *wy = reinterpret_cast<int16_t *>(sm);
  int16_t *wcb = wy + 2 * mc_block_words<N, false>();
  int16_t *wcr = wcb + 2 * mc_block_words<M, true>();
  int xy, yy, fxy, fyy, xb, yb, fxb, fyb, xr, yr, fxr, fyr;
  mc_origin<N, false>(y, xy, yy, fxy, fyy);
  mc_origin<M, true>(cb, xb, yb, fxb, fyb);
  mc_origin<M, true>(cr, xr, yr, fxr, fyr);
  stage_windows<GY::kW, GC::kW, GC::kW>(StageWin{y.s, xy, yy, wy},
                                         StageWin{cb.s, xb, yb, wcb},
                                         StageWin{cr.s, xr, yr, wcr});
  __syncthreads();
  const McShifts k = mc_shifts(bit_depth);
  if (warp < 6)
    mc_filter<N, false>(wy, fxy, fyy, k, threadIdx.x, 192, py);
  else if (warp == 6)
    mc_filter<M, true>(wcb, fxb, fyb, k, threadIdx.x & 31, 32, pcb);
  else
    mc_filter<M, true>(wcr, fxr, fyr, k, threadIdx.x & 31, 32, pcr);
}

// Shared-memory words of mc_pair for M x M chroma
template <int M>
__host__ __device__ constexpr int mc_pair_words() {
  return 2 * mc_block_words<M, true>();
}

// Kernel C14's chroma MC of a CU in one pass (its read phase): the M x M
// jobs cb and cr, both windows staged behind one barrier, cb on warps 0-3,
// cr on warps 4-7. No barrier at the end.
template <int M, class Put>
__device__ __forceinline__ void mc_pair(const McJob &cb, const McJob &cr,
                                        int bit_depth, int32_t *sm,
                                        const Put &pcb, const Put &pcr) {
  using GC = McGeom<M, true>;
  const int warp = threadIdx.x >> 5;
  int16_t *wcb = reinterpret_cast<int16_t *>(sm);
  int16_t *wcr = wcb + 2 * mc_block_words<M, true>();
  int xb, yb, fxb, fyb, xr, yr, fxr, fyr;
  mc_origin<M, true>(cb, xb, yb, fxb, fyb);
  mc_origin<M, true>(cr, xr, yr, fxr, fyr);
  stage_windows<GC::kW, GC::kW>(StageWin{cb.s, xb, yb, wcb},
                                 StageWin{cr.s, xr, yr, wcr});
  __syncthreads();
  const McShifts k = mc_shifts(bit_depth);
  const int t = threadIdx.x & 127;
  if (warp < 4)
    mc_filter<M, true>(wcb, fxb, fyb, k, t, 128, pcb);
  else
    mc_filter<M, true>(wcr, fxr, fyr, k, t, 128, pcr);
}

}  // namespace
