// Device code of kernel C10, shared by its entries (inter_arms.cu) and by
// kernel C14 (ss_scan.cu): the three chains of one block's arms, each a
// CTA's work (arms_merge: the merge arms and the intra cost; arms_refine:
// the SS or the temporal sub-pel refinement), the ISS and PSS tournament
// over their results (arms_tournament), all of them in turn on one CTA
// (inter_arms_block), and one cell of the motion write (motion_cell). See
// inter_arms.cu for what they compute and the float forms they keep.
#pragma once

#include "interp.cuh"
#include "ss_common.cuh"

namespace {

// the chains' CTA: a candidate per warp
constexpr int kArmsThreads = 256;
constexpr int kArmsWarps = kArmsThreads / 32;

// Stage hooks of the chains (see common.cuh's Mark): the merge arms, each
// refinement stage of the SS and the temporal chain, the tournament
enum ArmsMark { kArmsMerge, kArmsSsHalf, kArmsSsQuarter, kArmsTHalf,
                kArmsTQuarter, kArmsTournament, kArmsMarks };

// the eight (dx, dy) neighbours of the refinement, row by row
__constant__ int kFracOffs[8][2] = {{-1, -1}, {0, -1}, {1, -1}, {-1, 0},
                                    {1, 0},   {-1, 1}, {0, 1},  {1, 1}};

struct Arms {
  Src recon, ref;   // ref: the previous picture (PSS), ref.p null on ISS
  const int32_t *org;
  const int32_t *zmaxw;
  Motion m;
  const uint8_t *nbav, *miav;
  const int32_t *mv_i, *pred0;
  const float *sse0;
  int32_t *ipred;
  const int32_t *imode;
  int n, w, h, bit_depth, mi_size;
  float lam, lam_i, mrate[9];
  int32_t *inter, *mv, *smode;
  float *costs;
  // PSS: C9's temporal search, and the reference index out
  const int32_t *mv_t, *tpred0;
  const float *tsse0;
  int32_t *refsel;
  // the refinement chains' results for the tournament: the best
  // prediction [B, n, n] and quarter-pel MV [B, 2] of the SS (r) and the
  // temporal (t) chain; their costs go straight into costs
  int32_t *rpred, *tpred, *rmv, *tmv;
};

// What the merge chain leaves in its CTA's shared memory for the
// tournament: the merge cost, winner and its MV and reference index, and
// the intra cost. The winner's prediction stays in its slot of
// ArmsSm::P.
struct MergeOut {
  float mcost, icost;
  int mk, mvx, mvy, ref;
};
__shared__ MergeOut g_merge;

// A chain's shared memory (arms_smem_bytes): the block's original O
// [n*n] int32; nine predictions P [9][n*n] int16, the slot of a candidate
// (the merge's nine; a refinement stage's eight, warp w's in slot w); the
// windows, int16: a warp's own [(n+7)^2] each (the merge), or one
// [(n+9)^2] that a refinement stage's eight candidates share.
struct ArmsSm {
  int32_t *O;
  int16_t *P, *win;
};

__device__ __forceinline__ ArmsSm arms_sm(int32_t *sm, int n) {
  ArmsSm s;
  s.O = sm;
  s.P = reinterpret_cast<int16_t *>(sm + n * n);
  s.win = s.P + 9 * n * n;
  return s;
}

// Shared-memory bytes of the chains for an n x n block
__host__ __device__ inline size_t arms_smem_bytes(int n) {
  return sizeof(int32_t) * n * n +
         sizeof(int16_t) * (9 * n * n + kArmsWarps * (n + 7) * (n + 7));
}

// The float32 SSE of a warp's block from its exact integer total tot:
// tot itself below 2^24 (every partial sum of block_sum is then exact),
// else ss_common.cuh block_sum's order over the terms t(i): lane r sums row
// r (block_row), the rows fold by halves through shuffles as fold_rows
// folds them. On every lane.
template <typename F>
__device__ float warp_sse(unsigned tot, int n, F t) {
  if (tot < (1u << 24)) return (float)tot;
  __syncwarp();
  const int lane = threadIdx.x & 31;
  float v = lane < n ? block_row(n, lane, t) : 0.0f;
  for (int h = n / 2; h >= 1; h /= 2)
    v = __fadd_rn(v, __shfl_down_sync(~0u, v, h));
  return __shfl_sync(~0u, v, 0);
}

// A warp stages the window of w x w samples at (x0, y0) of s (rows and
// columns clamped as interp.cuh's stage_load clamps them, L2-coherent loads)
// into win, row stride w; with all, the CTA's threads stage it.
__device__ __forceinline__ void stage_window(const Src &s, int x0, int y0,
                                             int w, int16_t *win, bool all) {
  const int t0 = all ? threadIdx.x : threadIdx.x & 31;
  const int nt = all ? blockDim.x : 32;
  for (int i = t0; i < w * w; i += nt) {
    const int y = clip3(s.row_lo, s.row_hi, y0 + i / w);
    const int x = clip3(0, s.w - 1, x0 + i % w);
    win[i] = (int16_t)__ldcg(s.p + (long long)y * s.stride + x);
  }
}

// One candidate's n x n quarter-pel luma prediction (n = 8, 16 or 32) by
// the lanes of a warp, interp.cuh mc_filter's arithmetic: win is the
// candidate's (n+7)^2 window (row stride ws), (fx, fy) its phase. Lane l
// takes column l % n of n*n/32 rows, from row (l / n) * n*n/32, and slides
// the eight first-stage rows its second stage reads down them in
// registers. The
// samples into out [n*n]; the integer SSE against O returned on every
// lane (below 2^32: n^2 (2^10 - 1)^2 at most).
__device__ unsigned mc_warp(const int16_t *win, int ws, int fx, int fy,
                            int n, int bit_depth, const int32_t *O,
                            int16_t *out) {
  const int lane = threadIdx.x & 31;
  const int rows = n * n / 32, col = lane % n, r0 = (lane / n) * rows;
  const int headroom = 14 - bit_depth;
  const int shift1 = 6 - headroom;
  const int off1 = -(8192 << shift1);
  const int shift2 = 6 + headroom;
  const int off2 = (8192 << 6) + (1 << (shift2 - 1));
  const int maxv = (1 << bit_depth) - 1;
  int hx[8], hy[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    hx[k] = kLumaTaps[fx][k];
    hy[k] = kLumaTaps[fy][k];
  }
  const int16_t *p = win + r0 * ws + col;
  auto first = [&](int r) {
    const int16_t *q = p + r * ws;
    int acc = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc += q[k] * hx[k];
    return (acc + off1) >> shift1;
  };
  int mid[8];
#pragma unroll
  for (int k = 0; k < 7; ++k) mid[k] = first(k);
  unsigned sse = 0;
  for (int r = 0; r < rows; ++r) {
    mid[7] = first(r + 7);
    int acc = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) acc += mid[k] * hy[k];
    const int v = clip3(0, maxv, (acc + off2) >> shift2);
    const int i = (r0 + r) * n + col;
    out[i] = (int16_t)v;
    const int e = O[i] - v;
    sse += (unsigned)(e * e);
#pragma unroll
    for (int k = 0; k < 7; ++k) mid[k] = mid[k + 1];
  }
  return warp_sum(sse);
}

// The CTA stages the block's original into O and thread 0 gathers the
// candidates into c; then a barrier.
__device__ __forceinline__ void arms_start(const Arms &a, int b, int px,
                                           int py, int32_t *O, Cands &c) {
  const int n = a.n, nn = n * n;
  for (int i = threadIdx.x; i < nn; i += blockDim.x)
    O[i] = a.org[(long long)(py + i / n) * a.recon.stride + px + i % n];
  if (threadIdx.x == 0)
    gather_cands(a.m, px, py, n, a.nbav + 5 * b, a.miav + 3 * b, a.mi_size,
                 a.ref.p != nullptr ? 1 : 0, c);
  __syncthreads();
}

// The merge chain of block b at (px, py) with z-address zc on one CTA:
// the nine merge candidates and the intra prediction's SSE as ten tasks
// over the warps (warp w takes tasks w and w + 8), each candidate that is
// available and causal (an SS one; a temporal one on PSS reads the
// previous picture) predicted into its slot of P from a window of the
// warp's own, costing SSE + its folded merge rate; the least (cost,
// index) wins. Leaves g_merge and the winner's slot for arms_tournament.
// sm holds arms_smem_bytes(n). Ends with a barrier.
template <class MarkFn>
__device__ void arms_merge(const Arms &a, int b, int px, int py, int zc,
                           int32_t *sm, const MarkFn &mark) {
  const int n = a.n, nn = n * n, ws = n + 7;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ss_idx = a.ref.p != nullptr ? 1 : 0;
  const ArmsSm s = arms_sm(sm, n);
  __shared__ Cands c;
  __shared__ float cost[10];
  arms_start(a, b, px, py, s.O, c);
  for (int k = warp; k < 10; k += kArmsWarps) {
    float ck;
    if (k == 9) {   // the intra prediction (kernel C2's)
      const int32_t *ip = a.ipred + (long long)b * nn;
      unsigned q = 0;
      for (int i = lane; i < nn; i += 32) {
        const int e = s.O[i] - __ldcg(ip + i);
        q += (unsigned)(e * e);
      }
      ck = __fadd_rn(warp_sse(warp_sum(q), n, [&](int i) {
                       const float d = (float)(s.O[i] - __ldcg(ip + i));
                       return __fmul_rn(d, d);
                     }),
                     a.lam_i);
    } else {
      const int cx = c.mv[k][0], cy = c.mv[k][1];
      const bool is_ss = c.ref[k] == ss_idx;
      ck = kBig;
      if (c.valid[k] && (!is_ss || causal(a.zmaxw, px + (cx >> 2),
                                          py + (cy >> 2), n, a.w, a.h,
                                          zc))) {
        int16_t *win = s.win + warp * ws * ws;
        int16_t *P = s.P + k * nn;
        stage_window(is_ss ? a.recon : a.ref, px + (cx >> 2) - 3,
                     py + (cy >> 2) - 3, ws, win, false);
        __syncwarp();
        const unsigned q =
            mc_warp(win, ws, cx & 3, cy & 3, n, a.bit_depth, s.O, P);
        ck = __fadd_rn(warp_sse(q, n, [&](int i) {
                         const float d = (float)(s.O[i] - P[i]);
                         return __fmul_rn(d, d);
                       }),
                       a.mrate[k]);
      }
    }
    if (lane == 0) cost[k] = ck;
  }
  __syncthreads();
  if (warp == 0) {
    float cm = lane < 9 ? cost[lane] : __int_as_float(0x7f800000);
    int km = lane < 9 ? lane : 32;
    warp_argmin(cm, km);
    if (lane == 0)
      g_merge = MergeOut{cm, cost[9], km, c.mv[km][0], c.mv[km][1],
                         c.ref[km]};
  }
  __syncthreads();
  mark(kArmsMerge);
}

// The SS (or, with temporal, the temporal) refinement chain of block b
// at (px, py) on one CTA: kernel C9's full-pel result (mv_i, pred0, sse0;
// or mv_t, tpred0, tsse0 over the previous picture) refined by half and
// then quarter pel, each stage's eight neighbours a warp each from one
// shared (n+9)^2 window, costing fmaf(6 + least MVD bits, lambda, SSE);
// the least (cost, index) is kept when strictly below the best so far, and
// its warp writes its prediction to rpred (tpred). The cost into costs
// [b, 2] ([b, 3]), the MV into rmv (tmv); pred0 copied to rpred where no
// stage improved (unless they are one buffer). Reads C9's results with
// L2-coherent loads: another CTA of C14's cluster wrote them. sm holds
// arms_smem_bytes(n). Ends with a barrier.
template <class MarkFn>
__device__ void arms_refine(const Arms &a, int b, int px, int py,
                            bool temporal, int32_t *sm, const MarkFn &mark) {
  const int n = a.n, nn = n * n, ws = n + 9;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const ArmsSm s = arms_sm(sm, n);
  const Src &src = temporal ? a.ref : a.recon;
  const int32_t *mv0 = (temporal ? a.mv_t : a.mv_i) + 2 * b;
  const int32_t *pred0 = (temporal ? a.tpred0 : a.pred0) + (long long)b * nn;
  int32_t *out = (temporal ? a.tpred : a.rpred) + (long long)b * nn;
  const float sse0 = __ldcg(temporal ? a.tsse0 + b : a.sse0 + b);
  __shared__ Cands c;
  __shared__ float cost[kArmsWarps];
  int bmx = 4 * __ldcg(mv0), bmy = 4 * __ldcg(mv0 + 1);
  // the half-pel stage's window staged beside the original and the
  // candidates, before one barrier
  if (sse0 < 1e37f)
    stage_window(src, px + (bmx >> 2) - 4, py + (bmy >> 2) - 4, ws, s.win,
                 true);
  arms_start(a, b, px, py, s.O, c);
  const int *preds = temporal ? &c.tpreds[0][0] : &c.preds[0][0];
  const int np = temporal ? 3 : 6;
  float best = fmaf(__fadd_rn(min_rate_bits(bmx, bmy, preds, np), kInterBits),
                    a.lam, sse0);
  bool moved = false;
  for (int step = 2; step >= 1; --step) {
    if (sse0 < 1e37f) {
      const int ox = bmx, oy = bmy;
      const int x0 = (ox >> 2) - 4, y0 = (oy >> 2) - 4;
      if (step == 1) {
        stage_window(src, px + x0, py + y0, ws, s.win, true);
        __syncthreads();
      }
      const int cx = ox + kFracOffs[warp][0] * step;
      const int cy = oy + kFracOffs[warp][1] * step;
      int16_t *P = s.P + warp * nn;
      const unsigned q =
          mc_warp(s.win + ((cy >> 2) - 3 - y0) * ws + (cx >> 2) - 3 - x0, ws,
                  cx & 3, cy & 3, n, a.bit_depth, s.O, P);
      const float sse = warp_sse(q, n, [&](int i) {
        const float d = (float)(s.O[i] - P[i]);
        return __fmul_rn(d, d);
      });
      if (lane == 0)
        cost[warp] = fmaf(
            __fadd_rn(min_rate_bits(cx, cy, preds, np), kInterBits), a.lam,
            sse);
      __syncthreads();
      // every warp takes the same argmin
      float cm = lane < kArmsWarps ? cost[lane] : __int_as_float(0x7f800000);
      int ci = lane < kArmsWarps ? lane : 32;
      warp_argmin(cm, ci);
      if (cm < best) {
        bmx = ox + kFracOffs[ci][0] * step;
        bmy = oy + kFracOffs[ci][1] * step;
        moved = true;
        if (warp == ci)
          for (int i = lane; i < nn; i += 32) out[i] = s.P[ci * nn + i];
      }
      best = fminf(best, cm);
    }
    mark((temporal ? kArmsTHalf : kArmsSsHalf) + 2 - step);
  }
  if (!moved && out != pred0)
    for (int i = threadIdx.x; i < nn; i += blockDim.x)
      out[i] = __ldcg(pred0 + i);
  if (threadIdx.x == 0) {
    int32_t *mv = (temporal ? a.tmv : a.rmv) + 2 * b;
    mv[0] = bmx;
    mv[1] = bmy;
    a.costs[(a.ref.p != nullptr ? 4 : 3) * b + (temporal ? 3 : 2)] = best;
  }
  __syncthreads();
}

// The tournament of block b on the merge chain's CTA, after every chain:
// intra (its cost from g_merge), merge (g_merge and its slot of P), SS
// (and temporal on PSS: the lower of the two is the inter cost, SS winning
// only when strictly lower) from costs, rmv and rpred (tmv, tpred); the
// chosen prediction over row b of ipred, and the outputs. The chains'
// results are read with L2-coherent loads. Ends with a barrier.
template <class MarkFn>
__device__ void arms_tournament(const Arms &a, int b, int32_t *sm,
                                const MarkFn &mark) {
  const int nn = a.n * a.n;
  const bool pss = a.ref.p != nullptr;
  const int nc = pss ? 4 : 3, ss_idx = pss ? 1 : 0;
  const ArmsSm s = arms_sm(sm, a.n);
  const MergeOut mo = g_merge;
  const float best = __ldcg(a.costs + nc * b + 2);
  const float tbest = pss ? __ldcg(a.costs + nc * b + 3) : kBig;
  const bool ss_beats_t = !pss || best < tbest;
  const float intercost = pss ? fminf(best, tbest) : best;
  const bool merge_win = mo.mcost < intercost && mo.mcost < mo.icost;
  const bool inter = merge_win || intercost < mo.icost;
  int32_t *ip = a.ipred + (long long)b * nn;
  const int32_t *AP = (ss_beats_t ? a.rpred : a.tpred) + (long long)b * nn;
  const int16_t *MP = s.P + mo.mk * nn;
  if (inter)
    for (int i = threadIdx.x; i < nn; i += blockDim.x)
      ip[i] = merge_win ? MP[i] : __ldcg(AP + i);
  if (threadIdx.x == 0) {
    const int32_t *amv = (ss_beats_t ? a.rmv : a.tmv) + 2 * b;
    a.inter[b] = inter;
    a.mv[2 * b] = merge_win ? mo.mvx : __ldcg(amv);
    a.mv[2 * b + 1] = merge_win ? mo.mvy : __ldcg(amv + 1);
    a.smode[b] = inter ? 0 : __ldcg(a.imode + b);
    a.costs[nc * b] = mo.icost;
    a.costs[nc * b + 1] = mo.mcost;
    if (pss) a.refsel[b] = merge_win ? mo.ref : ss_beats_t ? ss_idx : 0;
  }
  __syncthreads();
  mark(kArmsTournament);
}

// The arms entry's work on block b at (px, py) with z-address zc, every
// chain in turn on one CTA (the refinements first: the merge leaves its
// winner in shared memory for the tournament): the outputs into row b of
// a's arrays (the prediction over row b of a.ipred). sm holds
// arms_smem_bytes(n). Ends with a barrier.
template <class MarkFn = NoMark>
__device__ void inter_arms_block(const Arms &a, int b, int px, int py,
                                 int zc, int32_t *sm,
                                 const MarkFn &mark = MarkFn()) {
  arms_refine(a, b, px, py, false, sm, mark);
  if (a.ref.p != nullptr) arms_refine(a, b, px, py, true, sm, mark);
  arms_merge(a, b, px, py, zc, sm, mark);
  arms_tournament(a, b, sm, mark);
}

// One 4x4 cell (y, x) of the motion write: the block's MV (zero for intra)
// and inter flag into mvx4, mvy4 and pi4, and with rf4 its reference index
__device__ __forceinline__ void motion_cell(int32_t *mvx4, int32_t *mvy4,
                                            int32_t *pi4, int32_t *rf4,
                                            int wp, int y, int x, int on,
                                            int mvx, int mvy, int ref) {
  const long long o = (long long)y * wp + x;
  mvx4[o] = on ? mvx : 0;
  mvy4[o] = on ? mvy : 0;
  pi4[o] = on;
  if (rf4 != nullptr) rf4[o] = on ? ref : 0;
}

}  // namespace
