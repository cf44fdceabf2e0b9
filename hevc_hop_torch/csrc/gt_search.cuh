// Device code of kernel C12, shared by its entries (gt_search.cu) and by
// kernel C14 (ss_scan.cu): the GT corner search of one (block, anchor)
// (gt_search_block) and the GT decision of one block (gt_decide_block).
// See gt_search.cu for what they compute and the float forms they keep.
// The recon windows are read with L2-coherent loads (here and in
// interp.cuh's stage_load): a persistent caller reads recon that CTAs on
// other SMs wrote earlier in the same launch.
#pragma once

#include "interp.cuh"
#include "ss_common.cuh"
#include "warp.cuh"

namespace {

constexpr int kCands = 13;
constexpr float kUnsafe = 1.0e30f;

// The moves of an iteration, candidate k = 0..12 as (corner, dx, dy):
// keep, then each coded corner right, left, down, up (gt_cand), as
// ops/gt.py MOVES lists them:
// {0, 0, 0},  {0, 1, 0}, {0, -1, 0}, {0, 0, 1},  {0, 0, -1},
// {1, 1, 0},  {1, -1, 0}, {1, 0, 1}, {1, 0, -1}, {2, 1, 0},
// {2, -1, 0}, {2, 0, 1}, {2, 0, -1}

// Stage hooks of gt_search_block (see common.cuh's Mark): the window
// staged, then each iteration (the identity set first)
enum GtMark { kGtWindow, kGtIter0, kGtMarks = kGtIter0 + 7 };

struct GtSearch {
  const int32_t *recon, *org;
  int stride;
  const int32_t *pos, *zcur, *zmax2n;
  Motion m;
  const uint8_t *nbav, *miav;
  const int32_t *anchor;
  const float *gt_rate;
  const uint8_t *gt_ok;
  int n, w, h, bit_depth, mi_size, ss_idx;
  float lam;
  int32_t *s_gtc, *s_pred;
  float *s_cost;
  int32_t *s_amv, *s_ok;
};

// float32 bins of six coded components (all exact small integers)
__device__ __forceinline__ float corner_bits(const int *v) {
  float b = 0.0f;
  for (int k = 0; k < 6; ++k) b = __fadd_rn(b, mvd_bits(v[k]));
  return b;
}

// Shared-memory words of gt_search_block for an n x n block: the [2n, 2n]
// window and the original
__host__ __device__ inline int gt_search_words(int n) {
  return (4 + 1) * n * n;
}

// An iteration's candidate sets, computed once per iteration on kCands
// threads: the coded corners, the warp's geometry and the corners' bits
struct GtCand {
  int cg[kCands][6];
  WarpGeom g[kCands];
  float bits[kCands];
};

// gt_search_block's scalars in shared memory, one for every n
struct GtShared {
  GtCand q;
  // per iteration parity: the candidates' integer SSEs and knife flags
  unsigned acc[2][kCands];   // below 2^32: n^2 (2^10 - 1)^2 at most
  int kf[2][kCands];
  // block_sum's row sums of the candidates past 2^24
  float rows[kCands][32];
  int amv[2], ok, gtc[6];
  float rate, best;
};

// Lane k < kc of the calling warp: candidate k of an iteration around the
// corners gtc (it < 0: the identity set alone; else move k by step) into
// q, with its geometry and bits
template <int N>
__device__ __forceinline__ void gt_cand(GtCand &q, const int *gtc, int it,
                                        int step, int k) {
  // move k: corner (k - 1) / 4 right, left, down or up by step
  const int c = (k - 1) >> 2, d = (k - 1) & 3, on = it >= 0 && k > 0;
  const int dx = on * ((d == 0) - (d == 1)) * step;
  const int dy = on * ((d == 2) - (d == 3)) * step;
  int cg[6];
  for (int j = 0; j < 6; ++j)
    cg[j] = gtc[j] + (j == 2 * c ? dx : j == 2 * c + 1 ? dy : 0);
  int c4[8];
  gt4(cg, c4);
  q.g[k] = warp_geom(N, c4, 0);
  q.bits[k] = corner_bits(cg);
  for (int j = 0; j < 6; ++j) q.cg[k][j] = cg[j];
}

// gt_search_block for n = N
template <int N, class MarkFn>
__device__ void gt_search_n(const GtSearch &a, int b, int an, int32_t *sm,
                            GtShared &sh, const MarkFn &mark) {
  constexpr int nn = N * N, ws = 2 * N, chunks = nn / 32;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, warps = nt >> 5;
  const int px = a.pos[2 * b], py = a.pos[2 * b + 1];
  int32_t *win = sm;            // [2n, 2n]
  int32_t *O = win + ws * ws;   // [n, n]
  int *s_amv = sh.amv, &s_ok = sh.ok, *s_gtc = sh.gtc;
  GtCand &s_q = sh.q;
  unsigned(*s_acc)[kCands] = sh.acc;
  int(*s_kf)[kCands] = sh.kf;
  float(*s_rows)[32] = sh.rows;
  float &s_rate = sh.rate, &s_best = sh.best;
  const long long o = (long long)b * 2 + an;
  if (tid == 0) {
    if (an == 0) {
      s_amv[0] = a.anchor[2 * b];
      s_amv[1] = a.anchor[2 * b + 1];
      s_ok = a.gt_ok[b];
      s_rate = a.gt_rate[b];
    } else {
      Cands c;
      gather_cands(a.m, px, py, N, a.nbav + 5 * b, a.miav + 3 * b,
                   a.mi_size, a.ss_idx, c);
      const int qx = c.preds[0][0], qy = c.preds[0][1];
      const bool valid =
          iabs(qx) < kHugePred / 2 && iabs(qy) < kHugePred / 2;
      const int dx = valid ? (qx + 2) >> 2 : 0;
      const int dy = valid ? (qy + 2) >> 2 : 0;
      const bool dup = a.gt_ok[b] && a.anchor[2 * b] == dx &&
                       a.anchor[2 * b + 1] == dy;
      s_amv[0] = dx;
      s_amv[1] = dy;
      s_ok = valid && !dup &&
             anchor_causal(a.zmax2n, px + dx, py + dy, N, a.w, a.h,
                           a.zcur[b]);
      s_rate = min_rate_bits(4 * dx, 4 * dy, &c.preds[0][0], 6);
    }
    a.s_amv[2 * o] = s_amv[0];
    a.s_amv[2 * o + 1] = s_amv[1];
    a.s_ok[o] = s_ok;
    for (int k = 0; k < 6; ++k) s_gtc[k] = 0;
  }
  __syncthreads();
  if (!s_ok) {
    for (int k = tid; k < 6; k += nt) a.s_gtc[6 * o + k] = 0;
    if (tid == 0) a.s_cost[o] = kBig;
    __syncthreads();
    return;
  }
  const int x0 = px + s_amv[0] - N / 2, y0 = py + s_amv[1] - N / 2;
  for (int i = tid; i < ws * ws; i += nt) {
    const int y = clip3(0, a.h - 1, y0 + i / ws);
    const int x = clip3(0, a.w - 1, x0 + i % ws);
    win[i] = __ldcg(a.recon + (long long)y * a.stride + x);
  }
  for (int i = tid; i < nn; i += nt)
    O[i] = a.org[(long long)(py + i / N) * a.stride + px + i % N];
  // the identity set, and the first iteration's sums cleared
  if (warp == 0 && lane < kCands) {
    if (lane == 0) gt_cand<N>(s_q, s_gtc, -1, 0, 0);
    s_acc[0][lane] = 0;
    s_kf[0][lane] = 0;
  }
  __syncthreads();
  mark(kGtWindow);
  const int maxv = (1 << a.bit_depth) - 1;
  int step = N / 2;   // warp 0's
  for (int it = -1; it < 6; ++it) {
    const int kc = it < 0 ? 1 : kCands, par = (it + 1) & 1;
    // each warp takes a run of the iteration's chunks of 32 samples (nn is
    // a multiple of 32), a lane a sample; its lanes sum a candidate's
    // squared errors in integers (exact) and flush them, a warp-shuffle sum
    // and one shared atomic, where the run moves on to the next candidate;
    // the knife flags an OR
    const int total = kc * chunks, per = (total + warps - 1) / warps;
    const int c0 = warp * per, c1 = min(total, c0 + per);
    unsigned part = 0;
    int knives = 0, kcur = c0 / chunks;
    auto flush = [&] {
      const unsigned q = warp_sum(part);
      const unsigned kany = __any_sync(~0u, knives);
      if (lane == 0) {
        atomicAdd(&s_acc[par][kcur], q);
        if (kany) s_kf[par][kcur] = 1;
      }
    };
    for (int ch = c0; ch < c1; ++ch) {
      const int k = ch / chunks, j = (ch - k * chunks) * 32 + lane;
      if (k != kcur) {   // warp-uniform
        flush();
        part = 0;
        knives = 0;
        kcur = k;
      }
      int knife = 0;
      const int e = O[j] - warp_sample<N>(s_q.g[k], win, ws, j, maxv, knife);
      part += (unsigned)(e * e);
      knives |= knife;
    }
    if (c0 < c1) flush();
    __syncthreads();
    // block_sum's order where a safe candidate's SSE passes 2^24: a
    // thread a row (block_row), folded below
    const unsigned big = __ballot_sync(
        ~0u, lane < kc && s_acc[par][lane] >= (1u << 24) &&
                 !s_kf[par][lane]);
    if (big) {
      for (int t = tid; t < kc * N; t += nt) {
        const int k = t / N, r = t - k * N;
        if (!(big >> k & 1)) continue;
        int knife = 0;   // the sums above flagged it
        s_rows[k][r] = block_row(N, r, [&](int j) {
          const float d =
              (float)(O[j] - warp_sample<N>(s_q.g[k], win, ws, j, maxv,
                                            knife));
          return __fmul_rn(d, d);
        });
      }
      __syncthreads();
    }
    // warp 0: the costs on kc lanes, the least (cost, index) by shuffles,
    // the update, then the next iteration's candidates
    if (warp == 0) {
      float cost = __int_as_float(0x7f800000);
      int ki = 32;
      if (lane < kc) {
        const unsigned acc = s_acc[par][lane];
        const float sse = (big >> lane & 1) ? fold_rows(N, s_rows[lane])
                                            : (float)acc;
        cost = s_kf[par][lane] ? kUnsafe
                               : fmaf(s_q.bits[lane], a.lam, sse);
        ki = lane;
      }
      warp_argmin(cost, ki);
      const int *cg = s_q.cg[ki];
      const bool upd = it < 0 || cost < s_best;
      int gtc[6];
      for (int j = 0; j < 6; ++j) gtc[j] = upd ? cg[j] : s_gtc[j];
      __syncwarp();
      if (lane == 0 && upd) {
        s_best = cost;
        for (int j = 0; j < 6; ++j) s_gtc[j] = gtc[j];
      }
      if (it >= 0) step = step > 1 ? step / 2 : 1;
      if (it + 1 < 6 && lane < kCands) {
        gt_cand<N>(s_q, gtc, it + 1, step, lane);
        s_acc[par ^ 1][lane] = 0;
        s_kf[par ^ 1][lane] = 0;
      }
    }
    __syncthreads();
    mark(kGtIter0 + 1 + it);
  }
  // the best set's prediction, warped once more
  int c4[8];
  gt4(s_gtc, c4);
  const WarpGeom g = warp_geom(N, c4, 0);
  int knife = 0;
  for (int i = tid; i < nn; i += nt)
    a.s_pred[o * nn + i] = warp_sample<N>(g, win, ws, i, maxv, knife);
  for (int k = tid; k < 6; k += nt) a.s_gtc[6 * o + k] = s_gtc[k];
  if (tid == 0)
    a.s_cost[o] =
        an == 0 ? __fadd_rn(__fadd_rn(s_best, s_rate), a.lam)
                : __fadd_rn(fmaf(__fadd_rn(s_rate, kInterBits), a.lam, s_best),
                            a.lam);
  __syncthreads();
}

// The search entry's work on (block b, anchor an), n = 8, 16 or 32: the
// outputs into row 2b + an of a's per-(block, anchor) arrays. sm holds
// gt_search_words(n). Ends with a barrier.
template <class MarkFn = NoMark>
__device__ void gt_search_block(const GtSearch &a, int b, int an,
                                int32_t *sm, const MarkFn &mark = MarkFn()) {
  __shared__ GtShared sh;
  if (a.n == 8)
    gt_search_n<8>(a, b, an, sm, sh, mark);
  else if (a.n == 16)
    gt_search_n<16>(a, b, an, sm, sh, mark);
  else
    gt_search_n<32>(a, b, an, sm, sh, mark);
}

struct GtDecide {
  Src rc;
  int hc_off, n, bit_depth;
  const int32_t *pos, *s_gtc, *s_pred;
  const float *s_cost;
  const int32_t *s_amv, *s_ok;
  const float *costs;
  int32_t *pred, *inter, *mv, *smode, *flag, *gtc;
  int32_t *refsel;   // PSS: costs [B, 4] and the reference index; null
  int ss_idx;
};

// Shared-memory words of gt_decide_block for an n x n block:
// gt_chroma_pair's at m = n / 2
__host__ __device__ inline int gt_decide_words(int n) {
  return n == 8 ? gt_pair_words<4>()
                : (n == 16 ? gt_pair_words<8>() : gt_pair_words<16>());
}

// Whether the chroma warps of block b's cb and cr (M x M, as they stand
// before the level's chroma recon) have a knife edge, by gt_chroma_pair
// with the corners c4 at the full-pel anchor (vx, vy); the predictions
// into ocb and ocr [M, M] where they are given.
template <int M>
__device__ __forceinline__ int gt_chroma_knife(const GtDecide &a, int b,
                                               const int *c4, int vx, int vy,
                                               int32_t *sm, int32_t *ocb,
                                               int32_t *ocr) {
  const int px = a.pos[2 * b] / 2, py = a.pos[2 * b + 1] / 2;
  Src sb = a.rc, sr = a.rc;
  sr.row_lo = a.hc_off;
  sr.row_hi = a.hc_off + a.rc.row_hi;
  return gt_chroma_pair<M>(gt_chroma_job<M>(sb, px, py, vx, vy),
                           gt_chroma_job<M>(sr, px, py + a.hc_off, vx, vy),
                           c4, a.bit_depth, sm, PutIf{ocb, M},
                           PutIf{ocr, M});
}

// The words of block b that the decision reads, lane k of a warp word k:
// the two anchors' costs (float bits), ok flags, full-pel anchors (x, y)
// and coded corners, then C10's intra, merge, SS and, on PSS, temporal
// costs (float bits)
enum GtWord {
  kWordCost = 0, kWordOk = 2, kWordAmv = 4, kWordGtc = 8, kWordC10 = 20,
  kDecideWords = 24
};

// The cheaper anchor of costs c0, c1: the first among equals, as the
// reference's argmin
__device__ __forceinline__ int gt_cheaper(float c0, float c1) {
  return c1 < c0 ? 1 : 0;
}

__device__ __forceinline__ int gt_decide_word(const GtDecide &a, int b,
                                              int k, int nc) {
  if (k < kWordOk) return __float_as_int(__ldcg(a.s_cost + 2 * b + k));
  if (k < kWordAmv) return __ldcg(a.s_ok + 2 * b + k - kWordOk);
  if (k < kWordGtc) return __ldcg(a.s_amv + 4 * b + k - kWordAmv);
  if (k < kWordC10) return __ldcg(a.s_gtc + 12 * b + k - kWordGtc);
  return k - kWordC10 < nc
             ? __float_as_int(__ldcg(a.costs + nc * b + k - kWordC10))
             : 0;
}

// Block b's anchor and candidate test, in registers
struct GtPick {
  int ai, cand;
  int corner;   // lane k < 6: the chosen anchor's coded corner word k
};

// The decision's prologue on every warp of the CTA, with no shared memory
// and no barrier: lanes load the block's words in one round of L2 loads
// (written by other CTAs of a C14 cluster), take the anchors' costs by
// shuffles and the cheaper anchor, and test their own words, each vote a
// ballot: an ok flag set, a corner of the chosen anchor not zero, a C10
// cost not above the GT cost. GT is a candidate where an anchor is ok, a
// corner is not zero and no C10 cost is at or below it: the AND of the
// reference's comparisons (SS, intra, merge, on PSS temporal), which no
// order changes.
__device__ __forceinline__ GtPick gt_pick(const GtDecide &a, int b) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int nc = a.refsel != nullptr ? 4 : 3;
  const int v = lane < kDecideWords ? gt_decide_word(a, b, lane, nc) : 0;
  const float c0 = __int_as_float(__shfl_sync(kAll, v, kWordCost));
  const float c1 = __int_as_float(__shfl_sync(kAll, v, kWordCost + 1));
  const int ai = gt_cheaper(c0, c1);
  const float g = ai ? c1 : c0;
  const int lo = kWordGtc + 6 * ai;
  const bool ok = lane >= kWordOk && lane < kWordAmv && v != 0;
  const bool nonzero = lane >= lo && lane < lo + 6 && v != 0;
  const bool beaten = lane >= kWordC10 && lane < kWordC10 + nc &&
                      !(g < __int_as_float(v));
  GtPick p;
  p.ai = ai;
  p.cand = __ballot_sync(kAll, ok) != 0 && __ballot_sync(kAll, nonzero) != 0 &&
           __ballot_sync(kAll, beaten) == 0;
  p.corner = __shfl_sync(kAll, v, lo + lane % 6);
  return p;
}

// The chosen anchor ai of block b, full pel
__device__ __forceinline__ void gt_anchor(const GtDecide &a, int b, int ai,
                                          int &vx, int &vy) {
  vx = __ldcg(a.s_amv + 4 * b + 2 * ai);
  vy = __ldcg(a.s_amv + 4 * b + 2 * ai + 1);
}

// Whether the chroma warps of GT candidate b at its chosen anchor ai (vx,
// vy) have a knife edge (gt_chroma_safe's negation), by the CTA; the
// warps of cb and cr into ocb and ocr [n/2, n/2] where they are given.
// sm holds gt_decide_words(n) and is free on entry; its last barrier is
// gt_chroma_pair's CTA-wide OR, after every read of sm. Kernel C14 runs it
// inside a call of its own (ss_scan.cu decide_tail), so that the windows'
// registers stay out of the rest of its read phase.
__device__ __forceinline__ int gt_chroma_check(const GtDecide &a, int b,
                                               int ai, int vx, int vy,
                                               int32_t *sm, int32_t *ocb,
                                               int32_t *ocr) {
  int gt[6], c4[8];
  for (int k = 0; k < 6; ++k) gt[k] = __ldcg(a.s_gtc + 12 * b + 6 * ai + k);
  gt4(gt, c4);
  return a.n == 8 ? gt_chroma_knife<4>(a, b, c4, vx, vy, sm, ocb, ocr)
                  : (a.n == 16 ? gt_chroma_knife<8>(a, b, c4, vx, vy, sm,
                                                    ocb, ocr)
                               : gt_chroma_knife<16>(a, b, c4, vx, vy, sm,
                                                     ocb, ocr));
}

// Block b's decision by the lanes of warp 0: the chosen anchor's corners
// into gtc (lanes 0-5, corner: gt_pick's), the flag (lane 6) and, where GT
// is safe and wins, C10's choice overridden: inter (lane 7), the MV =
// anchor (vx, vy) * 4 (lanes 8, 9), the diagonal scan (lane 10), the SS
// reference index on PSS (lane 11). Not the prediction.
__device__ __forceinline__ void gt_decide_put(const GtDecide &a, int b,
                                              int corner, int safe, int vx,
                                              int vy) {
  const int t = threadIdx.x;
  if (t < 6) a.gtc[6 * b + t] = corner;
  if (t == 6) a.flag[b] = safe;
  if (!safe || t < 7 || t > 11) return;
  if (t == 7) a.inter[b] = 1;
  if (t == 8) a.mv[2 * b] = 4 * vx;
  if (t == 9) a.mv[2 * b + 1] = 4 * vy;
  if (t == 10) a.smode[b] = 0;
  if (t == 11 && a.refsel != nullptr) a.refsel[b] = a.ss_idx;
}

// The decide entry's work on block b: the pick on every warp, the chroma
// check only for a candidate, the outputs, and a winner's prediction
// copied over pred in place. sm holds gt_decide_words(n). No barrier at
// the end.
__device__ void gt_decide_block(const GtDecide &a, int b, int32_t *sm) {
  const GtPick p = gt_pick(a, b);
  int safe = 0, vx = 0, vy = 0;
  if (p.cand) {
    gt_anchor(a, b, p.ai, vx, vy);
    safe = !gt_chroma_check(a, b, p.ai, vx, vy, sm, nullptr, nullptr);
  }
  gt_decide_put(a, b, p.corner, safe, vx, vy);
  if (!safe) return;
  const int nn = a.n * a.n;
  const int32_t *gp = a.s_pred + (2 * (long long)b + p.ai) * nn;
  for (int i = threadIdx.x; i < nn; i += blockDim.x)
    a.pred[(long long)b * nn + i] = __ldcg(gp + i);
}

}  // namespace
