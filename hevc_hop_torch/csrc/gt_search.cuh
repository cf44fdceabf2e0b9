// Device code of kernel C12, shared by its entries (gt_search.cu) and by
// kernel C14 (ss_scan.cu): the GT corner search of one (block, anchor)
// (gt_search_block) and the GT decision of one block (gt_decide_block).
// See gt_search.cu for what they compute and the float forms they keep.
// The recon windows are read with L2-coherent loads (here and in
// interp.cuh's mc_block): a persistent caller reads recon that CTAs on
// other SMs wrote earlier in the same launch.
#pragma once

#include "interp.cuh"
#include "ss_common.cuh"
#include "warp.cuh"

namespace {

constexpr int kCands = 13;
constexpr float kUnsafe = 1.0e30f;

// the moves of an iteration, (corner, dx, dy): keep, then each coded
// corner right, left, down, up
__constant__ int kMoves[kCands][3] = {
    {0, 0, 0},  {0, 1, 0}, {0, -1, 0}, {0, 0, 1},  {0, 0, -1},
    {1, 1, 0},  {1, -1, 0}, {1, 0, 1}, {1, 0, -1}, {2, 1, 0},
    {2, -1, 0}, {2, 0, 1}, {2, 0, -1}};

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
// window, the original, the 13 candidates and the best prediction
__host__ __device__ inline int gt_search_words(int n) {
  return (4 + 1 + kCands + 1) * n * n;
}

// The search entry's work on (block b, anchor an): the outputs into row
// 2b + an of a's per-(block, anchor) arrays. sm holds gt_search_words(n).
// Ends with a barrier.
__device__ void gt_search_block(const GtSearch &a, int b, int an,
                                int32_t *sm) {
  const int n = a.n, nn = n * n;
  const int ws = 2 * n, tid = threadIdx.x, nt = blockDim.x;
  const int px = a.pos[2 * b], py = a.pos[2 * b + 1];
  int32_t *win = sm;                 // [2n, 2n]
  int32_t *O = win + ws * ws;        // [n, n]
  int32_t *P = O + nn;               // [13][n, n]
  int32_t *best_p = P + kCands * nn;  // [n, n]
  __shared__ int s_amv[2], s_ok, s_gtc[6], s_cg[kCands][6], s_kf[kCands];
  __shared__ unsigned long long s_acc[kCands];
  __shared__ float s_rate, s_best;
  __shared__ int s_upd;
  const long long o = (long long)b * 2 + an;
  if (tid == 0) {
    if (an == 0) {
      s_amv[0] = a.anchor[2 * b];
      s_amv[1] = a.anchor[2 * b + 1];
      s_ok = a.gt_ok[b];
      s_rate = a.gt_rate[b];
    } else {
      Cands c;
      gather_cands(a.m, px, py, n, a.nbav + 5 * b, a.miav + 3 * b,
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
             anchor_causal(a.zmax2n, px + dx, py + dy, n, a.w, a.h,
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
  const int x0 = px + s_amv[0] - n / 2, y0 = py + s_amv[1] - n / 2;
  for (int i = tid; i < ws * ws; i += nt) {
    const int y = clip3(0, a.h - 1, y0 + i / ws);
    const int x = clip3(0, a.w - 1, x0 + i % ws);
    win[i] = __ldcg(a.recon + (long long)y * a.stride + x);
  }
  for (int i = tid; i < nn; i += nt)
    O[i] = a.org[(long long)(py + i / n) * a.stride + px + i % n];
  const int maxv = (1 << a.bit_depth) - 1;
  const int lane = tid & 31;
  int step = n / 2;
  for (int it = -1; it < 6; ++it) {
    const int kc = it < 0 ? 1 : kCands;   // the identity set first
    for (int k = tid; k < kc; k += nt) {
      for (int j = 0; j < 6; ++j) s_cg[k][j] = s_gtc[j];
      if (it >= 0) {
        const int c = kMoves[k][0];
        s_cg[k][2 * c] += kMoves[k][1] * step;
        s_cg[k][2 * c + 1] += kMoves[k][2] * step;
      }
      s_acc[k] = 0;
      s_kf[k] = 0;
    }
    __syncthreads();
    // nn is a multiple of 32, so each warp of threads works on one set
    for (int i0 = tid - lane; i0 < kc * nn; i0 += nt) {
      const int i = i0 + lane, k = i0 / nn, j = i - k * nn;
      int c4[8];
      gt4(s_cg[k], c4);
      const WarpGeom g = warp_geom(n, c4, 0);
      int knife = 0;
      const int v = warp_sample(g, win, ws, j, maxv, knife);
      P[k * nn + j] = v;
      const long long e = O[j] - v;
      unsigned long long q = (unsigned long long)(e * e);
      for (int sh = 16; sh > 0; sh >>= 1) q += __shfl_down_sync(~0u, q, sh);
      const unsigned kany = __any_sync(~0u, knife);
      if (lane == 0) {
        atomicAdd(&s_acc[k], q);
        if (kany) atomicOr(&s_kf[k], 1);
      }
    }
    __syncthreads();
    if (tid == 0) {
      float cmin = 0.0f;
      int ki = 0;
      for (int k = 0; k < kc; ++k) {
        const int32_t *pk = P + k * nn;
        const float sse =
            s_acc[k] < (1ull << 24)
                ? (float)s_acc[k]
                : block_sum(n, [&](int j) {
                    const float d = (float)(O[j] - pk[j]);
                    return __fmul_rn(d, d);
                  });
        const float cost =
            s_kf[k] ? kUnsafe : fmaf(corner_bits(s_cg[k]), a.lam, sse);
        if (k == 0 || cost < cmin) {
          cmin = cost;
          ki = k;
        }
      }
      s_upd = -1;
      if (it < 0 || cmin < s_best) {
        s_best = cmin;
        s_upd = ki;
        for (int k = 0; k < 6; ++k) s_gtc[k] = s_cg[ki][k];
      }
    }
    __syncthreads();
    if (s_upd >= 0)
      for (int i = tid; i < nn; i += nt) best_p[i] = P[s_upd * nn + i];
    if (it >= 0) step = step > 1 ? step / 2 : 1;
    __syncthreads();
  }
  for (int i = tid; i < nn; i += nt) a.s_pred[o * nn + i] = best_p[i];
  for (int k = tid; k < 6; k += nt) a.s_gtc[6 * o + k] = s_gtc[k];
  if (tid == 0)
    a.s_cost[o] =
        an == 0 ? __fadd_rn(__fadd_rn(s_best, s_rate), a.lam)
                : __fadd_rn(fmaf(__fadd_rn(s_rate, kInterBits), a.lam, s_best),
                            a.lam);
  __syncthreads();
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

// Shared-memory words of gt_decide_block for an n x n block: the chroma
// window (n+3)^2 and the [n, n] interpolated one (n = 2m)
__host__ __device__ inline int gt_decide_words(int n) {
  return n * n + mc_smem_words(n, 1);
}

// The decide entry's work on block b. sm holds gt_decide_words(n). Ends
// with a barrier.
__device__ void gt_decide_block(const GtDecide &a, int b, int32_t *sm) {
  const int n = a.n, nn = n * n, m = n / 2, tid = threadIdx.x;
  __shared__ int s_ai, s_cand, s_gt[6];
  if (tid == 0) {
    const float c0 = a.s_cost[2 * b], c1 = a.s_cost[2 * b + 1];
    const int ai = c1 < c0 ? 1 : 0;
    const float gcost = ai ? c1 : c0;
    int nonzero = 0;
    for (int k = 0; k < 6; ++k) {
      s_gt[k] = a.s_gtc[12 * b + 6 * ai + k];
      nonzero |= s_gt[k] != 0;
      a.gtc[6 * b + k] = s_gt[k];
    }
    const bool pss = a.refsel != nullptr;
    // intra, merge, SS (and temporal on PSS)
    const float *c = a.costs + (pss ? 4 : 3) * b;
    s_ai = ai;
    s_cand = (a.s_ok[2 * b] || a.s_ok[2 * b + 1]) && nonzero &&
             gcost < c[2] && gcost < c[0] && gcost < c[1] &&
             (!pss || gcost < c[3]);
  }
  __syncthreads();
  const int ai = s_ai;
  const int vx = a.s_amv[4 * b + 2 * ai], vy = a.s_amv[4 * b + 2 * ai + 1];
  int safe = s_cand;
  if (s_cand) {
    // the chroma warps of cb and cr must be safe (gt_chroma_safe)
    int c4[8];
    gt4(s_gt, c4);
    const WarpGeom g = warp_geom(m, c4, 1);
    const int px = a.pos[2 * b] / 2, py = a.pos[2 * b + 1] / 2;
    int32_t *win = sm;
    for (int p = 0; p < 2; ++p) {
      Src s = a.rc;
      s.row_lo = p ? a.hc_off : 0;
      s.row_hi = s.row_lo + a.rc.row_hi;
      mc_block(s, px - m / 2, py + s.row_lo - m / 2, 4 * vx, 4 * vy, n, 1,
               a.bit_depth, sm + nn, win);
      int knife = 0;
      for (int i = tid; i < m * m; i += blockDim.x)
        warp_sample(g, win, n, i, (1 << a.bit_depth) - 1, knife);
      safe &= !__syncthreads_or(knife);
    }
  }
  if (safe) {
    const int32_t *gp = a.s_pred + (2 * (long long)b + ai) * nn;
    for (int i = tid; i < nn; i += blockDim.x)
      a.pred[(long long)b * nn + i] = gp[i];
  }
  if (tid == 0) {
    a.flag[b] = safe;
    if (safe) {
      a.inter[b] = 1;
      a.mv[2 * b] = 4 * vx;
      a.mv[2 * b + 1] = 4 * vy;
      a.smode[b] = 0;
      if (a.refsel != nullptr) a.refsel[b] = a.ss_idx;
    }
  }
  __syncthreads();
}

}  // namespace
