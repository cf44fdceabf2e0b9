// Kernel C12: the GT corner search of the ISS tournament, and the GT
// decision.
//
// Replaces hevc_hop_tpu/models/ss_scan.py _gt_search, _gt_arm (search
// entry, hh_gt_search), and the GT branch of scan_encode_iss's step with
// gt_chroma_safe (decide entry, hh_gt_decide).
//
// Search entry, one CTA per (block, anchor). Anchor 0 is kernel C9's ring
// (the least-cost displacement whose 2n window is causal); anchor 1 is the
// block's first AMVP predictor (ss_common.cuh gather_cands, read before the
// level's motion write), rounded to full pel, when it is valid, causal and
// not anchor 0 again. A CTA whose anchor is not causal writes a cost of
// 3e38 and stops. Otherwise it stages the clamped [2n, 2n] recon window
// around the anchor and the block's original in shared memory, and runs the
// reference's diamond search: the identity corners, then six iterations of
// 13 corner sets (keep; each coded corner moved by +-s on one axis; s from
// n/2 halving to 1). The 13 warps of an iteration run at once over the CTA
// (warp.cuh warp_sample, one sample a thread at a time), each into its own
// shared buffer; a warp of threads shares one candidate, so the SSE is a
// warp-shuffle sum and one shared atomic per warp, in integers (exact), and
// the knife flags an OR. Thread 0 then costs each set, fma(bits, lambda,
// SSE) or 1e30 where the warp is not safe, and keeps the least (the first
// among equals) when it is strictly below the best so far. The CTA writes
// the best corners, prediction and total cost: (cost + ring rate) + lambda
// for anchor 0, fma(6 + MVD bits, lambda, cost) + lambda for anchor 1.
//
// Decide entry, one CTA per block: the cheaper anchor (the first among
// equals); where its cost beats kernel C10's intra, merge and SS costs and
// its corners are not all zero, the chroma warp of both planes (cb and cr
// as they stand before the level's chroma recon: interp.cuh's mc_block at
// phase 0 or 4, then the half-pel warp) must be safe. Then the GT flag is
// set and C10's choice overridden in place: the prediction, inter = 1,
// MV = anchor * 4, the diagonal scan (mode 0).
//
// Floats: each SSE is the reference's float32 sum where that is exact
// (below 2^24); above it, ss_common.cuh block_sum's order, which is not the
// compiled reference's (ROADMAP.md F9: 32x32 blocks so far from their
// prediction, or 10-bit samples).
//
// Bound: int32 operations: 79 warps of n^2 samples per (block, anchor),
// about 30 operations each, against a window of 4 n^2 and a block of n^2
// samples read once. The CTA keeps every candidate in shared memory (19 n^2
// words, 76 KB at 32x32); a level's tens of CTAs leave most of the card's
// 132 SMs idle.
#include "interp.cuh"
#include "ss_common.cuh"
#include "warp.cuh"

namespace {

constexpr int kThreads = 256;
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
  int n, w, h, bit_depth, mi_size;
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

__global__ void gt_search_kernel(GtSearch a) {
  extern __shared__ int32_t sm[];
  const int b = blockIdx.x, an = blockIdx.y, n = a.n, nn = n * n;
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
                   a.mi_size, c);
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
    return;
  }
  const int x0 = px + s_amv[0] - n / 2, y0 = py + s_amv[1] - n / 2;
  for (int i = tid; i < ws * ws; i += nt) {
    const int y = clip3(0, a.h - 1, y0 + i / ws);
    const int x = clip3(0, a.w - 1, x0 + i % ws);
    win[i] = a.recon[(long long)y * a.stride + x];
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
}

struct GtDecide {
  Src rc;
  int hc_off, n, bit_depth;
  const int32_t *pos, *s_gtc, *s_pred;
  const float *s_cost;
  const int32_t *s_amv, *s_ok;
  const float *costs;
  int32_t *pred, *inter, *mv, *smode, *flag, *gtc;
};

__global__ void gt_decide_kernel(GtDecide a) {
  extern __shared__ int32_t sm[];
  const int b = blockIdx.x, n = a.n, nn = n * n, m = n / 2, tid = threadIdx.x;
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
    const float *c = a.costs + 3 * b;   // intra, merge, SS
    s_ai = ai;
    s_cand = (a.s_ok[2 * b] || a.s_ok[2 * b + 1]) && nonzero &&
             gcost < c[2] && gcost < c[0] && gcost < c[1];
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
    }
  }
}

int raise_smem(const void *kernel, size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// Search entry. recon/org int32 planes (row stride); pos [B, 2], zcur [B],
// zmax2n [h-2n+1, w-2n+1] int32; the motion planes [hp, wp] int32; nbav
// [B, 5], miav [B, 3] bool; C9's ring: anchor [B, 2] int32, gt_rate [B]
// float32, gt_ok [B] bool. Out per (block, anchor): s_gtc [B, 2, 6],
// s_pred [B, 2, n, n], s_amv [B, 2, 2], s_ok [B, 2] int32, s_cost [B, 2]
// float32.
HH_EXPORT int hh_gt_search(
    const void *recon, const void *org, int stride, const void *pos,
    const void *zcur, const void *zmax2n, const void *mvx4, const void *mvy4,
    const void *pi4, const void *rf4, int hp, int wp, const void *nbav,
    const void *miav, const void *anchor, const void *gt_rate,
    const void *gt_ok, int b, int n, int w, int h, int bit_depth,
    int mi_size, float lam, void *s_gtc, void *s_pred, void *s_cost,
    void *s_amv, void *s_ok, void *stream) {
  GtSearch a;
  a.recon = static_cast<const int32_t *>(recon);
  a.org = static_cast<const int32_t *>(org);
  a.stride = stride;
  a.pos = static_cast<const int32_t *>(pos);
  a.zcur = static_cast<const int32_t *>(zcur);
  a.zmax2n = static_cast<const int32_t *>(zmax2n);
  a.m = Motion{static_cast<const int32_t *>(mvx4),
               static_cast<const int32_t *>(mvy4),
               static_cast<const int32_t *>(pi4),
               static_cast<const int32_t *>(rf4), hp, wp};
  a.nbav = static_cast<const uint8_t *>(nbav);
  a.miav = static_cast<const uint8_t *>(miav);
  a.anchor = static_cast<const int32_t *>(anchor);
  a.gt_rate = static_cast<const float *>(gt_rate);
  a.gt_ok = static_cast<const uint8_t *>(gt_ok);
  a.n = n;
  a.w = w;
  a.h = h;
  a.bit_depth = bit_depth;
  a.mi_size = mi_size;
  a.lam = lam;
  a.s_gtc = static_cast<int32_t *>(s_gtc);
  a.s_pred = static_cast<int32_t *>(s_pred);
  a.s_cost = static_cast<float *>(s_cost);
  a.s_amv = static_cast<int32_t *>(s_amv);
  a.s_ok = static_cast<int32_t *>(s_ok);
  const size_t smem = sizeof(int32_t) * (4 + 1 + kCands + 1) * n * n;
  const int err = raise_smem((const void *)gt_search_kernel, smem);
  if (err) return err;
  gt_search_kernel<<<dim3(b, 2), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Decide entry. rc: the stacked cb/cr recon int32 (pw columns, row stride;
// cr from row hc_off, hc rows per picture); pos [B, 2]; the search entry's
// outputs; costs [B, 3] float32 (intra, merge, SS) from kernel C10. In
// place where GT wins: pred [B, n, n], inter [B], mv [B, 2], smode [B]
// int32. Out: flag [B], gtc [B, 6] int32.
HH_EXPORT int hh_gt_decide(const void *rc, int pw, int stride, int b, int n,
                           int hc, int hc_off, int bit_depth, const void *pos,
                           const void *s_gtc, const void *s_pred,
                           const void *s_cost, const void *s_amv,
                           const void *s_ok, const void *costs, void *pred,
                           void *inter, void *mv, void *smode, void *flag,
                           void *gtc, void *stream) {
  GtDecide a;
  a.rc = Src{static_cast<const int32_t *>(rc), stride, 0, hc - 1, pw};
  a.hc_off = hc_off;
  a.n = n;
  a.bit_depth = bit_depth;
  a.pos = static_cast<const int32_t *>(pos);
  a.s_gtc = static_cast<const int32_t *>(s_gtc);
  a.s_pred = static_cast<const int32_t *>(s_pred);
  a.s_cost = static_cast<const float *>(s_cost);
  a.s_amv = static_cast<const int32_t *>(s_amv);
  a.s_ok = static_cast<const int32_t *>(s_ok);
  a.costs = static_cast<const float *>(costs);
  a.pred = static_cast<int32_t *>(pred);
  a.inter = static_cast<int32_t *>(inter);
  a.mv = static_cast<int32_t *>(mv);
  a.smode = static_cast<int32_t *>(smode);
  a.flag = static_cast<int32_t *>(flag);
  a.gtc = static_cast<int32_t *>(gtc);
  // the (n+3)^2 chroma window and the [n, n] interpolated one (n = 2m)
  const size_t smem = sizeof(int32_t) * (n * n + mc_smem_words(n, 1));
  gt_decide_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a);
  return (int)cudaGetLastError();
}
