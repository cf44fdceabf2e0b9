// Device code of kernel C10, shared by its entries (inter_arms.cu) and by
// kernel C14 (ss_scan.cu): the merge arms, the sub-pel refinement and the
// ISS and PSS tournaments of one block (inter_arms_block), and one cell of
// the motion write (motion_cell). See inter_arms.cu for what they compute
// and the float forms they keep.
#pragma once

#include "interp.cuh"
#include "ss_common.cuh"

namespace {

// the SSE reduction's slots: at most this many threads per CTA
constexpr int kArmsThreads = 256;

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
};

// float32 sum of (a - b)^2 over the n x n block in block_sum's order (see
// inter_arms.cu); the result reaches every thread
__device__ float sse_block(const int32_t *a, const int32_t *b, int n,
                           unsigned long long *red) {
  const int nn = n * n;
  __shared__ float out;
  unsigned long long part = 0;
  for (int i = threadIdx.x; i < nn; i += blockDim.x) {
    const long long d = a[i] - b[i];
    part += (unsigned long long)(d * d);
  }
  red[threadIdx.x] = part;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long tot = 0;
    for (int t = 0; t < (int)blockDim.x; ++t) tot += red[t];
    out = tot < (1ull << 24) ? (float)tot : block_sum(n, [&](int i) {
      const float d = (float)(a[i] - b[i]);
      return __fmul_rn(d, d);
    });
  }
  __syncthreads();
  return out;
}

__device__ void copy_block(int32_t *dst, const int32_t *src, int nn) {
  for (int i = threadIdx.x; i < nn; i += blockDim.x) dst[i] = src[i];
  __syncthreads();
}

// Half- then quarter-pel refinement of a full-pel search result (mv_i,
// pred0, sse0) over src with np predictors: the best quarter-pel MV into
// (mx, my), its prediction into RP, and the cost returned. SP and P are
// scratch [n, n]; O the block's original.
__device__ float refine(const Src &src, int px, int py, int n, int bit_depth,
                        float lam, const int32_t *O, const int32_t *mv_i,
                        const int32_t *pred0, float sse0, const int *preds,
                        int np, int &mx, int &my, int32_t *RP, int32_t *SP,
                        int32_t *P, int32_t *scratch,
                        unsigned long long *red) {
  const int nn = n * n;
  int bmx = 4 * mv_i[0], bmy = 4 * mv_i[1];
  float best = fmaf(__fadd_rn(min_rate_bits(bmx, bmy, preds, np), kInterBits),
                    lam, sse0);
  copy_block(RP, pred0, nn);
  if (sse0 < 1e37f) {
    for (int step = 2; step >= 1; --step) {
      const int ox = bmx, oy = bmy;
      float cmin = 0.0f;
      int ci = 0;
      for (int k = 0; k < 8; ++k) {
        const int cx = ox + kFracOffs[k][0] * step;
        const int cy = oy + kFracOffs[k][1] * step;
        mc_block(src, px, py, cx, cy, n, 0, bit_depth, scratch, P);
        const float sse = sse_block(O, P, n, red);
        const float cost = fmaf(
            __fadd_rn(min_rate_bits(cx, cy, preds, np), kInterBits), lam,
            sse);
        if (k == 0 || cost < cmin) {
          cmin = cost;
          ci = k;
          copy_block(SP, P, nn);
        }
      }
      if (cmin < best) {
        bmx = ox + kFracOffs[ci][0] * step;
        bmy = oy + kFracOffs[ci][1] * step;
        copy_block(RP, SP, nn);
      }
      best = fminf(best, cmin);
    }
  }
  mx = bmx;
  my = bmy;
  return best;
}

// Shared-memory bytes of inter_arms_block for an n x n block
__host__ __device__ inline size_t arms_smem_bytes(int n, bool pss) {
  return sizeof(int32_t) * ((pss ? 6 : 5) * n * n + mc_smem_words(n, 0)) +
         sizeof(unsigned long long) * kArmsThreads;
}

// The arms entry's work on block b at (px, py) with z-address zc: merge
// arms, refinement, tournament, the outputs into row b of a's arrays (the
// prediction over row b of a.ipred). sm holds arms_smem_bytes(n, pss).
// Ends with a barrier.
__device__ void inter_arms_block(const Arms &a, int b, int px, int py,
                                 int zc, int32_t *sm) {
  const int n = a.n, nn = n * n;
  const bool pss = a.ref.p != nullptr;
  const int ss_idx = pss ? 1 : 0;
  int32_t *O = sm;
  int32_t *P = O + nn;     // the candidate's prediction
  int32_t *MP = P + nn;    // best merge prediction
  int32_t *RP = MP + nn;   // best refined SS prediction
  int32_t *SP = RP + nn;   // best of a refinement stage
  int32_t *TP = SP + nn;   // best refined temporal prediction (PSS)
  unsigned long long *red =
      reinterpret_cast<unsigned long long *>(TP + (pss ? nn : 0));
  int32_t *scratch = reinterpret_cast<int32_t *>(red + kArmsThreads);
  __shared__ Cands c;
  for (int i = threadIdx.x; i < nn; i += blockDim.x)
    O[i] = a.org[(long long)(py + i / n) * a.recon.stride + px + i % n];
  if (threadIdx.x == 0)
    gather_cands(a.m, px, py, n, a.nbav + 5 * b, a.miav + 3 * b, a.mi_size,
                 ss_idx, c);
  __syncthreads();

  // merge arms: an SS candidate reads the recon and must be causal, a
  // temporal one (PSS) reads the previous picture
  float mcost = kBig;
  int mk = 0;
  for (int k = 0; k < 9; ++k) {
    const int cx = c.mv[k][0], cy = c.mv[k][1];
    const bool is_ss = c.ref[k] == ss_idx;
    float cost = kBig;
    const bool ok =
        c.valid[k] && (!is_ss || causal(a.zmaxw, px + (cx >> 2),
                                        py + (cy >> 2), n, a.w, a.h, zc));
    if (ok) {
      mc_block(is_ss ? a.recon : a.ref, px, py, cx, cy, n, 0, a.bit_depth,
               scratch, P);
      cost = __fadd_rn(sse_block(O, P, n, red), a.mrate[k]);
    }
    if (k == 0 || cost < mcost) {
      mcost = cost;
      mk = k;
      if (ok) copy_block(MP, P, nn);
    }
  }

  // half- then quarter-pel refinement of kernel C9's results
  int bmx, bmy, tmx = 0, tmy = 0;
  const float best =
      refine(a.recon, px, py, n, a.bit_depth, a.lam, O, a.mv_i + 2 * b,
             a.pred0 + (long long)b * nn, a.sse0[b], &c.preds[0][0], 6, bmx,
             bmy, RP, SP, P, scratch, red);
  float tbest = kBig;
  if (pss)
    tbest = refine(a.ref, px, py, n, a.bit_depth, a.lam, O, a.mv_t + 2 * b,
                   a.tpred0 + (long long)b * nn, a.tsse0[b],
                   &c.tpreds[0][0], 3, tmx, tmy, TP, SP, P, scratch, red);

  // tournament against the intra prediction
  int32_t *ip = a.ipred + (long long)b * nn;
  copy_block(P, ip, nn);
  const float icost = __fadd_rn(sse_block(O, P, n, red), a.lam_i);
  const bool ss_beats_t = !pss || best < tbest;
  const float intercost = pss ? fminf(best, tbest) : best;
  const bool merge_win = mcost < intercost && mcost < icost;
  const bool inter = merge_win || intercost < icost;
  const int32_t *AP = ss_beats_t ? RP : TP;
  if (inter)
    for (int i = threadIdx.x; i < nn; i += blockDim.x)
      ip[i] = merge_win ? MP[i] : AP[i];
  if (threadIdx.x == 0) {
    a.inter[b] = inter;
    a.mv[2 * b] = merge_win ? c.mv[mk][0] : ss_beats_t ? bmx : tmx;
    a.mv[2 * b + 1] = merge_win ? c.mv[mk][1] : ss_beats_t ? bmy : tmy;
    a.smode[b] = inter ? 0 : a.imode[b];
    const int nc = pss ? 4 : 3;
    a.costs[nc * b] = icost;
    a.costs[nc * b + 1] = mcost;
    a.costs[nc * b + 2] = best;
    if (pss) {
      a.costs[nc * b + 3] = tbest;
      a.refsel[b] = merge_win ? c.ref[mk] : ss_beats_t ? ss_idx : 0;
    }
  }
  __syncthreads();
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
