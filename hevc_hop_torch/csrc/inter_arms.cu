// Kernel C10: merge arms, sub-pel refinement and the ISS and PSS
// tournaments; and the write of a level's motion into the carried planes.
//
// Replaces hevc_hop_tpu/models/ss_scan.py _gather_cands, _merge_arms,
// _frac_refine, _min_rate_bits and the intra / SS / merge tournament of
// scan_encode_iss's step, and the intra / SS / temporal / merge one of
// scan_encode_pss's (:982-1003), with the GT warp off (entry
// hh_inter_arms), and those steps' motion-plane scatter (entry
// hh_motion_write).
//
// Arms entry, one CTA per block. Thread 0 gathers the nine merge candidates
// and six AMVP predictors (ss_common.cuh). Each merge candidate that is
// available and causal is predicted by the exact quarter-pel MC (interp.cuh
// mc_block, the CTA's threads) and costs SSE + its folded merge rate; the
// least wins, the first among equals. The full-pel result of kernel C9 is
// refined by half and then quarter pel: eight neighbours per stage, each
// costing fmaf(6 + its least MVD bits, lambda, SSE), kept when strictly
// better. The tournament then compares intra (SSE of kernel C2's
// prediction + lambda * 8), merge and SS, writes the chosen prediction over
// the intra one in place, and the inter flag, the MV, the mode that picks
// kernel C3's scan (0 for inter: the diagonal scan) and the three costs.
//
// PSS form (ref not null; L0 = [previous picture, SS], the SS reference at
// index 1): a merge candidate that names the temporal reference is
// predicted from the previous picture and needs no causal test; C9's
// temporal result is refined over the previous picture with the temporal
// predictors; the tournament takes the lower of the SS and temporal costs
// as the inter cost (the SS arm wins only when strictly lower, as in the
// reference), and writes the four costs and the reference index too.
//
// Floats: each SSE is the reference's float32 sum (ss_common.cuh block_sum's
// order). The terms are exact integers, so when their integer total stays
// below 2^24 every partial sum is exact and the total is that sum: the CTA
// adds in integers and thread 0 takes block_sum's order only above 2^24.
//
// Motion entry, one thread per 4x4 cell of a launch's blocks: writes each
// block's MV (zero for intra) and inter flag into mvx4, mvy4 and pi4 (on a
// PSS picture its reference index into rf4, zero for intra), after the
// arms entry of every block of the level has read them.
//
// Bound: integer operations: 25 MCs (41 in the PSS form) of (n+7) n 8-tap
// and n^2 8-tap multiply-adds each against n^2 + (n+7)^2 samples. The design keeps the
// block, the MC scratch and the three running predictions in shared memory;
// the candidates run one after another, each over the whole CTA.
#include "interp.cuh"
#include "ss_common.cuh"

namespace {

constexpr int kThreads = 256;

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
// the header); the result reaches every thread
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

__global__ void inter_arms_kernel(Arms a, const int32_t *pos,
                                  const int32_t *zcur) {
  extern __shared__ int32_t sm[];
  const int b = blockIdx.x, n = a.n, nn = n * n;
  const int px = pos[2 * b], py = pos[2 * b + 1], zc = zcur[b];
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
  int32_t *scratch = reinterpret_cast<int32_t *>(red + kThreads);
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
}

__global__ void motion_write_kernel(int32_t *mvx4, int32_t *mvy4,
                                    int32_t *pi4, int wp, const int32_t *pos,
                                    const int32_t *inter, const int32_t *mv,
                                    int nb, int u, int32_t *rf4,
                                    const int32_t *refsel) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)nb * u * u) return;
  const int b = (int)(i / (u * u)), cell = (int)(i % (u * u));
  const int y = pos[2 * b + 1] / 4 + cell / u, x = pos[2 * b] / 4 + cell % u;
  const long long o = (long long)y * wp + x;
  const int on = inter[b] != 0;
  mvx4[o] = on ? mv[2 * b] : 0;
  mvy4[o] = on ? mv[2 * b + 1] : 0;
  pi4[o] = on;
  if (rf4 != nullptr) rf4[o] = on ? refsel[b] : 0;
}

}  // namespace

// Arms entry. recon/org int32 planes (row stride, the recon's rows read up
// to h - 1); pos [B, 2], zcur [B], zmaxw int32; the motion planes [hp, wp]
// int32; nbav [B, 5], miav [B, 3] bool; mv_i [B, 2] and pred0 [B, n, n]
// int32 and sse0 [B] float32 from kernel C9; ipred [B, n, n] and imode [B]
// int32 from kernel C2 (ipred is overwritten). lam float32, lam_i = float32
// (lam * 8), mrate[9] the merge rates. Out: inter, mv [B, 2], smode int32,
// costs [B, 3] float32. PSS form: ref the previous picture (int32, the
// recon's row stride, h rows), mv_t [B, 2] and tpred0 [B, n, n] int32 and
// tsse0 [B] float32 from kernel C9's temporal search; costs [B, 4] and
// refsel [B] int32 out. ref null: the ISS form.
HH_EXPORT int hh_inter_arms(
    const void *recon, const void *org, int stride, const void *pos,
    const void *zcur, const void *zmaxw, const void *mvx4, const void *mvy4,
    const void *pi4, const void *rf4, int hp, int wp, const void *nbav,
    const void *miav, const void *mv_i, const void *pred0, const void *sse0,
    void *ipred, const void *imode, int b, int n, int w, int h,
    int bit_depth, int mi_size, float lam, float lam_i, float r0, float r1,
    float r2, float r3, float r4, float r5, float r6, float r7, float r8,
    void *inter, void *mv, void *smode, void *costs, const void *ref,
    const void *mv_t, const void *tpred0, const void *tsse0, void *refsel,
    void *stream) {
  Arms a;
  a.recon = Src{static_cast<const int32_t *>(recon), stride, 0, h - 1, w};
  a.ref = Src{static_cast<const int32_t *>(ref), stride, 0, h - 1, w};
  a.mv_t = static_cast<const int32_t *>(mv_t);
  a.tpred0 = static_cast<const int32_t *>(tpred0);
  a.tsse0 = static_cast<const float *>(tsse0);
  a.refsel = static_cast<int32_t *>(refsel);
  a.org = static_cast<const int32_t *>(org);
  a.zmaxw = static_cast<const int32_t *>(zmaxw);
  a.m = Motion{static_cast<const int32_t *>(mvx4),
               static_cast<const int32_t *>(mvy4),
               static_cast<const int32_t *>(pi4),
               static_cast<const int32_t *>(rf4), hp, wp};
  a.nbav = static_cast<const uint8_t *>(nbav);
  a.miav = static_cast<const uint8_t *>(miav);
  a.mv_i = static_cast<const int32_t *>(mv_i);
  a.pred0 = static_cast<const int32_t *>(pred0);
  a.sse0 = static_cast<const float *>(sse0);
  a.ipred = static_cast<int32_t *>(ipred);
  a.imode = static_cast<const int32_t *>(imode);
  a.n = n;
  a.w = w;
  a.h = h;
  a.bit_depth = bit_depth;
  a.mi_size = mi_size;
  a.lam = lam;
  a.lam_i = lam_i;
  const float r[9] = {r0, r1, r2, r3, r4, r5, r6, r7, r8};
  for (int k = 0; k < 9; ++k) a.mrate[k] = r[k];
  a.inter = static_cast<int32_t *>(inter);
  a.mv = static_cast<int32_t *>(mv);
  a.smode = static_cast<int32_t *>(smode);
  a.costs = static_cast<float *>(costs);
  const int bufs = ref != nullptr ? 6 : 5;
  const size_t smem =
      sizeof(int32_t) * (bufs * n * n + mc_smem_words(n, 0)) +
      sizeof(unsigned long long) * kThreads;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        (const void *)inter_arms_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  inter_arms_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const int32_t *>(pos), static_cast<const int32_t *>(zcur));
  return (int)cudaGetLastError();
}

// Motion entry: mvx4, mvy4, pi4 int32 [hp, wp]; pos [B, 2], inter [B], mv
// [B, 2] int32 of B blocks of size n; on a PSS picture rf4 [hp, wp] and
// refsel [B] int32 (both null on an ISS one).
HH_EXPORT int hh_motion_write(void *mvx4, void *mvy4, void *pi4, int wp,
                              const void *pos, const void *inter,
                              const void *mv, int b, int n, void *rf4,
                              const void *refsel, void *stream) {
  const int u = n / 4;
  const long long items = (long long)b * u * u;
  const int threads = 128;
  motion_write_kernel<<<(int)((items + threads - 1) / threads), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t *>(mvx4), static_cast<int32_t *>(mvy4),
      static_cast<int32_t *>(pi4), wp, static_cast<const int32_t *>(pos),
      static_cast<const int32_t *>(inter), static_cast<const int32_t *>(mv),
      b, u, static_cast<int32_t *>(rf4), static_cast<const int32_t *>(refsel));
  return (int)cudaGetLastError();
}
