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
// The device code is in inter_arms.cuh (inter_arms_block, motion_cell),
// which kernel C14 (ss_scan.cu) runs too.
//
// Arms entry, one CTA per block, its three chains in turn (kernel C14 runs
// them side by side on three CTAs of a CU's cluster, the tournament after).
// A chain runs a candidate per warp: the warp stages the candidate's
// window (the merge: a window of its own; a refinement stage: one (n+9)^2
// window the eight neighbours share, staged once by the CTA), predicts it
// by the exact quarter-pel MC (inter_arms.cuh mc_warp: interp.cuh
// mc_filter's arithmetic, a lane a column, the first stage's rows sliding
// down in registers) and sums its SSE by shuffles; the choice among a
// stage's candidates is a warp argmin on (cost, index), the first index
// among equals, and only the winner's warp writes its samples out. The SS
// chain refines the full-pel result of kernel C9 by half and then quarter
// pel: eight neighbours per stage, each costing fmaf(6 + its least MVD
// bits, lambda, SSE), kept when strictly better. The merge chain: the
// nine merge candidates (thread 0 gathers them and the six AMVP predictors,
// ss_common.cuh), each available and causal one costing SSE + its folded
// merge rate, the least winning, the first among equals; and the SSE of
// kernel C2's prediction. The tournament then compares intra (that SSE +
// lambda * 8), merge and SS, writes the chosen prediction over the intra
// one in place, and the inter flag, the MV, the mode that picks kernel C3's
// scan (0 for inter: the diagonal scan) and the three costs.
//
// PSS form (ref not null; L0 = [previous picture, SS], the SS reference at
// index 1): a merge candidate that names the temporal reference is
// predicted from the previous picture and needs no causal test; the
// temporal chain refines C9's temporal result over the previous picture
// with the temporal predictors; the tournament takes the lower of the SS
// and temporal costs as the inter cost (the SS arm wins only when strictly
// lower, as in the reference), and writes the four costs and the
// reference index too.
//
// Floats: each SSE is the reference's float32 sum (ss_common.cuh
// block_sum's order). The terms are exact integers, so when their integer
// total stays below 2^24 every partial sum is exact and the total is that
// sum: the warp adds in integers and takes block_sum's order only above
// 2^24 (a lane a row, the rows folded by shuffles in fold_rows' order).
//
// Motion entry, one thread per 4x4 cell of a launch's blocks: writes each
// block's MV (zero for intra) and inter flag into mvx4, mvy4 and pi4 (on a
// PSS picture its reference index into rf4, zero for intra), after the
// arms entry of every block of the level has read them.
//
// Bound: integer operations: 25 MCs (41 in the PSS form) of (n+7) n 8-tap
// and n^2 8-tap multiply-adds each against n^2 + (n+7)^2 samples. The
// design keeps the block, nine candidates' predictions and the windows in
// shared memory (int16 samples); the chains' stages are its serial part:
// two rounds of the merge, two stages of each refinement.
#include "inter_arms.cuh"

namespace {

constexpr int kThreads = kArmsThreads;

__global__ void inter_arms_kernel(Arms a, const int32_t *pos,
                                  const int32_t *zcur) {
  extern __shared__ int32_t sm[];
  const int b = blockIdx.x;
  inter_arms_block(a, b, pos[2 * b], pos[2 * b + 1], zcur[b], sm);
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
  motion_cell(mvx4, mvy4, pi4, rf4, wp, y, x, inter[b] != 0, mv[2 * b],
              mv[2 * b + 1], rf4 != nullptr ? refsel[b] : 0);
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
// refsel [B] int32 out. ref null: the ISS form. Scratch: rpred [B, n, n]
// and rmv [B, 2] int32, and on PSS tpred and tmv alike (the refinement
// chains' results). n is 8, 16 or 32.
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
    void *rpred, void *tpred, void *rmv, void *tmv, void *stream) {
  if (n != 8 && n != 16 && n != 32) return (int)cudaErrorInvalidValue;
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
  a.rpred = static_cast<int32_t *>(rpred);
  a.tpred = static_cast<int32_t *>(tpred);
  a.rmv = static_cast<int32_t *>(rmv);
  a.tmv = static_cast<int32_t *>(tmv);
  // raised always: the static shared memory counts against 48 KB too
  const size_t smem = arms_smem_bytes(n);
  const cudaError_t e =
      cudaFuncSetAttribute((const void *)inter_arms_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
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
