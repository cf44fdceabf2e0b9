// Kernel C12: the GT corner search of the ISS and PSS tournaments, and the
// GT decision.
//
// Replaces hevc_hop_tpu/models/ss_scan.py _gt_search, _gt_arm (search
// entry, hh_gt_search), and the GT branch of scan_encode_iss's and
// scan_encode_pss's steps with gt_chroma_safe (decide entry,
// hh_gt_decide).
//
// The device code is in gt_search.cuh (gt_search_block, gt_decide_block),
// which kernel C14 (ss_scan.cu) runs too, the two anchors of a block one
// after the other.
//
// Search entry, one CTA per (block, anchor). Anchor 0 is kernel C9's ring
// (the least-cost displacement whose 2n window is causal); anchor 1 is the
// block's first SS AMVP predictor (ss_common.cuh gather_cands, read before
// the level's motion write), rounded to full pel, when it is valid, causal and
// not anchor 0 again. A CTA whose anchor is not causal writes a cost of
// 3e38 and stops. Otherwise it stages the clamped [2n, 2n] recon window
// around the anchor and the block's original in shared memory, and runs the
// reference's diamond search: the identity corners, then six iterations of
// 13 corner sets (keep; each coded corner moved by +-s on one axis; s from
// n/2 halving to 1). The body takes n as a template parameter (8, 16, 32),
// so warp.cuh warp_sample divides by compile-time constants. Per
// iteration, 13 threads of warp 0 compute the sets' corners, warp geometry
// and bits once into shared memory; then each thread takes a sample
// position of every set (at 8x8 a quarter of the sets, the CTA in four
// groups), so its 13 independent warps interleave, and sums their squared
// errors in integers (exact); per set a warp-shuffle sum and one shared
// atomic per warp, and the knife flags an OR. Warp 0 then costs the sets on
// 13 lanes, fma(bits, lambda, SSE) or 1e30 where the warp is not safe,
// takes the least (cost, index) by shuffles (the first among equals),
// keeps it when strictly below the best so far, and computes the next
// iteration's sets.
// No candidate's prediction is kept: the best set's is warped once more at
// the end. The CTA writes the best corners, prediction and total cost:
// (cost + ring rate) + lambda for anchor 0, fma(6 + MVD bits, lambda,
// cost) + lambda for anchor 1.
//
// Decide entry, one CTA per block: every warp loads the block's 23 (PSS:
// 24) words in one round of L2 loads, a word a lane, and takes them from
// its lanes by shuffles (gt_search.cuh gt_pick; no shared memory, no
// barrier): the cheaper anchor (the first among equals); where its cost
// beats kernel C10's intra, merge and SS costs and its corners are not all
// zero, the block is a candidate, and only a candidate runs the chroma
// check (gt_chroma_check): the chroma warp of both
// planes (cb and cr as they stand before the level's chroma recon:
// warp.cuh gt_chroma_pair, both planes interpolated at phase 0 or 4 and
// warped in half pel in one pass) must be safe. Then the GT flag is set
// and C10's choice overridden in place: the prediction, inter = 1, MV =
// anchor * 4, the diagonal scan (mode 0); lanes of warp 0 write the
// words. PSS form (refsel not null): the GT cost must also beat C10's
// temporal cost, and the reference index of a GT block is the SS one.
//
// Floats: each SSE is the reference's float32 sum where that is exact
// (below 2^24); above it, ss_common.cuh block_sum's order (a thread a row,
// the rows folded in one), which is not the compiled reference's
// (ROADMAP.md F9: 32x32 blocks so far from their prediction, or 10-bit
// samples).
//
// Bound: int32 operations: 79 warps of n^2 samples per (block, anchor),
// about 30 operations each, against a window of 4 n^2 and a block of n^2
// samples read once. The CTA keeps the window and the block in shared
// memory (5 n^2 words, 20 KB at 32x32); a level's tens of CTAs leave most
// of the card's 132 SMs idle.
#include "gt_search.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void gt_search_kernel(GtSearch a) {
  extern __shared__ int32_t sm[];
  gt_search_block(a, blockIdx.x, blockIdx.y, sm);
}

__global__ void gt_decide_kernel(GtDecide a) {
  extern __shared__ int32_t sm[];
  gt_decide_block(a, blockIdx.x, sm);
}

// The kernel's dynamic shared memory raised to smem (always: its static
// shared memory counts against the default 48 KB too)
int raise_smem(const void *kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// Search entry. recon/org int32 planes (row stride); pos [B, 2], zcur [B],
// zmax2n [h-2n+1, w-2n+1] int32; the motion planes [hp, wp] int32; nbav
// [B, 5], miav [B, 3] bool; C9's ring: anchor [B, 2] int32, gt_rate [B]
// float32, gt_ok [B] bool; n 8, 16 or 32. Out per (block, anchor): s_gtc
// [B, 2, 6], s_pred [B, 2, n, n], s_amv [B, 2, 2], s_ok [B, 2] int32,
// s_cost [B, 2]
// float32.
HH_EXPORT int hh_gt_search(
    const void *recon, const void *org, int stride, const void *pos,
    const void *zcur, const void *zmax2n, const void *mvx4, const void *mvy4,
    const void *pi4, const void *rf4, int hp, int wp, const void *nbav,
    const void *miav, const void *anchor, const void *gt_rate,
    const void *gt_ok, int b, int n, int w, int h, int bit_depth,
    int mi_size, int ss_idx, float lam, void *s_gtc, void *s_pred,
    void *s_cost,
    void *s_amv, void *s_ok, void *stream) {
  if (n != 8 && n != 16 && n != 32) return (int)cudaErrorInvalidValue;
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
  a.ss_idx = ss_idx;
  a.lam = lam;
  a.s_gtc = static_cast<int32_t *>(s_gtc);
  a.s_pred = static_cast<int32_t *>(s_pred);
  a.s_cost = static_cast<float *>(s_cost);
  a.s_amv = static_cast<int32_t *>(s_amv);
  a.s_ok = static_cast<int32_t *>(s_ok);
  const size_t smem = sizeof(int32_t) * gt_search_words(n);
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
// int32. Out: flag [B], gtc [B, 6] int32. PSS form: costs [B, 4] (the
// temporal cost last) and refsel [B] int32, set to ss_idx where GT wins;
// refsel null: the ISS form, costs [B, 3].
HH_EXPORT int hh_gt_decide(const void *rc, int pw, int stride, int b, int n,
                           int hc, int hc_off, int bit_depth, const void *pos,
                           const void *s_gtc, const void *s_pred,
                           const void *s_cost, const void *s_amv,
                           const void *s_ok, const void *costs, void *pred,
                           void *inter, void *mv, void *smode, void *flag,
                           void *gtc, void *refsel, int ss_idx,
                           void *stream) {
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
  a.refsel = static_cast<int32_t *>(refsel);
  a.ss_idx = ss_idx;
  const size_t smem = sizeof(int32_t) * gt_decide_words(n);
  gt_decide_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a);
  return (int)cudaGetLastError();
}
