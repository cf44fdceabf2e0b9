// Kernel C14: the lenslet ISS or PSS wavefront of one picture, encode and
// decode, as one cooperative launch per picture.
//
// Replaces hevc_hop_tpu/models/ss_scan.py scan_encode_iss (one
// jax.lax.scan over the levels, :714), scan_decode_ss (:1060),
// scan_encode_pss (:879, its scan at :1052) and scan_decode_pss (:1124,
// its scan at :1186), which the port ran as a Python loop launching, per
// level and CU size, kernels C2, C9, C10, C12, C3, C10's motion write, C2,
// C8, C11 and C3 again (encode) or C2, C8 and C11 (decode)
// (models/ss_scan.py scan_encode_iss_loop, scan_decode_ss_loop,
// scan_encode_pss_loop and scan_decode_pss_loop, which stay the plain
// version).
//
// The work list (models/ss_scan.py ss_work_list) holds one group per
// (level, CU size) in the reference's order (the sizes of a level one
// after another, smallest first), each group's CUs packed: items[i] =
// (log2, row of the CU in its size's plan, cb row, cr row of cpos), groups
// [g] = (first item, items, items of its first part: the decoder's intra
// CUs). A persistent grid strides over a phase's items; cooperative_groups'
// grid sync separates the phases. The encode launches in clusters of
// kClusterCtas CTAs (cudaLaunchKernelEx, cooperative and with a cluster
// dimension, as many clusters as are co-resident up to the widest group):
// a cluster per CU in the read phase, a CTA per CU and plane in the write
// phase. The decode launches one CTA per CU.
//
// Encode, two phases per group, as the reference's step orders its reads
// and writes (ss_scan.py:745-869: every decision reads the luma recon and
// the motion planes, then ry and the motion planes are written; chroma is
// predicted from rc, then rc is written):
// - read phase, one cluster per CU: luma intra (intra.cuh: RMD against
//   the original, or the given mode) on one CTA beside C9's search with
//   the GT anchor ring (ss_search.cuh) split over the others (on a PSS
//   picture the temporal search on CTAs of its own beside the SS one);
//   after a cluster sync the leader merges the SS parts (and another CTA
//   the temporal ones) through distributed shared memory; after another,
//   C10's three chains (inter_arms.cuh: the merge arms on the leader, the
//   SS refinement, and on PSS the temporal one, each on a CTA of its own)
//   beside C12's two anchors on two other CTAs (gt_search.cuh: anchor 1
//   reads nothing that anchor 0 writes); after a third, C10's tournament,
//   C12's decision and the chroma prediction of cb and cr from rc and the
//   CU's own decision on the leader (leader_tail, decide_chroma): the
//   decision in registers on every warp, and only for a GT candidate its
//   chroma check, which warps cb and cr in one pass (warp.cuh
//   gt_chroma_pair) and keeps them as a GT CU's chroma; C8's MC of cb and
//   cr in one pass for another inter CU (interp.cuh mc_pair), C2's DM
//   intra otherwise. The
//   predictions go to device scratch, the decisions straight into their
//   packed output slots; what one CTA of the cluster writes for another
//   crosses in global memory, ordered by the cluster syncs;
// - write phase, one CTA per CU and plane: C3 (tq.cuh, the RDOQ arm of
//   C7 where asked) on the luma prediction (a GT CU's from C12's slot)
//   into ry and coef_y with C10's motion write into the 4x4 motion planes;
//   C3 on cb, and on cr, into rc and coef_c.
// No read phase writes a plane that a read phase reads (ry, rc and the
// motion planes are written in write phases only), and a write phase reads
// only the original and its own CU's scratch, so the items of a phase may
// run in any order; the syncs order every write before the reads of later
// groups.
//
// Decode, one phase per group: each CU's prediction plus its dense
// residual written into the recon, luma, cb and cr: C2's add-residual form
// for an intra CU; for an inter CU its three planes in one pass, their
// windows staged behind one barrier and the planes on disjoint warps:
// C11's (warp.cuh gt_cu) for a GT CU, C8's (interp.cuh mc_cu) for
// another. The
// reference predicts a whole group from the recon before writing any of
// it; here a CU writes at once. That is the same result because the
// decoder's schedule (build_schedule_ss with each inter CU's dependency
// rectangle: its MC window with the filter margin, a GT CU's 2n window with
// its slack) puts every block that a CU's prediction reads (its intra
// neighbours, its MC or GT window) at an earlier level than the CU, so no
// CU reads samples that another CU of its group writes
// (tests/test_torch_ss_scan_program.py holds this on every case). The loop
// ran a GT CU through C8 and then C11; C11 overwrites all of it, so the
// CU runs C11 alone.
// Stage clocks in the decode (the clock build): per group a CTA's ns in
// intra CUs and in inter CUs (DecStamp).
//
// Coherence: the recon planes and the motion planes are read after grid
// syncs with L2-coherent loads (__ldcg) in every body (intra.cuh's chain,
// ss_search.cuh's window, ss_common.cuh's candidate gather, interp.cuh's
// and warp.cuh's windows, gt_search.cuh's window), never through L1 or the
// read-only path; a write phase reads its CU's scratch so too. Scratch
// written and read within one phase is the same cluster's: the same CTA's
// (barriers order it) or another CTA's of the cluster (a cluster sync,
// release and acquire at cluster scope, orders it). Every CTA reaches
// every sync.
//
// PSS form (a previous picture given; L0 = [previous picture, SS], the SS
// reference at index 1; its own instantiation, ss_scan_pss_encode_kernel
// and ss_scan_pss_decode_kernel, so that the ISS form's registers and
// shared bytes stay its own). The read phase runs C9's temporal search
// over the previous picture with radius radius_t beside the SS search, on
// the cluster's CTAs ss_parts leaves it; both searches take F10's
// sequential sums (Search::seq) above 2^24, as C9's PSS launches do. C10 runs its PSS tournament (merge candidates read the
// plane their reference index names), C12 its PSS decision (GT must beat
// the temporal cost too, and sets the reference index to the SS one), and
// the chroma prediction of an inter CU reads rc where its reference index
// is the SS one and the previous picture otherwise. The write phase writes
// the reference index into rf4 beside the MV. The previous picture is
// never written during the launch. In the decode a temporal CU (tflag) runs
// C8's add-residual form from the previous picture; it reads no recon
// sample, so the decoder's schedule gives it no dependency rectangle and
// the one-phase argument above holds as it stands; the priority is GT,
// then SS, then temporal, then intra, as in the reference
// (ss_scan.py:1151-1154).
//
// Integers and floats equal C2's, C3's, C7's, C8's, C9's, C10's, C11's and
// C12's: the CTA runs their device functions with the same blockDim
// (kThreads = 256, theirs); no float sum of theirs depends on blockDim or
// on a grid dimension (C9's per-displacement sums run in one thread, its
// reductions and the merge of its parts keep the first index among
// equals; C10's and C12's SSEs are integer sums below 2^24 and
// block_sum's order above, their argmins keep the first index among
// equals; C3's and C7's float sums are in one thread); C12's (block,
// anchor) pairs run on two CTAs, as C12's own entry runs them, and C10's
// chains on three where its entry runs them in turn on one.
//
// Bound: the chain of groups. A group holds a few tens of CUs on 132 SMs,
// and one cluster's latency per CU sets the picture's time: the longer of
// the intra (an RMD) and a part of the search, the longest of C10's
// chains (two rounds of a candidate per warp) and a GT diamond search (7
// iterations of up to 13 warps of n^2 samples), two chroma blocks, then
// C3 with RDOQ in the write phase. The design removes the host from the
// chain (one launch instead of some 4000 per ISS encode and some 1900 per
// PSS one) and spreads each CU's read phase over a cluster's SMs.
#include <cooperative_groups.h>

#include "gt_search.cuh"
#include "inter_arms.cuh"
#include "intra.cuh"
#include "ss_search.cuh"
#include "tq.cuh"

namespace {

constexpr int kThreads = 256;
static_assert(kThreads == kSearchThreads && kThreads == kArmsThreads &&
                  kThreads == kTqThreads,
              "the bodies' reductions are sized for kThreads");

// Stage clocks, only in the library built with -DHH_STAGE_CLOCK (the
// stage-clock phase of chip_smoke.py): thread 0 of each CTA writes
// %globaltimer (ns, one clock for every SM) when the CTA's threads have
// left a stage (a barrier first), into clk[(group * ctas + CTA) * kStamps
// + stage]; at the start it also writes its SM's index + 1 into slot
// kStampSm. A stage a CTA does not run stays 0. The write phase's C3
// stages (common.cuh Mark: forward transform, quantizer, SBH, recon) are
// durations instead: slot kStampTqMark + k sums the ns that the CTA's
// write tasks of the group spent in stage k (TqMark). The production
// library has no stamps.
enum Stamp {
  kStampStart, kStampIntra, kStampSs, kStampTemporal, kStampCluster1,
  kStampMerge, kStampCluster2, kStampArms, kStampAnchor0, kStampAnchor1,
  kStampCluster3, kStampDecide, kStampChroma, kStampSync1, kStampWrite,
  kStampSync2,
  // the bodies' own stages (inter_arms.cuh ArmsMark, gt_search.cuh GtMark)
  kStampArmsMark, kStampGtMark = kStampArmsMark + kArmsMarks,
  kStampTqMark = kStampGtMark + kGtMarks,   // the write phase's C3, ns
  kStampSm = kStampTqMark + kMarks,   // the CTA's SM + 1, not a time
  kStamps
};
#ifdef HH_STAGE_CLOCK
__device__ long long *g_clk;
__device__ int g_clk_ctas;
__device__ __forceinline__ void stamp(int g, int k) {
  __syncthreads();
  if (threadIdx.x == 0 && g_clk != nullptr && (int)blockIdx.x < g_clk_ctas) {
    long long *row =
        g_clk + ((long long)g * g_clk_ctas + blockIdx.x) * kStamps;
    row[k] = clock_ns();
    if (k == kStampStart) row[kStampSm] = clock_sm() + 1;
  }
}
// The decode's stamps in the same buffer: the group's start in slot
// kStampStart and the CTA's SM in kStampSm as above; the ns that the CTA's
// intra CUs and its inter CUs (MC and GT) of the group took, summed into
// kDecIntra and kDecInter (stamp_add); its way out of the grid sync in
// kDecSync.
enum DecStamp { kDecIntra = 1, kDecInter = 2, kDecSync = 3 };
__device__ __forceinline__ long long clock_now() { return clock_ns(); }
__device__ __forceinline__ void stamp_add(int g, int k, long long &last) {
  __syncthreads();
  if (threadIdx.x == 0 && g_clk != nullptr && (int)blockIdx.x < g_clk_ctas) {
    const long long t = clock_ns();
    g_clk[((long long)g * g_clk_ctas + blockIdx.x) * kStamps + k] += t - last;
    last = t;
  }
}
#else
__device__ __forceinline__ void stamp(int, int) {}
enum DecStamp { kDecIntra = 1, kDecInter = 2, kDecSync = 3 };
__device__ __forceinline__ long long clock_now() { return 0; }
__device__ __forceinline__ void stamp_add(int, int, long long &) {}
#endif

// A body's stage hook (common.cuh Mark): stamps slot base + k of group g
struct StampMark {
  int g, base;
  __device__ __forceinline__ void operator()(int k) const {
    stamp(g, base + k);
  }
};

// C3's stage hook in a write task of group g (tq_mark): in the clock
// build thread 0 adds the ns since the task's previous mark (its
// construction first) to slot kStampTqMark + k (a barrier first), so that a
// CTA's write tasks of one group sum; else NoMark, the body C3's entry runs.
#ifdef HH_STAGE_CLOCK
struct TqMark {
  int g;
  mutable long long last;
  __device__ explicit TqMark(int g_) : g(g_), last(clock_ns()) {}
  __device__ void operator()(int k) const {
    __syncthreads();
    if (threadIdx.x == 0 && g_clk != nullptr &&
        (int)blockIdx.x < g_clk_ctas) {
      const long long t = clock_ns();
      g_clk[((long long)g * g_clk_ctas + blockIdx.x) * kStamps +
            kStampTqMark + k] += t - last;
      last = t;
    }
  }
};
__device__ __forceinline__ TqMark tq_mark(int g) { return TqMark(g); }
#else
__device__ __forceinline__ NoMark tq_mark(int) { return NoMark(); }
#endif

// One TU class: C2's tables and C3's class (models/wavefront_scan.py
// _ClassArgs, as kernel C13 takes them).
struct ClassArgs {
  Tables t;
  TqClass tq;
};

// One CU size's packed plan (models/ss_scan.py SSPlan), its scratch and
// its outputs, as the wrapper hands them over. Mirrored by ctypes in
// models/ss_scan.py.
struct SsSizeIn {
  const int32_t *pos, *cpos, *zcur, *zmaxw, *zmax2n;
  const uint8_t *avail, *cavail, *nbav, *miav;
  const int32_t *modes;   // encode: given luma modes or null; decode: modes
  const int32_t *cmodes, *mvs, *gtf, *gtv;   // decode
  // encode scratch: C2's luma prediction (the chosen one after C10 and
  // C12), C9's results and ring, C10's scan mode and costs, C12's per
  // (block, anchor) results, the chroma predictions [2T, m, m]
  int32_t *ipred, *pred0, *mv_i;
  float *cost, *sse;
  int32_t *anchor;
  float *gt_rate;
  uint8_t *gt_ok;
  int32_t *smode;
  float *costs;
  int32_t *s_gtc, *s_pred;
  float *s_cost;
  int32_t *s_amv, *s_ok, *cpred;
  // encode outputs
  int32_t *inter, *mv, *imode, *cbf_y, *cbf_cb, *cbf_cr, *gtflag, *gtc;
  // PSS: C9's temporal search (encode scratch), C10's reference index
  // (encode output), each CU's temporal flag (decode)
  int32_t *mv_t, *tpred0;
  float *tsse0, *tcost;
  int32_t *refsel;
  const int32_t *tflag;
  ClassArgs ly, lc;   // luma n and chroma n / 2
};

struct SsScanIn {
  const int32_t *items, *groups;
  int ngroups;
  int32_t *ry, *rc;
  int y_rows, c_rows, w, wc, stride_y, stride_c;
  const int32_t *src_y, *src_c;   // the originals (encode), residuals
  int16_t *coef_y, *coef_c;
  int32_t *mvx4, *mvy4, *pi4, *rf4;
  int hp, wp;
  int h, bit_depth, strong, radius, mi_size;
  float lam, lam_i, mrate[9];
  // PSS: the previous picture (luma with the recon's row stride and h rows,
  // stacked chroma in rc's layout), null on an ISS picture; the temporal
  // search's radius
  const int32_t *ref_y, *ref_c;
  int radius_t;
  SsSizeIn size[3];   // log2 - 3
};

// What a CTA reads per CU size, built once per launch on the host.
struct SizeK {
  int n;
  const int32_t *pos, *cpos, *zcur;
  const uint8_t *avail, *cavail, *nbav, *miav;
  const int32_t *modes, *cmodes, *mvs, *gtf, *gtv;
  int32_t *ipred, *cpred, *smode, *inter, *mv, *imode, *gtflag, *gtc;
  int32_t *cbf_y, *cbf_cb, *cbf_cr;
  Search search;
  Found found;
  int32_t *anchor;
  float *gt_rate;
  uint8_t *gt_ok;
  Arms arms;
  GtSearch gts;
  GtDecide gtd;
  int gt;
  // PSS: the temporal search, C10's reference index, the decode's flags
  Search tsearch;
  Found tfound;
  int32_t *refsel;
  const int32_t *tflag;
  int nss;   // the SS search's parts (CTAs) of a cluster
  ClassArgs ly, lc;
};

struct ScanK {
  const int32_t *items, *groups;
  int ngroups;
  IntraPlane y, c;
  TqPlanes ty, tc;
  Motion m;
  int32_t *mvx4, *mvy4, *pi4, *rf4;
  int wp;
  Src ysrc, csrc;
  Src rysrc, rcsrc;   // PSS: the previous picture
  int32_t *ry, *rc;
  const int32_t *resi_y, *resi_c;
  int stride_y, stride_c;
  int h, hc, hc_off, bit_depth, strong, mi_size;
  SizeK size[3];
};

// The roles of a CU's cluster in the read phase: ranks [0, nss) search
// parts of C9's SS displacements, ranks [nss, kIntraRank) parts of its
// temporal ones (PSS), kIntraRank runs the intra; rank 0 merges the SS
// parts, rank nss the temporal ones. Then C10's three chains side by side:
// rank 0 the merge arms, kSsArmsRank the SS refinement, kTArmsRank the
// temporal one (PSS), beside C12's anchor an on kAnchorRank + an. Then
// rank 0 runs C10's tournament, C12's decision and the chroma.
constexpr int kIntraRank = kClusterCtas - 1, kAnchorRank = 1;
constexpr int kSsArmsRank = kAnchorRank + 2, kTArmsRank = kSsArmsRank + 1;
static_assert(kTArmsRank < kIntraRank, "the chains' and anchors' CTAs");

// The rest of the leader's steps of CU item w after the decision's pick
// p, a call of its own inside leader_tail (its windows' registers stay out
// of the tail's: inlined there, the encode kernels spilled up to 68 bytes,
// PERF.md §6), made only by a GT candidate or an inter CU:
// for a candidate C12's chroma check, which warps cb and cr in one pass
// into the CU's chroma slots, and the decision's outputs; then, for an
// inter CU that GT did not take, C8's MC of cb and cr in one pass from rc
// (a temporal CU's from the previous picture). Returns whether the CU's
// chroma is predicted. No barrier at the end: the leader's next write to
// sm is behind one (the next CU's search part opens with a CTA-wide vote,
// the write phase with the grid sync).
template <bool kPss>
__device__ __noinline__ bool decide_tail(const ScanK &a, const int32_t *w,
                                         int g, int32_t *sm, GtPick p) {
  const int row = w[1];
  const SizeK &z = a.size[w[0] - 3];
  const int m = z.n / 2, mm = m * m;
  int32_t *ocb = z.cpred + (long long)w[2] * mm;
  int32_t *ocr = z.cpred + (long long)w[3] * mm;
  if (p.cand) {
    int vx, vy;
    gt_anchor(z.gtd, row, p.ai, vx, vy);
    const int safe = !gt_chroma_check(z.gtd, row, p.ai, vx, vy, sm, ocb, ocr);
    gt_decide_put(z.gtd, row, p.corner, safe, vx, vy);
    stamp(g, kStampDecide);
    // a GT CU's cb and cr: warped by the check
    if (safe) return true;
    if (!z.inter[row]) return false;
  }
  const int bx = z.cpos[2 * w[2]], by = z.cpos[2 * w[2] + 1];
  const int rx = z.cpos[2 * w[3]], ry = z.cpos[2 * w[3] + 1];
  // an SS CU reads the recon, a temporal one the previous picture
  const Src &cs = !kPss || z.refsel[row] == 1 ? a.csrc : a.rcsrc;
  const int mvx = z.mv[2 * row], mvy = z.mv[2 * row + 1];
  const McJob jb{picture_rows(cs, 1, a.hc_off, a.hc, by), bx, by, mvx, mvy};
  const McJob jr{picture_rows(cs, 1, a.hc_off, a.hc, ry), rx, ry, mvx, mvy};
  if (m == 4)
    mc_pair<4>(jb, jr, a.bit_depth, sm, PutPred{ocb, m}, PutPred{ocr, m});
  else if (m == 8)
    mc_pair<8>(jb, jr, a.bit_depth, sm, PutPred{ocb, m}, PutPred{ocr, m});
  else
    mc_pair<16>(jb, jr, a.bit_depth, sm, PutPred{ocb, m}, PutPred{ocr, m});
  return true;
}

// The leader's steps of the read phase of CU item w after C10's
// tournament: C12's decision, its pick in registers on every warp
// (gt_search.cuh gt_pick: no shared memory, no barrier) and, for a CU that
// is no GT candidate, its outputs; then decide_tail, a call, for a GT
// candidate or an inter CU. Returns whether the CU's chroma is predicted
// (an intra CU's is not: unless GT was its candidate, it makes no call).
// The tournament's outputs (inter, mv, refsel) are read after its closing
// barrier.
template <bool kPss>
__device__ __forceinline__ bool decide_chroma(const ScanK &a,
                                              const int32_t *w, int g,
                                              int32_t *sm) {
  const int row = w[1];
  const SizeK &z = a.size[w[0] - 3];
  GtPick p{0, 0, 0};
  if (z.gt) {
    p = gt_pick(z.gtd, row);
    if (!p.cand) {
      gt_decide_put(z.gtd, row, p.corner, 0, 0, 0);
      stamp(g, kStampDecide);
    }
  } else {
    if (threadIdx.x < 6) z.gtc[6 * row + threadIdx.x] = 0;
    if (threadIdx.x == 6) z.gtflag[row] = 0;
  }
  return (p.cand || z.inter[row]) && decide_tail<kPss>(a, w, g, sm, p);
}

// The leader's steps of CU item w after C10's tournament: C12's decision
// (decide_chroma) and the chroma prediction, C2's DM intra for an intra
// CU. A call of its own: with these bodies inline in the read phase, the
// encode kernels spilled 16 to 36 bytes at their 128 registers; as a call,
// no more than the parent's (PERF.md §6). The tournament stays
// outside: inside the call it cost about 0.4 us a group. The DM intra
// stays inside: inline after a call of the decision, as the parent had it
// (also with that call made only on a size with GT or by an inter CU),
// the new decision spilled 20 to 40 bytes; as a call of its own, an intra
// CU's chroma stage took 0.8 us longer on iss-gt (PERF.md §6).
template <bool kPss>
__device__ __noinline__ void leader_tail(const ScanK &a, const int32_t *w,
                                         int g, int32_t *sm) {
  const int row = w[1];
  const SizeK &z = a.size[w[0] - 3];
  if (!decide_chroma<kPss>(a, w, g, sm)) {
    // an intra CU: C2's DM intra of cb and cr
    const int m = z.n / 2, mm = m * m, imode = __ldcg(z.imode + row);
    for (int k = 2; k <= 3; ++k)
      intra_block(a.c, z.lc.t, z.cpos[2 * w[k]], z.cpos[2 * w[k] + 1],
                  z.cavail + (long long)row * (4 * m + 1), imode, m, 1,
                  a.bit_depth, a.strong, sm, z.cpred + (long long)w[k] * mm);
  }
  stamp(g, kStampChroma);
}

// The read phase of CU item w on its cluster: every decision and
// prediction into scratch and the packed outputs (see the roles above).
// Three cluster syncs: after the intra and the search parts, after the
// merges, after C10's chains and C12's anchors. Data that one CTA of the
// cluster writes and another reads crosses in global memory, ordered by
// the cluster syncs (release and acquire at cluster scope).
template <bool kPss>
__device__ void encode_read(const ScanK &a, const int32_t *w, int g,
                            int32_t *sm) {
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = cl.block_rank();
  const int log2 = w[0], row = w[1];
  const SizeK &z = a.size[log2 - 3];
  const int n = z.n, tid = threadIdx.x;
  const int px = z.pos[2 * row], py = z.pos[2 * row + 1], zc = z.zcur[row];
  const int ss_idx = kPss ? 1 : 0;
  const int nss = z.nss, ntp = kIntraRank - nss;
  const bool temporal = kPss && rank >= nss;   // this CTA's search
  const Search &q = temporal ? z.tsearch : z.search;
  __shared__ Cands c;
  const int *preds = temporal ? &c.tpreds[0][0] : &c.preds[0][0];
  const int npred = temporal ? 3 : 6;
  if (rank == kIntraRank) {
    const int ask = z.modes != nullptr ? z.modes[row] : -1;
    const int imode = intra_block(
        a.y, z.ly.t, px, py, z.avail + (long long)row * (4 * n + 1), ask, n,
        0, a.bit_depth, a.strong, sm, z.ipred + (long long)row * n * n);
    if (tid == 0) z.imode[row] = imode;
    stamp(g, kStampIntra);
  } else {
    const int D = 2 * q.radius + 1;
    int d0, d1;
    part_range(D * D, temporal ? rank - nss : rank, temporal ? ntp : nss, d0,
               d1);
    search_part(q, px, py, temporal ? 0 : zc, preds, npred, d0, d1, sm,
                cluster_part(), [&] {
                  gather_cands(a.m, px, py, n, z.nbav + 5 * row,
                               z.miav + 3 * row, a.mi_size, ss_idx, c);
                });
    stamp(g, temporal ? kStampTemporal : kStampSs);
  }
  cl.sync();
  stamp(g, kStampCluster1);
  if (rank == 0 || (temporal && rank == nss)) {
    const Best best = merge_parts(q, temporal ? nss : 0,
                                  temporal ? ntp : nss, preds, npred);
    write_found(q, row, px, py, best, temporal ? z.tfound : z.found,
                z.anchor, z.gt_rate, z.gt_ok);
    stamp(g, kStampMerge);
  }
  cl.sync();
  stamp(g, kStampCluster2);
  const StampMark arms_mark{g, kStampArmsMark};
  if (rank == 0 || rank == kSsArmsRank || (kPss && rank == kTArmsRank)) {
    if (rank == 0)
      arms_merge(z.arms, row, px, py, zc, sm, arms_mark);
    else
      arms_refine(z.arms, row, px, py, rank == kTArmsRank, sm, arms_mark);
    stamp(g, kStampArms);
  } else if (z.gt && (rank == kAnchorRank || rank == kAnchorRank + 1)) {
    gt_search_block(z.gts, row, rank - kAnchorRank, sm,
                    StampMark{g, kStampGtMark});
    stamp(g, rank == kAnchorRank ? kStampAnchor0 : kStampAnchor1);
  }
  cl.sync();
  stamp(g, kStampCluster3);
  if (rank != 0) return;
  arms_tournament(z.arms, row, sm, arms_mark);
  leader_tail<kPss>(a, w, g, sm);
}

// The write phase of CU item w, one plane a task: plane 0 C3 on luma (a
// GT CU's prediction read from C12's slot of its chosen anchor, which
// C12 left in place) and C10's motion write into the 4x4 motion planes (a
// cell a thread), which no task of the phase reads; plane 1 and 2 C3 on cb
// and cr; from the read phase's scratch. The motion write stays a cell a
// thread after C3 on the luma task: on the cr task, or with vector stores,
// the encode kernels spilled more, and with a cell row a thread the write
// phase took 1.4-4.2 % longer (PERF.md §6).
template <bool kRdoq, bool kPss>
__device__ void encode_write(const ScanK &a, const int32_t *w, int plane,
                             int g, int32_t *sm) {
  const int log2 = w[0], row = w[1];
  const SizeK &z = a.size[log2 - 3];
  const int n = z.n, nn = n * n, m = n / 2, mm = m * m;
  const int tid = threadIdx.x, nt = blockDim.x;
  int32_t *pred = sm;
  const int smode = __ldcg(z.smode + row);
  __syncthreads();   // the CTA's previous task is done with pred
  if (plane == 0) {
    const int px = z.pos[2 * row], py = z.pos[2 * row + 1];
    const int32_t *ip = z.ipred + (long long)row * nn;
    if (z.gt && __ldcg(z.gtflag + row)) {
      const float *sc = z.gtd.s_cost + 2 * row;
      ip = z.gtd.s_pred +
           (2LL * row + gt_cheaper(__ldcg(sc), __ldcg(sc + 1))) * nn;
    }
    for (int i = tid; i < nn; i += nt) pred[i] = __ldcg(ip + i);
    __syncthreads();
    const int cbf = tq_encode_block<kRdoq>(z.ly.tq, a.ty, px, py, smode,
                                           pred, sm + nn, tq_mark(g));
    if (tid == 0) z.cbf_y[row] = cbf;
    // C10's motion write, a cell a thread
    const int on = __ldcg(z.inter + row) != 0;
    const int mvx = __ldcg(z.mv + 2 * row), mvy = __ldcg(z.mv + 2 * row + 1);
    const int ref = kPss ? __ldcg(z.refsel + row) : 0;
    const int u = n / 4;
    for (int cell = tid; cell < u * u; cell += nt)
      motion_cell(a.mvx4, a.mvy4, a.pi4, kPss ? a.rf4 : nullptr, a.wp,
                  py / 4 + cell / u, px / 4 + cell % u, on, mvx, mvy, ref);
    return;
  }
  const int r = w[plane + 1];   // cb's row of cpos, then cr's
  const int32_t *cp = z.cpred + (long long)r * mm;
  for (int i = tid; i < mm; i += nt) pred[i] = __ldcg(cp + i);
  __syncthreads();
  const int cbf_c = tq_encode_block<kRdoq>(z.lc.tq, a.tc, z.cpos[2 * r],
                                           z.cpos[2 * r + 1], smode, pred,
                                           sm + mm, tq_mark(g));
  if (tid == 0) (plane == 1 ? z.cbf_cb : z.cbf_cr)[row] = cbf_c;
}

// Every group of the picture: a read phase, a grid sync, a write phase, a
// grid sync.
template <bool kRdoq, bool kPss>
__device__ __forceinline__ void encode_groups(const ScanK &a, int32_t *sm) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int cluster = blockIdx.x / kClusterCtas;
  const int clusters = gridDim.x / kClusterCtas;
  for (int g = 0; g < a.ngroups; ++g) {
    const int first = a.groups[3 * g], end = first + a.groups[3 * g + 1];
    stamp(g, kStampStart);
    for (int it = first + cluster; it < end; it += clusters)
      encode_read<kPss>(a, a.items + 4LL * it, g, sm);
    grid.sync();
    stamp(g, kStampSync1);
    for (int t = blockIdx.x; t < 3 * (end - first); t += gridDim.x)
      encode_write<kRdoq, kPss>(a, a.items + 4LL * (first + t / 3), t % 3,
                                g, sm);
    stamp(g, kStampWrite);
    if (g + 1 < a.ngroups) grid.sync();
    stamp(g, kStampSync2);
  }
}

template <bool kRdoq>
__global__ void __launch_bounds__(kThreads)
    ss_scan_encode_kernel(const ScanK *ap) {
  extern __shared__ __align__(16) int32_t sm[];
  encode_groups<kRdoq, false>(*ap, sm);
}

template <bool kRdoq>
__global__ void __launch_bounds__(kThreads)
    ss_scan_pss_encode_kernel(const ScanK *ap) {
  extern __shared__ __align__(16) int32_t sm[];
  encode_groups<kRdoq, true>(*ap, sm);
}

// An inter CU of the decode with N x N luma: its three planes' prediction
// plus the residual into the recon in one pass, C11's (gt_cu) for a GT
// CU, C8's (mc_cu) for another.
template <int N, bool kPss>
__device__ __forceinline__ void decode_inter(const ScanK &a, const SizeK &z,
                                             const int32_t *w, int32_t *sm) {
  const int row = w[1], px = z.pos[2 * row], py = z.pos[2 * row + 1];
  const int bx = z.cpos[2 * w[2]], by = z.cpos[2 * w[2] + 1];
  const int rx = z.cpos[2 * w[3]], ry = z.cpos[2 * w[3] + 1];
  const int mvx = z.mvs[2 * row], mvy = z.mvs[2 * row + 1];
  const int maxv = (1 << a.bit_depth) - 1;
  const PutRecon oy{a.resi_y, a.stride_y, a.ry, a.stride_y, px, py, maxv};
  const PutRecon ob{a.resi_c, a.stride_c, a.rc, a.stride_c, bx, by, maxv};
  const PutRecon orr{a.resi_c, a.stride_c, a.rc, a.stride_c, rx, ry, maxv};
  if (z.gtf != nullptr && z.gtf[row] != 0) {
    const int vx = mvx >> 2, vy = mvy >> 2;
    gt_cu<N>(picture_rows(a.ysrc, 0, 0, a.h, py), px, py, vx, vy,
             gt_chroma_job<N / 2>(picture_rows(a.csrc, 1, a.hc_off, a.hc, by),
                                  bx, by, vx, vy),
             gt_chroma_job<N / 2>(picture_rows(a.csrc, 1, a.hc_off, a.hc, ry),
                                  rx, ry, vx, vy),
             z.gtv + 6 * row, a.bit_depth, sm, oy, ob, orr);
    return;
  }
  // a temporal CU (PSS) reads the previous picture, written into the recon
  // (the planes share their row strides)
  const bool temporal = kPss && z.tflag[row] != 0;
  const Src &ys = temporal ? a.rysrc : a.ysrc;
  const Src &cs = temporal ? a.rcsrc : a.csrc;
  mc_cu<N>(McJob{picture_rows(ys, 0, 0, a.h, py), px, py, mvx, mvy},
           McJob{picture_rows(cs, 1, a.hc_off, a.hc, by), bx, by, mvx, mvy},
           McJob{picture_rows(cs, 1, a.hc_off, a.hc, ry), rx, ry, mvx, mvy},
           a.bit_depth, sm, oy, ob, orr);
}

// One CU of the decode: its prediction plus the residual into the recon.
template <bool kPss>
__device__ void decode_item(const ScanK &a, const int32_t *w, bool intra,
                            int32_t *sm) {
  const int log2 = w[0], row = w[1];
  const SizeK &z = a.size[log2 - 3];
  const int n = z.n, m = n / 2;
  const int px = z.pos[2 * row], py = z.pos[2 * row + 1];
  __syncthreads();   // the CTA's previous CU is done with sm
  if (intra) {
    intra_block(a.y, z.ly.t, px, py, z.avail + (long long)row * (4 * n + 1),
                z.modes[row], n, 0, a.bit_depth, a.strong, sm, nullptr);
    for (int k = 2; k <= 3; ++k)
      intra_block(a.c, z.lc.t, z.cpos[2 * w[k]], z.cpos[2 * w[k] + 1],
                  z.cavail + (long long)row * (4 * m + 1), z.cmodes[row], m,
                  1, a.bit_depth, a.strong, sm, nullptr);
  } else if (n == 8) {
    decode_inter<8, kPss>(a, z, w, sm);
  } else if (n == 16) {
    decode_inter<16, kPss>(a, z, w, sm);
  } else {
    decode_inter<32, kPss>(a, z, w, sm);
  }
}

template <bool kPss>
__device__ __forceinline__ void decode_groups(const ScanK &a, int32_t *sm) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int g = 0; g < a.ngroups; ++g) {
    const int first = a.groups[3 * g], end = first + a.groups[3 * g + 1];
    const int intra_end = first + a.groups[3 * g + 2];
    stamp(g, kStampStart);
    long long last = clock_now();
    for (int it = first + blockIdx.x; it < end; it += gridDim.x) {
      decode_item<kPss>(a, a.items + 4LL * it, it < intra_end, sm);
      stamp_add(g, it < intra_end ? kDecIntra : kDecInter, last);
    }
    if (g + 1 < a.ngroups) grid.sync();
    stamp(g, kDecSync);
  }
}

__global__ void __launch_bounds__(kThreads)
    ss_scan_decode_kernel(const ScanK *ap) {
  extern __shared__ __align__(16) int32_t sm[];
  decode_groups<false>(*ap, sm);
}

__global__ void __launch_bounds__(kThreads)
    ss_scan_pss_decode_kernel(const ScanK *ap) {
  extern __shared__ __align__(16) int32_t sm[];
  decode_groups<true>(*ap, sm);
}

size_t max_of(size_t a, size_t b) { return a > b ? a : b; }

// Shared-memory words of the one-pass CU bodies for n x n luma (m x m
// chroma), n 8, 16 or 32
int mc_pair_words_n(int m) {
  return m == 4 ? mc_pair_words<4>()
                : (m == 8 ? mc_pair_words<8>() : mc_pair_words<16>());
}
int mc_cu_words_n(int n) {
  return n == 8 ? mc_cu_words<8>()
                : (n == 16 ? mc_cu_words<16>() : mc_cu_words<32>());
}
int gt_cu_words_n(int n) {
  return n == 8 ? gt_cu_words<8>()
                : (n == 16 ? gt_cu_words<16>() : gt_cu_words<32>());
}

// The SS search's share of a PSS cluster's kIntraRank search CTAs for n x
// n CUs: the split whose busiest CTA has the fewest displacements that
// can be valid. No SS displacement within a radius below n + 4 is causal
// (its window's interpolation margin reaches the CU's own samples), so
// there the SS search keeps one CTA.
int ss_parts(int n, int radius, int radius_t) {
  const int ds = radius < n + 4 ? 0 : (2 * radius + 1) * (2 * radius + 1);
  const int dt = (2 * radius_t + 1) * (2 * radius_t + 1);
  int best = 1, most = 1 << 30;
  for (int p = 1; p < kIntraRank; ++p) {
    const int a = (ds + p - 1) / p, b = (dt + kIntraRank - p - 1) /
                                        (kIntraRank - p);
    const int worst = a > b ? a : b;
    if (worst < most) {
      most = worst;
      best = p;
    }
  }
  return best;
}

// The kernel's view of the wrapper's arguments (the PSS form where a
// previous picture is given); smem <- the dynamic shared bytes the largest
// body of that form needs.
ScanK build(const SsScanIn &in, bool encode, bool rdoq, size_t *smem) {
  const bool pss = in.ref_y != nullptr;
  const int ss_idx = pss ? 1 : 0;
  ScanK k{};
  k.items = in.items;
  k.groups = in.groups;
  k.ngroups = in.ngroups;
  k.ry = in.ry;
  k.rc = in.rc;
  k.stride_y = in.stride_y;
  k.stride_c = in.stride_c;
  k.h = in.h;
  k.hc = in.h / 2;
  k.hc_off = in.c_rows / 2;
  k.bit_depth = in.bit_depth;
  k.strong = in.strong;
  k.mi_size = in.mi_size;
  const int32_t *org_y = encode ? in.src_y : nullptr;
  k.resi_y = encode ? nullptr : in.src_y;
  k.resi_c = encode ? nullptr : in.src_c;
  // C2's planes: the luma chain with the original for RMD, or with the
  // residual for the decode epilogue; chroma DM predicts a given mode
  k.y = IntraPlane{in.ry, in.y_rows, in.w, in.stride_y, org_y, in.stride_y,
                   k.resi_y, in.stride_y};
  k.c = IntraPlane{in.rc, in.c_rows, in.wc, in.stride_c, nullptr, 0,
                   k.resi_c, in.stride_c};
  k.ty = TqPlanes{in.src_y, in.stride_y, in.ry, in.stride_y, in.coef_y,
                  in.stride_y};
  k.tc = TqPlanes{in.src_c, in.stride_c, in.rc, in.stride_c, in.coef_c,
                  in.stride_c};
  k.m = Motion{in.mvx4, in.mvy4, in.pi4, in.rf4, in.hp, in.wp};
  k.mvx4 = in.mvx4;
  k.mvy4 = in.mvy4;
  k.pi4 = in.pi4;
  k.rf4 = in.rf4;
  k.wp = in.wp;
  k.ysrc = Src{in.ry, in.stride_y, 0, in.h - 1, in.w};
  k.csrc = Src{in.rc, in.stride_c, 0, k.hc - 1, in.wc};
  k.rysrc = Src{in.ref_y, in.stride_y, 0, in.h - 1, in.w};
  k.rcsrc = Src{in.ref_c, in.stride_c, 0, k.hc - 1, in.wc};
  size_t words = 0;
  for (int s = 0; s < 3; ++s) {
    const SsSizeIn &z = in.size[s];
    SizeK &o = k.size[s];
    const int n = 8 << s, m = n / 2;
    o.n = n;
    o.pos = z.pos;
    o.cpos = z.cpos;
    o.zcur = z.zcur;
    o.avail = z.avail;
    o.cavail = z.cavail;
    o.nbav = z.nbav;
    o.miav = z.miav;
    o.modes = z.modes;
    o.cmodes = z.cmodes;
    o.mvs = z.mvs;
    o.gtf = z.gtf;
    o.gtv = z.gtv;
    o.ipred = z.ipred;
    o.cpred = z.cpred;
    o.smode = z.smode;
    o.inter = z.inter;
    o.mv = z.mv;
    o.imode = z.imode;
    o.gtflag = z.gtflag;
    o.gtc = z.gtc;
    o.cbf_y = z.cbf_y;
    o.cbf_cb = z.cbf_cb;
    o.cbf_cr = z.cbf_cr;
    o.ly = z.ly;
    o.lc = z.lc;
    o.gt = encode && z.zmax2n != nullptr;
    o.refsel = z.refsel;
    o.tflag = z.tflag;
    o.nss = pss ? ss_parts(n, in.radius, in.radius_t) : kIntraRank;
    if (z.pos == nullptr) continue;   // no CU of this size
    if (encode) {
      o.search = Search{in.ry, in.src_y, in.stride_y, z.zmaxw, n, in.radius,
                        in.w, in.h, in.lam, z.zmax2n, pss ? 1 : 0};
      o.found = Found{z.mv_i, z.pred0, z.cost, z.sse};
      // the temporal search: every displacement in the picture, no ring
      o.tsearch = Search{in.ref_y, in.src_y, in.stride_y, nullptr, n,
                         in.radius_t, in.w, in.h, in.lam, nullptr, 1};
      o.tfound = Found{z.mv_t, z.tpred0, z.tcost, z.tsse0};
      o.anchor = z.anchor;
      o.gt_rate = z.gt_rate;
      o.gt_ok = z.gt_ok;
      Arms &r = o.arms;
      r.recon = Src{in.ry, in.stride_y, 0, in.h - 1, in.w};
      r.ref = Src{in.ref_y, in.stride_y, 0, in.h - 1, in.w};
      r.mv_t = z.mv_t;
      r.tpred0 = z.tpred0;
      r.tsse0 = z.tsse0;
      r.refsel = z.refsel;
      r.org = in.src_y;
      r.zmaxw = z.zmaxw;
      r.m = k.m;
      r.nbav = z.nbav;
      r.miav = z.miav;
      r.mv_i = z.mv_i;
      r.pred0 = z.pred0;
      r.sse0 = z.sse;
      r.ipred = z.ipred;
      r.imode = z.imode;
      r.n = n;
      r.w = in.w;
      r.h = in.h;
      r.bit_depth = in.bit_depth;
      r.mi_size = in.mi_size;
      r.lam = in.lam;
      r.lam_i = in.lam_i;
      for (int i = 0; i < 9; ++i) r.mrate[i] = in.mrate[i];
      r.inter = z.inter;
      r.mv = z.mv;
      r.smode = z.smode;
      r.costs = z.costs;
      // the refinement chains' results in place of C9's (scratch that
      // only the chain's own CTA reads before it writes)
      r.rpred = z.pred0;
      r.tpred = z.tpred0;
      r.rmv = z.mv_i;
      r.tmv = z.mv_t;
      GtSearch &g = o.gts;
      g.recon = in.ry;
      g.org = in.src_y;
      g.stride = in.stride_y;
      g.pos = z.pos;
      g.zcur = z.zcur;
      g.zmax2n = z.zmax2n;
      g.m = k.m;
      g.nbav = z.nbav;
      g.miav = z.miav;
      g.anchor = z.anchor;
      g.gt_rate = z.gt_rate;
      g.gt_ok = z.gt_ok;
      g.n = n;
      g.w = in.w;
      g.h = in.h;
      g.bit_depth = in.bit_depth;
      g.mi_size = in.mi_size;
      g.ss_idx = ss_idx;
      g.lam = in.lam;
      g.s_gtc = z.s_gtc;
      g.s_pred = z.s_pred;
      g.s_cost = z.s_cost;
      g.s_amv = z.s_amv;
      g.s_ok = z.s_ok;
      GtDecide &d = o.gtd;
      d.rc = k.csrc;
      d.hc_off = k.hc_off;
      d.n = n;
      d.bit_depth = in.bit_depth;
      d.pos = z.pos;
      d.s_gtc = z.s_gtc;
      d.s_pred = z.s_pred;
      d.s_cost = z.s_cost;
      d.s_amv = z.s_amv;
      d.s_ok = z.s_ok;
      d.costs = z.costs;
      d.pred = nullptr;   // a GT CU's prediction stays in its slot
      d.inter = z.inter;
      d.mv = z.mv;
      d.smode = z.smode;
      d.flag = z.gtflag;
      d.gtc = z.gtc;
      d.refsel = pss ? z.refsel : nullptr;
      d.ss_idx = ss_idx;
      // read phase: every body in turn; write phase: the prediction in
      // shared memory beside C3's scratch
      words = max_of(words, intra_scratch_words(n));
      words = max_of(words, part_words(n, in.radius, o.nss));
      if (pss)
        words = max_of(words, part_words(n, in.radius_t, kIntraRank - o.nss));
      words = max_of(words, (arms_smem_bytes(n) + 3) / 4);
      if (o.gt) {
        words = max_of(words, gt_search_words(n));
        words = max_of(words, gt_decide_words(n));
      }
      words = max_of(words, intra_scratch_words(m));
      words = max_of(words, mc_pair_words_n(m));
      words = max_of(words, n * n + (tq_scratch_bytes(n, rdoq) + 3) / 4);
      words = max_of(words, m * m + (tq_scratch_bytes(m, rdoq) + 3) / 4);
    } else {
      words = max_of(words, intra_scratch_words(n));
      words = max_of(words, intra_scratch_words(m));
      words = max_of(words, mc_cu_words_n(n));
      if (z.gtf != nullptr) words = max_of(words, gt_cu_words_n(n));
    }
  }
  *smem = sizeof(int32_t) * words;
  return k;
}

// The SS parts of the launch's largest CU size
int largest_nss(const ScanK &k) {
  for (int s = 2; s >= 0; --s)
    if (k.size[s].pos != nullptr) return k.size[s].nss;
  return 0;
}

// The shape of a launch, as info [kInfo] gives it to the wrapper: grid
// CTAs, CTAs per SM, dynamic shared bytes, threads, CTAs per CU in the
// read phase, registers per thread, the intra's rank, the SS search's
// parts, the two anchors' ranks, the SS and the temporal refinement
// chains' ranks (-1 where the launch has no such role)
constexpr int kInfo = 12;

int fill_info(const void *kernel, int grid, int per_sm, size_t smem,
              int per_cu, int nss, int *info) {
  cudaFuncAttributes fa;
  const cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return (int)e;
  const int v[kInfo] = {grid, per_sm, (int)smem, kThreads, per_cu,
                        fa.numRegs, per_cu > 1 ? kIntraRank : -1,
                        per_cu > 1 ? nss : -1,
                        per_cu > 1 ? kAnchorRank : -1,
                        per_cu > 1 ? kAnchorRank + 1 : -1,
                        per_cu > 1 ? kSsArmsRank : -1,
                        per_cu > 1 ? kTArmsRank : -1};
  for (int i = 0; i < kInfo; ++i) info[i] = v[i];
  return 0;
}

// The kernel's dynamic shared memory raised to smem (always: its static
// shared memory counts against the default 48 KB too), the device's SMs,
// its cooperative launch; the CTAs of `kernel` per SM
template <class Kernel>
int prepare(Kernel kernel, size_t smem, int *sms, int *per_sm) {
  cudaError_t e;
  if (smem > 0) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, coop = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  return *per_sm < 1 ? (int)cudaErrorCooperativeLaunchTooLarge : 0;
}

// The decode's cooperative launch of `kernel` over min(co-resident CTAs,
// widest) CTAs, one CTA per CU, with the kernel's arguments copied to
// args_dev; info <- its shape. A grid that cannot be co-resident is an
// error, never a smaller launch.
template <class Kernel>
int launch(Kernel kernel, const ScanK &k, void *args_dev, size_t smem,
           int widest, cudaStream_t st, int *info) {
  int sms = 0, per_sm = 0;
  int err = prepare(kernel, smem, &sms, &per_sm);
  if (err) return err;
  int grid = per_sm * sms < widest ? per_sm * sms : widest;
  if (grid < 1) grid = 1;
  if ((err = fill_info((const void *)kernel, grid, per_sm, smem, 1,
                       largest_nss(k), info)))
    return err;
  // from pageable memory: the copy is staged before the call returns
  cudaError_t e = cudaMemcpyAsync(args_dev, &k, sizeof(ScanK),
                                  cudaMemcpyHostToDevice, st);
  if (e != cudaSuccess) return (int)e;
  const ScanK *ap = static_cast<const ScanK *>(args_dev);
  void *params[] = {&ap};
  e = cudaLaunchCooperativeKernel((const void *)kernel, dim3(grid),
                                  dim3(kThreads), params, smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The encode's launch of `kernel`: cooperative (grid syncs between the
// phases) and in clusters of kClusterCtas CTAs (a cluster per CU in the
// read phase), min(co-resident clusters, widest) clusters, through
// cudaLaunchKernelEx; info <- its shape. A card that refuses either
// attribute, or a grid that cannot be co-resident, is an error, never
// another layout.
template <class Kernel>
int launch_clusters(Kernel kernel, const ScanK &k, void *args_dev,
                    size_t smem, int widest, cudaStream_t st, int *info) {
  int sms = 0, per_sm = 0;
  int err = prepare(kernel, smem, &sms, &per_sm);
  if (err) return err;
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = kClusterCtas;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeCooperative;
  at[1].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kClusterCtas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = at;
  cfg.numAttrs = 2;
  int most = 0;
  cudaError_t e = cudaOccupancyMaxActiveClusters(&most, kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (most < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int clusters = most < widest ? most : (widest > 0 ? widest : 1);
  cfg.gridDim = dim3(clusters * kClusterCtas);
  if ((err = fill_info((const void *)kernel, clusters * kClusterCtas, per_sm,
                       smem, kClusterCtas, largest_nss(k), info)))
    return err;
  e = cudaMemcpyAsync(args_dev, &k, sizeof(ScanK), cudaMemcpyHostToDevice,
                      st);
  if (e != cudaSuccess) return (int)e;
  const ScanK *ap = static_cast<const ScanK *>(args_dev);
  e = cudaLaunchKernelEx(&cfg, kernel, ap);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

#ifdef HH_STAGE_CLOCK
// The stage clocks' buffer: int64 [groups, ctas, kStamps], zero, or null
// to stop; CTAs at or past ctas write nothing.
HH_EXPORT int hh_ss_scan_clock(void *buf, int ctas) {
  cudaError_t e = cudaMemcpyToSymbol(g_clk, &buf, sizeof(buf));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_clk_ctas, &ctas, sizeof(int));
  return (int)e;
}
#endif

// Sizes the wrapper checks its mirror and its device buffer against:
// (sizeof SsScanIn, sizeof of the kernel's argument block, the launch
// info's ints).
HH_EXPORT int hh_ss_scan_sizes(int *out) {
  out[0] = (int)sizeof(SsScanIn);
  out[1] = (int)sizeof(ScanK);
  out[2] = kInfo;
  return 0;
}

// Encode entry: every group of one ISS or PSS picture. args: the SsScanIn,
// mirrored by ctypes in models/ss_scan.py; ry and rc zero on entry, src_y
// and src_c the originals, the motion planes zero; on a PSS picture ref_y
// and ref_c the previous picture and, per size, the temporal search's
// scratch and refsel; args_dev: device bytes for the kernel's arguments
// (hh_ss_scan_sizes); rdoq selects the RDOQ arm; widest: the most items of
// any group; info [kInfo] receives the launch's shape.
HH_EXPORT int hh_ss_scan_encode(const void *args, void *args_dev, int rdoq,
                                int widest, void *stream, int *info) {
  const SsScanIn &in = *static_cast<const SsScanIn *>(args);
  size_t smem = 0;
  const ScanK k = build(in, true, rdoq != 0, &smem);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in.ref_y != nullptr)
    return rdoq ? launch_clusters(ss_scan_pss_encode_kernel<true>, k,
                                  args_dev, smem, widest, st, info)
                : launch_clusters(ss_scan_pss_encode_kernel<false>, k,
                                  args_dev, smem, widest, st, info);
  return rdoq ? launch_clusters(ss_scan_encode_kernel<true>, k, args_dev,
                                smem, widest, st, info)
              : launch_clusters(ss_scan_encode_kernel<false>, k, args_dev,
                                smem, widest, st, info);
}

// Decode entry: every group of one ISS or PSS picture, prediction plus the
// dense residual. ry and rc zero on entry, src_y and src_c the residuals;
// per size modes, cmodes and mvs given, gtf and gtv too where the picture
// has GT CUs (null otherwise); on a PSS picture ref_y and ref_c the
// previous picture and per size tflag.
HH_EXPORT int hh_ss_scan_decode(const void *args, void *args_dev, int widest,
                                void *stream, int *info) {
  const SsScanIn &in = *static_cast<const SsScanIn *>(args);
  size_t smem = 0;
  const ScanK k = build(in, false, false, &smem);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in.ref_y != nullptr)
    return launch(ss_scan_pss_decode_kernel, k, args_dev, smem, widest, st,
                  info);
  return launch(ss_scan_decode_kernel, k, args_dev, smem, widest, st, info);
}
