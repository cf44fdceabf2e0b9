// Kernel C13: the whole-frame intra wavefront, encode and decode, as one
// cooperative launch per frame.
//
// Replaces hevc_hop_tpu/models/wavefront_scan.py scan_encode (one
// jax.lax.scan over the levels, :217) and scan_decode (:322), which the
// port ran as a Python loop launching kernels C2 and C3 once per level and
// TU size (models/wavefront_scan.py scan_encode_loop, which stays the
// plain version and the process mesh's loop), and, in its banded form
// (see scan_encode_kernel), hevc_hop_tpu/parallel/shard_encode.py
// banded_encode_fn (:106, one shard_map over one lax.scan with a ppermute
// of the halo rows after every level) on a virtual mesh.
//
// The work list (models/wavefront_scan.py work_list) holds each non-empty
// level's items, packed: (log2, luma row of the block in its size's plan,
// row of its chroma pair or -1, the cb and cr rows in the stacked chroma
// plane's positions). A persistent grid of CTAs walks a level's work;
// cooperative_groups' grid sync separates the levels. The encode launches
// in clusters of kCluster CTAs (cudaLaunchKernelEx, cooperative and with
// a cluster dimension), the decode without.
// - Given modes (the production and quadtree paths: the partition
//   pre-pass gives every luma mode, and the chroma mode is the given one
//   or the luma's): each item is three tasks, luma, cb and cr, which the
//   CTAs stride over (all luma tasks of the level first), so an item's
//   planes run side by side on three CTAs. A task runs intra_block
//   (intra.cuh: the chain gather and substitution, the given mode) into a
//   shared-memory prediction and tq_encode_block (tq.cuh: residual,
//   forward DCT or DST, dead-zone quant or RDOQ, SBH, the levels into
//   coef_y or coef_c, dequant, inverse transform, the recon into ry or
//   rc), and writes its mode and cbf into their packed slots.
// - RMD (the uniform paths, no mode given): a cluster per item. Every CTA
//   of it gathers the luma chain and scores its share of the 35 modes
//   (intra_block's RMD over [m0, m1)), leaves its lowest (SATD, mode) in
//   its shared memory, and after a cluster sync reads the others' through
//   distributed shared memory: the lowest SATD wins and, among equal
//   ones, the lowest mode, which is what the serial walk over the 35
//   modes with a strict < keeps. Rank 0 then predicts the winning mode
//   from its chain and codes luma; ranks 1 and 2 code cb and cr with it
//   (chroma follows the luma mode), beside it. The slots are double
//   buffered by the cluster's item count, so no second cluster sync is
//   needed per item: a slot is written again only two items later, after
//   every CTA of the cluster has passed the sync that follows its reads.
// - decode: the same three tasks per item, intra_block's add-residual
//   epilogue for luma, cb and cr.
// The prediction, residual and coefficients never leave shared memory.
//
// Coherence: a level reads recon that CTAs on other SMs wrote in earlier
// levels of the same launch, so intra_block reads the planes with
// L2-coherent loads (__ldcg), never through L1 or the read-only path; the
// grid sync orders the writes before the reads. A level's three planes of
// one item write disjoint planes and read only earlier levels' recon
// (chroma reads rc, which no luma task writes), so they need no order
// among themselves. Every CTA reaches every level's sync (an idle CTA
// strides over no task) and, on the RMD path, every cluster sync of its
// cluster (the cluster's CTAs walk the same items). Static shared state of
// rdoq_block and the cbf flag are reused from task to task; each body
// ends with a barrier.
//
// Integers equal C2's and C3's: the CTA runs the same device functions,
// with one blockDim for every size (kThreads); no sum of theirs depends
// on blockDim (integers in any order, per-thread CG walks, XLA's blocked
// float sums with each block on one thread), and every float that SBH and
// RDOQ compare is formed with explicit __fmul_rn / __fadd_rn / __fsub_rn /
// fmaf, so inlining into this kernel adds no contraction.
//
// Bound: the chain of levels. A level holds a few tens of items on 132
// SMs, so one task's latency per level (the luma block's RDOQ arm, or the
// RMD's share of the 35 modes, the merge and the luma coding) sets the
// frame's time; the bytes and operations of the whole frame are far below
// what the card could move in that time. The design removes the host from
// the chain (one launch instead of some 1500), keeps the prediction out
// of device memory, runs the three planes side by side and spreads the
// RMD over a cluster's SMs.
#include <cooperative_groups.h>

#include "intra.cuh"
#include "tq.cuh"

namespace {

constexpr int kThreads = 256;
static_assert(kThreads == kTqThreads, "tq_encode_block's stages are laid "
              "out for its CTA");
// CTAs per cluster: the RMD's parts; ranks 1 and 2 code cb and cr
constexpr int kCluster = 8;
static_assert(kCluster >= 3 && kCluster <= 32, "a warp merges the parts");

// Stage clocks, only in the library built with -DHH_STAGE_CLOCK (the
// stage-clock phase of chip_smoke.py): thread 0 of each CTA adds, per
// level, the %globaltimer nanoseconds (one clock for every SM) that the
// CTA spent in each stage to clk[(level * ctas + CTA) * kClock + slot]
// (a barrier first): slot plane * kMarks + k for the bodies' stages
// (common.cuh Mark: chain, prediction or RMD, forward transform,
// quantizer, SBH, recon),
// kClockCluster for the RMD's merge (its cluster sync and the reads of
// the other CTAs' parts), kClockWait for the wait at the grid sync;
// kClockStart and kClockEnd hold the level's start and the CTA's way out
// of its grid sync. The production library has no clocks.
constexpr int kClockCluster = 3 * kMarks, kClockWait = kClockCluster + 1,
              kClockStart = kClockWait + 1, kClockEnd = kClockWait + 2,
              kClock = kClockWait + 3;
#ifdef HH_STAGE_CLOCK
__device__ long long *g_clk;
__device__ int g_clk_ctas;
struct Clock : StageClock {
  int plane = 0;
  __device__ void operator()(int k) const { add(plane * kMarks + k); }
  __device__ void cluster() const { add(kClockCluster); }
  __device__ void start(int s) {
    const bool on = g_clk != nullptr && (int)blockIdx.x < g_clk_ctas;
    begin(on ? g_clk + ((long long)s * g_clk_ctas + blockIdx.x) * kClock
             : nullptr);
    if (row != nullptr) row[kClockStart] = last;
  }
  __device__ void synced() const {
    if (row != nullptr) {
      const long long t = clock_ns();
      row[kClockWait] += t - last;
      row[kClockEnd] = t;
    }
  }
};
#else
struct Clock : NoMark {
  int plane = 0;
  __device__ void cluster() const {}
  __device__ void start(int) {}
  __device__ void synced() const {}
};
#endif

// One TU class, by plane and size: intra tables and the encode's class.
struct ClassArgs {
  Tables t;
  TqClass tq;
};

// One block size's packed schedule (models/wavefront_scan.py SizePlan)
// and its outputs.
struct SizeArgs {
  const int32_t *pos;      // [T, 2]
  const uint8_t *avail;    // [T, 4n+1]
  const int32_t *cpos;     // [2Tc, 2] stacked chroma plane
  const uint8_t *cavail;   // [Tc, 4nc+1]
  const int32_t *modes_y;  // [T] given luma modes (encode: null for RMD)
  const int32_t *modes_c;  // [Tc] chroma modes (encode: null for "as luma")
  int32_t *best, *cbf_y;   // [T]
  int32_t *cbf_c;          // [2Tc]
};

struct ScanArgs {
  const int32_t *items;      // [N, 5]
  const int32_t *level_off;  // [levels + 1]
  const int32_t *halo;       // [N, 3] or null: see scan_encode_kernel
  int levels;
  IntraPlane y, c;           // recon planes with the originals or residuals
  int16_t *coef_y, *coef_c;  // level planes (encode)
  int coef_y_stride, coef_c_stride;
  int bit_depth, strong, rmd, nmax;
  SizeArgs size[4];          // log2 - 2
  ClassArgs cls[8];          // c_idx * 4 + log2 - 2
};

__device__ __forceinline__ int chroma_log2(int log2) {
  return log2 == 2 ? 2 : log2 - 1;
}

// The banded form's halo write (see scan_encode_kernel): where a.halo
// names a row for plane `plane` (0 luma, 1 cb, 2 cr) of item w, the
// block's bottom row of recon is copied there, by every thread of the CTA
// after tq_encode_block's closing barrier.
__device__ void write_halo(const ScanArgs &a, const int32_t *w, int plane) {
  if (a.halo == nullptr) return;
  const int row = a.halo[3 * ((w - a.items) / 5) + plane];
  if (row < 0) return;
  const int log2 = w[0];
  const SizeArgs &z = a.size[log2 - 2];
  const IntraPlane &p = plane == 0 ? a.y : a.c;
  const int *at = plane == 0 ? z.pos + 2 * w[1] : z.cpos + 2 * w[2 + plane];
  const int n = 1 << (plane == 0 ? log2 : chroma_log2(log2));
  const long long src = (long long)(at[1] + n - 1) * p.stride + at[0];
  const long long dst = (long long)row * p.stride + at[0];
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    p.plane[dst + i] = p.plane[src + i];
}

// The chroma block r (a row of cpos) of the item whose chroma row is crow,
// coded with mode cmode, by every thread of the CTA.
template <bool kRdoq>
__device__ void encode_chroma(const ScanArgs &a, const SizeArgs &z, int log2,
                              int crow, int r, int cmode, int32_t *pred,
                              int32_t *work, const Clock &clk) {
  const int lc2 = chroma_log2(log2), nc = 1 << lc2;
  const ClassArgs &lc = a.cls[4 + lc2 - 2];
  const int cx = z.cpos[2 * r], cy = z.cpos[2 * r + 1];
  intra_block(a.c, lc.t, cx, cy, z.cavail + (long long)crow * (4 * nc + 1),
              cmode, nc, 1, a.bit_depth, a.strong, work, pred, clk);
  const TqPlanes tc{a.c.org, a.c.org_stride, a.c.plane, a.c.stride,
                    a.coef_c, a.coef_c_stride};
  const int cbf_c = tq_encode_block<kRdoq>(lc.tq, tc, cx, cy, cmode, pred,
                                           work, clk);
  if (threadIdx.x == 0) z.cbf_c[r] = cbf_c;
}

// One task of a given-mode item, by every thread of the CTA: plane 0 the
// luma block, 1 cb, 2 cr (none where the item carries no chroma).
template <bool kRdoq>
__device__ void encode_task(const ScanArgs &a, const int32_t *w, int plane,
                            int32_t *pred, int32_t *work, Clock &clk) {
  const int log2 = w[0], row = w[1], crow = w[2];
  const SizeArgs &z = a.size[log2 - 2];
  clk.plane = plane;
  if (plane == 0) {
    const ClassArgs &ly = a.cls[log2 - 2];
    const int n = 1 << log2;
    const int px = z.pos[2 * row], py = z.pos[2 * row + 1];
    const int mode = z.modes_y[row];
    intra_block(a.y, ly.t, px, py, z.avail + (long long)row * (4 * n + 1),
                mode, n, 0, a.bit_depth, a.strong, work, pred, clk);
    const TqPlanes ty{a.y.org, a.y.org_stride, a.y.plane, a.y.stride,
                      a.coef_y, a.coef_y_stride};
    const int cbf = tq_encode_block<kRdoq>(ly.tq, ty, px, py, mode, pred,
                                           work, clk);
    if (threadIdx.x == 0) {
      z.best[row] = mode;
      z.cbf_y[row] = cbf;
    }
    write_halo(a, w, 0);
    return;
  }
  if (crow < 0) return;
  const int cmode = z.modes_c != nullptr ? z.modes_c[crow] : z.modes_y[row];
  encode_chroma<kRdoq>(a, z, log2, crow, w[2 + plane], cmode, pred, work,
                       clk);
  write_halo(a, w, plane);
}

// The RMD item w on its cluster (see the header): the split RMD, the
// merge through distributed shared memory, then luma on rank 0 and cb, cr
// on ranks 1, 2. part: this CTA's (SATD, mode) slots, double buffered by
// the item count `parity`.
template <bool kRdoq>
__device__ void encode_rmd_item(const ScanArgs &a, const int32_t *w,
                                int parity, int32_t (*part)[2],
                                int32_t *pred, int32_t *work, Clock &clk) {
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int log2 = w[0], row = w[1], crow = w[2];
  const SizeArgs &z = a.size[log2 - 2];
  const ClassArgs &ly = a.cls[log2 - 2];
  const int n = 1 << log2;
  const int px = z.pos[2 * row], py = z.pos[2 * row + 1];
  clk.plane = 0;
  const int m0 = rank * 35 / kCluster, m1 = (rank + 1) * 35 / kCluster;
  const int mine = intra_block(a.y, ly.t, px, py,
                               z.avail + (long long)row * (4 * n + 1), -1, n,
                               0, a.bit_depth, a.strong, work, nullptr, clk,
                               m0, m1);
  if (threadIdx.x == 0) {
    part[parity][0] = work[intra_cost_word(n)];
    part[parity][1] = mine;
  }
  cl.sync();
  // every warp: lanes 0..kCluster-1 read one rank's slot each, then the
  // lowest (SATD, mode) by shuffles
  const int lane = threadIdx.x & 31;
  int bc = 0x7fffffff, bm = 35;
  if (lane < kCluster) {
    const int32_t *q = cl.map_shared_rank(&part[parity][0], lane);
    bc = q[0];
    bm = q[1];
  }
  for (int o = 16; o > 0; o >>= 1) {
    const int oc = __shfl_xor_sync(0xffffffffu, bc, o);
    const int om = __shfl_xor_sync(0xffffffffu, bm, o);
    if (oc < bc || (oc == bc && om < bm)) {
      bc = oc;
      bm = om;
    }
  }
  const int best = bm;
  clk.cluster();
  if (rank == 0) {
    predict_from_chain(ly.t, work, best, n, 0, a.bit_depth, pred);
    clk(kMarkPredict);
    const TqPlanes ty{a.y.org, a.y.org_stride, a.y.plane, a.y.stride,
                      a.coef_y, a.coef_y_stride};
    const int cbf = tq_encode_block<kRdoq>(ly.tq, ty, px, py, best, pred,
                                           work, clk);
    if (threadIdx.x == 0) {
      z.best[row] = best;
      z.cbf_y[row] = cbf;
    }
    write_halo(a, w, 0);
  } else if (crow >= 0 && rank <= 2) {
    clk.plane = rank;
    encode_chroma<kRdoq>(a, z, log2, crow, w[2 + rank], best, pred, work,
                         clk);
    write_halo(a, w, rank);
  }
}

// The banded form (the mesh encoder's virtual mesh, K19): the planes hold
// every (frame, band) cell's slab stacked, and a.halo [N, 3] gives, per
// item and plane (luma, cb, cr), the row of the next band's slab that
// holds its halo where the block's bottom row is its band's last, or -1.
// The CTA that writes that block's recon copies its bottom row there
// (write_halo), so after every level the halo equals what the level
// loop's copy of the whole row gives: rows change only where blocks write.
// A block of the next band reads the halo only at a later level, after
// the grid sync; samples of it that a block of the same level writes are
// unavailable to it by the availability masks, whatever they hold.
template <bool kRdoq>
__global__ void __launch_bounds__(kThreads)
    scan_encode_kernel(const __grid_constant__ ScanArgs a) {
  extern __shared__ int32_t sm[];
  __shared__ int32_t part[2][2];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  int32_t *pred = sm;                      // [nmax^2]
  int32_t *work = sm + a.nmax * a.nmax;    // intra or tq scratch
  Clock clk;
  int parity = 0;
  for (int s = 0; s < a.levels; ++s) {
    clk.start(s);
    const int first = a.level_off[s], cnt = a.level_off[s + 1] - first;
    if (a.rmd) {
      const int clusters = gridDim.x / kCluster;
      for (int j = blockIdx.x / kCluster; j < cnt; j += clusters) {
        encode_rmd_item<kRdoq>(a, a.items + 5LL * (first + j), parity, part,
                               pred, work, clk);
        parity ^= 1;
      }
    } else {
      for (int t = blockIdx.x; t < 3 * cnt; t += gridDim.x)
        encode_task<kRdoq>(a, a.items + 5LL * (first + t % cnt), t / cnt,
                           pred, work, clk);
    }
    if (s + 1 < a.levels) grid.sync();
    clk.synced();
  }
  // no CTA leaves while another of its cluster may read its slots
  if (a.rmd) cooperative_groups::this_cluster().sync();
}

__global__ void __launch_bounds__(kThreads) scan_decode_kernel(ScanArgs a) {
  extern __shared__ int32_t sm[];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int s = 0; s < a.levels; ++s) {
    const int first = a.level_off[s], cnt = a.level_off[s + 1] - first;
    for (int t = blockIdx.x; t < 3 * cnt; t += gridDim.x) {
      const int32_t *w = a.items + 5LL * (first + t % cnt);
      const int plane = t / cnt;
      const int log2 = w[0], row = w[1], crow = w[2];
      const SizeArgs &z = a.size[log2 - 2];
      if (plane == 0) {
        const int n = 1 << log2;
        intra_block(a.y, a.cls[log2 - 2].t, z.pos[2 * row],
                    z.pos[2 * row + 1], z.avail + (long long)row * (4 * n + 1),
                    z.modes_y[row], n, 0, a.bit_depth, a.strong, sm, nullptr);
        continue;
      }
      if (crow < 0) continue;
      const int lc2 = chroma_log2(log2), nc = 1 << lc2;
      const int r = w[2 + plane];
      intra_block(a.c, a.cls[4 + lc2 - 2].t, z.cpos[2 * r], z.cpos[2 * r + 1],
                  z.cavail + (long long)crow * (4 * nc + 1), z.modes_c[crow],
                  nc, 1, a.bit_depth, a.strong, sm, nullptr);
    }
    if (s + 1 < a.levels) grid.sync();
  }
}

// Dynamic shared memory above 48 KB, the cooperative launch, the CTAs of
// `kernel` per SM.
template <class Kernel>
int prepare(Kernel kernel, size_t smem, int *sms, int *per_sm) {
  cudaError_t e;
  if (smem > 48 * 1024) {
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
// wanted) CTAs; info <- (grid, CTAs per SM, dynamic shared bytes,
// threads, CTAs per cluster).
template <class Kernel>
int launch(Kernel kernel, const ScanArgs *a, size_t smem, int wanted,
           cudaStream_t st, int *info) {
  int sms = 0, per_sm = 0;
  int err = prepare(kernel, smem, &sms, &per_sm);
  if (err) return err;
  int grid = per_sm * sms < wanted ? per_sm * sms : wanted;
  if (grid < 1) grid = 1;
  info[0] = grid;
  info[1] = per_sm;
  info[2] = (int)smem;
  info[3] = kThreads;
  info[4] = 1;
  void *params[] = {const_cast<ScanArgs *>(a)};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void *)kernel, dim3(grid), dim3(kThreads), params, smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The encode's launch of `kernel`: cooperative and in clusters of
// kCluster CTAs, min(co-resident clusters, the clusters that `wanted`
// CTAs fill) clusters, through cudaLaunchKernelEx; info as launch's. A
// card that refuses either attribute, or a grid that cannot be
// co-resident, is an error, never another layout.
template <class Kernel>
int launch_clusters(Kernel kernel, const ScanArgs *a, size_t smem,
                    int wanted, cudaStream_t st, int *info) {
  int sms = 0, per_sm = 0;
  int err = prepare(kernel, smem, &sms, &per_sm);
  if (err) return err;
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = kCluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeCooperative;
  at[1].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = at;
  cfg.numAttrs = 2;
  int most = 0;
  cudaError_t e = cudaOccupancyMaxActiveClusters(&most, kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  if (most < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int need = (wanted + kCluster - 1) / kCluster;
  const int clusters = most < need ? most : (need > 0 ? need : 1);
  cfg.gridDim = dim3(clusters * kCluster);
  info[0] = clusters * kCluster;
  info[1] = per_sm;
  info[2] = (int)smem;
  info[3] = kThreads;
  info[4] = kCluster;
  e = cudaLaunchKernelEx(&cfg, kernel, *a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

#ifdef HH_STAGE_CLOCK
// The stage clocks' buffer: int64 [levels, ctas, kClock], zero, or null
// to stop; CTAs at or past ctas write nothing.
HH_EXPORT int hh_scan_clock(void *buf, int ctas) {
  cudaError_t e = cudaMemcpyToSymbol(g_clk, &buf, sizeof(buf));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_clk_ctas, &ctas, sizeof(int));
  return (int)e;
}
#endif

// Encode entry: every level of one frame (or of a mesh's stacked slabs,
// with args.halo). args: the ScanArgs, mirrored by ctypes in
// models/wavefront_scan.py; y and c hold the recon planes (zero on entry)
// and the originals; rdoq selects the RDOQ arm; widest: the most items of
// any level; info [5] receives the launch's shape.
HH_EXPORT int hh_scan_encode(const void *args, int rdoq, int widest,
                             void *stream, int *info) {
  const ScanArgs *a = static_cast<const ScanArgs *>(args);
  const int n = a->nmax;
  const size_t intra_b = sizeof(int32_t) * intra_scratch_words(n);
  const size_t tq_b = tq_scratch_bytes(n, rdoq != 0);
  const size_t smem =
      sizeof(int32_t) * n * n + (intra_b > tq_b ? intra_b : tq_b);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // a cluster per item (RMD), or a CTA per plane of an item
  const int wanted = a->rmd ? widest * kCluster : 3 * widest;
  return rdoq ? launch_clusters(scan_encode_kernel<true>, a, smem, wanted, st,
                                info)
              : launch_clusters(scan_encode_kernel<false>, a, smem, wanted,
                                st, info);
}

// Decode entry: every level of one frame, prediction plus the dense
// residual. y and c hold the recon planes (zero on entry) and the
// residuals; modes_y and modes_c of every size are given.
HH_EXPORT int hh_scan_decode(const void *args, int widest, void *stream,
                             int *info) {
  const ScanArgs *a = static_cast<const ScanArgs *>(args);
  const size_t smem = sizeof(int32_t) * intra_scratch_words(a->nmax);
  return launch(scan_decode_kernel, a, smem, 3 * widest,
                static_cast<cudaStream_t>(stream), info);
}
