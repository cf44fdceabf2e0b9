// Kernel C13: the whole-frame intra wavefront, encode and decode, as one
// cooperative launch per frame.
//
// Replaces hevc_hop_tpu/models/wavefront_scan.py scan_encode (one
// jax.lax.scan over the levels, :217) and scan_decode (:322), which the
// port ran as a Python loop launching kernels C2 and C3 once per level and
// TU size (models/wavefront_scan.py scan_encode_loop, which stays the
// plain version and the mesh's loop).
//
// The work list (models/wavefront_scan.py work_list) holds each non-empty
// level's items, packed: (log2, luma row of the block in its size's plan,
// row of its chroma pair or -1, the cb and cr rows in the stacked chroma
// plane's positions). A persistent grid of CTAs strides over the items of
// a level; cooperative_groups' grid sync separates the levels. For each
// item one CTA runs, in order:
// - encode: luma intra_block (intra.cuh: the chain gather and
//   substitution, then RMD, or the given mode) into a shared-memory
//   prediction, tq_encode_block (tq.cuh: residual, forward DCT or DST,
//   dead-zone quant or RDOQ, SBH, the levels into coef_y, dequant, inverse
//   transform, the recon into ry), then the same for cb and cr with the
//   chroma mode (the given one, else the luma block's), and the mode and
//   the three cbfs into their packed slots;
// - decode: intra_block's add-residual epilogue for luma, cb and cr.
// The prediction, residual and coefficients never leave shared memory.
//
// Coherence: a level reads recon that CTAs on other SMs wrote in earlier
// levels of the same launch, so intra_block reads the planes with
// L2-coherent loads (__ldcg), never through L1 or the read-only path; the
// grid sync orders the writes before the reads. Every CTA reaches every
// level's sync (an idle CTA strides over no item). Static shared state of
// rdoq_block and the cbf flag are reused from item to item; each body ends
// with a barrier.
//
// Integers equal C2's and C3's: the CTA runs the same device functions,
// with one blockDim for every size (kThreads); no sum of theirs depends
// on blockDim (integer atomics, per-thread CG walks, thread 0's scalar
// sums), and every float that SBH and RDOQ compare is formed with explicit
// __fmul_rn / __fadd_rn / __fsub_rn / fmaf, so inlining into this kernel
// adds no contraction.
//
// Bound: the chain of levels. A level holds a few tens of items on 132
// SMs, so one CTA's latency per level (an RMD of 35 modes, or an RDOQ
// arm, then two chroma blocks) sets the frame's time; the bytes and
// operations of the whole frame are far below what the card could move
// in that time. The design removes the host from the chain: one launch
// instead of some 1500, and no round trip of the prediction through
// device memory.
#include <cooperative_groups.h>

#include "intra.cuh"
#include "tq.cuh"

namespace {

constexpr int kThreads = 256;

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

template <bool kRdoq>
__global__ void __launch_bounds__(kThreads) scan_encode_kernel(ScanArgs a) {
  extern __shared__ int32_t sm[];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  int32_t *pred = sm;                      // [nmax^2]
  int32_t *work = sm + a.nmax * a.nmax;    // intra or tq scratch
  const TqPlanes ty{a.y.org, a.y.org_stride, a.y.plane, a.y.stride,
                    a.coef_y, a.coef_y_stride};
  const TqPlanes tc{a.c.org, a.c.org_stride, a.c.plane, a.c.stride,
                    a.coef_c, a.coef_c_stride};
  for (int s = 0; s < a.levels; ++s) {
    const int end = a.level_off[s + 1];
    for (int it = a.level_off[s] + blockIdx.x; it < end; it += gridDim.x) {
      const int32_t *w = a.items + 5LL * it;
      const int log2 = w[0], row = w[1], crow = w[2];
      const SizeArgs &z = a.size[log2 - 2];
      const ClassArgs &ly = a.cls[log2 - 2];
      const int n = 1 << log2;
      const int px = z.pos[2 * row], py = z.pos[2 * row + 1];
      const int ask = a.rmd ? -1 : z.modes_y[row];
      const int best = intra_block(
          a.y, ly.t, px, py, z.avail + (long long)row * (4 * n + 1), ask, n,
          0, a.bit_depth, a.strong, work, pred);
      const int cbf = tq_encode_block<kRdoq>(ly.tq, ty, px, py, best, pred,
                                             work);
      if (threadIdx.x == 0) {
        z.best[row] = best;
        z.cbf_y[row] = cbf;
      }
      if (crow < 0) continue;
      const int lc2 = chroma_log2(log2), nc = 1 << lc2;
      const ClassArgs &lc = a.cls[4 + lc2 - 2];
      const int cmode = z.modes_c != nullptr ? z.modes_c[crow] : best;
      const uint8_t *av = z.cavail + (long long)crow * (4 * nc + 1);
      for (int k = 3; k <= 4; ++k) {
        const int r = w[k];
        const int cx = z.cpos[2 * r], cy = z.cpos[2 * r + 1];
        intra_block(a.c, lc.t, cx, cy, av, cmode, nc, 1, a.bit_depth,
                    a.strong, work, pred);
        const int cbf_c = tq_encode_block<kRdoq>(lc.tq, tc, cx, cy, cmode,
                                                 pred, work);
        if (threadIdx.x == 0) z.cbf_c[r] = cbf_c;
      }
    }
    if (s + 1 < a.levels) grid.sync();
  }
}

__global__ void __launch_bounds__(kThreads) scan_decode_kernel(ScanArgs a) {
  extern __shared__ int32_t sm[];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int s = 0; s < a.levels; ++s) {
    const int end = a.level_off[s + 1];
    for (int it = a.level_off[s] + blockIdx.x; it < end; it += gridDim.x) {
      const int32_t *w = a.items + 5LL * it;
      const int log2 = w[0], row = w[1], crow = w[2];
      const SizeArgs &z = a.size[log2 - 2];
      const int n = 1 << log2;
      intra_block(a.y, a.cls[log2 - 2].t, z.pos[2 * row], z.pos[2 * row + 1],
                  z.avail + (long long)row * (4 * n + 1), z.modes_y[row], n,
                  0, a.bit_depth, a.strong, sm, nullptr);
      if (crow < 0) continue;
      const int lc2 = chroma_log2(log2), nc = 1 << lc2;
      const uint8_t *av = z.cavail + (long long)crow * (4 * nc + 1);
      for (int k = 3; k <= 4; ++k) {
        const int r = w[k];
        intra_block(a.c, a.cls[4 + lc2 - 2].t, z.cpos[2 * r],
                    z.cpos[2 * r + 1], av, z.modes_c[crow], nc, 1,
                    a.bit_depth, a.strong, sm, nullptr);
      }
    }
    if (s + 1 < a.levels) grid.sync();
  }
}

// The cooperative launch of `kernel` over min(co-resident CTAs, widest)
// CTAs; info <- (grid, CTAs per SM, dynamic shared bytes, threads).
template <class Kernel>
int launch(Kernel kernel, const ScanArgs *a, size_t smem, int widest,
           cudaStream_t st, int *info) {
  cudaError_t e;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  int grid = per_sm * sms < widest ? per_sm * sms : widest;
  if (grid < 1) grid = 1;
  info[0] = grid;
  info[1] = per_sm;
  info[2] = (int)smem;
  info[3] = kThreads;
  void *params[] = {const_cast<ScanArgs *>(a)};
  e = cudaLaunchCooperativeKernel((const void *)kernel, dim3(grid),
                                  dim3(kThreads), params, smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// Encode entry: every level of one frame. args: the ScanArgs, mirrored by
// ctypes in models/wavefront_scan.py; y and c hold the recon planes (zero
// on entry) and the originals; rdoq selects the RDOQ arm; widest: the
// most items of any level; info [4] receives the launch's shape.
HH_EXPORT int hh_scan_encode(const void *args, int rdoq, int widest,
                             void *stream, int *info) {
  const ScanArgs *a = static_cast<const ScanArgs *>(args);
  const int n = a->nmax;
  const size_t intra_b = sizeof(int32_t) * intra_scratch_words(n);
  const size_t tq_b = tq_scratch_bytes(n, rdoq != 0);
  const size_t smem =
      sizeof(int32_t) * n * n + (intra_b > tq_b ? intra_b : tq_b);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rdoq ? launch(scan_encode_kernel<true>, a, smem, widest, st, info)
              : launch(scan_encode_kernel<false>, a, smem, widest, st, info);
}

// Decode entry: every level of one frame, prediction plus the dense
// residual. y and c hold the recon planes (zero on entry) and the
// residuals; modes_y and modes_c of every size are given.
HH_EXPORT int hh_scan_decode(const void *args, int widest, void *stream,
                             int *info) {
  const ScanArgs *a = static_cast<const ScanArgs *>(args);
  const size_t smem = sizeof(int32_t) * intra_scratch_words(a->nmax);
  return launch(scan_decode_kernel, a, smem, widest,
                static_cast<cudaStream_t>(stream), info);
}
