// Kernel C11: the GT corner warp, on given windows and as the GT
// prediction of blocks of a plane.
//
// Replaces hevc_hop_tpu/ops/warp.py warp_blocks (window entry,
// hh_warp_blocks) and hevc_hop_tpu/models/ss_scan.py gt_pred_luma and
// gt_pred_chroma with their window gathers (plane entry, hh_gt_pred), as
// scan_encode_iss's chroma and scan_decode_ss use them.
//
// One CTA per block; n is a template parameter (luma 8, 16, 32; chroma
// and the window entry 4, 8, 16, 32), so warp.cuh warp_sample divides by
// constants. The plane entry's work on a block is warp.cuh gt_luma_block
// or gt_chroma_block, whose parts kernel C14 (ss_scan.cu) runs on a CU's
// planes in one pass (gt_cu, gt_chroma_pair). The window entry stages the
// block's [2n, 2n] window in shared memory and warps it (warp_sample), a
// thread per output sample; a block-wide OR of the knife-edge flags gives
// `safe`. The plane entry stages the window itself, as int16 a row chunk
// at a time: for luma the clamped [2n, 2n] samples around pos + mv; for
// chroma the (2n+3)^2 samples of the block's own picture of the stacked
// cb/cr plane, interpolated by interp.cuh's mc_filter at the MV's chroma
// phase (0 or 4 per axis; a phase-0 axis a copy) into [2n, 2n], then
// warped in half-pel units. Epilogues as kernel C8's: the prediction, the
// prediction written only into the blocks a mask selects, or the residual
// added and the clipped recon written into the plane in place (where the
// mask selects; the decoder's MV-aware schedule puts every sample a block
// reads at an earlier level, so the blocks of one launch are independent).
//
// Bound: int32 operations, about 30 per output sample against a window of
// 4 samples per output sample read once: near the card's bytes-per-
// operation line, and far from either bound at a level's tens of blocks,
// whose launch is one short wave on 132 SMs.
#include "warp.cuh"

namespace {

constexpr int kThreads = 256;

template <int N>
__global__ void __launch_bounds__(kThreads)
    warp_kernel(const int32_t *windows, const int32_t *corners,
                int bit_depth, int half, int32_t *pred, int32_t *safe) {
  extern __shared__ int32_t sm[];
  constexpr int ws = 2 * N, nn = N * N;
  const int b = blockIdx.x;
  const int32_t *src = windows + (long long)b * ws * ws;
  for (int i = threadIdx.x; i < ws * ws; i += blockDim.x) sm[i] = src[i];
  __shared__ int c4[8];
  for (int k = threadIdx.x; k < 8; k += blockDim.x) c4[k] = corners[8 * b + k];
  __syncthreads();
  const int knife = gt_warp<N>(warp_geom(N, c4, half), sm,
                               (1 << bit_depth) - 1, threadIdx.x, blockDim.x,
                               PutPred{pred + (long long)b * nn, N});
  const int any = __syncthreads_or(knife);
  if (threadIdx.x == 0) safe[b] = !any;
}

template <int N, bool kChroma>
__global__ void __launch_bounds__(kThreads)
    gt_pred_kernel(Src src, int hc_off, int h_real, const int32_t *pos,
                   const int32_t *mv, const int32_t *gtc, int per,
                   int bit_depth, int32_t *out, const int32_t *only,
                   const int32_t *resi, int resi_stride, int32_t *plane) {
  extern __shared__ __align__(16) int32_t sm[];
  const int b = blockIdx.x, m = b % per;
  if (only != nullptr && only[m] == 0) return;
  const int px = pos[2 * b], py = pos[2 * b + 1];
  // the anchor: the full-pel part of the quarter-pel MV
  const int vx = mv[2 * m] >> 2, vy = mv[2 * m + 1] >> 2;
  int c4[8];
  gt4(gtc + 6 * m, c4);
  const Src s = picture_rows(src, kChroma, hc_off, h_real, py);
  const PutRecon rec{resi, resi_stride, plane, src.stride, px, py,
                     (1 << bit_depth) - 1};
  const PutPred pred{out + (long long)b * N * N, N};
  if constexpr (kChroma) {
    const McJob j = gt_chroma_job<N>(s, px, py, vx, vy);
    if (resi != nullptr)
      gt_chroma_block<N>(j, c4, bit_depth, sm, rec);
    else
      gt_chroma_block<N>(j, c4, bit_depth, sm, pred);
  } else {
    if (resi != nullptr)
      gt_luma_block<N>(s, px, py, vx, vy, c4, bit_depth, sm, rec);
    else
      gt_luma_block<N>(s, px, py, vx, vy, c4, bit_depth, sm, pred);
  }
}

template <int N>
int launch_warp(const int32_t *windows, const int32_t *corners, int b,
                int bit_depth, int half, int32_t *pred, int32_t *safe,
                cudaStream_t st) {
  const size_t smem = sizeof(int32_t) * 4 * N * N;
  warp_kernel<N><<<b, kThreads, smem, st>>>(windows, corners, bit_depth,
                                            half, pred, safe);
  return (int)cudaGetLastError();
}

template <int N, bool kChroma>
int launch_gt_pred(const Src &src, int hc_off, int h_real,
                   const int32_t *pos, const int32_t *mv, const int32_t *gtc,
                   int per, int b, int bit_depth, int32_t *out,
                   const int32_t *only, const int32_t *resi, int resi_stride,
                   int32_t *plane, cudaStream_t st) {
  const size_t smem = sizeof(int32_t) * (kChroma ? gt_chroma_words<N>()
                                                 : gt_luma_words<N>());
  gt_pred_kernel<N, kChroma><<<b, kThreads, smem, st>>>(
      src, hc_off, h_real, pos, mv, gtc, per, bit_depth, out, only, resi,
      resi_stride, plane);
  return (int)cudaGetLastError();
}

}  // namespace

// Window entry: windows [B, 2n, 2n] and corners [B, 4, 2] int32; half = 1
// for the chroma form; n 4, 8, 16 or 32. Out: pred [B, n, n] int32, safe
// [B] int32.
HH_EXPORT int hh_warp_blocks(const void *windows, const void *corners, int b,
                             int n, int bit_depth, int half, void *pred,
                             void *safe, void *stream) {
  const auto *w = static_cast<const int32_t *>(windows);
  const auto *c = static_cast<const int32_t *>(corners);
  auto *p = static_cast<int32_t *>(pred);
  auto *s = static_cast<int32_t *>(safe);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 4: return launch_warp<4>(w, c, b, bit_depth, half, p, s, st);
    case 8: return launch_warp<8>(w, c, b, bit_depth, half, p, s, st);
    case 16: return launch_warp<16>(w, c, b, bit_depth, half, p, s, st);
    case 32: return launch_warp<32>(w, c, b, bit_depth, half, p, s, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Plane entry: plane int32 (pw columns, row stride); pos [B, 2] (x, y),
// mv [per, 2] quarter-pel luma MVs and gtc [per, 6] coded corners, block i
// taking row i % per; chroma = 1 for the stacked cb/cr plane (cr from row
// hc_off); h_real rows per picture; n 8, 16 or 32 (luma) or 4, 8, 16
// (chroma). out [B, n, n] int32 (null with resi); only [per] int32 or
// null; resi int32 plane (row stride) or null.
HH_EXPORT int hh_gt_pred(void *plane, int pw, int stride, const void *pos,
                         const void *mv, const void *gtc, int per, int b,
                         int n, int chroma, int h_real, int hc_off,
                         int bit_depth, void *out, const void *only,
                         const void *resi, int resi_stride, void *stream) {
  const Src src{static_cast<const int32_t *>(plane), stride, 0, h_real - 1,
                pw};
  const auto *p = static_cast<const int32_t *>(pos);
  const auto *v = static_cast<const int32_t *>(mv);
  const auto *g = static_cast<const int32_t *>(gtc);
  auto *o = static_cast<int32_t *>(out);
  const auto *on = static_cast<const int32_t *>(only);
  const auto *r = static_cast<const int32_t *>(resi);
  auto *pl = static_cast<int32_t *>(plane);
  const auto st = static_cast<cudaStream_t>(stream);
#define HH_GT(N, C)                                                         \
  return launch_gt_pred<N, C>(src, hc_off, h_real, p, v, g, per, b,         \
                              bit_depth, o, on, r, resi_stride, pl, st)
  if (chroma) {
    switch (n) {
      case 4: HH_GT(4, true);
      case 8: HH_GT(8, true);
      case 16: HH_GT(16, true);
    }
  } else {
    switch (n) {
      case 8: HH_GT(8, false);
      case 16: HH_GT(16, false);
      case 32: HH_GT(32, false);
    }
  }
#undef HH_GT
  return (int)cudaErrorInvalidValue;
}
