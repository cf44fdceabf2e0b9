// Kernel C11: the GT corner warp, on given windows and as the GT
// prediction of blocks of a plane.
//
// Replaces hevc_hop_tpu/ops/warp.py warp_blocks (window entry,
// hh_warp_blocks) and hevc_hop_tpu/models/ss_scan.py gt_pred_luma and
// gt_pred_chroma with their window gathers (plane entry, hh_gt_pred), as
// scan_encode_iss's chroma and scan_decode_ss use them.
//
// One CTA per block; the plane entry's work on a block is warp.cuh
// gt_pred_block, which kernel C14 (ss_scan.cu) runs too. The window entry
// stages the block's [2n, 2n] window in
// shared memory and warps it (warp.cuh warp_sample), one thread per output
// sample; a block-wide OR of the knife-edge flags gives `safe`. The plane
// entry stages the window itself: for luma the clamped [2n, 2n] samples
// around pos + mv; for chroma the (2n+3)^2 samples of the block's own
// picture of the stacked cb/cr plane, interpolated by interp.cuh's
// mc_block at the MV's chroma phase (0 or 4 per axis) into [2n, 2n], then
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

__global__ void warp_kernel(const int32_t *windows, const int32_t *corners,
                            int n, int bit_depth, int half, int32_t *pred,
                            int32_t *safe) {
  extern __shared__ int32_t sm[];
  const int b = blockIdx.x, ws = 2 * n, nn = n * n;
  const int32_t *src = windows + (long long)b * ws * ws;
  for (int i = threadIdx.x; i < ws * ws; i += blockDim.x) sm[i] = src[i];
  __shared__ int c4[8];
  for (int k = threadIdx.x; k < 8; k += blockDim.x) c4[k] = corners[8 * b + k];
  __syncthreads();
  const WarpGeom g = warp_geom(n, c4, half);
  const int maxv = (1 << bit_depth) - 1;
  int knife = 0;
  for (int i = threadIdx.x; i < nn; i += blockDim.x)
    pred[(long long)b * nn + i] = warp_sample(g, sm, ws, i, maxv, knife);
  const int any = __syncthreads_or(knife);
  if (threadIdx.x == 0) safe[b] = !any;
}

__global__ void gt_pred_kernel(Src src, int hc_off, int h_real,
                               const int32_t *pos, const int32_t *mv,
                               const int32_t *gtc, int per, int n,
                               int chroma, int bit_depth, int32_t *out,
                               const int32_t *only, const int32_t *resi,
                               int resi_stride, int32_t *plane) {
  extern __shared__ int32_t sm[];
  const int b = blockIdx.x, m = b % per;
  if (only != nullptr && only[m] == 0) return;
  // the anchor: the full-pel part of the quarter-pel MV
  gt_pred_block(src, hc_off, h_real, pos[2 * b], pos[2 * b + 1],
                mv[2 * m] >> 2, mv[2 * m + 1] >> 2, gtc + 6 * m, n, chroma,
                bit_depth,
                out == nullptr ? nullptr : out + (long long)b * n * n, resi,
                resi_stride, plane, sm);
}

}  // namespace

// Window entry: windows [B, 2n, 2n] and corners [B, 4, 2] int32; half = 1
// for the chroma form. Out: pred [B, n, n] int32, safe [B] int32.
HH_EXPORT int hh_warp_blocks(const void *windows, const void *corners, int b,
                             int n, int bit_depth, int half, void *pred,
                             void *safe, void *stream) {
  const size_t smem = sizeof(int32_t) * 4 * n * n;
  warp_kernel<<<b, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t *>(windows),
      static_cast<const int32_t *>(corners), n, bit_depth, half,
      static_cast<int32_t *>(pred), static_cast<int32_t *>(safe));
  return (int)cudaGetLastError();
}

// Plane entry: plane int32 (pw columns, row stride); pos [B, 2] (x, y),
// mv [per, 2] quarter-pel luma MVs and gtc [per, 6] coded corners, block i
// taking row i % per; chroma = 1 for the stacked cb/cr plane (cr from row
// hc_off); h_real rows per picture. out [B, n, n] int32 (null with resi);
// only [per] int32 or null; resi int32 plane (row stride) or null.
HH_EXPORT int hh_gt_pred(void *plane, int pw, int stride, const void *pos,
                         const void *mv, const void *gtc, int per, int b,
                         int n, int chroma, int h_real, int hc_off,
                         int bit_depth, void *out, const void *only,
                         const void *resi, int resi_stride, void *stream) {
  const Src src{static_cast<const int32_t *>(plane), stride, 0, h_real - 1,
                pw};
  const size_t smem = sizeof(int32_t) * gt_pred_words(n, chroma);
  gt_pred_kernel<<<b, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      src, hc_off, h_real, static_cast<const int32_t *>(pos),
      static_cast<const int32_t *>(mv), static_cast<const int32_t *>(gtc),
      per, n, chroma, bit_depth, static_cast<int32_t *>(out),
      static_cast<const int32_t *>(only), static_cast<const int32_t *>(resi),
      resi_stride, static_cast<int32_t *>(plane));
  return (int)cudaGetLastError();
}
