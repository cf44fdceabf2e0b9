// Kernel C8: motion compensation of a batch of blocks.
//
// Replaces hevc_hop_tpu/ops/interp.py filter_2d, luma_mc and chroma_mc_q,
// with the window gather and the decoder's add-residual scatter of
// hevc_hop_tpu/models/ss_scan.py scan_decode_ss (and the encoder's chroma
// choice between DM intra and MC of scan_encode_iss, and of
// scan_encode_pss and scan_decode_pss between the recon and the previous
// picture).
//
// One CTA per block (interp.cuh mc_block): the CTA stages the clamped
// (n+7)^2 luma or (n+3)^2 chroma window in shared memory, runs the
// horizontal stage into a second shared buffer and the vertical stage into
// the output, in int32 with the reference's shifts, offsets and clip. The
// stacked cb/cr plane is read per block from its own picture: rows of a
// block at or below hc_off clamp to [hc_off, hc_off + h_real), others to
// [0, h_real). Epilogues: write the prediction ([B, n, n]); write it only
// into the blocks a mask selects (the others keep C2's intra prediction);
// or add the residual and write the clipped recon into the plane in place,
// or into another plane (a PSS picture's temporal blocks), for every block
// or the blocks a mask selects (the blocks of one launch are independent:
// no block reads samples another writes, as the decoder's MV-aware
// schedule guarantees).
//
// Bound: device-memory bytes. A block reads its (n+7)^2 window once and
// writes n^2 samples, and does about 16 n (2n + 7) int32 multiply-adds:
// some 2 operations per byte, far below the card's operations-per-byte
// line. The window and the intermediate stay in shared memory. A CTA per
// block and a level's tens of blocks leave the card mostly idle.
#include "interp.cuh"

namespace {

__global__ void mc_kernel(Src src, int hc_off, int h_real, const int32_t *pos,
                          const int32_t *mv, int mper, int n, int chroma,
                          int bit_depth, int32_t *out, const int32_t *only,
                          int oper, const int32_t *resi, int resi_stride,
                          int32_t *dst) {
  extern __shared__ int32_t sm[];
  const int b = blockIdx.x;
  if (only != nullptr && only[b % oper] == 0) return;
  const int px = pos[2 * b], py = pos[2 * b + 1];
  Src s = src;
  s.row_lo = (chroma && py >= hc_off) ? hc_off : 0;
  s.row_hi = s.row_lo + h_real - 1;
  const int m = b % mper;
  int32_t *pred = sm + mc_smem_words(n, chroma);
  mc_block(s, px, py, mv[2 * m], mv[2 * m + 1], n, chroma, bit_depth, sm,
           pred);
  const int nn = n * n, maxv = (1 << bit_depth) - 1;
  for (int i = threadIdx.x; i < nn; i += blockDim.x) {
    if (resi != nullptr) {
      const long long y = py + i / n, x = px + i % n;
      dst[y * src.stride + x] =
          clip3(0, maxv, pred[i] + resi[y * resi_stride + x]);
    } else {
      out[(long long)b * nn + i] = pred[i];
    }
  }
}

}  // namespace

// plane int32 [ph, pw] (row stride); pos [B, 2] (x, y) and mv [mper, 2]
// quarter-pel luma MVs int32; chroma = 1 for the stacked cb/cr plane (cr
// from row hc_off); h_real rows per picture. out [B, n, n] int32 (null with
// resi); only [oper] int32 or null; resi int32 plane (row stride) or null;
// dst the plane the resi epilogue writes (plane's row stride), null for
// plane itself.
HH_EXPORT int hh_mc_blocks(void *plane, int ph, int pw, int stride,
                           const void *pos, const void *mv, int mper, int b,
                           int n, int chroma, int h_real, int hc_off,
                           int bit_depth, void *out, const void *only,
                           int oper, const void *resi, int resi_stride,
                           void *dst, void *stream) {
  (void)ph;
  const Src src{static_cast<const int32_t *>(plane), stride, 0, 0, pw};
  const int nn = n * n;
  const int threads = nn < 64 ? 64 : (nn > 256 ? 256 : nn);
  const size_t smem = sizeof(int32_t) * (mc_smem_words(n, chroma) + nn);
  mc_kernel<<<b, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      src, hc_off, h_real, static_cast<const int32_t *>(pos),
      static_cast<const int32_t *>(mv), mper, n, chroma, bit_depth,
      static_cast<int32_t *>(out), static_cast<const int32_t *>(only), oper,
      static_cast<const int32_t *>(resi), resi_stride,
      static_cast<int32_t *>(dst != nullptr ? dst : plane));
  return (int)cudaGetLastError();
}
