// Kernel C8: motion compensation of a batch of blocks.
//
// Replaces hevc_hop_tpu/ops/interp.py filter_2d, luma_mc and chroma_mc_q,
// with the window gather and the decoder's add-residual scatter of
// hevc_hop_tpu/models/ss_scan.py scan_decode_ss (and the encoder's chroma
// choice between DM intra and MC of scan_encode_iss, and of
// scan_encode_pss and scan_decode_pss between the recon and the previous
// picture).
//
// One CTA per block (interp.cuh mc_block_n, whose filter kernel C14 runs
// on a CU's planes in one pass, mc_cu and mc_pair): the block size and the
// plane are template parameters (luma 4 to 32, chroma 2 to 16), the CTA's
// warps (2 to 8, with the block) stage the clamped (n+7)^2 luma or (n+3)^2
// chroma window as int16 in shared memory (interp.cuh stage_windows), the
// loads before the stores and the one barrier, and each thread then runs
// both stages down a column of a run of rows, the first stage's rows
// sliding in registers, in int32 with the reference's shifts, offsets and
// clip, and writes each sample from its register. The
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
// line. The window stays in shared memory, the intermediate in registers.
// A CTA per block and a level's tens of blocks leave the card mostly idle.
#include "interp.cuh"

namespace {

template <int N, bool kChroma, int kWarps>
__global__ void __launch_bounds__(kWarps * 32)
    mc_kernel(Src src, int hc_off, int h_real, const int32_t *pos,
              const int32_t *mv, int mper, int bit_depth, int32_t *out,
              const int32_t *only, int oper, const int32_t *resi,
              int resi_stride, int32_t *dst) {
  extern __shared__ __align__(16) int32_t sm[];
  const int b = blockIdx.x;
  if (only != nullptr && only[b % oper] == 0) return;
  const int m = b % mper, px = pos[2 * b], py = pos[2 * b + 1];
  const McJob j{picture_rows(src, kChroma, hc_off, h_real, py), px, py,
                mv[2 * m], mv[2 * m + 1]};
  if (resi != nullptr)
    mc_block_n<N, kChroma>(
        j, bit_depth, sm,
        PutRecon{resi, resi_stride, dst, src.stride, px, py,
                 (1 << bit_depth) - 1});
  else
    mc_block_n<N, kChroma>(j, bit_depth, sm,
                                   PutPred{out + (long long)b * N * N, N});
}

// One launch of mc_kernel for n = N: a warp per 32 samples of the block,
// 2 to 8
template <int N, bool kChroma>
int launch_mc(const Src &src, int hc_off, int h_real, const int32_t *pos,
              const int32_t *mv, int mper, int b, int bit_depth, int32_t *out,
              const int32_t *only, int oper, const int32_t *resi,
              int resi_stride, int32_t *dst, cudaStream_t st) {
  constexpr int kWarps = N * N / 32 < 2 ? 2 : (N * N / 32 > 8 ? 8 : N * N / 32);
  const size_t smem = sizeof(int32_t) * mc_block_words<N, kChroma>();
  mc_kernel<N, kChroma, kWarps><<<b, kWarps * 32, smem, st>>>(
      src, hc_off, h_real, pos, mv, mper, bit_depth, out, only, oper, resi,
      resi_stride, dst);
  return (int)cudaGetLastError();
}

}  // namespace

// plane int32 [ph, pw] (row stride); pos [B, 2] (x, y) and mv [mper, 2]
// quarter-pel luma MVs int32; chroma = 1 for the stacked cb/cr plane (cr
// from row hc_off); h_real rows per picture; n 4 to 32 (luma) or 2 to 16
// (chroma), a power of two. out [B, n, n] int32 (null with resi); only
// [oper] int32 or null; resi int32 plane (row stride) or null; dst the
// plane the resi epilogue writes (plane's row stride), null for plane
// itself.
HH_EXPORT int hh_mc_blocks(void *plane, int ph, int pw, int stride,
                           const void *pos, const void *mv, int mper, int b,
                           int n, int chroma, int h_real, int hc_off,
                           int bit_depth, void *out, const void *only,
                           int oper, const void *resi, int resi_stride,
                           void *dst, void *stream) {
  (void)ph;
  const Src src{static_cast<const int32_t *>(plane), stride, 0, 0, pw};
  const auto *p = static_cast<const int32_t *>(pos);
  const auto *v = static_cast<const int32_t *>(mv);
  auto *o = static_cast<int32_t *>(out);
  const auto *on = static_cast<const int32_t *>(only);
  const auto *r = static_cast<const int32_t *>(resi);
  auto *d = static_cast<int32_t *>(dst != nullptr ? dst : plane);
  const auto st = static_cast<cudaStream_t>(stream);
#define HH_MC(N, C)                                                        \
  return launch_mc<N, C>(src, hc_off, h_real, p, v, mper, b, bit_depth, o, \
                         on, oper, r, resi_stride, d, st)
  if (chroma) {
    switch (n) {
      case 2: HH_MC(2, true);
      case 4: HH_MC(4, true);
      case 8: HH_MC(8, true);
      case 16: HH_MC(16, true);
    }
  } else {
    switch (n) {
      case 4: HH_MC(4, false);
      case 8: HH_MC(8, false);
      case 16: HH_MC(16, false);
      case 32: HH_MC(32, false);
    }
  }
#undef HH_MC
  return (int)cudaErrorInvalidValue;
}
