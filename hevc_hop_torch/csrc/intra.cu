// Kernel C2: intra prediction of a batch of blocks, with the 35-mode SATD
// decision (RMD), or one given mode, or one given mode plus the decoder's
// add-residual epilogue.
//
// Replaces hevc_hop_tpu/ops/intra.py substitute_refs, filter_refs,
// predict_all_modes, predict_mode and satd, together with the chain gather
// and block scatter of hevc_hop_tpu/models/wavefront_scan.py
// (_gather_chains, _enc_plane_ys's RMD, scan_decode's dec_plane).
//
// One CTA per block, whose work is intra_block (intra.cuh), the body that
// kernel C13 (scan.cu) runs too. The CTA gathers the block's 4N+1
// reference chain from the recon plane (coordinates clamped to the plane),
// substitutes the unavailable samples (H.265 8.4.4.2.2), builds the 1-2-1
// filtered chain and the 32x32 strong-smoothed one, and predicts from the
// per-mode gather tables of ops/intra.py static_tables. RMD predicts the
// 35 modes one after another into shared memory and scores each with the
// 8x8 (4x4 at N = 4) Hadamard SATD against the original; the lowest cost
// wins and ties go to the lowest mode, as jnp.argmin does.
//
// Every block handed to one launch is independent of the others (one
// wavefront level): a block's chain only reads samples of earlier levels,
// or samples that substitution replaces. The schedule packs the real slots
// of a level first and the wrapper launches only those, so no two CTAs
// ever write the same samples.
//
// Bound: integer operations. RMD does about 35 x (N^2 prediction + 2 x N^2 x
// 8 Hadamard multiply-adds) per block and moves only the block's samples, so
// it sits far above the card's bytes-per-operation line. The design keeps
// the chain, the candidate prediction, the original and the Hadamard
// intermediate in shared memory, so device memory sees each input once and
// each output once; the threads of the CTA share the per-pixel work of every
// mode. The blocks of one level are few (a wavefront level of 1080p holds
// some tens), so the card is far from full; the all-intra frame's levels
// run inside one launch of kernel C13 (scan.cu), and C2 serves the level
// loops that remain (the mesh, the ISS and PSS scans).
//
// Analysis entry (analysis_kernel): the dense 35-mode mode analysis of
// hevc_hop_tpu/parallel/mesh.py analysis_costs and analysis_step_sharded
// (_block_chains, predict_all_modes with strong=False, satd, then min and
// argmin), over every n x n block of F frames cut into row bands of
// band_h rows. One CTA per block builds the block's chain from the
// original frame the reference's way: no substitution, mid-grey left of
// column 0, the band's halo row (the row above the band, or mid-grey)
// above its first row, the left column clipped at the band's last row and
// the top row at the frame's last column. It then scores the 35 modes
// against the block as the RMD loop above does and writes the lowest cost
// and the first mode that reaches it. Bound: integer operations, as RMD.
#include "intra.cuh"

namespace {

__global__ void intra_kernel(IntraPlane p, const int32_t *pos,
                             const uint8_t *avail, const int32_t *modes,
                             int aper, int mper, int n, int c_idx,
                             int bit_depth, int strong, Tables t,
                             int32_t *pred_out, int32_t *best_out) {
  extern __shared__ int32_t sm[];
  const int b = blockIdx.x;
  int32_t *pred =
      pred_out != nullptr ? pred_out + (long long)b * n * n : nullptr;
  const int mode = intra_block(p, t, pos[2 * b], pos[2 * b + 1],
                               avail + (long long)(b % aper) * (4 * n + 1),
                               modes[b % mper], n, c_idx, bit_depth, strong,
                               sm, pred);
  if (best_out != nullptr && threadIdx.x == 0) best_out[b] = mode;
}

__global__ void analysis_kernel(const int32_t *frames, const int32_t *halo,
                                int h, int w, int band_h, int n,
                                int bit_depth, Tables t, int32_t *cost_out,
                                int32_t *mode_out) {
  extern __shared__ int32_t sm[];
  const int L = 4 * n + 1, nn = n * n;
  int32_t *cu = sm;            // [L]
  int32_t *cf = cu + L;        // [L]
  int32_t *O = cf + L;         // [nn] original minus candidate
  int32_t *A = O + nn;         // [nn] Hadamard first stage
  int32_t *H = A + nn;         // [64]
  int32_t *tsum = H + 64;      // [16] per-tile sums

  const int tid = threadIdx.x, nt = blockDim.x;
  const int bx = w / n, per_frame = (h / n) * bx;
  const long long blk = blockIdx.x;
  const int f = (int)(blk / per_frame), rem = (int)(blk % per_frame);
  const int px = (rem % bx) * n, py = (rem / bx) * n;
  const int band = py / band_h, y0 = band * band_h;
  const int32_t *fr = frames + (long long)f * h * w;
  const int32_t *top = halo + ((long long)f * (h / band_h) + band) * w;
  const int mid = 1 << (bit_depth - 1);
  // ext coordinates of the reference: row 0 the halo, column 0 mid-grey
  const int ys = py - y0 + 1, xs = px + 1;
  for (int i = tid; i < L; i += nt) {
    int ey, ex;
    if (i < 2 * n) {
      ey = min(ys + 2 * n - 1 - i, band_h);
      ex = xs - 1;
    } else if (i == 2 * n) {
      ey = ys - 1;
      ex = xs - 1;
    } else {
      ey = ys - 1;
      ex = min(xs + i - 2 * n - 1, w);
    }
    cu[i] = ex == 0 ? mid
                    : (ey == 0 ? top[ex - 1]
                               : fr[(long long)(y0 + ey - 1) * w + ex - 1]);
  }
  const int k = n >= 8 ? 8 : 4;
  for (int i = tid; i < k * k; i += nt) H[i] = t.had[i];
  for (int i = tid; i < 16; i += nt) tsum[i] = 0;
  __syncthreads();

  const int use_filter = n > 4;
  if (use_filter) filter_chain(cu, cf, n, bit_depth, 0);
  const Refs r = make_refs(cu, use_filter ? cf : nullptr, n, 0, bit_depth);

  int best_cost = 0x7fffffff, best_mode = 0;  // kept by thread 0
  for (int m = 0; m < 35; ++m) {
    for (int i = tid; i < nn; i += nt) {
      const int x = i % n, y = i / n;
      O[i] = fr[(long long)(py + y) * w + px + x] - predict_px(r, t, m, x, y);
    }
    __syncthreads();
    const int cost = satd_cost(O, A, H, tsum, n);
    if (tid == 0 && cost < best_cost) {
      best_cost = cost;
      best_mode = m;
    }
    __syncthreads();
  }
  if (tid == 0) {
    cost_out[blk] = best_cost;
    mode_out[blk] = best_mode;
  }
}

}  // namespace

// plane [ph, pw] int32 (row stride `stride`): chains are read from it; the
// decode epilogue (resi != null) writes the recon into it. org != null
// selects RMD for blocks whose mode is -1. avail [aper, 4n+1] uint8 and
// modes [mper] int32 are read at row b % aper and b % mper.
HH_EXPORT int hh_intra(void *plane, int ph, int pw, int stride,
                       const void *org, int org_stride, const void *resi,
                       int resi_stride, const void *pos, const void *avail,
                       const void *modes, int aper, int mper, int nblocks,
                       int n, int c_idx, int bit_depth, int strong,
                       const void *ext_idx, const void *pred_idx,
                       const void *fact, const void *is_hor,
                       const void *filt, const void *had, void *pred_out,
                       void *best_out, void *stream) {
  Tables t{static_cast<const int32_t *>(ext_idx),
           static_cast<const int32_t *>(pred_idx),
           static_cast<const int32_t *>(fact),
           static_cast<const int32_t *>(is_hor),
           static_cast<const int32_t *>(filt),
           static_cast<const int32_t *>(had)};
  const int nn = n * n;
  int threads = nn < 32 ? 32 : (nn > 256 ? 256 : nn);
  const size_t smem = sizeof(int32_t) * intra_scratch_words(n);
  const IntraPlane p{static_cast<int32_t *>(plane), ph, pw, stride,
                     static_cast<const int32_t *>(org), org_stride,
                     static_cast<const int32_t *>(resi), resi_stride};
  intra_kernel<<<nblocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const int32_t *>(pos),
      static_cast<const uint8_t *>(avail), static_cast<const int32_t *>(modes),
      aper, mper, n, c_idx, bit_depth, strong, t,
      static_cast<int32_t *>(pred_out), static_cast<int32_t *>(best_out));
  return (int)cudaGetLastError();
}

// frames [nf, h, w] int32 originals; halo [nf, h / band_h, w] int32, the
// row above each band (mid-grey for a frame's first band); band_h a
// multiple of n dividing h. cost_out and mode_out [nf, h / n, w / n].
HH_EXPORT int hh_intra_analysis(const void *frames, const void *halo, int nf,
                                int h, int w, int band_h, int n,
                                int bit_depth, const void *ext_idx,
                                const void *pred_idx, const void *fact,
                                const void *is_hor, const void *filt,
                                const void *had, void *cost_out,
                                void *mode_out, void *stream) {
  Tables t{static_cast<const int32_t *>(ext_idx),
           static_cast<const int32_t *>(pred_idx),
           static_cast<const int32_t *>(fact),
           static_cast<const int32_t *>(is_hor),
           static_cast<const int32_t *>(filt),
           static_cast<const int32_t *>(had)};
  const int nn = n * n;
  const int threads = nn < 32 ? 32 : (nn > 256 ? 256 : nn);
  const size_t smem = sizeof(int32_t) * (2 * (4 * n + 1) + 2 * nn + 64 + 16);
  const unsigned blocks = (unsigned)nf * (unsigned)(h / n) * (unsigned)(w / n);
  analysis_kernel<<<blocks, threads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t *>(frames), static_cast<const int32_t *>(halo),
      h, w, band_h, n, bit_depth, t, static_cast<int32_t *>(cost_out),
      static_cast<int32_t *>(mode_out));
  return (int)cudaGetLastError();
}
