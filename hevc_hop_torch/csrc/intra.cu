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
// Analysis entry (analysis_kernel<N>): the dense 35-mode mode analysis of
// hevc_hop_tpu/parallel/mesh.py analysis_costs and analysis_step_sharded
// (_block_chains, predict_all_modes with strong=False, satd, then min and
// argmin), over every n x n block of F frames cut into row bands of
// band_h rows. The blocks are independent (their chains come from the
// original frame the reference's way: no substitution, mid-grey left of
// column 0, the band's halo row, or mid-grey, above its first row, the
// left column clipped at the band's last row and the top row at the
// frame's last column), so the mode loop runs in a warp's registers with
// no barrier. Each lane holds one row of K samples of a K x K Hadamard
// tile (K = 8, 4 at n = 4): a warp covers one 16x16 block, four 8x8
// blocks or eight 4x4 ones, and four warps a 32x32 block, a quarter each.
// A CTA of four warps stages the blocks' chains, their 1-2-1 filtered
// chains and the per-mode side-reference table (ops/intra.py
// static_tables' ext_idx, clamped to the chain as the reference's gather
// is) in shared memory once; each lane loads its row of the original and
// its column (for the horizontal modes, which it predicts transposed:
// their fraction is then the lane's own, as the vertical modes' is) into
// registers once. Per mode a lane predicts its K samples from the
// intraPredAngle values, takes the difference, runs the Hadamard's rows as
// butterflies in its registers and its columns as three __shfl_xor_sync
// stages across the tile's lanes (H D H, the reference's product), sums
// the absolute values over the tile by shuffles, normalises them
// ((s + 2) >> 2, (s + 1) >> 1 at 4x4) and sums the tiles; the lowest cost
// is kept in registers, the first mode reaching it winning. At 32x32 each
// warp writes its quarter's 35 costs to shared memory and one barrier
// after the loop lets warp 0 sum and choose. Everything is an integer, so
// every order of the sums is exact. The samples are assumed to lie in
// [0, 2^bit_depth), as an original frame's do. Bound: integer operations,
// as RMD.
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

constexpr int kAnWarps = 4;
__constant__ int kIntraAngle[33] = {32,  26,  21,  17,  13,  9,   5,
                                    2,   0,   -2,  -5,  -9,  -13, -17,
                                    -21, -26, -32, -26, -21, -17, -13,
                                    -9,  -5,  -2,  0,   2,   5,   9,
                                    13,  17,  21,  26,  32};

template <int N>
__global__ void __launch_bounds__(32 * kAnWarps)
    analysis_kernel(const int32_t *frames, const int32_t *halo, int nf,
                    int h, int w, int band_h, int bit_depth,
                    const int32_t *ext_idx, int32_t *cost_out,
                    int32_t *mode_out) {
  constexpr int K = N >= 8 ? 8 : 4;                   // Hadamard tile
  constexpr int GS = N == 4 ? 4 : (N == 8 ? 8 : 32);  // a block's lanes
  constexpr int BPC = N == 32 ? 1 : kAnWarps * 32 / GS;  // blocks a CTA
  constexpr int L = 4 * N + 1, E = 3 * N + 1;
  constexpr int LOG2 = N == 4 ? 2 : (N == 8 ? 3 : (N == 16 ? 4 : 5));
  constexpr int THRESH = N == 4 ? 10 : (N == 8 ? 7 : (N == 16 ? 1 : 0));
  constexpr unsigned kAll = 0xffffffffu;
  __shared__ int32_t s_ch[BPC][2][L];   // chain, filtered chain
  __shared__ int16_t s_ext[33 * E + 1];  // + 1: read at weight 0
  __shared__ int32_t s_cost[kAnWarps][35];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bx = w / N, per_frame = (h / N) * bx;
  const long long total = (long long)nf * per_frame;
  const long long blk0 = (long long)blockIdx.x * BPC;
  const int mid = 1 << (bit_depth - 1), maxv = (1 << bit_depth) - 1;

  for (int i = tid; i < 33 * E; i += blockDim.x)
    s_ext[i] = (int16_t)clip3(0, 4 * N, ext_idx[i]);
  if (tid == 0) s_ext[33 * E] = 0;
  for (int i = tid; i < BPC * L; i += blockDim.x) {
    const int b = i / L, j = i % L;
    const long long blk = min(blk0 + b, total - 1);
    const int f = (int)(blk / per_frame), rem = (int)(blk % per_frame);
    const int px = (rem % bx) * N, py = (rem / bx) * N;
    const int band = py / band_h, y0 = band * band_h;
    // ext coordinates: row 0 the halo, column 0 mid-grey
    const int ys = py - y0 + 1, xs = px + 1;
    int ey, ex;
    if (j < 2 * N) {
      ey = min(ys + 2 * N - 1 - j, band_h);
      ex = xs - 1;
    } else if (j == 2 * N) {
      ey = ys - 1;
      ex = xs - 1;
    } else {
      ey = ys - 1;
      ex = min(xs + j - 2 * N - 1, w);
    }
    s_ch[b][0][j] =
        ex == 0 ? mid
                : (ey == 0 ? halo[((long long)f * (h / band_h) + band) * w +
                                  ex - 1]
                           : frames[((long long)f * h + y0 + ey - 1) * w +
                                    ex - 1]);
  }
  __syncthreads();
  if constexpr (N > 4) {
    for (int i = tid; i < BPC * L; i += blockDim.x) {
      const int b = i / L, j = i % L;
      const int32_t *c = s_ch[b][0];
      s_ch[b][1][j] = (j == 0 || j == L - 1)
                          ? c[j]
                          : (c[j - 1] + 2 * c[j] + c[j + 1] + 2) >> 2;
    }
    __syncthreads();
  }

  // this lane: its block b of the CTA, its tile (tx, ty), its row r
  int b, tx, ty;
  const int r = lane % K;
  if constexpr (N == 32) {
    b = 0;
    tx = 2 * (warp & 1) + ((lane >> 3) & 1);
    ty = 2 * (warp >> 1) + (lane >> 4);
  } else if constexpr (N == 16) {
    b = warp;
    tx = (lane >> 3) & 1;
    ty = lane >> 4;
  } else {
    b = warp * (32 / GS) + lane / GS;
    tx = ty = 0;
  }
  const long long blk = blk0 + b;
  const bool valid = blk < total;
  int org_row[K], org_col[K];
  {
    const long long bb = min(blk, total - 1);
    const int f = (int)(bb / per_frame), rem = (int)(bb % per_frame);
    const int32_t *o = frames + (long long)f * h * w +
                       (long long)((rem / bx) * N + ty * K) * w +
                       (rem % bx) * N + tx * K;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      org_row[i] = o[(long long)r * w + i];
      org_col[i] = o[(long long)i * w + r];
    }
  }
  const int32_t *cu = s_ch[b][0];
  const int32_t *cf = N > 4 ? s_ch[b][1] : cu;
  int dc = 0;
  for (int i = lane % GS; i < N; i += GS) dc += cu[2 * N + 1 + i] +
                                                cu[2 * N - 1 - i];
#pragma unroll
  for (int o = 1; o < GS; o <<= 1) dc += __shfl_xor_sync(kAll, dc, o);
  dc = (dc + N) >> (LOG2 + 1);
  const int corner = cu[2 * N];

  int best = 0x7fffffff, best_mode = 0;
  for (int m = 0; m < 35; ++m) {
    int d[K];
    if (m < 2) {
      // planar and DC, in row form: row y, columns x0 + i
      const int y = ty * K + r, x0 = tx * K;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int x = x0 + i;
        int v;
        if (m == 0) {
          v = ((N - 1 - x) * cf[2 * N - 1 - y] + (x + 1) * cf[3 * N + 1] +
               (N - 1 - y) * cf[2 * N + 1 + x] + (y + 1) * cf[N - 1] + N) >>
              (LOG2 + 1);
        } else {
          v = dc;
          if (N < 32) {
            if (x == 0 && y == 0)
              v = (cu[2 * N - 1] + 2 * dc + cu[2 * N + 1] + 2) >> 2;
            else if (y == 0)
              v = (cu[2 * N + 1 + x] + 3 * dc + 2) >> 2;
            else if (x == 0)
              v = (cu[2 * N - 1 - y] + 3 * dc + 2) >> 2;
          }
        }
        d[i] = org_row[i] - v;
      }
    } else {
      // angular, in vertical form: a vertical mode's row is the lane's
      // row, a horizontal mode's the lane's column
      const int mi = m - 2, ang = kIntraAngle[mi];
      const bool hor = m < 18;
      const int rowv = (hor ? tx : ty) * K + r, col0 = (hor ? ty : tx) * K;
      const int pos = (rowv + 1) * ang, off = pos >> 5, fr = pos & 31;
      const bool filt = N > 4 && min(abs(m - 26), abs(m - 10)) > THRESH;
      const int32_t *ch = filt ? cf : cu;
      const int16_t *ex = s_ext + mi * E + N + 1 + col0 + off;
      int g[K + 1];
#pragma unroll
      for (int i = 0; i <= K; ++i) g[i] = ch[ex[i]];
      int p[K];
#pragma unroll
      for (int i = 0; i < K; ++i)
        p[i] = ((32 - fr) * g[i] + fr * g[i + 1] + 16) >> 5;
      if (N < 32) {
        if (m == 26 && col0 == 0)
          p[0] = clip3(0, maxv, cu[2 * N + 1] +
                                    ((cu[2 * N - 1 - rowv] - corner) >> 1));
        if (m == 10 && col0 == 0)
          p[0] = clip3(0, maxv, cu[2 * N - 1] +
                                    ((cu[2 * N + 1 + rowv] - corner) >> 1));
      }
      if (hor) {
#pragma unroll
        for (int i = 0; i < K; ++i) d[i] = org_col[i] - p[i];
      } else {
#pragma unroll
        for (int i = 0; i < K; ++i) d[i] = org_row[i] - p[i];
      }
    }
    // Hadamard: the rows in registers, the columns across the tile's lanes
#pragma unroll
    for (int s = 1; s < K; s <<= 1)
#pragma unroll
      for (int i = 0; i < K; ++i)
        if (!(i & s)) {
          const int a = d[i], c = d[i + s];
          d[i] = a + c;
          d[i + s] = a - c;
        }
#pragma unroll
    for (int s = 1; s < K; s <<= 1)
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int o = __shfl_xor_sync(kAll, d[i], s);
        d[i] = (r & s) ? o - d[i] : o + d[i];
      }
    int sum = 0;
#pragma unroll
    for (int i = 0; i < K; ++i) sum += abs(d[i]);
#pragma unroll
    for (int s = 1; s < K; s <<= 1) sum += __shfl_xor_sync(kAll, sum, s);
    int cost = K == 8 ? (sum + 2) >> 2 : (sum + 1) >> 1;
    if constexpr (N >= 16) {
      cost += __shfl_xor_sync(kAll, cost, 8);
      cost += __shfl_xor_sync(kAll, cost, 16);
    }
    if constexpr (N == 32) {
      if (lane == 0) s_cost[warp][m] = cost;
    } else if (cost < best) {
      best = cost;
      best_mode = m;
    }
  }
  if constexpr (N == 32) {
    __syncthreads();
    if (warp == 0) {
      unsigned long long key = ~0ull;
      for (int m = lane; m < 35; m += 32) {
        const int c = s_cost[0][m] + s_cost[1][m] + s_cost[2][m] +
                      s_cost[3][m];
        key = min(key, ((unsigned long long)c << 8) | (unsigned)m);
      }
#pragma unroll
      for (int o = 16; o; o >>= 1)
        key = min(key, __shfl_xor_sync(kAll, key, o));
      if (lane == 0 && valid) {
        cost_out[blk] = (int)(key >> 8);
        mode_out[blk] = (int)(key & 255);
      }
    }
  } else if (lane % GS == 0 && valid) {
    cost_out[blk] = best;
    mode_out[blk] = best_mode;
  }
}

template <int N>
int launch_analysis(const int32_t *frames, const int32_t *halo, int nf,
                    int h, int w, int band_h, int bit_depth,
                    const int32_t *ext_idx, int32_t *cost_out,
                    int32_t *mode_out, cudaStream_t st) {
  constexpr int BPC = N == 32 ? 1 : kAnWarps * 32 / (N == 4 ? 4 : N == 8 ? 8
                                                                        : 32);
  const long long total = (long long)nf * (h / N) * (w / N);
  const unsigned blocks = (unsigned)((total + BPC - 1) / BPC);
  analysis_kernel<N><<<blocks, 32 * kAnWarps, 0, st>>>(
      frames, halo, nf, h, w, band_h, bit_depth, ext_idx, cost_out,
      mode_out);
  return (int)cudaGetLastError();
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
// multiple of n dividing h; ext_idx [33, 3n + 1] the side-reference table
// of ops/intra.py static_tables(n). cost_out and mode_out [nf, h / n,
// w / n].
HH_EXPORT int hh_intra_analysis(const void *frames, const void *halo, int nf,
                                int h, int w, int band_h, int n,
                                int bit_depth, const void *ext_idx,
                                void *cost_out, void *mode_out,
                                void *stream) {
  const auto *fr = static_cast<const int32_t *>(frames);
  const auto *ha = static_cast<const int32_t *>(halo);
  const auto *ex = static_cast<const int32_t *>(ext_idx);
  auto *co = static_cast<int32_t *>(cost_out);
  auto *mo = static_cast<int32_t *>(mode_out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 4: return launch_analysis<4>(fr, ha, nf, h, w, band_h, bit_depth,
                                      ex, co, mo, st);
    case 8: return launch_analysis<8>(fr, ha, nf, h, w, band_h, bit_depth,
                                      ex, co, mo, st);
    case 16: return launch_analysis<16>(fr, ha, nf, h, w, band_h, bit_depth,
                                        ex, co, mo, st);
    case 32: return launch_analysis<32>(fr, ha, nf, h, w, band_h, bit_depth,
                                        ex, co, mo, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
