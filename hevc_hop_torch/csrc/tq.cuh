// Device functions of the transform and the quantizer shared by kernel C3
// (tq.cu), kernel C5 (partition.cu), kernel C9 (ss_search.cu) and kernels
// C13 (scan.cu) and C14 (ss_scan.cu): HM's rounding shift, the 16-bit
// clamp, int32 products that wrap as the reference's do, the dead-zone
// quantizer and the flat dequantizer of one coefficient, the two
// matrix-product stages of the 2-D transforms (C5's and C9's), the DCT and
// DST tables in __constant__ memory with HM's partial butterflies on them
// (C3's decode entry and its encode body), and C3's whole encode work on
// one block (tq_encode_block, with C7's rdoq_block in its RDOQ arm).
#pragma once

#include "common.cuh"
#include "rdoq.cuh"

namespace {

__device__ __forceinline__ int rshift_round(int x, int shift) {
  return (x + (1 << (shift - 1))) >> shift;
}

__device__ __forceinline__ int clip16(int v) { return clip3(-32768, 32767, v); }

// int32 products that wrap like the reference's
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int dequant1(int level, int dqs, int dqsh) {
  return clip16(wadd(wmul(level, dqs), 1 << (dqsh - 1)) >> dqsh);
}

// HM's dead-zone quantizer of one coefficient (the reference's quant)
__device__ __forceinline__ int quant1(int c, int qs, int qoff, int qbits) {
  const int lev = wadd(wmul(iabs(c), qs), qoff) >> qbits;
  return clip16(wmul(isign(c), lev));
}

// out[k][x] = round(sum_j M[k][j] * X[j][x]) (transpose_m: M[j][k])
__device__ void stage_rows(const int32_t *M, const int32_t *X, int32_t *Y,
                           int n, int transpose_m, int shift, int clamp) {
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
    const int kk = i / n, x = i % n;
    int s = 0;
    for (int j = 0; j < n; ++j)
      s += (transpose_m ? M[j * n + kk] : M[kk * n + j]) * X[j * n + x];
    s = rshift_round(s, shift);
    Y[i] = clamp ? clip16(s) : s;
  }
}

// out[y][k] = round(sum_j X[y][j] * M[k][j]) (transpose_m: M[j][k])
__device__ void stage_cols(const int32_t *M, const int32_t *X, int32_t *Y,
                           int n, int transpose_m, int shift, int clamp) {
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
    const int y = i / n, kk = i % n;
    int s = 0;
    for (int j = 0; j < n; ++j)
      s += X[y * n + j] * (transpose_m ? M[j * n + kk] : M[kk * n + j]);
    s = rshift_round(s, shift);
    Y[i] = clamp ? clip16(s) : s;
  }
}

// The proxy's floor(log2(v)), the reference's float32 one: one low at
// v = 8192 and 32768 (R5).
__device__ __forceinline__ int floor_log2_ref(int v) {
  return 31 - __clz(v) - ((v == 8192 || v == 32768) ? 1 : 0);
}

__device__ __forceinline__ float sbh_rate(int v) {
  return v > 0 ? 1.0f + 2.0f * (float)floor_log2_ref(v) : -1.5f;
}

__device__ __forceinline__ float sbh_cost(float dn, float dc, float lamc,
                                          float rn, float rc) {
  return fmaf(__fsub_rn(rn, rc), lamc, fmaf(dn, dn, -__fmul_rn(dc, dc)));
}


__device__ __forceinline__ int mdcs_scan_id(int mode, int n, int c_idx) {
  if (!(n == 4 || (n == 8 && c_idx == 0))) return 0;
  if (mode >= 22 && mode <= 30) return 1;
  if (mode >= 6 && mode <= 14) return 2;
  return 0;
}

// the 32-point DCT's first 16 columns; row j * 32 / N is the N-point
// matrix's row j, and a butterfly reads only its first N / 2 columns
__constant__ int kDct[32][16] = {
    {64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64, 64},
    {90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4},
    {90, 87, 80, 70, 57, 43, 25, 9, -9, -25, -43, -57, -70, -80, -87, -90},
    {90, 82, 67, 46, 22, -4, -31, -54, -73, -85, -90, -88, -78, -61, -38, -13},
    {89, 75, 50, 18, -18, -50, -75, -89, -89, -75, -50, -18, 18, 50, 75, 89},
    {88, 67, 31, -13, -54, -82, -90, -78, -46, -4, 38, 73, 90, 85, 61, 22},
    {87, 57, 9, -43, -80, -90, -70, -25, 25, 70, 90, 80, 43, -9, -57, -87},
    {85, 46, -13, -67, -90, -73, -22, 38, 82, 88, 54, -4, -61, -90, -78, -31},
    {83, 36, -36, -83, -83, -36, 36, 83, 83, 36, -36, -83, -83, -36, 36, 83},
    {82, 22, -54, -90, -61, 13, 78, 85, 31, -46, -90, -67, 4, 73, 88, 38},
    {80, 9, -70, -87, -25, 57, 90, 43, -43, -90, -57, 25, 87, 70, -9, -80},
    {78, -4, -82, -73, 13, 85, 67, -22, -88, -61, 31, 90, 54, -38, -90, -46},
    {75, -18, -89, -50, 50, 89, 18, -75, -75, 18, 89, 50, -50, -89, -18, 75},
    {73, -31, -90, -22, 78, 67, -38, -90, -13, 82, 61, -46, -88, -4, 85, 54},
    {70, -43, -87, 9, 90, 25, -80, -57, 57, 80, -25, -90, -9, 87, 43, -70},
    {67, -54, -78, 38, 85, -22, -90, 4, 90, 13, -88, -31, 82, 46, -73, -61},
    {64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64, 64, -64, -64, 64},
    {61, -73, -46, 82, 31, -88, -13, 90, -4, -90, 22, 85, -38, -78, 54, 67},
    {57, -80, -25, 90, -9, -87, 43, 70, -70, -43, 87, 9, -90, 25, 80, -57},
    {54, -85, -4, 88, -46, -61, 82, 13, -90, 38, 67, -78, -22, 90, -31, -73},
    {50, -89, 18, 75, -75, -18, 89, -50, -50, 89, -18, -75, 75, 18, -89, 50},
    {46, -90, 38, 54, -90, 31, 61, -88, 22, 67, -85, 13, 73, -82, 4, 78},
    {43, -90, 57, 25, -87, 70, 9, -80, 80, -9, -70, 87, -25, -57, 90, -43},
    {38, -88, 73, -4, -67, 90, -46, -31, 85, -78, 13, 61, -90, 54, 22, -82},
    {36, -83, 83, -36, -36, 83, -83, 36, 36, -83, 83, -36, -36, 83, -83, 36},
    {31, -78, 90, -61, 4, 54, -88, 82, -38, -22, 73, -90, 67, -13, -46, 85},
    {25, -70, 90, -80, 43, 9, -57, 87, -87, 57, -9, -43, 80, -90, 70, -25},
    {22, -61, 85, -90, 73, -38, -4, 46, -78, 90, -82, 54, -13, -31, 67, -88},
    {18, -50, 75, -89, 89, -75, 50, -18, -18, 50, -75, 89, -89, 75, -50, 18},
    {13, -38, 61, -78, 88, -90, 85, -73, 54, -31, 4, 22, -46, 67, -82, 90},
    {9, -25, 43, -57, 70, -80, 87, -90, 90, -87, 80, -70, 57, -43, 25, -9},
    {4, -13, 22, -31, 38, -46, 54, -61, 67, -73, 78, -82, 85, -88, 90, -90},
};
__constant__ int kDst4[4][4] = {{29, 55, 74, 84},
                                {74, 74, 0, -74},
                                {84, -29, -74, 55},
                                {55, -84, 74, -29}};

// One output k of the N-point forward DCT, sum_j M[k][j] x[j], by HM's
// partial butterfly (partialButterflyN): an odd k is the dot product of
// row k's first half with O[j] = x[j] - x[N-1-j]; an even k is output k / 2
// of the N/2-point transform of E[j] = x[j] + x[N-1-j]. int32 sums, equal
// to the matrix product's mod 2^32.
template <int N>
__device__ __forceinline__ int fwd_one(const int (&x)[N], int k) {
  if constexpr (N == 2) {
    return 64 * x[0] + (k ? -64 : 64) * x[1];
  } else {
    constexpr int H = N / 2;
    if (k & 1) {
      int s = 0;
#pragma unroll
      for (int j = 0; j < H; ++j)
        s += kDct[k * (32 / N)][j] * (x[j] - x[N - 1 - j]);
      return s;
    }
    int e[H];
#pragma unroll
    for (int j = 0; j < H; ++j) e[j] = x[j] + x[N - 1 - j];
    return fwd_one<H>(e, k >> 1);
  }
}

// One output k of the N-point inverse DCT, sum_j M[j][k] in[j], by
// partialButterflyInverseN: with kk = min(k, N-1-k), the odd rows' dot
// product O[kk] and E[kk], output kk of the N/2-point inverse of the even
// rows; out[kk] = E + O, out[N-1-kk] = E - O. in[j] is zero for j >= lim,
// and those rows are skipped. The encode body's warps take one to four of
// a transform's N outputs each, so it computes them one at a time; the
// decode entry's lane takes all N and shares E and O among them
// (inv_butterfly below).
template <int N>
__device__ __forceinline__ int inv_one(const int (&in)[N], int k, int lim) {
  if constexpr (N == 2) {
    return 64 * in[0] + (k ? -64 : 64) * in[1];
  } else {
    constexpr int H = N / 2;
    const int kk = k < H ? k : N - 1 - k;
    int ev[H];
#pragma unroll
    for (int j = 0; j < H; ++j) ev[j] = in[2 * j];
    const int e = inv_one<H>(ev, kk, (lim + 1) >> 1);
    int o = 0;
#pragma unroll
    for (int j = 1; j < N; j += 2) {
      if (j >= lim) break;
      o += kDct[j * (32 / N)][kk] * in[j];
    }
    return k < H ? e + o : e - o;
  }
}

// the forward and inverse 1-D transforms' output k, the 4x4 DST as its
// direct product
template <int N>
__device__ __forceinline__ int fwd_out(const int (&x)[N], int k, bool dst) {
  if constexpr (N == 4) {
    if (dst)
      return kDst4[k][0] * x[0] + kDst4[k][1] * x[1] + kDst4[k][2] * x[2] +
             kDst4[k][3] * x[3];
  }
  return fwd_one<N>(x, k);
}

template <int N>
__device__ __forceinline__ int inv_out(const int (&in)[N], int k, int lim,
                                       bool dst) {
  if constexpr (N == 4) {
    if (dst)
      return kDst4[0][k] * in[0] + kDst4[1][k] * in[1] +
             kDst4[2][k] * in[2] + kDst4[3][k] * in[3];
  }
  return inv_one<N>(in, k, lim);
}

// out[k] = sum_j T[j][k] in[j] over the N-point DCT T by the even/odd
// decomposition, every k at once (the decode entry's lane transform); in[j]
// is zero for j >= lim, and those rows are skipped
template <int N>
__device__ __forceinline__ void inv_butterfly(const int (&in)[N],
                                              int (&out)[N], int lim) {
  if constexpr (N == 4) {
    const int e0 = 64 * in[0] + 64 * in[2], e1 = 64 * in[0] - 64 * in[2];
    const int o0 = 83 * in[1] + 36 * in[3], o1 = 36 * in[1] - 83 * in[3];
    out[0] = e0 + o0;
    out[1] = e1 + o1;
    out[2] = e1 - o1;
    out[3] = e0 - o0;
  } else {
    constexpr int H = N / 2;
    int ev[H], e[H], o[H];
#pragma unroll
    for (int j = 0; j < H; ++j) {
      ev[j] = in[2 * j];
      o[j] = 0;
    }
    inv_butterfly<H>(ev, e, (lim + 1) >> 1);
#pragma unroll
    for (int j = 1; j < N; j += 2) {
      if (j >= lim) break;
#pragma unroll
      for (int k = 0; k < H; ++k) o[k] += kDct[j * (32 / N)][k] * in[j];
    }
#pragma unroll
    for (int k = 0; k < H; ++k) {
      out[k] = e[k] + o[k];
      out[N - 1 - k] = e[k] - o[k];
    }
  }
}

template <int N>
__device__ __forceinline__ void inv_1d(const int (&in)[N], int (&out)[N],
                                       int lim, bool dst) {
  if constexpr (N == 4) {
    if (dst) {
#pragma unroll
      for (int k = 0; k < 4; ++k) out[k] = inv_out<4>(in, k, 4, true);
      return;
    }
  }
  inv_butterfly<N>(in, out, lim);
}

// The raster index (y * 4 + x) in a 4x4 coefficient group of its scan
// position i, scan sid (0 up-right diagonal, 1 horizontal, 2 vertical):
// every scan of every size visits each group's 16 positions in the 4x4
// scan's order (hevc_hop_torch/common/rom.py scan_raster_index).
constexpr unsigned long long kDiag4 = 0xfbe7ad369c258140ull;
__device__ __forceinline__ int scan4_pos(int sid, int i) {
  if (sid == 1) return i;
  if (sid == 2) return ((i & 3) << 2) | (i >> 2);
  return (int)((kDiag4 >> (4 * i)) & 15);
}

// One TU class of the encode: the quantizer's scalars and the RDOQ class
// (read only by the RDOQ arm). The transform comes from kDct / kDst4 (the
// DST at 4x4 luma) and the scans from scan4_pos.
struct TqClass {
  int n, c_idx, bit_depth, maxv;
  int qs, qbits, qoff, dqs, dqsh;
  int sbh;
  float lamc;
  RdoqArgs r;
};

// The planes an encoded block reads (org) and writes (recon, int16 levels).
struct TqPlanes {
  const int32_t *org;
  int org_stride;
  int32_t *recon;
  int recon_stride;
  int16_t *coefp;
  int coef_stride;
};

// tq_encode_block's CTA: eight warps, every stage laid out for them.
constexpr int kTqThreads = 256;

// Row stride of the quantizer's coefficient and level tiles: at 16x16 and
// 32x32 N + 8 words, so that the four rows of two neighbouring 4x4 groups
// fall on 32 distinct banks; raster at 4x4 and 8x8, where they do already.
__host__ __device__ constexpr int tq_coef_stride(int n) {
  return n >= 16 ? n + 8 : n;
}

// Row stride of the region that holds the residual tile (stride n + 1),
// then the coefficients, then the prediction's tile.
__host__ __device__ constexpr int tq_x_stride(int n) {
  return n >= 16 ? n + 8 : n + 1;
}

// Shared scratch of tq_encode_block for an n x n block, in bytes: that
// region [n, tq_x_stride]; the transform's tile [n, n + 1]; the levels [n,
// tq_coef_stride]; the last nonzero level's row and column; RDOQ's scratch.
__host__ __device__ inline size_t tq_scratch_bytes(int n, bool rdoq) {
  return sizeof(int32_t) * (n * (tq_x_stride(n) + n + 1 + tq_coef_stride(n)) +
                            2) +
         (rdoq ? rdoq_scratch_bytes(n) : 0);
}

// The SBH pass over the 4x4 groups of the band of rows 4 gr .. 4 gr + 3
// and columns 4 gc0 ..: a group per 16 lanes (lanes 0-15 group gc0 + 2t,
// 16-31 gc0 + 2t + 1, round t of `rounds`; `groups` of them live), lane i
// its scan position i. Q, C: levels and coefficients, row stride sc.
// Sign-bit hiding (the reference's sbh_adjust): the first and last
// nonzero position by a ballot, the parity of the group's sum of |level|
// from a ballot of their low bits, and, where the parity disagrees with
// the first nonzero level's sign, the lowest-cost +-1 move, among equal
// costs the lowest scan position (a shuffle argmin; the serial walk's
// strict <). Then each level goes into the plane; returns whether this
// lane saw a nonzero level and, in *lr and *lc, the last nonzero row and
// column it saw. Every lane of the warp calls it.
__device__ __forceinline__ bool sbh_band(const TqClass &c, const TqPlanes &pl,
                                         int px, int py, int sid, int32_t *Q,
                                         const int32_t *C, int sc, int gr,
                                         int gc0, int rounds, int groups,
                                         int *lr, int *lc) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31, h = lane >> 4, i = lane & 15;
  const unsigned half = 0xffffu << (16 * h);
  const int pos = scan4_pos(sid, i);
  bool any = false;
  for (int t = 0; t < rounds; ++t) {
    const bool live = 2 * t + h < groups;
    const int row = 4 * gr + (pos >> 2), col = 4 * (gc0 + 2 * t + h) +
                                               (pos & 3);
    int q = live ? Q[row * sc + col] : 0;
    if (c.sbh) {
      const unsigned m = (__ballot_sync(kAll, q != 0) & half) >> (16 * h);
      const int first = m ? __ffs(m) - 1 : 99;
      const int last = m ? 31 - __clz(m) : -1;
      const unsigned odd = __ballot_sync(kAll, (iabs(q) & 1) != 0) & half;
      const bool parity = (__popc(odd) & 1) == 1;
      const int vfirst =
          __shfl_sync(kAll, q, 16 * h + (first < 15 ? first : 15));
      const bool mism = (last - first) >= 4 && (parity != (vfirst < 0));
      const unsigned m2 = last >= 0 ? m & ~(1u << last) : 0u;
      const int last2 = m2 ? 31 - __clz(m2) : -1;
      const bool collapse = (last2 - first) < 4;
      const int a = iabs(q), s = isign(q);
      const int cq = live ? C[row * sc + col] : 0;
      const float d_cur = (float)(cq - dequant1(q, c.dqs, c.dqsh));
      const float d_dec = (float)(cq - dequant1(q - s, c.dqs, c.dqsh));
      const float d_inc = (float)(cq - dequant1(q + s, c.dqs, c.dqsh));
      const float r_cur = sbh_rate(a), r_dec = sbh_rate(a - 1),
                  r_inc = sbh_rate(a + 1);
      float cost_dec = sbh_cost(d_dec, d_cur, c.lamc, r_dec, r_cur);
      float cost_inc = sbh_cost(d_inc, d_cur, c.lamc, r_inc, r_cur);
      const bool dec_ok =
          q != 0 && !((i == first || (i == last && collapse)) && a == 1);
      if (!dec_ok) cost_dec = 3e38f;
      if (q == 0) cost_inc = 3e38f;
      const bool use_dec = cost_dec <= cost_inc;
      float bc = fminf(cost_dec, cost_inc);
      int tgt = i;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {
        const float oc = __shfl_xor_sync(kAll, bc, o);
        const int oi = __shfl_xor_sync(kAll, tgt, o);
        if (oc < bc || (oc == bc && oi < tgt)) {
          bc = oc;
          tgt = oi;
        }
      }
      const bool dec = __shfl_sync(kAll, (int)use_dec, 16 * h + tgt) != 0;
      const int st = isign(__shfl_sync(kAll, q, 16 * h + tgt));
      if (mism && i == tgt && live) {
        q += dec ? -st : st;
        Q[row * sc + col] = q;
      }
    }
    if (live) {
      pl.coefp[(long long)(py + row) * pl.coef_stride + px + col] =
          (int16_t)q;
      if (q != 0) {
        any = true;
        *lr = max(*lr, row);
        *lc = max(*lc, col);
      }
    }
  }
  return any;
}

// Kernel C3's encode work on one N x N block (see tq_encode_block), by the
// kTqThreads threads of the CTA. Each 1-D transform is HM's partial
// butterfly on the tables in __constant__ memory, every coefficient index
// the same in all lanes of a warp (a constant read broadcasts); a tile read
// along its columns has a row stride of N + 1 words (no bank conflicts
// either way).
//  1. resi = org - pred into the tile X; a barrier.
//  2. Forward rows: lane y transforms row y, warp w its outputs w * K ..
//     (K = N / 8, one at 4x4 and 8x8), round(., log2 + bd - 9) into T; a
//     barrier.
//  3. Forward columns: warp w takes the band of rows 4 b .. 4 b + 3 (b = w
//     at 32x32; w / 2 at 16x16, the band's columns split between two
//     warps), a lane a column and the band's four outputs; at 8x8 and 4x4
//     four lanes a column, one output each. round(., log2 + 6) is C; the
//     dead-zone quantizer gives the level Q in the same epilogue. With
//     kRdoq, C7's rdoq_block on C instead (raster C and Q, its barriers).
//  4. SBH (sbh_band) on the warp's own groups, after a __syncwarp: the
//     band's groups, a group per 16 lanes, two at a time. The levels go
//     into the plane there; the cbf, the last nonzero row and column by
//     __syncthreads_or and shared atomics: a barrier. A block with no level
//     writes its recon, clip3(0, maxv, pred), and is done.
//  5. Inverse columns: lane x dequantizes column x of Q as it loads it
//     (rows up to the last nonzero one), warp w its outputs (at 32x32 w,
//     31 - w, 15 - w, 16 + w, a butterfly's two pairs), clip16(round(., 7))
//     into T; the prediction into X; a barrier.
//  6. Inverse rows: lane y transforms row y (columns up to the last nonzero
//     one), warp w its outputs w * K .., clip16(round(., 20 - bd)), adds
//     the prediction and writes clip3(0, maxv, .) into the plane, as one
//     vector store where the plane's base and stride allow; a barrier.
template <int N, bool kRdoq, class MarkFn>
__device__ __forceinline__ int tq_block_n(const TqClass &c,
                                          const TqPlanes &pl, int px, int py,
                                          int mode, const int32_t *pred,
                                          int32_t *sm, const MarkFn &mark) {
  constexpr int NN = N * N, P = N + 1, S = tq_coef_stride(N);
  constexpr int SC = kRdoq ? N : S;   // C's and Q's stride: RDOQ's raster
  constexpr int K = N >= 8 ? N / 8 : 1;   // outputs a warp in a row stage
  constexpr int LOG2 = N == 4 ? 2 : N == 8 ? 3 : N == 16 ? 4 : 5;
  int32_t *X = sm;            // residual, then C, then the prediction
  int32_t *T = X + N * tq_x_stride(N);   // the transform's tile
  int32_t *Q = T + N * P;     // levels
  int *last_rc = Q + N * S;   // the last nonzero level's row and column
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool dst = N == 4 && c.c_idx == 0;
  // 1. the residual
  for (int i = tid; i < NN; i += kTqThreads) {
    const int y = i / N, x = i % N;
    X[y * P + x] =
        pl.org[(long long)(py + y) * pl.org_stride + px + x] - pred[i];
  }
  if (tid < 2) last_rc[tid] = -1;
  __syncthreads();
  // 2. forward rows
  if (lane < N && warp * K < N) {
    int x[N];
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = X[lane * P + j];
    const int sh = LOG2 + c.bit_depth - 9;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int k = warp * K + q;
      T[lane * P + k] = rshift_round(fwd_out<N>(x, k, dst), sh);
    }
  }
  __syncthreads();
  // 3. forward columns: this lane's band b, column x, kept rows [r0, r1)
  int b, col, r0, r1;
  bool on;
  if constexpr (N == 32) {
    b = warp, col = lane, r0 = 0, r1 = 4, on = true;
  } else if constexpr (N == 16) {
    b = warp >> 1, col = 8 * (warp & 1) + (lane & 7), r0 = 0, r1 = 4;
    on = lane < 8;
  } else {
    b = warp, col = lane % N, r0 = lane / N, r1 = r0 + 1;
    on = warp < N / 4 && lane < 4 * N;
  }
  int32_t *Cf = X;
  if (on) {
    int x[N];
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = T[j * P + col];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = 4 * b + r;
      const int v = rshift_round(fwd_out<N>(x, k, dst), LOG2 + 6);
      if (r >= r0 && r < r1) {
        Cf[k * SC + col] = v;
        if constexpr (!kRdoq) Q[k * SC + col] = quant1(v, c.qs, c.qoff,
                                                      c.qbits);
      }
    }
  }
  mark(kMarkFwd);
  const int single = !(LOG2 == 2 || (LOG2 == 3 && c.c_idx == 0));
  const int sid = single ? 0 : mdcs_scan_id(mode, N, c.c_idx);
  if constexpr (kRdoq)
    rdoq_block(Cf, Q, N, c.c_idx, sid, c.r,
               reinterpret_cast<char *>(last_rc + 2));
  else
    __syncwarp();
  mark(kMarkQuant);
  // 4. SBH on the warp's groups, the levels out, the votes
  bool any = false;
  int lr = -1, lc = -1;
  if (warp < (N >= 16 ? 8 : N / 4)) {
    constexpr int G = N == 32 ? 8 : (N == 4 ? 1 : 2);   // groups a warp
    const int gc0 = N == 16 ? 2 * (warp & 1) : 0;
    any = sbh_band(c, pl, px, py, sid, Q, Cf, SC, b, gc0, (G + 1) / 2, G,
                   &lr, &lc);
    lr = __reduce_max_sync(0xffffffffu, lr);
    lc = __reduce_max_sync(0xffffffffu, lc);
    if (lane == 0 && lr >= 0) {
      atomicMax(&last_rc[0], lr);
      atomicMax(&last_rc[1], lc);
    }
  }
  const int cbf = __syncthreads_or(any);
  mark(kMarkSbh);
  if (!cbf) {
    for (int i = tid; i < NN; i += kTqThreads)
      pl.recon[(long long)(py + i / N) * pl.recon_stride + px + i % N] =
          clip3(0, c.maxv, pred[i]);
    __syncthreads();
    mark(kMarkRecon);
    return 0;
  }
  const int rows = last_rc[0] + 1, cols = last_rc[1] + 1;
  // 5. inverse columns; the prediction into X
  for (int i = tid; i < NN; i += kTqThreads) X[(i / N) * P + i % N] = pred[i];
  if (lane < N && warp * K < N) {
    int in[N];
#pragma unroll
    for (int j = 0; j < N; ++j)
      in[j] = j < rows ? dequant1(Q[j * SC + lane], c.dqs, c.dqsh) : 0;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      // at 32x32 and 16x16 the outputs w, N-1-w, (15-w, 16+w): shared terms
      const int k = q == 0 ? warp : q == 1 ? N - 1 - warp
                  : q == 2 ? N / 2 - 1 - warp : N / 2 + warp;
      T[k * P + lane] = clip16(rshift_round(inv_out<N>(in, k, rows, dst), 7));
    }
  }
  __syncthreads();
  // 6. inverse rows and the recon
  if (lane < N && warp * K < N) {
    int in[N];
#pragma unroll
    for (int j = 0; j < N; ++j) in[j] = j < cols ? T[lane * P + j] : 0;
    const int sh = 20 - c.bit_depth;
    int v[K];
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int k = warp * K + q;
      v[q] = clip3(0, c.maxv,
                   X[lane * P + k] +
                       clip16(rshift_round(inv_out<N>(in, k, cols, dst), sh)));
    }
    int32_t *out = pl.recon + (long long)(py + lane) * pl.recon_stride + px +
                   warp * K;
    const bool vec = (reinterpret_cast<uintptr_t>(pl.recon) % (4 * K)) ==
                         0 && pl.recon_stride % K == 0 && px % K == 0;
    if constexpr (K == 4) {
      if (vec) {
        *reinterpret_cast<int4 *>(out) = make_int4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int q = 0; q < K; ++q) out[q] = v[q];
      }
    } else if constexpr (K == 2) {
      if (vec) {
        *reinterpret_cast<int2 *>(out) = make_int2(v[0], v[1]);
      } else {
        out[0] = v[0];
        out[1] = v[1];
      }
    } else {
      out[0] = v[0];
    }
  }
  __syncthreads();
  mark(kMarkRecon);
  return cbf;
}

// Kernel C3's encode work on the n x n block at (px, py) whose prediction
// is pred [n*n] (shared or device memory) and whose intra mode (it picks
// the MDCS scan) is `mode`, by the kTqThreads threads of the CTA: resi =
// org - pred, forward DCT (DST at 4x4 luma) with HM's shifts, dead-zone
// quant or, with kRdoq, kernel C7's rdoq_block on the coefficients in
// shared memory, sign-bit hiding with its RD +-1 move, dequant, inverse
// transform with both 16-bit clamps, and the clipped recon (tq_block_n).
// The recon and the int16 levels go straight into their planes. Returns
// the cbf, in every thread; sm holds tq_scratch_bytes(n, kRdoq). Ends with
// a barrier. mark (common.cuh) is called where the forward transform, the
// quantizer, SBH and the recon are done (without RDOQ the quantizer runs
// in the forward transform's epilogue). A call, not inlined: inlined at
// C13's three call sites it took 255 registers there, and inlined at
// C14's two, 220 to 276 bytes of spills against 12 (ptxas); called, C13
// and C14 stay within 128 registers (two CTAs an SM). c and
// pl may point into kernel parameters only where those are
// __grid_constant__ (C13's, C3's entry), else the compiler copies the whole
// parameter block to local memory.
template <bool kRdoq, class MarkFn = NoMark>
__device__ __noinline__ int tq_encode_block(const TqClass &c,
                                            const TqPlanes &pl, int px,
                                            int py, int mode,
                                            const int32_t *pred, int32_t *sm,
                                            const MarkFn &mark = MarkFn()) {
  switch (c.n) {
    case 4: return tq_block_n<4, kRdoq>(c, pl, px, py, mode, pred, sm, mark);
    case 8: return tq_block_n<8, kRdoq>(c, pl, px, py, mode, pred, sm, mark);
    case 16:
      return tq_block_n<16, kRdoq>(c, pl, px, py, mode, pred, sm, mark);
    default:
      return tq_block_n<32, kRdoq>(c, pl, px, py, mode, pred, sm, mark);
  }
}

}  // namespace
