// Device functions of the transform and the quantizer shared by kernel C3
// (tq.cu), kernel C5 (partition.cu), kernel C9 (ss_search.cu) and kernel
// C13 (scan.cu): HM's rounding shift, the 16-bit clamp, int32 products that
// wrap as the reference's do, the dead-zone quantizer and the flat
// dequantizer of one coefficient, the two matrix-product stages of the 2-D
// transforms, sign-bit hiding, and C3's whole encode work on one block
// (tq_encode_block, with C7's rdoq_block in its RDOQ arm).
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

// Sign-bit hiding of one 4x4 group g (the reference's sbh_adjust, one
// group per thread). Q: levels, C: pre-quant coefficients (raster).
__device__ void sbh_group(int32_t *Q, const int32_t *C, const int32_t *perm,
                          int g, int rd, float lamc, int dqs, int dqsh) {
  int c[16], p[16];
  int first = 99, last = -1, sum = 0;
  for (int i = 0; i < 16; ++i) {
    p[i] = perm[g * 16 + i];
    c[i] = Q[p[i]];
    if (c[i] != 0) {
      if (first == 99) first = i;
      last = i;
    }
    sum += iabs(c[i]);
  }
  const bool hidden = (last - first) >= 4;
  const bool parity = (sum & 1) == 1;
  const int vfirst = c[first < 15 ? first : 15];
  const bool mism = hidden && (parity != (vfirst < 0));
  if (!mism) return;
  int tgt, delta;
  if (!rd) {
    tgt = last < 0 ? 0 : (last > 15 ? 15 : last);
    delta = -isign(c[tgt]);
  } else {
    int last2 = -1;
    for (int i = 0; i < 16; ++i)
      if (c[i] != 0 && i != last) last2 = i;
    const bool collapse = (last2 - first) < 4;
    const float big = 3e38f;
    float best = 0.f;
    bool best_dec = false;
    tgt = -1;
    for (int i = 0; i < 16; ++i) {
      const int a = iabs(c[i]), s = isign(c[i]), cq = C[p[i]];
      const bool nz = c[i] != 0;
      const float d_cur = (float)(cq - dequant1(c[i], dqs, dqsh));
      const float d_dec = (float)(cq - dequant1(c[i] - s, dqs, dqsh));
      const float d_inc = (float)(cq - dequant1(c[i] + s, dqs, dqsh));
      const float r_cur = sbh_rate(a), r_dec = sbh_rate(a - 1),
                r_inc = sbh_rate(a + 1);
      float cost_dec = sbh_cost(d_dec, d_cur, lamc, r_dec, r_cur);
      float cost_inc = sbh_cost(d_inc, d_cur, lamc, r_inc, r_cur);
      const bool dec_ok =
          nz && !((i == first || (i == last && collapse)) && a == 1);
      if (!dec_ok) cost_dec = big;
      if (!nz) cost_inc = big;
      const bool use_dec = cost_dec <= cost_inc;
      const float cost = fminf(cost_dec, cost_inc);
      if (tgt < 0 || cost < best) {
        best = cost;
        tgt = i;
        best_dec = use_dec;
      }
    }
    const int st = isign(c[tgt]);
    delta = best_dec ? -st : st;
  }
  Q[p[tgt]] = c[tgt] + delta;
}

__device__ __forceinline__ int mdcs_scan_id(int mode, int n, int c_idx) {
  if (!(n == 4 || (n == 8 && c_idx == 0))) return 0;
  if (mode >= 22 && mode <= 30) return 1;
  if (mode >= 6 && mode <= 14) return 2;
  return 0;
}

// One TU class of the encode: the transform, the quantizer's scalars and
// the RDOQ class (read only by the RDOQ arm).
struct TqClass {
  const int32_t *mat;   // [n, n] DCT or DST
  const int32_t *scan;  // [3, n*n] scan_raster_index
  int n, c_idx, bit_depth, maxv;
  int qs, qbits, qoff, dqs, dqsh;
  int sbh, rd;
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

// Shared scratch of tq_encode_block for an n x n block, in bytes.
__host__ __device__ inline size_t tq_scratch_bytes(int n, bool rdoq) {
  return sizeof(int32_t) * (5 * n * n + 1) +
         (rdoq ? rdoq_scratch_bytes(n) : 0);
}

// Kernel C3's encode work on the n x n block at (px, py) whose prediction
// is pred [n*n] (shared or device memory) and whose intra mode (it picks
// the MDCS scan) is `mode`, by every thread of the CTA: resi = org - pred,
// forward DCT (DST at 4x4 luma) with HM's shifts, dead-zone quant or, with
// kRdoq, kernel C7's rdoq_block on the coefficients in shared memory,
// sign-bit hiding with its RD +-1 move, dequant, inverse transform with
// both 16-bit clamps, and the clipped recon. The recon and the int16
// levels go straight into their planes. Returns the cbf, in every thread;
// sm holds tq_scratch_bytes(n, kRdoq). Ends with a barrier. mark
// (common.cuh) is called where the quantizer, SBH and the recon are done.
template <bool kRdoq, class MarkFn = NoMark>
__device__ int tq_encode_block(const TqClass &c, const TqPlanes &pl, int px,
                               int py, int mode, const int32_t *pred,
                               int32_t *sm, const MarkFn &mark = MarkFn()) {
  const int n = c.n, nn = n * n;
  int32_t *M = sm, *R = M + nn, *T = R + nn, *C = T + nn, *Q = C + nn;
  int32_t *any = Q + nn;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int log2 = 31 - __clz(n);
  for (int i = tid; i < nn; i += nt) {
    M[i] = c.mat[i];
    R[i] = pl.org[(long long)(py + i / n) * pl.org_stride + px + i % n] -
           pred[i];
  }
  if (tid == 0) *any = 0;
  __syncthreads();
  // forward: tmp = round(R . M^T, log2 + bd - 9); C = round(M . tmp, log2 + 6)
  stage_cols(M, R, T, n, 0, log2 + c.bit_depth - 9, 0);
  __syncthreads();
  stage_rows(M, T, C, n, 0, log2 + 6, 0);
  __syncthreads();
  const int single = !(log2 == 2 || (log2 == 3 && c.c_idx == 0));
  const int sid = single ? 0 : mdcs_scan_id(mode, n, c.c_idx);
  if constexpr (kRdoq) {
    rdoq_block(C, Q, n, c.c_idx, sid, c.r, reinterpret_cast<char *>(any + 1));
  } else {
    for (int i = tid; i < nn; i += nt) Q[i] = quant1(C[i], c.qs, c.qoff,
                                                     c.qbits);
    __syncthreads();
  }
  mark(kMarkQuant);
  if (c.sbh) {
    const int32_t *perm = c.scan + sid * nn;
    for (int g = tid; g < nn / 16; g += nt)
      sbh_group(Q, C, perm, g, c.rd, c.lamc, c.dqs, c.dqsh);
    __syncthreads();
  }
  mark(kMarkSbh);
  for (int i = tid; i < nn; i += nt) {
    const int q = Q[i];
    pl.coefp[(long long)(py + i / n) * pl.coef_stride + px + i % n] =
        (int16_t)q;
    if (q != 0) *any = 1;
    T[i] = dequant1(q, c.dqs, c.dqsh);
  }
  __syncthreads();
  // inverse: e = clip16(round(M^T . D, 7)); r = clip16(round(e . M, 20 - bd))
  stage_rows(M, T, R, n, 1, 7, 1);
  __syncthreads();
  stage_cols(M, R, T, n, 1, 20 - c.bit_depth, 1);
  __syncthreads();
  for (int i = tid; i < nn; i += nt)
    pl.recon[(long long)(py + i / n) * pl.recon_stride + px + i % n] =
        clip3(0, c.maxv, pred[i] + T[i]);
  const int cbf = *any;
  __syncthreads();
  mark(kMarkRecon);
  return cbf;
}

}  // namespace
