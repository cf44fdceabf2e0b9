// Kernel C3: transform and quantization of a batch of blocks.
//
// Replaces hevc_hop_tpu/ops/transform.py fwd_transform and inv_transform,
// hevc_hop_tpu/ops/quant.py quant, dequant and sbh_adjust (the chain
// _enc_plane_ys runs after prediction, plus the post-scan coefficient
// scatter of scan_encode), and hevc_hop_tpu/models/decoder.py
// _residual_uniform and _residual_mixed.
//
// Encode entry, one CTA per block: resi = org - pred, forward DCT (DST at
// 4x4 luma) with HM's shifts, dead-zone quant or, in its RDOQ arm
// (tq_encode_rdoq_kernel), kernel C7's rdoq_block (rdoq.cuh) on the
// coefficients in shared memory, sign-bit hiding with its RD +-1 move,
// dequant, inverse transform with both 16-bit clamps, and the clipped
// recon. The recon and the int16 levels are written straight into
// their planes at the block's position, and the block's cbf into cbf[b].
// Decode entry, one CTA per block: dequant and inverse transform of the
// levels at the block's position into the residual plane.
//
// Exactness: all transform arithmetic is int32 multiply-add on the CUDA
// cores. The first inverse stage reaches about 9.4e7 > 2^24, so fp32 or
// TF32 tensor cores would round; no integer MMA of the right width exists.
// The quantizer products wrap mod 2^32 exactly as the reference's int32 ones
// do (computed unsigned). SBH's float cost is rounded as the reference's
// compiled scan rounds it: fma(r_new - r_cur, lamc, fma(d_new, d_new,
// -d_cur*d_cur)), with d_cur*d_cur rounded on its own (__fmul_rn). The rate
// proxy's floor(log2(v)) is the reference's float32 one, one low at
// v = 8192 and 32768.
//
// Bound: integer operations. An N x N block does 4 N^3 multiply-adds for
// the four transform stages against 2 N^2 samples in and 2 N^2 out (plus
// int16 levels), which is above the card's bytes-per-operation line for
// N >= 8. The design keeps the block and every intermediate in shared
// memory, so device memory sees each input once and each output once; a
// CTA's threads share the N^2 outputs of each stage.
#include "rdoq.cuh"
#include "tq.cuh"

namespace {

__device__ __forceinline__ int floor_log2_ref(int v) {
  return 31 - __clz(v) - ((v == 8192 || v == 32768) ? 1 : 0);
}

__device__ __forceinline__ float rate(int v) {
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
      const float r_cur = rate(a), r_dec = rate(a - 1), r_inc = rate(a + 1);
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

struct EncArgs {
  const int32_t *org;
  int org_stride;
  const int32_t *pred, *pos, *modes;
  int mper, n, c_idx, bit_depth, maxv;
  int qs, qbits, qoff, dqs, dqsh;
  int sbh, rd;
  float lamc;
  const int32_t *mat, *scan;
  int32_t *recon;
  int recon_stride;
  int16_t *coefp;
  int coef_stride;
  int32_t *cbf;
  RdoqArgs r;
};

template <bool kRdoq>
__device__ void tq_encode_body(const EncArgs &a) {
  extern __shared__ int32_t sm[];
  const int n = a.n, nn = n * n;
  int32_t *M = sm, *R = M + nn, *T = R + nn, *C = T + nn, *Q = C + nn;
  int32_t *any = Q + nn;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int px = a.pos[2 * b], py = a.pos[2 * b + 1];
  const int log2 = 31 - __clz(n);
  const int32_t *pred = a.pred + (long long)b * nn;
  for (int i = tid; i < nn; i += nt) {
    M[i] = a.mat[i];
    R[i] = a.org[(long long)(py + i / n) * a.org_stride + px + i % n] -
           pred[i];
  }
  if (tid == 0) *any = 0;
  __syncthreads();
  // forward: tmp = round(R . M^T, log2 + bd - 9); C = round(M . tmp, log2 + 6)
  stage_cols(M, R, T, n, 0, log2 + a.bit_depth - 9, 0);
  __syncthreads();
  stage_rows(M, T, C, n, 0, log2 + 6, 0);
  __syncthreads();
  const int single = !(log2 == 2 || (log2 == 3 && a.c_idx == 0));
  const int sid = single ? 0 : mdcs_scan_id(a.modes[b % a.mper], n, a.c_idx);
  if constexpr (kRdoq) {
    rdoq_block(C, Q, n, a.c_idx, sid, a.r, reinterpret_cast<char *>(any + 1));
  } else {
    for (int i = tid; i < nn; i += nt) Q[i] = quant1(C[i], a.qs, a.qoff,
                                                     a.qbits);
    __syncthreads();
  }
  if (a.sbh) {
    const int32_t *perm = a.scan + sid * nn;
    for (int g = tid; g < nn / 16; g += nt)
      sbh_group(Q, C, perm, g, a.rd, a.lamc, a.dqs, a.dqsh);
    __syncthreads();
  }
  for (int i = tid; i < nn; i += nt) {
    const int q = Q[i];
    a.coefp[(long long)(py + i / n) * a.coef_stride + px + i % n] =
        (int16_t)q;
    if (q != 0) *any = 1;
    T[i] = dequant1(q, a.dqs, a.dqsh);
  }
  __syncthreads();
  // inverse: e = clip16(round(M^T . D, 7)); r = clip16(round(e . M, 20 - bd))
  stage_rows(M, T, R, n, 1, 7, 1);
  __syncthreads();
  stage_cols(M, R, T, n, 1, 20 - a.bit_depth, 1);
  __syncthreads();
  for (int i = tid; i < nn; i += nt)
    a.recon[(long long)(py + i / n) * a.recon_stride + px + i % n] =
        clip3(0, a.maxv, pred[i] + T[i]);
  if (tid == 0) a.cbf[b] = *any;
}

__global__ void tq_encode_kernel(EncArgs a) { tq_encode_body<false>(a); }

__global__ void tq_encode_rdoq_kernel(EncArgs a) { tq_encode_body<true>(a); }

__global__ void tq_decode_kernel(const int16_t *coefp, int coef_stride,
                                 const int32_t *pos, const int32_t *mat,
                                 int n, int bit_depth, int dqs, int dqsh,
                                 int32_t *out, int out_stride) {
  extern __shared__ int32_t sm[];
  const int nn = n * n;
  int32_t *M = sm, *D = M + nn, *E = D + nn;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int px = pos[2 * b], py = pos[2 * b + 1];
  for (int i = tid; i < nn; i += nt) {
    M[i] = mat[i];
    D[i] = dequant1(
        coefp[(long long)(py + i / n) * coef_stride + px + i % n], dqs,
        dqsh);
  }
  __syncthreads();
  stage_rows(M, D, E, n, 1, 7, 1);
  __syncthreads();
  stage_cols(M, E, D, n, 1, 20 - bit_depth, 1);
  __syncthreads();
  for (int i = tid; i < nn; i += nt)
    out[(long long)(py + i / n) * out_stride + px + i % n] = D[i];
}

int threads_for(int n) {
  const int nn = n * n;
  return nn < 32 ? 32 : (nn > 256 ? 256 : nn);
}

}  // namespace

// Encode entry. org/recon int32 and coefp int16 planes with row strides;
// pred [B, n, n]; pos [B, 2] (x, y); modes [mper], block b reads
// modes[b % mper]; mat [n, n] DCT or DST; scan [3, n*n] scan_raster_index.
// rdoq_args: null for the dead-zone quantizer, else the RDOQ class's
// tables and scalars (launches tq_encode_rdoq_kernel).
HH_EXPORT int hh_tq_encode(const void *org, int org_stride, const void *pred,
                           const void *pos, const void *modes, int mper,
                           int nblocks, int n, int c_idx, int bit_depth,
                           int maxv, int qs, int qbits, int qoff, int dqs,
                           int dqsh, int sbh, int rd, float lamc,
                           const void *mat, const void *scan, void *recon,
                           int recon_stride, void *coefp, int coef_stride,
                           void *cbf, const void *rdoq_args, void *stream) {
  EncArgs a;
  a.org = static_cast<const int32_t *>(org);
  a.org_stride = org_stride;
  a.pred = static_cast<const int32_t *>(pred);
  a.pos = static_cast<const int32_t *>(pos);
  a.modes = static_cast<const int32_t *>(modes);
  a.mper = mper;
  a.n = n;
  a.c_idx = c_idx;
  a.bit_depth = bit_depth;
  a.maxv = maxv;
  a.qs = qs;
  a.qbits = qbits;
  a.qoff = qoff;
  a.dqs = dqs;
  a.dqsh = dqsh;
  a.sbh = sbh;
  a.rd = rd;
  a.lamc = lamc;
  a.mat = static_cast<const int32_t *>(mat);
  a.scan = static_cast<const int32_t *>(scan);
  a.recon = static_cast<int32_t *>(recon);
  a.recon_stride = recon_stride;
  a.coefp = static_cast<int16_t *>(coefp);
  a.coef_stride = coef_stride;
  a.cbf = static_cast<int32_t *>(cbf);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  size_t smem = sizeof(int32_t) * (5 * n * n + 1);
  if (!rdoq_args) {
    tq_encode_kernel<<<nblocks, threads_for(n), smem, st>>>(a);
    return (int)cudaGetLastError();
  }
  a.r = *static_cast<const RdoqArgs *>(rdoq_args);
  smem += rdoq_scratch_bytes(n);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        tq_encode_rdoq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  tq_encode_rdoq_kernel<<<nblocks, threads_for(n), smem, st>>>(a);
  return (int)cudaGetLastError();
}

// Decode entry: levels of coefp (int16) at pos [B, 2] -> residual out.
HH_EXPORT int hh_tq_decode(const void *coefp, int coef_stride,
                           const void *pos, const void *mat, int nblocks,
                           int n, int bit_depth, int dqs, int dqsh, void *out,
                           int out_stride, void *stream) {
  const size_t smem = sizeof(int32_t) * 3 * n * n;
  tq_decode_kernel<<<nblocks, threads_for(n), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t *>(coefp), coef_stride,
      static_cast<const int32_t *>(pos), static_cast<const int32_t *>(mat), n,
      bit_depth, dqs, dqsh, static_cast<int32_t *>(out), out_stride);
  return (int)cudaGetLastError();
}
