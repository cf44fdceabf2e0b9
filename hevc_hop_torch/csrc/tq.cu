// Kernel C3: transform and quantization of a batch of blocks.
//
// Replaces hevc_hop_tpu/ops/transform.py fwd_transform and inv_transform,
// hevc_hop_tpu/ops/quant.py quant, dequant and sbh_adjust (the chain
// _enc_plane_ys runs after prediction, plus the post-scan coefficient
// scatter of scan_encode), and hevc_hop_tpu/models/decoder.py
// _residual_uniform and _residual_mixed.
//
// Encode entry, one CTA per block, whose work is tq_encode_block (tq.cuh),
// the body that kernel C13 (scan.cu) runs too: resi = org - pred, forward DCT (DST at
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
#include "tq.cuh"

namespace {

struct EncArgs {
  TqClass c;
  TqPlanes pl;
  const int32_t *pred, *pos, *modes;
  int mper;
  int32_t *cbf;
};

template <bool kRdoq>
__device__ void tq_encode_one(const EncArgs &a) {
  extern __shared__ int32_t sm[];
  const int b = blockIdx.x;
  const int cbf = tq_encode_block<kRdoq>(
      a.c, a.pl, a.pos[2 * b], a.pos[2 * b + 1], a.modes[b % a.mper],
      a.pred + (long long)b * a.c.n * a.c.n, sm);
  if (threadIdx.x == 0) a.cbf[b] = cbf;
}

__global__ void tq_encode_kernel(EncArgs a) { tq_encode_one<false>(a); }

__global__ void tq_encode_rdoq_kernel(EncArgs a) { tq_encode_one<true>(a); }

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
  a.c.mat = static_cast<const int32_t *>(mat);
  a.c.scan = static_cast<const int32_t *>(scan);
  a.c.n = n;
  a.c.c_idx = c_idx;
  a.c.bit_depth = bit_depth;
  a.c.maxv = maxv;
  a.c.qs = qs;
  a.c.qbits = qbits;
  a.c.qoff = qoff;
  a.c.dqs = dqs;
  a.c.dqsh = dqsh;
  a.c.sbh = sbh;
  a.c.rd = rd;
  a.c.lamc = lamc;
  a.pl.org = static_cast<const int32_t *>(org);
  a.pl.org_stride = org_stride;
  a.pl.recon = static_cast<int32_t *>(recon);
  a.pl.recon_stride = recon_stride;
  a.pl.coefp = static_cast<int16_t *>(coefp);
  a.pl.coef_stride = coef_stride;
  a.pred = static_cast<const int32_t *>(pred);
  a.pos = static_cast<const int32_t *>(pos);
  a.modes = static_cast<const int32_t *>(modes);
  a.mper = mper;
  a.cbf = static_cast<int32_t *>(cbf);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  size_t smem = tq_scratch_bytes(n, rdoq_args != nullptr);
  if (!rdoq_args) {
    tq_encode_kernel<<<nblocks, threads_for(n), smem, st>>>(a);
    return (int)cudaGetLastError();
  }
  a.c.r = *static_cast<const RdoqArgs *>(rdoq_args);
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
