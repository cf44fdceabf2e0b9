// Kernel C3: transform and quantization of a batch of blocks.
//
// Replaces hevc_hop_tpu/ops/transform.py fwd_transform and inv_transform,
// hevc_hop_tpu/ops/quant.py quant, dequant and sbh_adjust (the chain
// _enc_plane_ys runs after prediction, plus the post-scan coefficient
// scatter of scan_encode), and hevc_hop_tpu/models/decoder.py
// _residual_uniform and _residual_mixed.
//
// Encode entry, one CTA of kTqThreads threads per block, whose work is
// tq_encode_block (tq.cuh), the body that kernels C13 (scan.cu) and C14
// (ss_scan.cu) run too: resi = org - pred, forward DCT (DST at 4x4 luma)
// with HM's shifts, dead-zone quant or, in its RDOQ arm
// (tq_encode_rdoq_kernel), kernel C7's rdoq_block (rdoq.cuh) on the
// coefficients in shared memory, sign-bit hiding with its RD +-1 move,
// dequant, inverse transform with both 16-bit clamps, and the clipped
// recon. The recon and the int16 levels are written straight into their
// planes at the block's position, and the block's cbf into cbf[b].
// Decode entry (tq_decode_kernel), one launch per picture: dequant and
// inverse transform of every TU of the three planes into their residual
// planes (see the note above the kernel).
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
// Bound: bytes. HM's partial butterflies take about N^2 / 3 multiply-adds
// a 1-D transform, so an N x N block's four stages do about 4 N^3 / 3
// against some 14 N^2 bytes in and out (chip_smoke.py tq_encode_ops):
// under the card's ten int32 operations a byte at every size. In C13 and
// C14, which code one block a CTA at each level, the body's latency is
// what a frame pays. The design keeps every intermediate in shared memory
// and sets the eight warps of the CTA on every stage, with five barriers a
// block (four where it has no level): the residual, the two transposes of
// the 2-D transforms, the SBH pass's cbf vote and the closing one.
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

__global__ void __launch_bounds__(kTqThreads)
    tq_encode_kernel(const __grid_constant__ EncArgs a) {
  tq_encode_one<false>(a);
}

__global__ void __launch_bounds__(kTqThreads)
    tq_encode_rdoq_kernel(const __grid_constant__ EncArgs a) {
  tq_encode_one<true>(a);
}

// The decode entry: a picture's residual as one launch. The work list is
// every TU of the three planes in classes of one plane and one size, the
// largest size first (32x32 TUs hold a warp longest), within a size luma,
// cb, cr; class c's TUs read their positions from cls[c].pos. A warp takes
// 32 / N TUs of one class, a group of N lanes each, so that every lane is
// busy at every size: it loads the group's int16 levels as 8-byte vectors
// (a plane's rows need only be a multiple of four samples), one warp vote (the last nonzero row and column, by
// __reduce_max_sync) finds the rows and columns that hold a level, and a
// warp whose TUs are all zero writes zeros and is done. Otherwise each
// group dequantizes into its tile in shared memory (row stride N + 1, no
// bank conflicts either way), lane l transforms column l (stage one,
// summing only the rows up to the last nonzero one, then the first
// clamp), and after a __syncwarp lane l transforms row l (stage two,
// summing only the columns up to the last nonzero one) and writes it as
// 16-byte vectors. Both stages are HM's partial butterflies
// (partialButterflyInverseN: the odd rows' dot products, the even rows
// recursively, out[k] = E[k] + O[k], out[N-1-k] = E[k] - O[k]) on the
// matrix in __constant__ memory, int32 throughout: the same integer sums
// as the matrix products, so the result is bit for bit the reference's;
// the 4x4 DST is its direct product. No barrier spans the CTA.
//
// Bound: bytes. A TU moves 2 N^2 bytes of levels in and 4 N^2 of residual
// out for 2 N butterflies, under the card's bytes-per-operation line, and
// at QP 32 most TUs are zero and skip the transform.

// a plane of the picture: its int16 levels, its residual, the dequantizer's
// scale and whether its 4x4 TUs take the DST
struct ResPlane {
  const int16_t *lev;
  int lev_stride;
  int32_t *out;
  int out_stride;
  int dqs, dst;
};
// a class of TUs: one plane, one size; pos [count, 2] (x, y); unit0 the
// first warp of the class
struct ResClass {
  const int32_t *pos;
  int count, plane, log2, unit0;
};
constexpr int kResClasses = 12;
constexpr int kResWarps = 4;
struct ResArgs {
  ResPlane pl[3];
  ResClass cls[kResClasses];
  int ncls, units, bit_depth;
};

// warp `unit` of class c: 32 / N TUs of N x N, a group of N lanes each
template <int N>
__device__ void res_unit(const ResPlane &p, const ResClass &c,
                         int bit_depth, int unit, int32_t *tile) {
  constexpr int G = 32 / N, S = N + 1, VR = N / 4;  // 8-byte vectors a row
  const int lane = threadIdx.x & 31, g = lane / N, l = lane % N;
  const int tu = (unit - c.unit0) * G + g;
  const bool live = tu < c.count;
  int px = 0, py = 0;
  if (live) {
    px = c.pos[2 * tu];
    py = c.pos[2 * tu + 1];
  }
  // the levels: four int16 a vector, the group's vectors l, l + N, ...
  int16_t q[VR][4];
  int rlast = -1, clast = -1;
#pragma unroll
  for (int i = 0; i < VR; ++i) {
    const int v = l + i * N, row = v / VR, c0 = (v % VR) * 4;
    const int2 w = live ? *reinterpret_cast<const int2 *>(
                              p.lev + (long long)(py + row) * p.lev_stride +
                              px + c0)
                        : make_int2(0, 0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int word = e < 2 ? w.x : w.y;
      q[i][e] = (int16_t)(e & 1 ? word >> 16 : word & 0xffff);
      if (q[i][e] != 0) {
        rlast = row;
        clast = max(clast, c0 + e);
      }
    }
  }
  const int R = __reduce_max_sync(0xffffffffu, rlast) + 1;
  const int C = __reduce_max_sync(0xffffffffu, clast) + 1;
  if (R == 0) {
    // every TU of the warp is zero: so is its residual
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const int v = l + i * N, row = v / (N / 4), c0 = (v % (N / 4)) * 4;
      if (live)
        *reinterpret_cast<int4 *>(p.out + (long long)(py + row) *
                                              p.out_stride + px + c0) =
            make_int4(0, 0, 0, 0);
    }
    return;
  }
  int32_t *t = tile + g * N * S;
  const int dqsh = bit_depth + c.log2 - 5;
#pragma unroll
  for (int i = 0; i < VR; ++i) {
    const int v = l + i * N, row = v / VR, c0 = (v % VR) * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      t[row * S + c0 + e] = dequant1(q[i][e], p.dqs, dqsh);
  }
  __syncwarp();
  const bool dst = N == 4 && p.dst;
  int in[N], out[N];
  // stage one: column l, the rows below R are zero
#pragma unroll
  for (int j = 0; j < N; ++j) in[j] = j < R ? t[j * S + l] : 0;
  inv_1d<N>(in, out, R, dst);
#pragma unroll
  for (int k = 0; k < N; ++k) t[k * S + l] = clip16(rshift_round(out[k], 7));
  __syncwarp();
  // stage two: row l, the columns right of C are zero
#pragma unroll
  for (int j = 0; j < N; ++j) in[j] = j < C ? t[l * S + j] : 0;
  inv_1d<N>(in, out, C, dst);
  const int sh = 20 - bit_depth;
  if (live) {
    int32_t *dst_row = p.out + (long long)(py + l) * p.out_stride + px;
#pragma unroll
    for (int k = 0; k < N; k += 4)
      *reinterpret_cast<int4 *>(dst_row + k) =
          make_int4(clip16(rshift_round(out[k], sh)),
                    clip16(rshift_round(out[k + 1], sh)),
                    clip16(rshift_round(out[k + 2], sh)),
                    clip16(rshift_round(out[k + 3], sh)));
  }
}

__global__ void __launch_bounds__(32 * kResWarps)
    tq_decode_kernel(const ResArgs a) {
  __shared__ int32_t tiles[kResWarps][32 * 33];
  const int w = threadIdx.x >> 5;
  const int unit = blockIdx.x * kResWarps + w;
  if (unit >= a.units) return;
  // the warp's class and plane, read with constant indices only
  ResClass c = a.cls[0];
#pragma unroll
  for (int k = 1; k < kResClasses; ++k)
    if (k < a.ncls && a.cls[k].unit0 <= unit) c = a.cls[k];
  const ResPlane p = c.plane == 0 ? a.pl[0] : (c.plane == 1 ? a.pl[1]
                                                             : a.pl[2]);
  switch (c.log2) {
    case 5: res_unit<32>(p, c, a.bit_depth, unit, tiles[w]); break;
    case 4: res_unit<16>(p, c, a.bit_depth, unit, tiles[w]); break;
    case 3: res_unit<8>(p, c, a.bit_depth, unit, tiles[w]); break;
    default: res_unit<4>(p, c, a.bit_depth, unit, tiles[w]); break;
  }
}

}  // namespace

// Encode entry. org/recon int32 and coefp int16 planes with row strides;
// pred [B, n, n]; pos [B, 2] (x, y); modes [mper], block b reads
// modes[b % mper]. rdoq_args: null for the dead-zone quantizer, else the
// RDOQ class's tables and scalars (launches tq_encode_rdoq_kernel).
HH_EXPORT int hh_tq_encode(const void *org, int org_stride, const void *pred,
                           const void *pos, const void *modes, int mper,
                           int nblocks, int n, int c_idx, int bit_depth,
                           int maxv, int qs, int qbits, int qoff, int dqs,
                           int dqsh, int sbh, float lamc, void *recon,
                           int recon_stride, void *coefp, int coef_stride,
                           void *cbf, const void *rdoq_args, void *stream) {
  EncArgs a;
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
    tq_encode_kernel<<<nblocks, kTqThreads, smem, st>>>(a);
    return (int)cudaGetLastError();
  }
  a.c.r = *static_cast<const RdoqArgs *>(rdoq_args);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        tq_encode_rdoq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  tq_encode_rdoq_kernel<<<nblocks, kTqThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// Decode entry: every TU of args' classes (a ResArgs) in one launch.
HH_EXPORT int hh_tq_decode(const void *args, void *stream) {
  const ResArgs a = *static_cast<const ResArgs *>(args);
  if (a.ncls < 1 || a.ncls > kResClasses || a.units < 1)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((a.units + kResWarps - 1) / kResWarps);
  tq_decode_kernel<<<blocks, 32 * kResWarps, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
