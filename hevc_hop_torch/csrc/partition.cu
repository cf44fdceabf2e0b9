// Kernel C5: the partition RD pre-pass and its bottom-up decision.
//
// Replaces hevc_hop_tpu/models/partition.py rd_costs and rd_costs_forced
// (entry hh_partition_rd) and decide, decide_nxn and decide_rqt (entry
// hh_partition_decide).
//
// RD entry, one CTA per n x n block of the ORIGINAL luma plane. The CTA
// gathers the block's 4N+1 reference chain from original samples (a mid-grey
// row and column above and to the left of the picture, coordinates clamped
// at its bottom and right; every sample available, no substitution, never
// the strong smoothing), scores the 35 modes by Hadamard SATD, keeps the
// three lowest (the lower mode first among equals), and codes each through
// residual, DCT (DST at 4x4), quantizer, dequantizer and inverse transform:
// cost = SSE + lambda * (3 + 2 log2(|level| + 1) per nonzero level, and 10
// per coded block or 1 per empty one). The lowest cost wins, the earlier
// candidate on a tie. With a mode given per block (the sub-TU arm of the
// residual quadtree) only that mode is coded. Prediction and SATD are
// kernel C2's device functions (intra.cuh), transform and quantizer are
// kernel C3's (tq.cuh).
//
// Floats, as ops of the plain version in models/partition.py: dist and bits
// are summed by one thread over the samples in raster order, each sum
// rounded (__fadd_rn); dist + lambda * bits is one fmaf, which is what the
// reference's compiled program does; log2f, not __log2f.
//
// Decide entry, one thread per 32x32 CTU: it walks the CTU's 64 + 16 + 4 + 1
// costs bottom-up (NxN against 2Nx2N at 8x8; one CU, one CU with four
// half-size TUs, or four CUs at 16x16 and 32x32) and writes the CTU's cells
// of depth8, mode4 and tulog8. Sums of four costs are ((a + b) + c) + d and
// every sum is rounded on its own.
//
// Bound: integer operations. A block costs 35 predictions and SATDs plus
// three transform round trips against n^2 samples read once, far above the
// card's bytes-per-operation line. Every block of the frame is independent,
// so one launch per size fills the card (130 560 CTAs at n = 4 on
// 1920x1088). The design keeps the chain, the block and every intermediate
// in shared memory; device memory sees each sample once per launch.
#include "intra.cuh"
#include "tq.cuh"

namespace {

struct RdArgs {
  const int32_t *y;
  int h, w, stride;
  const int32_t *modes;  // null: top-3 search
  int n, bit_depth;
  int qs, qbits, qoff, dqs, dqsh;
  float lam;
  Tables t;
  const int32_t *mat;
  float *cost;
  int32_t *mode;
};

constexpr int kTop = 3;

__global__ void partition_rd_kernel(RdArgs a) {
  extern __shared__ int32_t sm[];
  const int n = a.n, nn = n * n, L = 4 * n + 1;
  int32_t *cu = sm;          // [L] chain
  int32_t *cf = cu + L;      // [L] smoothed chain
  int32_t *Y = cf + L;       // [nn] original block
  int32_t *O = Y + nn;       // [nn] original minus prediction
  int32_t *A = O + nn;       // [nn] scratch
  int32_t *C = A + nn;       // [nn] coefficients, then squared errors
  int32_t *E = C + nn;       // [nn] scratch
  int32_t *M = E + nn;       // [nn] transform matrix
  float *F = reinterpret_cast<float *>(M + nn);   // [nn] level-rate terms
  int32_t *H = reinterpret_cast<int32_t *>(F + nn);  // [64]
  int32_t *tsum = H + 64;    // [16]
  int32_t *satd = tsum + 16; // [35]
  int32_t *cand = satd + 35; // [kTop]
  float *G = reinterpret_cast<float *>(C);

  const int tid = threadIdx.x, nt = blockDim.x;
  const int px = blockIdx.x * n, py = blockIdx.y * n;
  const int log2 = 31 - __clz(n);
  const int bd = a.bit_depth;

  for (int i = tid; i < L; i += nt) {
    int x, y;
    if (i < 2 * n) {
      x = px - 1;
      y = py + 2 * n - 1 - i;
    } else if (i == 2 * n) {
      x = px - 1;
      y = py - 1;
    } else {
      x = px + i - 2 * n - 1;
      y = py - 1;
    }
    cu[i] = (x < 0 || y < 0)
                ? 1 << (bd - 1)
                : a.y[(long long)(y < a.h ? y : a.h - 1) * a.stride +
                      (x < a.w ? x : a.w - 1)];
  }
  for (int i = tid; i < nn; i += nt) {
    Y[i] = a.y[(long long)(py + i / n) * a.stride + px + i % n];
    M[i] = a.mat[i];
  }
  const int k = n >= 8 ? 8 : 4;
  for (int i = tid; i < k * k; i += nt) H[i] = a.t.had[i];
  if (tid < 16) tsum[tid] = 0;
  __syncthreads();

  const int use_filter = n > 4;
  if (use_filter) filter_chain(cu, cf, n, bd, 0);
  const Refs r = make_refs(cu, use_filter ? cf : nullptr, n, 0, bd);

  const int given =
      a.modes != nullptr ? a.modes[blockIdx.y * gridDim.x + blockIdx.x] : -1;
  int ncand = 1;
  if (given >= 0) {
    if (tid == 0) cand[0] = given;
  } else {
    ncand = kTop;
    for (int m = 0; m < 35; ++m) {
      for (int i = tid; i < nn; i += nt)
        O[i] = Y[i] - predict_px(r, a.t, m, i % n, i / n);
      __syncthreads();
      const int cost = satd_cost(O, A, H, tsum, n);
      if (tid == 0) satd[m] = cost;
      __syncthreads();
    }
    // the three lowest SATDs: a later mode replaces the best only when
    // strictly lower, so the lower mode comes first among equals
    if (tid == 0) {
      for (int c = 0; c < kTop; ++c) {
        int best = -1;
        for (int m = 0; m < 35; ++m) {
          bool taken = false;
          for (int p = 0; p < c; ++p) taken = taken || cand[p] == m;
          if (!taken && (best < 0 || satd[m] < satd[best])) best = m;
        }
        cand[c] = best;
      }
    }
  }
  __syncthreads();

  float best_cost = 0.f;  // kept by thread 0
  int best_mode = 0;
  for (int c = 0; c < ncand; ++c) {
    const int m = cand[c];
    for (int i = tid; i < nn; i += nt)
      O[i] = Y[i] - predict_px(r, a.t, m, i % n, i / n);
    __syncthreads();
    // forward: tmp = round(R . M^T, log2 + bd - 9); C = round(M . tmp, log2 + 6)
    stage_cols(M, O, A, n, 0, log2 + bd - 9, 0);
    __syncthreads();
    stage_rows(M, A, C, n, 0, log2 + 6, 0);
    __syncthreads();
    int nz = 0;
    for (int i = tid; i < nn; i += nt) {
      const int lev = quant1(C[i], a.qs, a.qoff, a.qbits);
      const int av = iabs(lev);
      nz |= lev != 0;
      F[i] = av > 0 ? __fadd_rn(3.0f, __fmul_rn(2.0f, log2f((float)av + 1.0f)))
                    : 0.0f;
      A[i] = dequant1(lev, a.dqs, a.dqsh);
    }
    const int any = __syncthreads_or(nz);
    // inverse: e = clip16(round(M^T . D, 7)); r = clip16(round(e . M, 20 - bd))
    stage_rows(M, A, E, n, 1, 7, 1);
    __syncthreads();
    stage_cols(M, E, A, n, 1, 20 - bd, 1);
    __syncthreads();
    for (int i = tid; i < nn; i += nt) {
      const float e = (float)(O[i] - A[i]);
      G[i] = __fmul_rn(e, e);
    }
    __syncthreads();
    if (tid == 0) {
      // raster order, one rounded sum after another
      float dist = G[0], bits = F[0];
      for (int i = 1; i < nn; ++i) {
        dist = __fadd_rn(dist, G[i]);
        bits = __fadd_rn(bits, F[i]);
      }
      bits = __fadd_rn(bits, any ? 10.0f : 1.0f);
      const float cost = fmaf(a.lam, bits, dist);
      if (c == 0 || cost < best_cost) {
        best_cost = cost;
        best_mode = m;
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    const long long o = (long long)blockIdx.y * gridDim.x + blockIdx.x;
    a.cost[o] = best_cost;
    a.mode[o] = best_mode;
  }
}

struct DecideArgs {
  const float *rd4, *rd8, *rd16, *rd32, *rd8f16, *rd16f32;
  const int32_t *m4, *m8, *m16, *m32;
  int by, bx;  // CTUs
  float mode_cost, split_cost, nxn_cost, cut_cost;
  int32_t *depth8, *mode4, *tulog8;
};

// ((a00 + a01) + a10) + a11 of the 2x2 cell at (y, x) of a grid w wide
__device__ __forceinline__ float sum4(const float *g, int w, int y, int x) {
  const float *p = g + (long long)(2 * y) * w + 2 * x;
  return __fadd_rn(__fadd_rn(__fadd_rn(p[0], p[1]), p[w]), p[w + 1]);
}

__global__ void partition_decide_kernel(DecideArgs a) {
  const int ctu = blockIdx.x * blockDim.x + threadIdx.x;
  if (ctu >= a.by * a.bx) return;
  const int cy = ctu / a.bx, cx = ctu % a.bx;
  const int w4 = a.bx * 8, w8 = a.bx * 4, w16 = a.bx * 2;
  const bool nxn = a.rd4 != nullptr, rqt = a.rd8f16 != nullptr;

  float best8[16];
  bool take_nxn[4][4];
  for (int j = 0; j < 4; ++j)
    for (int i = 0; i < 4; ++i) {
      const int gy = cy * 4 + j, gx = cx * 4 + i;
      float cu = __fadd_rn(a.rd8[(long long)gy * w8 + gx], a.mode_cost);
      bool take = false;
      if (nxn) {
        const float split = __fadd_rn(sum4(a.rd4, w4, gy, gx), a.nxn_cost);
        take = split < cu;
        cu = fminf(cu, split);
      }
      take_nxn[j][i] = take;
      best8[j * 4 + i] = cu;
    }

  float lvl16[4];
  bool take16[2][2], take16t[2][2];
  for (int j = 0; j < 2; ++j)
    for (int i = 0; i < 2; ++i) {
      const int gy = cy * 2 + j, gx = cx * 2 + i;
      float cu = __fadd_rn(a.rd16[(long long)gy * w16 + gx], a.mode_cost);
      bool tt = false;
      if (rqt) {
        const float cut = __fadd_rn(sum4(a.rd8f16, w8, gy, gx), a.cut_cost);
        tt = cut < cu;
        cu = fminf(cu, cut);
      }
      const float split = __fadd_rn(sum4(best8, 4, j, i), a.split_cost);
      take16[j][i] = cu <= split;
      take16t[j][i] = tt;
      lvl16[j * 2 + i] = take16[j][i] ? cu : split;
    }

  float cu32 = __fadd_rn(a.rd32[ctu], a.mode_cost);
  bool take32t = false;
  if (rqt) {
    const float cut = __fadd_rn(sum4(a.rd16f32, w16, cy, cx), a.cut_cost);
    take32t = cut < cu32;
    cu32 = fminf(cu32, cut);
  }
  const bool take32 = cu32 <= __fadd_rn(sum4(lvl16, 2, 0, 0), a.split_cost);

  for (int j = 0; j < 4; ++j)
    for (int i = 0; i < 4; ++i) {
      const int gy = cy * 4 + j, gx = cx * 4 + i;
      int depth, tulog;
      if (take32) {
        depth = 0;
        tulog = take32t ? 4 : 5;
      } else if (take16[j / 2][i / 2]) {
        depth = 1;
        tulog = take16t[j / 2][i / 2] ? 3 : 4;
      } else {
        depth = take_nxn[j][i] ? 3 : 2;
        tulog = take_nxn[j][i] ? 2 : 3;
      }
      a.depth8[(long long)gy * w8 + gx] = depth;
      a.tulog8[(long long)gy * w8 + gx] = tulog;
      for (int v = 0; v < 2; ++v)
        for (int u = 0; u < 2; ++u) {
          const long long o = (long long)(2 * gy + v) * w4 + 2 * gx + u;
          a.mode4[o] = depth == 0   ? a.m32[ctu]
                       : depth == 1 ? a.m16[(long long)(gy / 2) * w16 + gx / 2]
                       : depth == 3 ? a.m4[o]
                                    : a.m8[(long long)gy * w8 + gx];
        }
    }
}

}  // namespace

// RD entry. y int32 [h, w] (row stride), h and w multiples of n; modes null
// (top-3 search) or int32 [h/n, w/n] (one forced mode per block); the intra
// tables of size n, the k x k Hadamard matrix and the n x n DCT (DST at
// n = 4); cost float32 and mode int32 [h/n, w/n].
HH_EXPORT int hh_partition_rd(const void *y, int h, int w, int stride,
                              const void *modes, int n, int bit_depth, int qs,
                              int qbits, int qoff, int dqs, int dqsh,
                              float lam, const void *ext_idx,
                              const void *pred_idx, const void *fact,
                              const void *is_hor, const void *filt,
                              const void *had, const void *mat, void *cost,
                              void *mode, void *stream) {
  RdArgs a;
  a.y = static_cast<const int32_t *>(y);
  a.h = h;
  a.w = w;
  a.stride = stride;
  a.modes = static_cast<const int32_t *>(modes);
  a.n = n;
  a.bit_depth = bit_depth;
  a.qs = qs;
  a.qbits = qbits;
  a.qoff = qoff;
  a.dqs = dqs;
  a.dqsh = dqsh;
  a.lam = lam;
  a.t = Tables{static_cast<const int32_t *>(ext_idx),
               static_cast<const int32_t *>(pred_idx),
               static_cast<const int32_t *>(fact),
               static_cast<const int32_t *>(is_hor),
               static_cast<const int32_t *>(filt),
               static_cast<const int32_t *>(had)};
  a.mat = static_cast<const int32_t *>(mat);
  a.cost = static_cast<float *>(cost);
  a.mode = static_cast<int32_t *>(mode);
  const int nn = n * n;
  const int threads = nn < 32 ? 32 : (nn > 256 ? 256 : nn);
  const size_t smem =
      sizeof(int32_t) * (2 * (4 * n + 1) + 7 * nn + 64 + 16 + 35 + kTop);
  const dim3 grid(w / n, h / n);
  partition_rd_kernel<<<grid, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Decide entry. Cost grids float32 and mode grids int32 of a picture of
// by x bx CTUs of 32x32: rd4/m4 [8by, 8bx] (null: no NxN arm), rd8/m8
// [4by, 4bx], rd16/m16 [2by, 2bx], rd32/m32 [by, bx], rd8f16 [4by, 4bx] and
// rd16f32 [2by, 2bx] (both null: no TU-split arm). Out: depth8 and tulog8
// [4by, 4bx], mode4 [8by, 8bx] int32.
HH_EXPORT int hh_partition_decide(const void *rd4, const void *rd8,
                                  const void *rd16, const void *rd32,
                                  const void *rd8f16, const void *rd16f32,
                                  const void *m4, const void *m8,
                                  const void *m16, const void *m32, int by,
                                  int bx, float mode_cost, float split_cost,
                                  float nxn_cost, float cut_cost,
                                  void *depth8, void *mode4, void *tulog8,
                                  void *stream) {
  DecideArgs a;
  a.rd4 = static_cast<const float *>(rd4);
  a.rd8 = static_cast<const float *>(rd8);
  a.rd16 = static_cast<const float *>(rd16);
  a.rd32 = static_cast<const float *>(rd32);
  a.rd8f16 = static_cast<const float *>(rd8f16);
  a.rd16f32 = static_cast<const float *>(rd16f32);
  a.m4 = static_cast<const int32_t *>(m4);
  a.m8 = static_cast<const int32_t *>(m8);
  a.m16 = static_cast<const int32_t *>(m16);
  a.m32 = static_cast<const int32_t *>(m32);
  a.by = by;
  a.bx = bx;
  a.mode_cost = mode_cost;
  a.split_cost = split_cost;
  a.nxn_cost = nxn_cost;
  a.cut_cost = cut_cost;
  a.depth8 = static_cast<int32_t *>(depth8);
  a.mode4 = static_cast<int32_t *>(mode4);
  a.tulog8 = static_cast<int32_t *>(tulog8);
  const int threads = 128;
  const int blocks = (by * bx + threads - 1) / threads;
  partition_decide_kernel<<<blocks, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
