// Kernel C9: the self-similarity and temporal full searches, in the scan
// and in the quadtree pre-pass.
//
// Replaces hevc_hop_tpu/models/ss_scan.py _ss_search (with its GT anchor
// ring, :266-288), _t_search (:301), _dyn_rate_map and _mvd_bits (scan
// entry, hh_ss_search), and hevc_hop_tpu/models/ss_partition.py
// _ss_rd_size, its SS arm and its temporal one (pre-pass entry, hh_ss_rd).
//
// One CTA per block. The CTA stages the clamped (n+2r)^2 search window of
// the recon (the original plane in the pre-pass) and the block's original
// in shared memory as float32, and gathers the block's AMVP predictors from
// the carried motion planes (ss_common.cuh gather_cands; the pre-pass takes
// the four static ones). Each thread then takes displacements in row-major
// (dy, dx) order: a displacement outside the picture, or whose window with
// the interpolation margin reaches a sample not yet decoded, costs 3e38;
// otherwise the SSE is org^2 + ref^2 - 2 corr and the cost SSE + lambda *
// (6 + the least MVD bits over the predictors). The least cost wins, the
// first in row-major order among equals (jnp.argmin's rule), through one
// per-thread pass and a CTA reduction. The entry writes the MV, the cost,
// the SSE (3e38 when no displacement was causal) and the full-pel
// prediction. With the GT on, the same pass keeps a second least cost, over
// the displacements whose 2n GT window plus 2 samples of slack is in the
// picture and causal (zmax2n), with the same tie rule (the reference's
// lax.top_k with k = 1): the anchor ring, written as the anchor, its rate
// and whether one was found. On a PSS picture the scan entry's grid has a
// second row of CTAs, one per block again, that run the temporal search:
// the same code over the previous picture's window with radius radius_t,
// every displacement inside the picture valid (no causal test), with the
// temporal predictors (the neighbours that name the temporal reference,
// and zero); its own outputs. The pre-pass entry goes on with the
// dead-zone transform round trip of the residual (tq.cuh, kernel C3's
// device functions) and writes SSE + lambda * level bits + the search's
// rate; on a PSS picture it first runs the temporal search over the
// previous luma with the zero predictor, and takes its residual and rate
// where its cost is lower.
//
// Floats: the reference's SSE map is float32 from XLA:CPU's convolution,
// whose sums this kernel repeats in the same order (ROADMAP.md F8): over the
// kernel in row-major order in blocks of 512 products, two accumulators per
// block (even and odd products), added at the block's end, blocks added in
// order; org^2 in ss_common.cuh block_sum's order. The PSS program compiles
// both searches' sums otherwise (ROADMAP.md F10): over the kernel in
// row-major order, one rounded add after another (Search::seq; the scan
// entry's PSS launches). The rate lambda * (6 + bits) is rounded on its own
// and then added, as in the reference. For 8-bit samples and n <= 16 every
// sum is exact.
//
// Bound: float32 operations, 2 n^2 (2r+1)^2 multiply-adds per block for the
// correlation and ref^2 against (n+2r)^2 + n^2 samples: far above the
// card's bytes-per-operation line. The design keeps the window in shared
// memory, so device memory sees each sample of it once per block; threads
// of a warp take neighbouring dx, so their shared-memory reads fall in
// distinct banks. Tensor-core correlation is later work.
#include "ss_common.cuh"
#include "tq.cuh"

namespace {

constexpr int kConvBlock = 512;
constexpr int kThreads = 256;

struct Search {
  const int32_t *src;  // searched plane (recon, original, previous picture)
  const int32_t *org;  // original plane
  int stride;
  const int32_t *zmaxw;   // causality plane; null: the temporal search
  int n, radius, w, h;
  float lam;
  const int32_t *zmax2n;  // the GT window's causality plane, or null
  int seq;                // the PSS program's sequential sums (F10)
};

struct Best {
  int mvx, mvy;
  float cost, sse;
  int amvx, amvy, aok;  // the GT anchor ring (with zmax2n)
  float arate;
};

// Shared-memory words of the search (block original + reduction + window)
__host__ __device__ __forceinline__ int search_words(int n, int radius) {
  const int W = n + 2 * radius;
  return n * n + 5 * kThreads + W * W;
}


// The masked full search of the block at (px, py) over the CTA. sm holds
// search_words(n, r) words: of [nn] float, reduction [5 * nt], window
// [W * W] float. Returns the winner to every thread.
__device__ Best search_block(const Search &s, int px, int py, int zcur,
                             const int *preds, int np, float *sm) {
  const int n = s.n, r = s.radius, nn = n * n, W = n + 2 * r, D = 2 * r + 1;
  const int tid = threadIdx.x, nt = blockDim.x;
  float *of = sm;
  float *red_cost = of + nn;
  int *red_idx = reinterpret_cast<int *>(red_cost + kThreads);
  float *red_sse = reinterpret_cast<float *>(red_idx + kThreads);
  float *red_cost2 = red_sse + kThreads;
  int *red_idx2 = reinterpret_cast<int *>(red_cost2 + kThreads);
  float *win = reinterpret_cast<float *>(red_idx2 + kThreads);
  __shared__ float org2_s;
  for (int i = tid; i < W * W; i += nt) {
    const int y = clip3(0, s.h - 1, py - r + i / W);
    const int x = clip3(0, s.w - 1, px - r + i % W);
    win[i] = (float)s.src[(long long)y * s.stride + x];
  }
  for (int i = tid; i < nn; i += nt)
    of[i] = (float)s.org[(long long)(py + i / n) * s.stride + px + i % n];
  __syncthreads();
  if (tid == 0)
    org2_s = block_sum(n, [&](int i) { return __fmul_rn(of[i], of[i]); });
  __syncthreads();
  const float org2 = org2_s;
  const int rows_per_block = kConvBlock / n < n ? kConvBlock / n : n;
  float bc = kBig, bs = 0.0f, bc2 = kBig;
  int bi = D * D, bi2 = D * D;
  for (int d = tid; d < D * D; d += nt) {
    const int dy = d / D, dx = d % D;
    const int ty = py + dy - r, tx = px + dx - r;
    if (s.zmaxw != nullptr ? !causal(s.zmaxw, tx, ty, n, s.w, s.h, zcur)
                           : !in_picture(tx, ty, n, s.w, s.h)) {
      if (bi == D * D) bi = d;   // a masked first entry, as argmin sees it
      continue;
    }
    float corr = 0.0f, ref2 = 0.0f;
    // F10: one accumulator over the whole kernel (the products are exact,
    // so each fmaf is the rounded add)
    for (int ky = 0; s.seq && ky < n; ++ky) {
      const float *wr = win + (dy + ky) * W + dx;
      const float *orow = of + ky * n;
      for (int kx = 0; kx < n; ++kx) {
        corr = fmaf(wr[kx], orow[kx], corr);
        ref2 = fmaf(wr[kx], wr[kx], ref2);
      }
    }
    for (int y0 = 0; !s.seq && y0 < n; y0 += rows_per_block) {
      float c0 = 0.0f, c1 = 0.0f, q0 = 0.0f, q1 = 0.0f;
      for (int ky = y0; ky < y0 + rows_per_block; ++ky) {
        const float *wr = win + (dy + ky) * W + dx;
        const float *orow = of + ky * n;
        for (int kx = 0; kx < n; kx += 2) {
          const float w0 = wr[kx], w1 = wr[kx + 1];
          c0 = fmaf(w0, orow[kx], c0);
          c1 = fmaf(w1, orow[kx + 1], c1);
          q0 = fmaf(w0, w0, q0);
          q1 = fmaf(w1, w1, q1);
        }
      }
      const float cs = __fadd_rn(c0, c1), qs = __fadd_rn(q0, q1);
      corr = y0 == 0 ? cs : __fadd_rn(corr, cs);
      ref2 = y0 == 0 ? qs : __fadd_rn(ref2, qs);
    }
    const float sse = __fsub_rn(__fadd_rn(org2, ref2), __fmul_rn(2.0f, corr));
    const float bits = min_rate_bits(4 * (dx - r), 4 * (dy - r), preds, np);
    // the rate map is rounded on its own, then added (the reference's
    // compiled search)
    const float cost =
        __fadd_rn(sse, __fmul_rn(s.lam, __fadd_rn(bits, kInterBits)));
    if (cost < bc || (cost == bc && d < bi)) {
      bc = cost;
      bi = d;
      bs = sse;
    }
    if (s.zmax2n != nullptr &&
        anchor_causal(s.zmax2n, tx, ty, n, s.w, s.h, zcur) &&
        (cost < bc2 || (cost == bc2 && d < bi2))) {
      bc2 = cost;
      bi2 = d;
    }
  }
  red_cost[tid] = bc;
  red_idx[tid] = bi;
  red_sse[tid] = bs;
  red_cost2[tid] = bc2;
  red_idx2[tid] = bi2;
  __syncthreads();
  __shared__ Best best_s;
  if (tid == 0) {
    float c = red_cost[0], e = red_sse[0];
    int i = red_idx[0];
    for (int t = 1; t < nt; ++t)
      if (red_cost[t] < c || (red_cost[t] == c && red_idx[t] < i)) {
        c = red_cost[t];
        i = red_idx[t];
        e = red_sse[t];
      }
    if (i >= D * D) i = 0;   // nothing causal: argmin of all-3e38 is 0
    best_s.mvx = i % D - r;
    best_s.mvy = i / D - r;
    best_s.cost = c;
    best_s.sse = c < 1e37f ? e : kBig;
    if (s.zmax2n != nullptr) {
      float c2 = red_cost2[0];
      int i2 = red_idx2[0];
      for (int t = 1; t < nt; ++t)
        if (red_cost2[t] < c2 || (red_cost2[t] == c2 && red_idx2[t] < i2)) {
          c2 = red_cost2[t];
          i2 = red_idx2[t];
        }
      if (i2 >= D * D) i2 = 0;   // no causal GT window: top_k's index 0
      best_s.amvx = i2 % D - r;
      best_s.amvy = i2 / D - r;
      best_s.aok = c2 < 1e37f;
      best_s.arate = __fmul_rn(
          s.lam, __fadd_rn(min_rate_bits(4 * best_s.amvx, 4 * best_s.amvy,
                                         preds, np),
                           kInterBits));
    }
  }
  __syncthreads();
  return best_s;
}

struct Found {
  int32_t *mv, *pred;
  float *cost, *sse;
};

__global__ void ss_search_kernel(Search s, Search st, const int32_t *pos,
                                 const int32_t *zcur, Motion m,
                                 const uint8_t *nbav, const uint8_t *miav,
                                 int mi_size, int ss_idx, Found f,
                                 Found ft, int32_t *anchor, float *gt_rate,
                                 uint8_t *gt_ok) {
  extern __shared__ float sm[];
  const int b = blockIdx.x;
  const bool temporal = blockIdx.y == 1;
  const Search &q = temporal ? st : s;
  const Found &o = temporal ? ft : f;
  const int px = pos[2 * b], py = pos[2 * b + 1];
  __shared__ Cands c;
  if (threadIdx.x == 0)
    gather_cands(m, px, py, q.n, nbav + 5 * b, miav + 3 * b, mi_size, ss_idx,
                 c);
  __syncthreads();
  const Best best =
      temporal ? search_block(q, px, py, 0, &c.tpreds[0][0], 3, sm)
               : search_block(q, px, py, zcur[b], &c.preds[0][0], 6, sm);
  const int n = q.n, W = n + 2 * q.radius;
  const float *win = sm + search_words(n, q.radius) - W * W;
  for (int i = threadIdx.x; i < n * n; i += blockDim.x)
    o.pred[(long long)b * n * n + i] =
        (int32_t)win[(best.mvy + q.radius + i / n) * W + best.mvx + q.radius +
                     i % n];
  if (threadIdx.x == 0) {
    o.mv[2 * b] = best.mvx;
    o.mv[2 * b + 1] = best.mvy;
    o.cost[b] = best.cost;
    o.sse[b] = best.sse;
    if (q.zmax2n != nullptr) {
      anchor[2 * b] = best.amvx;
      anchor[2 * b + 1] = best.amvy;
      gt_rate[b] = best.arate;
      gt_ok[b] = best.aok;
    }
  }
}

struct Tq {
  const int32_t *mat;
  int bit_depth, qs, qbits, qoff, dqs, dqsh;
};

__global__ void ss_rd_kernel(Search s, Search st, const int32_t *pos,
                             const int32_t *zcur, int4 mi, Tq q,
                             float *cost) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int n = s.n, nn = n * n;
  const int rmax = st.src != nullptr && st.radius > s.radius ? st.radius
                                                             : s.radius;
  const int px = pos[2 * b], py = pos[2 * b + 1];
  const int preds[8] = {0, 0, mi.x, 0, 0, mi.y, mi.z, mi.w};
  Best best = search_block(s, px, py, zcur[b], preds, 4, sm);
  // the residual (the original sits at the start of sm), then the transform
  // round trip, past the larger search's words
  int32_t *O = reinterpret_cast<int32_t *>(sm + search_words(n, rmax));
  auto residual = [&](const Search &p, const Best &bb) {
    const int W = n + 2 * p.radius;
    const float *win = sm + search_words(n, p.radius) - W * W;
    for (int i = tid; i < nn; i += nt)
      O[i] = (int32_t)sm[i] - (int32_t)win[(bb.mvy + p.radius + i / n) * W +
                                           bb.mvx + p.radius + i % n];
    __syncthreads();
  };
  residual(s, best);
  float valid = best.cost;
  if (st.src != nullptr) {
    const int zero[2] = {0, 0};
    const Best tb = search_block(st, px, py, 0, zero, 1, sm);
    valid = fminf(best.cost, tb.cost);
    if (tb.cost < best.cost) {
      residual(st, tb);
      best = tb;
    }
  }
  int32_t *A = O + nn, *C = A + nn, *E = C + nn, *M = E + nn;
  float *F = reinterpret_cast<float *>(M + nn);
  float *G = F + nn;
  for (int i = tid; i < nn; i += nt) M[i] = q.mat[i];
  __syncthreads();
  const int log2 = 31 - __clz(n), bd = q.bit_depth;
  stage_cols(M, O, A, n, 0, log2 + bd - 9, 0);
  __syncthreads();
  stage_rows(M, A, C, n, 0, log2 + 6, 0);
  __syncthreads();
  int nz = 0;
  for (int i = tid; i < nn; i += nt) {
    const int lev = quant1(C[i], q.qs, q.qoff, q.qbits);
    const int av = iabs(lev);
    nz |= lev != 0;
    F[i] = av > 0 ? __fadd_rn(3.0f, __fmul_rn(2.0f, log2f((float)av + 1.0f)))
                  : 0.0f;
    A[i] = dequant1(lev, q.dqs, q.dqsh);
  }
  const int any = __syncthreads_or(nz);
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
    float dist = G[0], bits = F[0];
    for (int i = 1; i < nn; ++i) {
      dist = __fadd_rn(dist, G[i]);
      bits = __fadd_rn(bits, F[i]);
    }
    bits = __fadd_rn(bits, any ? 10.0f : 1.0f);
    const float out = __fadd_rn(fmaf(bits, s.lam, dist),
                                __fsub_rn(best.cost, best.sse));
    cost[b] = valid < 1e37f ? out : kBig;
  }
}

int launch_smem(const void *kernel, size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// Scan entry. recon/org int32 planes (row stride), pos [B, 2], zcur [B],
// zmaxw [h-n+1, w-n+1] int32; the motion planes [hp, wp] int32; nbav
// [B, 5], miav [B, 3] bool. Out: mv [B, 2] full-pel int32, cost [B]
// float32, pred [B, n, n] int32, sse [B] float32. With zmax2n [h-2n+1,
// w-2n+1] int32 (null: GT off) also the anchor ring: anchor [B, 2] full-pel
// int32, gt_rate [B] float32, gt_ok [B] bool. With ref (null: ISS) the
// previous picture (int32, the same row stride, h rows) and radius_t, the
// temporal search too, into tmv, tcost, tpred, tsse as mv, cost, pred,
// sse; ss_idx is the SS reference's index (0 on ISS, 1 on PSS).
HH_EXPORT int hh_ss_search(const void *recon, const void *org, int stride,
                           const void *pos, const void *zcur,
                           const void *zmaxw, const void *mvx4,
                           const void *mvy4, const void *pi4,
                           const void *rf4, int hp, int wp,
                           const void *nbav, const void *miav, int b, int n,
                           int radius, int w, int h, int mi_size, float lam,
                           void *mv, void *cost, void *pred, void *sse,
                           const void *zmax2n, void *anchor, void *gt_rate,
                           void *gt_ok, const void *ref, int radius_t,
                           int ss_idx, void *tmv, void *tcost, void *tpred,
                           void *tsse, void *stream) {
  const Search s{static_cast<const int32_t *>(recon),
                 static_cast<const int32_t *>(org), stride,
                 static_cast<const int32_t *>(zmaxw), n, radius, w, h, lam,
                 static_cast<const int32_t *>(zmax2n), ref != nullptr};
  const Search st{static_cast<const int32_t *>(ref),
                  static_cast<const int32_t *>(org), stride, nullptr, n,
                  radius_t, w, h, lam, nullptr, 1};
  const Motion m{static_cast<const int32_t *>(mvx4),
                 static_cast<const int32_t *>(mvy4),
                 static_cast<const int32_t *>(pi4),
                 static_cast<const int32_t *>(rf4), hp, wp};
  const Found f{static_cast<int32_t *>(mv), static_cast<int32_t *>(pred),
                static_cast<float *>(cost), static_cast<float *>(sse)};
  const Found ft{static_cast<int32_t *>(tmv), static_cast<int32_t *>(tpred),
                 static_cast<float *>(tcost), static_cast<float *>(tsse)};
  const bool temporal = ref != nullptr;
  const int rmax = temporal && radius_t > radius ? radius_t : radius;
  const size_t smem = sizeof(float) * search_words(n, rmax);
  const int err = launch_smem((const void *)ss_search_kernel, smem);
  if (err) return err;
  ss_search_kernel<<<dim3(b, temporal ? 2 : 1), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      s, st, static_cast<const int32_t *>(pos),
      static_cast<const int32_t *>(zcur), m,
      static_cast<const uint8_t *>(nbav), static_cast<const uint8_t *>(miav),
      mi_size, ss_idx, f, ft, static_cast<int32_t *>(anchor),
      static_cast<float *>(gt_rate), static_cast<uint8_t *>(gt_ok));
  return (int)cudaGetLastError();
}

// Pre-pass entry on the original plane org (row stride): pos [B, 2], zcur
// [B], zmaxw int32; mat the n x n DCT; the quantizer's and dequantizer's
// parameters; the MI predictors (mi_x, 0), (0, mi_y), (mi_xy_x, mi_xy_y);
// ref the previous luma (the same row stride, h rows) and its radius_t on
// a PSS picture, null on an ISS one. Out: cost [B] float32.
HH_EXPORT int hh_ss_rd(const void *org, int stride, const void *pos,
                       const void *zcur, const void *zmaxw, const void *mat,
                       int b, int n, int radius, int w, int h, int bit_depth,
                       float lam, int qs, int qbits, int qoff, int dqs,
                       int dqsh, int mi_x, int mi_y, int mi_xy_x,
                       int mi_xy_y, const void *ref, int radius_t,
                       void *cost, void *stream) {
  const Search s{static_cast<const int32_t *>(org),
                 static_cast<const int32_t *>(org), stride,
                 static_cast<const int32_t *>(zmaxw), n, radius, w, h, lam,
                 nullptr};
  const Search st{static_cast<const int32_t *>(ref),
                  static_cast<const int32_t *>(org), stride, nullptr, n,
                  radius_t, w, h, lam, nullptr};
  const Tq q{static_cast<const int32_t *>(mat), bit_depth, qs, qbits, qoff,
             dqs, dqsh};
  const int rmax = ref != nullptr && radius_t > radius ? radius_t : radius;
  const size_t smem = sizeof(float) * (search_words(n, rmax) + 7 * n * n);
  const int err = launch_smem((const void *)ss_rd_kernel, smem);
  if (err) return err;
  ss_rd_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      s, st, static_cast<const int32_t *>(pos),
      static_cast<const int32_t *>(zcur),
      make_int4(mi_x, mi_y, mi_xy_x, mi_xy_y), q, static_cast<float *>(cost));
  return (int)cudaGetLastError();
}
