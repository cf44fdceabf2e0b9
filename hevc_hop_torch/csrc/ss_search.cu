// Kernel C9: the self-similarity and temporal full searches, in the scan
// and in the quadtree pre-pass.
//
// Replaces hevc_hop_tpu/models/ss_scan.py _ss_search (with its GT anchor
// ring, :266-288), _t_search (:301), _dyn_rate_map and _mvd_bits (scan
// entry, hh_ss_search), and hevc_hop_tpu/models/ss_partition.py
// _ss_rd_size, its SS arm and its temporal one (pre-pass entry, hh_ss_rd).
//
// Scan entry: one cluster of kClusterCtas CTAs per block (and per search:
// on a PSS picture a second row of clusters runs the temporal search); its
// work on a block (search_entry_cluster, search_part, merge_parts) is in
// ss_search.cuh, which kernel C14 (ss_scan.cu) runs too. The CTAs split
// the (2r+1)^2 displacements into contiguous row-major parts, one per
// rank. Each stages the clamped window rows its part reads and the
// block's original in shared memory, gathers the block's AMVP predictors
// from the carried motion planes (ss_common.cuh gather_cands) and takes
// its displacements thread by thread: a displacement outside the picture,
// or whose window with the interpolation margin reaches a sample not yet
// decoded, costs 3e38; otherwise the SSE is org^2 + ref^2 - 2 corr and the
// cost SSE + lambda * (6 + the least MVD bits over the predictors). The
// least cost wins, the first in row-major order among equals (jnp.argmin's
// rule): per thread, then per CTA into its Part, then the leader reads the
// parts through distributed shared memory after a cluster sync and merges
// them in rank order, which is index order. The entry writes the MV, the
// cost, the SSE (3e38 when no displacement was causal) and the full-pel
// prediction. With the GT on, the same pass keeps a second least cost,
// over the displacements whose 2n GT window plus 2 samples of slack is in
// the picture and causal (zmax2n), with the same tie rule (the reference's
// lax.top_k with k = 1): the anchor ring, written as the anchor, its rate
// and whether one was found. On a PSS picture the temporal search is the
// same code over the previous picture's window with radius radius_t,
// every displacement inside the picture valid (no causal test), with the
// temporal predictors (the neighbours that name the temporal reference,
// and zero); its own outputs.
//
// Pre-pass entry: one CTA per block runs the whole search in the float
// forms (search_block), then the dead-zone transform round trip of the
// residual (tq.cuh, kernel C3's device functions), and writes SSE +
// lambda * level bits + the search's rate; on a PSS picture it first runs
// the temporal search over the previous luma with the zero predictor, and
// takes its residual and rate where its cost is lower.
//
// Sums: every term of corr and ref^2 is a non-negative integer, so where
// a sum stays below 2^24 every partial sum is an exact float32 integer in
// any order. The scan entry takes both sums as integers: ref^2 from the
// window rows' box sums of squares (width n, then n rows), corr by __dp4a
// on packed bytes where every sample is below 256 and by int32
// multiply-adds otherwise (10 bit: 1024 * 1023^2 < 2^31). An entry whose
// corr and ref^2 are below 2^24 (every entry of an 8-bit block of 16x16 or
// less: 256 * 255^2 < 2^24) takes them as float32; another takes the
// reference's float order, which the pre-pass takes for every entry:
// XLA:CPU's convolution (ROADMAP.md F8), over the kernel in row-major
// order in blocks of 512 products, two accumulators per block (even and
// odd products), added at the block's end, blocks added in order; the PSS
// program's (ROADMAP.md F10), over the kernel in row-major order, one
// rounded add after another (Search::seq; the scan entry's PSS
// launches). org^2 is exact below 2^24; above, in the jitted search's
// order (ss_common.cuh block_lane and fold_lanes, F11), or with seq in
// block_sum's. The rate lambda * (6 + bits) is rounded on its own and then
// added, as in the reference.
//
// Bound: integer operations, n^2 (2r+1)^2 multiply-adds per block for the
// correlation (a quarter as many __dp4a) and O((n+2r)^2 n / 8 + (2r+1)^2
// n) adds for ref^2, against (n+2r)^2 + n^2 samples. The split puts a
// block's displacements on kClusterCtas SMs; each CTA reads only its
// part's window rows from L2; threads of a warp take neighbouring dx, so
// their shared-memory reads fall in distinct banks or broadcast.
#include "ss_search.cuh"
#include "tq.cuh"

namespace {

constexpr int kThreads = kSearchThreads;

__global__ void __cluster_dims__(kClusterCtas, 1, 1)
    __launch_bounds__(kThreads)
    ss_search_kernel(Search s, Search st, const int32_t *pos,
                     const int32_t *zcur, Motion m, const uint8_t *nbav,
                     const uint8_t *miav, int mi_size, int ss_idx, Found f,
                     Found ft, int32_t *anchor, float *gt_rate,
                     uint8_t *gt_ok) {
  // the pre-pass kernel's dynamic shared memory is float; this one's int
  extern __shared__ __align__(16) int32_t smi[];
  const int b = blockIdx.x / kClusterCtas;
  const bool temporal = blockIdx.y == 1;
  search_entry_cluster(temporal ? st : s, m, b, pos[2 * b], pos[2 * b + 1],
                       zcur[b], nbav + 5 * b, miav + 3 * b, mi_size, ss_idx,
                       temporal, temporal ? ft : f, anchor, gt_rate, gt_ok,
                       smi);
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
  const int words = part_words(n, radius, kClusterCtas);
  const int twords = temporal ? part_words(n, radius_t, kClusterCtas) : 0;
  const size_t smem = sizeof(int32_t) * (words > twords ? words : twords);
  const int err = launch_smem((const void *)ss_search_kernel, smem);
  if (err) return err;
  ss_search_kernel<<<dim3(b * kClusterCtas, temporal ? 2 : 1), kThreads,
                     smem,
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
