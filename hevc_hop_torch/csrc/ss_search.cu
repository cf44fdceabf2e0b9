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
// Pre-pass entry: one CTA per block (rd_search): the SS search over the
// original with the four static predictors and, on a PSS picture, then
// the temporal search over the previous luma with the zero predictor,
// kept where its cost is lower; then the dead-zone transform round trip
// of the winner's residual (tq.cuh, kernel C3's device functions) and
// SSE + lambda * level bits + the search's rate (rd_tail). A search finds
// its valid displacements first (a block with none reads no window, and
// one whose arms have none skips the tail: its cost is 3e38), stages once
// the window rows they read, as u8 where every sample is below 256 (else
// int16), and takes the correlation on the tensor cores (mma.m16n8k32,
// u8 x u8 into exact s32 sums; RdGeom), tiles with no valid displacement
// skipped. The temporal arm on CTAs of its own (a cluster of two a
// block, the winners merged through distributed shared memory) was
// slower than the float-order entry it replaced on a PSS picture's 8x8
// and 32x32 blocks and was not kept (PERF.md, Findings).
//
// Sums: every term of corr and ref^2 is a non-negative integer, so where
// a sum stays below 2^24 every partial sum is an exact float32 integer in
// any order. Both entries take both sums as integers: ref^2 from the
// window rows' box sums of squares (width n, then n rows), corr where
// every sample is below 256 by __dp4a on packed bytes (scan entry) or on
// the tensor cores (pre-pass), and by int32 multiply-adds otherwise (10
// bit: 1024 * 1023^2 < 2^31). An entry whose corr and ref^2 are below
// 2^24 (every entry of an 8-bit block of 16x16 or less: 256 * 255^2 <
// 2^24) takes them as float32; another takes the reference's float order:
// XLA:CPU's convolution (ROADMAP.md F8), over the kernel in row-major
// order in blocks of 512 products, two accumulators per block (even and
// odd products), added at the block's end, blocks added in order; the PSS
// program's (ROADMAP.md F10), over the kernel in row-major order, one
// rounded add after another (Search::seq; the scan entry's PSS
// launches). org^2 is exact below 2^24; above, in the jitted search's
// order (ss_common.cuh block_lane and fold_lanes, F11), or with seq in
// block_sum's. The rate lambda * (6 + bits) is rounded on its own and then
// added, as in the reference. The pre-pass's tail: the SSE exact below
// 2^24, else the reference's raster walk; the level bits in raster order
// over the nonzero levels only.
//
// Bound: integer operations, n^2 (2r+1)^2 multiply-adds per block for the
// correlation (a quarter as many __dp4a; on the tensor cores in the
// pre-pass) and O((n+2r)^2 n / 8 + (2r+1)^2 n) adds for ref^2, against
// (n+2r)^2 + n^2 samples. The split puts a
// block's displacements on kClusterCtas SMs; each CTA reads only its
// part's window rows from L2; threads of a warp take neighbouring dx, so
// their shared-memory reads fall in distinct banks or broadcast.
#include <climits>

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
  // the pre-pass kernel's dynamic shared memory is char; this one's int
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

// ---------------------------------------------------------------------------
// Pre-pass entry. One CTA per block: each arm's least cost (rd_search),
// then the winner's transform round trip and the cost's sums (rd_tail).
// ---------------------------------------------------------------------------

constexpr int kRdThreads = kSearchThreads;
constexpr int kRdWarps = kRdThreads / 32;
constexpr int kRdPreds = 4;   // the SS arm's static predictors

// Stage clocks, only in the library built with -DHH_STAGE_CLOCK
// (tools/ss_clock.py): thread 0 of each CTA adds the %globaltimer
// nanoseconds it spent in each stage to clk[cta * kRdClock + stage]
// (common.cuh StageClock); slot kRdTotal gets its whole time, kRdSm its
// SM + 1.
enum RdStage { kRdStaging, kRdOrg2, kRdSearch, kRdTemporal, kRdTransform,
               kRdTail, kRdTotal, kRdSm, kRdClock };
#ifdef HH_STAGE_CLOCK
__device__ long long *g_rd_clk;
__device__ int g_rd_ctas;
struct RdClock : StageClock {
  __device__ void start() {
    const long long cta = blockIdx.y * gridDim.x + blockIdx.x;
    begin(g_rd_clk != nullptr && cta < g_rd_ctas
              ? g_rd_clk + cta * kRdClock : nullptr);
    if (row != nullptr) row[kRdTotal] = last;
  }
  __device__ void operator()(int k) const { add(k); }
  __device__ void end() const {
    if (row != nullptr) {
      row[kRdTotal] = clock_ns() - row[kRdTotal];
      row[kRdSm] = clock_sm() + 1;
    }
  }
};
#else
struct RdClock {
  __device__ void start() const {}
  __device__ void operator()(int) const {}
  __device__ void end() const {}
};
#endif

// The correlation on the tensor cores: for a row m = (dy, 8 xi) of the
// displacements and eight columns j, corr[dy][8 xi + j] = sum over the
// kernel of win[dy + ky][8 xi + j + kx] org[ky][kx]. As a product
// A (M x K) . B (K x 8) with K running over the kernel rows, each row
// taken as `span` bytes (n + 8 rounded up to 16, one window row from
// 8 xi; two rows of 16 at n = 8, two chunks of 32 at n = 32):
// A[m][ky, k] = win[dy + ky][8 xi + k], B[ky, k][j] = org[ky][k - j]
// (0 outside the row): the eight columns are eight shifts of the original,
// so every A word is four aligned bytes of one window row. One
// mma.m16n8k32 (u8 x u8, exact s32 sums) takes 32 bytes of K, `chunks`
// of them a tile of 16 rows.
struct RdGeom {
  int n, r, D, W, X, span, chunks, Wp;
  __host__ __device__ RdGeom(int n_, int r_) : n(n_), r(r_) {
    D = 2 * r + 1;
    W = n + 2 * r;
    X = (D + 7) / 8;
    span = n == 8 ? 16 : (n == 16 ? 32 : 64);
    chunks = n * span / 32;
    const int reach = 8 * (X - 1) + span;
    Wp = ((reach > W ? reach : W) + 15) / 16 * 16;
  }
};

// Byte offsets of the search's shared memory: the original (int32), the
// displacements' validity (u8), the MVD bits' tables (float [2][4][D]),
// the window rows' box sums of squares (int32 [W][D]), the reduction,
// then the window: u8 rows of Wp bytes with B's shifted originals after
// them, or int16 rows of W.
struct RdLayout {
  int org, valid, bits, rs, red, win, bt, end;
  __host__ __device__ static int up16(int b) { return (b + 15) / 16 * 16; }
  __host__ __device__ RdLayout(const RdGeom &g) {
    const int nn = g.n * g.n;
    org = 0;
    valid = up16(org + 4 * nn);
    bits = up16(valid + g.D * g.D);
    rs = up16(bits + 4 * 2 * kRdPreds * g.D);
    red = up16(rs + 4 * g.W * g.D);
    win = up16(red + 4 * 5 * kSearchThreads);
    bt = up16(win + g.W * g.Wp);
    const int narrow = bt + 4 * 64 * g.chunks;
    const int wide = win + 2 * g.W * g.W;
    end = narrow > wide ? narrow : wide;
  }
};

// Shared bytes of the pre-pass for n at radii r (SS) and rt (temporal, 0:
// none): the larger search, and the tail's seven n x n words past the
// original and the validity
__host__ __device__ inline int rd_smem_bytes(int n, int r, int rt) {
  const RdLayout a{RdGeom(n, r)};
  int end = a.end;
  if (rt > 0) {
    const RdLayout t{RdGeom(n, rt)};
    end = t.end > end ? t.end : end;
  }
  const int tail = a.rs + 4 * 7 * n * n;
  return end > tail ? end : tail;
}

__device__ __forceinline__ void mma_u8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The search of one arm of the block at (px, py) by the CTA: the masked
// full search of the D x D displacements with the costs the reference
// forms, its winner returned to every thread. corr and ref^2 are exact
// integers (corr on the tensor cores where every sample is below 256,
// else by int32 multiply-adds; ref^2 from box sums); an entry whose corr
// or ref^2 reaches 2^24 takes the reference's ordered float sums (F8), so
// every entry equals the reference's float. org^2 likewise: exact below
// 2^24, else F11's order. preds: np (x, y) quarter-pel predictors.
template <int N, class Clk>
__device__ Best rd_search(const Search &s, int px, int py, int zcur,
                          const int *preds, int np, char *sm,
                          const Clk &clk) {
  const RdGeom g(N, s.radius);
  const RdLayout L(g);
  constexpr int n = N, nn = N * N;
  const int r = g.r, D = g.D, W = g.W, Wp = g.Wp;
  const int tid = threadIdx.x, nt = blockDim.x;
  int32_t *org = reinterpret_cast<int32_t *>(sm + L.org);
  uint8_t *valid = reinterpret_cast<uint8_t *>(sm + L.valid);
  float *bx = reinterpret_cast<float *>(sm + L.bits), *by = bx + np * D;
  int32_t *rs = reinterpret_cast<int32_t *>(sm + L.rs);
  float *red = reinterpret_cast<float *>(sm + L.red);
  uint8_t *w8 = reinterpret_cast<uint8_t *>(sm + L.win);
  int16_t *w16 = reinterpret_cast<int16_t *>(sm + L.win);
  uint32_t *bt = reinterpret_cast<uint32_t *>(sm + L.bt);
  __shared__ unsigned long long org2_i;
  __shared__ float org2_s;
  __shared__ Part part_s;
  __shared__ Best best_s;
  __shared__ int rows_s[2];
  const int warp = tid >> 5, lane = tid & 31;
  // the displacements' validity first (eight loads in flight a thread),
  // and the rows of displacements that hold a valid one
  if (tid == 0) {
    org2_i = 0;
    rows_s[0] = D;
    rows_s[1] = -1;
  }
  __syncthreads();
  int lo = D, hi = -1;
  const auto mark = [&](int dy, int dx, bool v) {
    valid[dy * D + dx] = v;
    if (v) {
      lo = min(lo, dy);
      hi = max(hi, dy);
    }
  };
  if (s.zmaxw == nullptr) {
    // the temporal search: every displacement in the picture
    for (int d = tid; d < D * D; d += nt) {
      const int dy = d / D, dx = d - dy * D;
      mark(dy, dx, in_picture(px + dx - r, py + dy - r, n, s.w, s.h));
    }
  } else {
    // the causality plane's row segments, four entries a 16-byte load
    // from the aligned word at or before each row's first displacement
    // (causal's test, entry by entry)
    const int zw = s.w - n + 1, zlen = zw * (s.h - n + 1);
    const int nq = (D + 6) / 4;
    const bool zal = (reinterpret_cast<uintptr_t>(s.zmaxw) & 15) == 0;
#pragma unroll 4
    for (int t = tid; t < D * nq; t += nt) {
      const int dy = t / nq, c = t - dy * nq, ty = py + dy - r;
      const bool row_in = ty >= 0 && ty + n <= s.h;
      const int base = ty * zw + px - r;
      const int a = (base & ~3) + 4 * c;
      int z[4] = {INT_MAX, INT_MAX, INT_MAX, INT_MAX};
      if (row_in && zal && a >= 0 && a + 4 <= zlen) {
        const int4 q = __ldg(reinterpret_cast<const int4 *>(s.zmaxw + a));
        z[0] = q.x;
        z[1] = q.y;
        z[2] = q.z;
        z[3] = q.w;
      } else if (row_in) {
        for (int k = 0; k < 4; ++k)
          if (a + k >= 0 && a + k < zlen) z[k] = __ldg(s.zmaxw + a + k);
      }
      for (int k = 0; k < 4; ++k) {
        const int dx = a + k - base, tx = px + dx - r;
        if (dx >= 0 && dx < D)
          mark(dy, dx, row_in && tx >= 0 && tx + n <= s.w && z[k] < zcur);
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(~0u, lo, o));
    hi = max(hi, __shfl_xor_sync(~0u, hi, o));
  }
  if (lane == 0) {
    atomicMin(&rows_s[0], lo);
    atomicMax(&rows_s[1], hi);
  }
  // the block, and each predictor's MVD bits by column and by row
  // (min_rate_bits's terms)
  int wide = 0;
  unsigned long long o2 = 0;
  for (int i = tid; i < nn; i += nt) {
    const int v = s.org[(long long)(py + i / n) * s.stride + px + i % n];
    org[i] = v;
    wide |= v > 255;
    o2 += (unsigned long long)(v * v);
  }
  for (int i = tid; i < np * D; i += nt) {
    const int p = i / D, k = i % D;
    bx[i] = mvd_bits(4 * (k - r) - preds[2 * p]);
    by[i] = mvd_bits(4 * (k - r) - preds[2 * p + 1]);
  }
  __syncthreads();
  // nothing valid: the reference's argmin over all-masked costs, index 0
  if (rows_s[1] < 0) {
    if (tid == 0)
      best_s = finish_best(s, Part{kBig, 0.0f, kBig, D * D, D * D}, preds,
                           np);
    __syncthreads();
    clk(kRdStaging);
    return best_s;
  }
  // the window rows [j0, j1) that the valid displacements' rows read, a
  // word of four samples a thread (one 16-byte load where the row lies in
  // the picture), as u8 with zeros past W; where a sample is past 255 they
  // are read again as int16
  const int j0 = rows_s[0], j1 = rows_s[1] + n;
  const int x0 = px - r, y0 = py - r;
  const bool inside = x0 >= 0 && x0 + Wp <= s.w && (x0 & 3) == 0 &&
                      (s.stride & 3) == 0 &&
                      (reinterpret_cast<uintptr_t>(s.src) & 15) == 0;
  const int Wq = Wp / 4;   // words of a u8 row: Wp is a multiple of 16
  uint32_t *w8q = reinterpret_cast<uint32_t *>(w8);
#pragma unroll 8
  for (int t = j0 * Wq + tid; t < j1 * Wq; t += nt) {
    const int j = t / Wq, x = 4 * (t - j * Wq);
    const int32_t *row =
        s.src + (long long)clip3(0, s.h - 1, y0 + j) * s.stride;
    int v[4];
    if (inside) {
      const int4 q = __ldg(reinterpret_cast<const int4 *>(row + x0 + x));
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else {
      for (int k = 0; k < 4; ++k)
        v[k] = x + k < W ? __ldg(row + clip3(0, s.w - 1, x0 + x + k)) : 0;
    }
    uint32_t word = 0;
    for (int k = 0; k < 4; ++k) {
      const int u = x + k < W ? v[k] : 0;
      wide |= u > 255;
      word |= (uint32_t)(u & 255) << (8 * k);
    }
    w8q[t] = word;
  }
  wide = __syncthreads_or(wide);
  atomicAdd(&org2_i, o2);
  if (wide)
    for (int j = j0 + warp; j < j1; j += kRdWarps) {
      const int32_t *row =
          s.src + (long long)clip3(0, s.h - 1, y0 + j) * s.stride;
      for (int x = lane; x < W; x += 32)
        w16[j * W + x] = (int16_t)__ldg(row + clip3(0, s.w - 1, x0 + x));
    }
  __syncthreads();
  clk(kRdStaging);
  // org^2: exact below 2^24, else the jitted search's order (F11)
  if (org2_i < kExact) {
    if (tid == 0) org2_s = (float)org2_i;
  } else {
    const auto sq = [&](int i) {
      return __fmul_rn((float)org[i], (float)org[i]);
    };
    const bool rows = n % 8 != 0;
    if (tid < (rows ? n : 8))
      red[tid] = rows ? block_row(n, tid, sq) : block_lane(n, tid, sq);
    __syncthreads();
    if (tid == 0) org2_s = rows ? fold_rows(n, red) : fold_lanes(red);
  }
  __syncthreads();
  clk(kRdOrg2);
  const float org2 = org2_s;
  // the rows' box sums of squares, eight displacements a task
  const int nseg = (D + 7) / 8;
  for (int t = j0 * nseg + tid; t < j1 * nseg; t += nt) {
    const int j = t / nseg, xa = (t % nseg) * 8;
    const int xb = xa + 8 < D ? xa + 8 : D;
    const auto at = [&](int x) {
      return wide ? (int)w16[j * W + x] : (int)w8[j * Wp + x];
    };
    int acc = 0;
    for (int k = 0; k < n; ++k) acc += at(xa + k) * at(xa + k);
    for (int dx = xa; dx < xb; ++dx) {
      rs[j * D + dx] = acc;
      if (dx + 1 < xb) acc += at(dx + n) * at(dx + n) - at(dx) * at(dx);
    }
  }
  // B: the eight shifted originals of every chunk, as the fragments'
  // words: bt[(c * 8 + j) * 8 + 2 t + h] holds bytes k = 16 h + 4 t .. + 3
  constexpr int span = N == 8 ? 16 : (N == 16 ? 32 : 64);
  constexpr int chunks = N * span / 32;
  if (!wide) {
    for (int i = tid; i < chunks * 64; i += nt) {
      const int c = i / 64, j = (i / 8) % 8, t = (i / 2) % 4, h = i % 2;
      uint32_t v = 0;
      for (int b = 0; b < 4; ++b) {
        const int gb = 32 * c + 16 * h + 4 * t + b;
        const int ky = gb / span, kx = gb % span - j;
        if (kx >= 0 && kx < n) v |= (uint32_t)org[ky * n + kx] << (8 * b);
      }
      bt[i] = v;
    }
  }
  __syncthreads();
  // the least (cost, index) over the valid displacements: with none, the
  // reference's argmin over all-masked costs is index 0 (finish_best)
  float bc = kBig, bs = 0.0f;
  int bi = D * D;
  // displacement (dy, dx) with its exact corr, folded into (bc, bi, bs)
  const auto fold = [&](int dy, int dx, unsigned corr) {
    const int d = dy * D + dx;
    if (!valid[d]) return;
    unsigned ref2 = 0;
    for (int ky = 0; ky < n; ++ky) ref2 += (unsigned)rs[(dy + ky) * D + dx];
    float fc, fr;
    if (corr < kExact && ref2 < kExact) {
      fc = (float)corr;
      fr = (float)ref2;
    } else if (wide) {
      ordered_sums(w16 + dy * W + dx, W, org, n, 0, fc, fr);
    } else {
      ordered_sums(w8 + dy * Wp + dx, Wp, org, n, 0, fc, fr);
    }
    const float sse = __fsub_rn(__fadd_rn(org2, fr), __fmul_rn(2.0f, fc));
    float bits = 0.0f;
    for (int p = 0; p < np; ++p) {
      const float b = __fadd_rn(bx[p * D + dx], by[p * D + dy]);
      bits = p == 0 ? b : fminf(bits, b);
    }
    const float cost =
        __fadd_rn(sse, __fmul_rn(s.lam, __fadd_rn(bits, kInterBits)));
    if (take_least(bc, bi, cost, d)) bs = sse;
  };
  if (!wide) {
    const int gid = lane >> 2, t4 = lane & 3;
    const int rows = D * g.X;
    // the tiles over the rows of displacements that hold a valid one
    const int t0 = rows_s[0] * g.X / 16;
    const int t1 = ((rows_s[1] + 1) * g.X + 15) / 16;
    for (int tile = t0 + warp; tile < t1; tile += kRdWarps) {
      // a tile none of whose displacements is valid costs nothing
      int any = 0;
      for (int e = lane; e < 128; e += 32) {
        const int m = tile * 16 + e / 8, dx = 8 * (m % g.X) + e % 8;
        any |= m < rows && dx < D && valid[(m / g.X) * D + dx];
      }
      if (!__any_sync(~0u, any)) continue;
      const int ma = tile * 16 + gid, mb = ma + 8;
      const int ra = ma < rows ? ma : 0, rb = mb < rows ? mb : 0;
      const uint8_t *pa = w8 + (ra / g.X) * Wp + 8 * (ra % g.X);
      const uint8_t *pb = w8 + (rb / g.X) * Wp + 8 * (rb % g.X);
      const uint2 *bq = reinterpret_cast<const uint2 *>(bt) + gid * 4 + t4;
      int acc[4] = {0, 0, 0, 0};
#pragma unroll 4
      for (int c = 0; c < chunks; ++c) {
        const int g0 = 32 * c + 4 * t4, g1 = g0 + 16;
        const int o0 = g0 / span * Wp + g0 % span;
        const int o1 = g1 / span * Wp + g1 % span;
        const uint2 b = bq[c * 32];
        mma_u8(acc, *reinterpret_cast<const uint32_t *>(pa + o0),
               *reinterpret_cast<const uint32_t *>(pb + o0),
               *reinterpret_cast<const uint32_t *>(pa + o1),
               *reinterpret_cast<const uint32_t *>(pb + o1), b.x, b.y);
      }
      for (int q = 0; q < 4; ++q) {
        const int m = q < 2 ? ma : mb;
        const int dx = 8 * (m % g.X) + 2 * t4 + (q & 1);
        if (m < rows && dx < D) fold(m / g.X, dx, (unsigned)acc[q]);
      }
    }
  } else {
    // 10 bit: int32 multiply-adds (1024 * 1023^2 < 2^31)
    for (int d = tid; d < D * D; d += nt) {
      if (!valid[d]) continue;
      const int dy = d / D, dx = d % D;
      unsigned corr = 0;
      for (int ky = 0; ky < n; ++ky) {
        const int16_t *wr = w16 + (dy + ky) * W + dx;
        const int32_t *orow = org + ky * n;
        for (int kx = 0; kx < n; ++kx) corr += wr[kx] * orow[kx];
      }
      fold(dy, dx, corr);
    }
  }
  reduce_part(bc, bi, bs, kBig, D * D, red, part_s);
  if (tid == 0) best_s = finish_best(s, part_s, preds, np);
  __syncthreads();
  return best_s;
}

// The cost of coding the winner best of the search over q's plane: its
// residual against the prediction (q's plane at the displacement, clamped
// as the window is), the dead-zone transform round trip, then SSE + lam *
// level bits + the search's rate, by the CTA. The SSE is an exact integer
// below 2^24 (where every partial sum of the reference's raster walk is
// exact), else that raster walk of the float squares; the level bits add
// only the nonzero levels' terms, in raster order (a ballot a warp of 32
// terms; a zero term adds +0.0f, exactly); org holds the block, w 7 n^2
// words. Returns the cost to every thread.
template <class Clk>
__device__ float rd_tail(const Search &q, const Best &best, int px, int py,
                         const int32_t *org, const Tq &t, float lam,
                         int32_t *w, const Clk &clk) {
  const int n = q.n, nn = n * n, tid = threadIdx.x, nt = blockDim.x;
  int32_t *O = w, *A = O + nn, *C = A + nn, *E = C + nn, *M = E + nn;
  float *F = reinterpret_cast<float *>(M + nn);
  float *G = F + nn;
  __shared__ unsigned long long sse_i;
  __shared__ float out_s;
  if (tid == 0) sse_i = 0;
  for (int i = tid; i < nn; i += nt) {
    const int y = clip3(0, q.h - 1, py + best.mvy + i / n);
    const int x = clip3(0, q.w - 1, px + best.mvx + i % n);
    O[i] = org[i] - __ldg(q.src + (long long)y * q.stride + x);
    M[i] = t.mat[i];
  }
  __syncthreads();
  const int log2 = 31 - __clz(n), bd = t.bit_depth;
  stage_cols(M, O, A, n, 0, log2 + bd - 9, 0);
  __syncthreads();
  stage_rows(M, A, C, n, 0, log2 + 6, 0);
  __syncthreads();
  int nz = 0;
  for (int i = tid; i < nn; i += nt) {
    const int lev = quant1(C[i], t.qs, t.qoff, t.qbits);
    const int av = iabs(lev);
    nz |= lev != 0;
    F[i] = av > 0 ? __fadd_rn(3.0f, __fmul_rn(2.0f, log2f((float)av + 1.0f)))
                  : 0.0f;
    A[i] = dequant1(lev, t.dqs, t.dqsh);
  }
  const int any = __syncthreads_or(nz);
  stage_rows(M, A, E, n, 1, 7, 1);
  __syncthreads();
  stage_cols(M, E, A, n, 1, 20 - bd, 1);
  __syncthreads();
  clk(kRdTransform);
  unsigned long long se = 0;
  for (int i = tid; i < nn; i += nt) {
    const int e = O[i] - A[i];
    G[i] = __fmul_rn((float)e, (float)e);
    se += (unsigned long long)((long long)e * e);
  }
  for (int o = 16; o > 0; o >>= 1) se += __shfl_xor_sync(~0u, se, o);
  if ((tid & 31) == 0) atomicAdd(&sse_i, se);
  __syncthreads();
  if (tid < 32) {
    float bits = 0.0f;
    for (int c = 0; c < nn; c += 32) {
      const float f = F[c + tid];
      unsigned m = __ballot_sync(~0u, f != 0.0f);
      while (m) {
        const int k = __ffs(m) - 1;
        m &= m - 1;
        bits = __fadd_rn(bits, __shfl_sync(~0u, f, k));
      }
    }
    if (tid == 0) {
      float dist;
      if (sse_i < kExact) {
        dist = (float)sse_i;
      } else {
        dist = G[0];
        for (int i = 1; i < nn; ++i) dist = __fadd_rn(dist, G[i]);
      }
      bits = __fadd_rn(bits, any ? 10.0f : 1.0f);
      out_s = __fadd_rn(fmaf(bits, lam, dist), __fsub_rn(best.cost, best.sse));
    }
  }
  __syncthreads();
  return out_s;
}

// n = N; at least five CTAs an SM (four at 32x32) keep the staging's
// loads in flight. st.src set: the temporal arm too, after the SS arm.
template <int N>
__global__ void __launch_bounds__(kRdThreads, N == 32 ? 4 : 5)
    ss_rd_kernel(Search s, Search st, const int32_t *pos,
                 const int32_t *zcur, int4 mi, Tq q, float *cost) {
  extern __shared__ __align__(16) char smr[];
  const int b = blockIdx.x;
  const int px = pos[2 * b], py = pos[2 * b + 1];
  RdClock clk;
  clk.start();
  const int preds[2 * kRdPreds] = {0, 0, mi.x, 0, 0, mi.y, mi.z, mi.w};
  Best best = rd_search<N>(s, px, py, zcur[b], preds, kRdPreds, smr, clk);
  clk(kRdSearch);
  const Search *arm = &s;
  float valid = best.cost;
  if (st.src != nullptr) {
    const int zero[2] = {0, 0};
    const Best tb = rd_search<N>(st, px, py, 0, zero, 1, smr, clk);
    clk(kRdTemporal);
    valid = fminf(best.cost, tb.cost);
    if (tb.cost < best.cost) {
      best = tb;
      arm = &st;
    }
  }
  // no valid displacement in either arm: the intra arm wins (3e38), and
  // the residual's cost is never read
  if (valid >= 1e37f) {
    if (threadIdx.x == 0) cost[b] = kBig;
    clk.end();
    return;
  }
  const RdLayout L{RdGeom(N, s.radius)};
  const float out =
      rd_tail(*arm, best, px, py, reinterpret_cast<int32_t *>(smr + L.org),
              q, s.lam, reinterpret_cast<int32_t *>(smr + L.rs), clk);
  clk(kRdTail);
  if (threadIdx.x == 0) cost[b] = out;
  clk.end();
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

#ifdef HH_STAGE_CLOCK
// The pre-pass's stage clocks' buffer: int64 [ctas, kRdClock] (the CTAs
// of one launch, (arm, block) in row-major order), zero, or null to stop.
HH_EXPORT int hh_ss_rd_clock(void *buf, int ctas) {
  cudaError_t e = cudaMemcpyToSymbol(g_rd_clk, &buf, sizeof(buf));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_rd_ctas, &ctas, sizeof(int));
  return (int)e;
}
#endif

// Pre-pass entry on the original plane org (row stride): pos [B, 2], zcur
// [B], zmaxw int32; mat the n x n DCT (n = 8, 16 or 32); the quantizer's
// and dequantizer's parameters; the MI predictors (mi_x, 0), (0, mi_y),
// (mi_xy_x, mi_xy_y); ref the previous luma (the same row stride, h rows)
// and its radius_t on a PSS picture, null on an ISS one. Out: cost [B]
// float32.
HH_EXPORT int hh_ss_rd(const void *org, int stride, const void *pos,
                       const void *zcur, const void *zmaxw, const void *mat,
                       int b, int n, int radius, int w, int h, int bit_depth,
                       float lam, int qs, int qbits, int qoff, int dqs,
                       int dqsh, int mi_x, int mi_y, int mi_xy_x,
                       int mi_xy_y, const void *ref, int radius_t,
                       void *cost, void *stream) {
  if (n != 8 && n != 16 && n != 32) return (int)cudaErrorInvalidValue;
  const Search s{static_cast<const int32_t *>(org),
                 static_cast<const int32_t *>(org), stride,
                 static_cast<const int32_t *>(zmaxw), n, radius, w, h, lam,
                 nullptr};
  const Search st{static_cast<const int32_t *>(ref),
                  static_cast<const int32_t *>(org), stride, nullptr, n,
                  radius_t, w, h, lam, nullptr};
  const Tq q{static_cast<const int32_t *>(mat), bit_depth, qs, qbits, qoff,
             dqs, dqsh};
  const bool temporal = ref != nullptr;
  const size_t smem = rd_smem_bytes(n, radius, temporal ? radius_t : 0);
  void (*kernel)(Search, Search, const int32_t *, const int32_t *, int4, Tq,
                 float *) =
      n == 8 ? ss_rd_kernel<8> : (n == 16 ? ss_rd_kernel<16>
                                          : ss_rd_kernel<32>);
  const int err = launch_smem((const void *)kernel, smem);
  if (err) return err;
  kernel<<<b, kRdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      s, st, static_cast<const int32_t *>(pos),
      static_cast<const int32_t *>(zcur),
      make_int4(mi_x, mi_y, mi_xy_x, mi_xy_y), q, static_cast<float *>(cost));
  return (int)cudaGetLastError();
}
