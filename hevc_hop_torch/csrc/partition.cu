// Kernel C5: the partition RD pre-pass and its bottom-up decision.
//
// Replaces hevc_hop_tpu/models/partition.py rd_costs and rd_costs_forced
// (entry hh_partition_rd) and decide, decide_nxn and decide_rqt (entry
// hh_partition_decide).
//
// RD entry, one n x n block of the ORIGINAL luma plane per group of
// threads: a warp at n = 4 and 8 (eight blocks per CTA of 256 threads),
// the whole CTA at n = 16 and 32. The group gathers the block's 4N+1
// reference chain from original samples (a mid-grey row and column above
// and to the left of the picture, coordinates clamped at its bottom and
// right; every sample available, no substitution, never the strong
// smoothing), scores the 35 modes by Hadamard SATD, keeps the three lowest
// (the lower mode first among equals), and codes each through residual,
// DCT (DST at 4x4), quantizer, dequantizer and inverse transform: cost =
// SSE + lambda * (3 + 2 log2(|level| + 1) per nonzero level, and 10 per
// coded block or 1 per empty one). The lowest cost wins, the earlier
// candidate on a tie. With a mode given per block (the sub-TU arm of the
// residual quadtree) only that mode is coded. Prediction is kernel C2's
// device function (intra.cuh), quantizer and dequantizer kernel C3's
// (tq.cuh).
//
// The work is laid out for the card's warps, with no barrier of the whole
// CTA inside a block's work at n <= 8:
// - RMD: a mode per warp (at n >= 16 the group's eight warps take the 35
//   modes in turn), each warp predicting, transforming and summing its
//   mode's SATD alone (warp_satd: __syncwarp and shuffle sums);
// - the top three: three warp argmins over (SATD, mode);
// - the three candidates coded side by side: every stage of the residual,
//   the transforms, the quantizer and the error runs over the three
//   blocks at once;
// - dist, the block's SSE: the squared errors are integers; where their
//   sum stays below 2^24, every partial sum in any order is an exact
//   float, so the integer sum (shuffles, an atomic per warp) is the
//   reference's float; above 2^24 (reachable at 16x16 and 32x32 on noisy
//   10-bit content) the sum takes the order of the reference's compiled
//   reduction (models/partition.py block_dist, ROADMAP.md F12): at 8x8
//   and 16x16 a thread per lane (common.cuh block_lane), then fold_lanes;
//   at 32x32 a thread per row adds the lanes that do not wait on the
//   running sum, then one thread walks the rows' chain through lane 0,
//   the row's chunks in the arm's order (kRow32); at 4x4 (16 * 1024^2 =
//   2^24: only errors past 1024 reach it) the raster walk;
// - bits: only the nonzero levels' terms change the raster sum (adding
//   +0.0f is exact), so a ballot per warp marks them and one thread adds
//   just those, in raster order.
//
// Floats, as ops of the plain version in models/partition.py: bits in
// raster order, dist as above, each sum rounded (__fadd_rn); dist +
// lambda * bits is one fmaf, which is what the reference's compiled
// program does; log2f, not __log2f.
//
// Decide entry, one thread per 8x8 cell (16 a CTU, 32 640 on 1920x1088):
// the CTU's 64 + 16 + 4 + 1 costs bottom-up (NxN against 2Nx2N at 8x8;
// one CU, one CU with four half-size TUs, or four CUs at 16x16 and 32x32),
// each level's sums from the level below through shared memory, and the
// cell's depth8, tulog8 and 2x2 of mode4 written by its thread. Sums of
// four costs are ((a00 + a01) + a10) + a11 and every sum is rounded on its
// own. Bound: bytes (each grid read once, each output written once), far
// under a launch's own time at 1920x1088 (0.7 us of 3 MB), so the design
// spreads the work over the card (272 CTAs) with coalesced rows and every
// load in flight at once.
//
// RD entry bound: integer operations. A block costs 35 predictions and
// SATDs plus three transform round trips against n^2 samples read once, far
// above the card's bytes-per-operation line. Every block of the frame is
// independent, so one launch per size fills the card (16 320 CTAs of eight
// blocks at n = 4 on 1920x1088). The design keeps the chain, the block and
// every intermediate in shared memory; device memory sees each sample once
// per launch.
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
constexpr int kRdThreads = 256;
// the order in which rd_costs (0) and rd_costs_forced (1) add a 32x32
// row's four chunks of eight (models/partition.py ROW32_ORDER)
__constant__ int kRow32[2][4] = {{0, 2, 3, 1}, {0, 1, 2, 3}};

// The layout of one n x n block's work: its group of threads (a warp at
// n <= 8, else the CTA), the blocks per CTA, the group's shared words.
template <int N>
struct RdShape {
  static constexpr int NN = N * N, L = 4 * N + 1;
  static constexpr int G = N <= 8 ? 32 : kRdThreads;
  static constexpr int BLOCKS = kRdThreads / G, WARPS = G / 32;
  // RMD: two [NN] buffers per warp; coding: five [NN] per candidate
  static constexpr int U = 2 * NN * WARPS > 5 * kTop * NN ? 2 * NN * WARPS
                                                          : 5 * kTop * NN;
  static constexpr int MASKS = (kTop * NN + 31) / 32;
  // chain, smoothed chain, block, union, SATDs, candidates, ballot masks,
  // the candidates' integer SSEs (u64) and costs
  static constexpr int WORDS =
      2 * L + NN + U + 35 + kTop + MASKS + 2 * kTop + kTop + 1;
  static constexpr int GROUP_WORDS = (WORDS + 3) & ~3;
  static constexpr size_t smem() {
    return sizeof(int32_t) * (NN + 64 + BLOCKS * GROUP_WORDS);
  }
};

template <int G>
__device__ __forceinline__ void group_sync() {
  if constexpr (G == 32)
    __syncwarp();
  else
    __syncthreads();
}

// Hadamard SATD of the N x N difference block O by one warp alone (the
// reference's intra.satd, satd_cost's arithmetic): A [N*N] scratch, H the
// k x k matrix; tile by tile, each tile's absolute sum by shuffles.
// Returns the cost in every lane.
template <int N>
__device__ int warp_satd(const int32_t *O, int32_t *A, const int32_t *H) {
  constexpr int K = N >= 8 ? 8 : 4, KL = K == 8 ? 3 : 2, TW = N / K;
  constexpr int NN = N * N;
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < NN; i += 32) {
    const int x = i % N, y = i / N;
    const int ty = y & ~(K - 1), ly = y & (K - 1);
    int s = 0;
    for (int j = 0; j < K; ++j) s += H[ly * K + j] * O[(ty + j) * N + x];
    A[i] = s;
  }
  __syncwarp();
  int cost = 0;
  for (int ti = 0; ti < TW * TW; ++ti) {
    const int y0 = (ti / TW) * K, tx = (ti % TW) * K;
    int acc = 0;
    for (int j = lane; j < K * K; j += 32) {
      const int y = y0 + (j >> KL), lx = j & (K - 1);
      int s = 0;
      for (int jj = 0; jj < K; ++jj) s += A[y * N + tx + jj] * H[jj * K + lx];
      acc += iabs(s);
    }
    const int t = __reduce_add_sync(0xffffffffu, acc);
    cost += K == 8 ? (t + 2) >> 2 : (t + 1) >> 1;
  }
  __syncwarp();
  return cost;
}

// out[k][x] = round(sum_j M[k][j] * X[j][x]) (tm: M[j][k]), and
// out[y][k] = round(sum_j X[y][j] * M[k][j]) (cols), for the kc blocks of
// X [kc, N, N] side by side, the group's threads striding over them
// (tq.cuh stage_rows and stage_cols, element for element).
template <int N, int G>
__device__ void rows_k(const int32_t *M, const int32_t *X, int32_t *Y, int kc,
                       int tm, int shift, int clamp, int gtid) {
  constexpr int NN = N * N;
  for (int i = gtid; i < kc * NN; i += G) {
    const int32_t *Xc = X + (i / NN) * NN;
    const int kk = (i % NN) / N, x = i % N;
    int s = 0;
    for (int j = 0; j < N; ++j)
      s += (tm ? M[j * N + kk] : M[kk * N + j]) * Xc[j * N + x];
    s = rshift_round(s, shift);
    Y[i] = clamp ? clip16(s) : s;
  }
}
template <int N, int G>
__device__ void cols_k(const int32_t *M, const int32_t *X, int32_t *Y, int kc,
                       int tm, int shift, int clamp, int gtid) {
  constexpr int NN = N * N;
  for (int i = gtid; i < kc * NN; i += G) {
    const int32_t *Xc = X + (i / NN) * NN;
    const int y = (i % NN) / N, kk = i % N;
    int s = 0;
    for (int j = 0; j < N; ++j)
      s += Xc[y * N + j] * (tm ? M[j * N + kk] : M[kk * N + j]);
    s = rshift_round(s, shift);
    Y[i] = clamp ? clip16(s) : s;
  }
}

template <int N>
__global__ void __launch_bounds__(kRdThreads) partition_rd_kernel(RdArgs a) {
  using S = RdShape<N>;
  constexpr int NN = S::NN, L = S::L, G = S::G;
  extern __shared__ __align__(16) int32_t sm[];
  int32_t *M = sm;          // [NN] transform matrix, the CTA's
  int32_t *H = M + NN;      // [64] Hadamard matrix, the CTA's
  const int grp = threadIdx.x / G, gtid = threadIdx.x % G;
  const int lane = threadIdx.x & 31, wig = gtid / 32;
  int32_t *cu = H + 64 + grp * S::GROUP_WORDS;   // [L] chain
  int32_t *cf = cu + L;          // [L] smoothed chain
  int32_t *Y = cf + L;           // [NN] original block
  int32_t *U = Y + NN;           // [S::U] RMD or coding scratch
  int32_t *satd = U + S::U;      // [35]
  int32_t *cand = satd + 35;     // [kTop]
  uint32_t *mask = reinterpret_cast<uint32_t *>(cand + kTop);  // [MASKS]
  unsigned long long *dsum = reinterpret_cast<unsigned long long *>(
      (reinterpret_cast<uintptr_t>(mask + S::MASKS) + 7) & ~uintptr_t(7));
  float *ccost = reinterpret_cast<float *>(dsum + kTop);  // [kTop]

  const int k8 = N >= 8 ? 8 : 4;
  for (int i = threadIdx.x; i < NN; i += kRdThreads) M[i] = a.mat[i];
  for (int i = threadIdx.x; i < k8 * k8; i += kRdThreads) H[i] = a.t.had[i];
  __syncthreads();
  const int gw = a.w / N;
  const long long id = (long long)blockIdx.x * S::BLOCKS + grp;
  if (id >= (long long)(a.h / N) * gw) return;   // a whole group leaves
  const int px = (int)(id % gw) * N, py = (int)(id / gw) * N;
  const int bd = a.bit_depth;

  for (int i = gtid; i < L; i += G) {
    int x, y;
    if (i < 2 * N) {
      x = px - 1;
      y = py + 2 * N - 1 - i;
    } else if (i == 2 * N) {
      x = px - 1;
      y = py - 1;
    } else {
      x = px + i - 2 * N - 1;
      y = py - 1;
    }
    cu[i] = (x < 0 || y < 0)
                ? 1 << (bd - 1)
                : a.y[(long long)(y < a.h ? y : a.h - 1) * a.stride +
                      (x < a.w ? x : a.w - 1)];
  }
  for (int i = gtid; i < NN; i += G)
    Y[i] = a.y[(long long)(py + i / N) * a.stride + px + i % N];
  if (gtid < kTop) dsum[gtid] = 0ull;
  group_sync<G>();
  constexpr bool use_filter = N > 4;
  if (use_filter) {
    // the 1-2-1 smoothing (filter_chain without the strong form)
    for (int i = gtid; i < L; i += G)
      cf[i] = (i == 0 || i == L - 1)
                  ? cu[i]
                  : (cu[i - 1] + 2 * cu[i] + cu[i + 1] + 2) >> 2;
    group_sync<G>();
  }
  const Refs r = make_refs(cu, use_filter ? cf : nullptr, N, 0, bd);

  const int given = a.modes != nullptr ? a.modes[id] : -1;
  if (given < 0) {
    // a mode per warp: the SATD of each of the 35
    int32_t *O = U + wig * 2 * NN, *A = O + NN;
    for (int m = wig; m < 35; m += S::WARPS) {
      for (int i = lane; i < NN; i += 32)
        O[i] = Y[i] - predict_px(r, a.t, m, i % N, i / N);
      __syncwarp();
      const int c = warp_satd<N>(O, A, H);
      if (lane == 0) satd[m] = c;
    }
    group_sync<G>();
    // the three lowest SATDs by three warp argmins over (SATD, mode): the
    // lower mode first among equals
    if (wig == 0) {
      bool tk0 = false, tk1 = false;   // modes lane and lane + 32 taken
      for (int c = 0; c < kTop; ++c) {
        int bs = tk0 ? 0x7fffffff : satd[lane], bm = tk0 ? 99 : lane;
        if (lane + 32 < 35 && !tk1 && satd[lane + 32] < bs) {
          bs = satd[lane + 32];
          bm = lane + 32;
        }
        for (int o = 16; o > 0; o >>= 1) {
          const int os = __shfl_xor_sync(0xffffffffu, bs, o);
          const int om = __shfl_xor_sync(0xffffffffu, bm, o);
          if (os < bs || (os == bs && om < bm)) {
            bs = os;
            bm = om;
          }
        }
        tk0 = tk0 || bm == lane;
        tk1 = tk1 || bm == lane + 32;
        if (lane == 0) cand[c] = bm;
      }
    }
  } else if (gtid == 0) {
    cand[0] = given;
  }
  group_sync<G>();

  // the candidates side by side: residual, forward transform, quantizer
  const int kc = given < 0 ? kTop : 1, kn = kc * NN;
  const int log2 = 31 - __clz(N);
  int32_t *O = U, *A = O + kTop * NN, *C = A + kTop * NN, *E = C + kTop * NN;
  float *F = reinterpret_cast<float *>(E + kTop * NN);
  float *Gf = reinterpret_cast<float *>(C);   // squared errors, after C
  for (int i = gtid; i < kn; i += G) {
    const int j = i % NN;
    O[i] = Y[j] - predict_px(r, a.t, cand[i / NN], j % N, j / N);
  }
  group_sync<G>();
  // forward: tmp = round(R . M^T, log2 + bd - 9); C = round(M . tmp, log2 + 6)
  cols_k<N, G>(M, O, A, kc, 0, log2 + bd - 9, 0, gtid);
  group_sync<G>();
  rows_k<N, G>(M, A, C, kc, 0, log2 + 6, 0, gtid);
  group_sync<G>();
  // quantizer, the rate terms, dequantizer; a ballot per warp marks the
  // nonzero levels (mask word q: samples 32q .. 32q + 31 of the three)
  for (int base = 0; base < kn; base += G) {
    const int i = base + gtid;
    bool nz = false;
    if (i < kn) {
      const int lev = quant1(C[i], a.qs, a.qoff, a.qbits);
      const int av = iabs(lev);
      nz = lev != 0;
      F[i] = av > 0 ? __fadd_rn(3.0f, __fmul_rn(2.0f, log2f((float)av + 1.0f)))
                    : 0.0f;
      A[i] = dequant1(lev, a.dqs, a.dqsh);
    }
    const uint32_t b = __ballot_sync(0xffffffffu, nz);
    if (lane == 0 && i < kn) mask[i >> 5] = b;
  }
  group_sync<G>();
  // inverse: e = clip16(round(M^T . D, 7)); r = clip16(round(e . M, 20 - bd))
  rows_k<N, G>(M, A, E, kc, 1, 7, 1, gtid);
  group_sync<G>();
  cols_k<N, G>(M, E, A, kc, 1, 20 - bd, 1, gtid);
  group_sync<G>();
  // the squared errors, as floats and as integer sums per candidate (a
  // candidate's samples are a whole warp, or a half warp at n = 4)
  constexpr int SEG = NN < 32 ? NN : 32;
  for (int base = 0; base < kn; base += G) {
    const int i = base + gtid;
    int e2 = 0;
    if (i < kn) {
      const int e = O[i] - A[i];
      const float ef = (float)e;
      Gf[i] = __fmul_rn(ef, ef);
      e2 = e * e;
    }
    for (int o = SEG / 2; o > 0; o >>= 1)
      e2 += __shfl_xor_sync(0xffffffffu, e2, o);
    if (lane % SEG == 0 && i < kn)
      atomicAdd(&dsum[i / NN], (unsigned long long)e2);
  }
  group_sync<G>();
  // above 2^24, the parts of the reference's order that do not wait on a
  // running sum, on threads of their own (P: E's words, free since the
  // inverse): at 8x8 and 16x16 the eight lanes; at 32x32 per row the
  // lanes 1..7 of its vector, kept as lane 4, lanes 2 + 6 and
  // (1 + 5) + (3 + 7), the terms fold_lanes adds to lane 0 in turn
  float *P = reinterpret_cast<float *>(E);
  const int *o32 = kRow32[a.modes != nullptr];
  if constexpr (N == 8 || N == 16) {
    for (int t = gtid; t < 8 * kc; t += G)
      if (dsum[t / 8] >= (1ull << 24)) {
        const float *g = Gf + (t / 8) * NN;
        P[t] = block_lane(N, t % 8, [g](int i) { return g[i]; });
      }
  } else if constexpr (N == 32) {
    for (int t = gtid; t < 32 * kc; t += G)
      if (dsum[t / 32] >= (1ull << 24)) {
        const float *g = Gf + (t / 32) * NN + (t % 32) * 32;
        float v[8];
        for (int l = 1; l < 8; ++l) {
          v[l] = g[o32[0] * 8 + l];
          for (int k = 1; k < 4; ++k)
            v[l] = __fadd_rn(v[l], g[o32[k] * 8 + l]);
        }
        P[3 * t] = v[4];
        P[3 * t + 1] = __fadd_rn(v[2], v[6]);
        P[3 * t + 2] =
            __fadd_rn(__fadd_rn(v[1], v[5]), __fadd_rn(v[3], v[7]));
      }
  }
  group_sync<G>();
  // each candidate's cost on a thread of its own
  if (gtid < kc) {
    const int c = gtid;
    const unsigned long long tot = dsum[c];
    const float *g = Gf + c * NN;
    float dist;
    if (tot < (1ull << 24)) {
      dist = (float)tot;   // every partial sum of any order is exact
    } else if constexpr (N == 8 || N == 16) {
      dist = fold_lanes(P + 8 * c);
    } else if constexpr (N == 32) {
      // row by row: the running sum enters lane 0, which takes the row's
      // chunks in order; then fold_lanes, lane 0 first
      const float *p = P + 3 * 32 * c;
      dist = 0.0f;
      for (int row = 0; row < 32; ++row) {
        for (int k = 0; k < 4; ++k)
          dist = __fadd_rn(dist, g[row * 32 + o32[k] * 8]);
        dist = __fadd_rn(__fadd_rn(__fadd_rn(dist, p[3 * row]),
                                   p[3 * row + 1]), p[3 * row + 2]);
      }
    } else {
      // raster order, one rounded sum after another
      dist = g[0];
      for (int i = 1; i < NN; ++i) dist = __fadd_rn(dist, g[i]);
    }
    // the nonzero levels' terms in raster order
    float bits = 0.0f;
    bool any = false;
    for (int q = (c * NN) >> 5; q <= (c * NN + NN - 1) >> 5; ++q) {
      uint32_t bm = mask[q];
      int first = 32 * q;
      if constexpr (NN < 32) {   // two candidates share the word
        bm = (bm >> ((c * NN) & 31)) & ((1u << (NN & 31)) - 1);
        first = c * NN;
      }
      any = any || bm != 0;
      while (bm) {
        const int bit = __ffs(bm) - 1;
        bits = __fadd_rn(bits, F[first + bit]);
        bm &= bm - 1;
      }
    }
    bits = __fadd_rn(bits, any ? 10.0f : 1.0f);
    ccost[c] = fmaf(a.lam, bits, dist);
  }
  group_sync<G>();
  if (gtid == 0) {
    float best_cost = ccost[0];
    int best_mode = cand[0];
    for (int c = 1; c < kc; ++c)
      if (ccost[c] < best_cost) {
        best_cost = ccost[c];
        best_mode = cand[c];
      }
    a.cost[id] = best_cost;
    a.mode[id] = best_mode;
  }
}

struct DecideArgs {
  const float *rd4, *rd8, *rd16, *rd32, *rd8f16, *rd16f32;
  const int32_t *m4, *m8, *m16, *m32;
  int by, bx;  // CTUs
  float mode_cost, split_cost, nxn_cost, cut_cost;
  int32_t *depth8, *mode4, *tulog8;
};

// CTUs side by side in a CTA of the decide entry: a warp covers one row of
// their 8x8 cells, a lane a cell
constexpr int kDecideCtus = 8;
constexpr int kDecideThreads = 32 * 4;

// ((s00 + s01) + s10) + s11 of the 2x2 cell at row r, column c of s
template <int W>
__device__ __forceinline__ float sum4s(float (*s)[W], int r, int c) {
  return __fadd_rn(__fadd_rn(__fadd_rn(s[r][c], s[r][c + 1]), s[r + 1][c]),
                   s[r + 1][c + 1]);
}

// A thread per 8x8 cell: CTA (blockIdx.x, blockIdx.y) takes the 8 CTUs
// from column 8 blockIdx.x of CTU row blockIdx.y, warp w their cell row w,
// lane l cell column l, so every load and store of the cell grids (rd8, m8,
// rd8f16, depth8, tulog8) is one 128-byte row segment a warp, and the 2x2
// of rd4, m4 and mode4 under a cell two 8-byte accesses (256 bytes a warp).
// Every load is issued before the first decision. The 16x16 and 32x32
// levels add their cells' values from shared memory in sum4s's order; each
// of a level's threads decides its CU itself.
__global__ void __launch_bounds__(kDecideThreads)
    partition_decide_kernel(DecideArgs a) {
  const int wr = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int cy = blockIdx.y, cx = blockIdx.x * kDecideCtus + (l >> 2);
  const bool live = cx < a.bx;
  const int w4 = a.bx * 8, w8 = a.bx * 4, w16 = a.bx * 2;
  const int gy = cy * 4 + wr, gx = blockIdx.x * 4 * kDecideCtus + l;
  const long long c8 = (long long)gy * w8 + gx;
  const long long c16 = (long long)(cy * 2 + (wr >> 1)) * w16 + (gx >> 1);
  const long long c4 = (long long)(2 * gy) * w4 + 2 * gx;
  const bool nxn = a.rd4 != nullptr, rqt = a.rd8f16 != nullptr;

  float rd8 = 0.0f, rd16 = 0.0f, rd32 = 0.0f, f16 = 0.0f, f32 = 0.0f;
  int m8 = 0, m16 = 0, m32 = 0;
  float2 r4t = make_float2(0.0f, 0.0f), r4b = r4t;
  int2 m4t = make_int2(0, 0), m4b = m4t;
  if (live) {
    rd8 = a.rd8[c8];
    m8 = a.m8[c8];
    rd16 = a.rd16[c16];
    m16 = a.m16[c16];
    rd32 = a.rd32[(long long)cy * a.bx + cx];
    m32 = a.m32[(long long)cy * a.bx + cx];
    if (nxn) {
      r4t = *reinterpret_cast<const float2 *>(a.rd4 + c4);
      r4b = *reinterpret_cast<const float2 *>(a.rd4 + c4 + w4);
      m4t = *reinterpret_cast<const int2 *>(a.m4 + c4);
      m4b = *reinterpret_cast<const int2 *>(a.m4 + c4 + w4);
    }
    if (rqt) {
      f16 = a.rd8f16[c8];
      f32 = a.rd16f32[c16];
    }
  }

  // 8x8: the CU against NxN (strict <)
  float cu8 = __fadd_rn(rd8, a.mode_cost);
  bool take_nxn = false;
  if (nxn) {
    const float split = __fadd_rn(
        __fadd_rn(__fadd_rn(__fadd_rn(r4t.x, r4t.y), r4b.x), r4b.y),
        a.nxn_cost);
    take_nxn = split < cu8;
    cu8 = fminf(cu8, split);
  }
  __shared__ float best8[4][32], sub8[4][32], lvl16[2][16], sub16[2][16];
  best8[wr][l] = cu8;
  sub8[wr][l] = f16;
  __syncthreads();

  // 16x16: the CU over its four cells from row wr & 2, column l & ~1; the
  // TU split strict <, the CU kept against its split at <=
  float cu16 = __fadd_rn(rd16, a.mode_cost);
  bool take16t = false;
  if (rqt) {
    const float cut = __fadd_rn(sum4s(sub8, wr & 2, l & ~1), a.cut_cost);
    take16t = cut < cu16;
    cu16 = fminf(cu16, cut);
  }
  const float split16 =
      __fadd_rn(sum4s(best8, wr & 2, l & ~1), a.split_cost);
  const bool take16 = cu16 <= split16;
  if (!(wr & 1) && !(l & 1)) {
    lvl16[wr >> 1][l >> 1] = take16 ? cu16 : split16;
    sub16[wr >> 1][l >> 1] = f32;
  }
  __syncthreads();

  // 32x32: the CTU over its four 16x16 CUs, columns 2 (l / 4) and the next
  const int k0 = (l >> 2) * 2;
  float cu32 = __fadd_rn(rd32, a.mode_cost);
  bool take32t = false;
  if (rqt) {
    const float cut = __fadd_rn(sum4s(sub16, 0, k0), a.cut_cost);
    take32t = cut < cu32;
    cu32 = fminf(cu32, cut);
  }
  const bool take32 = cu32 <= __fadd_rn(sum4s(lvl16, 0, k0), a.split_cost);
  if (!live) return;

  int depth, tulog;
  if (take32) {
    depth = 0;
    tulog = take32t ? 4 : 5;
  } else if (take16) {
    depth = 1;
    tulog = take16t ? 3 : 4;
  } else {
    depth = take_nxn ? 3 : 2;
    tulog = take_nxn ? 2 : 3;
  }
  a.depth8[c8] = depth;
  a.tulog8[c8] = tulog;
  if (depth != 3) {
    const int m = depth == 0 ? m32 : (depth == 1 ? m16 : m8);
    m4t = m4b = make_int2(m, m);
  }
  *reinterpret_cast<int2 *>(a.mode4 + c4) = m4t;
  *reinterpret_cast<int2 *>(a.mode4 + c4 + w4) = m4b;
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
  const long long blocks = (long long)(h / n) * (w / n);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = [&](auto kernel, size_t smem, int per_cta) -> int {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    const long long grid = (blocks + per_cta - 1) / per_cta;
    if (grid > 0)
      kernel<<<(unsigned)grid, kRdThreads, smem, st>>>(a);
    return (int)cudaGetLastError();
  };
  switch (n) {
    case 4:
      return go(partition_rd_kernel<4>, RdShape<4>::smem(), RdShape<4>::BLOCKS);
    case 8:
      return go(partition_rd_kernel<8>, RdShape<8>::smem(), RdShape<8>::BLOCKS);
    case 16:
      return go(partition_rd_kernel<16>, RdShape<16>::smem(),
                RdShape<16>::BLOCKS);
    case 32:
      return go(partition_rd_kernel<32>, RdShape<32>::smem(),
                RdShape<32>::BLOCKS);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Decide entry. Cost grids float32 and mode grids int32 of a picture of
// by x bx CTUs of 32x32: rd4/m4 [8by, 8bx] (null: no NxN arm), rd8/m8
// [4by, 4bx], rd16/m16 [2by, 2bx], rd32/m32 [by, bx], rd8f16 [4by, 4bx] and
// rd16f32 [2by, 2bx] (both null: no TU-split arm), each contiguous, rd4
// and m4 8-byte aligned. Out: depth8 and tulog8 [4by, 4bx], mode4 [8by,
// 8bx] int32, mode4 8-byte aligned.
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
  if (by < 1 || bx < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((bx + kDecideCtus - 1) / kDecideCtus, by);
  partition_decide_kernel<<<grid, kDecideThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
