// Device code of kernel C9's search, shared by its entries (ss_search.cu)
// and by kernel C14 (ss_scan.cu): the search of one part of a block's
// displacements by one CTA of a cluster (search_part), the merge of the
// parts by one CTA (merge_parts), the scan entry's work on one block
// (search_entry_cluster), and the reference's ordered float sums
// (ordered_sums), which the pre-pass entry (ss_search.cu) takes too. See
// ss_search.cu for what they compute and the float forms they keep.
//
// The searched plane is read with L2-coherent loads (__ldcg): a persistent
// caller reads recon that CTAs on other SMs wrote earlier in the same
// launch. The motion planes are read so too (ss_common.cuh gather_cands).
#pragma once

#include <cooperative_groups.h>

#include "ss_common.cuh"

namespace {

constexpr int kConvBlock = 512;
// the reduction's slots: at most this many threads per CTA
constexpr int kSearchThreads = 256;
// the CTAs of the cluster that searches one block
constexpr int kClusterCtas = 8;
// a non-negative integer sum below this is exact in float32 in any order
constexpr unsigned kExact = 1u << 24;

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

// One part's least cost, its index and SSE, and the anchor ring's least
// cost and index, by jnp.argmin's rule (the first index among equals; a
// masked entry counts as 3e38 at its index). An index of D * D: the part
// holds no displacement.
struct Part {
  float cost, sse, cost2;
  int idx, idx2;
};

// (c, i) <- (c2, i2) where c2 is less, or equal at a lower index
__device__ __forceinline__ bool take_least(float &c, int &i, float c2,
                                           int i2) {
  if (c2 < c || (c2 == c && i2 < i)) {
    c = c2;
    i = i2;
    return true;
  }
  return false;
}

// The reference's float32 corr and ref^2 of one displacement: w0 the
// window at (dy, dx) (row stride W), o the block's original; F10's
// sequential sums with seq, F8's blocked ones otherwise (see ss_search.cu).
template <typename T, typename U>
__device__ void ordered_sums(const T *w0, int W, const U *o, int n, int seq,
                             float &corr, float &ref2) {
  corr = 0.0f;
  ref2 = 0.0f;
  // F10: one accumulator over the whole kernel (the products are exact,
  // so each fmaf is the rounded add)
  for (int ky = 0; seq && ky < n; ++ky) {
    const T *wr = w0 + ky * W;
    const U *orow = o + ky * n;
    // n is a multiple of 8: the loads of eight products go out together
#pragma unroll 8
    for (int kx = 0; kx < n; ++kx) {
      const float wv = (float)wr[kx];
      corr = fmaf(wv, (float)orow[kx], corr);
      ref2 = fmaf(wv, wv, ref2);
    }
  }
  const int rows_per_block = kConvBlock / n < n ? kConvBlock / n : n;
  for (int y0 = 0; !seq && y0 < n; y0 += rows_per_block) {
    float c0 = 0.0f, c1 = 0.0f, q0 = 0.0f, q1 = 0.0f;
    for (int ky = y0; ky < y0 + rows_per_block; ++ky) {
      const T *wr = w0 + ky * W;
      const U *orow = o + ky * n;
#pragma unroll 4
      for (int kx = 0; kx < n; kx += 2) {
        const float w0f = (float)wr[kx], w1f = (float)wr[kx + 1];
        c0 = fmaf(w0f, (float)orow[kx], c0);
        c1 = fmaf(w1f, (float)orow[kx + 1], c1);
        q0 = fmaf(w0f, w0f, q0);
        q1 = fmaf(w1f, w1f, q1);
      }
    }
    const float cs = __fadd_rn(c0, c1), qs = __fadd_rn(q0, q1);
    corr = y0 == 0 ? cs : __fadd_rn(corr, cs);
    ref2 = y0 == 0 ? qs : __fadd_rn(ref2, qs);
  }
}

// Whether displacement (dx, dy) (0 .. D-1 each) of the block at (px, py)
// may be taken: causal, or in the picture for the temporal search
__device__ __forceinline__ bool search_valid(const Search &s, int px, int py,
                                             int dx, int dy, int zcur) {
  const int tx = px + dx - s.radius, ty = py + dy - s.radius;
  return s.zmaxw != nullptr ? causal(s.zmaxw, tx, ty, s.n, s.w, s.h, zcur)
                            : in_picture(tx, ty, s.n, s.w, s.h);
}

// Displacement d of the search: its cost (the SSE plus the rounded rate)
// folded into the thread's (bc, bi, bs) and, where its GT window is causal,
// into the ring's (bc2, bi2)
__device__ __forceinline__ void fold_cost(const Search &s, int px, int py,
                                          int zcur, const int *preds, int np,
                                          int d, float sse, float &bc,
                                          int &bi, float &bs, float &bc2,
                                          int &bi2) {
  const int r = s.radius, D = 2 * r + 1, dy = d / D, dx = d % D;
  const float bits = min_rate_bits(4 * (dx - r), 4 * (dy - r), preds, np);
  // the rate map is rounded on its own, then added (the reference's
  // compiled search)
  const float cost =
      __fadd_rn(sse, __fmul_rn(s.lam, __fadd_rn(bits, kInterBits)));
  if (take_least(bc, bi, cost, d)) bs = sse;
  if (s.zmax2n != nullptr &&
      anchor_causal(s.zmax2n, px + dx - r, py + dy - r, s.n, s.w, s.h, zcur))
    take_least(bc2, bi2, cost, d);
}

// The CTA's per-thread results reduced into a Part (thread 0 writes it):
// the least (cost, index) pair, a minimum in any order, through the warps'
// shuffles, then over the warps. red holds 5 words a warp; blockDim.x is
// a multiple of 32.
__device__ void reduce_part(float bc, int bi, float bs, float bc2, int bi2,
                            float *red, Part &out) {
  const int tid = threadIdx.x, warps = blockDim.x / 32;
  for (int off = 16; off > 0; off >>= 1) {
    const float c = __shfl_down_sync(~0u, bc, off);
    const int i = __shfl_down_sync(~0u, bi, off);
    const float e = __shfl_down_sync(~0u, bs, off);
    const float c2 = __shfl_down_sync(~0u, bc2, off);
    const int i2 = __shfl_down_sync(~0u, bi2, off);
    if (take_least(bc, bi, c, i)) bs = e;
    take_least(bc2, bi2, c2, i2);
  }
  Part *wp = reinterpret_cast<Part *>(red);
  if ((tid & 31) == 0) wp[tid / 32] = Part{bc, bs, bc2, bi, bi2};
  __syncthreads();
  if (tid == 0) {
    Part p = wp[0];
    for (int k = 1; k < warps; ++k) {
      if (take_least(p.cost, p.idx, wp[k].cost, wp[k].idx)) p.sse = wp[k].sse;
      take_least(p.cost2, p.idx2, wp[k].cost2, wp[k].idx2);
    }
    out = p;
  }
  __syncthreads();
}

// The winner of a search from its merged Part p, as the reference reads
// its argmin (thread 0)
__device__ Best finish_best(const Search &s, const Part &p, const int *preds,
                            int np) {
  const int r = s.radius, D = 2 * r + 1;
  Best b;
  int i = p.idx;
  if (i >= D * D) i = 0;   // nothing causal: argmin of all-3e38 is 0
  b.mvx = i % D - r;
  b.mvy = i / D - r;
  b.cost = p.cost;
  b.sse = p.cost < 1e37f ? p.sse : kBig;
  b.amvx = b.amvy = b.aok = 0;
  b.arate = 0.0f;
  if (s.zmax2n != nullptr) {
    int i2 = p.idx2;
    if (i2 >= D * D) i2 = 0;   // no causal GT window: top_k's index 0
    b.amvx = i2 % D - r;
    b.amvy = i2 / D - r;
    b.aok = p.cost2 < 1e37f;
    b.arate = __fmul_rn(
        s.lam,
        __fadd_rn(min_rate_bits(4 * b.amvx, 4 * b.amvy, preds, np),
                  kInterBits));
  }
  return b;
}

// Part p of np of the D * D displacements in row-major order: [d0, d1)
__host__ __device__ inline void part_range(int dd, int p, int np, int &d0,
                                           int &d1) {
  d0 = (int)((long long)dd * p / np);
  d1 = (int)((long long)dd * (p + 1) / np);
}

// Window rows that part [d0, d1) reads
__host__ __device__ inline int part_rows(int n, int radius, int d0, int d1) {
  const int D = 2 * radius + 1;
  return d1 > d0 ? (d1 - 1) / D - d0 / D + n : 0;
}

// Words of one packed window row (4 samples a word, one word of slack)
__host__ __device__ inline int packed_words(int W) { return W / 4 + 2; }

// Shared-memory words of search_part for any part of np: the original
// (int and packed), the part's window rows (int, packed), their row box
// sums of squares, the reduction
__host__ __device__ inline int part_words(int n, int radius, int np) {
  const int D = 2 * radius + 1, W = n + 2 * radius;
  int rows = 0;
  for (int p = 0; p < np; ++p) {
    int d0, d1;
    part_range(D * D, p, np, d0, d1);
    const int r = part_rows(n, radius, d0, d1);
    rows = r > rows ? r : rows;
  }
  return n * n + n * n / 4 + rows * (W + packed_words(W) + D) +
         5 * kSearchThreads;
}

// The masked search of displacements [d0, d1) of the block at (px, py) by
// the CTA, into part (thread 0 writes it; a barrier ends it). Integer sums:
// ref^2 from the window rows' box sums of squares (width n, then n rows),
// corr by __dp4a on packed bytes (samples below 256) or by int32
// multiply-adds (10 bit: 1024 * 1023^2 < 2^31). An entry whose corr and
// ref^2 are below 2^24 takes them as float32, exact in any order; another
// takes the reference's ordered float sums (ordered_sums). sm holds
// part_words(n, r, np) words for the np the caller split into. Thread 0
// runs prep() (the predictors' gather into preds) while the others stage
// the window.
template <class Prep>
__device__ void search_part(const Search &s, int px, int py, int zcur,
                            const int *preds, int np, int d0, int d1,
                            int32_t *sm, Part &part, Prep prep) {
  const int n = s.n, r = s.radius, nn = n * n, W = n + 2 * r, D = 2 * r + 1;
  const int W4 = packed_words(W), nq = n / 4;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int y0 = d0 / D, rows = part_rows(n, r, d0, d1);
  // a part with no valid displacement reads nothing: its least is its
  // first (masked) index at 3e38, as the loop below would find
  int live = 0;
  for (int d = d0 + tid; d < d1; d += nt)
    live |= search_valid(s, px, py, d % D, d / D, zcur);
  if (!__syncthreads_or(live)) {
    if (tid == 0) {
      prep();
      part = Part{kBig, 0.0f, kBig, d1 > d0 ? d0 : D * D, D * D};
    }
    __syncthreads();
    return;
  }
  if (tid == 0) prep();
  int32_t *org = sm;
  uint32_t *ob = reinterpret_cast<uint32_t *>(org + nn);
  int32_t *win = reinterpret_cast<int32_t *>(ob + nn / 4);
  uint32_t *wb = reinterpret_cast<uint32_t *>(win + rows * W);
  int32_t *rs = reinterpret_cast<int32_t *>(wb + rows * W4);
  float *red = reinterpret_cast<float *>(rs + rows * D);
  __shared__ unsigned long long org2_i;
  __shared__ float org2_s;
  if (tid == 0) org2_i = 0;
  int wide = 0;
#pragma unroll 4
  for (int i = tid; i < rows * W; i += nt) {
    const int y = clip3(0, s.h - 1, py - r + y0 + i / W);
    const int x = clip3(0, s.w - 1, px - r + i % W);
    const int v = __ldcg(s.src + (long long)y * s.stride + x);
    win[i] = v;
    wide |= v > 255;
  }
  unsigned long long o2 = 0;
  for (int i = tid; i < nn; i += nt) {
    org[i] = s.org[(long long)(py + i / n) * s.stride + px + i % n];
    wide |= org[i] > 255;
    o2 += (unsigned long long)(org[i] * org[i]);
  }
  wide = __syncthreads_or(wide);
  atomicAdd(&org2_i, o2);
  if (!wide) {
    for (int i = tid; i < rows * W4; i += nt) {
      const int j = i / W4, x = 4 * (i % W4);
      uint32_t v = 0;
      for (int k = 0; k < 4; ++k)
        if (x + k < W) v |= (uint32_t)win[j * W + x + k] << (8 * k);
      wb[i] = v;
    }
    for (int i = tid; i < nn / 4; i += nt)
      ob[i] = (uint32_t)org[4 * i] | (uint32_t)org[4 * i + 1] << 8 |
              (uint32_t)org[4 * i + 2] << 16 | (uint32_t)org[4 * i + 3] << 24;
  }
  // row box sums of squares, eight displacements a task: one sum of n,
  // then a sliding window
  const int nseg = (D + 7) / 8;
  for (int t = tid; t < rows * nseg; t += nt) {
    const int j = t / nseg, x0 = (t % nseg) * 8;
    const int32_t *wr = win + j * W;
    int acc = 0;
    for (int k = 0; k < n; ++k) acc += wr[x0 + k] * wr[x0 + k];
    const int x1 = x0 + 8 < D ? x0 + 8 : D;
    for (int dx = x0; dx < x1; ++dx) {
      rs[j * D + dx] = acc;
      if (dx + 1 < x1) acc += wr[dx + n] * wr[dx + n] - wr[dx] * wr[dx];
    }
  }
  __syncthreads();
  // org^2: exact below 2^24, else the reference's order: the jitted
  // search's (F11, a thread a lane), or with seq the PSS program's
  // block_sum order (a thread a row)
  if (org2_i < kExact) {
    if (tid == 0) org2_s = (float)org2_i;
  } else {
    const auto sq = [&](int i) {
      return __fmul_rn((float)org[i], (float)org[i]);
    };
    const bool rows = s.seq || n % 8 != 0;
    if (tid < (rows ? n : 8))
      red[tid] = rows ? block_row(n, tid, sq) : block_lane(n, tid, sq);
    __syncthreads();
    if (tid == 0) org2_s = rows ? fold_rows(n, red) : fold_lanes(red);
  }
  __syncthreads();
  const float org2 = org2_s;
  float bc = kBig, bs = 0.0f, bc2 = kBig;
  int bi = D * D, bi2 = D * D;
  for (int d = d0 + tid; d < d1; d += nt) {
    const int dy = d / D, dx = d % D, j0 = dy - y0;
    if (!search_valid(s, px, py, dx, dy, zcur)) {
      if (bi == D * D) bi = d;   // a masked first entry, as argmin sees it
      continue;
    }
    unsigned ref2 = 0, corr = 0;
    for (int ky = 0; ky < n; ++ky) ref2 += rs[(j0 + ky) * D + dx];
    if (!wide) {
      const int sh = 8 * (dx & 3);
      for (int ky = 0; ky < n; ++ky) {
        const uint32_t *wr = wb + (j0 + ky) * W4 + (dx >> 2);
        const uint32_t *orow = ob + ky * nq;
        for (int q = 0; q < nq; ++q)
          corr = __dp4a(__funnelshift_r(wr[q], wr[q + 1], sh), orow[q],
                        corr);
      }
    } else {
      for (int ky = 0; ky < n; ++ky) {
        const int32_t *wr = win + (j0 + ky) * W + dx;
        const int32_t *orow = org + ky * n;
        for (int kx = 0; kx < n; ++kx) corr += wr[kx] * orow[kx];
      }
    }
    float fc, fr;
    if (corr < kExact && ref2 < kExact) {
      fc = (float)corr;
      fr = (float)ref2;
    } else {
      ordered_sums(win + j0 * W + dx, W, org, n, s.seq, fc, fr);
    }
    const float sse = __fsub_rn(__fadd_rn(org2, fr), __fmul_rn(2.0f, fc));
    fold_cost(s, px, py, zcur, preds, np, d, sse, bc, bi, bs, bc2, bi2);
  }
  reduce_part(bc, bi, bs, bc2, bi2, red, part);
}

// This CTA's Part, which the merging CTA of its cluster reads
__device__ __forceinline__ Part &cluster_part() {
  __shared__ Part p;
  return p;
}

// The cluster's parts of ranks [first, first + count), merged in rank
// (so index) order by thread 0 into the search's winner, returned to every
// thread of this CTA. Every part must have been written and the cluster
// synced.
__device__ Best merge_parts(const Search &s, int first, int count,
                            const int *preds, int np) {
  namespace cg = cooperative_groups;
  __shared__ Best best_s;
  if (threadIdx.x == 0) {
    cg::cluster_group cl = cg::this_cluster();
    Part &mine = cluster_part();
    Part p = *cl.map_shared_rank(&mine, first);
    for (int q = first + 1; q < first + count; ++q) {
      const Part o = *cl.map_shared_rank(&mine, q);
      if (take_least(p.cost, p.idx, o.cost, o.idx)) p.sse = o.sse;
      take_least(p.cost2, p.idx2, o.cost2, o.idx2);
    }
    best_s = finish_best(s, p, preds, np);
  }
  __syncthreads();
  return best_s;
}

// The scan entry's outputs, per block
struct Found {
  int32_t *mv, *pred;
  float *cost, *sse;
};

// The winner of a search of the block at (px, py) into row b of o (the
// full-pel prediction read from the searched plane, clamped as the window
// is) and, with the ring, into row b of anchor, gt_rate and gt_ok
__device__ void write_found(const Search &q, int b, int px, int py,
                            const Best &best, const Found &o, int32_t *anchor,
                            float *gt_rate, uint8_t *gt_ok) {
  const int n = q.n;
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
    const int y = clip3(0, q.h - 1, py + best.mvy + i / n);
    const int x = clip3(0, q.w - 1, px + best.mvx + i % n);
    o.pred[(long long)b * n * n + i] =
        __ldcg(q.src + (long long)y * q.stride + x);
  }
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

// The scan entry's work on block b at (px, py) over the whole cluster:
// every CTA gathers the block's predictors from the motion planes and
// searches its part (its rank's) of the displacements (the temporal search
// with `temporal`, over q's plane with the temporal predictors and no
// causal test); after a cluster sync the leader merges the parts in rank
// order and writes the MV, cost, SSE and full-pel prediction into row b
// of o, with q.zmax2n the anchor ring into row b of anchor, gt_rate and
// gt_ok. sm holds part_words(q.n, q.radius, cluster size) words. Ends
// with a cluster sync.
__device__ void search_entry_cluster(const Search &q, const Motion &m, int b,
                                     int px, int py, int zcur,
                                     const uint8_t *nbav, const uint8_t *miav,
                                     int mi_size, int ss_idx, bool temporal,
                                     const Found &o, int32_t *anchor,
                                     float *gt_rate, uint8_t *gt_ok,
                                     int32_t *sm) {
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = cl.block_rank(), np = cl.num_blocks();
  const int D = 2 * q.radius + 1;
  __shared__ Cands c;
  const int *preds = temporal ? &c.tpreds[0][0] : &c.preds[0][0];
  const int npred = temporal ? 3 : 6;
  int d0, d1;
  part_range(D * D, rank, np, d0, d1);
  search_part(q, px, py, temporal ? 0 : zcur, preds, npred, d0, d1, sm,
              cluster_part(), [&] {
                gather_cands(m, px, py, q.n, nbav, miav, mi_size, ss_idx,
                             c);
              });
  cl.sync();
  if (rank == 0) {
    const Best best = merge_parts(q, 0, np, preds, npred);
    write_found(q, b, px, py, best, o, anchor, gt_rate, gt_ok);
  }
  cl.sync();
}

}  // namespace
