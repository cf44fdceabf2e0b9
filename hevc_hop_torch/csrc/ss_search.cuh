// Device code of kernel C9's search, shared by its entries (ss_search.cu)
// and by kernel C14 (ss_scan.cu): the masked full search of one block over
// the CTA (search_block) and the scan entry's work on one block
// (search_entry_block). See ss_search.cu for what they compute and the
// float forms they keep.
//
// The searched plane is read with L2-coherent loads (__ldcg): a persistent
// caller reads recon that CTAs on other SMs wrote earlier in the same
// launch. The motion planes are read so too (ss_common.cuh gather_cands).
#pragma once

#include "ss_common.cuh"

namespace {

constexpr int kConvBlock = 512;
// the reduction's slots: at most this many threads per CTA
constexpr int kSearchThreads = 256;

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
  return n * n + 5 * kSearchThreads + W * W;
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
  int *red_idx = reinterpret_cast<int *>(red_cost + kSearchThreads);
  float *red_sse = reinterpret_cast<float *>(red_idx + kSearchThreads);
  float *red_cost2 = red_sse + kSearchThreads;
  int *red_idx2 = reinterpret_cast<int *>(red_cost2 + kSearchThreads);
  float *win = reinterpret_cast<float *>(red_idx2 + kSearchThreads);
  __shared__ float org2_s;
  for (int i = tid; i < W * W; i += nt) {
    const int y = clip3(0, s.h - 1, py - r + i / W);
    const int x = clip3(0, s.w - 1, px - r + i % W);
    win[i] = (float)__ldcg(s.src + (long long)y * s.stride + x);
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

// The scan entry's outputs, per block
struct Found {
  int32_t *mv, *pred;
  float *cost, *sse;
};

// The scan entry's work on block b at (px, py): gather its predictors from
// the motion planes, search (the temporal search with `temporal`, over q's
// plane with the temporal predictors and no causal test), and write the
// MV, cost, SSE and full-pel prediction into row b of o; with q.zmax2n the
// anchor ring into row b of anchor, gt_rate and gt_ok. sm holds
// search_words(q.n, q.radius) words. Ends with a barrier.
__device__ void search_entry_block(const Search &q, const Motion &m, int b,
                                   int px, int py, int zcur,
                                   const uint8_t *nbav, const uint8_t *miav,
                                   int mi_size, int ss_idx, bool temporal,
                                   const Found &o, int32_t *anchor,
                                   float *gt_rate, uint8_t *gt_ok,
                                   float *sm) {
  __shared__ Cands c;
  if (threadIdx.x == 0)
    gather_cands(m, px, py, q.n, nbav, miav, mi_size, ss_idx, c);
  __syncthreads();
  const Best best =
      temporal ? search_block(q, px, py, 0, &c.tpreds[0][0], 3, sm)
               : search_block(q, px, py, zcur, &c.preds[0][0], 6, sm);
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
  __syncthreads();
}

}  // namespace
