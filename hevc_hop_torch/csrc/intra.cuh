// Device functions of intra prediction shared by kernel C2 (intra.cu),
// kernel C5 (partition.cu) and kernel C13 (scan.cu): the per-mode
// prediction of one sample from a reference chain, the chain's smoothing,
// its DC value, the Hadamard SATD of a difference block, and C2's whole
// work on one block (intra_block). All int32, bit-exact with H.265
// 8.4.4.2.
//
// Chain layout (ops/intra.py): ref[4N+1], index 0..2N-1 the left column
// bottom-to-top, 2N the corner, 2N+1..4N the top row left-to-right.
#pragma once

#include "common.cuh"

namespace {

struct Tables {
  const int32_t *ext_idx;   // [33, 3N+1]
  const int32_t *pred_idx;  // [33, N, N]
  const int32_t *fact;      // [33, N]
  const int32_t *is_hor;    // [33]
  const int32_t *filt;      // [33]
  const int32_t *had;       // [k, k]
};

struct Refs {
  const int32_t *cu;  // substituted chain
  const int32_t *cf;  // filtered chain (== cu when no filtering)
  int n, log2, c_idx, use_filter, maxv, dc;
};

__device__ __forceinline__ int left_of(const int32_t *c, int n, int y) {
  return c[2 * n - 1 - y];
}
__device__ __forceinline__ int top_of(const int32_t *c, int n, int x) {
  return c[2 * n + 1 + x];
}

// Prediction of mode m at column x, row y (H.265 8.4.4.2.4-6, following
// the reference's predict_all_modes / predict_mode exactly).
__device__ int predict_px(const Refs &r, const Tables &t, int m, int x,
                          int y) {
  const int n = r.n;
  int v;
  if (m == 0) {
    const int32_t *c = r.use_filter ? r.cf : r.cu;
    v = ((n - 1 - x) * left_of(c, n, y) + (x + 1) * top_of(c, n, n) +
         (n - 1 - y) * top_of(c, n, x) + (y + 1) * left_of(c, n, n) + n) >>
        (r.log2 + 1);
  } else if (m == 1) {
    v = r.dc;
    if (r.c_idx == 0 && n < 32) {
      if (x == 0 && y == 0)
        v = (left_of(r.cu, n, 0) + 2 * r.dc + top_of(r.cu, n, 0) + 2) >> 2;
      else if (y == 0)
        v = (top_of(r.cu, n, x) + 3 * r.dc + 2) >> 2;
      else if (x == 0)
        v = (left_of(r.cu, n, y) + 3 * r.dc + 2) >> 2;
    }
  } else {
    const int mi = m - 2;
    const int32_t *c = (t.filt[mi] && r.use_filter) ? r.cf : r.cu;
    const int hor = t.is_hor[mi];
    const int row = hor ? x : y, col = hor ? y : x;  // vertical form
    const int32_t *ext = t.ext_idx + mi * (3 * n + 1);
    const int p = t.pred_idx[(mi * n + row) * n + col];
    const int f = t.fact[mi * n + row];
    const int g0 = c[ext[p]];
    const int g1 = f ? c[ext[p + 1]] : 0;
    v = ((32 - f) * g0 + f * g1 + 16) >> 5;
    if (r.c_idx == 0 && n < 32) {
      const int corner = r.cu[2 * n];
      if (m == 26 && x == 0)
        v = clip3(0, r.maxv,
                  top_of(r.cu, n, 0) + ((left_of(r.cu, n, y) - corner) >> 1));
      if (m == 10 && y == 0)
        v = clip3(0, r.maxv,
                  left_of(r.cu, n, 0) + ((top_of(r.cu, n, x) - corner) >> 1));
    }
  }
  return clip3(0, r.maxv, v);
}

// The 1-2-1 smoothed chain cf of the chain cu (both [4n+1], shared memory),
// and the 32x32 strong bilinear smoothing where `strong` asks for it and
// the chain is flat enough. Called by every thread of the CTA, with cu
// complete; cf is complete on return.
__device__ void filter_chain(const int32_t *cu, int32_t *cf, int n,
                             int bit_depth, int strong) {
  const int L = 4 * n + 1, tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < L; i += nt)
    cf[i] = (i == 0 || i == L - 1)
                ? cu[i]
                : (cu[i - 1] + 2 * cu[i] + cu[i + 1] + 2) >> 2;
  __syncthreads();
  if (strong && n == 32) {
    const int thr = 1 << (bit_depth - 5);
    const int corner = cu[2 * n], top_last = cu[4 * n], left_last = cu[0];
    const bool cond = iabs(corner + top_last - 2 * cu[3 * n]) < thr &&
                      iabs(corner + left_last - 2 * cu[n]) < thr;
    if (cond) {
      for (int i = tid; i < L; i += nt) {
        int v;
        if (i == 0) v = left_last;
        else if (i < 64) {
          const int k = 63 - i;
          v = ((63 - k) * corner + (k + 1) * left_last + 32) >> 6;
        } else if (i == 64) v = corner;
        else if (i < 128) {
          const int k = i - 65;
          v = ((63 - k) * corner + (k + 1) * top_last + 32) >> 6;
        } else v = top_last;
        cf[i] = v;
      }
    }
    __syncthreads();
  }
}

// The references of a block: chain cu, filtered chain cf (null: no
// filtering), and the DC value. Called by every thread of the CTA (whole
// warps): each warp sums the 2n DC samples with a shuffle reduction, an
// integer sum in any order, so no barrier is needed.
__device__ Refs make_refs(const int32_t *cu, const int32_t *cf, int n,
                          int c_idx, int bit_depth) {
  Refs r;
  r.cu = cu;
  r.cf = cf != nullptr ? cf : cu;
  r.n = n;
  r.log2 = 31 - __clz(n);
  r.c_idx = c_idx;
  r.use_filter = cf != nullptr;
  r.maxv = (1 << bit_depth) - 1;
  const int lane = threadIdx.x & 31;
  int s = 0;
  for (int i = lane; i < n; i += 32) s += top_of(cu, n, i) + left_of(cu, n, i);
  s = __reduce_add_sync(0xffffffffu, s);
  r.dc = (s + n) >> (r.log2 + 1);
  return r;
}

// Hadamard SATD of the n x n difference block O (8x8 tiles, 4x4 at n = 4),
// the reference's intra.satd. A [n*n] is scratch, H the k x k Hadamard
// matrix, tsum [16] per-tile sums that are zero on entry and on return.
// Called by every thread of the CTA (blockDim a multiple of 32) with O
// complete; the cost is valid in thread 0 only, and the caller
// synchronises before O or A change. The second stage walks the samples
// tile by tile, so a warp's 32 lanes lie in one tile: a shuffle reduction
// and one shared atomic per warp give the tile sums, and warp 0 reduces
// the normalised tile sums with shuffles (integers: any order is exact).
__device__ int satd_cost(const int32_t *O, int32_t *A, const int32_t *H,
                         int32_t *tsum, int n) {
  const int nn = n * n, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31;
  const int k = n >= 8 ? 8 : 4;
  const int kl = k == 8 ? 3 : 2;
  const int tiles_w = n / k;
  // stage 1: A = H . D within each k x k tile (rows mix)
  for (int i = tid; i < nn; i += nt) {
    const int x = i % n, y = i / n;
    const int ty = y & ~(k - 1), ly = y & (k - 1);
    int s = 0;
    for (int j = 0; j < k; ++j) s += H[ly * k + j] * O[(ty + j) * n + x];
    A[i] = s;
  }
  __syncthreads();
  // stage 2: (H . D) . H (columns mix), absolute sum per tile; sample i in
  // tile order: tile i >> 2kl, row and column within it from the rest
  for (int base = 0; base < nn; base += nt) {
    const int i = base + tid;
    int v = 0;
    if (i < nn) {
      const int ti = i >> (2 * kl), j = i & (k * k - 1);
      const int tx = (ti % tiles_w) * k, y = (ti / tiles_w) * k + (j >> kl);
      const int lx = j & (k - 1);
      int s = 0;
      for (int jj = 0; jj < k; ++jj) s += A[y * n + tx + jj] * H[jj * k + lx];
      v = iabs(s);
    }
    v = __reduce_add_sync(0xffffffffu, v);
    const int first = i - lane;   // the warp's first sample
    if (lane == 0 && first < nn) atomicAdd(&tsum[first >> (2 * kl)], v);
  }
  __syncthreads();
  int cost = 0;
  if (tid < 32) {
    int c = 0;
    if (lane < tiles_w * tiles_w) {
      const int s = tsum[lane];
      c = k == 8 ? (s + 2) >> 2 : (s + 1) >> 1;
      tsum[lane] = 0;
    }
    cost = __reduce_add_sync(0xffffffffu, c);
  }
  return cost;
}


// The plane a block's chain is read from, and what C2's forms read besides
// it: the original (RMD) and the dense residual (the decode epilogue,
// which writes the recon into the plane).
struct IntraPlane {
  int32_t *plane;
  int ph, pw, stride;
  const int32_t *org;
  int org_stride;
  const int32_t *resi;
  int resi_stride;
};

// Shared scratch of intra_block for an n x n block, in int32 words; its
// last word (intra_cost_word) holds the RMD's lowest SATD on return.
__host__ __device__ inline int intra_scratch_words(int n) {
  return 2 * (4 * n + 1) + 4 * n * n + 64 + 19;
}
__host__ __device__ inline int intra_cost_word(int n) {
  return intra_scratch_words(n) - 1;
}

// The substitution of H.265 8.4.4.2.2 on the gathered chain cu [L], by
// every thread of the CTA (blockDim a multiple of 32): each unavailable
// sample takes the last available one at or before it, else the first
// available one; with none available every sample is mid-grey. The "last
// available index at or before i" is an inclusive max-scan of
// (av[i] ? i : -1): shuffles within a warp, the warps' totals through
// shared memory, chunk by chunk of blockDim. An available sample is its
// own source and is never written, so the chain is substituted in place.
// src [L] is scratch.
__device__ void substitute_chain(int32_t *cu, const uint8_t *av, int L,
                                 int bit_depth, int32_t *src) {
  __shared__ int s_wmax[32], s_carry, s_first;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    s_carry = -1;
    s_first = L;
  }
  __syncthreads();
  for (int base = 0; base < L; base += nt) {
    const int i = base + tid;
    const bool here = i < L && av[i];
    int v = here ? i : -1;
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v = max(v, u);
    }
    if (lane == 31) s_wmax[warp] = v;
    if (here) atomicMin(&s_first, i);
    __syncthreads();
    int pre = s_carry;
    for (int w = 0; w < warp; ++w) pre = max(pre, s_wmax[w]);
    v = max(v, pre);
    if (i < L) src[i] = v;
    __syncthreads();
    if (tid == nt - 1) s_carry = v;
    __syncthreads();
  }
  const int first = s_first;
  for (int i = tid; i < L; i += nt)
    if (!av[i])
      cu[i] = first >= L ? 1 << (bit_depth - 1)
                         : cu[src[i] >= 0 ? src[i] : first];
  __syncthreads();
}

// The prediction of `mode` from the chain that intra_block left in sm
// (its cu and cf), into pred [n*n], by every thread of the CTA; ends with
// a barrier. The RMD split of kernel C13 predicts the cluster's best mode
// so on the CTA that codes it.
__device__ void predict_from_chain(const Tables &t, int32_t *sm, int mode,
                                   int n, int c_idx, int bit_depth,
                                   int32_t *pred) {
  const int L = 4 * n + 1, nn = n * n;
  const int use_filter = (c_idx == 0 && n > 4);
  const Refs r = make_refs(sm, use_filter ? sm + L : nullptr, n, c_idx,
                           bit_depth);
  for (int i = threadIdx.x; i < nn; i += blockDim.x)
    pred[i] = predict_px(r, t, mode, i % n, i / n);
  __syncthreads();
}

// Kernel C2's work on the n x n block at (px, py), by every thread of the
// CTA. It gathers the block's 4N+1 reference chain from p.plane
// (coordinates clamped to the plane; L2-coherent loads, since a
// persistent caller reads recon that other SMs wrote after its L1 may
// have cached the line), substitutes the samples that `av` marks
// unavailable (H.265 8.4.4.2.2, substitute_chain), builds the 1-2-1
// filtered chain and the 32x32 strong-smoothed one, and then:
// - mode >= 0, or no original: predicts `mode` into pred [n*n], or, with
//   p.resi, writes clip(prediction + residual) into the plane;
// - else RMD over the modes [m0, m1) (all 35 by default): predicts them
//   one after another, scores each with the 8x8 (4x4 at N = 4) Hadamard
//   SATD against the original, and writes the lowest cost's prediction
//   into pred (none where pred is null); ties go to the lowest mode, as
//   jnp.argmin does. The lowest cost is left in sm[intra_cost_word(n)],
//   so that kernel C13 can merge the parts of a split RMD.
// Returns the mode, in every thread. sm holds intra_scratch_words(n);
// pred may lie in shared or device memory. Ends with a barrier. mark
// (common.cuh) is called where the chain and the prediction are done.
template <class MarkFn = NoMark>
__device__ int intra_block(const IntraPlane &p, const Tables &t, int px,
                           int py, const uint8_t *av, int mode, int n,
                           int c_idx, int bit_depth, int strong, int32_t *sm,
                           int32_t *pred, const MarkFn &mark = MarkFn(),
                           int m0 = 0, int m1 = 35) {
  const int L = 4 * n + 1, nn = n * n;
  int32_t *cu = sm;            // [L]
  int32_t *cf = cu + L;        // [L]
  int32_t *P = cf + L;         // [nn] candidate prediction
  int32_t *B = P + nn;         // [nn] best prediction so far
  int32_t *O = B + nn;         // [nn] original minus candidate
  int32_t *A = O + nn;         // [nn] Hadamard first stage
  int32_t *H = A + nn;         // [64]
  int32_t *tsum = H + 64;      // [16] per-tile sums
  int32_t *flag = tsum + 16;   // [3] improved, best mode, best cost
  const int tid = threadIdx.x, nt = blockDim.x;
  const int maxv = (1 << bit_depth) - 1;

  // gather the chain (the reference's chain_coords, clamped to the plane)
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
    x = clip3(0, p.pw - 1, x);
    y = clip3(0, p.ph - 1, y);
    cu[i] = __ldcg(p.plane + (long long)y * p.stride + x);
  }
  // O and A (2 nn >= L words) hold the scan's source indices
  substitute_chain(cu, av, L, bit_depth, O);

  const int use_filter = (c_idx == 0 && n > 4);
  if (use_filter) filter_chain(cu, cf, n, bit_depth, strong);
  const Refs r = make_refs(cu, use_filter ? cf : nullptr, n, c_idx, bit_depth);
  mark(kMarkChain);

  if (p.org == nullptr || mode >= 0) {
    // one given mode: prediction, or the decode epilogue
    for (int i = tid; i < nn; i += nt) {
      const int x = i % n, y = i / n;
      const int v = predict_px(r, t, mode, x, y);
      if (p.resi != nullptr) {
        const long long row = py + y;
        p.plane[row * p.stride + px + x] =
            clip3(0, maxv, v + p.resi[row * p.resi_stride + px + x]);
      } else {
        pred[i] = v;
      }
    }
    __syncthreads();
    mark(kMarkPredict);
    return mode;
  }

  // RMD: the candidates [m0, m1), Hadamard SATD against the original
  const int k = n >= 8 ? 8 : 4;
  for (int i = tid; i < k * k; i += nt) H[i] = t.had[i];
  for (int i = tid; i < 16; i += nt) tsum[i] = 0;
  if (tid == 0) {
    flag[0] = 0;
    flag[1] = m0;
  }
  int best_cost = 0x7fffffff;  // kept by thread 0
  __syncthreads();

  for (int m = m0; m < m1; ++m) {
    for (int i = tid; i < nn; i += nt) {
      const int x = i % n, y = i / n;
      const int v = predict_px(r, t, m, x, y);
      P[i] = v;
      O[i] = p.org[(long long)(py + y) * p.org_stride + px + x] - v;
    }
    __syncthreads();
    const int cost = satd_cost(O, A, H, tsum, n);
    if (tid == 0) {
      flag[0] = cost < best_cost;
      if (flag[0]) {
        best_cost = cost;
        flag[1] = m;
      }
    }
    __syncthreads();
    if (flag[0] && pred != nullptr)
      for (int i = tid; i < nn; i += nt) B[i] = P[i];
    __syncthreads();
  }
  const int best = flag[1];
  if (tid == 0) flag[2] = best_cost;
  if (pred != nullptr)
    for (int i = tid; i < nn; i += nt) pred[i] = B[i];
  __syncthreads();
  mark(kMarkPredict);
  return best;
}

}  // namespace
