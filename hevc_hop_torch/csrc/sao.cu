// Kernel C6: sample adaptive offset, statistics and apply, each one launch
// over a picture's planes.
//
// Replaces hevc_hop_tpu/ops/sao.py sao_stats_plane (with _eo_cat, _shifted
// and _tile_sums) and apply_sao_plane, for the three planes that
// stats_dispatch and apply_sao_frame hand them.
//
// A CTA takes one CTU position at a time: the luma CTU (1 << ctb_log2
// samples a side) and the two chroma CTUs beside it (ctb_log2 - 1), or one
// plane's CTU when the launch has one plane. The CTU size is a template
// parameter. The grid is as many CTAs as the card holds at once, each
// stepping over the positions; while it works on one position from shared
// memory, the loads of its next one (16-byte loads of the pre-SAO CTUs
// with a 1-sample halo, 4 columns a side so that they stay aligned, and of
// org) are in flight into registers, which it stores to shared memory
// when it moves on. A thread takes 4 neighbouring samples of a row at a
// time; the cr CTU runs on the threads that cb leaves idle.
//
// A neighbour outside the PICTURE makes the category 0 (the reference's
// validity mask knows only the picture's borders, not the CTU's).
//
// Stats entry. Each sample's four edge categories (the reference's
// EO_LUT) go to the lane's 16 counters in registers, summed over the warp
// by __reduce_add_sync at the end of the plane. Its band goes to the
// warp's 32 band counters in shared memory: a thread first merges its 4
// samples' runs of one band, and where a whole warp's samples fall in one
// band (a flat CTU) the warp adds its __reduce_add_sync total with one
// atomic. A counter holds its count and its sum of org - pre packed as
// count * 2^21 + sum: a warp sees at most 512 samples of a plane's CTU
// (the CTA has 128 threads, 256 at 64x64 CTUs) and |org - pre| <= 1023 (at
// most 10 bits), so |sum| < 2^20 and each warp's total unpacks exactly;
// the warps' totals are summed once a position. Integer sums do not depend
// on the order, so the result is exact. Out: [ncty, nctx, planes, 96]
// int32, per plane EO counts 16 (class x category 1..4), EO sums 16, BO
// counts 32, BO sums 32.
//
// Apply entry. The position's type, band and offsets of each plane (one
// packed [ncty, nctx, planes, 6] int32 tensor: type, band, four offsets)
// come with its samples. An off CTU is written back (clipped, as the
// reference clips every sample), a band-offset CTU reads no neighbour, an
// edge-offset CTU reads its staged neighbours; 16-byte stores where the
// rows are aligned. It writes new planes, because classification reads the
// neighbours' pre-SAO values across CTU borders.
//
// Bound: device-memory bytes. Both entries read each int32 sample once
// and do a few tens of integer operations per sample.
#include "common.cuh"

#include <algorithm>

namespace {

constexpr int kSide = 4;   // staged columns on each side (aligned rows)
constexpr int kPack = 21;  // count * 2^21 + sum
constexpr unsigned kFull = 0xffffffffu;

// threads of a CTA at CTU size 1 << lg: at most 512 samples of a plane's
// CTU a warp
__host__ __device__ constexpr int threads_of(int lg) {
  return lg == 6 ? 256 : 128;
}

__host__ __device__ constexpr int side(int lg, int p) {
  return 1 << (lg - (p > 0));
}

// words and 16-byte quads of a staged CTU of side c
__host__ __device__ constexpr int pitch_of(int c) { return c + 2 * kSide; }
__host__ __device__ constexpr int tile_words(int c) {
  return (c + 2) * pitch_of(c);
}

template <int NP, int LG>
__host__ __device__ constexpr int tiles_words() {
  return tile_words(side(LG, 0)) + (NP - 1) * tile_words(side(LG, 1));
}

// the stats entry's shared memory: the tiles, then the org CTUs
template <int NP, int LG>
__host__ __device__ constexpr int stats_words() {
  return tiles_words<NP, LG>() + side(LG, 0) * side(LG, 0) +
         (NP - 1) * side(LG, 1) * side(LG, 1);
}

struct Planes {
  const int32_t *pre[3];
  const int32_t *org[3];  // stats entry only
  int32_t *out[3];        // apply entry only: dense [h, w]
  int pre_stride[3], org_stride[3];
  int h[3], w[3];
};

__device__ __forceinline__ bool aligned16(const void *p, int stride) {
  return ((reinterpret_cast<uintptr_t>(p) | (uintptr_t)stride * 4) & 15) ==
         0;
}

// The loads of one CTU position, issued into registers while the CTA
// works on the previous one, then stored into shared memory: plane p's CTU
// of side c at [(y + 1) * pitch + kSide + x] of its tile, with a 1-row,
// kSide-column halo (0 outside the plane, never used); with ORG, each
// plane's org CTU (c x c, pitch c) after the tiles (the stats entry's
// planes are CTU-aligned).
template <int LG, int T, bool ORG, int P>
struct PlaneFetch {
  static constexpr int kC = side(LG, P);
  static constexpr int kQuads = tile_words(kC) / 4;
  static constexpr int kPer = (kQuads + T - 1) / T;
  static constexpr int kOrgQuads = kC * kC / 4;
  static constexpr int kPerO = ORG ? (kOrgQuads + T - 1) / T : 0;
  int4 q[kPer];
  int4 o[kPerO > 0 ? kPerO : 1];

  __device__ void load(const Planes &pl, int cy, int cx) {
    constexpr int quads = pitch_of(kC) / 4, lg = LG - (P > 0);
    const int h = pl.h[P], w = pl.w[P], stride = pl.pre_stride[P];
    const int32_t *src = pl.pre[P];
    const bool vec = aligned16(src, stride) && (w & 3) == 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = threadIdx.x + k * T;
      const int r = i / quads, v = i - r * quads;
      const int gy = (cy << lg) - 1 + r, gx = (cx << lg) - kSide + 4 * v;
      q[k] = make_int4(0, 0, 0, 0);
      if (i < kQuads && gy >= 0 && gy < h && gx >= 0 && gx < w) {
        const int32_t *s = src + (long long)gy * stride + gx;
        if (vec) {
          q[k] = *reinterpret_cast<const int4 *>(s);
        } else {
          q[k].x = s[0];
          if (gx + 1 < w) q[k].y = s[1];
          if (gx + 2 < w) q[k].z = s[2];
          if (gx + 3 < w) q[k].w = s[3];
        }
      }
    }
    if constexpr (ORG) {
      const int ostride = pl.org_stride[P];
      const int32_t *org = pl.org[P];
      const bool ovec = aligned16(org, ostride);
#pragma unroll
      for (int k = 0; k < kPerO; ++k) {
        const int i = threadIdx.x + k * T;
        const int y = i / (kC / 4), x = 4 * (i - y * (kC / 4));
        o[k] = make_int4(0, 0, 0, 0);
        if (i < kOrgQuads) {
          const int32_t *s =
              org + (long long)((cy << lg) + y) * ostride + (cx << lg) + x;
          o[k] = ovec ? *reinterpret_cast<const int4 *>(s)
                      : make_int4(s[0], s[1], s[2], s[3]);
        }
      }
    }
  }

  __device__ void store(int32_t *tile, int32_t *org) const {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = threadIdx.x + k * T;
      if (i < kQuads) *reinterpret_cast<int4 *>(tile + 4 * i) = q[k];
    }
#pragma unroll
    for (int k = 0; k < kPerO; ++k) {
      const int i = threadIdx.x + k * T;
      if (i < kOrgQuads) *reinterpret_cast<int4 *>(org + 4 * i) = o[k];
    }
  }
};

// offsets in shared memory: the tiles of planes 0 .. NP - 1, then the org
// CTUs
template <int LG>
__host__ __device__ constexpr int tile_at(int p) {
  return p == 0 ? 0 : tile_words(side(LG, 0)) + (p - 1) * tile_words(side(LG, 1));
}

template <int NP, int LG>
__host__ __device__ constexpr int org_at(int p) {
  return tiles_words<NP, LG>() +
         (p == 0 ? 0 : side(LG, 0) * side(LG, 0) + (p - 1) * side(LG, 1) * side(LG, 1));
}

template <int NP, int LG, int T, bool ORG>
struct Fetch {
  PlaneFetch<LG, T, ORG, 0> f0;
  PlaneFetch<LG, T, ORG, 1> f1;
  PlaneFetch<LG, T, ORG, 2> f2;

  __device__ void load(const Planes &pl, int cy, int cx) {
    f0.load(pl, cy, cx);
    if constexpr (NP == 3) {
      f1.load(pl, cy, cx);
      f2.load(pl, cy, cx);
    }
  }

  __device__ void store(int32_t *smem) const {
    f0.store(smem + tile_at<LG>(0), smem + org_at<NP, LG>(0));
    if constexpr (NP == 3) {
      f1.store(smem + tile_at<LG>(1), smem + org_at<NP, LG>(1));
      f2.store(smem + tile_at<LG>(2), smem + org_at<NP, LG>(2));
    }
  }
};

// sign(v - a) + sign(v - b): the category is EO_LUT = (1, 2, 0, 3, 4) at
// this + 2
__device__ __forceinline__ int sgn(int x) { return max(-1, min(1, x)); }

__device__ __forceinline__ void unpack(int t, int &cnt, int &sum) {
  cnt = (t + (1 << (kPack - 1))) >> kPack;
  sum = t - cnt * (1 << kPack);
}

// 4 neighbouring samples of a staged row from t[0], with one neighbour on
// each side: r[0] = t[-1] .. r[5] = t[4]
__device__ __forceinline__ void row6(const int32_t *t, int r[6]) {
  const int4 q = *reinterpret_cast<const int4 *>(t);
  r[0] = t[-1];
  r[1] = q.x;
  r[2] = q.y;
  r[3] = q.z;
  r[4] = q.w;
  r[5] = t[4];
}

// the four classes' counters of one sample: s the class's sum of signs
// (categories 1, 2, 3, 4 at -2, -1, 1, 2)
__device__ __forceinline__ void add_eo(int *acc, int s, int val) {
  if (s == -2) acc[0] += val;
  if (s == -1) acc[1] += val;
  if (s == 1) acc[2] += val;
  if (s == 2) acc[3] += val;
}

// One plane's CTU counted into the warp's band counters bo[32] and the
// warp's edge totals eo[32] (lane j < 16 writes counter j's count and sum).
template <int NP, int LG, int T, int P>
__device__ __forceinline__ void count_plane(const Planes &pl,
                                            const int32_t *smem, int cy,
                                            int cx, int shift, int32_t *bo,
                                            int32_t *eo) {
  constexpr int lg = LG - (P > 0), c = 1 << lg, pitch = pitch_of(c);
  constexpr int quads = c / 4, nq = c * quads;
  const int tid = threadIdx.x, lane = tid & 31;
  const int h = pl.h[P], w = pl.w[P];
  const int32_t *tile = smem + tile_at<LG>(P);
  const int32_t *org = smem + org_at<NP, LG>(P);
  int acc[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) acc[j] = 0;
  // where the two chroma CTUs fit in half the threads each, cr takes the
  // upper half: every thread then runs at most one chroma quad
  const int me = P == 2 && 2 * nq <= T ? (tid + T / 2) % T : tid;
#pragma unroll
  for (int base = 0; base < nq; base += T) {
    const int i = me + base;
    const bool on = i < nq;
    // every lane takes part in the warp's votes (an idle lane agrees)
    const unsigned m = __ballot_sync(kFull, on);
    if (m == 0) continue;  // the same for every lane of the warp
    const int ii = on ? i : 0;
    const int y = ii / quads, x = 4 * (ii % quads);
    const int gy = (cy << lg) + y, gx = (cx << lg) + x;
    const int32_t *t = tile + (y + 1) * pitch + kSide + x;
    int u[6], r[6], d[6];
    row6(t - pitch, u);
    row6(t, r);
    row6(t + pitch, d);
    const int4 oq = *reinterpret_cast<const int4 *>(org + 4 * ii);
    const int ov[4] = {oq.x, oq.y, oq.z, oq.w};
    const bool ud = on && gy > 0 && gy < h - 1;
    // horizontal signs, each shared by two samples
    int sh[5];
#pragma unroll
    for (int j = 0; j < 5; ++j) sh[j] = sgn(r[j + 1] - r[j]);
    int run_b = (r[1] >> shift) & 31, run = 0, nruns = 1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int v = r[j + 1];
      const int val = (1 << kPack) + ov[j] - v;
      const bool lr = on && gx + j > 0 && gx + j < w - 1;
      if (lr) add_eo(acc + 0, sh[j] - sh[j + 1], val);
      if (ud) {
        add_eo(acc + 4, sgn(v - u[j + 1]) + sgn(v - d[j + 1]), val);
        if (lr) {
          add_eo(acc + 8, sgn(v - u[j]) + sgn(v - d[j + 2]), val);
          add_eo(acc + 12, sgn(v - u[j + 2]) + sgn(v - d[j]), val);
        }
      }
      // runs of one band: the last run waits for the warp's vote
      const int b = (v >> shift) & 31;
      if (b != run_b) {
        if (on) atomicAdd(&bo[run_b], run);
        run_b = b;
        run = 0;
        ++nruns;
      }
      run += val;
    }
    // a flat warp: every lane one run, all of one band
    const int b0 = __shfl_sync(kFull, run_b, __ffs(m) - 1);
    if (__all_sync(kFull, !on || (nruns == 1 && run_b == b0))) {
      const int tot = __reduce_add_sync(kFull, on ? run : 0);
      if (lane == 0) atomicAdd(&bo[b0], tot);
    } else if (on) {
      atomicAdd(&bo[run_b], run);
    }
  }
  // lane j < 16 keeps counter j's warp total
  int cnt = 0, sum = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int tot = __reduce_add_sync(kFull, acc[j]);
    if (lane == j) unpack(tot, cnt, sum);
  }
  if (lane < 16) {
    eo[lane] = cnt;
    eo[16 + lane] = sum;
  }
}

template <int NP, int LG>
__global__ void __launch_bounds__(threads_of(LG))
    sao_stats_kernel(Planes pl, int bit_depth, int ncty, int nctx,
                     int32_t *out) {
  constexpr int T = threads_of(LG), NW = T / 32;
  extern __shared__ __align__(16) int32_t smem[];  // stats_words
  __shared__ int32_t bo[NP][NW][32];  // packed, per warp
  __shared__ int32_t eo[NP][NW][32];  // per warp: counts 16, sums 16
  const int tid = threadIdx.x, warp = tid >> 5;
  const int shift = bit_depth - 5, n = ncty * nctx;
  Fetch<NP, LG, T, true> fetch;
  if (blockIdx.x < n) fetch.load(pl, blockIdx.x / nctx, blockIdx.x % nctx);
  for (int pos = blockIdx.x; pos < n; pos += gridDim.x) {
    const int cy = pos / nctx, cx = pos - cy * nctx;
    __syncthreads();  // the last position is written out
    fetch.store(smem);
    for (int i = tid; i < NP * NW * 32; i += T) (&bo[0][0][0])[i] = 0;
    __syncthreads();
    // the next position's loads fly while this one is counted
    const int next = pos + gridDim.x;
    if (next < n) fetch.load(pl, next / nctx, next % nctx);
    count_plane<NP, LG, T, 0>(pl, smem, cy, cx, shift, bo[0][warp],
                              eo[0][warp]);
    if constexpr (NP == 3) {
      count_plane<NP, LG, T, 1>(pl, smem, cy, cx, shift, bo[1][warp],
                                eo[1][warp]);
      count_plane<NP, LG, T, 2>(pl, smem, cy, cx, shift, bo[2][warp],
                                eo[2][warp]);
    }
    __syncthreads();
    int32_t *dst = out + (long long)pos * NP * 96;
    for (int i = tid; i < NP * 96; i += T) {
      const int p = i / 96, j = i - p * 96;
      int r = 0;
      for (int wp = 0; wp < NW; ++wp) {
        if (j < 32) {
          r += eo[p][wp][j];
        } else {
          int c, s;
          unpack(bo[p][wp][(j - 32) & 31], c, s);
          r += j < 64 ? c : s;
        }
      }
      dst[i] = r;
    }
  }
}

template <int NP, int LG>
__global__ void __launch_bounds__(threads_of(LG))
    sao_apply_kernel(Planes pl, const int32_t *params, int bit_depth,
                     int ncty, int nctx) {
  constexpr int T = threads_of(LG);
  extern __shared__ __align__(16) int32_t smem[];  // tiles_words
  __shared__ int32_t prm[NP * 6];
  const int tid = threadIdx.x, n = ncty * nctx;
  const int maxv = (1 << bit_depth) - 1, shift = bit_depth - 5;
  Fetch<NP, LG, T, false> fetch;
  int pv = 0;  // thread tid < NP * 6: its parameter of the position
  if (blockIdx.x < n) {
    fetch.load(pl, blockIdx.x / nctx, blockIdx.x % nctx);
    if (tid < NP * 6) pv = params[(long long)blockIdx.x * NP * 6 + tid];
  }
  for (int pos = blockIdx.x; pos < n; pos += gridDim.x) {
    const int cy = pos / nctx, cx = pos - cy * nctx;
    __syncthreads();  // the last position's tiles are read
    fetch.store(smem);
    if (tid < NP * 6) prm[tid] = pv;
    __syncthreads();
    const int next = pos + gridDim.x;
    if (next < n) {
      fetch.load(pl, next / nctx, next % nctx);
      if (tid < NP * 6) pv = params[(long long)next * NP * 6 + tid];
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int lg = LG - (p > 0), c = 1 << lg, pitch = pitch_of(c);
      const int type = prm[p * 6], band = prm[p * 6 + 1];
      const int32_t *off = prm + p * 6 + 2;
      const int h = pl.h[p], w = pl.w[p];
      const int32_t *tile = smem + tile_at<LG>(p);
      int32_t *dst = pl.out[p];
      const bool vec = aligned16(dst, w);
      const int quads = c / 4;
      const int me = p == 2 && 2 * c * quads <= T ? (tid + T / 2) % T : tid;
      for (int i = me; i < c * quads; i += T) {
        const int y = i / quads, x = 4 * (i - y * quads);
        const int gy = (cy << lg) + y, gx = (cx << lg) + x;
        if (gy >= h || gx >= w) continue;
        const int32_t *t = tile + (y + 1) * pitch + kSide + x;
        const int4 q = *reinterpret_cast<const int4 *>(t);
        int e[4] = {q.x, q.y, q.z, q.w};
        if (type == 1) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int rel = ((e[j] >> shift) - band) & 31;
            e[j] += rel < 4 ? off[rel] : 0;
          }
        } else if (type >= 2 && type <= 5) {
          // neighbour offsets of the class: hor, ver, 135 deg, 45 deg
          const int d = type == 2 ? 1 : (type == 3 ? pitch
                                         : (type == 4 ? pitch + 1 : pitch - 1));
          const bool ud = gy > 0 && gy < h - 1;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool lr = gx + j > 0 && gx + j < w - 1;
            const bool ok = type == 2 ? lr : (type == 3 ? ud : lr && ud);
            const int s = sgn(e[j] - t[j - d]) + sgn(e[j] - t[j + d]);
            // categories 1, 2, 3, 4 at s = -2, -1, 1, 2
            if (ok && s != 0) e[j] += off[s < 0 ? s + 2 : s + 1];
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) e[j] = clip3(0, maxv, e[j]);
        int32_t *o = dst + (long long)gy * w + gx;
        if (vec && gx + 4 <= w) {
          *reinterpret_cast<int4 *>(o) = make_int4(e[0], e[1], e[2], e[3]);
        } else {
          for (int j = 0; j < 4 && gx + j < w; ++j) o[j] = e[j];
        }
      }
    }
  }
}

Planes planes_of(int nplanes, const void *const *pre, const int *pre_stride,
                 const int *h, const int *w) {
  Planes pl{};
  for (int p = 0; p < nplanes; ++p) {
    pl.pre[p] = static_cast<const int32_t *>(pre[p]);
    pl.pre_stride[p] = pre_stride[p];
    pl.h[p] = h[p];
    pl.w[p] = w[p];
  }
  return pl;
}

// CTAs of the kernel resident on the card at once: the grid of the
// entries, whose CTAs step over the CTU positions
template <class K>
int resident_ctas(K kernel, int threads, int smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  return sms * (per_sm > 0 ? per_sm : 1);
}

template <int NP, int LG>
int launch(bool stats, const Planes &pl, const int32_t *params, int ncty,
           int nctx, int bit_depth, int32_t *out, cudaStream_t s) {
  const int n = ncty * nctx;
  if (stats) {
    constexpr int bytes = stats_words<NP, LG>() * (int)sizeof(int32_t);
    // above 48 KB (three planes of 64x64 CTUs) the launch needs the
    // attribute; both are set once
    static const int opt_in =
        bytes > (48 << 10)
            ? (int)cudaFuncSetAttribute(
                  sao_stats_kernel<NP, LG>,
                  cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
            : 0;
    if (opt_in != 0) return opt_in;
    static const int ctas =
        resident_ctas(sao_stats_kernel<NP, LG>, threads_of(LG), bytes);
    sao_stats_kernel<NP, LG><<<std::min(n, ctas), threads_of(LG), bytes, s>>>(
        pl, bit_depth, ncty, nctx, out);
  } else {
    constexpr int bytes = tiles_words<NP, LG>() * (int)sizeof(int32_t);
    static const int ctas =
        resident_ctas(sao_apply_kernel<NP, LG>, threads_of(LG), bytes);
    sao_apply_kernel<NP, LG><<<std::min(n, ctas), threads_of(LG), bytes, s>>>(
        pl, params, bit_depth, ncty, nctx);
  }
  return (int)cudaGetLastError();
}

template <int NP>
int launch_lg(bool stats, const Planes &pl, const int32_t *params, int ncty,
              int nctx, int ctb_log2, int bit_depth, int32_t *out,
              cudaStream_t s) {
  switch (ctb_log2) {
    case 3:
      return launch<NP, 3>(stats, pl, params, ncty, nctx, bit_depth, out, s);
    case 4:
      return launch<NP, 4>(stats, pl, params, ncty, nctx, bit_depth, out, s);
    case 5:
      return launch<NP, 5>(stats, pl, params, ncty, nctx, bit_depth, out, s);
    case 6:
      return launch<NP, 6>(stats, pl, params, ncty, nctx, bit_depth, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int launch_any(bool stats, int nplanes, const Planes &pl,
               const int32_t *params, int ncty, int nctx, int ctb_log2,
               int bit_depth, int32_t *out, void *stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (nplanes == 3)
    return launch_lg<3>(stats, pl, params, ncty, nctx, ctb_log2, bit_depth,
                        out, s);
  if (nplanes == 1)
    return launch_lg<1>(stats, pl, params, ncty, nctx, ctb_log2, bit_depth,
                        out, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Stats entry. nplanes 1 (one plane at ctb_log2) or 3 (luma at ctb_log2,
// chroma at ctb_log2 - 1); per plane org and pre int32 [h, w] with row
// strides, h and w multiples of the plane's CTU side, the same CTU grid
// [ncty, nctx] for every plane; ctb_log2 3 to 6 (4 to 6 with three
// planes); samples of at most 10 bits. out int32 [ncty, nctx, nplanes, 96].
HH_EXPORT int hh_sao_stats(int nplanes, const void *const *org,
                           const int *org_stride, const void *const *pre,
                           const int *pre_stride, const int *h, const int *w,
                           int ncty, int nctx, int ctb_log2, int bit_depth,
                           void *out, void *stream) {
  Planes pl = planes_of(nplanes, pre, pre_stride, h, w);
  for (int p = 0; p < nplanes; ++p) {
    pl.org[p] = static_cast<const int32_t *>(org[p]);
    pl.org_stride[p] = org_stride[p];
  }
  return launch_any(true, nplanes, pl, nullptr, ncty, nctx, ctb_log2,
                    bit_depth, static_cast<int32_t *>(out), stream);
}

// Apply entry. pre int32 [h, w] per plane with row strides (the CTU grid
// [ncty, nctx] may overhang the picture); params int32 [ncty, nctx,
// nplanes, 6] (type 0 off, 1 BO, 2 + class EO; band; four offsets); out
// new dense int32 [h, w] per plane.
HH_EXPORT int hh_sao_apply(int nplanes, const void *const *pre,
                           const int *pre_stride, void *const *out,
                           const int *h, const int *w, const void *params,
                           int ncty, int nctx, int ctb_log2, int bit_depth,
                           void *stream) {
  Planes pl = planes_of(nplanes, pre, pre_stride, h, w);
  for (int p = 0; p < nplanes; ++p) pl.out[p] = static_cast<int32_t *>(out[p]);
  return launch_any(false, nplanes, pl,
                    static_cast<const int32_t *>(params), ncty, nctx,
                    ctb_log2, bit_depth, nullptr, stream);
}
