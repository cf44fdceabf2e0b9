// Kernel C1: H.265 D.3.19 decoded-picture checksum of up to three planes.
//
// Replaces hevc_hop_tpu/ops/hashes.py:18 plane_checksum (called once per
// plane by checksum_digests). One launch covers all planes and writes the
// three sums itself: no fill or copy before or after it.
//
// Bound: device-memory bytes. Each int32 sample is read once and costs a
// handful of integer operations, far below the card's compute rate.
//
// Work list: each plane is cut into bands of whole rows, the rows of a band
// chosen per plane (hevc_hop_torch/ops/hashes.py band_plan) so that every
// band holds about the same number of samples and there are about as many
// bands as the card holds CTAs at once; the bands of the three planes form
// one flat list, and CTA c takes bands c, c + gridDim.x, ... In a band a
// thread takes groups of four neighbouring columns, blockDim.x groups
// apart, kUnroll groups' loads in flight before it adds; y and x follow
// from the band and the group (no division), and the position mask is
// formed once a group: x = 4g + j never crosses a multiple of 256, so the
// mask of column j is the group's mask xor j. A plane whose base and row
// stride are multiples of 16 bytes is read with one 16-byte load a group;
// any other plane, and a row's last group where it is narrower than four,
// with guarded scalar loads (the scalar arm).
//
// Sums in registers, across the warp by shuffles, across the CTA in shared
// memory. Each CTA writes one uint32 partial a plane into the workspace and
// takes a ticket from atomicInc, which wraps the counter back to 0; the
// CTA that draws the last ticket adds the partials and writes the sums
// straight into the caller's pinned host words, so the call's only device
// work is this launch.
// uint32 sums wrap mod 2^32 in any order, so they are exact.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
// partials a plane in the workspace; the counter follows the three rows
constexpr int kMaxCtas = 2048;

struct Plane {
  const int32_t *p;
  int h, w, stride;  // samples
  int rows;          // a band's rows
  int bands;         // ceil(h / rows), 0 for an absent plane
  bool vec;          // 16-byte loads
};

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// the masked sum of the group of four columns from x0 = 4g on row y, nv of
// them inside the plane
template <bool kHigh>
__device__ __forceinline__ uint32_t group_sum(int4 v, int x0, int y, int nv) {
  const uint32_t m = ((uint32_t)x0 ^ ((uint32_t)x0 >> 8) ^ (uint32_t)y ^
                      ((uint32_t)y >> 8)) & 255u;
  const uint32_t s[4] = {(uint32_t)v.x, (uint32_t)v.y, (uint32_t)v.z,
                         (uint32_t)v.w};
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < nv) {
      const uint32_t xm = m ^ (uint32_t)j;
      acc += (s[j] & 255u) ^ xm;
      if (kHigh) acc += (s[j] >> 8) ^ xm;
    }
  return acc;
}

template <bool kHigh>
__device__ __forceinline__ uint32_t band_sum(const Plane &pl, int band) {
  const int y0 = band * pl.rows;
  const int y1 = min(y0 + pl.rows, pl.h);
  const int groups = (pl.w + 3) >> 2, full = pl.w >> 2;
  const int n = (y1 - y0) * groups;
  // this thread's group k = r * groups + g, stepped without a division
  int r = 0, g = threadIdx.x;
  while (g >= groups) {
    g -= groups;
    ++r;
  }
  uint32_t acc = 0;
  for (int k = threadIdx.x; k < n; k += kUnroll * kThreads) {
    int4 v[kUnroll];
    int ys[kUnroll], xs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ys[u] = y0 + r;
      xs[u] = 4 * g;
      v[u] = make_int4(0, 0, 0, 0);
      if (k + u * kThreads < n) {
        const int32_t *q = pl.p + (long long)ys[u] * pl.stride + xs[u];
        if (pl.vec && g < full) {
          v[u] = __ldg(reinterpret_cast<const int4 *>(q));
        } else {
          const int nv = min(4, pl.w - xs[u]);
          v[u].x = __ldg(q);
          if (nv > 1) v[u].y = __ldg(q + 1);
          if (nv > 2) v[u].z = __ldg(q + 2);
          if (nv > 3) v[u].w = __ldg(q + 3);
        }
      }
      g += kThreads;
      while (g >= groups) {
        g -= groups;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (k + u * kThreads < n)
        acc += group_sum<kHigh>(v[u], xs[u], ys[u], min(4, pl.w - xs[u]));
  }
  return acc;
}

// a0, a1 and a2 summed over the CTA, into every thread (all threads call it)
__device__ __forceinline__ void cta_sums(uint32_t &a0, uint32_t &a1,
                                         uint32_t &a2) {
  __shared__ uint32_t red[3][kThreads / 32];
  a0 = warp_sum(a0);
  a1 = warp_sum(a1);
  a2 = warp_sum(a2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = a0;
    red[1][warp] = a1;
    red[2][warp] = a2;
  }
  __syncthreads();
  a0 = a1 = a2 = 0;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) {
    a0 += red[0][i];
    a1 += red[1][i];
    a2 += red[2][i];
  }
}

template <bool kHigh>
__global__ void __launch_bounds__(kThreads)
    checksum_kernel(Plane p0, Plane p1, Plane p2, uint32_t *ws,
                    uint32_t *out) {
  const int b1 = p0.bands, b2 = b1 + p1.bands, nb = b2 + p2.bands;
  uint32_t a0 = 0, a1 = 0, a2 = 0;
  for (int b = blockIdx.x; b < nb; b += gridDim.x) {
    // the plane's fields selected, not indexed: no copy to local memory
    const int k = b < b1 ? 0 : (b < b2 ? 1 : 2);
    const Plane pl = k == 0 ? p0 : (k == 1 ? p1 : p2);
    const int first = k == 0 ? 0 : (k == 1 ? b1 : b2);
    const uint32_t s = band_sum<kHigh>(pl, b - first);
    if (k == 0)
      a0 += s;
    else if (k == 1)
      a1 += s;
    else
      a2 += s;
  }
  cta_sums(a0, a1, a2);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    ws[blockIdx.x] = a0;
    ws[kMaxCtas + blockIdx.x] = a1;
    ws[2 * kMaxCtas + blockIdx.x] = a2;
    __threadfence();
    last = atomicInc(ws + 3 * kMaxCtas, gridDim.x - 1) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // every other CTA's partials are visible: each fenced before its ticket
  __threadfence();
  uint32_t s0 = 0, s1 = 0, s2 = 0;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads) {
    s0 += __ldcg(ws + i);
    s1 += __ldcg(ws + kMaxCtas + i);
    s2 += __ldcg(ws + 2 * kMaxCtas + i);
  }
  __syncthreads();  // red[] is read again below
  cta_sums(s0, s1, s2);
  if (threadIdx.x == 0) {
    out[0] = s0;
    out[1] = s1;
    out[2] = s2;
  }
}

Plane plane_of(const void *p, int h, int w, int stride, int rows, bool on) {
  Plane pl{static_cast<const int32_t *>(p), h, w, stride, rows, 0, false};
  if (on && h > 0 && w > 0) {
    pl.bands = (h + rows - 1) / rows;
    pl.vec = (reinterpret_cast<uintptr_t>(p) & 15) == 0 && (stride & 3) == 0;
  }
  return pl;
}

}  // namespace

// CTAs of the kernel resident on the card at once, at most kMaxCtas: the
// grid that hevc_hop_torch/ops/hashes.py band_plan sizes the bands for;
// and the uint32 words of a stream's workspace.
HH_EXPORT int hh_checksum_ctas(int *ctas, int *ws_words) {
  int dev = 0, sms = 0, lo = 0, hi = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&lo, checksum_kernel<false>,
                                                kThreads, 0);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&hi, checksum_kernel<true>,
                                                kThreads, 0);
  const int per_sm = lo < hi ? lo : hi;
  const int n = sms * (per_sm > 0 ? per_sm : 1);
  *ctas = n < kMaxCtas ? n : kMaxCtas;
  *ws_words = 3 * kMaxCtas + 1;
  return (int)cudaGetLastError();
}

// Plane k: int32 samples, h x w, row stride s (samples), r rows a band.
// grid: CTAs (1 to kMaxCtas). ws: hh_checksum_ctas's ws_words uint32 of
// the caller's stream, its last word 0 before the first call (each call
// leaves it 0).
// out: three uint32 (int32 storage) in pinned host memory, written by the
// launch's last CTA (through the device's mapping of it).
HH_EXPORT int hh_checksum(const void *p0, int h0, int w0, int s0, int r0,
                          const void *p1, int h1, int w1, int s1, int r1,
                          const void *p2, int h2, int w2, int s2, int r2,
                          int nplanes, int bit_depth, int grid, void *ws,
                          void *out, void *stream) {
  if (grid < 1 || grid > kMaxCtas || nplanes < 1 || nplanes > 3 ||
      r0 < 1 || r1 < 1 || r2 < 1)
    return (int)cudaErrorInvalidValue;
  const Plane a = plane_of(p0, h0, w0, s0, r0, true);
  const Plane b = plane_of(p1, h1, w1, s1, r1, nplanes > 1);
  const Plane c = plane_of(p2, h2, w2, s2, r2, nplanes > 2);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint32_t *w = static_cast<uint32_t *>(ws);
  void *mapped = nullptr;
  const cudaError_t e = cudaHostGetDevicePointer(&mapped, out, 0);
  if (e != cudaSuccess) return (int)e;
  uint32_t *o = static_cast<uint32_t *>(mapped);
  if (bit_depth > 8)
    checksum_kernel<true><<<grid, kThreads, 0, st>>>(a, b, c, w, o);
  else
    checksum_kernel<false><<<grid, kThreads, 0, st>>>(a, b, c, w, o);
  return (int)cudaGetLastError();
}
