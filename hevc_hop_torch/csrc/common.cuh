// Shared helpers for the hand-written kernels of hevc_hop_torch.
//
// Each .cu file is built on its own into a shared library with a plain C
// interface (see hevc_hop_torch/_cuda.py). Every entry point launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError() so that
// a refused launch is reported to Python at once.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define HH_EXPORT extern "C" __attribute__((visibility("default")))

HH_EXPORT const char *hh_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

__device__ __forceinline__ int clip3(int lo, int hi, int v) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int iabs(int v) { return v < 0 ? -v : v; }

__device__ __forceinline__ int isign(int v) { return (v > 0) - (v < 0); }

// float32 sum of the n x n terms t(i) (n a multiple of 8) in an order
// XLA:CPU compiles for several of the reference's reductions (the jitted
// searches' org^2, F11, ops/ss_search.py lane_block_sum; rd_costs' SSE at
// 8x8 and 16x16, F12, models/partition.py block_dist): eight vector lanes,
// lane l adding rows l, l + 8, ... in row-major order (block_lane), then
// the lanes by halves, (l, l + 4), (k, k + 2), (0, 1) (fold_lanes). A CTA
// runs block_lane a thread a lane, then fold_lanes in one.
template <typename F>
__device__ __forceinline__ float block_lane(int n, int l, F t) {
  float acc = t(l * n);
  for (int c = 1; c < n; ++c) acc = __fadd_rn(acc, t(l * n + c));
  for (int r = l + 8; r < n; r += 8)
    for (int c = 0; c < n; ++c) acc = __fadd_rn(acc, t(r * n + c));
  return acc;
}

__device__ __forceinline__ float fold_lanes(const float *s) {
  const float b0 = __fadd_rn(__fadd_rn(s[0], s[4]), __fadd_rn(s[2], s[6]));
  const float b1 = __fadd_rn(__fadd_rn(s[1], s[5]), __fadd_rn(s[3], s[7]));
  return __fadd_rn(b0, b1);
}

// Stage hooks of the shared bodies (intra_block, tq_encode_block): each
// calls mark(k), by every thread of the CTA, where its stage k ends. The
// stage-clock builds of kernels C13 (scan.cu) and C14 (ss_scan.cu, its
// write phase; -DHH_STAGE_CLOCK) pass a functor that stamps a clock there;
// every other caller passes NoMark, which compiles to nothing.
enum Mark { kMarkChain, kMarkPredict, kMarkFwd, kMarkQuant, kMarkSbh,
            kMarkRecon, kMarks };
struct NoMark {
  __device__ __forceinline__ void operator()(int) const {}
};

// Stage clocks, only in the libraries built with -DHH_STAGE_CLOCK (C13's
// scan.cu, C14's ss_scan.cu, C9's pre-pass in ss_search.cu): the
// %globaltimer's nanoseconds (one clock for every SM), the CTA's SM, and
// a CTA's row of stage slots, to which thread 0 adds the nanoseconds since
// its last mark (a barrier first). A null row is off.
#ifdef HH_STAGE_CLOCK
__device__ __forceinline__ long long clock_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned clock_sm() {
  unsigned sm;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
  return sm;
}
struct StageClock {
  long long *row = nullptr;
  mutable long long last = 0;
  __device__ void begin(long long *r) {
    row = threadIdx.x == 0 ? r : nullptr;
    if (row != nullptr) last = clock_ns();
  }
  __device__ void add(int k) const {
    __syncthreads();
    if (row != nullptr) {
      const long long t = clock_ns();
      row[k] += t - last;
      last = t;
    }
  }
};
#endif
