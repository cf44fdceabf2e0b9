// Kernel C1: H.265 D.3.19 decoded-picture checksum of up to three planes.
//
// Replaces hevc_hop_tpu/ops/hashes.py:18 plane_checksum (called once per
// plane by checksum_digests). One launch covers all planes: blockIdx.y picks
// the plane, a grid-stride loop walks its samples.
//
// Bound: device-memory bytes. Each int32 sample is read once and costs a
// handful of integer operations, far below the card's compute rate. The
// design reads rows with neighbouring threads on neighbouring addresses,
// reduces in registers and across the warp with shuffles, and issues one
// 32-bit atomicAdd per warp. Unsigned integer atomics wrap mod 2^32 and are
// order-independent, so the sum is exact whatever the order.
#include "common.cuh"

namespace {

struct Plane {
  const int32_t *p;
  int h, w, stride;
};

__global__ void checksum_kernel(Plane p0, Plane p1, Plane p2, int bit_depth,
                                uint32_t *out) {
  const Plane pl = blockIdx.y == 0 ? p0 : (blockIdx.y == 1 ? p1 : p2);
  const long long total = (long long)pl.h * pl.w;
  uint32_t acc = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const uint32_t y = (uint32_t)(i / pl.w);
    const uint32_t x = (uint32_t)(i - (long long)y * pl.w);
    const uint32_t xm = ((x & 255u) ^ (y & 255u) ^ (x >> 8) ^ (y >> 8)) & 255u;
    const uint32_t v = (uint32_t)pl.p[(long long)y * pl.stride + x];
    acc += (v & 255u) ^ xm;
    if (bit_depth > 8) acc += (v >> 8) ^ xm;
  }
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) atomicAdd(out + blockIdx.y, acc);
}

}  // namespace

// out: three uint32 (passed as int32 storage), zeroed by the caller.
HH_EXPORT int hh_checksum(const void *p0, int h0, int w0, int s0,
                          const void *p1, int h1, int w1, int s1,
                          const void *p2, int h2, int w2, int s2,
                          int nplanes, int bit_depth, void *out,
                          void *stream) {
  const Plane a{static_cast<const int32_t *>(p0), h0, w0, s0};
  const Plane b{static_cast<const int32_t *>(p1), h1, w1, s1};
  const Plane c{static_cast<const int32_t *>(p2), h2, w2, s2};
  long long biggest = (long long)h0 * w0;
  if ((long long)h1 * w1 > biggest) biggest = (long long)h1 * w1;
  if ((long long)h2 * w2 > biggest) biggest = (long long)h2 * w2;
  const int threads = 256;
  int blocks = (int)((biggest + threads - 1) / threads);
  if (blocks > 1024) blocks = 1024;
  if (blocks < 1) blocks = 1;
  checksum_kernel<<<dim3(blocks, nplanes), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      a, b, c, bit_depth, static_cast<uint32_t *>(out));
  return (int)cudaGetLastError();
}
