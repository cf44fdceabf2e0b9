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
