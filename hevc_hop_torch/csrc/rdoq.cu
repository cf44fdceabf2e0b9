// Kernel C7: RDOQ of a batch of transform blocks, standalone entry.
//
// Replaces hevc_hop_tpu/ops/rdoq.py rdoq_quant (the reference's K3). One
// CTA per block: it loads the block's coefficients into shared memory, runs
// rdoq_block (rdoq.cuh, the device code kernel C3's encode entry runs in
// its RDOQ arm) and writes the signed levels. ops/rdoq.py rdoq_quant calls
// it on CUDA tensors; the level loop reaches the same device code through
// C3, where the coefficients never leave shared memory.
#include "rdoq.cuh"

namespace {

__global__ void rdoq_quant_kernel(const int32_t *coef, const int32_t *scan_id,
                            int32_t *out, int n, int c_idx, int single,
                            RdoqArgs a) {
  extern __shared__ int32_t sm[];
  const int nn = n * n;
  int32_t *C = sm, *Q = C + nn;
  const long long b = blockIdx.x;
  for (int i = threadIdx.x; i < nn; i += blockDim.x) C[i] = coef[b * nn + i];
  __syncthreads();
  const int sid = single ? 0 : scan_id[b];
  rdoq_block(C, Q, n, c_idx, sid, a, reinterpret_cast<char *>(Q + nn));
  for (int i = threadIdx.x; i < nn; i += blockDim.x) out[b * nn + i] = Q[i];
}

}  // namespace

// coef, out [B, n, n] int32; scan_id [B] int32 (read only where the class
// has MDCS, single == 0); args: the class's tables and scalars.
HH_EXPORT int hh_rdoq_quant(const void *coef, const void *scan_id, void *out,
                            int nblocks, int n, int c_idx, int single,
                            const void *args, void *stream) {
  const int nn = n * n;
  const size_t smem = sizeof(int32_t) * 2 * nn + rdoq_scratch_bytes(n);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rdoq_quant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = nn < 32 ? 32 : (nn > 256 ? 256 : nn);
  rdoq_quant_kernel<<<nblocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t *>(coef),
      static_cast<const int32_t *>(scan_id), static_cast<int32_t *>(out), n,
      c_idx, single, *static_cast<const RdoqArgs *>(args));
  return (int)cudaGetLastError();
}
