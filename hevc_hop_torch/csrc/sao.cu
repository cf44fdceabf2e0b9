// Kernel C6: sample adaptive offset, statistics and apply.
//
// Replaces hevc_hop_tpu/ops/sao.py sao_stats_plane (with _eo_cat, _shifted
// and _tile_sums) and apply_sao_plane.
//
// Stats entry, one CTA per CTU: every sample of the CTU is classified for
// the four edge classes (sign of the differences to its two neighbours, the
// reference's EO_LUT) and for its band, and its count and its difference
// org - pre are added to the CTU's 96 counters in shared memory (4 classes x
// 4 categories and 32 bands, count and sum each). The counters go to device
// memory once per CTU. Integer sums do not depend on the order of the
// atomics, so the result is exact.
// Apply entry, one thread per sample: the sample's CTU gives type, offsets
// and band position; the offset of the sample's category or band is added
// and the result clipped. It writes a new plane, because classification
// reads the neighbours' pre-SAO values across CTU borders.
//
// A neighbour outside the PICTURE makes the category 0 (the reference's
// validity mask knows only the picture's borders, not the CTU's).
//
// Bound: device-memory bytes. Both entries read each int32 sample once (the
// neighbours come from cache) and do a few tens of integer operations per
// sample. The design reads rows with neighbouring threads on neighbouring
// addresses and keeps the counters in shared memory; shared-memory atomics
// on one hot counter (a flat CTU puts every sample into one band) serialise,
// which is what a later pass would attack with per-warp counters.
#include "common.cuh"

namespace {

__device__ __forceinline__ int eo_category(const int32_t *p, int stride, int h,
                                           int w, int x, int y, int cls) {
  // neighbour offsets (dy, dx) of the class: hor, ver, 135 deg, 45 deg
  const int dy0 = cls == 0 ? 0 : -1;
  const int dx0 = cls == 1 ? 0 : (cls == 3 ? 1 : -1);
  const int y0 = y + dy0, x0 = x + dx0, y1 = y - dy0, x1 = x - dx0;
  if (y0 < 0 || y1 >= h || x0 < 0 || x0 >= w || x1 < 0 || x1 >= w) return 0;
  const int c = p[(long long)y * stride + x];
  const int s = isign(c - p[(long long)y0 * stride + x0]) +
                isign(c - p[(long long)y1 * stride + x1]);
  // EO_LUT = (1, 2, 0, 3, 4) at s + 2
  return s == -2 ? 1 : (s == -1 ? 2 : (s == 0 ? 0 : (s == 1 ? 3 : 4)));
}

__global__ void sao_stats_kernel(const int32_t *org, int org_stride,
                                 const int32_t *pre, int pre_stride, int h,
                                 int w, int ctb_log2, int bit_depth,
                                 int32_t *out) {
  __shared__ int32_t cnt[96];  // eo_cnt 16, eo_sum 16, bo_cnt 32, bo_sum 32
  const int tid = threadIdx.x, nt = blockDim.x;
  const int c = 1 << ctb_log2;
  const int cx = blockIdx.x, cy = blockIdx.y;
  for (int i = tid; i < 96; i += nt) cnt[i] = 0;
  __syncthreads();
  for (int i = tid; i < c * c; i += nt) {
    const int x = (cx << ctb_log2) + (i & (c - 1));
    const int y = (cy << ctb_log2) + (i >> ctb_log2);
    const int v = pre[(long long)y * pre_stride + x];
    const int d = org[(long long)y * org_stride + x] - v;
    for (int cls = 0; cls < 4; ++cls) {
      const int k = eo_category(pre, pre_stride, h, w, x, y, cls);
      if (k > 0) {
        atomicAdd(&cnt[cls * 4 + k - 1], 1);
        atomicAdd(&cnt[16 + cls * 4 + k - 1], d);
      }
    }
    const int b = (v >> (bit_depth - 5)) & 31;
    atomicAdd(&cnt[32 + b], 1);
    atomicAdd(&cnt[64 + b], d);
  }
  __syncthreads();
  int32_t *o = out + ((long long)cy * gridDim.x + cx) * 96;
  for (int i = tid; i < 96; i += nt) o[i] = cnt[i];
}

__global__ void sao_apply_kernel(const int32_t *pre, int stride,
                                 const int32_t *type_map, const int32_t *offs,
                                 const int32_t *band, int h, int w, int nctx,
                                 int ctb_log2, int bit_depth, int32_t *out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= w) return;
  const int ctu = (y >> ctb_log2) * nctx + (x >> ctb_log2);
  const int t = type_map[ctu];
  const int v = pre[(long long)y * stride + x];
  int add = 0;
  if (t == 1) {
    const int rel = ((v >> (bit_depth - 5)) - band[ctu]) & 31;
    if (rel < 4) add = offs[ctu * 4 + rel];
  } else if (t >= 2 && t <= 5) {
    const int k = eo_category(pre, stride, h, w, x, y, t - 2);
    if (k > 0) add = offs[ctu * 4 + k - 1];
  }
  out[(long long)y * w + x] = clip3(0, (1 << bit_depth) - 1, v + add);
}

}  // namespace

// Stats entry. org/pre int32 [h, w] with row strides, h and w multiples of
// the CTU size; out int32 [h >> ctb_log2, w >> ctb_log2, 96].
HH_EXPORT int hh_sao_stats(const void *org, int org_stride, const void *pre,
                           int pre_stride, int h, int w, int ctb_log2,
                           int bit_depth, void *out, void *stream) {
  const dim3 grid(w >> ctb_log2, h >> ctb_log2);
  sao_stats_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t *>(org), org_stride,
      static_cast<const int32_t *>(pre), pre_stride, h, w, ctb_log2,
      bit_depth, static_cast<int32_t *>(out));
  return (int)cudaGetLastError();
}

// Apply entry. pre int32 [h, w] with a row stride; type_map and band
// [ncty, nctx], offs [ncty, nctx, 4] int32; out int32 [h, w], dense.
HH_EXPORT int hh_sao_apply(const void *pre, int stride, const void *type_map,
                           const void *offs, const void *band, int h, int w,
                           int nctx, int ctb_log2, int bit_depth, void *out,
                           void *stream) {
  const int threads = 256;
  const dim3 grid((w + threads - 1) / threads, h);
  sao_apply_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t *>(pre), stride,
      static_cast<const int32_t *>(type_map),
      static_cast<const int32_t *>(offs), static_cast<const int32_t *>(band),
      h, w, nctx, ctb_log2, bit_depth, static_cast<int32_t *>(out));
  return (int)cudaGetLastError();
}
