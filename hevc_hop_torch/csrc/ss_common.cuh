// Device code shared by kernel C9 (ss_search.cu), kernel C10
// (inter_arms.cu), kernel C12 (gt_search.cu) and kernel C14 (ss_scan.cu):
// the MVD rate of hevc_hop_tpu/models/ss_scan.py _mvd_bits and
// _min_rate_bits, the validity tests of a displacement (in the picture;
// causal for its MC window and for its GT window, ss_anchor_ok), and
// _gather_cands (merge candidates with their reference indices, and the SS
// and temporal AMVP predictors, from the carried 4x4 motion planes).
#pragma once

#include "common.cuh"

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kHugePred = 1 << 19;
constexpr float kInterBits = 6.0f;

// float32 bins of one MVD component (quarter pel): 1, 3, or 5 + 2
// floor(log2(|v| / 2)), the floor(log2) being the reference's float32 one,
// one low where |v| / 2 is exactly 2^13 or 2^15
__device__ __forceinline__ float mvd_bits(int v) {
  const int a = iabs(v);
  if (a == 0) return 1.0f;
  if (a == 1) return 3.0f;
  const int fl = 31 - __clz(a >> 1) - ((a == 16384 || a == 65536) ? 1 : 0);
  return 5.0f + 2.0f * (float)fl;
}

// least bits of (mx, my) over np predictors preds[2p], preds[2p + 1]
__device__ __forceinline__ float min_rate_bits(int mx, int my,
                                               const int *preds, int np) {
  float best = 0.0f;
  for (int p = 0; p < np; ++p) {
    const float b = __fadd_rn(mvd_bits(mx - preds[2 * p]),
                              mvd_bits(my - preds[2 * p + 1]));
    best = p == 0 ? b : fminf(best, b);
  }
  return best;
}

// float32 sum of the n x n terms t(i) (raster index i) in XLA:CPU's order
// of the reference's jnp.sum over a block: each row one rounded add after
// another (block_row), then the row sums pairwise by halves (fold_rows,
// which leaves the sum in rows[0]). block_sum runs both in one thread; a
// CTA may run block_row a thread a row, then fold_rows in one. n <= 32.
template <typename F>
__device__ __forceinline__ float block_row(int n, int r, F t) {
  float acc = t(r * n);
  for (int c = 1; c < n; ++c) acc = __fadd_rn(acc, t(r * n + c));
  return acc;
}

__device__ __forceinline__ float fold_rows(int n, float *rows) {
  for (int half = n / 2; half >= 1; half /= 2)
    for (int i = 0; i < half; ++i) rows[i] = __fadd_rn(rows[i], rows[i + half]);
  return rows[0];
}

template <typename F>
__device__ float block_sum(int n, F t) {
  float rows[32];
  for (int r = 0; r < n; ++r) rows[r] = block_row(n, r, t);
  return fold_rows(n, rows);
}

// The sum of v over the warp's lanes, on every lane
__device__ __forceinline__ unsigned warp_sum(unsigned v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

// (c, k) <- the least (cost, index) over the warp's lanes, on every lane:
// the first index among equal costs, as the serial walk `k == 0 || cost <
// best` keeps it
__device__ __forceinline__ void warp_argmin(float &c, int &k) {
  for (int o = 16; o > 0; o >>= 1) {
    const float c2 = __shfl_xor_sync(~0u, c, o);
    const int k2 = __shfl_xor_sync(~0u, k, o);
    if (c2 < c || (c2 == c && k2 < k)) {
      c = c2;
      k = k2;
    }
  }
}

// The motion carried across the scan: [hp, wp] int32 planes of 4x4 cells.
struct Motion {
  const int32_t *mvx4, *mvy4, *pi4, *rf4;
  int hp, wp;
};

struct Cands {
  int mv[9][2];   // quarter pel: A1, B1, B0, A0, B2, three MI, zero
  int valid[9];
  int ref[9];     // each candidate's reference index
  int preds[6][2];   // the SS predictors
  int tpreds[3][2];  // the temporal predictors (PSS)
};

// _gather_cands with the SS reference at index ss_idx (0 on ISS slices,
// L0's last on PSS ones). The motion planes are read with L2-coherent loads:
// kernel C14 reads cells that CTAs on other SMs wrote earlier in its launch.
__device__ void gather_cands(const Motion &m, int px, int py, int n,
                             const uint8_t *nbav, const uint8_t *miav,
                             int mi_size, int ss_idx, Cands &c) {
  const int nx[5] = {px - 1, px + n - 1, px + n, px - 1, px - 1};
  const int ny[5] = {py + n - 1, py - 1, py - 1, py + n, py - 1};
  for (int k = 0; k < 5; ++k) {
    const int gy = clip3(0, m.hp * 4 - 1, ny[k]) / 4;
    const int gx = clip3(0, m.wp * 4 - 1, nx[k]) / 4;
    const long long o = (long long)gy * m.wp + gx;
    c.mv[k][0] = __ldcg(m.mvx4 + o);
    c.mv[k][1] = __ldcg(m.mvy4 + o);
    c.ref[k] = __ldcg(m.rf4 + o);
    c.valid[k] = nbav[k] && __ldcg(m.pi4 + o) == 1;
  }
  const int dmi = mi_size ? -(((n + mi_size - 1) / mi_size) * mi_size) * 4
                          : 0;
  const int mi[3][2] = {{dmi, 0}, {0, dmi}, {dmi, dmi}};
  for (int k = 0; k < 3; ++k) {
    c.mv[5 + k][0] = mi[k][0];
    c.mv[5 + k][1] = mi[k][1];
    c.valid[5 + k] = mi_size > 0 && miav[k];
    c.ref[5 + k] = ss_idx;
  }
  c.mv[8][0] = c.mv[8][1] = 0;
  c.valid[8] = 1;
  c.ref[8] = 0;
  for (int k = 0; k < 2; ++k) {
    const bool ok = c.valid[k] && c.ref[k] == ss_idx;
    const bool tok = c.valid[k] && c.ref[k] != ss_idx;
    c.preds[k][0] = ok ? c.mv[k][0] : kHugePred;
    c.preds[k][1] = ok ? c.mv[k][1] : kHugePred;
    c.tpreds[k][0] = tok ? c.mv[k][0] : kHugePred;
    c.tpreds[k][1] = tok ? c.mv[k][1] : kHugePred;
  }
  c.tpreds[2][0] = c.tpreds[2][1] = 0;
  for (int k = 0; k < 3; ++k) {
    c.preds[2 + k][0] = c.valid[5 + k] ? mi[k][0] : kHugePred;
    c.preds[2 + k][1] = c.valid[5 + k] ? mi[k][1] : kHugePred;
  }
  c.preds[5][0] = c.preds[5][1] = 0;
}

// Whether an n x n block at (tx, ty) lies in the picture
__device__ __forceinline__ bool in_picture(int tx, int ty, int n, int w,
                                           int h) {
  return tx >= 0 && ty >= 0 && tx + n <= w && ty + n <= h;
}

// Whether an n x n block at (tx, ty) lies in the picture and, with its
// interpolation margin, only over samples decoded before the current block
// (zmaxw [h - n + 1, w - n + 1], the reference's masks)
__device__ __forceinline__ bool causal(const int32_t *zmaxw, int tx, int ty,
                                       int n, int w, int h, int zcur) {
  if (!in_picture(tx, ty, n, w, h)) return false;
  return zmaxw[(long long)ty * (w - n + 1) + tx] < zcur;
}

// Whether the GT window of an n x n target at (tx, ty) (2n x 2n around it,
// plus 2 samples of slack) is in the picture and causal: the reference's
// mask2 and ss_anchor_ok
__device__ __forceinline__ bool anchor_causal(const int32_t *zmax2n, int tx,
                                              int ty, int n, int w, int h,
                                              int zcur) {
  const int wx = tx - n / 2, wy = ty - n / 2;
  if (wx < 2 || wy < 2 || wx + 2 * n + 2 > w || wy + 2 * n + 2 > h)
    return false;
  return zmax2n[(long long)wy * (w - 2 * n + 1) + wx] < zcur;
}

}  // namespace
