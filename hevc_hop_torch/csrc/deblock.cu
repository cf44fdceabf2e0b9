// Kernel C4: in-loop deblocking, one pass of edges.
//
// Replaces hevc_hop_tpu/ops/deblock.py deblock_frame with its boundary
// strength _edge_bs_v and its _luma_edges and _chroma_edges filters.
// Without the inter maps (all-intra slices) every transform-block edge of
// the 8-grid has BS 2. With them (pred4, cbf4, ref4 uint8 and mv4x, mv4y
// int16, [h/4, w/4], the ISS slices) a transform-block edge has BS 2 where
// either side is intra, 1 where either side codes luma levels or the
// references or MVs (quarter pel) differ by a full pel or more, else 0;
// luma takes tc at BS 1 or 2, chroma filters BS 2 edges only.
//
// One launch filters every vertical edge of the three planes; a second
// launch, on its output, every horizontal edge (blockIdx.y picks the
// plane). A luma thread owns one (4-line segment, edge): it makes the
// segment's on / strong / weak decisions from lines 0 and 3 as H.265
// 8.7.2.5.3 does, then filters the four lines. A chroma thread owns one
// (2-line segment, edge) of the 16-luma grid, the granularity of one luma
// segment. The p3..q3 window of an edge never overlaps a neighbour's (edges
// are 8 samples apart), so the pass works in place without a race. The
// horizontal pass reads with strides instead of transposing.
//
// Bound: device-memory bytes. Each sample is read and written at most once
// per pass with a few dozen integer operations. A thread walks its lines
// with stride loads (the vertical pass) or neighbouring threads take
// neighbouring columns (the horizontal pass), and the two passes are two
// launches because the horizontal decisions need the vertical output.
#include "common.cuh"

namespace {

struct Plane {
  int32_t *p;
  int h, w;
};

// sample k across the edge: k = 0..3 -> q0..q3, k = -1..-4 -> p0..p3
struct Line {
  int32_t *q0;
  int across;
  __device__ int &at(int k) const { return q0[k * across]; }
};

__device__ void luma_segment(const Line *ln, int beta, int tc, int maxv) {
  int dp[4], dq[4];
  for (int r = 0; r < 4; ++r) {
    const Line &l = ln[r];
    dp[r] = iabs(l.at(-3) - 2 * l.at(-2) + l.at(-1));
    dq[r] = iabs(l.at(2) - 2 * l.at(1) + l.at(0));
  }
  if (!(dp[0] + dp[3] + dq[0] + dq[3] < beta)) return;
  bool strong = true;
  for (int r = 0; r < 4; r += 3) {
    const Line &l = ln[r];
    const int p0 = l.at(-1), q0 = l.at(0);
    strong = strong && (2 * (dp[r] + dq[r]) < (beta >> 2)) &&
             (iabs(l.at(-4) - p0) + iabs(q0 - l.at(3)) < (beta >> 3)) &&
             (iabs(p0 - q0) < ((5 * tc + 1) >> 1));
  }
  const int side = (beta + (beta >> 1)) >> 3;
  const bool dep = (dp[0] + dp[3]) < side, deq = (dq[0] + dq[3]) < side;
  const int tc2 = tc >> 1;
  for (int r = 0; r < 4; ++r) {
    const Line &l = ln[r];
    const int p3 = l.at(-4), p2 = l.at(-3), p1 = l.at(-2), p0 = l.at(-1);
    const int q0 = l.at(0), q1 = l.at(1), q2 = l.at(2), q3 = l.at(3);
    if (strong) {
      l.at(-1) = clip3(p0 - 2 * tc, p0 + 2 * tc,
                       (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
      l.at(-2) = clip3(p1 - 2 * tc, p1 + 2 * tc, (p2 + p1 + p0 + q0 + 2) >> 2);
      l.at(-3) = clip3(p2 - 2 * tc, p2 + 2 * tc,
                       (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
      l.at(0) = clip3(q0 - 2 * tc, q0 + 2 * tc,
                      (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3);
      l.at(1) = clip3(q1 - 2 * tc, q1 + 2 * tc, (q2 + q1 + q0 + p0 + 2) >> 2);
      l.at(2) = clip3(q2 - 2 * tc, q2 + 2 * tc,
                      (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3);
    } else {
      const int delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
      if (!(iabs(delta) < 10 * tc)) continue;
      const int d1 = clip3(-tc, tc, delta);
      l.at(-1) = clip3(0, maxv, p0 + d1);
      l.at(0) = clip3(0, maxv, q0 - d1);
      if (dep)
        l.at(-2) = clip3(
            0, maxv, p1 + clip3(-tc2, tc2, (((p2 + p0 + 1) >> 1) - p1 + d1) >> 1));
      if (deq)
        l.at(1) = clip3(
            0, maxv, q1 + clip3(-tc2, tc2, (((q2 + q0 + 1) >> 1) - q1 - d1) >> 1));
    }
  }
}

__device__ void chroma_line(const Line &l, int tc, int maxv) {
  const int p1 = l.at(-2), p0 = l.at(-1), q0 = l.at(0), q1 = l.at(1);
  const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + p1 - q1 + 4) >> 3);
  l.at(-1) = clip3(0, maxv, p0 + delta);
  l.at(0) = clip3(0, maxv, q0 - delta);
}

struct InterMaps {
  const uint8_t *pred4, *cbf4, *ref4;  // null: all-intra slice
  const int16_t *mv4x, *mv4y;
};

// BS of the edge between 4x4 cells p and q (offsets into the maps)
__device__ int edge_bs(const InterMaps &m, int p, int q) {
  if (m.pred4 == nullptr) return 2;
  if (m.pred4[p] != 0 || m.pred4[q] != 0) return 2;
  const bool cbf = m.cbf4[p] != 0 || m.cbf4[q] != 0;
  const bool ref = m.ref4[p] != m.ref4[q];
  const bool mv = iabs((int)m.mv4x[p] - (int)m.mv4x[q]) >= 4 ||
                  iabs((int)m.mv4y[p] - (int)m.mv4y[q]) >= 4;
  return (cbf || ref || mv) ? 1 : 0;
}

__global__ void deblock_kernel(Plane y, Plane cb, Plane cr,
                               const uint8_t *tu4, InterMaps im,
                               int vertical, int beta, int tc, int tc1,
                               int tc_c, int bit_depth) {
  const int plane = blockIdx.y;
  const Plane pl = plane == 0 ? y : (plane == 1 ? cb : cr);
  const int luma = plane == 0;
  const int maxv = (1 << bit_depth) - 1;
  if (!luma && tc_c == 0) return;
  const int tw = y.w / 4;  // tu4 row length
  // segments run along the edge; edges across it
  const int len_along = vertical ? pl.h : pl.w;
  const int len_across = vertical ? pl.w : pl.h;
  const int seg_lines = luma ? 4 : 2;
  const int nseg = len_along / seg_lines;
  const int nedge = len_across / 8 - 1;
  if (nedge <= 0) return;
  const int item = blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= nseg * nedge) return;
  // neighbouring threads take neighbouring segments in the horizontal pass
  // (neighbouring columns) and neighbouring edges in the vertical one
  int seg, j;
  if (vertical) {
    seg = item / nedge;
    j = item % nedge;
  } else {
    seg = item % nseg;
    j = item / nseg;
  }
  const int pos = 8 * (j + 1);              // edge position across
  const int lx = luma ? pos : 2 * pos;      // in luma samples
  const int cq = lx / 4;
  // the 4x4 cells on both sides: seg indexes 4-line luma segments
  const int q = vertical ? seg * tw + cq : cq * tw + seg;
  const int p = vertical ? q - 1 : q - tw;
  const int t = tu4[q];
  if (lx % (1 << t) != 0) return;           // not a transform-block edge
  const int bs = edge_bs(im, p, q);
  if (bs == 0 || (!luma && bs != 2)) return;
  const int along = vertical ? pl.w : 1;
  const int across = vertical ? 1 : pl.w;
  Line ln[4];
  for (int r = 0; r < seg_lines; ++r) {
    const long long line = (long long)seg * seg_lines + r;
    ln[r].q0 = pl.p + line * along + (long long)pos * across;
    ln[r].across = across;
  }
  if (luma) {
    luma_segment(ln, beta, bs == 2 ? tc : tc1, maxv);
  } else {
    chroma_line(ln[0], tc_c, maxv);
    chroma_line(ln[1], tc_c, maxv);
  }
}

}  // namespace

// y [h, w], cb/cr [h/2, w/2] int32 (dense rows), tu4 [h/4, w/4] uint8;
// pred4, cbf4, ref4 uint8 and mv4x, mv4y int16 [h/4, w/4], all null for an
// all-intra slice. vertical = 1 filters the vertical edges, 0 the
// horizontal ones. tc and tc1 are the luma tc at BS 2 and 1, tc_c the
// chroma tc (0 skips chroma).
HH_EXPORT int hh_deblock(void *py, void *pcb, void *pcr, const void *tu4,
                         const void *pred4, const void *cbf4,
                         const void *ref4, const void *mv4x,
                         const void *mv4y, int h, int w, int vertical,
                         int beta, int tc, int tc1, int tc_c, int bit_depth,
                         void *stream) {
  const InterMaps im{static_cast<const uint8_t *>(pred4),
                     static_cast<const uint8_t *>(cbf4),
                     static_cast<const uint8_t *>(ref4),
                     static_cast<const int16_t *>(mv4x),
                     static_cast<const int16_t *>(mv4y)};
  const Plane y{static_cast<int32_t *>(py), h, w};
  const Plane cb{static_cast<int32_t *>(pcb), h / 2, w / 2};
  const Plane cr{static_cast<int32_t *>(pcr), h / 2, w / 2};
  // the luma plane has the most items: (h/4) x (w/8) at most
  const long long items = (long long)(h / 4 + 1) * (w / 8 + 1) +
                          (long long)(w / 4 + 1) * (h / 8 + 1);
  const int threads = 128;
  const int blocks = (int)((items + threads - 1) / threads);
  deblock_kernel<<<dim3(blocks, 3), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      y, cb, cr, static_cast<const uint8_t *>(tu4), im, vertical, beta, tc,
      tc1, tc_c, bit_depth);
  return (int)cudaGetLastError();
}
