// Kernel C4: in-loop deblocking of a picture, one launch, out of place.
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
// The reference filters every vertical edge of the picture, then every
// horizontal edge of that result. Here a CTA owns one tile: 32x32 luma
// samples and the two 16x16 chroma tiles beside them. It stages the tile
// with a halo of 4 samples on each side (luma and chroma; chroma reads 2)
// in shared memory with 16-byte loads, then
//   1. decides and filters the vertical edges of every staged row, halo
//      rows included, at the tile's columns 0, 8, .., 32 (its two border
//      edges too);
//   2. decides and filters the horizontal edges of its own columns at
//      rows 0, 8, .., 32;
// and writes its own samples to new planes. This gives the two-pass
// result: a vertical edge filters each row on its own, and its decisions
// read lines 0 and 3 of a 4-row segment, so the 4-row halo is one whole
// segment decided as the picture-wide pass decides it; an edge reads 4
// samples and changes at most 3 on each side, and edges lie 8 apart, so
// the tile's columns after step 1 are the picture-wide pass's, and the
// rows a horizontal border edge reads lie in the halo. A border edge is
// decided by both CTAs from the same inputs; each writes its own side.
// The maps' cells that the tile's edges read (tu4 and, for an inter slice,
// the five inter maps) are staged as well, a row of cells at a time, with
// every load of the CTA in flight at once; each edge segment's BS is then
// computed once, and each luma segment's on / strong / weak decisions
// (H.265 8.7.2.5.3) are made once, before the lines are filtered in place
// in shared memory. The shared-memory rows have an odd pitch, so that the
// threads of a vertical edge, one a row, hit 32 banks.
//
// The input planes are read where they lie (row strides: the encoder
// passes views of its stacked recon buffers); the output planes are
// dense. Bound: device-memory bytes, one read and one write of the three
// planes (and one read of the maps) with a few dozen integer operations
// per sample.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;                    // luma tile
constexpr int kHalo = 4;                     // staged halo, both planes
constexpr int kLS = kTile + 2 * kHalo;       // 40 staged luma rows, columns
constexpr int kCT = kTile / 2;               // 16, chroma tile
constexpr int kCS = kCT + 2 * kHalo;         // 24 staged chroma rows, columns
// odd shared-memory pitches: a vertical edge's lines, one a thread down the
// rows, fall in 32 different banks
constexpr int kLP = kLS + 1;
constexpr int kCP = kCS + 1;
constexpr int kSegs = kLS / 4;               // 10 staged 4-row segments
constexpr int kEdges = kTile / 8 + 1;        // 5 edges each way
constexpr int kColSegs = kTile / 4;          // 8 own 4-column segments
constexpr int kCEdges = kCT / 8 + 1;         // 3 chroma edges each way
constexpr int kCRows = kCT + 4;              // 20 chroma rows filtered

struct InPlane {
  const int32_t *p;
  int stride;
};

struct InterMaps {
  const uint8_t *pred4, *cbf4, *ref4;  // null: all-intra slice
  const int16_t *mv4x, *mv4y;
};

// The maps' cells the tile's edges read, staged: 4-row segments r4 =
// ty0 / 4 - 1 .. + 9 by 4-column segments tx0 / 4 - 1 .. + 9 (the
// staging's rows and columns), tu4 and, for an inter slice, pred4, cbf4,
// ref4, mv4x and mv4y.
constexpr int kCells = kSegs;                          // 10 a side
constexpr int kMaps = 6;

// BS of the edge between staged cells p and q: 2 for an all-intra slice
// (nmaps 1), else the reference's _edge_bs_v
__device__ int edge_bs(const int16_t (*cell)[kCells * kCells], int nmaps,
                       int p, int q) {
  if (nmaps == 1) return 2;
  if ((cell[1][p] | cell[1][q]) != 0) return 2;
  return ((cell[2][p] | cell[2][q]) != 0 || cell[3][p] != cell[3][q] ||
          iabs(cell[4][p] - cell[4][q]) >= 4 ||
          iabs(cell[5][p] - cell[5][q]) >= 4) ? 1 : 0;
}

// sample k across the edge: k = 0..3 -> q0..q3, k = -1..-4 -> p0..p3
struct Line {
  int32_t *q0;
  int across;
  __device__ int &at(int k) const { return q0[k * across]; }
};

// a luma segment's decisions from its lines 0 and 3: 0 off, else bit 0
// on, bit 1 strong, bits 2 and 3 the weak filter's p1 and q1, tc above
enum { kOn = 1, kStrong = 2, kDep = 4, kDeq = 8 };

__device__ int luma_decide(const Line &l0, const Line &l3, int beta,
                           int tc) {
  const Line *ln[2] = {&l0, &l3};
  int dp[2], dq[2];
  for (int r = 0; r < 2; ++r) {
    const Line &l = *ln[r];
    dp[r] = iabs(l.at(-3) - 2 * l.at(-2) + l.at(-1));
    dq[r] = iabs(l.at(2) - 2 * l.at(1) + l.at(0));
  }
  if (!(dp[0] + dp[1] + dq[0] + dq[1] < beta)) return 0;
  bool strong = true;
  for (int r = 0; r < 2; ++r) {
    const Line &l = *ln[r];
    const int p0 = l.at(-1), q0 = l.at(0);
    strong = strong && (2 * (dp[r] + dq[r]) < (beta >> 2)) &&
             (iabs(l.at(-4) - p0) + iabs(q0 - l.at(3)) < (beta >> 3)) &&
             (iabs(p0 - q0) < ((5 * tc + 1) >> 1));
  }
  const int side = (beta + (beta >> 1)) >> 3;
  return kOn | (strong ? kStrong : 0) |
         ((dp[0] + dp[1]) < side ? kDep : 0) |
         ((dq[0] + dq[1]) < side ? kDeq : 0) | (tc << 4);
}

__device__ void luma_line(const Line &l, int f, int maxv) {
  if (!(f & kOn)) return;
  const int tc = f >> 4;
  const int p3 = l.at(-4), p2 = l.at(-3), p1 = l.at(-2), p0 = l.at(-1);
  const int q0 = l.at(0), q1 = l.at(1), q2 = l.at(2), q3 = l.at(3);
  if (f & kStrong) {
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
    return;
  }
  const int delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
  if (!(iabs(delta) < 10 * tc)) return;
  const int d1 = clip3(-tc, tc, delta);
  const int tc2 = tc >> 1;
  l.at(-1) = clip3(0, maxv, p0 + d1);
  l.at(0) = clip3(0, maxv, q0 - d1);
  if (f & kDep)
    l.at(-2) = clip3(
        0, maxv, p1 + clip3(-tc2, tc2, (((p2 + p0 + 1) >> 1) - p1 + d1) >> 1));
  if (f & kDeq)
    l.at(1) = clip3(
        0, maxv, q1 + clip3(-tc2, tc2, (((q2 + q0 + 1) >> 1) - q1 - d1) >> 1));
}

__device__ void chroma_line(const Line &l, int tc, int maxv) {
  const int p1 = l.at(-2), p0 = l.at(-1), q0 = l.at(0), q1 = l.at(1);
  const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + p1 - q1 + 4) >> 3);
  l.at(-1) = clip3(0, maxv, p0 + delta);
  l.at(0) = clip3(0, maxv, q0 - delta);
}

// Staging of one plane's ROWS x COLS samples from (y0, x0) (COLS a
// multiple of 4, as x0 and w) into shared memory of pitch COLS + 1, in two
// halves: load issues the thread's 16-byte loads (0 outside the plane,
// never read by a filtered edge), store writes them.
template <int ROWS, int COLS>
struct Stage {
  static constexpr int kQuads = ROWS * COLS / 4;
  static constexpr int kPer = (kQuads + kThreads - 1) / kThreads;
  int4 q[kPer];

  __device__ void load(const InPlane &src, int h, int w, int y0, int x0) {
    const bool vec = ((reinterpret_cast<uintptr_t>(src.p) |
                       (uintptr_t)src.stride * 4) & 15) == 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int r = i / (COLS / 4), v = i - r * (COLS / 4);
      const int gy = y0 + r, gx = x0 + 4 * v;
      q[k] = make_int4(0, 0, 0, 0);
      if (i < kQuads && gy >= 0 && gy < h && gx >= 0 && gx < w) {
        const int32_t *s = src.p + (long long)gy * src.stride + gx;
        q[k] = vec ? *reinterpret_cast<const int4 *>(s)
                   : make_int4(s[0], s[1], s[2], s[3]);
      }
    }
  }

  __device__ void store(int32_t *dst) const {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i >= kQuads) continue;
      const int r = i / (COLS / 4), v = i - r * (COLS / 4);
      int32_t *d = dst + r * (COLS + 1) + 4 * v;  // odd pitch: 4-byte stores
      d[0] = q[k].x;
      d[1] = q[k].y;
      d[2] = q[k].z;
      d[3] = q[k].w;
    }
  }
};

// the tile's own rows x cols samples from shared memory (pitch, halo) into
// the dense plane [h, w] at (y0, x0)
__device__ void unstage(const int32_t *src, int pitch, int32_t *dst, int h,
                        int w, int y0, int x0, int rows, int cols) {
  const int quads = cols / 4;
  for (int i = threadIdx.x; i < rows * quads; i += blockDim.x) {
    const int r = i / quads, v = i - r * quads;
    const int gy = y0 + r, gx = x0 + 4 * v;
    if (gy >= h || gx >= w) continue;
    const int32_t *s = src + (r + kHalo) * pitch + kHalo + 4 * v;
    *reinterpret_cast<int4 *>(dst + (long long)gy * w + gx) =
        make_int4(s[0], s[1], s[2], s[3]);
  }
}

__global__ void __launch_bounds__(kThreads)
    deblock_kernel(InPlane y, InPlane cb, InPlane cr, int32_t *oy,
                   int32_t *ocb, int32_t *ocr, const uint8_t *tu4,
                   InterMaps im, int h, int w, int beta, int tc, int tc1,
                   int tc_c, int bit_depth) {
  __shared__ int32_t sy[kLS * kLP];
  __shared__ int32_t sc[2][kCS * kCP];
  __shared__ int16_t cell[kMaps][kCells * kCells];
  __shared__ int8_t bs_v[kSegs][kEdges];     // staged row segment, edge
  __shared__ int8_t bs_h[kEdges][kColSegs];  // edge, own column segment
  __shared__ int dec_v[kSegs][kEdges];
  __shared__ int dec_h[kEdges][kColSegs];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int ty0 = blockIdx.y * kTile, tx0 = blockIdx.x * kTile;
  const int cy0 = ty0 / 2, cx0 = tx0 / 2;
  const int hc = h / 2, wc = w / 2, tw = w / 4;
  const int maxv = (1 << bit_depth) - 1;

  // the staging's loads, all issued before any is waited for (the launch
  // has kThreads threads)
  Stage<kLS, kLS> ly;
  Stage<kCS, kCS> lcb, lcr;
  ly.load(y, h, w, ty0 - kHalo, tx0 - kHalo);
  lcb.load(cb, hc, wc, cy0 - kHalo, cx0 - kHalo);
  lcr.load(cr, hc, wc, cy0 - kHalo, cx0 - kHalo);
  // the maps' cells (one byte or short each, a row of cells at a time)
  const int nmaps = im.pred4 == nullptr ? 1 : kMaps;
  constexpr int kCellsPer = (kMaps * kCells * kCells + kThreads - 1) /
                            kThreads;
  int cv[kCellsPer];
#pragma unroll
  for (int k = 0; k < kCellsPer; ++k) {
    const int i = tid + k * kThreads;
    const int m = i / (kCells * kCells), j = i - m * (kCells * kCells);
    const int r4 = ty0 / 4 - 1 + j / kCells, c4 = tx0 / 4 - 1 + j % kCells;
    cv[k] = 0;
    if (m < nmaps && r4 >= 0 && r4 < h / 4 && c4 >= 0 && c4 < tw) {
      const int at = r4 * tw + c4;
      cv[k] = m == 0 ? tu4[at] : m == 1 ? im.pred4[at] : m == 2 ? im.cbf4[at]
            : m == 3 ? im.ref4[at] : m == 4 ? im.mv4x[at] : im.mv4y[at];
    }
  }
#pragma unroll
  for (int k = 0; k < kCellsPer; ++k) {
    const int i = tid + k * kThreads;
    if (i < kMaps * kCells * kCells) (&cell[0][0])[i] = (int16_t)cv[k];
  }
  ly.store(sy);
  lcb.store(sc[0]);
  lcr.store(sc[1]);
  __syncthreads();

  // 1. vertical edges: a segment's decisions, then every line
  // the BS of every edge segment the tile filters (0: none, or outside
  // the picture); staged segment s is luma rows 4 r4 .. 4 r4 + 3, cell row
  // s; edge k at x = tx0 + 8 k lies between cell columns 2 k and 2 k + 1
  for (int i = tid; i < kSegs * kEdges; i += nt) {
    const int s = i / kEdges, k = i - s * kEdges;
    const int r4 = ty0 / 4 - 1 + s, x = tx0 + 8 * k;
    const int q = s * kCells + 2 * k + 1;
    const int bs = r4 >= 0 && r4 < h / 4 && x > 0 && x + 8 <= w &&
                           x % (1 << cell[0][q]) == 0
                       ? edge_bs(cell, nmaps, q - 1, q)
                       : 0;
    bs_v[s][k] = (int8_t)bs;
    int f = 0;
    if (bs > 0) {
      int32_t *q0 = sy + (4 * s) * kLP + kHalo + 8 * k;
      f = luma_decide(Line{q0, 1}, Line{q0 + 3 * kLP, 1}, beta,
                      bs == 2 ? tc : tc1);
    }
    dec_v[s][k] = f;
  }
  __syncthreads();
  constexpr int kLumaV = kLS * kEdges;                  // 200 lines
  constexpr int kChromaV = 2 * kCRows * kCEdges;         // 120 lines
  for (int i = tid; i < kLumaV + kChromaV; i += nt) {
    if (i < kLumaV) {
      // neighbouring threads take neighbouring rows of one edge
      const int k = i / kLS, r = i - k * kLS;
      luma_line(Line{sy + r * kLP + kHalo + 8 * k, 1}, dec_v[r / 4][k],
                maxv);
    } else if (tc_c > 0) {
      const int j = i - kLumaV;
      const int pl = j / (kCRows * kCEdges);
      const int jj = j - pl * (kCRows * kCEdges);
      const int k = jj / kCRows, r = jj - k * kCRows;
      // chroma row cy0 - 2 + r lies in luma segment r / 2 of the staging;
      // chroma edge k is luma edge 2 k
      if (bs_v[r / 2][2 * k] == 2 && cx0 + 8 * k + 8 <= wc)
        chroma_line(Line{sc[pl] + (r + 2) * kCP + kHalo + 8 * k, 1}, tc_c,
                    maxv);
    }
  }
  __syncthreads();

  // 2. horizontal edges of the tile's own columns
  // edge k at y = ty0 + 8 k lies between cell rows 2 k and 2 k + 1
  for (int i = tid; i < kEdges * kColSegs; i += nt) {
    const int k = i / kColSegs, c = i - k * kColSegs;
    const int yy = ty0 + 8 * k;
    const int q = (2 * k + 1) * kCells + 1 + c;
    const int bs = yy > 0 && yy + 8 <= h && tx0 / 4 + c < tw &&
                           yy % (1 << cell[0][q]) == 0
                       ? edge_bs(cell, nmaps, q - kCells, q)
                       : 0;
    bs_h[k][c] = (int8_t)bs;
    int f = 0;
    if (bs > 0) {
      int32_t *q0 = sy + (kHalo + 8 * k) * kLP + kHalo + 4 * c;
      f = luma_decide(Line{q0, kLP}, Line{q0 + 3, kLP}, beta,
                      bs == 2 ? tc : tc1);
    }
    dec_h[k][c] = f;
  }
  __syncthreads();
  constexpr int kLumaH = kEdges * kTile;                // 160 lines
  constexpr int kChromaH = 2 * kCEdges * kCT;            // 96 lines
  for (int i = tid; i < kLumaH + kChromaH; i += nt) {
    if (i < kLumaH) {
      const int k = i / kTile, col = i - k * kTile;
      luma_line(Line{sy + (kHalo + 8 * k) * kLP + kHalo + col, kLP},
                dec_h[k][col / 4], maxv);
    } else if (tc_c > 0) {
      const int j = i - kLumaH;
      const int pl = j / (kCEdges * kCT);
      const int jj = j - pl * (kCEdges * kCT);
      const int k = jj / kCT, col = jj - k * kCT;
      if (bs_h[2 * k][col / 2] == 2 && cy0 + 8 * k + 8 <= hc)
        chroma_line(Line{sc[pl] + (kHalo + 8 * k) * kCP + kHalo + col, kCP},
                    tc_c, maxv);
    }
  }
  __syncthreads();

  // chroma with tc 0 leaves as it came
  unstage(sy, kLP, oy, h, w, ty0, tx0, kTile, kTile);
  unstage(sc[0], kCP, ocb, hc, wc, cy0, cx0, kCT, kCT);
  unstage(sc[1], kCP, ocr, hc, wc, cy0, cx0, kCT, kCT);
}

}  // namespace

// y [h, w] and cb, cr [h/2, w/2] int32 with row strides ys, cbs, crs
// (dense rows, 8-aligned h and w); oy, ocb, ocr new dense planes of the
// same shapes; tu4 [h/4, w/4] uint8; pred4, cbf4, ref4 uint8 and mv4x,
// mv4y int16 [h/4, w/4], all null for an all-intra slice. tc and tc1 are
// the luma tc at BS 2 and 1, tc_c the chroma tc (0 filters no chroma).
HH_EXPORT int hh_deblock(const void *py, int ys, const void *pcb, int cbs,
                         const void *pcr, int crs, void *oy, void *ocb,
                         void *ocr, const void *tu4, const void *pred4,
                         const void *cbf4, const void *ref4,
                         const void *mv4x, const void *mv4y, int h, int w,
                         int beta, int tc, int tc1, int tc_c, int bit_depth,
                         void *stream) {
  const InterMaps im{static_cast<const uint8_t *>(pred4),
                     static_cast<const uint8_t *>(cbf4),
                     static_cast<const uint8_t *>(ref4),
                     static_cast<const int16_t *>(mv4x),
                     static_cast<const int16_t *>(mv4y)};
  const InPlane y{static_cast<const int32_t *>(py), ys};
  const InPlane cb{static_cast<const int32_t *>(pcb), cbs};
  const InPlane cr{static_cast<const int32_t *>(pcr), crs};
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile);
  deblock_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      y, cb, cr, static_cast<int32_t *>(oy), static_cast<int32_t *>(ocb),
      static_cast<int32_t *>(ocr), static_cast<const uint8_t *>(tu4), im, h,
      w, beta, tc, tc1, tc_c, bit_depth);
  return (int)cudaGetLastError();
}
