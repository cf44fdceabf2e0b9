"""In-loop deblocking; kernel C4.

Counterpart of hevc_hop_tpu/ops/deblock.py ``deblock_frame``. Without the
inter maps (``pred4 is None``, an all-intra slice) every transform-block
edge of the 8-grid has BS 2. With them (pred4, cbf4, ref4, mv4x, mv4y, the
ISS slices' dense maps) the boundary strength is the reference's
``_edge_bs_v``: 2 where either side is intra, 1 where either side codes
luma levels or the references or MVs differ (by a full pel or more), else
0; luma's tc depends on the BS, and chroma filters BS 2 edges only.

:func:`deblock_frame` launches kernel C4 (``csrc/deblock.cu``) on CUDA
tensors: one launch a picture, a CTA per 32x32 luma tile and its two 16x16
chroma tiles, which reads the input planes where they lie (row strides)
and writes new ones. :func:`deblock_tiles_plain` is a plain walk of that
decomposition. On CPU tensors :func:`deblock_frame` runs
:func:`deblock_frame_plain`, whose two picture-wide passes are dense
tensor code that runs on any device.
"""
from __future__ import annotations

import numpy as np
import torch

from hevc_hop_torch import _cuda

LAUNCHES = 0

# H.265 Table 8-11
TC_TABLE = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10,
     11, 13, 14, 16, 18, 20, 22, 24], np.int32)
BETA_TABLE = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6, 7, 8, 9, 10, 11,
     12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32, 34, 36, 38,
     40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64], np.int32)


def thresholds(qp: int, qp_c: int, bit_depth: int = 8, beta_off: int = 0,
               tc_off: int = 0):
    """(beta, luma tc at BS 2, chroma tc) of a slice."""
    qb = min(max(qp + beta_off * 2, 0), 51)
    beta = int(BETA_TABLE[qb]) << (bit_depth - 8)
    tc = int(TC_TABLE[min(max(qp + 2 + tc_off * 2, 0), 53)]) \
        << (bit_depth - 8)
    tc_c = int(TC_TABLE[min(max(qp_c + 2 + tc_off * 2, 0), 53)]) \
        << (bit_depth - 8)
    return beta, tc, tc_c


def _seg_rows(a: torch.Tensor, rep: int) -> torch.Tensor:
    return torch.repeat_interleave(a, rep, dim=0)


def _luma_edges(plane, edge_on, beta: int, tc_seg, bit_depth: int):
    """Filter all vertical 8-grid edges of plane [H, W] (see the
    reference's ``_luma_edges``)."""
    h, w = plane.shape
    e = w // 8 - 1
    if e <= 0:
        return plane
    maxv = (1 << bit_depth) - 1
    win = plane[:, 4:4 + e * 8].reshape(h, e, 8)
    p3, p2, p1, p0 = win[..., 0], win[..., 1], win[..., 2], win[..., 3]
    q0, q1, q2, q3 = win[..., 4], win[..., 5], win[..., 6], win[..., 7]

    seg = lambda a: a.reshape(h // 4, 4, e)
    dp = torch.abs(p2 - 2 * p1 + p0)
    dq = torch.abs(q2 - 2 * q1 + q0)
    dp0, dp3 = seg(dp)[:, 0], seg(dp)[:, 3]
    dq0, dq3 = seg(dq)[:, 0], seg(dq)[:, 3]
    f_on = ((dp0 + dp3 + dq0 + dq3) < beta) & edge_on

    def row_cond(r):
        sp, sq = seg(p0)[:, r], seg(q0)[:, r]
        c1 = 2 * (seg(dp)[:, r] + seg(dq)[:, r]) < (beta >> 2)
        c2 = (torch.abs(seg(p3)[:, r] - sp) + torch.abs(sq - seg(q3)[:, r])
              < (beta >> 3))
        c3 = torch.abs(sp - sq) < ((5 * tc_seg + 1) >> 1)
        return c1 & c2 & c3

    strong = row_cond(0) & row_cond(3) & f_on
    weak = f_on & ~strong
    up = lambda a: _seg_rows(a, 4)
    strong_r, weak_r, tc = up(strong), up(weak), up(tc_seg)

    cl = lambda v, lo, hi: torch.minimum(torch.maximum(v, lo), hi)
    sp0 = cl((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
             p0 - 2 * tc, p0 + 2 * tc)
    sp1 = cl((p2 + p1 + p0 + q0 + 2) >> 2, p1 - 2 * tc, p1 + 2 * tc)
    sp2 = cl((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3,
             p2 - 2 * tc, p2 + 2 * tc)
    sq0 = cl((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
             q0 - 2 * tc, q0 + 2 * tc)
    sq1 = cl((q2 + q1 + q0 + p0 + 2) >> 2, q1 - 2 * tc, q1 + 2 * tc)
    sq2 = cl((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3,
             q2 - 2 * tc, q2 + 2 * tc)

    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    w_on = weak_r & (torch.abs(delta) < 10 * tc)
    d1 = cl(delta, -tc, tc)
    wp0 = torch.clamp(p0 + d1, 0, maxv)
    wq0 = torch.clamp(q0 - d1, 0, maxv)
    side = (beta + (beta >> 1)) >> 3
    dep = up((dp0 + dp3) < side) & w_on
    deq = up((dq0 + dq3) < side) & w_on
    tc2 = tc >> 1
    dpv = cl((((p2 + p0 + 1) >> 1) - p1 + d1) >> 1, -tc2, tc2)
    dqv = cl((((q2 + q0 + 1) >> 1) - q1 - d1) >> 1, -tc2, tc2)
    wp1 = torch.clamp(p1 + dpv, 0, maxv)
    wq1 = torch.clamp(q1 + dqv, 0, maxv)

    np0 = torch.where(strong_r, sp0, torch.where(w_on, wp0, p0))
    np1 = torch.where(strong_r, sp1, torch.where(dep, wp1, p1))
    np2 = torch.where(strong_r, sp2, p2)
    nq0 = torch.where(strong_r, sq0, torch.where(w_on, wq0, q0))
    nq1 = torch.where(strong_r, sq1, torch.where(deq, wq1, q1))
    nq2 = torch.where(strong_r, sq2, q2)
    out = torch.stack([p3, np2, np1, np0, nq0, nq1, nq2, q3], dim=-1)
    plane = plane.clone()
    plane[:, 4:4 + e * 8] = out.reshape(h, e * 8)
    return plane


def _chroma_edges(plane, edge_on, tc: int, bit_depth: int, rep: int = 2):
    """Filter vertical chroma edges (8-sample grid); each decision covers
    ``rep`` chroma rows."""
    h, w = plane.shape
    e = w // 8 - 1
    if e <= 0 or tc == 0:
        return plane
    maxv = (1 << bit_depth) - 1
    win = plane[:, 6:6 + e * 8].reshape(h, e, 8)
    p1, p0, q0, q1 = win[..., 0], win[..., 1], win[..., 2], win[..., 3]
    on = _seg_rows(edge_on, rep)
    delta = torch.clamp((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc, tc)
    np0 = torch.where(on, torch.clamp(p0 + delta, 0, maxv), p0)
    nq0 = torch.where(on, torch.clamp(q0 - delta, 0, maxv), q0)
    out = torch.cat([p1[..., None], np0[..., None], nq0[..., None],
                     q1[..., None], win[..., 4:]], dim=-1)
    plane = plane.clone()
    plane[:, 6:6 + e * 8] = out.reshape(h, e * 8)
    return plane


def tc_bs1(qp: int, bit_depth: int = 8, tc_off: int = 0) -> int:
    """Luma tc at BS 1 (BS 2 adds DEFAULT_INTRA_TC_OFFSET = 2 to the QP)."""
    return int(TC_TABLE[min(max(qp + tc_off * 2, 0), 53)]) << (bit_depth - 8)


def edge_bs_v(tu4, w: int, inter=None):
    """[H/4, E] boundary strength of the vertical 8-grid edges, E = w // 8
    - 1: 0 off a transform-block edge; else 2 without the inter maps
    inter = (pred4, cbf4, ref4, mv4x, mv4y), or the reference's
    ``_edge_bs_v`` with them."""
    e = w // 8 - 1
    xs = (torch.arange(e, device=tu4.device) + 1) * 8
    cq = xs // 4
    sizes = 1 << tu4[:, cq].to(torch.int64)
    edge_on = (xs[None, :] % sizes) == 0
    if inter is None:
        return torch.where(edge_on, 2, 0)
    pred4, cbf4, ref4, mv4x, mv4y = (m.to(torch.int32) for m in inter)
    intra = (pred4[:, cq - 1] != 0) | (pred4[:, cq] != 0)
    cbf = (cbf4[:, cq - 1] != 0) | (cbf4[:, cq] != 0)
    refdiff = ref4[:, cq - 1] != ref4[:, cq]
    mvdiff = ((torch.abs(mv4x[:, cq - 1] - mv4x[:, cq]) >= 4)
              | (torch.abs(mv4y[:, cq - 1] - mv4y[:, cq]) >= 4))
    bs = torch.where(intra, 2, torch.where(cbf | refdiff | mvdiff, 1, 0))
    return torch.where(edge_on, bs, 0)


def _inter_maps(y, pred4, cbf4, ref4, mv4x, mv4y):
    maps = (pred4, cbf4, ref4, mv4x, mv4y)
    if pred4 is None:
        return None
    return tuple(torch.as_tensor(m).to(y.device) for m in maps)


def deblock_frame_plain(y, cb, cr, tu4, qp: int, qp_c: int,
                        bit_depth: int = 8, beta_off: int = 0,
                        tc_off: int = 0, pred4=None, cbf4=None, ref4=None,
                        mv4x=None, mv4y=None):
    """Plain version of :func:`deblock_frame` (returns new planes)."""
    h, w = y.shape
    beta, tc, tc_c = thresholds(qp, qp_c, bit_depth, beta_off, tc_off)
    tc1 = tc_bs1(qp, bit_depth, tc_off)
    tu4 = torch.as_tensor(tu4).to(y.device).to(torch.int64)
    inter = _inter_maps(y, pred4, cbf4, ref4, mv4x, mv4y)
    bs_v = edge_bs_v(tu4, w, inter)
    bs_h = edge_bs_v(tu4.T, h, None if inter is None
                     else tuple(m.T for m in inter))
    tcs = lambda bs: torch.where(bs == 2, tc, torch.where(bs == 1, tc1, 0)
                                 ).to(torch.int32)
    y = _luma_edges(y, bs_v > 0, beta, tcs(bs_v), bit_depth)
    y = _luma_edges(y.T, bs_h > 0, beta, tcs(bs_h), bit_depth).T.contiguous()
    if tc_c > 0:
        hc, wc = cb.shape
        if wc // 8 - 1 > 0:
            evc = (bs_v[:, 1::2] == 2)[:, :wc // 8 - 1]
            cb = _chroma_edges(cb, evc, tc_c, bit_depth)
            cr = _chroma_edges(cr, evc, tc_c, bit_depth)
        if hc // 8 - 1 > 0:
            ehc = (bs_h[:, 1::2] == 2)[:, :hc // 8 - 1]
            cb = _chroma_edges(cb.T, ehc, tc_c, bit_depth).T.contiguous()
            cr = _chroma_edges(cr.T, ehc, tc_c, bit_depth).T.contiguous()
    return y, cb, cr


# a staged sample that kernel C4 does not stage (outside its halo or the
# picture): were it read by a filtered edge, the walk would differ
_UNSTAGED = 1 << 20


def _walk_tile(plane, y0, x0, th, tw, seg, bs_v, bs_h, edges):
    """One tile of :func:`deblock_tiles_plain` on one plane: [th, tw]
    samples at (y0, x0), deblocking segments of ``seg`` lines (4 luma, 2
    chroma). Returns the tile's own filtered samples."""
    hh, ww = plane.shape
    dev = plane.device
    # staged on the picture's 8-grid, 8 samples beyond the tile; what the
    # kernel stages is the tile and a halo of 4
    ry0, rx0 = y0 // 8 * 8 - 8, x0 // 8 * 8 - 8
    ry1, rx1 = -(-(y0 + th) // 8) * 8 + 8, -(-(x0 + tw) // 8) * 8 + 8
    st = torch.full((ry1 - ry0, rx1 - rx0), _UNSTAGED, dtype=plane.dtype,
                    device=dev)
    a0, a1 = max(y0 - 4, 0), min(y0 + th + 4, hh)
    b0, b1 = max(x0 - 4, 0), min(x0 + tw + 4, ww)
    st[a0 - ry0:a1 - ry0, b0 - rx0:b1 - rx0] = plane[a0:a1, b0:b1]
    ar = lambda n: torch.arange(n, device=dev)

    def on(bs, lines0, n_lines, lo, hi, pos0, n_pos, p_lo, p_hi, size):
        """[n_lines, n_pos] BS of the staged segments starting at lines0 +
        seg * i across the edges at pos0 + 8 (j + 1), 0 where the kernel
        filters no such segment or edge."""
        ln = lines0 + seg * ar(n_lines)
        pos = pos0 + 8 * (ar(n_pos) + 1)
        ok_l = (ln >= lo) & (ln < hi) & (ln >= 0)
        ok_p = (pos >= p_lo) & (pos <= p_hi) & (pos > 0) & (pos + 8 <= size)
        scale = 4 // seg          # chroma edge Xc is luma edge 2 Xc
        li = (ln // seg).clamp(0, bs.shape[0] - 1)
        pi = (pos * scale // 8 - 1).clamp(0, bs.shape[1] - 1)
        got = bs[li[:, None], pi[None, :]]
        return torch.where(ok_l[:, None] & ok_p[None, :], got, 0)

    rows, cols = ry1 - ry0, rx1 - rx0
    # 1. vertical edges at the tile's columns x0 .. x0 + tw, every staged
    # row: the tile's and one segment above and below it
    bv = on(bs_v, ry0, rows // seg, y0 - seg, min(y0 + th + seg, hh), rx0,
            cols // 8 - 1, x0, x0 + tw, ww)
    st = edges(st, bv)
    # 2. horizontal edges at its rows y0 .. y0 + th, its own columns
    bh = on(bs_h, rx0, cols // seg, x0, min(x0 + tw, ww), ry0,
            rows // 8 - 1, y0, y0 + th, hh)
    st = edges(st.T, bh).T
    return st[y0 - ry0:min(y0 + th, hh) - ry0,
              x0 - rx0:min(x0 + tw, ww) - rx0]


def deblock_tiles_plain(y, cb, cr, tu4, qp: int, qp_c: int,
                        bit_depth: int = 8, beta_off: int = 0,
                        tc_off: int = 0, pred4=None, cbf4=None, ref4=None,
                        mv4x=None, mv4y=None, tile=(32, 32)):
    """A plain walk of kernel C4's decomposition; equals
    :func:`deblock_frame_plain`. Per tile of ``tile`` = (th, tw) luma
    samples (multiples of 8) and its chroma tiles (th/2, tw/2): stage the
    tile with a halo of 4 samples, filter the vertical edges at the tile's
    columns 0, 8, .., tw on every staged row that a deblocking segment
    beside the tile covers (4 luma rows, 2 chroma rows), then the
    horizontal edges at its rows 0, 8, .., th on its own columns, and keep
    its own samples. Each edge's BS is the picture's (edge_bs_v)."""
    h, w = y.shape
    th, tw = tile
    beta, tc, tc_c = thresholds(qp, qp_c, bit_depth, beta_off, tc_off)
    tc1 = tc_bs1(qp, bit_depth, tc_off)
    tu4 = torch.as_tensor(tu4).to(y.device).to(torch.int64)
    inter = _inter_maps(y, pred4, cbf4, ref4, mv4x, mv4y)
    bs_v = edge_bs_v(tu4, w, inter)
    bs_h = edge_bs_v(tu4.T, h, None if inter is None
                     else tuple(m.T for m in inter))

    def luma(st, bs):
        tcs = torch.where(bs == 2, tc, torch.where(bs == 1, tc1, 0))
        return _luma_edges(st, bs > 0, beta, tcs.to(torch.int32), bit_depth)

    def chroma(st, bs):
        return _chroma_edges(st, bs == 2, tc_c, bit_depth)

    outs = [torch.empty_like(p) for p in (y, cb, cr)]
    for ty0 in range(0, h, th):
        for tx0 in range(0, w, tw):
            outs[0][ty0:ty0 + th, tx0:tx0 + tw] = _walk_tile(
                y, ty0, tx0, th, tw, 4, bs_v, bs_h, luma)
            for p, o in ((cb, outs[1]), (cr, outs[2])):
                o[ty0 // 2:(ty0 + th) // 2, tx0 // 2:(tx0 + tw) // 2] = \
                    _walk_tile(p, ty0 // 2, tx0 // 2, th // 2, tw // 2, 2,
                               bs_v, bs_h, chroma)
    return tuple(outs)


def deblock_frame(y, cb, cr, tu4, qp: int, qp_c: int, bit_depth: int = 8,
                  beta_off: int = 0, tc_off: int = 0, pred4=None, cbf4=None,
                  ref4=None, mv4x=None, mv4y=None):
    """Deblock one frame. y [H, W], cb/cr [H/2, W/2] int32, tu4 [H/4, W/4]
    leaf-TU log2 map; pred4/cbf4/ref4/mv4x/mv4y ([H/4, W/4], MVs in
    quarter pel) give the inter boundary strengths, all None an all-intra
    slice. Returns the filtered planes (new tensors; the inputs are left
    as they were)."""
    if not y.is_cuda:
        return deblock_frame_plain(y, cb, cr, tu4, qp, qp_c, bit_depth,
                                   beta_off, tc_off, pred4, cbf4, ref4,
                                   mv4x, mv4y)
    return _deblock_cuda(y, cb, cr, tu4, qp, qp_c, bit_depth, beta_off,
                         tc_off, _inter_maps(y, pred4, cbf4, ref4, mv4x,
                                             mv4y))


def _deblock_cuda(y, cb, cr, tu4, qp, qp_c, bit_depth, beta_off, tc_off,
                  inter):
    global LAUNCHES
    planes = (y, cb, cr)
    tu = tu4.to(device=y.device, dtype=torch.uint8).contiguous()
    if inter is not None:
        u8 = lambda m: m.to(torch.uint8).contiguous()
        i16 = lambda m: m.to(torch.int16).contiguous()
        inter = (u8(inter[0]), u8(inter[1]), u8(inter[2]), i16(inter[3]),
                 i16(inter[4]))
        if any(tuple(m.shape) != tuple(tu.shape) for m in inter):
            raise ValueError("deblock_frame: the inter maps are [H/4, W/4]")
    for p in planes:
        if not (p.is_cuda and p.dtype == torch.int32 and p.dim() == 2
                and p.stride(1) == 1):
            raise ValueError("deblock_frame: int32 CUDA planes with dense "
                             "rows")
    h, w = y.shape
    if h % 8 or w % 8 or tuple(cb.shape) != (h // 2, w // 2) \
            or tuple(cr.shape) != (h // 2, w // 2) \
            or tuple(tu.shape) != (h // 4, w // 4):
        raise ValueError("deblock_frame: 8-aligned 4:2:0 planes and a "
                         "[H/4, W/4] tu4 map")
    beta, tc, tc_c = thresholds(qp, qp_c, bit_depth, beta_off, tc_off)
    tc1 = tc_bs1(qp, bit_depth, tc_off)
    ptr = [None] * 5 if inter is None else [m.data_ptr() for m in inter]
    outs = [torch.empty(tuple(p.shape), dtype=torch.int32, device=y.device)
            for p in planes]
    fn = _cuda.bind("deblock", "hh_deblock", "pipipi" "ppp" "pppppp"
                    "ii" "iiiii" "p")
    err = fn(y.data_ptr(), y.stride(0), cb.data_ptr(), cb.stride(0),
             cr.data_ptr(), cr.stride(0), *(o.data_ptr() for o in outs),
             tu.data_ptr(), *ptr, h, w, beta, tc, tc1, tc_c, bit_depth,
             _cuda.stream(y))
    _cuda.check("deblock", err)
    LAUNCHES += 1
    return tuple(outs)
