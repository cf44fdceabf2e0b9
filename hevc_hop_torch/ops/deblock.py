"""In-loop deblocking of an all-intra frame; kernel C4.

Counterpart of hevc_hop_tpu/ops/deblock.py ``deblock_frame`` with
``pred4 is None`` (every edge of a transform block has BS 2). The inter-BS
arm (pred4, cbf4, ref4, mv4x, mv4y) belongs to the P-slice path and is not
ported yet.

:func:`deblock_frame` launches kernel C4 (``csrc/deblock.cu``) on CUDA
tensors: one launch filters all vertical edges of the three planes, a
second all horizontal edges of the vertically filtered planes. On CPU
tensors it runs :func:`deblock_frame_plain`, whose passes are dense tensor
code that runs on any device.
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


def edge_on_v(tu4: torch.Tensor, w: int) -> torch.Tensor:
    """[H/4, E] transform-block edges on the vertical 8-grid (BS 2 in an
    all-intra slice), E = w // 8 - 1."""
    e = w // 8 - 1
    xs = (torch.arange(e, device=tu4.device) + 1) * 8
    sizes = 1 << tu4[:, xs // 4].to(torch.int64)
    return (xs[None, :] % sizes) == 0


def deblock_frame_plain(y, cb, cr, tu4, qp: int, qp_c: int,
                        bit_depth: int = 8, beta_off: int = 0,
                        tc_off: int = 0):
    """Plain version of :func:`deblock_frame` (returns new planes)."""
    h, w = y.shape
    beta, tc, tc_c = thresholds(qp, qp_c, bit_depth, beta_off, tc_off)
    tu4 = tu4.to(torch.int64)
    ev = edge_on_v(tu4, w)
    eh = edge_on_v(tu4.T, h)
    tcs = lambda on: torch.where(on, tc, 0).to(torch.int32)
    y = _luma_edges(y, ev, beta, tcs(ev), bit_depth)
    y = _luma_edges(y.T, eh, beta, tcs(eh), bit_depth).T.contiguous()
    if tc_c > 0:
        hc, wc = cb.shape
        if wc // 8 - 1 > 0:
            evc = ev[:, 1::2][:, :wc // 8 - 1]
            cb = _chroma_edges(cb, evc, tc_c, bit_depth)
            cr = _chroma_edges(cr, evc, tc_c, bit_depth)
        if hc // 8 - 1 > 0:
            ehc = eh[:, 1::2][:, :hc // 8 - 1]
            cb = _chroma_edges(cb.T, ehc, tc_c, bit_depth).T.contiguous()
            cr = _chroma_edges(cr.T, ehc, tc_c, bit_depth).T.contiguous()
    return y, cb, cr


def deblock_frame(y, cb, cr, tu4, qp: int, qp_c: int, bit_depth: int = 8,
                  beta_off: int = 0, tc_off: int = 0):
    """Deblock one all-intra frame. y [H, W], cb/cr [H/2, W/2] int32,
    tu4 [H/4, W/4] leaf-TU log2 map. Returns the filtered planes (new
    tensors; the inputs are left as they were)."""
    if not y.is_cuda:
        return deblock_frame_plain(y, cb, cr, tu4, qp, qp_c, bit_depth,
                                   beta_off, tc_off)
    return _deblock_cuda(y, cb, cr, tu4, qp, qp_c, bit_depth, beta_off,
                         tc_off)


def _deblock_cuda(y, cb, cr, tu4, qp, qp_c, bit_depth, beta_off, tc_off):
    global LAUNCHES
    planes = [p.contiguous().clone() for p in (y, cb, cr)]
    tu = tu4.to(device=y.device, dtype=torch.uint8).contiguous()
    for p in planes:
        if not (p.is_cuda and p.dtype == torch.int32):
            raise ValueError("deblock_frame: int32 CUDA planes")
    h, w = y.shape
    if h % 8 or w % 8 or tuple(cb.shape) != (h // 2, w // 2) \
            or tuple(cr.shape) != (h // 2, w // 2) \
            or tuple(tu.shape) != (h // 4, w // 4):
        raise ValueError("deblock_frame: 8-aligned 4:2:0 planes and a "
                         "[H/4, W/4] tu4 map")
    beta, tc, tc_c = thresholds(qp, qp_c, bit_depth, beta_off, tc_off)
    fn = _cuda.bind("deblock", "hh_deblock", "pppp" "ii" "iiiii" "p")
    py, pcb, pcr = planes
    for vertical in (1, 0):
        err = fn(py.data_ptr(), pcb.data_ptr(), pcr.data_ptr(),
                 tu.data_ptr(), h, w, vertical, beta, tc, tc_c, bit_depth,
                 _cuda.stream(py))
        _cuda.check("deblock", err)
        LAUNCHES += 1
    return py, pcb, pcr
