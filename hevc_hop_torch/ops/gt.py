"""GT (geometric transform, HOP) prediction and corner search; kernel C12.

Counterpart of hevc_hop_tpu/models/ss_scan.py ``_gt4``, ``_gt_window``,
``gt_pred_luma``, ``gt_pred_chroma``, ``gt_chroma_safe``, ``_gt_bits``,
``_gt_search``, ``_gt_arm`` and the GT branch of ``scan_encode_iss``'s
and ``scan_encode_pss``'s steps (the chroma safety gate, the GT flag and
its override of the tournament).

:func:`gt_step` is the wrapper of kernel C12 (``csrc/gt_search.cu``). Its
search entry runs one CTA per (block, anchor): the anchors are C9's ring
(the best displacement whose whole 2n window is causal) and the first AMVP
predictor, rounded to full pel, when causal and not a duplicate. From the
identity corners it takes six diamond iterations, each moving one coded
corner by +-s on one axis (12 sets, plus keeping the current one), s
halving from n/2 to 1; every set is warped with kernel C11's device code
and costs its SSE + lambda * corner bits, 1e30 where the warp is not safe.
Its decide entry, one CTA per block, keeps the cheaper anchor (the first
among equals), checks that the chroma warps of both planes are safe, and
where the GT cost beats the intra, merge and SS costs of kernel C10 (and
on a PSS picture its temporal cost), sets the GT flag and overrides C10's
choice: inter, MV = anchor * 4, the diagonal scan and the GT prediction,
in place, and on a PSS picture the reference index: the SS one.

The search kernel's split order (each iteration's candidate sets'
geometry once, integer SSEs, the first-index argmin of a warp's shuffle
butterfly, the best set warped once more at the end) is
:func:`gt_search_split`, in plain torch.

Float forms, copied from the compiled reference (``jax.jit``; ROADMAP.md
queue 3): a corner set's cost is one fused multiply-add, fma(bits, lambda,
sse); the ring anchor's total is (cost + its rate) + lambda, rounded after
each add; the predictor anchor's is fma(6 + its MVD bits, lambda, cost) +
lambda. A block SSE below 2^24 is an exact integer in any order and is
taken so; above it the port sums in ops/ss_search.py ``block_sum``'s order,
which is not the compiled reference's (F9: a 32x32 block whose SSE passes
2^24, or a 10-bit one; no test holds that region).

On a CUDA tensor the wrappers launch the kernels; on a CPU tensor they run
the ``*_plain`` versions.
"""
from __future__ import annotations

import numpy as np
import torch

from hevc_hop_torch import _cuda
from hevc_hop_torch.ops import interp, quant
from hevc_hop_torch.ops.quant import argmin_first
from hevc_hop_torch.ops.ss_search import (BIG, HUGE_PRED, INTER_BITS,
                                          SS_IDX_PSS, block_at, block_sum,
                                          f32, min_rate_bits, mvd_bits,
                                          ss_anchor_ok)
from hevc_hop_torch.ops.warp import warp_blocks_plain

SEARCH_LAUNCHES = 0
DECIDE_LAUNCHES = 0
# launches of the decide entry's PSS form
PSS_DECIDE_LAUNCHES = 0

UNSAFE = 1.0e30
ITERS = 6
# the candidate moves of an iteration: keep, then each coded corner by one
# step right, left, down, up
MOVES = np.zeros((13, 3, 2), np.int32)
for _c in range(3):
    for _d, _v in enumerate([(1, 0), (-1, 0), (0, 1), (0, -1)]):
        MOVES[1 + _c * 4 + _d, _c] = _v


def gt4(gtc: torch.Tensor) -> torch.Tensor:
    """Coded corners [..., 3, 2] (TL, TR, BR) -> [..., 4, 2] with the
    affine BL = TL + BR - TR."""
    bl = gtc[..., 0, :] + gtc[..., 2, :] - gtc[..., 1, :]
    return torch.cat([gtc, bl[..., None, :]], -2)


def gt_window(plane, pos, mv_px, n, h_clip):
    """The [B, 2n, 2n] window of plane centred on the block at pos + mv_px
    (full pel), rows clamped to h_clip - 1, columns to the plane."""
    ar = torch.arange(2 * n, device=plane.device)
    y0 = (pos[:, 1] + mv_px[:, 1] - n // 2).long()
    x0 = (pos[:, 0] + mv_px[:, 0] - n // 2).long()
    ry = (y0[:, None] + ar[None]).clamp(0, h_clip - 1)
    rx = (x0[:, None] + ar[None]).clamp(0, plane.shape[1] - 1)
    return plane[ry[:, :, None], rx[:, None, :]]


def gt_bits(gtc: torch.Tensor) -> torch.Tensor:
    """float32 bins of the three coded corner vectors [..., 3, 2]: the MVD
    binarisation per component, summed."""
    return mvd_bits(gtc).sum((-2, -1))


def gt_pred_luma(plane, pos, mv_px, gtc, n, h_clip, bit_depth):
    """GT luma prediction [B, n, n] of the blocks at pos (gtc [B, 3, 2])."""
    win = gt_window(plane, pos, mv_px, n, h_clip)
    return warp_blocks_plain(win, gt4(gtc), n, bit_depth)[0]


def _chroma_gt(plane, cpos, mv_px, gtc, m, row_lo, row_hi, bit_depth):
    """(pred, safe) of the chroma GT warp: the (2m+3)^2 window around
    cpos + (mv_px >> 1) - m/2, rows clamped to [row_lo, row_hi] per block,
    interpolated at phase (mv_px & 1) * 4 per axis into [2m, 2m], then
    warped with the coded vectors in half-pel units."""
    taps = torch.as_tensor(interp.CHROMA_FILTER, device=plane.device)
    mv_px = mv_px.to(torch.int32)
    phase = ((mv_px & 1) * 4).long()
    win = interp._window(plane, cpos - m // 2, mv_px >> 1, 4, 2 * m, row_lo,
                         row_hi)
    fwin = interp.filter_2d(win, taps[phase[:, 0]], taps[phase[:, 1]],
                            2 * m, bit_depth)
    return warp_blocks_plain(fwin, gt4(gtc), m, bit_depth, half=True)


def _full_rows(cpos, h_clip):
    lo = torch.zeros(cpos.shape[0], dtype=torch.int64, device=cpos.device)
    return lo, lo + h_clip - 1


def gt_pred_chroma(plane, cpos, mv_px, gtc, m, h_clip, bit_depth):
    """GT chroma prediction [B, m, m] (the reference's gt_pred_chroma)."""
    return _chroma_gt(plane, cpos, mv_px, gtc, m, *_full_rows(cpos, h_clip),
                      bit_depth)[0]


def gt_chroma_safe(plane, cpos, mv_px, gtc, m, h_clip, bit_depth):
    """[B] bool: the chroma GT warp is safe (the reference's
    gt_chroma_safe)."""
    return _chroma_gt(plane, cpos, mv_px, gtc, m, *_full_rows(cpos, h_clip),
                      bit_depth)[1]


def gt_pred_blocks_plain(plane, pos, mv, gtc, n, chroma, h_real, bit_depth=8,
                         hc_off=0, out=None, only=None, resi=None):
    """Plain version of ops/warp.py ``gt_pred_blocks`` (same arguments and
    results)."""
    b = pos.shape[0]
    rep = b // max(mv.shape[0], 1)
    mv_px = (mv.to(torch.int32) >> 2).repeat(rep, 1)
    gtc3 = gtc.reshape(-1, 3, 2).repeat(rep, 1, 1)
    if chroma:
        lo, hi = interp._rows(pos, True, h_real, hc_off)
        pred = _chroma_gt(plane, pos, mv_px, gtc3, n, lo, hi, bit_depth)[0]
    else:
        pred = gt_pred_luma(plane, pos, mv_px, gtc3, n, h_real, bit_depth)
    sel = (torch.ones(b, dtype=torch.bool, device=pos.device) if only is None
           else only.repeat(rep) != 0)
    if resi is not None:
        ar = torch.arange(n, device=plane.device)
        ps = pos[sel]
        rows = (ps[:, 1, None, None].long() + ar[None, :, None]).expand(
            -1, n, n)
        cols = (ps[:, 0, None, None].long() + ar[None, None, :]).expand(
            -1, n, n)
        plane[rows, cols] = torch.clamp(pred[sel] + resi[rows, cols], 0,
                                        (1 << bit_depth) - 1)
        return None
    if out is None:
        return pred
    out[sel] = pred[sel]
    return out


def _block_sse(of: torch.Tensor, preds: torch.Tensor) -> torch.Tensor:
    """float32 SSE [B, K] of of [B, n, n] against preds [B, K, n, n]:
    exact below 2^24, block_sum's order above (F9)."""
    d = of[:, None] - preds.to(torch.float32)
    sq = d * d
    tot = sq.double().sum((-2, -1))
    out = tot.float()
    big = tot >= 2.0 ** 24
    if big.any():
        out[big] = block_sum(sq[big])
    return out


def gt_search_plain(recon, org, pos, mv, n, lam, h, bit_depth,
                    iters: int = ITERS):
    """The diamond corner search around the full-pel anchors mv [B, 2]
    (the reference's _gt_search): (gtc [B, 3, 2] int32, pred [B, n, n]
    int32, cost [B] float32)."""
    b = pos.shape[0]
    dev = recon.device
    win = gt_window(recon, pos, mv, n, h)
    of = org.to(torch.float32)
    moves = torch.as_tensor(MOVES, device=dev)
    lam32 = f32(lam)
    ar = torch.arange(b, device=dev)

    def eval_cands(gtk):
        k = gtk.shape[1]
        winb = win[:, None].expand(b, k, 2 * n, 2 * n).reshape(
            b * k, 2 * n, 2 * n)
        preds, safe = warp_blocks_plain(winb, gt4(gtk).reshape(b * k, 4, 2),
                                        n, bit_depth)
        preds = preds.reshape(b, k, n, n)
        cost = quant.fma(gt_bits(gtk), lam32, _block_sse(of, preds))
        return torch.where(safe.reshape(b, k), cost,
                           torch.full_like(cost, UNSAFE)), preds

    gtc = torch.zeros((b, 3, 2), dtype=torch.int32, device=dev)
    cost0, pred0 = eval_cands(gtc[:, None])
    best_cost, best_pred = cost0[:, 0], pred0[:, 0]
    s = n // 2
    for _ in range(iters):
        cands = gtc[:, None] + moves[None] * s
        costs, preds = eval_cands(cands)
        ki = argmin_first(costs)
        c_new = costs[ar, ki]
        upd = c_new < best_cost
        gtc = torch.where(upd[:, None, None], cands[ar, ki], gtc)
        best_pred = torch.where(upd[:, None, None], preds[ar, ki], best_pred)
        best_cost = torch.minimum(best_cost, c_new)
        s = max(1, s // 2)
    return gtc, best_pred, best_cost


def gt_search_split(recon, org, pos, mv, n, lam, h, bit_depth,
                    iters: int = ITERS, stats=None):
    """Kernel C12's search in its split order (csrc/gt_search.cuh
    ``gt_search_n``), in plain torch: per iteration each candidate set's
    geometry computed once (its corners, the warp's affine map, its bits),
    its samples warped and summed as integers, the float32 SSE exact below
    2^24 and in block_sum's order above (ops/inter_arms.py ``warp_sse``);
    the costs on 13 lanes and the least (cost, index) by the butterfly
    (``lane_argmin``), kept when strictly below the best so far (always on
    the identity set). No candidate's prediction is kept: the best set is
    warped once more at the end. Same arguments and results as
    :func:`gt_search_plain`; ``stats`` (a dict, where given) counts the
    iterations whose least cost was tied (``ties``) and the safe
    candidates past 2^24 (``past_2_24``)."""
    from hevc_hop_torch.ops.inter_arms import lane_argmin, warp_sse
    if stats is not None:
        for key in ("ties", "past_2_24"):
            stats.setdefault(key, 0)
    b = pos.shape[0]
    dev = recon.device
    win = gt_window(recon, pos, mv, n, h)
    moves = torch.as_tensor(MOVES, device=dev)
    lam32 = f32(lam)
    ar = torch.arange(b, device=dev)
    gtc = torch.zeros((b, 3, 2), dtype=torch.int32, device=dev)
    best = None
    s = n // 2
    for it in range(-1, iters):
        cands = gtc[:, None] if it < 0 else gtc[:, None] + moves[None] * s
        k = cands.shape[1]
        winb = win[:, None].expand(b, k, 2 * n, 2 * n).reshape(
            b * k, 2 * n, 2 * n)
        preds, safe = warp_blocks_plain(winb, gt4(cands).reshape(b * k, 4, 2),
                                        n, bit_depth)
        sse, tot = warp_sse(org[:, None], preds.reshape(b, k, n, n))
        safe = safe.reshape(b, k)
        cost = torch.where(safe, quant.fma(gt_bits(cands), lam32, sse),
                           torch.full_like(sse, UNSAFE))
        cm, ki = lane_argmin(cost)
        upd = (torch.ones_like(safe[:, 0]) if it < 0 else cm < best)
        gtc = torch.where(upd[:, None, None], cands[ar, ki], gtc)
        best = cm if it < 0 else torch.where(upd, cm, best)
        if stats is not None:
            stats["ties"] += int(((cost == cm[:, None]).sum(-1) > 1).sum())
            stats["past_2_24"] += int(((tot >= 2 ** 24) & safe).sum())
        if it >= 0:
            s = max(1, s // 2)
    pred = warp_blocks_plain(win, gt4(gtc), n, bit_depth)[0]
    return gtc, pred, best


def gt_anchors_plain(recon, org, pos, zcur, zmax2n, anchor, gt_rate, gt_ok,
                     p_ss, n, lam, w, h, bit_depth):
    """The search entry's outputs per (block, anchor) (the reference's
    _gt_arm before its argmin, with C9's one ring anchor): anchor [B, 2]
    full pel, gt_rate [B] float32 and gt_ok [B] bool from C9's ring; p_ss
    [B, 6, 2] the AMVP predictors. Returns (s_gtc [B, 2, 6], s_pred [B, 2,
    n, n], s_cost [B, 2] float32 totals, 3e38 where the anchor is not
    causal, s_amv [B, 2, 2] full pel, s_ok [B, 2] int32). An anchor that
    is not causal is not searched: its corners and prediction are zero."""
    b = pos.shape[0]
    dev = pos.device
    pr = p_ss[:, 0]
    valid_p = (pr.abs() < HUGE_PRED // 2).all(-1)
    prd = torch.where(valid_p[:, None], (pr + 2) >> 2, 0).to(torch.int32)
    ok_p = ss_anchor_ok(pos, zcur, zmax2n, prd, n, w, h) & valid_p
    bits_p = min_rate_bits((prd * 4)[:, None], p_ss)[:, 0]
    dup = (anchor == prd).all(-1) & gt_ok
    ok = torch.stack([gt_ok, ok_p & ~dup], 1)
    anchors = torch.stack([anchor.to(torch.int32), prd], 1)
    gtc_a = torch.zeros((b, 2, 3, 2), dtype=torch.int32, device=dev)
    gpred_a = torch.zeros((b, 2, n, n), dtype=torch.int32, device=dev)
    cost_a = torch.full((b, 2), BIG, dtype=torch.float32, device=dev)
    sel = ok.nonzero()
    if len(sel):
        bi, ai = sel[:, 0], sel[:, 1]
        g, p, c = gt_search_plain(recon, org[bi], pos[bi], anchors[bi, ai],
                                  n, lam, h, bit_depth)
        gtc_a[bi, ai], gpred_a[bi, ai], cost_a[bi, ai] = g, p, c
    lam32 = torch.tensor(f32(lam), dtype=torch.float32, device=dev)
    g0 = (cost_a[:, 0] + gt_rate) + lam32
    g1 = quant.fma(bits_p + INTER_BITS, f32(lam), cost_a[:, 1]) + lam32
    gcost_a = torch.where(ok, torch.stack([g0, g1], 1),
                          torch.full_like(cost_a, BIG))
    return (gtc_a.reshape(b, 2, 6), gpred_a, gcost_a, anchors,
            ok.to(torch.int32))


def gt_arm_plain(recon, org, pos, zcur, zmax2n, anchor, gt_rate, gt_ok,
                 p_ss, n, lam, w, h, bit_depth):
    """The multi-anchor GT refinement (the reference's _gt_arm with C9's
    one ring anchor): :func:`gt_anchors_plain`'s anchors, the least cost
    kept (the first among equals). Returns (gcost [B] float32, gtc [B, 3,
    2], gpred [B, n, n], amv [B, 2], ok_any [B]). Where no anchor is
    causal, gcost is 3e38 as in the reference and gtc, gpred and amv are
    those of an unsearched first anchor (zero corners)."""
    s_gtc, s_pred, s_cost, s_amv, s_ok = gt_anchors_plain(
        recon, org, pos, zcur, zmax2n, anchor, gt_rate, gt_ok, p_ss, n, lam,
        w, h, bit_depth)
    ai = argmin_first(s_cost)
    ar = torch.arange(pos.shape[0], device=pos.device)
    return (s_cost[ar, ai], s_gtc[ar, ai].reshape(-1, 3, 2), s_pred[ar, ai],
            s_amv[ar, ai], (s_ok != 0).any(1))


def gt_step_plain(recon, org_plane, rc, pos, zcur, zmax2n, motion, nbav, miav,
                  ring, costs, pred, inter, mv, smode, n, w, h, hc_off,
                  bit_depth, lam, mi_size, refsel=None):
    """Plain version of :func:`gt_step` (same arguments and results)."""
    from hevc_hop_torch.ops.inter_arms import gather_cands
    anchor, gt_rate, gt_ok = ring
    ss_idx = 0 if refsel is None else SS_IDX_PSS
    p_ss = gather_cands(*motion, pos, nbav, miav, n, mi_size, ss_idx)[3]
    org = block_at(org_plane, pos, n)
    gcost, gtc, gpred, amv, gok = gt_arm_plain(
        recon, org, pos, zcur, zmax2n, anchor, gt_rate, gt_ok, p_ss, n, lam,
        w, h, bit_depth)
    nonzero = (gtc != 0).flatten(1).any(1)
    m, hc = n // 2, h // 2
    cb = pos // 2
    cr = cb + torch.tensor([0, hc_off], dtype=cb.dtype, device=cb.device)
    csafe = torch.ones_like(gok)
    for cp in (cb, cr):
        lo, hi = interp._rows(cp, True, hc, hc_off)
        csafe &= _chroma_gt(rc, cp, amv, gtc, m, lo, hi, bit_depth)[1]
    icost, mcost, sscost = costs.unbind(1)[:3]
    flag = (gok & nonzero & csafe & (gcost < sscost) & (gcost < icost)
            & (gcost < mcost))
    if refsel is not None:
        flag &= gcost < costs[:, 3]
        refsel[flag] = ss_idx
    pred[flag] = gpred[flag]
    inter[flag] = 1
    mv[flag] = amv[flag] * 4
    smode[flag] = 0
    return flag.to(torch.int32), gtc.reshape(-1, 6)


# ---------------------------------------------------------------------------
# Kernel C12.
# ---------------------------------------------------------------------------

def _check(t, dtype, name):
    if not (t.is_cuda and t.dtype == dtype and t.is_contiguous()):
        raise ValueError(f"gt_step: {name} must be a contiguous CUDA "
                         f"{dtype} tensor")


def _check_plane(t, name):
    if not (t.is_cuda and t.dtype == torch.int32 and t.stride(-1) == 1):
        raise ValueError(f"gt_step: {name} must be a CUDA int32 plane with "
                         "dense rows")


def gt_step(recon, org_plane, rc, pos, zcur, zmax2n, motion, nbav, miav,
            ring, costs, pred, inter, mv, smode, n, w, h, hc_off, bit_depth,
            lam, mi_size, refsel=None):
    """Kernel C12 over B blocks of size n (one wavefront level), between
    kernel C10 and kernel C3.

    recon/org_plane [H(+pad), W] int32; rc the stacked cb/cr recon (cr from
    row hc_off) as it stands before this level's chroma; pos, zcur, motion,
    nbav, miav as for kernel C9; zmax2n [h-2n+1, w-2n+1] int32 the 2n
    window's causality plane; ring = (anchor [B, 2], gt_rate [B], gt_ok [B])
    from C9's ring; costs [B, 3] (intra, merge, SS) from C10. Where GT
    wins, overwrites pred [B, n, n], inter [B], mv [B, 2] (quarter pel) and
    smode [B] in place. Returns (gtflag [B] int32, gtc [B, 6] int32: the
    winning anchor's coded corners, TL, TR, BR as (x, y)).

    On a PSS picture refsel [B] int32 is C10's reference index (the SS
    reference, L0's last entry, names the AMVP predictors; GT must also
    beat the temporal cost, costs [B, 4]) and is set to the SS one where
    GT wins."""
    if not recon.is_cuda:
        return gt_step_plain(recon, org_plane, rc, pos, zcur, zmax2n, motion,
                             nbav, miav, ring, costs, pred, inter, mv, smode,
                             n, w, h, hc_off, bit_depth, lam, mi_size,
                             refsel)
    return _gt_step_cuda(recon, org_plane, rc, pos, zcur, zmax2n, motion,
                         nbav, miav, ring, costs, pred, inter, mv, smode, n,
                         w, h, hc_off, bit_depth, lam, mi_size, refsel)


def _gt_step_cuda(recon, org_plane, rc, pos, zcur, zmax2n, motion, nbav,
                  miav, ring, costs, pred, inter, mv, smode, n, w, h, hc_off,
                  bit_depth, lam, mi_size, refsel):
    global SEARCH_LAUNCHES, DECIDE_LAUNCHES, PSS_DECIDE_LAUNCHES
    b = pos.shape[0]
    anchor, gt_rate, gt_ok = ring
    for t, nm in ((recon, "recon"), (org_plane, "org_plane"), (rc, "rc")):
        _check_plane(t, nm)
    if recon.stride(0) != org_plane.stride(0):
        raise ValueError("gt_step: recon and org_plane share one stride")
    if costs.shape[1:] != ((3,) if refsel is None else (4,)):
        raise ValueError("gt_step: costs [B, 3], or [B, 4] with refsel")
    for t, nm in ((pos, "pos"), (zcur, "zcur"), (zmax2n, "zmax2n"),
                  (anchor, "anchor"), (pred, "pred"), (inter, "inter"),
                  (mv, "mv"), (smode, "smode"),
                  *((m, "motion") for m in motion),
                  *(() if refsel is None else ((refsel, "refsel"),))):
        _check(t, torch.int32, nm)
    for t, nm in ((gt_rate, "gt_rate"), (costs, "costs")):
        _check(t, torch.float32, nm)
    for t, nm in ((gt_ok, "gt_ok"), (nbav, "nbav"), (miav, "miav")):
        _check(t, torch.bool, nm)
    dev = recon.device
    flag = torch.empty(b, dtype=torch.int32, device=dev)
    gtc = torch.empty((b, 6), dtype=torch.int32, device=dev)
    if b == 0:
        return flag, gtc
    # per (block, anchor): corners, prediction, total cost, anchor, ok
    s_gtc = torch.empty((b, 2, 6), dtype=torch.int32, device=dev)
    s_pred = torch.empty((b, 2, n, n), dtype=torch.int32, device=dev)
    s_cost = torch.empty((b, 2), dtype=torch.float32, device=dev)
    s_amv = torch.empty((b, 2, 2), dtype=torch.int32, device=dev)
    s_ok = torch.empty((b, 2), dtype=torch.int32, device=dev)
    mvx4, mvy4, pi4, rf4 = motion
    lam32 = f32(lam)
    ss_idx = 0 if refsel is None else SS_IDX_PSS
    fn = _cuda.bind("gt_search", "hh_gt_search",
                    "ppi" "ppp" "pppp" "ii" "pp" "ppp"
                    "iiiiiiif" "ppppp" "p")
    err = fn(recon.data_ptr(), org_plane.data_ptr(), recon.stride(0),
             pos.data_ptr(), zcur.data_ptr(), zmax2n.data_ptr(),
             mvx4.data_ptr(), mvy4.data_ptr(), pi4.data_ptr(),
             rf4.data_ptr(), pi4.shape[0], pi4.shape[1],
             nbav.data_ptr(), miav.data_ptr(),
             anchor.data_ptr(), gt_rate.data_ptr(), gt_ok.data_ptr(),
             b, n, w, h, bit_depth, mi_size, ss_idx, lam32,
             s_gtc.data_ptr(), s_pred.data_ptr(), s_cost.data_ptr(),
             s_amv.data_ptr(), s_ok.data_ptr(), _cuda.stream(recon))
    _cuda.check("gt_search", err)
    SEARCH_LAUNCHES += 1
    fn = _cuda.bind("gt_search", "hh_gt_decide",
                    "pii" "iiiii" "ppppppp" "pppppp" "pi" "p")
    err = fn(rc.data_ptr(), rc.shape[1], rc.stride(0),
             b, n, h // 2, hc_off, bit_depth,
             pos.data_ptr(), s_gtc.data_ptr(), s_pred.data_ptr(),
             s_cost.data_ptr(), s_amv.data_ptr(), s_ok.data_ptr(),
             costs.data_ptr(), pred.data_ptr(), inter.data_ptr(),
             mv.data_ptr(), smode.data_ptr(), flag.data_ptr(),
             gtc.data_ptr(), None if refsel is None else refsel.data_ptr(),
             ss_idx, _cuda.stream(recon))
    _cuda.check("gt_search", err)
    DECIDE_LAUNCHES += 1
    if refsel is not None:
        PSS_DECIDE_LAUNCHES += 1
    return flag, gtc


# ---------------------------------------------------------------------------
# Walk of kernel C12's decision (csrc/gt_search.cuh gt_pick, gt_chroma_check,
# gt_decide_put), in plain torch, for the tests.
# ---------------------------------------------------------------------------

# the decision's words of a block, lane k of a warp word k (gt_search.cuh
# GtWord): the anchors' costs, ok flags, anchors, corners, C10's costs
WORD_COST, WORD_OK, WORD_AMV, WORD_GTC, WORD_C10, DECIDE_WORDS = (0, 2, 4, 8,
                                                                  20, 24)


def decide_words(s_cost, s_ok, s_amv, s_gtc, costs) -> torch.Tensor:
    """[B, 32] int32: lane k's word of each block as gt_pick loads it
    (floats by their bits, zero past the last word)."""
    b = s_cost.shape[0]
    v = torch.zeros((b, 32), dtype=torch.int32, device=s_cost.device)
    v[:, WORD_COST:WORD_OK] = s_cost.contiguous().view(torch.int32)
    v[:, WORD_OK:WORD_AMV] = s_ok
    v[:, WORD_AMV:WORD_GTC] = s_amv.reshape(b, 4)
    v[:, WORD_GTC:WORD_C10] = s_gtc.reshape(b, 12)
    nc = costs.shape[1]
    v[:, WORD_C10:WORD_C10 + nc] = costs.contiguous().view(torch.int32)
    return v


def gt_pick_walk(v: torch.Tensor, pss: bool):
    """gt_pick on the words v [B, 32]: each block's anchor ai (the anchors'
    costs shuffled from lanes 0 and 1), candidate test and chosen corners
    [B, 6], as a warp takes them: each lane tests its own word, each test
    a ballot (an ok flag set, a corner of the chosen anchor not zero, a
    C10 cost at or below the GT cost)."""
    b = v.shape[0]
    ar = torch.arange(b, device=v.device)
    lane = torch.arange(32, device=v.device)
    fl = lambda k: v[:, k].contiguous().view(torch.float32)
    c0, c1 = fl(WORD_COST), fl(WORD_COST + 1)
    ai = (c1 < c0).long()
    g = torch.where(ai == 1, c1, c0)
    lo = (WORD_GTC + 6 * ai)[:, None]
    nc = 4 if pss else 3
    ok = ((lane >= WORD_OK) & (lane < WORD_AMV) & (v != 0)).any(1)
    nonzero = ((lane >= lo) & (lane < lo + 6) & (v != 0)).any(1)
    beaten = ((lane >= WORD_C10) & (lane < WORD_C10 + nc)
              & ~(g[:, None] < v.view(torch.float32))).any(1)
    corners = v[ar[:, None], lo + torch.arange(6, device=v.device)]
    return ai, ok & nonzero & ~beaten, corners


def gt_decide_walk(rc, pos, s_gtc, s_pred, s_cost, s_amv, s_ok, costs, pred,
                   inter, mv, smode, n, h, hc_off, bit_depth, refsel=None,
                   ss_idx=SS_IDX_PSS, slot=False):
    """Kernel C12's decision as csrc/gt_search.cuh runs it, in plain torch:
    the pick on each block's words (gt_pick_walk), the chroma check
    (gt_chroma_pair_walk) on the candidates alone, then the outputs: gtc
    [B, 6] the chosen corners, flag [B], and where GT is safe and wins
    C10's choice overridden in place (inter, mv, smode, on PSS refsel,
    set to ss_idx) and, unless ``slot`` (kernel C14, whose write phase
    reads a GT CU's prediction from its chosen anchor's slot of s_pred),
    the prediction copied over pred. refsel None: the ISS form (costs [B,
    3]); else costs [B, 4]. Returns (flag [B] int32, gtc [B, 6], cand [B]
    bool: the blocks that ran the chroma check, ai [B]: the chosen slot)."""
    pss = refsel is not None
    v = decide_words(s_cost, s_ok, s_amv, s_gtc, costs)
    ai, cand, gtc = gt_pick_walk(v, pss)
    # the chosen anchor, loaded by a candidate's check (gt_anchor)
    amv = s_amv[torch.arange(pos.shape[0], device=pos.device), ai]
    safe = torch.zeros_like(cand)
    sel = cand.nonzero()[:, 0]
    if len(sel):
        safe[sel] = gt_chroma_pair_walk(rc, pos[sel] // 2, amv[sel],
                                        gtc[sel].reshape(-1, 3, 2), n // 2,
                                        h // 2, hc_off, bit_depth)[2]
    inter[safe] = 1
    mv[safe] = amv[safe] * 4
    smode[safe] = 0
    if pss:
        refsel[safe] = ss_idx
    if not slot:
        ar = torch.arange(pos.shape[0], device=pos.device)
        pred[safe] = s_pred[ar, ai][safe]
    return safe.to(torch.int32), gtc, cand, ai


# ---------------------------------------------------------------------------
# Walks of kernel C11's one-pass bodies (csrc/warp.cuh), in plain torch, for
# the tests.
# ---------------------------------------------------------------------------

def gt_chroma_walk(plane, cpos, mv_px, gtc, m, row_lo, row_hi, bit_depth,
                   nthr):
    """csrc/warp.cuh's chroma form of one plane's m x m blocks at cpos
    [B, 2] with the full-pel anchors mv_px [B, 2] and the coded corners
    gtc [B, 3, 2], as kernel C14's one-pass bodies run it: the (2m+3)^2
    window staged as int16 (rows [row_lo, row_hi] [B]), interpolated at the
    phase (mv_px & 1) * 4 by nthr threads (interp.py mc_filter_walk) into
    [2m, 2m], warped in half-pel units. Returns (pred [B, m, m], knife [B]
    bool: a sample sits on a knife edge, writes [2m, 2m] of the
    interpolation)."""
    mv_px = mv_px.to(torch.int32)
    win = interp.stage_window16(plane, cpos[:, 0] - m // 2 + (mv_px[:, 0] >> 1)
                                - 1, cpos[:, 1] - m // 2 + (mv_px[:, 1] >> 1)
                                - 1, 2 * m + 3, row_lo, row_hi)
    fwin, writes = interp.mc_filter_walk(win, (mv_px[:, 0] & 1) * 4,
                                         (mv_px[:, 1] & 1) * 4, 2 * m, True,
                                         bit_depth, nthr)
    pred, safe = warp_blocks_plain(fwin, gt4(gtc), m, bit_depth, half=True)
    return pred, ~safe, writes


def gt_chroma_pair_walk(rc, cb_pos, mv_px, gtc, m, hc, hc_off, bit_depth):
    """Kernel C12's chroma check as kernel C14 runs it (csrc/gt_search.cuh
    gt_decide_block, warp.cuh gt_chroma_pair): cb at cb_pos [B, 2] (rows
    [0, hc) of the stacked rc) and cr hc_off rows below (rows [hc_off,
    hc_off + hc)) warped in one pass, 128 threads a plane. Returns (cb's
    prediction, cr's, safe [B]): the decision's flag, and the predictions
    that C14's chroma stage then takes as they are for a GT CU."""
    b = cb_pos.shape[0]
    zero = torch.zeros(b, dtype=torch.int64, device=rc.device)
    cr_pos = cb_pos + torch.tensor([0, hc_off], dtype=cb_pos.dtype,
                                   device=rc.device)
    pb, kb, _ = gt_chroma_walk(rc, cb_pos, mv_px, gtc, m, zero, zero + hc - 1,
                               bit_depth, 128)
    pr, kr, _ = gt_chroma_walk(rc, cr_pos, mv_px, gtc, m, zero + hc_off,
                               zero + hc_off + hc - 1, bit_depth, 128)
    return pb, pr, ~(kb | kr)


def gt_cu_walk(src_y, src_c, dst_y, dst_c, resi_y, resi_c, pos, cb_pos,
               cr_pos, mv_px, gtc, n, h, hc, hc_off, bit_depth):
    """csrc/warp.cuh gt_cu, kernel C14's decode of GT CUs (n x n luma at
    pos, n/2 x n/2 cb and cr at cb_pos and cr_pos [B, 2], full-pel anchors
    mv_px, coded corners gtc [B, 3, 2]) in one pass: the luma's [2n, 2n]
    window of src_y staged as int16 (rows [0, h)) and warped, cb and cr of
    the stacked src_c by 64 threads each (gt_chroma_walk), clip(prediction
    + residual) written into dst_y and dst_c (C14: the recon itself)."""
    b = pos.shape[0]
    zero = torch.zeros(b, dtype=torch.int64, device=src_y.device)
    mv_px = mv_px.to(torch.int32)
    win = interp.stage_window16(src_y, pos[:, 0] + mv_px[:, 0] - n // 2,
                                pos[:, 1] + mv_px[:, 1] - n // 2, 2 * n,
                                zero, zero + h - 1)
    py = warp_blocks_plain(win, gt4(gtc), n, bit_depth)[0]
    m = n // 2
    pb = gt_chroma_walk(src_c, cb_pos, mv_px, gtc, m, zero, zero + hc - 1,
                        bit_depth, 64)[0]
    pr = gt_chroma_walk(src_c, cr_pos, mv_px, gtc, m, zero + hc_off,
                        zero + hc_off + hc - 1, bit_depth, 64)[0]
    interp.add_residual(dst_y, py, pos, resi_y, bit_depth)
    interp.add_residual(dst_c, pb, cb_pos, resi_c, bit_depth)
    interp.add_residual(dst_c, pr, cr_pos, resi_c, bit_depth)
