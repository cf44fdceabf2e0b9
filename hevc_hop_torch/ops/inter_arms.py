"""Merge candidates, sub-pel refinement and the ISS and PSS tournaments;
kernel C10.

Counterpart of hevc_hop_tpu/models/ss_scan.py ``_gather_cands``,
``_merge_arms``, ``_frac_refine`` and the intra / SS / merge tournament of
``scan_encode_iss``'s step, and the intra / SS / temporal / merge one of
``scan_encode_pss``'s (GT off; ops/gt.py overrides either with GT).

:func:`inter_arms` is the wrapper of kernel C10 (``csrc/inter_arms.cu``),
one CTA per block: it gathers the nine merge candidates (five spatial
neighbours, three micro-image displacements, zero) and the six AMVP
predictors from the carried 4x4 motion planes; codes each valid, causal
candidate through the exact quarter-pel MC and keeps the lowest SSE +
merge rate; refines the full-pel search result of kernel C9 by half and
then quarter pel over eight neighbours each; and runs the tournament
against the intra prediction. It writes the chosen prediction over the
intra one (in place), the inter flag, the quarter-pel MV and the mode that
picks the MDCS scan for kernel C3 (0, the diagonal scan, for an inter
block). Its PSS form (``pss`` given) predicts each merge candidate from
the plane its reference index names (the recon for the SS reference, L0's
last entry; the previous picture for the temporal one, which no causal
veto touches), refines the temporal search's result over the previous
picture with the temporal predictors as well, and adds the temporal arm
to the tournament (inter cost = the lower of SS and temporal); it also
returns each block's reference index. :func:`motion_write` (kernel C10's
second entry) then writes the level's motion, and on a PSS picture the
reference indices, into the carried planes, after every block of the
launch has read them, as the reference's scan step does.

Float forms, copied from the compiled reference (ROADMAP.md queue 3, F8):
every SSE is summed in XLA:CPU's order (ops/ss_search.py ``block_sum``); the
merge rate lam * (4 + index bits) is folded to a float32 constant and
added; the refinement's rate is one fused multiply-add, fma(INTER_BITS +
bits, lam, sse); the intra cost is SSE + float32(lam * INTRA_BITS).

On a CUDA tensor the wrappers launch the kernel; on a CPU tensor they run
the ``*_plain`` version.
"""
from __future__ import annotations

import numpy as np
import torch

from hevc_hop_torch import _cuda
from hevc_hop_torch.ops import interp, quant
from hevc_hop_torch.ops.quant import argmin_first
from hevc_hop_torch.ops.ss_search import (BIG, HUGE_PRED, INTER_BITS,
                                          INTRA_BITS, SS_IDX_PSS, block_sum,
                                          f32, min_rate_bits)

LAUNCHES = 0
MOTION_LAUNCHES = 0
# the launches of each entry's PSS form
PSS_LAUNCHES = 0
PSS_MOTION_LAUNCHES = 0

# half/quarter-pel neighbours (dx, dy), row by row
FRAC_OFFS = np.array([(dx, dy) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                      if (dx, dy) != (0, 0)], np.int32)


def gather_cands(mvx4, mvy4, pi4, rf4, pos, nbav, miav, n: int,
                 mi_size: int, ss_idx: int = 0):
    """Merge and AMVP material from the carried motion planes (the
    reference's ``_gather_cands``): (cands [B, 9, 2] quarter-pel, cref
    [B, 9], cvalid [B, 9], preds_ss [B, 6, 2], preds_t [B, 3, 2]); the
    order is A1, B1, B0, A0, B2, the three MI candidates, zero. ss_idx is
    the SS reference's index (0 on ISS, L0's last on PSS): the SS
    predictors are A1 and B1 where they name it, the MI displacements and
    zero; the temporal ones A1 and B1 where they name another, and zero."""
    b = pos.shape[0]
    dev = pos.device
    px, py = pos[:, 0].long(), pos[:, 1].long()
    nx = torch.stack([px - 1, px + n - 1, px + n, px - 1, px - 1], 1)
    ny = torch.stack([py + n - 1, py - 1, py - 1, py + n, py - 1], 1)
    hp, wp = pi4.shape
    gy = ny.clamp(0, hp * 4 - 1) // 4
    gx = nx.clamp(0, wp * 4 - 1) // 4
    sp_mv = torch.stack([mvx4[gy, gx], mvy4[gy, gx]], -1).to(torch.int32)
    sp_ref = rf4[gy, gx]
    sp_ok = nbav & (pi4[gy, gx] == 1)
    dmi = -(((n + mi_size - 1) // mi_size) * mi_size) * 4 if mi_size else 0
    mi_mv = torch.tensor([[dmi, 0], [0, dmi], [dmi, dmi]], dtype=torch.int32,
                         device=dev)[None].expand(b, 3, 2)
    mi_ok = miav if mi_size > 0 else torch.zeros((b, 3), dtype=torch.bool,
                                                 device=dev)
    zero_mv = torch.zeros((b, 1, 2), dtype=torch.int32, device=dev)
    cands = torch.cat([sp_mv, mi_mv, zero_mv], 1)
    cref = torch.cat([sp_ref.to(torch.int32),
                      torch.full((b, 3), ss_idx, dtype=torch.int32,
                                 device=dev),
                      torch.zeros((b, 1), dtype=torch.int32, device=dev)], 1)
    cvalid = torch.cat([sp_ok, mi_ok, torch.ones((b, 1), dtype=torch.bool,
                                                 device=dev)], 1)
    big = torch.full_like(sp_mv[:, :2], HUGE_PRED)
    a1b1_ss = sp_ok[:, :2] & (sp_ref[:, :2] == ss_idx)
    a1b1_t = sp_ok[:, :2] & (sp_ref[:, :2] != ss_idx)
    p_ss = torch.cat([
        torch.where(a1b1_ss[..., None], sp_mv[:, :2], big),
        torch.where(mi_ok[..., None], mi_mv, big[:, :1].expand(b, 3, 2)),
        zero_mv], 1)
    p_t = torch.cat([torch.where(a1b1_t[..., None], sp_mv[:, :2], big),
                     zero_mv], 1)
    return cands, cref, cvalid, p_ss, p_t


def merge_arms_plain(recon, of, pos, zcur, zmaxw, cands, cvalid, n, w, h,
                     bit_depth, lam, ref=None, cref=None, ss_idx=0):
    """Prediction-domain RD of each merge candidate: (cost [B], mv [B, 2]
    quarter-pel, reference index [B], pred [B, n, n]). Without ref every
    candidate reads the SS reference, recon; with ref (a PSS picture) a
    candidate whose cref is not ss_idx reads ref, and only the SS ones
    must be causal."""
    b, k = cands.shape[:2]
    posr = pos.repeat_interleave(k, 0)
    pred = interp.luma_mc(recon, posr, cands.reshape(-1, 2), n, h,
                          bit_depth).reshape(b, k, n, n)
    if cref is None:
        cref = torch.full((b, k), ss_idx, dtype=torch.int32,
                          device=pos.device)
    is_ss = cref == ss_idx
    if ref is not None:
        p_t = interp.luma_mc(ref, posr, cands.reshape(-1, 2), n, h,
                             bit_depth).reshape(b, k, n, n)
        pred = torch.where(is_ss[..., None, None], pred, p_t)
    mvi = cands >> 2
    tx = pos[:, None, 0].long() + mvi[..., 0]
    ty = pos[:, None, 1].long() + mvi[..., 1]
    inb = (tx >= 0) & (ty >= 0) & (tx + n <= w) & (ty + n <= h)
    zm = zmaxw[ty.clamp(0, h - n), tx.clamp(0, w - n)]
    ok = cvalid & torch.where(is_ss, inb & (zm < zcur[:, None]), True)
    sse = block_sum((of[:, None] - pred.to(torch.float32)) ** 2)
    idx_bits = torch.minimum(torch.arange(k, device=pos.device) + 1,
                             torch.tensor(4, device=pos.device))
    rate = torch.tensor([f32(f32(lam) * (4.0 + float(i))) for i in
                         idx_bits.tolist()], dtype=torch.float32,
                        device=pos.device)
    cost = torch.where(ok, sse + rate[None], torch.full_like(sse, BIG))
    best = argmin_first(cost)
    bc = cost.gather(1, best[:, None])[:, 0]
    mv = cands.gather(1, best[:, None, None].expand(-1, 1, 2))[:, 0]
    mref = cref.gather(1, best[:, None])[:, 0]
    prd = pred[torch.arange(b, device=pos.device), best]
    return bc, mv, mref, prd


def frac_refine_plain(recon, of, pos, mvq0, pred0, sse0, preds, n, h,
                      bit_depth, lam):
    """Half- then quarter-pel refinement around the full-pel best:
    (mvq [B, 2], pred [B, n, n], sse [B], cost [B])."""
    b = pos.shape[0]
    offs = torch.as_tensor(FRAC_OFFS, device=pos.device)
    k = offs.shape[0]
    lam32 = f32(lam)
    rate0 = min_rate_bits(mvq0[:, None], preds)[:, 0]
    best_cost = quant.fma(rate0 + INTER_BITS, lam32, sse0)
    best_mv, best_pred, best_sse = mvq0, pred0, sse0
    posr = pos.repeat_interleave(k, 0)
    ar = torch.arange(b, device=pos.device)
    for step in (2, 1):
        cands = best_mv[:, None] + offs[None] * step
        pk = interp.luma_mc(recon, posr, cands.reshape(-1, 2), n, h,
                            bit_depth).reshape(b, k, n, n)
        sse = block_sum((of[:, None] - pk.to(torch.float32)) ** 2)
        cost = quant.fma(min_rate_bits(cands, preds) + INTER_BITS, lam32, sse)
        cost = torch.where(sse0[:, None] < 1e37, cost,
                           torch.full_like(cost, BIG))
        ci = argmin_first(cost)
        c_new = cost[ar, ci]
        upd = c_new < best_cost
        best_mv = torch.where(upd[:, None], cands[ar, ci], best_mv)
        best_pred = torch.where(upd[:, None, None], pk[ar, ci], best_pred)
        best_sse = torch.where(upd, sse[ar, ci], best_sse)
        best_cost = torch.minimum(best_cost, c_new)
    return best_mv, best_pred, best_sse, best_cost


def intra_cost(org, ipred, lam):
    """SSE of the intra prediction + float32(lam * INTRA_BITS)."""
    d = (org.to(torch.int32) - ipred).to(torch.float32)
    return block_sum(d * d) + f32(lam * INTRA_BITS)


def inter_arms_plain(recon, org_plane, pos, zcur, zmaxw, motion, nbav, miav,
                     mv_i, pred0, sse0, ipred, imode, n, w, h, bit_depth,
                     lam, mi_size, pss=None):
    """Plain version of :func:`inter_arms`; returns the same tuple."""
    ar = torch.arange(n, device=pos.device)
    org = org_plane[pos[:, 1, None, None].long() + ar[None, :, None],
                    pos[:, 0, None, None].long() + ar[None, None, :]]
    of = org.to(torch.float32)
    ss_idx = 0 if pss is None else SS_IDX_PSS
    cands, cref, cvalid, p_ss, p_t = gather_cands(*motion, pos, nbav, miav,
                                                  n, mi_size, ss_idx)
    mvq, sspred, _, sscost = frac_refine_plain(
        recon, of, pos, mv_i * 4, pred0, sse0, p_ss, n, h, bit_depth, lam)
    ref = None if pss is None else pss[0]
    mcost, mmv, mref, mpred = merge_arms_plain(
        recon, of, pos, zcur, zmaxw, cands, cvalid, n, w, h, bit_depth, lam,
        ref, cref, ss_idx)
    icost = intra_cost(org, ipred, lam)
    if pss is None:
        merge_win = (mcost < sscost) & (mcost < icost)
        inter = merge_win | (sscost < icost)
        mv = torch.where(merge_win[:, None], mmv, mvq)
        pred = torch.where(merge_win[:, None, None], mpred,
                           torch.where(inter[:, None, None], sspred, ipred))
        ipred.copy_(pred)
        smode = torch.where(inter, 0, imode).to(torch.int32)
        costs = torch.stack([icost, mcost, sscost], -1)
        return inter.to(torch.int32), mv.to(torch.int32), smode, costs
    _, mv_t, tpred0, tsse0 = pss
    mtq, tpred, _, tcost = frac_refine_plain(
        ref, of, pos, mv_t * 4, tpred0, tsse0, p_t, n, h, bit_depth, lam)
    ss_beats_t = sscost < tcost
    intercost = torch.minimum(sscost, tcost)
    merge_win = (mcost < intercost) & (mcost < icost)
    amvp_win = ~merge_win & (intercost < icost)
    inter = merge_win | amvp_win
    mv = torch.where(merge_win[:, None], mmv,
                     torch.where(ss_beats_t[:, None], mvq, mtq))
    refsel = torch.where(merge_win, mref,
                         torch.where(ss_beats_t, ss_idx, 0))
    apred = torch.where(ss_beats_t[:, None, None], sspred, tpred)
    pred = torch.where(merge_win[:, None, None], mpred,
                       torch.where(amvp_win[:, None, None], apred, ipred))
    ipred.copy_(pred)
    smode = torch.where(inter, 0, imode).to(torch.int32)
    costs = torch.stack([icost, mcost, sscost, tcost], -1)
    return (inter.to(torch.int32), mv.to(torch.int32), smode, costs,
            refsel.to(torch.int32))


def motion_write_plain(mvx4, mvy4, pi4, pos, inter, mv, n, rf4=None,
                       refsel=None):
    u = n // 4
    ar = torch.arange(u, device=pos.device)
    r4 = (pos[:, 1, None, None].long() // 4 + ar[None, :, None]).expand(
        -1, u, u)
    c4 = (pos[:, 0, None, None].long() // 4 + ar[None, None, :]).expand(
        -1, u, u)
    on = inter != 0
    bc = lambda v: v[:, None, None].expand(-1, u, u)
    mvx4[r4, c4] = bc(torch.where(on, mv[:, 0], 0).to(torch.int32))
    mvy4[r4, c4] = bc(torch.where(on, mv[:, 1], 0).to(torch.int32))
    pi4[r4, c4] = bc(on.to(torch.int32))
    if refsel is not None:
        rf4[r4, c4] = bc(torch.where(on, refsel, 0).to(torch.int32))


# ---------------------------------------------------------------------------
# Kernel C10.
# ---------------------------------------------------------------------------

def _check(t, dtype, name):
    if not (t.is_cuda and t.dtype == dtype and t.is_contiguous()):
        raise ValueError(f"inter_arms: {name} must be a contiguous CUDA "
                         f"{dtype} tensor")


def _check_plane(t, name):
    if not (t.is_cuda and t.dtype == torch.int32 and t.stride(-1) == 1):
        raise ValueError(f"inter_arms: {name} must be a CUDA int32 plane "
                         "with dense rows")


def inter_arms(recon, org_plane, pos, zcur, zmaxw, motion, nbav, miav, mv_i,
               pred0, sse0, ipred, imode, n, w, h, bit_depth, lam, mi_size,
               pss=None):
    """Kernel C10 over B blocks of size n (one wavefront level).

    recon/org_plane [H(+pad), W] int32; pos, zcur, zmaxw, motion = (mvx4,
    mvy4, pi4, rf4), nbav, miav as for :func:`ss_search`; mv_i [B, 2]
    full-pel, pred0 [B, n, n] and sse0 [B] from kernel C9; ipred
    [B, n, n] int32 the intra prediction (kernel C2) with its modes imode
    [B]. Overwrites ipred with the chosen prediction and returns (inter
    [B] int32, mv [B, 2] quarter-pel, smode [B] the mode of kernel C3's
    scan choice, costs [B, 3] float32 (intra, merge, SS)).

    On a PSS picture pss = (ref [h, W] int32, the previous picture; mv_t
    [B, 2], tpred0 [B, n, n], tsse0 [B]: C9's temporal search): costs are
    [B, 4] (intra, merge, SS, temporal), and a fifth result, refsel [B]
    int32, is each block's reference index (0 temporal, 1 SS).
    """
    if not recon.is_cuda:
        return inter_arms_plain(recon, org_plane, pos, zcur, zmaxw, motion,
                                nbav, miav, mv_i, pred0, sse0, ipred, imode,
                                n, w, h, bit_depth, lam, mi_size, pss)
    return _inter_arms_cuda(recon, org_plane, pos, zcur, zmaxw, motion, nbav,
                            miav, mv_i, pred0, sse0, ipred, imode, n, w, h,
                            bit_depth, lam, mi_size, pss)


def _inter_arms_cuda(recon, org_plane, pos, zcur, zmaxw, motion, nbav, miav,
                     mv_i, pred0, sse0, ipred, imode, n, w, h, bit_depth, lam,
                     mi_size, pss):
    global LAUNCHES, PSS_LAUNCHES
    b = pos.shape[0]
    planes = (recon, org_plane) + (() if pss is None else (pss[0],))
    for t in planes:
        _check_plane(t, "recon, org_plane and ref")
        if t.stride(0) != org_plane.stride(0):
            raise ValueError("inter_arms: recon, ref and org_plane share "
                             "one stride")
    tsearch = () if pss is None else pss[1:]
    for t, nm in ((pos, "pos"), (zcur, "zcur"), (zmaxw, "zmaxw"),
                  (mv_i, "mv_i"), (pred0, "pred0"), (ipred, "ipred"),
                  (imode, "imode"), *((m, "motion") for m in motion),
                  *((t, "mv_t/tpred0") for t in tsearch[:2])):
        _check(t, torch.int32, nm)
    for t in (sse0,) + tsearch[2:]:
        _check(t, torch.float32, "sse0/tsse0")
    _check(nbav, torch.bool, "nbav")
    _check(miav, torch.bool, "miav")
    dev = recon.device
    inter = torch.empty(b, dtype=torch.int32, device=dev)
    mv = torch.empty((b, 2), dtype=torch.int32, device=dev)
    smode = torch.empty(b, dtype=torch.int32, device=dev)
    costs = torch.empty((b, 3 if pss is None else 4), dtype=torch.float32,
                        device=dev)
    out = (inter, mv, smode, costs)
    refsel = None
    if pss is not None:
        refsel = torch.empty(b, dtype=torch.int32, device=dev)
        out = out + (refsel,)
    if b == 0:
        return out
    mvx4, mvy4, pi4, rf4 = motion
    lam32 = f32(lam)
    mrates = [f32(lam32 * (4.0 + min(i + 1, 4))) for i in range(9)]
    ptr = lambda t: None if t is None else t.data_ptr()
    ref, mv_t, tpred0, tsse0 = pss or (None,) * 4
    fn = _cuda.bind("inter_arms", "hh_inter_arms",
                    "ppi" "ppp" "pppp" "ii" "pp" "pppp" "p"
                    "iiiiii" "ff" "fffffffff" "pppp" "ppppp" "p")
    err = fn(recon.data_ptr(), org_plane.data_ptr(), recon.stride(0),
             pos.data_ptr(), zcur.data_ptr(), zmaxw.data_ptr(),
             mvx4.data_ptr(), mvy4.data_ptr(), pi4.data_ptr(),
             rf4.data_ptr(), pi4.shape[0], pi4.shape[1],
             nbav.data_ptr(), miav.data_ptr(),
             mv_i.data_ptr(), pred0.data_ptr(), sse0.data_ptr(),
             ipred.data_ptr(), imode.data_ptr(),
             b, n, w, h, bit_depth, mi_size,
             lam32, f32(lam * INTRA_BITS), *mrates,
             inter.data_ptr(), mv.data_ptr(), smode.data_ptr(),
             costs.data_ptr(), ptr(ref), ptr(mv_t), ptr(tpred0), ptr(tsse0),
             ptr(refsel), _cuda.stream(recon))
    _cuda.check("inter_arms", err)
    LAUNCHES += 1
    if pss is not None:
        PSS_LAUNCHES += 1
    return out


def motion_write(mvx4, mvy4, pi4, pos, inter, mv, n, rf4=None, refsel=None):
    """Kernel C10, motion entry: each block's inter flag and MV (zero for
    an intra block) into its 4x4 cells of the carried planes; with refsel
    [B] int32 (a PSS picture) also its reference index into rf4."""
    if not pos.is_cuda:
        return motion_write_plain(mvx4, mvy4, pi4, pos, inter, mv, n, rf4,
                                  refsel)
    return _motion_write_cuda(mvx4, mvy4, pi4, pos, inter, mv, n, rf4,
                              refsel)


def _motion_write_cuda(mvx4, mvy4, pi4, pos, inter, mv, n, rf4, refsel):
    global MOTION_LAUNCHES, PSS_MOTION_LAUNCHES
    for t, nm in ((mvx4, "mvx4"), (mvy4, "mvy4"), (pi4, "pi4"),
                  (pos, "pos"), (inter, "inter"), (mv, "mv"),
                  *(() if refsel is None else ((rf4, "rf4"),
                                               (refsel, "refsel")))):
        _check(t, torch.int32, nm)
    b = pos.shape[0]
    if b == 0:
        return None
    ptr = lambda t: None if t is None else t.data_ptr()
    fn = _cuda.bind("inter_arms", "hh_motion_write",
                    "pppi" "ppp" "ii" "pp" "p")
    err = fn(mvx4.data_ptr(), mvy4.data_ptr(), pi4.data_ptr(),
             pi4.shape[1], pos.data_ptr(), inter.data_ptr(), mv.data_ptr(),
             b, n, ptr(None if refsel is None else rf4), ptr(refsel),
             _cuda.stream(pos))
    _cuda.check("inter_arms", err)
    MOTION_LAUNCHES += 1
    if refsel is not None:
        PSS_MOTION_LAUNCHES += 1
    return None
