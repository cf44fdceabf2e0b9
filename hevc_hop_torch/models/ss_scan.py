"""ISS and PSS wavefront scans: joint intra / self-similarity / temporal
encode and decode.

Counterpart of hevc_hop_tpu/models/ss_scan.py for ISS and PSS slices, with
and without the GT warp. The schedule is the reference's
(:func:`build_schedule_ss`,
numpy, copied): topological levels of CUs such that every z-earlier block
within the search reach sits at an earlier level (encoder), or such that
every block that the coded MV reads sits at an earlier level (decoder).
The reference runs the levels as one ``lax.scan``; here a Python loop
launches, per level and CU size:

- encode: C2 (intra prediction: the pre-pass's mode, or 35-mode RMD), C9
  (full search, with the GT anchor ring when the GT is on, and on a PSS
  picture the temporal search in the same launch), C10 (merge arms,
  sub-pel refinement, tournament), C12 (GT corner search and decision, GT
  on), C3 (transform, RDOQ or the dead-zone quantizer, SBH, recon) and
  C10's motion entry for luma; then C2 (chroma DM), C8 (chroma MC over the
  inter blocks: from the recon for SS blocks, and on a PSS picture from
  the previous picture for temporal ones), C11 (GT chroma over the GT
  blocks) and C3 for the stacked cb/cr plane;
- decode: C2 with its add-residual epilogue for the intra blocks and C8
  with its own for the inter blocks (on a PSS picture the temporal ones
  read the previous picture and write the recon), then C11's over the GT
  blocks among them, luma then the stacked chroma plane.

On the CPU the same loop runs the kernels' plain versions. Only the real
slots of a level are launched (see models/wavefront_scan.py
``pack_schedule``). The stacked chroma plane keeps the reference's layout:
cb rows [0, h/2), cr rows [hc_off, hc_off + h/2).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from numpy.lib.stride_tricks import sliding_window_view

from hevc_hop_torch.models import wavefront
from hevc_hop_torch.models.partition import full_lambda
from hevc_hop_torch.ops.gt import gt_step
from hevc_hop_torch.ops.inter_arms import inter_arms, motion_write
from hevc_hop_torch.ops.interp import mc_blocks
from hevc_hop_torch.ops.intra import intra_blocks
from hevc_hop_torch.ops.ss_search import IFM, pss_search, ss_search
from hevc_hop_torch.ops.tq import tq_encode
from hevc_hop_torch.ops.warp import gt_pred_blocks


def zmax_win_px(zaddr4: np.ndarray, n: int, ifm: int = IFM) -> np.ndarray:
    """Max z-address over every (n+2*ifm)-window, edge-extended, indexed by
    the n-block target top-left (y, x) in [0, H-n] x [0, W-n]; the ifm ring
    models the interpolation filter's margin."""
    zp = np.repeat(np.repeat(zaddr4, 4, 0), 4, 1)
    zp = np.pad(zp, ifm, mode="edge")
    k = n + 2 * ifm
    zr = sliding_window_view(zp, k, axis=1).max(-1)
    return np.ascontiguousarray(
        sliding_window_view(zr, k, axis=0).max(-1)).astype(np.int32)


@functools.lru_cache(maxsize=32)
def _zmax_planes(w: int, h: int, ctb_log2: int, n: int, ifm: int,
                 device: str):
    return torch.as_tensor(zmax_win_px(wavefront.zaddr4_plane(w, h,
                                                               ctb_log2), n,
                                       ifm), device=device)


def zmax_plane(w: int, h: int, ctb_log2: int, n: int, device,
               ifm: int = IFM) -> torch.Tensor:
    """:func:`zmax_win_px` of the picture's z-address plane for n-blocks
    (the MC window's plane; with n = 2 x the CU size and ifm = 2, the GT
    window's, zmax2n), int32 on ``device``; a function of the geometry
    alone, so built once per geometry and device (the host's sliding
    maxima over a 1920x1088 picture take tenths of a second)."""
    return _zmax_planes(w, h, ctb_log2, n, ifm, str(torch.device(device)))


def build_schedule_ss(blocks, w: int, h: int, ctb_log2: int, radius: int,
                      mv_rect: np.ndarray | None = None,
                      pad_steps: int = 32, pad_slots: int = 4):
    """Schedule of an ISS encode (radius > 0) or an MV-aware decode
    (mv_rect given, radius == 0): (sizes, data, nsteps), data[log2] with
    pos/valid/avail/availc as build_schedule plus zcur [S, B] int32 (-1 for
    padding dummies), src and nbav [S, B, 5] (static z-availability of the
    A1, B1, B0, A0, B2 neighbours)."""
    from hevc_hop_torch.entropy import native as _native
    arr = np.array(blocks, np.int32)
    levels = _native.wavefront_levels(
        arr[:, 0], arr[:, 1], arr[:, 2], w, h, ctb_log2,
        ss_range=(radius + IFM) if radius > 0 else 0, mv_rect=mv_rect)
    nsteps = int(levels.max()) if len(levels) else 0
    if pad_steps > 1:
        nsteps = max(pad_steps, -(-nsteps // pad_steps) * pad_steps)
    zplane = wavefront.zaddr4_plane(w, h, ctb_log2)
    czplane = zplane[::2, ::2]
    sizes = tuple(sorted({int(l) for l in arr[:, 2]}))
    data = {}
    for log2 in sizes:
        n = 1 << log2
        sel = arr[:, 2] == log2
        lv = levels[sel] - 1
        pts = arr[sel][:, :2]
        idx_orig = np.nonzero(sel)[0]
        counts = np.bincount(lv, minlength=nsteps)
        bmax = max(1, int(counts.max()))
        slot_q = max(2, pad_slots >> max(log2 - 3, 0))
        if pad_slots > 1:
            bmax = max(slot_q, -(-bmax // slot_q) * slot_q)
        pos = np.zeros((nsteps, bmax, 2), np.int32)
        pos[:, :, 1] = h
        valid = np.zeros((nsteps, bmax), bool)
        src = np.full((nsteps, bmax), -1, np.int64)
        slot = np.zeros(nsteps, np.int32)
        for j in np.argsort(lv, kind="stable"):
            s = lv[j]
            pos[s, slot[s]] = pts[j]
            valid[s, slot[s]] = True
            src[s, slot[s]] = idx_orig[j]
            slot[s] += 1
        flat = pos.reshape(-1, 2)
        vmf = valid.reshape(-1)
        fv = flat[vmf]
        avail = np.zeros((flat.shape[0], 4 * n + 1), bool)
        avail[vmf] = wavefront.avail_mask(fv, n, zplane, w, h)
        availc = np.zeros((flat.shape[0], 2 * n + 1), bool)
        availc[vmf] = wavefront.avail_mask(fv // 2, n // 2, czplane,
                                           w // 2, h // 2)
        zcur = zplane[np.clip(pos[:, :, 1], 0, h - 1) >> 2,
                      np.clip(pos[:, :, 0], 0, w - 1) >> 2]
        zcur = np.where(valid, zcur, -1).astype(np.int32)
        px_, py_ = pos[:, :, 0], pos[:, :, 1]
        nbx = np.stack([px_ - 1, px_ + n - 1, px_ + n, px_ - 1, px_ - 1], -1)
        nby = np.stack([py_ + n - 1, py_ - 1, py_ - 1, py_ + n, py_ - 1], -1)
        inf = (nbx >= 0) & (nby >= 0) & (nbx < w) & (nby < h)
        znb = zplane[np.clip(nby, 0, h - 1) >> 2, np.clip(nbx, 0, w - 1) >> 2]
        nbav = inf & (znb < zcur[..., None]) & valid[..., None]
        data[log2] = dict(
            pos=pos, valid=valid, zcur=zcur, src=src, nbav=nbav,
            avail=avail.reshape(nsteps, bmax, 4 * n + 1),
            availc=availc.reshape(nsteps, bmax, 2 * n + 1))
    return sizes, data, nsteps


@dataclasses.dataclass
class SSPlan:
    """The real blocks of one CU size, packed in level order, each level's
    first ``cnt_a`` blocks one group (the decoder's intra blocks) and the
    rest the other.

    Luma block j of level s is row off[s] + j of the per-block arrays. Its
    chroma rows in cpos: a level's slice cpos[2 off[s] : 2 off[s] +
    2 cnt[s]] holds the cb then the cr blocks of the first group, then those
    of the second (stacked-plane coordinates).
    """
    n: int
    cnt: np.ndarray
    cnt_a: np.ndarray
    off: np.ndarray
    pos: torch.Tensor      # [T, 2] int32
    avail: torch.Tensor    # [T, 4n+1] bool
    cpos: torch.Tensor     # [2T, 2] int32
    cavail: torch.Tensor   # [T, n+1] bool
    zcur: torch.Tensor     # [T] int32
    nbav: torch.Tensor     # [T, 5] bool
    miav: torch.Tensor     # [T, 3] bool
    vpos: np.ndarray       # [T, 2] host copy of pos


def pack_ss(sizes, data, hc_off: int, device, miav: dict | None,
            second=None) -> dict:
    """Real slots of :func:`build_schedule_ss`'s output packed per size
    into :class:`SSPlan`. miav[log2] [S, B, 3] bool (None: none);
    ``second(log2, pos)`` [T] bool marks the blocks that go after the
    others of their level (None: one group)."""
    plans = {}
    for log2 in sizes:
        d = data[log2]
        valid = d["valid"]
        lvl = np.nonzero(valid)[0]
        pos = d["pos"][valid]
        g = (np.zeros(len(pos), bool) if second is None
             else np.asarray(second(log2, pos), bool))
        order = np.lexsort((g, lvl))
        lvl, pos, g = lvl[order], pos[order], g[order]
        pick = lambda a: a[valid][order]
        mi = (np.zeros(valid.shape + (3,), bool) if miav is None
              else miav[log2])
        nst = valid.shape[0]
        cnt = np.bincount(lvl, minlength=nst).astype(np.int64)
        cnt_a = np.bincount(lvl[~g], minlength=nst).astype(np.int64)
        off = np.concatenate([[0], np.cumsum(cnt)[:-1]]).astype(np.int64)
        r = np.arange(len(pos)) - off[lvl]
        ca, cb_n = cnt_a[lvl], cnt[lvl] - cnt_a[lvl]
        cbr = np.where(g, 2 * off[lvl] + 2 * ca + (r - ca), 2 * off[lvl] + r)
        crr = cbr + np.where(g, cb_n, ca)
        cpos = np.zeros((2 * len(pos), 2), np.int32)
        cpos[cbr] = pos // 2
        cpos[crr] = pos // 2 + np.array([0, hc_off], np.int32)
        t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                          device=device)
        plans[log2] = SSPlan(
            n=1 << log2, cnt=cnt, cnt_a=cnt_a, off=off,
            pos=t(pos, torch.int32), avail=t(pick(d["avail"]), torch.bool),
            cpos=t(cpos, torch.int32),
            cavail=t(pick(d["availc"]), torch.bool),
            zcur=t(pick(d["zcur"]), torch.int32),
            nbav=t(pick(d["nbav"]), torch.bool),
            miav=t(pick(mi), torch.bool), vpos=pos)
    return plans


def scan_encode_iss(org_y, org_c, plans: dict, nsteps: int, zmaxw: dict,
                    qp: int, qp_c: int, bit_depth: int, strong: bool,
                    w: int, h: int, radius: int, mi_size: int = 0,
                    use_rdoq: bool = False, sbh: bool = False, modes=None,
                    zmax2n: dict | None = None):
    """ISS encode of every CU, level by level.

    org_y [h+pad, w] and org_c (stacked cb/cr) int32 on the target device;
    zmaxw[log2] the causality plane of each size; ``modes`` None for
    in-loop RMD, else modes[log2] [T] the pre-pass's intra modes in the
    packed order; zmax2n None for the GT off, else zmax2n[log2] the GT
    window's causality plane of each size. Returns (ry, rc, coef_y, coef_c,
    outs) with outs[log2] = (inter [T], mv [T, 2] quarter-pel, imode [T],
    cbf_y [T], cbf_cb [T], cbf_cr [T], gtflag [T], gtc [T, 6]) in the
    packed order of ``plans`` (gtflag 0 and gtc 0 with the GT off).
    """
    return _scan_encode(org_y, org_c, plans, nsteps, zmaxw, qp, qp_c,
                        bit_depth, strong, w, h, radius, mi_size, use_rdoq,
                        sbh, modes, zmax2n)


def scan_encode_pss(org_y, org_c, ref_y, ref_c, plans: dict, nsteps: int,
                    zmaxw: dict, qp: int, qp_c: int, bit_depth: int,
                    strong: bool, w: int, h: int, radius: int,
                    radius_t: int, mi_size: int = 0, use_rdoq: bool = False,
                    sbh: bool = False, modes=None,
                    zmax2n: dict | None = None):
    """PSS encode of every CU, level by level: L0 = [the previous picture,
    the SS reference (the recon carry), last]. As :func:`scan_encode_iss`,
    with ref_y [h, w] and ref_c (stacked cb/cr, org_c's layout) int32 the
    previous picture's filtered recon, searched with radius ``radius_t``.
    outs[log2] = (inter, refsel [T] (0 temporal, 1 SS), mv, imode, cbf_y,
    cbf_cb, cbf_cr, gtflag, gtc)."""
    return _scan_encode(org_y, org_c, plans, nsteps, zmaxw, qp, qp_c,
                        bit_depth, strong, w, h, radius, mi_size, use_rdoq,
                        sbh, modes, zmax2n, (ref_y, ref_c), radius_t)


def _scan_encode(org_y, org_c, plans, nsteps, zmaxw, qp, qp_c, bit_depth,
                 strong, w, h, radius, mi_size, use_rdoq, sbh, modes, zmax2n,
                 ref=None, radius_t=0):
    dev = org_y.device
    lam = full_lambda(qp)
    init_type = 3 if ref is None else 4               # ISS, PSS
    rcfg_y = (init_type, lam) if use_rdoq else None
    rcfg_c = ((init_type, lam * 2.0 ** ((qp_c - qp) / 3.0)) if use_rdoq
              else None)
    hc = h // 2
    hc_off = (org_c.shape[0]) // 2
    ry = torch.zeros_like(org_y)
    rc = torch.zeros_like(org_c)
    coef_y = torch.zeros(org_y.shape, dtype=torch.int16, device=dev)
    coef_c = torch.zeros(org_c.shape, dtype=torch.int16, device=dev)
    shape4 = (org_y.shape[0] // 4, w // 4)
    motion = tuple(torch.zeros(shape4, dtype=torch.int32, device=dev)
                   for _ in range(4))
    widest = max((int(p.cnt.max(initial=0)) for p in plans.values()),
                 default=0)
    rmd = torch.full((max(widest, 1),), -1, dtype=torch.int32, device=dev)
    names = ("inter", "refsel", "mv", "imode", "cbf", "cbf_c", "gtflag",
             "gtc")
    acc = {log2: {k: [] for k in names} for log2 in plans}
    for s in range(nsteps):
        for log2, p in plans.items():
            c = int(p.cnt[s])
            if c == 0:
                continue
            o, n, m = int(p.off[s]), p.n, p.n // 2
            sl = slice(o, o + c)
            pos, zcur = p.pos[sl], p.zcur[sl]
            if modes is None:
                ipred, imode = intra_blocks(ry, pos, p.avail[sl], rmd[:c], n,
                                            0, bit_depth, strong, org=org_y)
            else:
                imode = modes[log2][sl]
                ipred, _ = intra_blocks(ry, pos, p.avail[sl], imode, n, 0,
                                        bit_depth, strong)
            z2 = None if zmax2n is None else zmax2n[log2]
            sargs = (ry, org_y, pos, zcur, zmaxw[log2], motion, p.nbav[sl],
                     p.miav[sl], n, radius, w, h, lam, mi_size, z2)
            aargs = (ry, org_y, pos, zcur, zmaxw[log2], motion, p.nbav[sl],
                     p.miav[sl])
            tail = (n, w, h, bit_depth, lam, mi_size)
            if ref is None:
                mv_i, _, pred0, sse0, *ring = ss_search(*sargs)
                inter, mv, smode, costs = inter_arms(
                    *aargs, mv_i, pred0, sse0, ipred, imode, *tail)
                refsel = None
            else:
                (mv_i, _, pred0, sse0, *ring), (mv_t, _, tpred0, tsse0) = \
                    pss_search(*sargs, ref[0], radius_t)
                inter, mv, smode, costs, refsel = inter_arms(
                    *aargs, mv_i, pred0, sse0, ipred, imode, *tail,
                    pss=(ref[0], mv_t, tpred0, tsse0))
            if z2 is None:
                gtflag = torch.zeros_like(inter)
                gtc = torch.zeros((c, 6), dtype=torch.int32, device=dev)
            else:
                # GT overrides C10's choice where it wins, in place
                gtflag, gtc = gt_step(
                    ry, org_y, rc, pos, zcur, z2, motion, p.nbav[sl],
                    p.miav[sl], ring, costs, ipred, inter, mv, smode, n, w,
                    h, hc_off, bit_depth, lam, mi_size, refsel)
            cbf = tq_encode(org_y, ipred, pos, smode, n, 0, qp, bit_depth,
                            sbh, rcfg_y, ry, coef_y)
            motion_write(*motion[:3], pos, inter, mv, n, motion[3], refsel)
            cpos = p.cpos[2 * o:2 * o + 2 * c]
            cpred, _ = intra_blocks(rc, cpos, p.cavail[sl], imode, m, 1,
                                    bit_depth, strong)
            if ref is None:
                mc_blocks(rc, cpos, mv, m, True, hc, bit_depth, hc_off,
                          out=cpred, only=inter)
            else:
                # SS blocks (GT ones too) read the recon, temporal ones the
                # previous picture
                use_ss = inter * refsel
                mc_blocks(rc, cpos, mv, m, True, hc, bit_depth, hc_off,
                          out=cpred, only=use_ss)
                mc_blocks(ref[1], cpos, mv, m, True, hc, bit_depth, hc_off,
                          out=cpred, only=inter - use_ss)
            if z2 is not None:
                gt_pred_blocks(rc, cpos, mv, gtc, m, True, hc, bit_depth,
                               hc_off, out=cpred, only=gtflag)
            cbf_c = tq_encode(org_c, cpred, cpos, smode, m, 1, qp_c,
                              bit_depth, sbh, rcfg_c, rc, coef_c)
            for k, v in zip(names, (inter, refsel, mv, imode, cbf, cbf_c,
                                    gtflag, gtc)):
                if v is not None:
                    acc[log2][k].append(v)
    outs = {}
    for log2, lists in acc.items():
        cat = {k: torch.cat(v) for k, v in lists.items() if v}
        cb_rows, cr_rows = _chroma_rows(plans[log2])
        cbf_c = cat["cbf_c"]
        outs[log2] = ((cat["inter"],)
                      + (() if ref is None else (cat["refsel"],))
                      + (cat["mv"], cat["imode"], cat["cbf"],
                         cbf_c[cb_rows], cbf_c[cr_rows], cat["gtflag"],
                         cat["gtc"]))
    return ry, rc, coef_y, coef_c, outs


def _chroma_rows(p: SSPlan):
    """(cb rows, cr rows) [T] of each packed block in the concatenation of
    the levels' chroma outputs (one group per level)."""
    lvl = np.repeat(np.arange(len(p.cnt)), p.cnt)
    r = np.arange(int(p.cnt.sum())) - p.off[lvl]
    cb = 2 * p.off[lvl] + r
    return (torch.as_tensor(cb, device=p.pos.device),
            torch.as_tensor(cb + p.cnt[lvl], device=p.pos.device))


def scan_decode_ss(resi_y, resi_c, plans: dict, nsteps: int, modes: dict,
                   cmodes: dict, mvs: dict, bit_depth: int, strong: bool,
                   h: int, gt: dict | None = None):
    """ISS decode of every CU, level by level: each level's intra blocks
    (the first group of the plans) through C2's add-residual epilogue, its
    inter blocks through C8's and, among them, the GT blocks through
    C11's, luma then the stacked chroma plane. modes/cmodes[log2] [T]
    int32 and mvs[log2] [T, 2] quarter-pel, in the packed order of
    ``plans``; gt None (no GT block) or gt[log2] = (gtf [T] int32, gtv
    [T, 6] int32, the GT flag and coded corners in the same order, and
    levels [nsteps] bool, the levels that hold a GT block). Returns (ry,
    rc)."""
    return _scan_decode(resi_y, resi_c, plans, nsteps, modes, cmodes, mvs,
                        bit_depth, strong, h, gt)


def scan_decode_pss(resi_y, resi_c, ref_y, ref_c, plans: dict, nsteps: int,
                    modes: dict, cmodes: dict, mvs: dict, tf: dict,
                    bit_depth: int, strong: bool, h: int,
                    gt: dict | None = None):
    """PSS decode of every CU, level by level, as :func:`scan_decode_ss`;
    the temporal blocks (tf[log2] = (tflag [T] int32, 1 where the inter
    block reads the previous picture, and its complement ssf [T] int32, 1
    where it reads the recon, and their levels [nsteps] bool each)) read
    ref_y [h, w] and ref_c (the stacked layout of resi_c), the previous
    picture, through C8 and write the recon. Returns (ry, rc)."""
    return _scan_decode(resi_y, resi_c, plans, nsteps, modes, cmodes, mvs,
                        bit_depth, strong, h, gt, (ref_y, ref_c), tf)


def _scan_decode(resi_y, resi_c, plans, nsteps, modes, cmodes, mvs,
                 bit_depth, strong, h, gt, ref=None, tf=None):
    ry = torch.zeros_like(resi_y)
    rc = torch.zeros_like(resi_c)
    hc_off = resi_c.shape[0] // 2
    for s in range(nsteps):
        for log2, p in plans.items():
            c = int(p.cnt[s])
            if c == 0:
                continue
            o, ca, n = int(p.off[s]), int(p.cnt_a[s]), p.n
            co = 2 * o
            if ca:
                a = slice(o, o + ca)
                intra_blocks(ry, p.pos[a], p.avail[a], modes[log2][a], n, 0,
                             bit_depth, strong, resi=resi_y)
                intra_blocks(rc, p.cpos[co:co + 2 * ca], p.cavail[a],
                             cmodes[log2][a], n // 2, 1, bit_depth, strong,
                             resi=resi_c)
            if ca < c:
                b = slice(o + ca, o + c)
                cb = p.cpos[co + 2 * ca:co + 2 * c]
                # (source planes, the blocks that read them or None: all)
                srcs = [(ry, rc, None)]
                if ref is not None:
                    tflag, ssf, t_lv, ss_lv = tf[log2]
                    srcs = ([(ry, rc, ssf[b])] if ss_lv[s] else []) + (
                        [(ref[0], ref[1], tflag[b])] if t_lv[s] else [])
                for sy, sc, only in srcs:
                    mc_blocks(sy, p.pos[b], mvs[log2][b], n, False, h,
                              bit_depth, resi=resi_y, only=only, dst=ry)
                    mc_blocks(sc, cb, mvs[log2][b], n // 2, True, h // 2,
                              bit_depth, hc_off, resi=resi_c, only=only,
                              dst=rc)
                if gt is not None and gt[log2][2][s]:
                    gtf, gtv = gt[log2][0][b], gt[log2][1][b]
                    gt_pred_blocks(ry, p.pos[b], mvs[log2][b], gtv, n, False,
                                   h, bit_depth, resi=resi_y, only=gtf)
                    gt_pred_blocks(rc, cb, mvs[log2][b], gtv, n // 2, True,
                                   h // 2, bit_depth, hc_off, resi=resi_c,
                                   only=gtf)
    return ry, rc
