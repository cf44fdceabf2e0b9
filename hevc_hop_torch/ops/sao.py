"""Sample adaptive offset: per-CTU statistics, host RDO, apply; kernel C6.

Counterpart of hevc_hop_tpu/ops/sao.py. The statistics (the encoder's
per-CTU EO/BO counts and difference sums) and the apply (the per-sample
offset, normative) are the two entries of kernel C6 (``csrc/sao.cu``). Each
takes a picture's three planes in one launch, a CTA per CTU position:
:func:`stats_dispatch` writes one [ncty, nctx, 3, 96] buffer, which
:func:`fetch_stats` copies to the host at once (or a caller copies without
waiting and reads with :func:`host_stats`), and :func:`apply_sao_frame`
uploads the decided parameters as one packed tensor. :func:`sao_stats_plane`
and :func:`apply_sao_plane` are the one-plane forms of the same launches.
On a CUDA tensor each launches its kernel; on a CPU tensor it runs its
``*_plain`` version, which runs on any device. All device arithmetic is
int32 and exact: the statistics are integer sums, which do not depend on
the order of summation.

The per-CTU rate-distortion decision (:func:`choose_sao_params` and its
helpers) is the reference's float64 numpy code, copied: it runs on the host
over a few thousand CTUs.

Edge classification only knows the picture's borders (not the CTU's nor the
slice's): a sample whose neighbour lies outside the picture has category 0.
Chroma planes run at ``ctb_log2 - 1``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from hevc_hop_torch import _cuda

# one count per kernel of csrc/sao.cu
STATS_LAUNCHES = 0
APPLY_LAUNCHES = 0

# EO neighbor pairs per class (dy, dx): 0=hor, 1=ver, 2=135deg, 3=45deg
EO_NEIGHBORS = (((0, -1), (0, 1)),
                ((-1, 0), (1, 0)),
                ((-1, -1), (1, 1)),
                ((-1, 1), (1, -1)))
# edgeIdx lut: signs sum +2 -> category
EO_LUT = (1, 2, 0, 3, 4)


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------

def _shifted(p: torch.Tensor, dy: int, dx: int):
    """Neighbor plane + validity mask (picture-boundary pixels invalid)."""
    h, w = p.shape
    n = torch.roll(p, (-dy, -dx), (0, 1))
    vy = torch.ones(h, dtype=torch.bool, device=p.device)
    if dy < 0:
        vy[:-dy] = False
    elif dy > 0:
        vy[h - dy:] = False
    vx = torch.ones(w, dtype=torch.bool, device=p.device)
    if dx < 0:
        vx[:-dx] = False
    elif dx > 0:
        vx[w - dx:] = False
    return n, vy[:, None] & vx[None, :]


def _eo_cat(p: torch.Tensor, cls: int):
    """Per-pixel EO category (0..4) + validity for one class."""
    (dy0, dx0), (dy1, dx1) = EO_NEIGHBORS[cls]
    n0, v0 = _shifted(p, dy0, dx0)
    n1, v1 = _shifted(p, dy1, dx1)
    s = torch.sign(p - n0) + torch.sign(p - n1)
    lut = torch.as_tensor(EO_LUT, dtype=torch.int32, device=p.device)
    return lut[(s + 2).long()], v0 & v1


def apply_sao_plane_plain(pre, type_map, offs, band, ctb_log2: int,
                          bit_depth: int = 8):
    """Plain version of :func:`apply_sao_plane`."""
    h, w = pre.shape
    dev = pre.device
    p = pre
    cyi = (torch.arange(h, device=dev) >> ctb_log2)[:, None]
    cxi = (torch.arange(w, device=dev) >> ctb_log2)[None, :]
    t = type_map[cyi, cxi]
    o = offs[cyi, cxi]                    # [H, W, 4]
    bpos = band[cyi, cxi]
    zero = torch.zeros((), dtype=torch.int32, device=dev)

    # BO: band = p >> (bd - 5); 4 consecutive bands from band position
    bidx = p >> (bit_depth - 5)
    rel = (bidx - bpos) & 31
    bo = torch.where(rel < 4, torch.gather(
        o, -1, rel.clamp(0, 3)[..., None].long())[..., 0], zero)
    out = torch.where(t == 1, bo, zero)

    for cls in range(4):
        cat, valid = _eo_cat(p, cls)
        eo = torch.where((cat > 0) & valid, torch.gather(
            o, -1, (cat - 1).clamp(0, 3)[..., None].long())[..., 0], zero)
        out = torch.where(t == 2 + cls, eo, out)
    return torch.clamp(p + out, 0, (1 << bit_depth) - 1)


def _tile_sums(x: torch.Tensor, ctb_log2: int) -> torch.Tensor:
    h, w = x.shape
    c = 1 << ctb_log2
    return x.reshape(h // c, c, w // c, c).sum((1, 3), dtype=torch.int32)


def sao_stats_plane_plain(org, pre, ctb_log2: int, bit_depth: int = 8):
    """Plain version of :func:`sao_stats_plane`."""
    diff = (org - pre).to(torch.int32)
    eo_cnt, eo_sum = [], []
    for cls in range(4):
        cat, valid = _eo_cat(pre, cls)
        cnts, sums = [], []
        for k in range(1, 5):
            m = ((cat == k) & valid).to(torch.int32)
            cnts.append(_tile_sums(m, ctb_log2))
            sums.append(_tile_sums(m * diff, ctb_log2))
        eo_cnt.append(torch.stack(cnts, -1))
        eo_sum.append(torch.stack(sums, -1))
    bidx = pre >> (bit_depth - 5)
    bo_cnt, bo_sum = [], []
    for b in range(32):
        m = (bidx == b).to(torch.int32)
        bo_cnt.append(_tile_sums(m, ctb_log2))
        bo_sum.append(_tile_sums(m * diff, ctb_log2))
    return (torch.stack(eo_cnt, -2), torch.stack(eo_sum, -2),
            torch.stack(bo_cnt, -1), torch.stack(bo_sum, -1))


# ---------------------------------------------------------------------------
# Kernel C6.
# ---------------------------------------------------------------------------

def _pack_stats(stats) -> torch.Tensor:
    """One plane's (eo_cnt, eo_sum, bo_cnt, bo_sum) as [ncty, nctx, 96]."""
    eo_cnt, eo_sum, bo_cnt, bo_sum = stats
    ncty, nctx = bo_cnt.shape[:2]
    return torch.cat([eo_cnt.reshape(ncty, nctx, 16),
                      eo_sum.reshape(ncty, nctx, 16), bo_cnt, bo_sum], -1)


def _unpack_stats(packed):
    """(eo_cnt [ncty, nctx, 4, 4], eo_sum, bo_cnt [ncty, nctx, 32], bo_sum)
    of one plane's [ncty, nctx, 96] counters (views of a torch tensor)."""
    ncty, nctx = packed.shape[:2]
    return (packed[..., 0:16].reshape(ncty, nctx, 4, 4),
            packed[..., 16:32].reshape(ncty, nctx, 4, 4),
            packed[..., 32:64], packed[..., 64:96])


def sao_stats_frame_plain(org_yuv, rec_yuv, ctb_log2: int,
                          bit_depth: int = 8) -> torch.Tensor:
    """Plain version of :func:`stats_dispatch`'s launch: the per-plane
    plain bodies, packed as [ncty, nctx, 3, 96]."""
    return torch.stack([
        _pack_stats(sao_stats_plane_plain(o, r, ctb_log2 - (i > 0),
                                          bit_depth))
        for i, (o, r) in enumerate(zip(org_yuv, rec_yuv))], 2)


def apply_sao_frame_plain(planes, params, ctb_log2: int, bit_depth: int = 8):
    """Plain version of :func:`apply_sao_frame`'s launch: the per-plane
    plain body on each plane's slice of the packed parameters [ncty, nctx,
    3, 6]."""
    return tuple(apply_sao_plane_plain(
        p, params[:, :, i, 0], params[:, :, i, 2:6], params[:, :, i, 1],
        ctb_log2 - (i > 0), bit_depth) for i, p in enumerate(planes))


def _check_plane(t, name):
    if not (t.is_cuda and t.dtype == torch.int32 and t.dim() == 2
            and t.stride(1) == 1):
        raise ValueError(f"sao: {name} must be a CUDA int32 [H, W] plane "
                         "with dense rows")


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _ints(vs):
    return (ctypes.c_int * len(vs))(*vs)


def _stats_launch(orgs, pres, ctb_log2: int, bit_depth: int):
    """One launch of the statistics entry over the planes (luma at
    ctb_log2, chroma at ctb_log2 - 1): [ncty, nctx, planes, 96] int32."""
    global STATS_LAUNCHES
    for t in (*orgs, *pres):
        _check_plane(t, "org/pre")
    if bit_depth > 10:
        raise ValueError("sao: the statistics entry packs sums of at most "
                         "10-bit samples")
    h, w = pres[0].shape
    c = 1 << ctb_log2
    ncty, nctx = h // c, w // c
    out = torch.empty((ncty, nctx, len(pres), 96), dtype=torch.int32,
                      device=pres[0].device)
    fn = _cuda.bind("sao", "hh_sao_stats", "ippppppiiiipp")
    err = fn(len(pres), _ptrs(orgs), _ints([t.stride(0) for t in orgs]),
             _ptrs(pres), _ints([t.stride(0) for t in pres]),
             _ints([t.shape[0] for t in pres]),
             _ints([t.shape[1] for t in pres]), ncty, nctx, ctb_log2,
             bit_depth, out.data_ptr(), _cuda.stream(pres[0]))
    _cuda.check("sao", err)
    STATS_LAUNCHES += 1
    return out


def _apply_launch(pres, params, ctb_log2: int, bit_depth: int):
    """One launch of the apply entry over the planes: new planes."""
    global APPLY_LAUNCHES
    for t in pres:
        _check_plane(t, "pre")
    if not (params.is_cuda and params.dtype == torch.int32
            and params.is_contiguous()):
        raise ValueError("sao: the packed parameters must be a contiguous "
                         "CUDA int32 tensor")
    outs = [torch.empty(tuple(t.shape), dtype=torch.int32, device=t.device)
            for t in pres]
    ncty, nctx = params.shape[:2]
    fn = _cuda.bind("sao", "hh_sao_apply", "ipppppp" "iiii" "p")
    err = fn(len(pres), _ptrs(pres), _ints([t.stride(0) for t in pres]),
             _ptrs(outs), _ints([t.shape[0] for t in pres]),
             _ints([t.shape[1] for t in pres]), params.data_ptr(), ncty,
             nctx, ctb_log2, bit_depth, _cuda.stream(pres[0]))
    _cuda.check("sao", err)
    APPLY_LAUNCHES += 1
    return tuple(outs)


def sao_stats_plane(org, pre, ctb_log2: int, bit_depth: int = 8):
    """Per-CTU SAO statistics of one plane; kernel C6, stats entry, on one
    plane.

    org/pre: [H, W] int32, H and W multiples of the CTU size. Returns
    (eo_cnt [ncty, nctx, 4, 4], eo_sum, bo_cnt [ncty, nctx, 32], bo_sum)
    int32, with EO categories 1..4 at index 0..3.
    """
    c = 1 << ctb_log2
    if pre.shape != org.shape or pre.shape[0] % c or pre.shape[1] % c:
        raise ValueError("sao_stats_plane: planes of one CTU-aligned shape")
    if not pre.is_cuda:
        return sao_stats_plane_plain(org, pre, ctb_log2, bit_depth)
    return _unpack_stats(_stats_launch((org,), (pre,), ctb_log2,
                                       bit_depth)[:, :, 0])


def apply_sao_plane(pre, type_map, offs, band, ctb_log2: int,
                    bit_depth: int = 8):
    """Apply SAO to one plane; kernel C6, apply entry, on one plane.

    pre: [H, W] int32 deblocked samples (classification source AND input);
    type_map [ncty, nctx] int32 (0 off, 1 BO, 2+cls EO); offs
    [ncty, nctx, 4] int32; band [ncty, nctx] int32. Returns a new [H, W]
    int32 plane: classification reads the neighbours' pre-SAO values, so
    the pass cannot run in place.
    """
    h, w = pre.shape
    c = 1 << ctb_log2
    ncty, nctx = -(-h // c), -(-w // c)
    if tuple(type_map.shape) != (ncty, nctx) \
            or tuple(offs.shape) != (ncty, nctx, 4) \
            or tuple(band.shape) != (ncty, nctx):
        raise ValueError("apply_sao_plane: per-CTU maps do not match the "
                         "plane")
    if not pre.is_cuda:
        return apply_sao_plane_plain(pre, type_map, offs, band, ctb_log2,
                                     bit_depth)
    params = torch.cat([type_map[..., None], band[..., None], offs],
                       -1).to(torch.int32)[:, :, None].contiguous()
    return _apply_launch((pre,), params, ctb_log2, bit_depth)[0]


# ---------------------------------------------------------------------------
# Host-side RDO, vectorized over all CTUs (float64 numpy, as the reference).
# Candidate costs are dense numpy tensors; only the merge decision (which
# copies the raster-order *decided* params of the left/top neighbor) runs as
# a short anti-diagonal sweep.
# ---------------------------------------------------------------------------

def _best_offset_vec(cnt, s, lam, lo, hi):
    """Vectorized offset search: min over o in [lo, hi] of
    cnt*o^2 - 2*o*s + lam*(|o|+1), with o=0 costing 0.
    cnt/s: [...]; returns (off [...], cost [...])."""
    o = np.arange(lo, hi + 1, dtype=np.float64)
    c = (cnt[..., None] * o * o - 2.0 * o * s[..., None]
         + lam * (np.abs(o) + 1.0))
    c[..., -lo if lo < 0 else 0] = 0.0  # o == 0
    k = np.argmin(c, axis=-1)
    return (o[k]).astype(np.int16), np.take_along_axis(
        c, k[..., None], -1)[..., 0]


def _comp_new_best(stats, lam):
    """Per-CTU best 'new' params for one component, all CTUs at once.

    Returns dict with eo_off [Y,X,4,4], eo_cost [Y,X,4] (incl. lam*4 rate),
    bo_off [Y,X,4], bo_band [Y,X], bo_cost [Y,X] (incl. lam*7 rate)."""
    eo_cnt, eo_sum, bo_cnt, bo_sum = (np.asarray(a, np.float64)
                                      for a in stats)
    # EO: cats 0,1 -> offsets in [0,7]; cats 2,3 -> [-7,0]
    op, cp = _best_offset_vec(eo_cnt[..., :2], eo_sum[..., :2], lam, 0, 7)
    on, cn = _best_offset_vec(eo_cnt[..., 2:], eo_sum[..., 2:], lam, -7, 0)
    eo_off = np.concatenate([op, on], -1)            # [Y,X,4cls,4cat]
    eo_cost = cp.sum(-1) + cn.sum(-1) + lam * 4.0    # [Y,X,4cls]
    # BO: every band's best offset, then best 4-band window
    bo, bc = _best_offset_vec(bo_cnt, bo_sum, lam, -7, 7)   # [Y,X,32]
    win = sum(np.roll(bc, -k, axis=-1) for k in range(4))   # [Y,X,32]
    band = np.argmin(win, axis=-1)
    bo_cost = np.take_along_axis(win, band[..., None], -1)[..., 0] + lam * 7.0
    idx = (band[..., None] + np.arange(4)) % 32
    bo_off = np.take_along_axis(bo, idx, -1)
    return dict(eo_off=eo_off, eo_cost=eo_cost, bo_off=bo_off,
                bo_band=band.astype(np.int16), bo_cost=bo_cost)


def _apply_cost(stats, t, offs, bpos):
    """Distortion-delta of applying params (t [N], offs [N,4], band [N]) to
    CTUs whose stats rows are pre-gathered:
    stats = (eo_cnt [N,4,4], eo_sum, bo_cnt [N,32], bo_sum)."""
    eo_cnt, eo_sum, bo_cnt, bo_sum = stats
    o = offs.astype(np.float64)
    cls = np.clip(t - 2, 0, 3)
    n = np.arange(len(t))
    d_eo = (eo_cnt[n, cls] * o * o - 2.0 * o * eo_sum[n, cls]).sum(-1)
    b = (bpos[:, None] + np.arange(4)) % 32
    d_bo = (np.take_along_axis(bo_cnt, b, -1) * o * o
            - 2.0 * o * np.take_along_axis(bo_sum, b, -1)).sum(-1)
    return np.where(t == 0, 0.0, np.where(t == 1, d_bo, d_eo))


def choose_sao_params(stats_y, stats_cb, stats_cr, lam: float):
    """Per-CTU SAO decision incl. merge.

    stats_*: (eo_cnt, eo_sum, bo_cnt, bo_sum) numpy. Returns
    (merge [ncty,nctx], type3 [ncty,nctx,3], off [ncty,nctx,3,4],
    band [ncty,nctx,3]).
    """
    ncty, nctx = np.asarray(stats_y[0]).shape[:2]
    comps = tuple(tuple(np.asarray(a, np.float64) for a in s)
                  for s in (stats_y, stats_cb, stats_cr))
    nb = tuple(_comp_new_best(s, lam) for s in comps)

    # luma: free choice among OFF / BO / best-EO-class
    by = nb[0]
    ycls = np.argmin(by["eo_cost"], -1)
    yeo_cost = np.take_along_axis(by["eo_cost"], ycls[..., None], -1)[..., 0]
    cand_cost = np.stack([np.zeros((ncty, nctx)), by["bo_cost"], yeo_cost], 0)
    ysel = np.argmin(cand_cost, 0)                       # 0 off, 1 BO, 2 EO
    ty = np.where(ysel == 2, 2 + ycls, ysel).astype(np.uint8)
    costy = np.min(cand_cost, 0)
    # cb free; cr forced to cb's type idx + EO class (chroma pair)
    bcb = nb[1]
    ccls = np.argmin(bcb["eo_cost"], -1)
    ceo_cost = np.take_along_axis(bcb["eo_cost"], ccls[..., None], -1)[..., 0]
    ccost = np.stack([np.zeros((ncty, nctx)), bcb["bo_cost"], ceo_cost], 0)
    csel = np.argmin(ccost, 0)
    tcb = np.where(csel == 2, 2 + ccls, csel).astype(np.uint8)
    costcb = np.min(ccost, 0)
    bcr = nb[2]
    creo = np.take_along_axis(bcr["eo_cost"], ccls[..., None], -1)[..., 0]
    costcr = np.where(csel == 0, 0.0,
                      np.where(csel == 1, bcr["bo_cost"], creo))
    new_cost = costy + costcb + costcr + lam * 2.0

    def new_params(ci, tsel, cls):
        b = nb[ci]
        offs = np.where((tsel >= 2)[..., None],
                        np.take_along_axis(
                            b["eo_off"], cls[..., None, None], 2)[:, :, 0],
                        np.where((tsel == 1)[..., None], b["bo_off"], 0))
        bnd = np.where(tsel == 1, b["bo_band"], 0)
        return offs.astype(np.int16), bnd.astype(np.uint8)

    oy, bndy = new_params(0, ty, ycls)
    ocb, bndcb = new_params(1, tcb, ccls)
    tcr = np.where(csel == 2, 2 + ccls, csel).astype(np.uint8)
    ocr, bndcr = new_params(2, tcr, ccls)
    ntype = np.stack([ty, tcb, tcr], -1)
    noff = np.stack([oy, ocb, ocr], -2)
    nband = np.stack([bndy, bndcb, bndcr], -1)

    # merge sweep: anti-diagonals (left/top are always in earlier diagonals)
    merge = np.zeros((ncty, nctx), np.uint8)
    type3 = ntype.copy()
    off = noff.copy()
    band = nband.copy()
    ii, jj = np.mgrid[0:ncty, 0:nctx]
    for d in range(ncty + nctx - 1):
        sel = (ii + jj) == d
        cy, cx = ii[sel], jj[sel]
        cost_best = new_cost[cy, cx].copy()
        src = np.zeros(len(cy), np.uint8)
        for mrg, (sy, sx) in ((1, (cy, cx - 1)), (2, (cy - 1, cx))):
            ok = (sx >= 0) & (sy >= 0)
            if not ok.any():
                continue
            sy2, sx2 = np.clip(sy, 0, None), np.clip(sx, 0, None)
            c = np.full(len(cy), lam * 1.0)
            for ci in range(3):
                g = tuple(a[cy, cx] for a in comps[ci])
                c += _apply_cost(g, type3[sy2, sx2, ci].astype(np.int32),
                                 off[sy2, sx2, ci], band[sy2, sx2, ci])
            better = ok & (c < cost_best)
            cost_best = np.where(better, c, cost_best)
            src = np.where(better, mrg, src)
        merge[cy, cx] = src
        for mrg, (sy, sx) in ((1, (cy, cx - 1)), (2, (cy - 1, cx))):
            m = src == mrg
            if m.any():
                type3[cy[m], cx[m]] = type3[sy[m], sx[m]]
                off[cy[m], cx[m]] = off[sy[m], sx[m]]
                band[cy[m], cx[m]] = band[sy[m], sx[m]]
    return merge, type3, off, band


class SaoStats(tuple):
    """The per-CTU statistics of a picture's three planes: per plane
    (eo_cnt, eo_sum, bo_cnt, bo_sum), views of one [ncty, nctx, 3, 96]
    int32 buffer, ``packed``, which :func:`fetch_stats` copies at once."""
    packed: torch.Tensor


def stats_dispatch(org_yuv, rec_yuv, ctb_log2: int, bit_depth: int = 8):
    """The per-CTU statistics of a picture's three planes (luma at
    ctb_log2, chroma at ctb_log2 - 1), as a :class:`SaoStats`: device
    tensors, on the card one launch of kernel C6's stats entry, a CTA per
    CTU position, not yet waited for."""
    c = 1 << ctb_log2
    h, w = rec_yuv[0].shape
    shapes = ((h, w), (h // 2, w // 2), (h // 2, w // 2))
    if h % c or w % c or any(
            tuple(o.shape) != s or tuple(r.shape) != s
            for o, r, s in zip(org_yuv, rec_yuv, shapes)):
        raise ValueError("stats_dispatch: 4:2:0 planes of one CTU-aligned "
                         "shape")
    if rec_yuv[0].is_cuda:
        packed = _stats_launch(tuple(org_yuv), tuple(rec_yuv), ctb_log2,
                               bit_depth)
    else:
        packed = sao_stats_frame_plain(org_yuv, rec_yuv, ctb_log2,
                                       bit_depth)
    out = SaoStats(_unpack_stats(packed[:, :, i]) for i in range(3))
    out.packed = packed
    return out


def fetch_stats(stats: SaoStats):
    """The statistics on the host as numpy arrays, in one copy."""
    return host_stats(stats.packed.cpu())


def host_stats(packed: torch.Tensor):
    """Per plane (eo_cnt, eo_sum, bo_cnt, bo_sum) numpy views of ``packed``,
    a host copy of :class:`SaoStats`' packed buffer (the read step of a
    fetch whose copy the caller enqueued and waited for)."""
    return tuple(tuple(a.numpy() for a in _unpack_stats(packed[:, :, i]))
                 for i in range(3))


def choose_apply(stats_np, rec_yuv, maps, ctb_log2: int, lam: float,
                 bit_depth: int = 8):
    """Host RDO on fetched stats -> fill maps.sao_* -> device apply."""
    st_y, st_cb, st_cr = stats_np
    merge, type3, off, band = choose_sao_params(st_y, st_cb, st_cr, lam)
    maps.sao_on = 1
    maps.sao_merge[:] = merge
    maps.sao_type[:] = type3
    maps.sao_off[:] = off
    maps.sao_band[:] = band
    return apply_sao_frame(*rec_yuv, type3, off, band, ctb_log2, bit_depth)


def rdo_and_apply(org_yuv, rec_yuv, maps, ctb_log2: int, lam: float,
                  bit_depth: int = 8):
    """Encoder-side SAO: stats -> per-CTU RDO -> fill maps.sao_* -> apply.

    org_yuv/rec_yuv: (y, cb, cr) int32 tensors on one device, CTU-aligned.
    Returns the post-SAO (ry, rcb, rcr) tensors.
    """
    stats_np = fetch_stats(stats_dispatch(org_yuv, rec_yuv, ctb_log2,
                                          bit_depth))
    return choose_apply(stats_np, rec_yuv, maps, ctb_log2, lam, bit_depth)


def apply_sao_frame(ry, rcb, rcr, type3, off, band, ctb_log2: int,
                    bit_depth: int = 8):
    """Apply resolved per-CTU SAO params (numpy [ncty, nctx, 3(, 4)]) to
    all three planes: packed into one [ncty, nctx, 3, 6] int32 array
    (type, band, four offsets), uploaded in one copy; on the card one
    launch of kernel C6's apply entry, a CTA per CTU position. Returns new
    planes."""
    c = 1 << ctb_log2
    h, w = ry.shape
    if tuple(type3.shape) != (-(-h // c), -(-w // c), 3):
        raise ValueError("apply_sao_frame: per-CTU parameters do not match "
                         "the picture")
    params = np.empty(tuple(type3.shape) + (6,), np.int32)
    params[..., 0] = type3
    params[..., 1] = band
    params[..., 2:] = off
    params = torch.as_tensor(params).to(ry.device)
    if not ry.is_cuda:
        return apply_sao_frame_plain((ry, rcb, rcr), params, ctb_log2,
                                     bit_depth)
    return _apply_launch((ry, rcb, rcr), params, ctb_log2, bit_depth)
