"""Whole-frame intra wavefront: kernel C13, one launch per frame.

Counterpart of hevc_hop_tpu/models/wavefront_scan.py. The schedule is the
reference's (:func:`build_schedule`, numpy, copied): topological levels of
transform blocks, each level's blocks mutually independent. The reference
runs the levels as one ``lax.scan``; on the card :func:`scan_encode` and
:func:`scan_decode` run them as one cooperative launch of kernel C13
(``csrc/scan.cu``), which walks the schedule's :class:`WorkList` level by
level with a grid-wide barrier between levels: with the modes given, each
item's luma, cb and cr on three CTAs; with the in-loop RMD, a cluster of
CTAs per item that splits the 35 modes, then codes the three planes side
by side. Their plain version is the
level loop (:func:`scan_encode_loop`, :func:`scan_decode_loop`), which
launches, per level and block size, C2 then C3 for luma and C2 then C3 for
the stacked cb/cr plane (encode), or C2 with its add-residual epilogue for
each plane (decode); on the CPU it runs the kernels' plain versions. The
mesh encoder (parallel/shard_encode.py) runs C13 in its banded form on a
virtual mesh on the card: every cell's slab stacked into one plane, and a
halo table that has each block whose bottom row is its band's last write
that row into the next band's halo as well. The process mesh runs the loop
with its halo exchange after every level (``after_level``).

:func:`pack_schedule` keeps only the real slots of each level, packed in
level order, so no launch ever sees a dummy slot: the reference's dummies
all write one scratch block, which CTAs running side by side may not do.
The stacked chroma plane keeps the reference's layout: cb rows
[0, h/2), cr rows [hc_off, hc_off + h/2).
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools

import numpy as np
import torch

from hevc_hop_torch import _cuda
from hevc_hop_torch.models import wavefront
from hevc_hop_torch.models.partition import full_lambda
from hevc_hop_torch.ops import quant, rdoq as _rdoq
from hevc_hop_torch.ops.intra import intra_blocks, intra_blocks_plain
from hevc_hop_torch.ops.tq import tq_encode, tq_encode_plain

# launches of kernel C13's two entries
SCAN_ENCODE_LAUNCHES = 0
SCAN_DECODE_LAUNCHES = 0
# (grid, CTAs per SM, dynamic shared bytes, threads, CTAs per cluster) of
# the last C13 launch
LAST_LAUNCH = None


def build_schedule(blocks, w: int, h: int, ctb_log2: int,
                   pad_steps: int = 64, pad_slots: int = 16,
                   force_sizes: tuple | None = None):
    """Schedule tensors for an arbitrary TU-leaf structure (z-order list).

    Returns (sizes, data, nsteps): sizes is a sorted tuple of block log2s
    and data[log2] = dict(pos [S,B,2], avail [S,B,L], availc [S,B,Lc],
    valid [S,B]) with S = number of levels (shared across sizes; dummies
    point at the (0, h) scratch row). The real slots of a level come first.
    """
    from hevc_hop_torch.entropy import native as _native
    arr = np.array(blocks, np.int32)
    # NxN CUs: the 4th 4x4 PU carries the CU's 4x4 CHROMA TU, whose
    # reference chain spans the whole 8x8 CU neighborhood — wider than the
    # carrier's own luma chain, so its dependency rect is added explicitly
    rects = None
    if (arr[:, 2] == 2).any():
        rects = np.zeros((len(arr), 4), np.int32)
        car = ((arr[:, 2] == 2) & (arr[:, 0] % 8 == 4)
               & (arr[:, 1] % 8 == 4))
        rects[car] = np.stack(
            [arr[car, 0] - 6, arr[car, 1] - 6,
             np.full(car.sum(), 18), np.full(car.sum(), 18)], -1)
    levels = _native.wavefront_levels(arr[:, 0], arr[:, 1], arr[:, 2],
                                      w, h, ctb_log2, mv_rect=rects)
    nsteps = int(levels.max()) if len(levels) else 0
    if pad_steps > 1:
        nsteps = max(pad_steps, -(-nsteps // pad_steps) * pad_steps)
    zplane = wavefront.zaddr4_plane(w, h, ctb_log2)
    czplane = zplane[::2, ::2]
    sizes = (tuple(force_sizes) if force_sizes is not None
             else tuple(sorted({int(l) for l in arr[:, 2]})))
    data = {}
    for log2 in sizes:
        n = 1 << log2
        sel = arr[:, 2] == log2
        lv = levels[sel] - 1
        pts = arr[sel][:, :2]
        counts = np.bincount(lv, minlength=nsteps)
        bmax = max(1, int(counts.max()) if len(lv) else 0)
        slot_q = max(2, pad_slots >> max(log2 - 3, 0))
        if pad_slots > 1:
            bmax = max(slot_q, -(-bmax // slot_q) * slot_q)
        pos = np.zeros((nsteps, bmax, 2), np.int32)
        pos[:, :, 1] = h
        valid = np.zeros((nsteps, bmax), bool)
        slot = np.zeros(nsteps, np.int32)
        order = np.argsort(lv, kind="stable")
        for i in order:
            s = lv[i]
            pos[s, slot[s]] = pts[i]
            valid[s, slot[s]] = True
            slot[s] += 1
        flat = pos.reshape(-1, 2)
        vmf = valid.reshape(-1)
        fv = flat[vmf]
        avail = np.zeros((flat.shape[0], 4 * n + 1), bool)
        avail[vmf] = wavefront.avail_mask(fv, n, zplane, w, h)
        if log2 == 2:
            # chroma is a CU-level 4x4 TU carried by the 4th PU: chain of
            # the 4x4 chroma block at the CU origin (others unused)
            availc = np.zeros((flat.shape[0], 17), bool)
            availc[vmf] = wavefront.avail_mask(
                np.maximum(fv - 4, 0) // 2, 4, czplane, w // 2, h // 2)
            clen = 17
        else:
            availc = np.zeros((flat.shape[0], 2 * n + 1), bool)
            availc[vmf] = wavefront.avail_mask(fv // 2, n // 2, czplane,
                                               w // 2, h // 2)
            clen = 2 * n + 1
        data[log2] = dict(
            pos=pos, valid=valid,
            avail=avail.reshape(nsteps, bmax, 4 * n + 1),
            availc=availc.reshape(nsteps, bmax, clen))
    return sizes, data, nsteps


@dataclasses.dataclass
class SizePlan:
    """The real blocks of one size, packed in level order.

    Luma block j of level s is row off[s] + j of pos/avail (cnt[s] rows).
    Its chroma blocks are rows coff[s] + j (cb) and coff[s] + ccnt[s] + j
    (cr) of cpos, and row cidx[...] of the luma arrays gives their
    availability and mode (all blocks, or only the NxN carriers at 4x4).
    """
    n: int
    cnt: np.ndarray        # [S] luma blocks per level
    off: np.ndarray        # [S]
    ccnt: np.ndarray       # [S] chroma blocks (per plane) per level
    coff: np.ndarray       # [S] offset of the level's cb rows in cpos
    pos: torch.Tensor      # [T, 2] int32 (x, y)
    avail: torch.Tensor    # [T, 4n+1] bool
    cpos: torch.Tensor     # [2Tc, 2] int32, stacked-plane coordinates
    cavail: torch.Tensor   # [Tc, Lc] bool
    cidx: np.ndarray       # [Tc] luma row of each chroma block
    vpos: np.ndarray       # [T, 2] host copy of pos
    cb_rows: np.ndarray    # [Tc] rows of the cb blocks in cpos order
    cr_rows: np.ndarray    # [Tc]


def pack_schedule(sizes, data, h: int, hc_off: int, device) -> dict:
    """Real slots of :func:`build_schedule`'s output, packed per size into
    :class:`SizePlan` tensors on ``device``."""
    plans = {}
    for log2 in sizes:
        d = data[log2]
        valid = d["valid"]
        cnt = valid.sum(1).astype(np.int64)
        off = np.concatenate([[0], np.cumsum(cnt)[:-1]]).astype(np.int64)
        vm = valid.reshape(-1)
        pos = d["pos"].reshape(-1, 2)[vm]
        avail = d["avail"].reshape(-1, d["avail"].shape[-1])[vm]
        availc = d["availc"].reshape(-1, d["availc"].shape[-1])[vm]
        lvl = np.repeat(np.arange(len(cnt)), cnt)
        if log2 == 2:
            car = (pos[:, 0] % 8 == 4) & (pos[:, 1] % 8 == 4)
            cidx = np.nonzero(car)[0]
            pc = (pos[car] - 4) // 2
            ccnt = np.bincount(lvl[car], minlength=len(cnt)).astype(np.int64)
        else:
            cidx = np.arange(len(pos))
            pc = pos // 2
            ccnt = cnt
        coff = 2 * np.concatenate([[0], np.cumsum(ccnt)[:-1]]).astype(
            np.int64)
        clvl = lvl[cidx]
        j = np.arange(len(cidx)) - (coff[clvl] // 2)
        cb_rows = coff[clvl] + j
        cr_rows = cb_rows + ccnt[clvl]
        cpos = np.zeros((2 * len(cidx), 2), np.int32)
        cpos[cb_rows] = pc
        cpos[cr_rows] = pc + np.array([0, hc_off], np.int32)
        t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                          device=device)
        plans[log2] = SizePlan(
            n=1 << log2, cnt=cnt, off=off, ccnt=ccnt, coff=coff,
            pos=t(pos, torch.int32), avail=t(avail, torch.bool),
            cpos=t(cpos, torch.int32), cavail=t(availc[cidx], torch.bool),
            cidx=cidx, vpos=pos, cb_rows=cb_rows, cr_rows=cr_rows)
    return plans


@dataclasses.dataclass
class Schedule:
    """The packed wavefront schedule of one frame geometry, with what the
    encoder and the decoder derive from its transform blocks."""
    leaves: np.ndarray     # [L, 3] int32 luma TUs (x, y, log2), z order
    plans: dict            # log2 -> SizePlan
    nsteps: int
    tu4: np.ndarray        # [h/4, w/4] uint8 TU log2 per 4x4 unit
    tu4_dev: torch.Tensor

    @functools.cached_property
    def map_index(self) -> dict:
        """log2 -> (iy4, ix4, iy8, ix8): each packed luma block's 4x4 units
        [T, u, u] and each chroma block's 8x8 units [Tc, v, v] in the dense
        maps. At 4x4 the chroma blocks are the NxN carriers' and land at
        their CU's cell."""
        out = {}
        for log2, p in self.plans.items():
            px, py = p.vpos[:, 0], p.vpos[:, 1]
            cx, cy = px[p.cidx], py[p.cidx]
            u4, u8 = p.n // 4, max(p.n // 8, 1)
            out[log2] = (
                py[:, None, None] // 4 + np.arange(u4)[None, :, None],
                px[:, None, None] // 4 + np.arange(u4)[None, None, :],
                cy[:, None, None] // 8 + np.arange(u8)[None, :, None],
                cx[:, None, None] // 8 + np.arange(u8)[None, None, :])
        return out

    @functools.cached_property
    def tu_pos(self) -> tuple:
        return tu_positions(self.leaves, self.tu4_dev.device)

    @functools.cached_property
    def work(self) -> "WorkList":
        return work_list(self.plans, self.tu4_dev.device)


@dataclasses.dataclass
class WorkList:
    """Kernel C13's items: the blocks of every size, packed level by level
    (within a level by size, then by packed row). Item i is
    items[i] = (log2, luma row in that size's :class:`SizePlan`, chroma
    row (of cavail and the chroma modes) or -1, cb row and cr row of
    cpos or -1). Level s holds items level_off[s]:level_off[s + 1]; only
    levels that hold items count, so the padded steps of
    :func:`build_schedule` cost no barrier."""
    items: torch.Tensor        # [N, 5] int32
    level_off: torch.Tensor    # [S' + 1] int32
    host_items: np.ndarray
    host_off: np.ndarray
    widest: int                # the most items of any level


def work_list(plans: dict, device) -> WorkList:
    """The :class:`WorkList` of a schedule's packed plans, on ``device``."""
    rows = []
    for log2, p in plans.items():
        t = len(p.vpos)
        tc = np.full(t, -1, np.int64)
        tc[p.cidx] = np.arange(len(p.cidx))
        cb = np.full(t, -1, np.int64)
        cr = np.full(t, -1, np.int64)
        has = tc >= 0
        cb[has] = p.cb_rows[tc[has]]
        cr[has] = p.cr_rows[tc[has]]
        rows.append(np.stack([np.repeat(np.arange(len(p.cnt)), p.cnt),
                              np.full(t, log2), np.arange(t), tc, cb, cr],
                             -1))
    a = np.concatenate(rows) if rows else np.zeros((0, 6), np.int64)
    a = a[np.lexsort((a[:, 2], a[:, 1], a[:, 0]))]
    _, counts = np.unique(a[:, 0], return_counts=True)
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    items = np.ascontiguousarray(a[:, 1:], dtype=np.int32)
    return WorkList(items=torch.as_tensor(items, device=device),
                    level_off=torch.as_tensor(off, device=device),
                    host_items=items, host_off=off,
                    widest=int(counts.max(initial=0)))


def tu_positions(lv: np.ndarray, device) -> tuple:
    """(luma, chroma): log2 -> [B, 2] int32 positions of the TUs of that
    size in their own plane, from the luma TU leaves lv [L, 3]. Chroma TUs
    follow the CU tree only down to 8x8 luma: an NxN CU's chroma is one 4x4
    TU at the CU origin, not four 2x2s."""
    nxn = lv[lv[:, 2] == 2]
    cu = np.concatenate([lv[lv[:, 2] >= 3], np.unique(
        np.stack([nxn[:, 0] // 8 * 8, nxn[:, 1] // 8 * 8,
                  np.full(len(nxn), 3, np.int32)], -1), axis=0)])
    group = lambda a, sh: {
        int(lg): torch.as_tensor(
            np.ascontiguousarray(a[a[:, 2] == lg, :2] >> sh),
            dtype=torch.int32, device=device)
        for lg in np.unique(a[:, 2])}
    luma = group(lv, 0)
    chroma = {lg - 1: p for lg, p in group(cu, 1).items()}
    return luma, chroma


_SCHEDULES: collections.OrderedDict = collections.OrderedDict()
_SCHEDULES_MAX = 8


def schedule(depth8: np.ndarray, tu4: np.ndarray, w: int, h: int,
             ctb_log2: int, device) -> Schedule:
    """The :class:`Schedule` of the transform blocks that the CU depth map
    and the TU-size map give (TUs no larger than their CU), built once per
    device and geometry and cached (bounded, least recently used out)."""
    key = (str(device), w, h, ctb_log2, depth8.tobytes(), tu4.tobytes())
    hit = _SCHEDULES.get(key)
    if hit is not None:
        _SCHEDULES.move_to_end(key)
        return hit
    leaves = np.array(wavefront.tu_blocks_from_maps(depth8, tu4, w, h,
                                                    ctb_log2),
                      np.int32).reshape(-1, 3)
    sizes, data, nsteps = build_schedule(leaves, w, h, ctb_log2)
    plans = pack_schedule(sizes, data, h, h // 2 + (1 << ctb_log2), device)
    tu4_real = np.zeros((h // 4, w // 4), np.uint8)
    for log2, p in plans.items():
        u = p.n // 4
        tu4_real[p.vpos[:, 1, None, None] // 4 + np.arange(u)[None, :, None],
                 p.vpos[:, 0, None, None] // 4
                 + np.arange(u)[None, None, :]] = log2
    val = Schedule(leaves=leaves, plans=plans, nsteps=nsteps, tu4=tu4_real,
                   tu4_dev=torch.as_tensor(tu4_real, device=device))
    _SCHEDULES[key] = val
    while len(_SCHEDULES) > _SCHEDULES_MAX:
        _SCHEDULES.popitem(last=False)
    return val


def scan_encode(org_y, org_c, plans: dict, nsteps: int, qp: int, qp_c: int,
                bit_depth: int, strong: bool, sbh: bool, modes=None,
                use_rdoq: bool = False, init_type: int = 2,
                after_level=None, work: WorkList | None = None,
                halo: torch.Tensor | None = None):
    """Intra encode of every block of a frame: on CUDA tensors one launch
    of kernel C13 over ``work`` (the schedule's :class:`WorkList`, built
    here when not given); with ``after_level``, or on CPU tensors, the
    level loop :func:`scan_encode_loop`, C13's plain version. ``halo``
    [N, 3] int32 (C13 only, with ``work``): per item of ``work`` and plane
    (luma, cb, cr) the row of its plane that also receives the block's
    bottom recon row, or -1 (the mesh's banded form,
    parallel/shard_encode.py ``halo_table``). Other arguments and the
    results are :func:`scan_encode_loop`'s."""
    if org_y.is_cuda and after_level is None:
        if halo is not None and (work is None or tuple(halo.shape) != (
                len(work.host_items), 3)):
            raise ValueError("scan_encode: halo must be [N, 3] beside the "
                             "work list it indexes")
        return _scan_encode_c13(
            org_y, org_c, plans,
            work if work is not None else work_list(plans, org_y.device),
            qp, qp_c, bit_depth, strong, sbh, modes, use_rdoq, init_type,
            halo)
    if halo is not None:
        raise ValueError("scan_encode: the halo table is C13's; the level "
                         "loop refreshes the halo with after_level")
    return scan_encode_loop(org_y, org_c, plans, nsteps, qp, qp_c, bit_depth,
                            strong, sbh, modes, use_rdoq, init_type,
                            after_level)


def scan_encode_loop(org_y, org_c, plans: dict, nsteps: int, qp: int,
                     qp_c: int, bit_depth: int, strong: bool, sbh: bool,
                     modes=None, use_rdoq: bool = False, init_type: int = 2,
                     after_level=None, plain: bool = False):
    """Intra encode of every block, level by level.

    org_y [h+pad, w] and org_c (stacked cb/cr) int32 on the target device.
    ``modes`` None: every block's mode is chosen in the loop by 35-mode
    SATD against the reconstructed references, and chroma follows it.
    Otherwise modes[log2] = (luma modes [T], chroma modes [Tc] or None for
    "as luma") in the packed order of ``plans``, and C2 predicts the one
    given mode. A 4x4 block is luma only, through the DST; the chroma of
    its NxN CU is one 4x4 TU that the CU's fourth block carries.
    ``use_rdoq`` quantizes every block with RDOQ (slice class
    ``init_type``) at the reference's lambdas: full_lambda(qp) for luma,
    weighted by 2^((qp_c - qp) / 3) in float64 for chroma.
    ``after_level(ry, rc)``, where given, runs after every level (the
    mesh encoder's halo refresh, parallel/shard_encode.py).
    ``plain`` runs the kernels' plain versions whatever the device.
    Returns (ry, rc, coef_y, coef_c, outs): recon and int16 level planes
    shaped like the originals, and outs[log2] = (best [T], cbf_y [T],
    cbf_c [2Tc]) in the packed order of ``plans``.
    """
    pred_fn = intra_blocks_plain if plain else intra_blocks
    tq_fn = tq_encode_plain if plain else tq_encode
    dev = org_y.device
    lam = full_lambda(qp)
    rcfg_y = (init_type, lam) if use_rdoq else None
    rcfg_c = ((init_type, lam * 2.0 ** ((qp_c - qp) / 3.0)) if use_rdoq
              else None)
    ry = torch.zeros_like(org_y)
    rc = torch.zeros_like(org_c)
    coef_y = torch.zeros(org_y.shape, dtype=torch.int16, device=dev)
    coef_c = torch.zeros(org_c.shape, dtype=torch.int16, device=dev)
    widest = max((int(p.cnt.max(initial=0)) for p in plans.values()),
                 default=0)
    rmd = torch.full((max(widest, 1),), -1, dtype=torch.int32, device=dev)
    acc = {log2: ([], [], []) for log2 in plans}
    for s in range(nsteps):
        for log2, p in plans.items():
            c = int(p.cnt[s])
            if c == 0:
                continue
            o = int(p.off[s])
            n = p.n
            pos = p.pos[o:o + c]
            if modes is None:
                pred, best = pred_fn(ry, pos, p.avail[o:o + c], rmd[:c], n,
                                     0, bit_depth, strong, org=org_y)
            else:
                best = modes[log2][0][o:o + c]
                pred, _ = pred_fn(ry, pos, p.avail[o:o + c], best, n, 0,
                                  bit_depth, strong)
            cbf = tq_fn(org_y, pred, pos, best, n, 0, qp, bit_depth, sbh,
                        rcfg_y, ry, coef_y)
            acc[log2][0].append(best)
            acc[log2][1].append(cbf)
            cc = int(p.ccnt[s])
            if cc == 0:
                continue
            co = int(p.coff[s])
            cmode = best
            if modes is not None and modes[log2][1] is not None:
                cmode = modes[log2][1][co // 2:co // 2 + cc]
            nc = 4 if log2 == 2 else n // 2
            cpos = p.cpos[co:co + 2 * cc]
            predc, _ = pred_fn(rc, cpos, p.cavail[co // 2:co // 2 + cc],
                               cmode, nc, 1, bit_depth, strong)
            acc[log2][2].append(tq_fn(org_c, predc, cpos, cmode, nc, 1, qp_c,
                                      bit_depth, sbh, rcfg_c, rc, coef_c))
        if after_level is not None:
            after_level(ry, rc)
    outs = {}
    for log2, lists in acc.items():
        outs[log2] = tuple(torch.cat(v) if v else torch.zeros(
            0, dtype=torch.int32, device=dev) for v in lists)
    return ry, rc, coef_y, coef_c, outs


def scan_decode(resi_y, resi_c, plans: dict, nsteps: int, modes: dict,
                cmodes: dict, bit_depth: int, strong: bool,
                work: WorkList | None = None):
    """Intra decode of every block of a frame: on CUDA tensors one launch
    of kernel C13's decode entry over ``work`` (built here when not
    given); on CPU tensors the level loop :func:`scan_decode_loop`, its
    plain version. Arguments and results are :func:`scan_decode_loop`'s."""
    if resi_y.is_cuda:
        return _scan_decode_c13(
            resi_y, resi_c, plans,
            work if work is not None else work_list(plans, resi_y.device),
            modes, cmodes, bit_depth, strong)
    return scan_decode_loop(resi_y, resi_c, plans, nsteps, modes, cmodes,
                            bit_depth, strong)


def scan_decode_loop(resi_y, resi_c, plans: dict, nsteps: int, modes: dict,
                     cmodes: dict, bit_depth: int, strong: bool,
                     plain: bool = False):
    """Intra decode of every block, level by level: prediction plus the
    dense residual, written in place into fresh recon planes.

    resi_y [h+pad, w] and resi_c (stacked cb/cr) int32; modes[log2] [T]
    and cmodes[log2] [Tc] int32 in the packed order of ``plans``.
    ``plain`` runs C2's plain version whatever the device.
    Returns (ry, rc).
    """
    pred_fn = intra_blocks_plain if plain else intra_blocks
    ry = torch.zeros_like(resi_y)
    rc = torch.zeros_like(resi_c)
    for s in range(nsteps):
        for log2, p in plans.items():
            c = int(p.cnt[s])
            if c == 0:
                continue
            o = int(p.off[s])
            pred_fn(ry, p.pos[o:o + c], p.avail[o:o + c],
                    modes[log2][o:o + c], p.n, 0, bit_depth, strong,
                    resi=resi_y)
            cc = int(p.ccnt[s])
            if cc == 0:
                continue
            co = int(p.coff[s])
            pred_fn(rc, p.cpos[co:co + 2 * cc],
                    p.cavail[co // 2:co // 2 + cc],
                    cmodes[log2][co // 2:co // 2 + cc],
                    4 if log2 == 2 else p.n // 2, 1, bit_depth, strong,
                    resi=resi_c)
    return ry, rc


# ---------------------------------------------------------------------------
# Kernel C13's launches. The structures mirror csrc/scan.cu's ScanArgs
# (with csrc/intra.cuh's Tables and IntraPlane and csrc/tq.cuh's TqClass),
# field for field.
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int


class _Tables(ctypes.Structure):
    _fields_ = [(k, _P) for k in ("ext_idx", "pred_idx", "fact", "is_hor",
                                   "filt", "had")]


class _TqClass(ctypes.Structure):
    _fields_ = ([(k, _I) for k in ("n", "c_idx", "bit_depth", "maxv", "qs",
                                    "qbits", "qoff", "dqs", "dqsh", "sbh")]
                + [("lamc", ctypes.c_float), ("r", _rdoq.RdoqArgs)])


class _ClassArgs(ctypes.Structure):
    _fields_ = [("t", _Tables), ("tq", _TqClass)]


class _IntraPlane(ctypes.Structure):
    _fields_ = [("plane", _P), ("ph", _I), ("pw", _I), ("stride", _I),
                ("org", _P), ("org_stride", _I), ("resi", _P),
                ("resi_stride", _I)]


class _SizeArgs(ctypes.Structure):
    _fields_ = [(k, _P) for k in ("pos", "avail", "cpos", "cavail", "modes_y",
                                   "modes_c", "best", "cbf_y", "cbf_c")]


class _ScanArgs(ctypes.Structure):
    _fields_ = [("items", _P), ("level_off", _P), ("halo", _P),
                ("levels", _I),
                ("y", _IntraPlane), ("c", _IntraPlane), ("coef_y", _P),
                ("coef_c", _P), ("coef_y_stride", _I),
                ("coef_c_stride", _I), ("bit_depth", _I), ("strong", _I),
                ("rmd", _I), ("nmax", _I), ("size", _SizeArgs * 4),
                ("cls", _ClassArgs * 8)]


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(t, dtype, name):
    if not (t.is_cuda and t.dtype == dtype and t.is_contiguous()):
        raise ValueError(f"scan: {name} must be a contiguous CUDA {dtype} "
                         "tensor")


def _plane(plane, org=None, resi=None) -> _IntraPlane:
    return _IntraPlane(plane.data_ptr(), plane.shape[0], plane.shape[1],
                       plane.stride(0), _ptr(org),
                       0 if org is None else org.stride(0), _ptr(resi),
                       0 if resi is None else resi.stride(0))


def _intra_tables(dev, n: int) -> _Tables:
    """C2's tables for an n x n block, as ops/intra.py hands them to C2."""
    from hevc_hop_torch.convert import device_tables
    tab = device_tables(dev)
    k = f"intra{n}"
    return _Tables(*(tab[k + f].data_ptr() for f in (
        "_ext_idx", "_pred_idx", "_fact", "_is_hor", "_filt")),
        tab["hadamard4" if n == 4 else "hadamard8"].data_ptr())


def _class_args(dev, c_idx, log2, qp, bit_depth, sbh, rcfg) -> _ClassArgs:
    """C2's tables and C3's class scalars for TU class (c_idx, log2), as
    ops/intra.py and ops/tq.py hand them to C2 and C3 (RDOQ's only where
    ``rcfg`` is given)."""
    n = 1 << log2
    qs, qbits, qoff = quant.quant_params(qp, log2, bit_depth)
    dqs, dqsh = quant.dequant_params(qp, log2, bit_depth)
    lam = rcfg[1] if rcfg else 0.0
    lamc = float(np.float32(lam * (4.0 ** (15 - bit_depth - log2))))
    r = (_rdoq.kernel_args(log2, c_idx, qp, bit_depth, rcfg[0], rcfg[1], dev)
         if rcfg else _rdoq.RdoqArgs())
    return _ClassArgs(_intra_tables(dev, n), _TqClass(
        n, c_idx, bit_depth, (1 << bit_depth) - 1, qs, qbits, qoff, dqs, dqsh,
        int(sbh), lamc, r))


def _chroma_log2(log2: int) -> int:
    return 2 if log2 == 2 else log2 - 1


def _scan_args(work, plans, y, c, bit_depth, strong, classes):
    """ScanArgs of ``work`` on the planes y and c; classes: (c_idx, log2)
    -> _ClassArgs."""
    a = _ScanArgs()
    a.items, a.level_off = work.items.data_ptr(), work.level_off.data_ptr()
    a.levels = len(work.host_off) - 1
    a.y, a.c = y, c
    a.bit_depth, a.strong = bit_depth, int(strong)
    a.nmax = max((p.n for p in plans.values() if len(p.vpos)), default=4)
    for (c_idx, log2), ca in classes.items():
        a.cls[c_idx * 4 + log2 - 2] = ca
    return a


def _plan_check(p):
    for t, dt, name in ((p.pos, torch.int32, "pos"),
                        (p.avail, torch.bool, "avail"),
                        (p.cpos, torch.int32, "cpos"),
                        (p.cavail, torch.bool, "cavail")):
        _check(t, dt, name)


def _launch(entry, sig, a, *extra, like):
    """One launch of C13's ``entry`` (ctypes signature ``sig``); records
    its shape in LAST_LAUNCH."""
    global LAST_LAUNCH
    info = (ctypes.c_int * 5)()
    fn = _cuda.bind("scan", entry, sig)
    err = fn(ctypes.addressof(a), *extra, _cuda.stream(like), info)
    _cuda.check("scan", err)
    LAST_LAUNCH = tuple(info)


def _scan_encode_c13(org_y, org_c, plans, work, qp, qp_c, bit_depth, strong,
                     sbh, modes, use_rdoq, init_type, halo=None):
    global SCAN_ENCODE_LAUNCHES
    _check(org_y, torch.int32, "org_y")
    _check(org_c, torch.int32, "org_c")
    if halo is not None:
        _check(halo, torch.int32, "halo")
    dev = org_y.device
    ry = torch.zeros_like(org_y)
    rc = torch.zeros_like(org_c)
    coef_y = torch.zeros(org_y.shape, dtype=torch.int16, device=dev)
    coef_c = torch.zeros(org_c.shape, dtype=torch.int16, device=dev)
    lam = full_lambda(qp)
    rcfg = {0: (init_type, lam) if use_rdoq else None,
            1: ((init_type, lam * 2.0 ** ((qp_c - qp) / 3.0)) if use_rdoq
                else None)}
    classes, outs = {}, {}
    for log2, p in plans.items():
        _plan_check(p)
        classes[0, log2] = _class_args(dev, 0, log2, qp, bit_depth, sbh,
                                       rcfg[0])
        if len(p.cidx):
            lc = _chroma_log2(log2)
            classes[1, lc] = _class_args(dev, 1, lc, qp_c, bit_depth, sbh,
                                         rcfg[1])
    a = _scan_args(work, plans, _plane(ry, org=org_y),
                   _plane(rc, org=org_c), bit_depth, strong, classes)
    a.coef_y, a.coef_c = coef_y.data_ptr(), coef_c.data_ptr()
    a.halo = _ptr(halo)
    a.coef_y_stride, a.coef_c_stride = coef_y.stride(0), coef_c.stride(0)
    a.rmd = int(modes is None)
    for log2, p in plans.items():
        t, tc = len(p.vpos), len(p.cidx)
        out = tuple(torch.empty(k, dtype=torch.int32, device=dev)
                    for k in (t, t, 2 * tc))
        outs[log2] = out
        my = mc = None
        if modes is not None:
            my, mc = modes[log2]
            _check(my, torch.int32, "luma modes")
            if my.shape[0] != t:
                raise ValueError("scan_encode: modes[log2][0] must be [T]")
            if mc is not None:
                _check(mc, torch.int32, "chroma modes")
                if mc.shape[0] != tc:
                    raise ValueError("scan_encode: modes[log2][1] must be "
                                     "[Tc]")
        a.size[log2 - 2] = _SizeArgs(
            p.pos.data_ptr(), p.avail.data_ptr(), p.cpos.data_ptr(),
            p.cavail.data_ptr(), _ptr(my), _ptr(mc), *(o.data_ptr()
                                                       for o in out))
    if work.widest:
        _launch("hh_scan_encode", "piipp", a, int(use_rdoq), work.widest,
                like=org_y)
        SCAN_ENCODE_LAUNCHES += 1
    return ry, rc, coef_y, coef_c, outs


def _scan_decode_c13(resi_y, resi_c, plans, work, modes, cmodes, bit_depth,
                     strong):
    global SCAN_DECODE_LAUNCHES
    _check(resi_y, torch.int32, "resi_y")
    _check(resi_c, torch.int32, "resi_c")
    dev = resi_y.device
    ry = torch.zeros_like(resi_y)
    rc = torch.zeros_like(resi_c)
    classes = {}
    for log2, p in plans.items():
        _plan_check(p)
        classes[0, log2] = _ClassArgs(_intra_tables(dev, p.n))
        if len(p.cidx):
            lc = _chroma_log2(log2)
            classes[1, lc] = _ClassArgs(_intra_tables(dev, 1 << lc))
    a = _scan_args(work, plans, _plane(ry, resi=resi_y),
                   _plane(rc, resi=resi_c), bit_depth, strong, classes)
    for log2, p in plans.items():
        my, mc = modes[log2], cmodes[log2]
        _check(my, torch.int32, "luma modes")
        _check(mc, torch.int32, "chroma modes")
        if my.shape[0] != len(p.vpos) or mc.shape[0] != len(p.cidx):
            raise ValueError("scan_decode: modes must be [T], cmodes [Tc]")
        a.size[log2 - 2] = _SizeArgs(
            p.pos.data_ptr(), p.avail.data_ptr(), p.cpos.data_ptr(),
            p.cavail.data_ptr(), my.data_ptr(), mc.data_ptr(), None, None,
            None)
    if work.widest:
        _launch("hh_scan_decode", "pipp", a, work.widest, like=resi_y)
        SCAN_DECODE_LAUNCHES += 1
    return ry, rc
