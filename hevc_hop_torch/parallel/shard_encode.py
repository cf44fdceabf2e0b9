"""Mesh-sharded intra encode: frames x CTU-row bands.

Counterpart of hevc_hop_tpu/parallel/shard_encode.py. The single-device
encoder runs the whole-frame wavefront as one level loop
(models/wavefront_scan.scan_encode). Here the same loop runs over a
("frame", "band") mesh (parallel/mesh.py):

  frame axis : independent frames, pure data parallelism;
  band axis  : horizontal bands of CTU rows of one frame. Intra prediction
               reads at most ONE reconstructed row above a block, so each
               band keeps a one-row recon halo that is refreshed after
               every wavefront level. The levels are computed over the
               whole frame (native wavefront_levels), so a block that
               depends on the band above sits at a strictly later level
               than its producer and reads the halo only after the refresh
               that carried it: the sharded encode is bit-identical to the
               single-device one.

Every cell holds a slab of its band: luma row 0 the halo, rows 1..hb the
band, rows hb+1..hb+33 scratch (intra's bottom-left reads stay inside the
slab; the availability masks make them unavailable), and the chroma slab
cb and cr stacked with cr at ``hcoff = hb/2 + 2 + 16``. In a virtual mesh
every cell's slab is stacked into one plane. On the card the whole encode
is then one launch of kernel C13 in its banded form
(models/wavefront_scan.py ``scan_encode`` with :func:`halo_table`): the
block whose bottom row is its band's last row also writes that row into
the next band's halo, so no copy runs between levels. Its plain version is
the level loop: per (level, size, plane) one launch of kernels C2 and C3
over every frame and band, then the halo refresh, one indexed copy (on
CPU tensors). In a process mesh each rank holds its
own slab, runs the level loop and sends its band's last rows to the band
below with ``torch.distributed`` point-to-point operations after every
level.

After the loop each cell packs its band's recon, levels and dense mode and
cbf maps into one int32 row; the frame's band-0 cell gathers them, deblocks
the frame (C4), writes the checksum SEI (C1) and runs the native CABAC.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from hevc_hop_torch.bitstream import nal, params, sei
from hevc_hop_torch.common import rom
from hevc_hop_torch.common.types import NalUnitType, SliceType
from hevc_hop_torch.entropy import ctx_layout, native
from hevc_hop_torch.models import wavefront, wavefront_scan
from hevc_hop_torch.ops import deblock, hashes
from hevc_hop_torch.parallel.mesh import Mesh, build_mesh


def make_mesh(n_devices: int | None = None, band_par: int | None = None,
              device=None) -> Mesh:
    """("frame", "band") mesh; by default four bands where the cells are a
    multiple of four, else two where even, else one (the reference's
    rule)."""
    return build_mesh(n_devices, band_par,
                      lambda n: 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1),
                      ("frame", "band"), device)


def build_banded_schedule(leaves, w: int, h: int, ctb_log2: int,
                          nbands: int):
    """Banded schedule: blocks slotted per (global wavefront level, band).

    Returns (sizes, data, nsteps, hb) with data[log2] = dict(
    pos [S, R, B, 2] BAND-LOCAL coords (row 0 = halo, rows 1..hb = band,
    dummies target the scratch row hb+1), avail/availc from GLOBAL
    availability, valid [S, R, B], modes slot map gpos [S, R, B, 2]
    (global coords for mode lookup; dummies (0, h)))."""
    if h % (nbands << ctb_log2):
        raise ValueError("bands must be CTU-row aligned")
    hb = h // nbands
    arr = np.array(leaves, np.int32)
    levels = native.wavefront_levels(arr[:, 0], arr[:, 1], arr[:, 2],
                                     w, h, ctb_log2)
    nsteps = int(levels.max()) if len(levels) else 0
    zplane = wavefront.zaddr4_plane(w, h, ctb_log2)
    czplane = zplane[::2, ::2]
    sizes = tuple(sorted({int(l) for l in arr[:, 2]}))
    data = {}
    for log2 in sizes:
        n = 1 << log2
        sel = arr[:, 2] == log2
        lv = levels[sel] - 1
        pts = arr[sel][:, :2]
        band = pts[:, 1] // hb
        key = lv * nbands + band
        counts = np.bincount(key, minlength=nsteps * nbands)
        bmax = max(1, int(counts.max()))
        gpos = np.zeros((nsteps, nbands, bmax, 2), np.int32)
        gpos[..., 1] = h                       # global dummy -> (0, h)
        valid = np.zeros((nsteps, nbands, bmax), bool)
        slot = np.zeros(nsteps * nbands, np.int32)
        for j in np.argsort(key, kind="stable"):
            k = key[j]
            gpos[lv[j], band[j], slot[k]] = pts[j]
            valid[lv[j], band[j], slot[k]] = True
            slot[k] += 1
        flat = gpos.reshape(-1, 2)
        vmf = valid.reshape(-1)
        fv = flat[vmf]
        avail = np.zeros((flat.shape[0], 4 * n + 1), bool)
        avail[vmf] = wavefront.avail_mask(fv, n, zplane, w, h)
        availc = np.zeros((flat.shape[0], 2 * n + 1), bool)
        availc[vmf] = wavefront.avail_mask(fv // 2, n // 2, czplane,
                                           w // 2, h // 2)
        # band-local coords: y_loc = y - band*hb + 1 (halo row 0);
        # dummies -> scratch row hb+1
        bidx = np.arange(nbands)[None, :, None]
        y_loc = np.where(valid, gpos[..., 1] - bidx * hb + 1, hb + 1)
        x_loc = np.where(valid, gpos[..., 0], 0)
        pos = np.stack([x_loc, y_loc], -1).astype(np.int32)
        data[log2] = dict(
            pos=pos, gpos=gpos, valid=valid,
            avail=avail.reshape(nsteps, nbands, bmax, 4 * n + 1),
            availc=availc.reshape(nsteps, nbands, bmax, 2 * n + 1))
    return sizes, data, nsteps, hb


@dataclasses.dataclass
class Layout:
    """Slab geometry of one band (luma rows ``slab``, stacked chroma rows
    ``cslab``, cr at ``hcoff``) and the cells a process holds, as (frame,
    band) in stacking order."""
    w: int
    hb: int
    cells: list

    @property
    def hcb(self) -> int:
        return self.hb // 2

    @property
    def hcoff(self) -> int:
        return self.hb // 2 + 2 + 16

    @property
    def slab(self) -> int:
        return self.hb + 2 + 32

    @property
    def cslab(self) -> int:
        return 2 * self.hcoff


def pack_banded(sizes, data, lay: Layout, device) -> tuple:
    """The real slots of :func:`build_banded_schedule`'s output for the
    cells of ``lay``, stacked: cell c's slab starts at luma row c * slab
    and chroma row c * cslab. Returns (plans, maps): plans[log2] a
    wavefront_scan.SizePlan whose level s holds that level's blocks of
    every cell (chroma: the cb blocks, then the cr ones); maps[log2] the
    flat indices [T, u, u] of each block's 4x4 units and [T, v, v] of its
    8x8 units in the cells' stacked [C, hb/4, w/4] and [C, hb/8, w/8]
    maps."""
    bands = np.array([r for _, r in lay.cells], np.int64)
    cslot = np.arange(len(lay.cells))
    plans, maps = {}, {}
    t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                      device=device)
    for log2 in sizes:
        n = 1 << log2
        d = data[log2]
        s_i, c_i, b_i = np.nonzero(d["valid"][:, bands])
        nsteps = d["valid"].shape[0]
        lpos = d["pos"][s_i, bands[c_i], b_i]             # band-local
        pos = lpos + np.stack([np.zeros_like(c_i),
                               cslot[c_i] * lay.slab], -1)
        cnt = np.bincount(s_i, minlength=nsteps).astype(np.int64)
        off = np.concatenate([[0], np.cumsum(cnt)[:-1]]).astype(np.int64)
        coff = 2 * off
        cb_rows = coff[s_i] + np.arange(len(s_i)) - off[s_i]
        cr_rows = cb_rows + cnt[s_i]
        pc = np.stack([lpos[:, 0] // 2, (lpos[:, 1] - 1) // 2 + 1
                       + cslot[c_i] * lay.cslab], -1)
        cpos = np.zeros((2 * len(s_i), 2), np.int32)
        cpos[cb_rows] = pc
        cpos[cr_rows] = pc + np.array([0, lay.hcoff])
        plans[log2] = wavefront_scan.SizePlan(
            n=n, cnt=cnt, off=off, ccnt=cnt, coff=coff,
            pos=t(pos, torch.int32),
            avail=t(d["avail"][s_i, bands[c_i], b_i], torch.bool),
            cpos=t(cpos, torch.int32),
            cavail=t(d["availc"][s_i, bands[c_i], b_i], torch.bool),
            cidx=np.arange(len(s_i)), vpos=pos, cb_rows=cb_rows,
            cr_rows=cr_rows)
        ly = lpos[:, 1] - 1
        w4, w8 = lay.w // 4, lay.w // 8
        u, v = np.arange(n // 4), np.arange(n // 8)
        idx4 = (cslot[c_i] * (lay.hb // 4) * w4)[:, None, None] + (
            (ly // 4)[:, None, None] + u[None, :, None]) * w4 + (
            lpos[:, 0] // 4)[:, None, None] + u[None, None, :]
        idx8 = (cslot[c_i] * (lay.hb // 8) * w8)[:, None, None] + (
            (ly // 8)[:, None, None] + v[None, :, None]) * w8 + (
            lpos[:, 0] // 8)[:, None, None] + v[None, None, :]
        maps[log2] = (t(idx4, torch.int64), t(idx8, torch.int64),
                      t(cb_rows, torch.int64), t(cr_rows, torch.int64))
    return plans, maps


def halo_table(work, plans: dict, lay: Layout, nbands: int) -> np.ndarray:
    """[N, 3] int32: per item of ``work`` (models/wavefront_scan.py
    ``work_list`` of :func:`pack_banded`'s plans for the cells of ``lay``)
    and plane (luma, cb, cr), the row of the stacked plane that holds the
    next band's halo where the block's bottom row is its band's last (luma
    row hb of the slab, chroma rows hcb and hcoff + hcb of the cslab), else
    -1: the next band's row 0 (luma, cb) or hcoff (cr). The last band of a
    frame has none, and no row crosses into another frame."""
    items = work.host_items
    out = np.full((len(items), 3), -1, np.int32)
    at = {c: i for i, c in enumerate(lay.cells)}
    nxt = np.array([at.get((f, r + 1), -1) if r + 1 < nbands else -1
                    for f, r in lay.cells], np.int64)
    for log2, p in plans.items():
        sel = np.nonzero(items[:, 0] == log2)[0]
        if not len(sel):
            continue
        y = p.vpos[items[sel, 1], 1].astype(np.int64)
        cell = y // lay.slab
        dst = nxt[cell]
        out[sel, 0] = np.where(
            (y - cell * lay.slab + p.n - 1 == lay.hb) & (dst >= 0),
            dst * lay.slab, -1)
        nc = 4 if log2 == 2 else p.n // 2
        cy = p.cpos.cpu().numpy()[:, 1].astype(np.int64)
        for k, base in ((1, 0), (2, lay.hcoff)):
            r = items[sel, 2 + k]
            has = r >= 0
            yl = np.where(has, cy[np.maximum(r, 0)], 0) - cell * lay.cslab
            out[sel, k] = np.where(
                has & (yl + nc - 1 == base + lay.hcb) & (dst >= 0),
                dst * lay.cslab + base, -1)
    return out


class MeshIntraEncoder:
    """Frame x row-band mesh encoder producing the SAME streams as the
    single-device IntraEncoder in its uniform-CU, in-loop-RMD
    configuration.

    It refuses (ValueError) what the reference asserts against (no
    ``cu_log2``; bands that are not whole CTU rows; a width that is not a
    multiple of 8) and what the reference codes into a stream its own
    decoder rejects: ``sao=True`` (the SPS enables SAO, the slice data
    carries none) and ``wpp=True`` (the PPS signals WPP, the slice has no
    entry points). Like the reference it writes the checksum SEI whatever
    ``hash_type`` says."""

    def __init__(self, cfg, mesh: Mesh) -> None:
        from hevc_hop_torch.models.encoder import IntraEncoder
        if cfg.cu_log2 is None:
            raise ValueError("mesh encoder shares one static schedule: use "
                             "uniform cu_log2")
        if cfg.sao:
            raise ValueError("the mesh encoder codes no SAO syntax: "
                             "sao=True would enable SAO in the SPS of a "
                             "stream without it")
        if cfg.wpp:
            raise ValueError("the mesh encoder writes one substream: "
                             "wpp=True would signal entry points it has "
                             "not")
        self.nframes, self.nbands = mesh.shape
        if cfg.height % (self.nbands << cfg.ctb_log2) or cfg.width % 8:
            raise ValueError("bands must be whole CTU rows and the width a "
                             "multiple of 8")
        self.cfg = cfg
        self.mesh = mesh
        self.single = IntraEncoder(cfg, mesh.device)   # headers
        self._built = None
        self._banded = None
        self.last_recons = []
        self.last_halo_rows = {}

    def _build(self):
        if self._built is not None:
            return self._built
        cfg = self.cfg
        w, h = cfg.width, cfg.height
        depth8 = np.full((h // 8, w // 8), cfg.ctb_log2 - cfg.cu_log2,
                         np.uint8)
        leaves = wavefront.leaves_from_depth(depth8, w, h, cfg.ctb_log2)
        sizes, data, nsteps, hb = build_banded_schedule(
            leaves, w, h, cfg.ctb_log2, self.nbands)
        cells = ([(f, r) for f in range(self.nframes)
                  for r in range(self.nbands)] if self.mesh.virtual
                 else [self.mesh.cell])
        lay = Layout(w=w, hb=hb, cells=cells)
        plans, maps = pack_banded(sizes, data, lay, self.mesh.device)
        self._built = (lay, plans, maps, nsteps, depth8)
        return self._built

    def _banded_work(self, lay: Layout, plans: dict) -> tuple:
        """(work list, halo table on the device) of C13's banded form."""
        if self._banded is None:
            dev = self.mesh.device
            work = wavefront_scan.work_list(plans, dev)
            halo = halo_table(work, plans, lay, self.nbands)
            self._banded = (work, torch.as_tensor(halo, device=dev))
        return self._banded

    def _halo_refresh(self, lay: Layout):
        """The per-level refresh: band r's rows hb (luma), hcb and hcoff +
        hcb (chroma) become band r+1's rows 0 and 0, hcoff."""
        dev = self.mesh.device
        if self.mesh.virtual:
            pairs = [(i, lay.cells.index((f, r + 1)))
                     for i, (f, r) in enumerate(lay.cells)
                     if r + 1 < self.nbands]
            if not pairs:
                return None
            src, dst = (np.array(a, np.int64) for a in zip(*pairs))
            t = lambda a: torch.as_tensor(a, device=dev)
            ys, yd = t(src * lay.slab + lay.hb), t(dst * lay.slab)
            cs = t(np.concatenate([src * lay.cslab + lay.hcb,
                                   src * lay.cslab + lay.hcoff + lay.hcb]))
            cd = t(np.concatenate([dst * lay.cslab,
                                   dst * lay.cslab + lay.hcoff]))

            def refresh(ry, rc):
                ry.index_copy_(0, yd, ry.index_select(0, ys))
                rc.index_copy_(0, cd, rc.index_select(0, cs))
            return refresh
        f, r = self.mesh.cell
        if self.nbands == 1:
            return None
        group = self.mesh.group("band")
        w = lay.w
        recv = torch.empty(2 * w, dtype=torch.int32, device=dev)
        counted = self.last_halo_rows

        def exchange(ry, rc):
            ops = []
            if r + 1 < self.nbands:
                send = torch.cat([ry[lay.hb], rc[lay.hcb],
                                  rc[lay.hcoff + lay.hcb]])
                ops.append(dist.P2POp(dist.isend, send,
                                      self.mesh.rank_of(f, r + 1), group))
            if r > 0:
                ops.append(dist.P2POp(dist.irecv, recv,
                                      self.mesh.rank_of(f, r - 1), group))
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            if r > 0:
                ry[0] = recv[:w]
                rc[0] = recv[w:w + w // 2]
                rc[lay.hcoff] = recv[w + w // 2:]
                counted[(f, r)] += 1
        return exchange

    def slabs(self, frames: list, lay: Layout) -> tuple:
        """(org_y, org_c) int32 on the mesh's device: the cells' luma
        slabs and stacked chroma slabs of ``lay``, one over another (halo
        and scratch rows zero)."""
        hb, hcb, w = lay.hb, lay.hcb, lay.w
        org_y = np.zeros((len(lay.cells), lay.slab, w), np.int32)
        org_c = np.zeros((len(lay.cells), lay.cslab, w // 2), np.int32)
        for i, (f, r) in enumerate(lay.cells):
            y, cb, cr = frames[f]
            org_y[i, 1:hb + 1] = y[r * hb:(r + 1) * hb]
            org_c[i, 1:hcb + 1] = cb[r * hcb:(r + 1) * hcb]
            org_c[i, lay.hcoff + 1:lay.hcoff + hcb + 1] = cr[
                r * hcb:(r + 1) * hcb]
        up = lambda a: torch.as_tensor(a.reshape(-1, a.shape[-1])).to(
            self.mesh.device)
        return up(org_y), up(org_c)

    def _payload(self, lay, plans, maps, ry, rc, coef_y, coef_c, outs):
        """[C, L] int32: per cell its band's recon (y, cb, cr), levels (y,
        cb, cr) and dense maps (mode4, cbf4_y, cbf8_cb, cbf8_cr)."""
        dev = ry.device
        c, hb, hcb, w = len(lay.cells), lay.hb, lay.hcb, lay.w
        y_rows = lambda a: a.view(c, lay.slab, w)[:, 1:hb + 1]
        cb_rows = lambda a: a.view(c, lay.cslab, w // 2)[:, 1:hcb + 1]
        cr_rows = lambda a: a.view(c, lay.cslab, w // 2)[
            :, lay.hcoff + 1:lay.hcoff + hcb + 1]
        m4 = [torch.zeros(c * (hb // 4) * (w // 4), dtype=torch.int32,
                          device=dev) for _ in range(2)]
        m8 = [torch.zeros(c * (hb // 8) * (w // 8), dtype=torch.int32,
                          device=dev) for _ in range(2)]
        for log2 in plans:
            best, cbf, cbf_c = outs[log2]
            idx4, idx8, cbr, crr = maps[log2]
            m4[0][idx4] = best[:, None, None].expand_as(idx4)
            m4[1][idx4] = cbf[:, None, None].expand_as(idx4)
            m8[0][idx8] = cbf_c[cbr][:, None, None].expand_as(idx8)
            m8[1][idx8] = cbf_c[crr][:, None, None].expand_as(idx8)
        parts = [y_rows(ry), cb_rows(rc), cr_rows(rc), y_rows(coef_y),
                 cb_rows(coef_c), cr_rows(coef_c)] + m4 + m8
        return torch.cat([p.reshape(c, -1).to(torch.int32) for p in parts],
                         1)

    def _gather(self, payload) -> dict:
        """frame -> [R, L] payload rows of its bands, for the frames whose
        band-0 cell this process holds."""
        if self.mesh.virtual:
            rows = payload.view(self.nframes, self.nbands, -1)
            return {f: rows[f] for f in range(self.nframes)}
        f, r = self.mesh.cell
        if self.nbands == 1:
            return {f: payload}
        dst = self.mesh.rank_of(f, 0)
        got = ([torch.empty_like(payload[0]) for _ in range(self.nbands)]
               if r == 0 else None)
        dist.gather(payload[0], got, dst=dst, group=self.mesh.group("band"))
        return {f: torch.stack(got)} if r == 0 else {}

    def _frame_stream(self, rows, lay, depth8) -> tuple:
        """AnnexB stream and recon of one frame from its bands' payload
        rows [R, L]."""
        cfg = self.cfg
        w, h, hb, hcb = cfg.width, cfg.height, lay.hb, lay.hcb
        nb = self.nbands
        shapes = ([(hb, w)] + [(hcb, w // 2)] * 2) * 2 + [
            (hb // 4, w // 4)] * 2 + [(hb // 8, w // 8)] * 2
        parts, at = [], 0
        for sh in shapes:
            k = sh[0] * sh[1]
            parts.append(rows[:, at:at + k].reshape(nb * sh[0], sh[1]))
            at += k
        ry, rcb, rcr = parts[:3]
        qp_c = rom.chroma_qp_from_luma(cfg.qp)
        tu4 = np.full((h // 4, w // 4), cfg.cu_log2, np.uint8)
        if cfg.deblocking:
            ry, rcb, rcr = deblock.deblock_frame(
                ry.contiguous(), rcb.contiguous(), rcr.contiguous(),
                torch.as_tensor(tu4, device=rows.device), qp=cfg.qp,
                qp_c=qp_c, bit_depth=cfg.bit_depth)
        else:
            ry, rcb, rcr = (p.contiguous() for p in (ry, rcb, rcr))
        host = [p.cpu().numpy() for p in parts[3:]]
        maps = native.SliceMaps(w, h, cfg.ctb_log2, max_hier_depth=0)
        maps.sbh = int(cfg.sbh)
        maps.depth8[:] = depth8
        maps.tu4[:] = tu4
        maps.coef_y[:] = host[0]
        maps.coef_cb[:] = host[1]
        maps.coef_cr[:] = host[2]
        maps.mode4[:] = host[3]
        maps.cbf4_y[:] = host[4]
        maps.cbf8_cb[:] = host[5]
        maps.cbf8_cr[:] = host[6]
        enc = self.single
        sh = params.SliceHeader(slice_type=SliceType.I, slice_qp=cfg.qp)
        hw = params.write_slice_header(sh, enc.sps, enc.pps)
        states = ctx_layout.init_states(int(SliceType.I), cfg.qp)
        hw.write_bytes(native.encode_slice_data(states, maps))
        slice_nal = nal.make_nal(NalUnitType.IDR_W_RADL, hw.get_bytes())
        dig = hashes.checksum_digests(ry, rcb, rcr, cfg.bit_depth)
        sei_nal = nal.make_nal(
            NalUnitType.SUFFIX_SEI_NUT,
            sei.write_sei([sei.SEIMessage(
                sei.PICTURE_HASH,
                sei.make_picture_hash_payload(dig, sei.HASH_CHECKSUM))]))
        return (nal.annexb_wrap(enc.headers() + [slice_nal, sei_nal]),
                (ry, rcb, rcr))

    def encode_frames(self, frames: list) -> list:
        """frames: list of (y, cb, cr) numpy, one per frame of the mesh.
        Returns the AnnexB streams (bit-identical to IntraEncoder in the
        same uniform-CU configuration), on every rank of a process mesh.
        A virtual mesh on the card codes the frames in one launch of C13's
        banded form.
        ``last_recons`` holds each frame's (y, cb, cr) recon on the device
        where this process coded it (None for the frames of other ranks);
        ``last_halo_rows`` the halo rows each cell of this process
        received."""
        cfg = self.cfg
        if len(frames) != self.nframes:
            raise ValueError(f"{len(frames)} frames for a mesh of "
                             f"{self.nframes}")
        lay, plans, maps, nsteps, depth8 = self._build()
        org_y, org_c = self.slabs(frames, lay)
        dev = self.mesh.device
        self.last_halo_rows = {c: 0 for c in lay.cells}
        qp_c = rom.chroma_qp_from_luma(cfg.qp)
        if self.mesh.virtual and dev.type == "cuda":
            work, halo = self._banded_work(lay, plans)
            how = dict(work=work, halo=halo)
        else:
            how = dict(after_level=self._halo_refresh(lay))
        ry, rc, coef_y, coef_c, outs = wavefront_scan.scan_encode(
            org_y, org_c, plans, nsteps, cfg.qp, qp_c,
            cfg.bit_depth, cfg.strong_intra_smoothing, cfg.sbh, None,
            use_rdoq=cfg.rdoq, init_type=int(SliceType.I), **how)
        if self.mesh.virtual:
            for f, r in lay.cells:
                self.last_halo_rows[(f, r)] = nsteps if r else 0
        payload = self._payload(lay, plans, maps, ry, rc, coef_y, coef_c,
                                outs)
        mine = {f: self._frame_stream(rows, lay, depth8)
                for f, rows in self._gather(payload).items()}
        self.last_recons = [mine[f][1] if f in mine else None
                            for f in range(self.nframes)]
        if self.mesh.virtual:
            return [mine[f][0] for f in range(self.nframes)]
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, {f: s for f, (s, _) in mine.items()})
        streams = {}
        for part in every:
            streams.update(part)
        return [streams[f] for f in range(self.nframes)]
