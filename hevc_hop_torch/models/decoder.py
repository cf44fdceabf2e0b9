"""HEVC decoder for I, ISS and PSS slices, on the card.

Counterpart of hevc_hop_tpu/models/decoder.py. Native C++ parses the slice
into dense maps; the residuals of every TU of the three planes are
dequantized and inverse-transformed by one launch of kernel C3's decode
entry, after one copy of the stacked level planes. I slices:
prediction plus residual runs as one launch of kernel C13's decode entry
(models/wavefront_scan.py). ISS slices: the MV-aware wavefront as one
launch of kernel C14's decode entry (models/ss_scan.py). PSS slices: the
MV-aware level loop of models/ss_scan.py, kernel C2 for the intra CUs,
kernel C8 for the self-similarity and the temporal ones (those out of the
previous picture) and kernel C11 for the GT (corner-warped) ones among
them. A PSS slice with no picture before it
(its reference lost) is decoded against a mid-grey picture, which is
appended to the pictures and recorded in ``concealed``. Deblocking is
kernel C4 (with the inter boundary strengths on ISS and PSS slices),
SAO's apply is kernel C6, and the checksum SEI is verified by kernel C1.
Every stream the reference encoder writes decodes.

``last_stats`` holds the last picture's stage times in seconds, each
ending in a synchronize on the card: ``parse_s`` (CABAC into the dense
maps), ``schedule_s``, ``residual_s`` (C3's dense residual), ``scan_s``
(the prediction wavefront), ``loopfilter_s`` (C4, C6) and, once its SEI
is read, ``checksum_s`` (C1).
"""
from __future__ import annotations

import collections
import time

import numpy as np
import torch

from hevc_hop_torch.bitstream import nal, params
from hevc_hop_torch.bitstream import sei as seimod
from hevc_hop_torch.common import rom
from hevc_hop_torch.common.types import NalUnitType, SliceType
from hevc_hop_torch.device import resolve
from hevc_hop_torch.entropy import ctx_layout, native
from hevc_hop_torch.io import yuv as yuvio
from hevc_hop_torch.models import ss_scan, wavefront, wavefront_scan
from hevc_hop_torch.ops import deblock, hashes, sao
from hevc_hop_torch.ops.tq import tq_decode_picture


# packed ISS decode schedules, keyed by device, geometry, leaves and the
# coded MVs' rectangles (bounded, least recently used out)
_SS_PLANS: collections.OrderedDict = collections.OrderedDict()


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to hevc_hop_torch yet: see ROADMAP.md")


def _dense_residual(maps, luma_pos: dict, chroma_pos: dict, qp: int,
                    bit_depth: int, dst4: bool, outs: tuple) -> None:
    """Dequant + inverse transform of every TU of the parsed level planes
    into ``outs`` (luma, cb, cr [H, W] int32 views; the reference's
    _residual_uniform / _residual_mixed): the stacked planes go to the
    card in one copy and kernel C3's decode entry takes all three planes
    in one launch. luma_pos and chroma_pos map each log2 to the [B, 2]
    positions of its TUs; dst4 picks the DST at 4x4 luma."""
    cp = torch.as_tensor(maps.coef).to(outs[0].device)
    ny, nc = maps.coef_y.size, maps.coef_cb.size
    qp_c = rom.chroma_qp_from_luma(qp)
    planes = [(cp[:ny].view(maps.coef_y.shape), outs[0], qp, dst4),
              (cp[ny:ny + nc].view(maps.coef_cb.shape), outs[1], qp_c,
               False),
              (cp[ny + nc:].view(maps.coef_cr.shape), outs[2], qp_c, False)]
    classes = [(0, lg, p) for lg, p in luma_pos.items()] + [
        (c, lg, p) for c in (1, 2) for lg, p in chroma_pos.items()]
    tq_decode_picture(planes, classes, bit_depth)


class Decoder:
    def __init__(self, device=None) -> None:
        self.device = resolve(device)
        self.sps = None
        self.pps = None
        self.vps = None
        self._pics_dev = []   # device (y, cb, cr) int32 triples
        self._pics_np = []    # lazily fetched host copies
        self.hash_ok = []     # per decoded-picture-hash SEI verification
        self.concealed = []   # indices of synthesized lost references
        self.sei_log = []     # (payload_type, parsed-or-raw)
        self.last_stats = {}  # stage seconds of the last picture

    @property
    def pictures_full(self) -> list:
        """Host (numpy int32) decoded pictures at the coded size."""
        for t in self._pics_dev[len(self._pics_np):]:
            self._pics_np.append(tuple(p.cpu().numpy().astype(np.int32)
                                       for p in t))
        return self._pics_np

    @property
    def pictures(self) -> list:
        """Output pictures with the SPS conformance window applied."""
        full = self.pictures_full
        cr_, cb_ = self.sps.conf_win_right, self.sps.conf_win_bottom
        if not (cr_ or cb_):
            return full
        uw = self.sps.pic_width - cr_
        uh = self.sps.pic_height - cb_
        return [(y[:uh, :uw], cb[:uh // 2, :uw // 2],
                 cr[:uh // 2, :uw // 2]) for (y, cb, cr) in full]

    def decode_stream(self, stream: bytes) -> list:
        """Decode an AnnexB stream; returns the list of (y, cb, cr)
        frames."""
        for (nal_type, rbsp) in nal.annexb_split(stream):
            if nal_type == NalUnitType.VPS_NUT:
                self.vps = params.parse_vps(rbsp)
            elif nal_type == NalUnitType.SPS_NUT:
                self.sps = params.parse_sps(rbsp)
            elif nal_type == NalUnitType.PPS_NUT:
                self.pps = params.parse_pps(rbsp)
            elif nal_type in (NalUnitType.IDR_W_RADL, NalUnitType.IDR_N_LP,
                              NalUnitType.CRA_NUT, NalUnitType.TRAIL_R):
                self._decode_slice(rbsp, nal_type)
            elif nal_type in (NalUnitType.PREFIX_SEI_NUT,
                              NalUnitType.SUFFIX_SEI_NUT):
                self._sei(rbsp)
        return self.pictures

    def _sei(self, rbsp: bytes) -> None:
        for msg in seimod.parse_sei(rbsp):
            if msg.payload_type == seimod.RECOVERY_POINT:
                self.sei_log.append(
                    ("recovery_point",
                     seimod.parse_recovery_point(msg.payload)))
            elif msg.payload_type == seimod.ACTIVE_PARAMETER_SETS:
                self.sei_log.append(
                    ("active_parameter_sets",
                     seimod.parse_active_parameter_sets(msg.payload)))
            elif msg.payload_type == seimod.USER_DATA_UNREGISTERED:
                self.sei_log.append(
                    ("user_data",
                     seimod.parse_user_data_unregistered(msg.payload)))
            if msg.payload_type == seimod.PICTURE_HASH and self._pics_dev:
                t0 = time.perf_counter()
                if msg.payload[0] == seimod.HASH_CHECKSUM:
                    # kernel C1 on the device planes: 4 bytes per plane
                    # leave the card
                    dig = hashes.checksum_digests(*self._pics_dev[-1],
                                                  self.sps.bit_depth)
                    self.hash_ok.append(msg.payload[1:] == b"".join(dig))
                else:
                    self.hash_ok.append(seimod.verify_picture_hash(
                        msg.payload, *self.pictures_full[-1],
                        self.sps.bit_depth))
                self.last_stats["checksum_s"] = time.perf_counter() - t0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _stage(self, key: str, t0: float) -> float:
        """Records the stage that began at t0 (after a synchronize on the
        card) and returns the time it ended."""
        self._sync()
        t1 = time.perf_counter()
        self.last_stats[key] = self.last_stats.get(key, 0.0) + t1 - t0
        return t1

    def _decode_slice(self, rbsp: bytes, nal_type: int) -> None:
        self.last_stats = {}
        t0 = time.perf_counter()
        sps, pps = self.sps, self.pps
        holo = bool(self.vps and self.vps.holo)
        sh = params.parse_slice_header(rbsp, sps, pps, nal_type, holo)
        if sh.slice_type not in (SliceType.I, SliceType.ISS, SliceType.PSS):
            raise _not_ported("P/B slices")
        w, h, bd = sps.pic_width, sps.pic_height, sps.bit_depth
        qp = sh.slice_qp
        holo_slice = sh.slice_type in (SliceType.ISS, SliceType.PSS)
        states = ctx_layout.init_states(int(sh.slice_type), qp)
        if holo_slice:
            # a PSS slice's signalled L0 count includes the SS reference,
            # which takes the last entry
            maps = native.decode_slice_data_ss(
                states, rbsp[sh.data_offset:], w, h, sps.ctb_log2,
                sps.max_transform_hierarchy_depth_intra, int(sh.slice_type),
                self.vps.holo_mi_size,
                *((sh.num_ref_wire,) if sh.slice_type == SliceType.PSS
                  else ()),
                sao_on=int(sps.sao_enabled), sbh=int(pps.sign_data_hiding))
        elif pps.entropy_coding_sync:
            data = rbsp[sh.data_offset:]
            ny = (h + (1 << sps.ctb_log2) - 1) >> sps.ctb_log2
            if len(sh.entry_offsets) != ny - 1:
                raise ValueError("WPP entry point count does not match the "
                                 "CTU rows")
            subs = nal.unwire_substream_sizes(data, sh.entry_offsets)
            maps = native.decode_slice_data_wpp(
                states, data, subs, w, h, sps.ctb_log2,
                max_hier_depth=sps.max_transform_hierarchy_depth_intra,
                sao_on=int(sps.sao_enabled), sbh=int(pps.sign_data_hiding))
        else:
            maps = native.decode_slice_data(
                states, rbsp[sh.data_offset:], w, h, sps.ctb_log2,
                max_hier_depth=sps.max_transform_hierarchy_depth_intra,
                sao_on=int(sps.sao_enabled), sbh=int(pps.sign_data_hiding))

        t0 = self._stage("parse_s", t0)
        # reconstruction structure = TRANSFORM blocks (prediction is per-TU)
        if holo_slice:
            sched = None
            leaves = np.array(wavefront.tu_blocks_from_maps(
                maps.depth8, maps.tu4, w, h, sps.ctb_log2),
                np.int32).reshape(-1, 3)
            luma_pos, chroma_pos = wavefront_scan.tu_positions(leaves,
                                                               self.device)
        else:
            sched = wavefront_scan.schedule(maps.depth8, maps.tu4, w, h,
                                            sps.ctb_log2, self.device)
            luma_pos, chroma_pos = sched.tu_pos
            sched.work    # C13's work list, built once per schedule
        t0 = self._stage("schedule_s", t0)
        pad = 1 << sps.ctb_log2
        hcp = h // 2 + pad
        dev = self.device
        resi_y = torch.zeros((h + pad, w), dtype=torch.int32, device=dev)
        resi_c = torch.zeros((2 * hcp, w // 2), dtype=torch.int32,
                             device=dev)
        # the DST is intra 4x4 luma's, on I and ISS slices
        _dense_residual(maps, luma_pos, chroma_pos, qp, bd,
                        sh.slice_type != SliceType.PSS,
                        (resi_y[:h], resi_c[:h // 2],
                         resi_c[hcp:hcp + h // 2]))
        self._stage("residual_s", t0)
        if sched is None:
            self._recon_ss(maps, leaves, qp, resi_y, resi_c, hcp)
        else:
            self._recon(maps, sched, qp, resi_y, resi_c, hcp)

    def _recon(self, maps, sched, qp, resi_y, resi_c, hcp) -> None:
        t0 = time.perf_counter()
        sps = self.sps
        w, h, bd = sps.pic_width, sps.pic_height, sps.bit_depth
        plans, nsteps = sched.plans, sched.nsteps
        modes, cmodes = {}, {}
        for log2, p in plans.items():
            px, py = p.vpos[:, 0], p.vpos[:, 1]
            m = maps.mode4[py // 4, px // 4].astype(np.int32)
            cm = maps.cmode8[py // 8, px // 8].astype(np.int32)
            if log2 == 2:
                # chroma DM of an NxN CU follows PU0's luma mode
                dm = maps.mode4[((py // 8) * 8) // 4,
                                ((px // 8) * 8) // 4].astype(np.int32)
            else:
                dm = m
            cmode = np.where(cm == 36, dm, cm)[p.cidx]
            t = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                          dtype=torch.int32,
                                          device=self.device)
            modes[log2], cmodes[log2] = t(m), t(cmode)
        ry, rc = wavefront_scan.scan_decode(
            resi_y, resi_c, plans, nsteps, modes, cmodes, bd,
            sps.strong_intra_smoothing, work=sched.work)
        t0 = self._stage("scan_s", t0)
        ry, rcb, rcr = ry[:h], rc[:h // 2], rc[hcp:hcp + h // 2]
        if not self.pps.deblocking_disabled:
            qp_c = rom.chroma_qp_from_luma(qp)
            ry, rcb, rcr = deblock.deblock_frame(
                ry, rcb, rcr, torch.as_tensor(maps.tu4, device=self.device),
                qp=qp, qp_c=qp_c, bit_depth=bd,
                beta_off=self.pps.beta_offset_div2,
                tc_off=self.pps.tc_offset_div2)
        if sps.sao_enabled:
            ry, rcb, rcr = sao.apply_sao_frame(
                ry, rcb, rcr, maps.sao_type, maps.sao_off, maps.sao_band,
                sps.ctb_log2, bd)
        self._stage("loopfilter_s", t0)
        self._pics_dev.append((ry, rcb, rcr))

    def _recon_ss(self, maps, leaves, qp, resi_y, resi_c, hcp) -> None:
        """ISS and PSS reconstruction: the wavefront over intra, SS,
        temporal and GT CUs, scheduled by the coded MVs' dependency
        rectangles (the reference's ``_recon_ss``: an SS CU's n window plus
        the interpolation margin, a GT CU's 2n window plus 2 samples of
        slack; a temporal CU reads the previous picture and waits on
        nothing), then deblocking with the inter boundary strengths and
        SAO."""
        t0 = time.perf_counter()
        sps = self.sps
        w, h, bd = sps.pic_width, sps.pic_height, sps.bit_depth
        pss = maps.slice_type == int(SliceType.PSS)
        ss_idx = maps.num_ref - 1
        lx, ly, lg = leaves[:, 0], leaves[:, 1], leaves[:, 2]
        n = (1 << lg).astype(np.int32)
        x4, y4 = lx // 4, ly // 4
        is_ss = (maps.pred4[y4, x4] == 0) & (maps.ref4[y4, x4] == ss_idx)
        mvx = maps.mv4x[y4, x4].astype(np.int32) >> 2
        mvy = maps.mv4y[y4, x4].astype(np.int32) >> 2
        gt = maps.gt8[ly // 8, lx // 8] != 0
        f = np.where(gt, 2, ss_scan.IFM)
        x0 = np.where(gt, lx + mvx - n // 2 - f, lx + mvx - f)
        y0 = np.where(gt, ly + mvy - n // 2 - f, ly + mvy - f)
        wh = np.where(gt, 2 * n + 2 * f, n + 2 * f)
        rects = np.where(is_ss[:, None], np.stack([x0, y0, wh, wh], -1),
                         0).astype(np.int32)
        key = (str(self.device), w, h, sps.ctb_log2, leaves.tobytes(),
               rects.tobytes(), maps.pred4.tobytes())
        hit = _SS_PLANS.get(key)
        if hit is None:
            sizes, data, nsteps = ss_scan.build_schedule_ss(
                leaves, w, h, sps.ctb_log2, radius=0, mv_rect=rects)
            inter = lambda log2, pos: maps.pred4[pos[:, 1] // 4,
                                                 pos[:, 0] // 4] == 0
            plans = ss_scan.pack_ss(sizes, data, hcp, self.device, None,
                                    inter)
            hit = (plans, nsteps, ss_scan.ss_work_list(plans, self.device))
            _SS_PLANS[key] = hit
            while len(_SS_PLANS) > 8:
                _SS_PLANS.popitem(last=False)
        else:
            _SS_PLANS.move_to_end(key)
        plans, nsteps, work = hit
        t0 = self._stage("schedule_s", t0)
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                      device=self.device)
        modes, cmodes, mvs, gts, tfs = {}, {}, {}, {}, {}
        for log2, p in plans.items():
            px, py = p.vpos[:, 0], p.vpos[:, 1]
            m = maps.mode4[py // 4, px // 4].astype(np.int32)
            cm = maps.cmode8[py // 8, px // 8].astype(np.int32)
            modes[log2] = t(m)
            cmodes[log2] = t(np.where(cm == 36, m, cm))
            mvs[log2] = t(np.stack([maps.mv4x[py // 4, px // 4],
                                    maps.mv4y[py // 4, px // 4]], -1))
            gtf = maps.gt8[py // 8, px // 8].astype(np.int32)
            gtv = np.where(gtf[:, None] != 0, maps.gtv8[py // 8, px // 8], 0)
            lvl = np.repeat(np.arange(len(p.cnt)), p.cnt)
            levels = lambda on: np.bincount(lvl, weights=on,
                                            minlength=len(p.cnt)) > 0
            gts[log2] = (t(gtf), t(gtv), levels(gtf != 0))
            if pss:
                inter = maps.pred4[py // 4, px // 4] == 0
                ssf = inter & (maps.ref4[py // 4, px // 4] == ss_idx)
                tf = inter & ~ssf
                tfs[log2] = (t(tf), t(ssf), levels(tf), levels(ssf))
        gt = gts if maps.gt8.any() else None
        if pss:
            ref_y, ref_c = self._reference(hcp)
            ry, rc = ss_scan.scan_decode_pss(
                resi_y, resi_c, ref_y, ref_c, plans, nsteps, modes, cmodes,
                mvs, tfs, bd, sps.strong_intra_smoothing, h, gt, work=work)
        else:
            ry, rc = ss_scan.scan_decode_ss(
                resi_y, resi_c, plans, nsteps, modes, cmodes, mvs, bd,
                sps.strong_intra_smoothing, h, gt, work=work)
        t0 = self._stage("scan_s", t0)
        ry, rcb, rcr = ry[:h], rc[:h // 2], rc[hcp:hcp + h // 2]
        if not self.pps.deblocking_disabled:
            dev = self.device
            m = lambda a: torch.as_tensor(a, device=dev)
            ry, rcb, rcr = deblock.deblock_frame(
                ry, rcb, rcr, m(maps.tu4), qp=qp,
                qp_c=rom.chroma_qp_from_luma(qp), bit_depth=bd,
                beta_off=self.pps.beta_offset_div2,
                tc_off=self.pps.tc_offset_div2, pred4=m(maps.pred4),
                cbf4=m(maps.cbf4_y), ref4=m(maps.ref4), mv4x=m(maps.mv4x),
                mv4y=m(maps.mv4y))
        if sps.sao_enabled:
            ry, rcb, rcr = sao.apply_sao_frame(
                ry, rcb, rcr, maps.sao_type, maps.sao_off, maps.sao_band,
                sps.ctb_log2, bd)
        self._stage("loopfilter_s", t0)
        self._pics_dev.append((ry, rcb, rcr))

    def _reference(self, hcp: int):
        """(luma [h, w], stacked cb/cr [2 hcp, w/2]) int32 of the previous
        picture, the temporal reference of a PSS slice. Without one (the
        reference was lost) a mid-grey picture stands in: it is appended to
        the pictures and its index to ``concealed``."""
        sps = self.sps
        w, h = sps.pic_width, sps.pic_height
        if not self._pics_dev:
            mid = 1 << (sps.bit_depth - 1)
            grey = tuple(torch.full(shape, mid, dtype=torch.int32,
                                    device=self.device)
                         for shape in ((h, w), (h // 2, w // 2),
                                       (h // 2, w // 2)))
            self._pics_dev.append(grey)
            self._pics_np.append(tuple(p.cpu().numpy() for p in grey))
            self.concealed.append(len(self._pics_dev) - 1)
        ry, rcb, rcr = self._pics_dev[-1]
        rc = torch.zeros((2 * hcp, w // 2), dtype=torch.int32,
                         device=self.device)
        rc[:h // 2] = rcb
        rc[hcp:hcp + h // 2] = rcr
        return ry.contiguous(), rc

    def picture_md5(self, idx: int = -1) -> bytes:
        # the decoded-picture hash covers the FULL coded picture
        y, cb, cr = self.pictures_full[idx]
        return yuvio.picture_md5(y, cb, cr, self.sps.bit_depth)
