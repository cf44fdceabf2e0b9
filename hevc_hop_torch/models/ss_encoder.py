"""Lenslet light-field encoder: ISS and PSS slices with self-similarity
prediction.

Counterpart of hevc_hop_tpu/models/ss_encoder.py, with the GT warp
(``gt=True``, the reference's default) or without. ``encode_frame`` codes
an ISS picture; ``encode_sequence`` codes the low-delay holoscopic GOP: an
ISS picture, then PSS pictures whose L0 is [the previous picture's
filtered recon, the SS reference last]. The stages of a picture, each
timed in ``last_stats``:

  1. ``decide_s``: the quadtree pre-pass (models/ss_partition.py, kernels
     C5 and C9, on a PSS picture with the temporal arm) or the uniform CU
     grid; then the wavefront schedule (host, cached per partition);
  2. ``scan_s``: on an ISS picture one launch of kernel C14, the whole
     wavefront; on a PSS picture the level loop over kernels C2, C9, C10,
     C12 (GT on), C3, C8 and C11 (GT on) (models/ss_scan.py);
  3. ``loopfilter_s``: deblocking with the inter boundary strengths, C4;
  4. ``fetch_s``, ``maps_s``: level planes and per-block outputs to the
     host, the dense syntax maps;
  5. ``sao_s``: SAO statistics, host RDO and apply, C6;
  6. ``entropy_s``: native CABAC, NAL and the checksum SEI (C1).
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from hevc_hop_torch.bitstream import nal, params, sei
from hevc_hop_torch.common import rom
from hevc_hop_torch.common.types import NalUnitType, SliceType
from hevc_hop_torch.device import resolve
from hevc_hop_torch.entropy import ctx_layout, native
from hevc_hop_torch.io import yuv as yuvio
from hevc_hop_torch.models import partition, ss_partition, ss_scan, wavefront
from hevc_hop_torch.ops import deblock, hashes, sao


def _mi_avail(pos: np.ndarray, valid: np.ndarray, n: int, mi: int,
              ctb: int) -> np.ndarray:
    """Static availability of the three MI merge/AMVP candidates per
    scheduled block [S, B, 3] (getMILeftCand/Above/AboveLeft and the
    isMvInsidePic bound)."""
    if mi <= 0:
        return np.zeros(pos.shape[:2] + (3,), bool)
    d = -(((n + mi - 1) // mi) * mi) * 4          # qpel MI displacement
    x, y = pos[..., 0], pos[..., 1]
    ok_h = d >= (-ctb - 8 - x + 1) * 4
    ok_v = d >= (-ctb - 8 - y + 1) * 4
    left = (x % ctb != 0) & ok_h
    above = (y % ctb != 0) & ok_v
    al = (x % ctb != 0) & ok_h & ok_v
    return np.stack([left, above, al], -1) & valid[..., None]


@dataclasses.dataclass
class HoloConfig:
    width: int = 64
    height: int = 64
    qp: int = 32
    bit_depth: int = 8
    ctb_log2: int = 5
    cu_log2: int = 4            # uniform CU grid (when quadtree=False)
    quadtree: bool = False      # per-frame CU quadtree 8/16/32 from the
                                # batched RD pre-pass; CTB-aligned sizes
    search_range: int = 32      # SS full-search radius
    search_range_t: int = 16    # temporal ME radius (PSS frames)
    mi_size: int = 0            # micro-image size (0 = off)
    gt: bool = True             # GT/HOP corner-warp refinement
    strong_intra_smoothing: bool = True
    deblocking: bool = True
    sao: bool = False
    rdoq: bool = True
    sbh: bool = True
    hash_type: int = 2  # sei.HASH_CHECKSUM


class HoloEncoder:
    """Holoscopic encoder: ISS pictures, and the low-delay GOP of an ISS
    picture followed by PSS pictures."""

    def __init__(self, cfg: HoloConfig, device=None) -> None:
        if cfg.width % 8 or cfg.height % 8:
            raise ValueError("the picture must be a multiple of 8")
        if cfg.cu_log2 < 3:
            raise ValueError("ISS CUs are 8x8 or larger")
        ctb = 1 << cfg.ctb_log2
        if (cfg.sao or cfg.quadtree) and (cfg.width % ctb
                                          or cfg.height % ctb):
            raise ValueError("SAO and the quadtree need CTU-aligned sizes")
        if cfg.quadtree and cfg.ctb_log2 != 5:
            raise ValueError("the quadtree pre-pass needs ctb_log2 = 5")
        self.device = resolve(device)
        self.cfg = cfg
        self.sps = params.SPS(
            pic_width=cfg.width, pic_height=cfg.height,
            bit_depth=cfg.bit_depth, ctb_log2=cfg.ctb_log2,
            max_transform_hierarchy_depth_intra=0,
            sao_enabled=cfg.sao,
            strong_intra_smoothing=cfg.strong_intra_smoothing)
        self.pps = params.PPS(init_qp=26, sign_data_hiding=cfg.sbh,
                              deblocking_disabled=not cfg.deblocking)
        self.vps = params.VPS(holo=True, holo_mi_size=cfg.mi_size)
        self._prep_cache = collections.OrderedDict()
        self._recon_dev = None
        self._recon_np = None
        self.last_stats = {}

    def headers(self) -> list:
        return [
            nal.make_nal(NalUnitType.VPS_NUT, params.write_vps(self.vps)),
            nal.make_nal(NalUnitType.SPS_NUT, params.write_sps(self.sps)),
            nal.make_nal(NalUnitType.PPS_NUT, params.write_pps(self.pps)),
        ]

    def encode_sequence(self, frames: list) -> bytes:
        """The low-delay holoscopic GOP of ``frames`` [(y, cb, cr), ...]:
        an ISS IDR picture, then PSS trail pictures. Sets
        ``recon_history``, one recon per picture."""
        out = [self.encode_frame(*frames[0])]
        self.recon_history = [self.recon_yuv]
        for poc, (y, cb, cr) in enumerate(frames[1:], start=1):
            out.append(self._encode_pss(y, cb, cr, poc))
            self.recon_history.append(self.recon_yuv)
        return b"".join(out)

    def _prep(self, leaves=None, key=None):
        """Schedule, packed plans, causality planes and kernel C14's work
        list of a partition: (plans, nsteps, zmaxw, zmax2n, work), cached
        (bounded, least recently used out). leaves None: the uniform cu_log2
        grid."""
        if key in self._prep_cache:
            self._prep_cache.move_to_end(key)
            return self._prep_cache[key]
        cfg = self.cfg
        w, h = cfg.width, cfg.height
        n = 1 << cfg.cu_log2
        ctb = 1 << cfg.ctb_log2
        if leaves is None:
            leaves = [(x, yy, cfg.cu_log2)
                      for cy in range(0, h, ctb) for cx in range(0, w, ctb)
                      for yy in range(cy, min(cy + ctb, h), n)
                      for x in range(cx, min(cx + ctb, w), n)]
        sizes, data, nsteps = ss_scan.build_schedule_ss(
            leaves, w, h, cfg.ctb_log2, cfg.search_range)
        miav = {lg: _mi_avail(data[lg]["pos"], data[lg]["valid"], 1 << lg,
                              cfg.mi_size, ctb) for lg in sizes}
        plans = ss_scan.pack_ss(sizes, data, h // 2 + ctb, self.device,
                                miav)
        zmaxw = {lg: ss_scan.zmax_plane(w, h, cfg.ctb_log2, 1 << lg,
                                        self.device) for lg in sizes}
        zmax2n = ({lg: ss_scan.zmax_plane(w, h, cfg.ctb_log2, 2 << lg,
                                          self.device, ifm=2)
                   for lg in sizes} if cfg.gt else None)
        prep = (plans, nsteps, zmaxw, zmax2n,
                ss_scan.ss_work_list(plans, self.device))
        self._prep_cache[key] = prep
        while len(self._prep_cache) > 4:
            self._prep_cache.popitem(last=False)
        return prep

    def _frame_prep(self, y_dev: torch.Tensor, ref_y=None):
        """Per-frame partition and intra modes: (prep, mode4 or None for
        in-loop RMD); ref_y the previous picture's luma on a PSS one."""
        cfg = self.cfg
        if not cfg.quadtree:
            return self._prep(), None
        depth8, mode4 = ss_partition.decide(
            y_dev, cfg.qp, cfg.ctb_log2, cfg.search_range, cfg.mi_size,
            cfg.bit_depth, ref_y, cfg.search_range_t)
        self._depth8 = depth8
        leaves = wavefront.leaves_from_depth(depth8, cfg.width, cfg.height,
                                             cfg.ctb_log2)
        return self._prep(leaves, key=depth8.tobytes()), mode4

    def _xs_with_modes(self, plans: dict, mode4: np.ndarray) -> dict:
        """log2 -> the pre-pass's intra mode of each packed block."""
        return {lg: torch.as_tensor(
            mode4[p.vpos[:, 1] // 4, p.vpos[:, 0] // 4].astype(np.int32),
            device=self.device) for lg, p in plans.items()}

    def _upload(self, y, cb, cr):
        """(org_y [h+pad, w], org_c stacked [2(h/2+pad), w/2]) int32 on
        the device."""
        cfg = self.cfg
        w, h = cfg.width, cfg.height
        pad = 1 << cfg.ctb_log2
        hc, hc_off = h // 2, h // 2 + pad
        org_y = np.zeros((h + pad, w), np.int32)
        org_y[:h] = y
        org_c = np.zeros((2 * hc_off, w // 2), np.int32)
        org_c[:hc] = cb
        org_c[hc_off:hc_off + hc] = cr
        return (torch.as_tensor(org_y).to(self.device),
                torch.as_tensor(org_c).to(self.device))

    @staticmethod
    def _fetch_all(coef_y, coef_c, outs, h, hc_off):
        """Level planes and per-block outputs to the host."""
        hc = h // 2
        cc = coef_c.cpu().numpy()
        return (coef_y[:h].cpu().numpy(), cc[:hc], cc[hc_off:hc_off + hc],
                {k: tuple(v.cpu().numpy() for v in o)
                 for k, o in outs.items()})

    def _fill_maps(self, maps, plans, outs, pss: bool) -> None:
        """Dense syntax maps from the per-block outputs."""
        ctb_log2 = self.cfg.ctb_log2
        for log2, p in plans.items():
            if pss:
                (inter, refsel, mv, imode, cbf, cbf_b, cbf_r, gtflag,
                 gtc) = outs[log2]
            else:
                inter, mv, imode, cbf, cbf_b, cbf_r, gtflag, gtc = outs[log2]
            px, py = p.vpos[:, 0], p.vpos[:, 1]
            u4, u8 = p.n // 4, p.n // 8
            iy4 = py[:, None, None] // 4 + np.arange(u4)[None, :, None]
            ix4 = px[:, None, None] // 4 + np.arange(u4)[None, None, :]
            iy8 = py[:, None, None] // 8 + np.arange(u8)[None, :, None]
            ix8 = px[:, None, None] // 8 + np.arange(u8)[None, None, :]
            col = lambda v: v[:, None, None]
            iv = inter != 0
            maps.depth8[iy8, ix8] = ctb_log2 - log2
            maps.tu4[iy4, ix4] = log2
            maps.pred4[iy4, ix4] = col(np.where(iv, 0, 1).astype(np.uint8))
            maps.mode4[iy4, ix4] = col(np.where(iv, 1, imode).astype(
                np.uint8))
            maps.mv4x[iy4, ix4] = col(np.where(iv, mv[:, 0], 0).astype(
                np.int16))
            maps.mv4y[iy4, ix4] = col(np.where(iv, mv[:, 1], 0).astype(
                np.int16))
            maps.cbf4_y[iy4, ix4] = col(cbf.astype(np.uint8))
            if pss:
                maps.ref4[iy4, ix4] = col(np.where(iv, refsel, 0).astype(
                    np.uint8))
            maps.cbf8_cb[iy8, ix8] = col(cbf_b.astype(np.uint8))
            maps.cbf8_cr[iy8, ix8] = col(cbf_r.astype(np.uint8))
            gf = gtflag != 0
            maps.gt8[py // 8, px // 8] = gf.astype(np.uint8)
            maps.gtv8[py // 8, px // 8] = np.where(gf[:, None], gtc,
                                                   0).astype(np.int16)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def encode_frame(self, y: np.ndarray, cb: np.ndarray,
                     cr: np.ndarray) -> bytes:
        """Encode one ISS picture; returns the AnnexB stream (with
        headers). The recon stays on the device (recon_yuv fetches it).
        Per-stage wall-clock seconds land in self.last_stats; on the card
        each stage ends with a synchronize."""
        return self._encode_picture(y, cb, cr, 0)

    def _encode_pss(self, y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                    poc: int) -> bytes:
        """One PSS picture: L0 = [previous filtered recon, SS ref (last)];
        returns its slice and SEI NAL units."""
        return self._encode_picture(y, cb, cr, poc)

    def _encode_picture(self, y, cb, cr, poc: int) -> bytes:
        cfg = self.cfg
        pss = poc > 0
        stats = {}
        t0 = time.perf_counter()
        w, h = cfg.width, cfg.height
        qp, qp_c = cfg.qp, rom.chroma_qp_from_luma(cfg.qp)
        hc, hc_off = h // 2, h // 2 + (1 << cfg.ctb_log2)
        org_y, org_c = self._upload(y, cb, cr)
        ref = None
        if pss:
            ref_y, ref_cb, ref_cr = self._recon_dev
            ref_c = torch.zeros_like(org_c)
            ref_c[:hc] = ref_cb
            ref_c[hc_off:hc_off + hc] = ref_cr
            ref = (ref_y.contiguous(), ref_c)
        self._sync()
        stats["upload_s"] = time.perf_counter() - t0

        t1 = time.perf_counter()
        (plans, nsteps, zmaxw, zmax2n, work), mode4 = self._frame_prep(
            org_y[:h], None if ref is None else ref[0])
        modes = None if mode4 is None else self._xs_with_modes(plans, mode4)
        self._sync()
        stats["decide_s"] = time.perf_counter() - t1

        t1 = time.perf_counter()
        args = (plans, nsteps, zmaxw, qp, qp_c, cfg.bit_depth,
                cfg.strong_intra_smoothing, w, h, cfg.search_range)
        tail = (cfg.mi_size, cfg.rdoq, cfg.sbh, modes, zmax2n)
        if pss:
            ry, rc, coef_y, coef_c, outs = ss_scan.scan_encode_pss(
                org_y, org_c, *ref, *args, cfg.search_range_t, *tail,
                work=work)
        else:
            ry, rc, coef_y, coef_c, outs = ss_scan.scan_encode_iss(
                org_y, org_c, *args, *tail, work=work)
        self._sync()
        stats["scan_s"] = time.perf_counter() - t1

        t1 = time.perf_counter()
        stype = SliceType.PSS if pss else SliceType.ISS
        maps = native.SliceMaps(w, h, cfg.ctb_log2, max_hier_depth=0)
        maps.slice_type = int(stype)
        maps.sbh = int(cfg.sbh)
        maps.mi_size = cfg.mi_size
        if pss:
            maps.num_ref = 2   # [temporal, SS (last)]
        cy_np, ccb_np, ccr_np, outs_np = self._fetch_all(coef_y, coef_c,
                                                         outs, h, hc_off)
        maps.coef_y[:] = cy_np
        maps.coef_cb[:] = ccb_np
        maps.coef_cr[:] = ccr_np
        stats["fetch_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        self._fill_maps(maps, plans, outs_np, pss)
        stats["maps_s"] = time.perf_counter() - t1

        t1 = time.perf_counter()
        ry, rcb, rcr = ry[:h], rc[:hc], rc[hc_off:hc_off + hc]
        if cfg.deblocking:
            dev = self.device
            m = lambda a: torch.as_tensor(a, device=dev)
            ry, rcb, rcr = deblock.deblock_frame(
                ry, rcb, rcr, m(maps.tu4), qp=qp, qp_c=qp_c,
                bit_depth=cfg.bit_depth, pred4=m(maps.pred4),
                cbf4=m(maps.cbf4_y), ref4=m(maps.ref4), mv4x=m(maps.mv4x),
                mv4y=m(maps.mv4y))
        self._sync()
        stats["loopfilter_s"] = time.perf_counter() - t1

        t1 = time.perf_counter()
        if cfg.sao:
            st = sao.stats_dispatch(
                (org_y[:h], org_c[:hc], org_c[hc_off:hc_off + hc]),
                (ry, rcb, rcr), cfg.ctb_log2, cfg.bit_depth)
            st = sao.fetch_stats(st)
            ry, rcb, rcr = sao.choose_apply(
                st, (ry, rcb, rcr), maps, cfg.ctb_log2,
                partition.full_lambda(qp), cfg.bit_depth)
            self._sync()
        self._recon_dev = (ry, rcb, rcr)
        self._recon_np = None
        stats["sao_s"] = time.perf_counter() - t1

        t1 = time.perf_counter()
        self.last_maps = maps
        if pss:
            sh = params.SliceHeader(slice_type=stype, slice_qp=qp, idr=False,
                                    poc=poc, num_ref_wire=maps.num_ref)
        else:
            sh = params.SliceHeader(slice_type=stype, slice_qp=qp)
        hw = params.write_slice_header(sh, self.sps, self.pps)
        states = ctx_layout.init_states(int(stype), qp)
        hw.write_bytes(native.encode_slice_data_ss(states, maps))
        if pss:
            slice_nal = nal.make_nal(NalUnitType.TRAIL_R, hw.get_bytes())
            out = nal.annexb_wrap([slice_nal, self._hash_sei()])
        else:
            slice_nal = nal.make_nal(NalUnitType.IDR_W_RADL, hw.get_bytes())
            out = nal.annexb_wrap(self.headers()
                                  + [slice_nal, self._hash_sei()])
        stats["entropy_s"] = time.perf_counter() - t1
        stats["total_s"] = time.perf_counter() - t0
        stats["bytes"] = len(out)
        stats["levels"] = int(sum(np.any(
            [p.cnt > 0 for p in plans.values()], 0)))
        self.last_stats = stats
        return out

    @property
    def recon_yuv(self):
        if self._recon_np is None:
            self._recon_np = tuple(p.cpu().numpy().astype(np.int32)
                                   for p in self._recon_dev)
        return self._recon_np

    def _hash_sei(self) -> bytes:
        if self.cfg.hash_type == sei.HASH_CHECKSUM:
            digests = hashes.checksum_digests(*self._recon_dev,
                                              self.cfg.bit_depth)
        elif self.cfg.hash_type == sei.HASH_CRC:
            digests = hashes.crc_digests(*self.recon_yuv, self.cfg.bit_depth)
        else:
            digests = sei.plane_md5s(*self.recon_yuv, self.cfg.bit_depth)
        return nal.make_nal(
            NalUnitType.SUFFIX_SEI_NUT,
            sei.write_sei([sei.SEIMessage(
                sei.PICTURE_HASH,
                sei.make_picture_hash_payload(digests,
                                              self.cfg.hash_type))]))

    def recon_md5(self) -> bytes:
        y, cb, cr = self.recon_yuv
        return yuvio.picture_md5(y, cb, cr, self.cfg.bit_depth)
