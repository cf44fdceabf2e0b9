"""All-intra HEVC encoder (I slices, Main 8-bit), on the card.

Counterpart of hevc_hop_tpu/models/encoder.py for its uniform-CU path
(``cu_log2`` set, or ``mode_decision="rmd"``): every CU has one size, its
TU is the CU, and the intra mode is chosen inside the wavefront by 35-mode
SATD against the reconstructed references. The stages:

  1. the wavefront schedule of the fixed CU grid (host, cached);
  2. the level loop over kernels C2 (prediction, RMD) and C3 (transform,
     quant, SBH, recon) for luma and the stacked cb/cr plane
     (models/wavefront_scan.py);
  3. deblocking, kernel C4, and the checksum SEI, kernel C1;
  4. dense maps -> native C++ slice-data serializer -> NAL/AnnexB.

The reference's quadtree RD pre-pass, RDOQ and SAO are not ported yet and
raise NotImplementedError (ROADMAP.md queue 1).
"""
from __future__ import annotations

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
from hevc_hop_torch.models import wavefront_scan
from hevc_hop_torch.ops import deblock, hashes


@dataclasses.dataclass
class EncoderConfig:
    width: int = 64
    height: int = 64
    qp: int = 32
    bit_depth: int = 8
    ctb_log2: int = 5
    strong_intra_smoothing: bool = True
    deblocking: bool = True
    sao: bool = False
    # partition: None = quadtree DP (default); or fixed uniform CU log2
    cu_log2: int | None = None
    # mode decision: "analysis" (dense, original refs) or "rmd" (in-loop
    # SATD from recon refs)
    mode_decision: str = "analysis"
    # decoded-picture-hash SEI type (sei.HASH_CHECKSUM: kernel C1)
    hash_type: int = 2
    # RDOQ level decisions
    rdoq: bool = True
    # sign_data_hiding_enabled_flag
    sbh: bool = True
    # NxN intra at min CU (analysis mode decision only)
    nxn: bool = True
    # residual quadtree (analysis mode decision only)
    rqt: bool = True
    # entropy_coding_sync_enabled_flag: one CABAC substream per CTU row
    wpp: bool = False


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to hevc_hop_torch yet: see ROADMAP.md "
        "queue 1")


class IntraEncoder:
    def __init__(self, cfg: EncoderConfig, device=None) -> None:
        if cfg.cu_log2 is None and cfg.mode_decision != "rmd":
            raise _not_ported("the quadtree RD pre-pass (cu_log2=None with "
                              "mode_decision='analysis')")
        if cfg.rdoq:
            raise _not_ported("RDOQ (rdoq=True)")
        if cfg.sao:
            raise _not_ported("SAO (sao=True)")
        if cfg.cu_log2 is not None and not 3 <= cfg.cu_log2 <= cfg.ctb_log2:
            raise ValueError("cu_log2 must lie in [3, ctb_log2]")
        if cfg.width % 2 or cfg.height % 2:
            raise ValueError("4:2:0 needs even luma dimensions")
        self.device = resolve(device)
        # conformance window: code at the next multiple of MinCbSizeY and
        # signal the crop (H.265 7.4.3.2)
        self.user_w, self.user_h = cfg.width, cfg.height
        pw, ph = -cfg.width % 8, -cfg.height % 8
        self._pad = (pw, ph)
        if pw or ph:
            cfg = dataclasses.replace(cfg, width=cfg.width + pw,
                                      height=cfg.height + ph)
        self.cfg = cfg
        self.sps = params.SPS(
            pic_width=cfg.width, pic_height=cfg.height,
            bit_depth=cfg.bit_depth, ctb_log2=cfg.ctb_log2,
            max_transform_hierarchy_depth_intra=0, sao_enabled=False,
            conf_win_right=pw, conf_win_bottom=ph,
            strong_intra_smoothing=cfg.strong_intra_smoothing)
        self.pps = params.PPS(init_qp=26, sign_data_hiding=cfg.sbh,
                              entropy_coding_sync=cfg.wpp,
                              deblocking_disabled=not cfg.deblocking)
        self._recon_dev = None
        self._recon_np = None
        self.last_stats = {}

    def headers(self) -> list:
        vps = params.VPS()
        return [
            nal.make_nal(NalUnitType.VPS_NUT, params.write_vps(vps)),
            nal.make_nal(NalUnitType.SPS_NUT, params.write_sps(self.sps)),
            nal.make_nal(NalUnitType.PPS_NUT, params.write_pps(self.pps)),
        ]

    def _decide(self) -> np.ndarray:
        """depth8 [h/8, w/8] of the uniform CU grid."""
        cfg = self.cfg
        cu = cfg.cu_log2 if cfg.cu_log2 is not None else 3
        return np.full((cfg.height // 8, cfg.width // 8), cfg.ctb_log2 - cu,
                       np.uint8)

    def _schedule(self, depth8: np.ndarray) -> wavefront_scan.Schedule:
        """The wavefront schedule of the CU grid (its TUs are its CUs),
        cached per device and geometry."""
        cfg = self.cfg
        cu = cfg.cu_log2 if cfg.cu_log2 is not None else 3
        return wavefront_scan.schedule(
            depth8, np.full((cfg.height // 4, cfg.width // 4), cu, np.uint8),
            cfg.width, cfg.height, cfg.ctb_log2, self.device)

    @staticmethod
    def _scatter_outputs(maps, sched, outs) -> None:
        for log2, p in sched.plans.items():
            best, cbf_y, cbf_c = outs[log2]
            iy4, ix4, iy8, ix8 = sched.map_index[log2]
            maps.mode4[iy4, ix4] = best[:, None, None]
            maps.cbf4_y[iy4, ix4] = cbf_y[:, None, None]
            maps.cbf8_cb[iy8, ix8] = cbf_c[p.cb_rows][:, None, None]
            maps.cbf8_cr[iy8, ix8] = cbf_c[p.cr_rows][:, None, None]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def encode_frame(self, y: np.ndarray, cb: np.ndarray,
                     cr: np.ndarray) -> bytes:
        """Encode one frame; returns the AnnexB byte stream (with headers).
        The reconstruction stays on the device (recon_yuv fetches it).
        Per-stage wall-clock seconds land in self.last_stats; on the card
        each stage ends with a synchronize, so they are device times."""
        return self._stage2(self._stage1(y, cb, cr))

    def encode_frames(self, frames: list) -> list:
        """[(y, cb, cr), ...] -> [stream, ...], one frame after another."""
        return [self.encode_frame(*f) for f in frames]

    def _stage1(self, y, cb, cr) -> dict:
        stats = {}
        t0 = time.perf_counter()
        cfg = self.cfg
        w, h = cfg.width, cfg.height
        pw, ph = self._pad
        if pw or ph:    # conformance-window edge padding
            y = np.pad(np.asarray(y), ((0, ph), (0, pw)), mode="edge")
            cb = np.pad(np.asarray(cb), ((0, ph // 2), (0, pw // 2)),
                        mode="edge")
            cr = np.pad(np.asarray(cr), ((0, ph // 2), (0, pw // 2)),
                        mode="edge")
        depth8 = self._decide()
        sched = self._schedule(depth8)
        stats["decide_s"] = time.perf_counter() - t0

        maps = native.SliceMaps(w, h, cfg.ctb_log2, max_hier_depth=0)
        maps.sbh = int(cfg.sbh)
        maps.depth8[:] = depth8
        maps.part8[:] = 0
        maps.tu4[:] = sched.tu4

        pad = 1 << cfg.ctb_log2
        hc = h // 2
        hc_off = hc + pad
        udt = np.uint8 if cfg.bit_depth <= 8 else np.uint16
        org_y = np.zeros((h + pad, w), udt)
        org_y[:h] = y
        org_c = np.zeros((2 * hc_off, w // 2), udt)
        org_c[:hc] = cb
        org_c[hc_off:hc_off + hc] = cr
        qp = cfg.qp
        qp_c = rom.chroma_qp_from_luma(qp)

        t1 = time.perf_counter()
        up = lambda a: torch.as_tensor(a.astype(np.int32)).to(self.device)
        org_y_dev, org_c_dev = up(org_y), up(org_c)
        ry, rc, coef_y, coef_c, outs = wavefront_scan.scan_encode(
            org_y_dev, org_c_dev, sched.plans, sched.nsteps, qp, qp_c,
            cfg.bit_depth, cfg.strong_intra_smoothing, cfg.sbh)
        self._sync()
        stats["scan_s"] = time.perf_counter() - t1

        t1 = time.perf_counter()
        ry, rcb, rcr = ry[:h], rc[:hc], rc[hc_off:hc_off + hc]
        if cfg.deblocking:
            ry, rcb, rcr = deblock.deblock_frame(
                ry, rcb, rcr, sched.tu4_dev, qp=qp, qp_c=qp_c,
                bit_depth=cfg.bit_depth)
        self._sync()
        stats["loopfilter_s"] = time.perf_counter() - t1
        stats["_t0"] = t0
        return dict(maps=maps, sched=sched, stats=stats,
                    recon=(ry, rcb, rcr), coef=(coef_y, coef_c), outs=outs,
                    hc=hc, hc_off=hc_off, qp=qp)

    def _stage2(self, st: dict) -> bytes:
        cfg = self.cfg
        maps, stats = st["maps"], st["stats"]
        hc, hc_off, qp = st["hc"], st["hc_off"], st["qp"]
        h = cfg.height

        t1 = time.perf_counter()
        coef_y, coef_c = st["coef"]
        maps.coef_y[:] = coef_y[:h].cpu().numpy()
        cc = coef_c.cpu().numpy()
        maps.coef_cb[:] = cc[:hc]
        maps.coef_cr[:] = cc[hc_off:hc_off + hc]
        outs = {k: tuple(v.cpu().numpy() for v in o)
                for k, o in st["outs"].items()}
        stats["fetch_s"] = time.perf_counter() - t1

        stats["sao_s"] = 0.0
        self._recon_dev = st["recon"]
        self._recon_np = None

        t1 = time.perf_counter()
        self._scatter_outputs(maps, st["sched"], outs)
        stats["maps_s"] = time.perf_counter() - t1

        t1 = time.perf_counter()
        sh = params.SliceHeader(slice_type=SliceType.I, slice_qp=qp)
        states = ctx_layout.init_states(int(SliceType.I), qp)
        if cfg.wpp:
            payload, subs = native.encode_slice_data_wpp(states, maps)
            pos, wire = 0, []
            for s in subs[:-1]:
                wire.append(s + nal.ep_insert_count(payload[pos:pos + s]))
                pos += s
            sh.entry_offsets = wire
        else:
            payload = native.encode_slice_data(states, maps)
        hw = params.write_slice_header(sh, self.sps, self.pps)
        hw.write_bytes(payload)
        slice_nal = nal.make_nal(NalUnitType.IDR_W_RADL, hw.get_bytes())
        stats["entropy_s"] = time.perf_counter() - t1
        # decoded-picture-hash SEI
        if cfg.hash_type == sei.HASH_CHECKSUM:
            digests = hashes.checksum_digests(*self._recon_dev,
                                              cfg.bit_depth)
        elif cfg.hash_type == sei.HASH_CRC:
            digests = hashes.crc_digests(*self.recon_yuv, cfg.bit_depth)
        else:
            digests = sei.plane_md5s(*self.recon_yuv, cfg.bit_depth)
        sei_nal = nal.make_nal(
            NalUnitType.SUFFIX_SEI_NUT,
            sei.write_sei([sei.SEIMessage(
                sei.PICTURE_HASH,
                sei.make_picture_hash_payload(digests, cfg.hash_type))]))
        out = nal.annexb_wrap(self.headers() + [slice_nal, sei_nal])
        stats["total_s"] = time.perf_counter() - stats.pop("_t0")
        stats["bytes"] = len(out)
        self.last_stats = stats
        return out

    @property
    def recon_full(self):
        """Full coded-size reconstruction (before the conformance crop),
        as host int32 arrays."""
        if self._recon_np is None:
            self._recon_np = tuple(p.cpu().numpy().astype(np.int32)
                                   for p in self._recon_dev)
        return self._recon_np

    @property
    def recon_yuv(self):
        y, cb, cr = self.recon_full
        uw, uh = self.user_w, self.user_h
        return (y[:uh, :uw], cb[:uh // 2, :uw // 2],
                cr[:uh // 2, :uw // 2])

    def recon_md5(self) -> bytes:
        y, cb, cr = self.recon_full
        return yuvio.picture_md5(y, cb, cr, self.cfg.bit_depth)
