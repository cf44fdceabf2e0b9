"""All-intra HEVC encoder (I slices, Main and Main10), on the card.

Counterpart of hevc_hop_tpu/models/encoder.py. The stages:

  1. partition and mode decision: the RD pre-pass over every block of every
     CU size and the quadtree / NxN / residual-quadtree choice, kernel C5
     (models/partition.py); or, with ``cu_log2`` set or
     ``mode_decision="rmd"``, a uniform CU grid whose modes are chosen
     inside the wavefront by 35-mode SATD. Then the wavefront schedule of
     the chosen transform blocks (host, cached per structure);
  2. the wavefront of every block, one launch of kernel C13 on the card
     (models/wavefront_scan.py): per block C2's prediction and C3's
     transform, RDOQ or the dead-zone quantizer, SBH and recon, for luma
     and the stacked cb/cr plane (on the CPU, the level loop over their
     plain versions);
  3. deblocking, kernel C4; SAO statistics, host RDO and apply, kernel C6
     (ops/sao.py); the checksum SEI, kernel C1;
  4. dense maps -> native C++ slice-data serializer -> NAL/AnnexB.

Stages 1-3's device work (``_stage1``) is enqueued without a wait past the
decision's fetch, and ends with the frame's results copied to pinned host
tensors behind one event; the host work (``_stage2``: the SAO decision,
stage 4, the checksum) waits on that event alone. ``encode_frames`` runs
frame i+1's ``_stage1`` before frame i's ``_stage2``, so the card codes
one frame while the host finishes the other.
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
from hevc_hop_torch.models import partition, wavefront_scan
from hevc_hop_torch.ops import deblock, hashes, sao


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


class _StageClock:
    """A frame's stage times. ``mark(name)`` starts stage ``name`` and ends
    the one before (``None`` starts none). On the card a mark is a CUDA
    event recorded on the stream, so the clock never waits: read
    :meth:`seconds` once the stream has passed the last mark. On the CPU,
    where each stage runs as it is called, a mark reads the host's
    clock."""

    def __init__(self, device: torch.device) -> None:
        self.stream = (torch.cuda.current_stream(device)
                       if device.type == "cuda" else None)
        self.marks = []

    def mark(self, name) -> None:
        if self.stream is None:
            t = time.perf_counter()
        else:
            t = torch.cuda.Event(enable_timing=True)
            t.record(self.stream)
        self.marks.append((name, t))

    def seconds(self) -> dict:
        """{stage name: seconds from its mark to the next}."""
        return {name: (b - a if self.stream is None
                       else a.elapsed_time(b) / 1e3)
                for (name, a), (_, b) in zip(self.marks, self.marks[1:])
                if name is not None}


class IntraEncoder:
    def __init__(self, cfg: EncoderConfig, device=None) -> None:
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
        ctb = 1 << cfg.ctb_log2
        if cfg.sao and (cfg.width % ctb or cfg.height % ctb):
            raise ValueError("SAO statistics need CTU-aligned dimensions "
                             "(pad the input)")
        # the RD pre-pass decides partition and modes; its quadtree is the
        # 32/16/8 one of a 32x32 CTU
        self._analysis = (cfg.cu_log2 is None
                          and cfg.mode_decision == "analysis")
        if self._analysis and cfg.ctb_log2 != 5:
            raise ValueError("the quadtree RD pre-pass needs ctb_log2 = 5")
        self._use_rqt = cfg.rqt and self._analysis
        self.sps = params.SPS(
            pic_width=cfg.width, pic_height=cfg.height,
            bit_depth=cfg.bit_depth, ctb_log2=cfg.ctb_log2,
            max_transform_hierarchy_depth_intra=1 if self._use_rqt else 0,
            sao_enabled=cfg.sao,
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

    def _decide(self, y_dev: torch.Tensor, decisions=None):
        """Partition and shared mode decision of the luma plane y_dev
        [h, w] int32 on the device. Returns (depth8 [h/8, w/8] uint8
        (ctb_log2 - 2 = NxN), mode4 [h/4, w/4] int32 or None for in-loop
        RMD, tulog8 [h/8, w/8] uint8 TU log2 per cell or None where every
        TU is its CU). ``decisions`` = (depth8, mode4, tulog8) given from
        outside replaces the pre-pass."""
        cfg = self.cfg
        w, h = cfg.width, cfg.height
        if not self._analysis:
            cu = cfg.cu_log2 if cfg.cu_log2 is not None else 3
            return (np.full((h // 8, w // 8), cfg.ctb_log2 - cu, np.uint8),
                    None, None)
        if decisions is not None:
            depth, mode4, tulog8 = decisions
            return (np.asarray(depth, np.uint8), np.asarray(mode4, np.int32),
                    None if tulog8 is None else np.asarray(tulog8, np.uint8))
        # true-RD analysis at every CU size on a 32-aligned padded copy
        pw, ph = -w % 32, -h % 32
        if pw or ph:    # edge padding
            rows = torch.arange(h + ph, device=y_dev.device).clamp(max=h - 1)
            cols = torch.arange(w + pw, device=y_dev.device).clamp(max=w - 1)
            y_dev = y_dev[rows][:, cols].contiguous()
        qp, bd = cfg.qp, cfg.bit_depth
        rd8, m8 = partition.rd_costs(y_dev, 8, qp, bd)
        rd16, m16 = partition.rd_costs(y_dev, 16, qp, bd)
        rd32, m32 = partition.rd_costs(y_dev, 32, qp, bd)
        tulog8 = None
        if self._use_rqt:
            rd4, m4 = partition.rd_costs(y_dev, 4, qp, bd)
            if not cfg.nxn:
                rd4 = rd4 + 1e18   # the NxN arm never wins
            up2 = lambda a: a.repeat_interleave(2, 0).repeat_interleave(
                2, 1).contiguous()
            rd8f16 = partition.rd_costs_forced(y_dev, up2(m16), 8, qp, bd)
            rd16f32 = partition.rd_costs_forced(y_dev, up2(m32), 16, qp, bd)
            depth, mode4, tulog8 = partition.decide_rqt(
                rd4, rd8, rd16, rd32, rd8f16, rd16f32, m4, m8, m16, m32, qp)
            tulog8 = tulog8[:h // 8, :w // 8].cpu().numpy().astype(np.uint8)
        elif cfg.nxn:
            rd4, m4 = partition.rd_costs(y_dev, 4, qp, bd)
            depth, mode4 = partition.decide_nxn(
                rd4, rd8, rd16, rd32, m4, m8, m16, m32, qp)
        else:
            depth, mode8 = partition.decide(rd8, rd16, rd32, m8, m16, m32,
                                            qp)
            mode4 = mode8.repeat_interleave(2, 0).repeat_interleave(2, 1)
        return (depth[:h // 8, :w // 8].cpu().numpy().astype(np.uint8),
                mode4[:h // 4, :w // 4].cpu().numpy().astype(np.int32),
                tulog8)

    def _schedule(self, depth8: np.ndarray,
                  tulog8=None) -> wavefront_scan.Schedule:
        """The wavefront schedule of the transform blocks of the CU
        structure depth8 (ctb_log2 - 2 = NxN: four 4x4 TUs), split once
        more where tulog8 says so; cached per device and structure."""
        cfg = self.cfg
        if tulog8 is None:
            tulog8 = (cfg.ctb_log2 - depth8.astype(np.int32)).astype(np.uint8)
        return wavefront_scan.schedule(
            np.minimum(depth8, cfg.ctb_log2 - 3),
            np.repeat(np.repeat(tulog8, 2, 0), 2, 1),
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

    def _given_modes(self, sched, mode4: np.ndarray) -> dict:
        """log2 -> (luma modes [T], chroma modes [Tc] or None) on the
        device, in the packed order of the schedule's plans. An NxN CU's
        chroma TU, carried by its fourth PU, takes PU0's luma mode (the DM
        slot); elsewhere chroma follows its block's luma mode."""
        up = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                       dtype=torch.int32, device=self.device)
        out = {}
        for log2, p in sched.plans.items():
            px, py = p.vpos[:, 0], p.vpos[:, 1]
            cm = None
            if log2 == 2:
                cx, cy = px[p.cidx], py[p.cidx]
                cm = up(mode4[(cy // 8) * 2, (cx // 8) * 2])
            out[log2] = (up(mode4[py // 4, px // 4]), cm)
        return out

    def encode_frame(self, y: np.ndarray, cb: np.ndarray,
                     cr: np.ndarray) -> bytes:
        """Encode one frame; returns the AnnexB byte stream (with headers).
        The reconstruction stays on the device (recon_yuv fetches it).
        Per-stage seconds land in self.last_stats: the device stages'
        (upload_s, decide_s, scan_s, loopfilter_s) from CUDA events on the
        stream, the host stages' (fetch_s, sao_s, maps_s, entropy_s,
        checksum_s) from the host's clock."""
        return self._stage2(self._stage1(y, cb, cr))

    def encode_frames(self, frames: list) -> list:
        """[(y, cb, cr), ...] -> [stream, ...], byte for byte those of
        per-frame encode_frame calls, as a two-stage pipeline: frame i+1's
        device programs (:meth:`_stage1`) are enqueued before frame i's
        host work (:meth:`_stage2`: the SAO decision and CABAC), so the
        card runs the one while the host does the other. Afterwards
        recon_yuv holds the last frame's reconstruction."""
        out, pend = [], None
        for (y, cb, cr) in frames:
            st = self._stage1(y, cb, cr)
            if pend is not None:
                out.append(self._stage2(pend))
            pend = st
        if pend is not None:
            out.append(self._stage2(pend))
        return out

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of t in a host tensor of its own: from the card pinned
        and enqueued without waiting (read it once the frame's ``ready``
        event is complete), on the CPU a plain copy."""
        cuda = self.device.type == "cuda"
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda)
        return out.copy_(t, non_blocking=cuda)

    def _stage1(self, y, cb, cr, decisions=None) -> dict:
        """Upload, decision, wavefront, loop filters and SAO statistics,
        all enqueued, then the frame's results enqueued to pinned host
        tensors of its own and one event recorded behind them. Nothing
        here waits for the card but the decision's fetch. ``decisions`` =
        (depth8, mode4, tulog8), as :meth:`_decide` returns them, replaces
        the RD pre-pass."""
        t0 = time.perf_counter()
        clock = _StageClock(self.device)
        cfg = self.cfg
        w, h = cfg.width, cfg.height
        pw, ph = self._pad
        if pw or ph:    # conformance-window edge padding
            y = np.pad(np.asarray(y), ((0, ph), (0, pw)), mode="edge")
            cb = np.pad(np.asarray(cb), ((0, ph // 2), (0, pw // 2)),
                        mode="edge")
            cr = np.pad(np.asarray(cr), ((0, ph // 2), (0, pw // 2)),
                        mode="edge")
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
        up = lambda a: torch.as_tensor(a.astype(np.int32)).to(self.device)
        clock.mark("upload_s")
        org_y_dev, org_c_dev = up(org_y), up(org_c)

        # the decision ends with its fetch, so the stream waits while the
        # host builds the schedule: decide_s spans both
        clock.mark("decide_s")
        depth8, mode4, tulog8 = self._decide(org_y_dev[:h], decisions)
        sched = self._schedule(depth8, tulog8)
        modes = None if mode4 is None else self._given_modes(sched, mode4)
        clock.mark(None)

        maps = native.SliceMaps(
            w, h, cfg.ctb_log2,
            max_hier_depth=self.sps.max_transform_hierarchy_depth_intra)
        maps.sbh = int(cfg.sbh)
        # depth ctb_log2 - 2 = NxN: the CU is the min CU, part_mode = NxN
        maps.depth8[:] = np.minimum(depth8, cfg.ctb_log2 - 3)
        maps.part8[:] = np.where(depth8 == cfg.ctb_log2 - 2, 3, 0)
        maps.tu4[:] = sched.tu4

        clock.mark("scan_s")
        ry, rc, coef_y, coef_c, outs = wavefront_scan.scan_encode(
            org_y_dev, org_c_dev, sched.plans, sched.nsteps, qp, qp_c,
            cfg.bit_depth, cfg.strong_intra_smoothing, cfg.sbh, modes,
            use_rdoq=cfg.rdoq, init_type=int(SliceType.I), work=sched.work)

        clock.mark("loopfilter_s")
        ry, rcb, rcr = ry[:h], rc[:hc], rc[hc_off:hc_off + hc]
        if cfg.deblocking:
            ry, rcb, rcr = deblock.deblock_frame(
                ry, rcb, rcr, sched.tu4_dev, qp=qp, qp_c=qp_c,
                bit_depth=cfg.bit_depth)
        sao_stats = None
        if cfg.sao:
            # the originals are the planes already on the device
            sao_stats = sao.stats_dispatch(
                (org_y_dev[:h], org_c_dev[:hc],
                 org_c_dev[hc_off:hc_off + hc]), (ry, rcb, rcr),
                cfg.ctb_log2, cfg.bit_depth)
        clock.mark(None)
        # the frame's results leave the card in one set of copies behind
        # one event, which _stage2 waits on; the device tensors they come
        # from may be reused by the next frame's programs, which the
        # stream runs after these copies
        host = dict(
            coef=(self._to_host(coef_y[:h]), self._to_host(coef_c)),
            outs={k: tuple(self._to_host(v) for v in o)
                  for k, o in outs.items()},
            sao=(None if sao_stats is None
                 else self._to_host(sao_stats.packed)))
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        return dict(maps=maps, sched=sched, recon=(ry, rcb, rcr),
                    host=host, ready=ready, clock=clock, t0=t0,
                    hc=hc, hc_off=hc_off, qp=qp)

    def _stage2(self, st: dict) -> bytes:
        """Frame ``st``'s results read once its event is complete, the
        host's SAO decision and the C6 apply, the dense maps, CABAC and
        the checksum SEI."""
        cfg = self.cfg
        maps = st["maps"]
        hc, hc_off, qp = st["hc"], st["hc_off"], st["qp"]

        t1 = time.perf_counter()
        if st["ready"] is not None:
            st["ready"].synchronize()
        host = st["host"]
        coef_y, coef_c = host["coef"]
        maps.coef_y[:] = coef_y.numpy()
        cc = coef_c.numpy()
        maps.coef_cb[:] = cc[:hc]
        maps.coef_cr[:] = cc[hc_off:hc_off + hc]
        outs = {k: tuple(v.numpy() for v in o)
                for k, o in host["outs"].items()}
        sao_np = None if host["sao"] is None else sao.host_stats(host["sao"])
        stats = st["clock"].seconds()
        stats["fetch_s"] = time.perf_counter() - t1

        t1 = time.perf_counter()
        recon = st["recon"]
        if sao_np is not None:
            recon = sao.choose_apply(sao_np, recon, maps, cfg.ctb_log2,
                                     partition.full_lambda(qp),
                                     cfg.bit_depth)
        self._recon_dev = recon
        self._recon_np = None
        stats["sao_s"] = time.perf_counter() - t1

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
        t1 = time.perf_counter()
        if cfg.hash_type == sei.HASH_CHECKSUM:
            digests = hashes.checksum_digests(*self._recon_dev,
                                              cfg.bit_depth)
        elif cfg.hash_type == sei.HASH_CRC:
            digests = hashes.crc_digests(*self.recon_yuv, cfg.bit_depth)
        else:
            digests = sei.plane_md5s(*self.recon_yuv, cfg.bit_depth)
        stats["checksum_s"] = time.perf_counter() - t1
        sei_nal = nal.make_nal(
            NalUnitType.SUFFIX_SEI_NUT,
            sei.write_sei([sei.SEIMessage(
                sei.PICTURE_HASH,
                sei.make_picture_hash_payload(digests, cfg.hash_type))]))
        out = nal.annexb_wrap(self.headers() + [slice_nal, sei_nal])
        stats["total_s"] = time.perf_counter() - st["t0"]
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
