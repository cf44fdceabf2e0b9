"""Parameter sets (VPS/SPS/PPS) + slice segment header, write & parse.

Capability ref: TEncCavlc.cpp (codeVPS/codeSPS/codePPS/codeSliceHeader,
incl. the holoscopic VPS extension at TEncCavlc.cpp:572-575) and
TDecCAVLC.cpp (parse side, ISS/PSS remap at 842-846). Syntax follows
H.265 7.3.2; only features the engine uses are parameterized, everything
else is written as its off/default value and validated on parse.
"""
from __future__ import annotations

import dataclasses

from hevc_hop_torch.bitstream.bits import BitReader, BitWriter
from hevc_hop_torch.common.types import NalUnitType, SliceType


@dataclasses.dataclass
class SPS:
    pic_width: int = 64
    pic_height: int = 64
    bit_depth: int = 8
    ctb_log2: int = 5
    min_cb_log2: int = 3
    min_tb_log2: int = 2
    max_tb_log2: int = 5
    max_transform_hierarchy_depth_intra: int = 0
    max_transform_hierarchy_depth_inter: int = 0
    strong_intra_smoothing: bool = True
    sao_enabled: bool = False
    # conformance window (luma samples), for non-multiple-of-8 sizes
    conf_win_right: int = 0
    conf_win_bottom: int = 0
    sps_id: int = 0
    vps_id: int = 0
    max_dec_pic_buffering: int = 4
    num_short_term_rps: int = 0
    temporal_mvp: bool = False
    # holoscopic extension (IT): carried in VPS in the reference; we mirror
    # the flags here for convenience after parse
    holo: bool = False
    holo_mi_size: int = 0


@dataclasses.dataclass
class PPS:
    pps_id: int = 0
    sps_id: int = 0
    init_qp: int = 26
    cu_qp_delta_enabled: bool = False
    diff_cu_qp_delta_depth: int = 0
    cb_qp_offset: int = 0
    cr_qp_offset: int = 0
    deblocking_disabled: bool = True
    beta_offset_div2: int = 0
    tc_offset_div2: int = 0
    sign_data_hiding: bool = False
    transform_skip_enabled: bool = False
    entropy_coding_sync: bool = False
    tiles_enabled: bool = False


@dataclasses.dataclass
class VPS:
    vps_id: int = 0
    max_dec_pic_buffering: int = 4
    # IT holoscopic extension (TComSlice.h:417-476)
    holo: bool = False
    holo_mi_size: int = 0


@dataclasses.dataclass
class SliceHeader:
    slice_type: int = SliceType.I
    pps_id: int = 0
    slice_qp: int = 32
    first_slice: bool = True
    idr: bool = True
    poc: int = 0
    # parsed P/B fields
    ref_deltas: list = dataclasses.field(default_factory=list)
    num_ref_wire: int = 1
    max_merge: int = 5
    sao: bool = False
    # WPP/tiles entry points (WIRE offsets: escaped-byte counts of each
    # substream except the last, H.265 7.4.7.1)
    entry_offsets: list = dataclasses.field(default_factory=list)
    # payload byte offset where slice data (CABAC) starts
    data_offset: int = 0


def _write_ptl(w: BitWriter) -> None:
    """profile_tier_level, Main profile level 4.1 (H.265 7.3.3)."""
    w.write(0, 2)          # general_profile_space
    w.write_flag(0)        # general_tier_flag
    w.write(1, 5)          # general_profile_idc = Main
    for i in range(32):
        w.write_flag(1 if i == 1 else 0)  # compat flags: Main
    w.write_flag(1)        # general_progressive_source_flag
    w.write_flag(0)        # interlaced
    w.write_flag(0)        # non_packed_constraint
    w.write_flag(1)        # frame_only_constraint
    w.write(0, 32)         # reserved_zero_44bits
    w.write(0, 12)
    w.write(123, 8)        # general_level_idc (4.1)


def _parse_ptl(r: BitReader) -> None:
    r.read(2 + 1 + 5)
    r.read(32)
    r.read(4)
    r.read(32)
    r.read(12)
    r.read(8)


def write_vps(vps: VPS) -> bytes:
    w = BitWriter()
    w.write(vps.vps_id, 4)
    w.write(3, 2)          # vps_reserved_three_2bits
    w.write(0, 6)          # vps_max_layers_minus1
    w.write(0, 3)          # vps_max_sub_layers_minus1
    w.write_flag(1)        # vps_temporal_id_nesting_flag
    w.write(0xFFFF, 16)    # vps_reserved_0xffff_16bits
    _write_ptl(w)
    w.write_flag(0)        # vps_sub_layer_ordering_info_present
    w.write_ue(vps.max_dec_pic_buffering - 1)
    w.write_ue(0)          # num_reorder_pics
    w.write_ue(0)          # max_latency_increase
    w.write(0, 6)          # vps_max_layer_id
    w.write_ue(0)          # vps_num_layer_sets_minus1
    w.write_flag(0)        # vps_timing_info_present
    # vps_extension_flag doubles as the holoscopic extension carrier in the
    # reference (TEncCavlc.cpp:572-576: flag, writeAlignOne (1-bits to byte
    # boundary, mirrored by the parser's readOutTrailingBits at
    # TDecCAVLC.cpp:740), microimage size ue(v), vps_extension2_flag)
    if vps.holo:
        w.write_flag(1)
        while w.num_bits % 8 != 0:
            w.write_flag(1)
        w.write_ue(vps.holo_mi_size)
        w.write_flag(0)    # vps_extension2_flag
    else:
        w.write_flag(0)
    w.write_byte_alignment()
    return w.get_bytes()


def parse_vps(data: bytes) -> VPS:
    r = BitReader(data)
    vps = VPS()
    vps.vps_id = r.read(4)
    r.read(2 + 6 + 3 + 1 + 16)
    _parse_ptl(r)
    r.read_flag()
    vps.max_dec_pic_buffering = r.read_ue() + 1
    r.read_ue()
    r.read_ue()
    r.read(6)
    r.read_ue()
    r.read_flag()
    if r.read_flag():
        vps.holo = True
        r.byte_align()     # readOutTrailingBits (TDecCAVLC.cpp:740)
        vps.holo_mi_size = r.read_ue()
        r.read_flag()      # vps_extension2_flag
    return vps


def write_sps(sps: SPS) -> bytes:
    w = BitWriter()
    w.write(sps.vps_id, 4)
    w.write(0, 3)          # sps_max_sub_layers_minus1
    w.write_flag(1)        # sps_temporal_id_nesting_flag
    _write_ptl(w)
    w.write_ue(sps.sps_id)
    w.write_ue(1)          # chroma_format_idc = 4:2:0
    w.write_ue(sps.pic_width)
    w.write_ue(sps.pic_height)
    if sps.conf_win_right or sps.conf_win_bottom:
        w.write_flag(1)
        w.write_ue(0)                      # left offset
        w.write_ue(sps.conf_win_right // 2)
        w.write_ue(0)                      # top
        w.write_ue(sps.conf_win_bottom // 2)
    else:
        w.write_flag(0)
    w.write_ue(sps.bit_depth - 8)
    w.write_ue(sps.bit_depth - 8)
    w.write_ue(8)          # log2_max_pic_order_cnt_lsb_minus4 -> 12 bits
    w.write_flag(0)        # sps_sub_layer_ordering_info_present
    w.write_ue(sps.max_dec_pic_buffering - 1)
    w.write_ue(0)          # num_reorder
    w.write_ue(0)          # max_latency
    w.write_ue(sps.min_cb_log2 - 3)
    w.write_ue(sps.ctb_log2 - sps.min_cb_log2)
    w.write_ue(sps.min_tb_log2 - 2)
    w.write_ue(sps.max_tb_log2 - sps.min_tb_log2)
    w.write_ue(sps.max_transform_hierarchy_depth_inter)
    w.write_ue(sps.max_transform_hierarchy_depth_intra)
    w.write_flag(0)        # scaling_list_enabled
    w.write_flag(0)        # amp_enabled
    w.write_flag(1 if sps.sao_enabled else 0)
    w.write_flag(0)        # pcm_enabled
    w.write_ue(sps.num_short_term_rps)
    w.write_flag(0)        # long_term_ref_pics_present
    w.write_flag(1 if sps.temporal_mvp else 0)
    w.write_flag(1 if sps.strong_intra_smoothing else 0)
    w.write_flag(0)        # vui_parameters_present
    w.write_flag(0)        # sps_extension_flag
    w.write_byte_alignment()
    return w.get_bytes()


def parse_sps(data: bytes) -> SPS:
    r = BitReader(data)
    sps = SPS()
    sps.vps_id = r.read(4)
    r.read(3 + 1)
    _parse_ptl(r)
    sps.sps_id = r.read_ue()
    chroma = r.read_ue()
    assert chroma == 1, "only 4:2:0 supported"
    sps.pic_width = r.read_ue()
    sps.pic_height = r.read_ue()
    if r.read_flag():
        r.read_ue()
        sps.conf_win_right = r.read_ue() * 2
        r.read_ue()
        sps.conf_win_bottom = r.read_ue() * 2
    sps.bit_depth = r.read_ue() + 8
    r.read_ue()            # chroma bit depth (same)
    r.read_ue()            # log2_max_poc_lsb
    r.read_flag()
    sps.max_dec_pic_buffering = r.read_ue() + 1
    r.read_ue()
    r.read_ue()
    sps.min_cb_log2 = r.read_ue() + 3
    sps.ctb_log2 = sps.min_cb_log2 + r.read_ue()
    sps.min_tb_log2 = r.read_ue() + 2
    sps.max_tb_log2 = sps.min_tb_log2 + r.read_ue()
    sps.max_transform_hierarchy_depth_inter = r.read_ue()
    sps.max_transform_hierarchy_depth_intra = r.read_ue()
    assert r.read_flag() == 0, "scaling lists unsupported"
    r.read_flag()          # amp
    sps.sao_enabled = bool(r.read_flag())
    assert r.read_flag() == 0, "pcm unsupported"
    sps.num_short_term_rps = r.read_ue()
    assert sps.num_short_term_rps == 0, "RPS-in-SPS unsupported"
    r.read_flag()          # long term
    sps.temporal_mvp = bool(r.read_flag())
    sps.strong_intra_smoothing = bool(r.read_flag())
    r.read_flag()          # vui
    r.read_flag()          # extension
    return sps


def write_pps(pps: PPS) -> bytes:
    w = BitWriter()
    w.write_ue(pps.pps_id)
    w.write_ue(pps.sps_id)
    w.write_flag(0)        # dependent_slice_segments_enabled
    w.write_flag(0)        # output_flag_present
    w.write(0, 3)          # num_extra_slice_header_bits
    w.write_flag(1 if pps.sign_data_hiding else 0)
    w.write_flag(0)        # cabac_init_present (forced off w/ IT tools,
    #                        TypeDef.h:246-250)
    w.write_ue(0)          # num_ref_idx_l0_default_active_minus1
    w.write_ue(0)          # l1
    w.write_se(pps.init_qp - 26)
    w.write_flag(0)        # constrained_intra_pred
    w.write_flag(1 if pps.transform_skip_enabled else 0)
    w.write_flag(1 if pps.cu_qp_delta_enabled else 0)
    if pps.cu_qp_delta_enabled:
        w.write_ue(pps.diff_cu_qp_delta_depth)
    w.write_se(pps.cb_qp_offset)
    w.write_se(pps.cr_qp_offset)
    w.write_flag(0)        # pps_slice_chroma_qp_offsets_present
    w.write_flag(0)        # weighted_pred
    w.write_flag(0)        # weighted_bipred
    w.write_flag(0)        # transquant_bypass_enabled
    w.write_flag(1 if pps.tiles_enabled else 0)
    w.write_flag(1 if pps.entropy_coding_sync else 0)
    assert not pps.tiles_enabled, "tiles TODO"
    w.write_flag(1)        # pps_loop_filter_across_slices_enabled
    w.write_flag(1)        # deblocking_filter_control_present
    w.write_flag(0)        # deblocking_filter_override_enabled
    w.write_flag(1 if pps.deblocking_disabled else 0)
    if not pps.deblocking_disabled:
        w.write_se(pps.beta_offset_div2)
        w.write_se(pps.tc_offset_div2)
    w.write_flag(0)        # pps_scaling_list_data_present
    w.write_flag(0)        # lists_modification_present
    w.write_ue(0)          # log2_parallel_merge_level_minus2
    w.write_flag(0)        # slice_segment_header_extension_present
    w.write_flag(0)        # pps_extension_flag
    w.write_byte_alignment()
    return w.get_bytes()


def parse_pps(data: bytes) -> PPS:
    r = BitReader(data)
    pps = PPS()
    pps.pps_id = r.read_ue()
    pps.sps_id = r.read_ue()
    r.read_flag()
    r.read_flag()
    r.read(3)
    pps.sign_data_hiding = bool(r.read_flag())
    assert r.read_flag() == 0, "cabac_init unsupported"
    r.read_ue()
    r.read_ue()
    pps.init_qp = r.read_se() + 26
    r.read_flag()
    pps.transform_skip_enabled = bool(r.read_flag())
    pps.cu_qp_delta_enabled = bool(r.read_flag())
    if pps.cu_qp_delta_enabled:
        pps.diff_cu_qp_delta_depth = r.read_ue()
    pps.cb_qp_offset = r.read_se()
    pps.cr_qp_offset = r.read_se()
    r.read_flag()
    r.read_flag()
    r.read_flag()
    assert r.read_flag() == 0, "transquant bypass unsupported"
    pps.tiles_enabled = bool(r.read_flag())
    pps.entropy_coding_sync = bool(r.read_flag())
    assert not pps.tiles_enabled, "tiles TODO"
    r.read_flag()
    if r.read_flag():      # deblocking control present
        r.read_flag()      # override enabled
        pps.deblocking_disabled = bool(r.read_flag())
        if not pps.deblocking_disabled:
            pps.beta_offset_div2 = r.read_se()
            pps.tc_offset_div2 = r.read_se()
    r.read_flag()
    r.read_flag()
    r.read_ue()
    r.read_flag()
    r.read_flag()
    return pps


def write_slice_header(sh: SliceHeader, sps: SPS, pps: PPS) -> BitWriter:
    """Returns a BitWriter positioned after header alignment; the caller
    appends the CABAC slice data bytes."""
    w = BitWriter()
    w.write_flag(1 if sh.first_slice else 0)
    if sh.idr:
        w.write_flag(0)    # no_output_of_prior_pics
    w.write_ue(sh.pps_id)
    # (not first slice -> segment address; single-slice only for now)
    assert sh.first_slice, "multi-slice TODO"
    st = sh.slice_type
    # ISS/PSS are coded as I/P in the slice header; the decoder remaps via
    # the VPS holo flag (TDecCAVLC.cpp:842-846)
    wire_type = {SliceType.ISS: SliceType.I,
                 SliceType.PSS: SliceType.P}.get(st, st)
    w.write_ue(int(wire_type))
    if not sh.idr:
        w.write(sh.poc & 0xFFF, 12)    # pic_order_cnt_lsb
        w.write_flag(0)                # short_term_ref_pic_set_sps_flag
        # st_ref_pic_set(): low-delay, one negative ref at delta -1
        w.write_ue(1)                  # num_negative_pics
        w.write_ue(0)                  # num_positive_pics
        w.write_ue(0)                  # delta_poc_s0_minus1 (= -1)
        w.write_flag(1)                # used_by_curr_pic_s0_flag
        # (long-term off in SPS; TMVP off in SPS)
    if sps.sao_enabled:
        w.write_flag(1)    # slice_sao_luma_flag
        w.write_flag(1)    # slice_sao_chroma_flag
    # HM's isIntra() is (type == I_SLICE), so ISS/PSS slices carry the
    # non-intra header fields even when wire-coded as I
    # (TEncCavlc.cpp:780-783,895-897; TDecCAVLC.cpp parses them after the
    # I->ISS remap). num_ref counts INCLUDE the SS ref for PSS: the SS
    # picture replaces the last L0 entry (TComSlice.cpp:497-506).
    if st != SliceType.I:
        if sh.num_ref_wire != 1:       # PPS default active = 1
            w.write_flag(1)            # num_ref_idx_active_override_flag
            w.write_ue(sh.num_ref_wire - 1)
        else:
            w.write_flag(0)
        # cabac_init absent (CABAC_INIT_PRESENT forced 0, TypeDef.h:246)
        w.write_ue(0)                  # five_minus_max_num_merge_cand
    w.write_se(sh.slice_qp - pps.init_qp)
    # deblocking override absent (override disabled in PPS)
    if not pps.deblocking_disabled or sps.sao_enabled:
        # slice_loop_filter_across_slices_enabled_flag (pps enables it)
        w.write_flag(1)
    if pps.entropy_coding_sync or pps.tiles_enabled:
        # WPP entry points (H.265 7.3.6.1; TEncCavlc.cpp:1002
        # codeTilesWPPEntryPoint): offsets count the bytes AS ESCAPED in
        # the NAL (substream rbsp size + emulation-prevention insertions,
        # TEncGOP.cpp puiSubstreamSizes + countStartCodeEmulations)
        offs = sh.entry_offsets or []
        w.write_ue(len(offs))
        if offs:
            ln = max(1, max((o - 1).bit_length() for o in offs))
            w.write_ue(ln - 1)
            for o in offs:
                w.write(o - 1, ln)
    w.write_byte_alignment()
    return w


def parse_slice_header(data: bytes, sps: SPS, pps: PPS, nal_type: int,
                       holo: bool = False) -> SliceHeader:
    r = BitReader(data)
    sh = SliceHeader()
    sh.idr = nal_type in (NalUnitType.IDR_W_RADL, NalUnitType.IDR_N_LP)
    sh.first_slice = bool(r.read_flag())
    if nal_type >= NalUnitType.BLA_W_LP and nal_type <= NalUnitType.CRA_NUT:
        r.read_flag()      # no_output_of_prior_pics
    sh.pps_id = r.read_ue()
    st = r.read_ue()
    if holo:
        st = {int(SliceType.I): int(SliceType.ISS),
              int(SliceType.P): int(SliceType.PSS)}.get(st, st)
    sh.slice_type = st
    if not sh.idr:
        sh.poc = r.read(12)
        assert r.read_flag() == 0      # st_ref_pic_set_sps_flag
        nneg = r.read_ue()
        npos = r.read_ue()
        sh.ref_deltas = []
        d = 0
        for _ in range(nneg):
            d -= r.read_ue() + 1
            used = r.read_flag()
            if used:
                sh.ref_deltas.append(d)
        assert npos == 0, "RA/B RPS TODO"
    if sps.sao_enabled:
        sh.sao = bool(r.read_flag())
        r.read_flag()          # slice_sao_chroma_flag (joint with luma here)
    if st != int(SliceType.I):         # ISS/PSS are non-intra here (see writer)
        if r.read_flag():              # num_ref_idx override
            sh.num_ref_wire = r.read_ue() + 1
        else:
            sh.num_ref_wire = 1
        sh.max_merge = 5 - r.read_ue()
    sh.slice_qp = r.read_se() + pps.init_qp
    if not pps.deblocking_disabled or sps.sao_enabled:
        r.read_flag()    # slice_loop_filter_across_slices_enabled_flag
    if pps.entropy_coding_sync or pps.tiles_enabled:
        n_ep = r.read_ue()
        sh.entry_offsets = []
        if n_ep:
            ln = r.read_ue() + 1
            sh.entry_offsets = [r.read(ln) + 1 for _ in range(n_ep)]
    # byte_alignment(): mandatory stop bit, then zero bits to the boundary
    assert r.read_flag() == 1, "alignment stop bit"
    r_aligned = (r.bit_pos + 7) & ~7
    sh.data_offset = r_aligned >> 3
    return sh
