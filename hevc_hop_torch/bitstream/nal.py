"""NAL unit packaging and AnnexB byte-stream assembly/scanning.

Capability ref: NALwrite.cpp / AnnexBwrite.h (write), NALread.cpp /
AnnexBread.cpp (read).
"""
from __future__ import annotations

from hevc_hop_torch.bitstream.bits import ebsp_to_rbsp, rbsp_to_ebsp
from hevc_hop_torch.common.types import NalUnitType


def make_nal(nal_type: int, rbsp: bytes, temporal_id: int = 0,
             layer_id: int = 0) -> bytes:
    """2-byte NAL header + EBSP payload (H.265 7.3.1.2)."""
    h0 = (0 << 7) | (int(nal_type) << 1) | (layer_id >> 5)
    h1 = ((layer_id & 31) << 3) | (temporal_id + 1)
    return bytes([h0, h1]) + rbsp_to_ebsp(rbsp)


def annexb_wrap(nals: list[bytes], first_au: bool = True) -> bytes:
    """Prefix start codes; 4-byte start code for parameter sets & first NAL
    of an access unit, 3-byte otherwise (H.265 B.2.2)."""
    out = bytearray()
    for i, nal in enumerate(nals):
        nal_type = (nal[0] >> 1) & 0x3F
        long_sc = (i == 0 or nal_type in (
            NalUnitType.VPS_NUT, NalUnitType.SPS_NUT, NalUnitType.PPS_NUT))
        out += b"\x00\x00\x00\x01" if long_sc else b"\x00\x00\x01"
        out += nal
    return bytes(out)


def annexb_split(stream: bytes) -> list[tuple[int, bytes]]:
    """Scan an AnnexB stream -> list of (nal_type, rbsp payload)."""
    nals = []
    i = 0
    n = len(stream)
    # find first start code
    starts = []
    while i + 2 < n:
        if stream[i] == 0 and stream[i + 1] == 0 and stream[i + 2] == 1:
            starts.append(i + 3)
            i += 3
        else:
            i += 1
    for k, s in enumerate(starts):
        e = (starts[k + 1] - 3) if k + 1 < len(starts) else n
        # previous start code may have been 4-byte: trailing zero belongs
        # to the next start code, strip trailing zeros of this NAL
        while e > s and stream[e - 1] == 0 and k + 1 < len(starts):
            e -= 1
        nal = stream[s:e]
        if len(nal) < 2:
            continue
        nal_type = (nal[0] >> 1) & 0x3F
        nals.append((nal_type, ebsp_to_rbsp(nal[2:])))
    return nals


def ep_insert_count(data: bytes) -> int:
    """Number of emulation_prevention_three_bytes the NAL escaper will
    insert inside `data` (00 00 followed by a byte <= 03 -> 03 inserted;
    bits.rbsp_to_ebsp semantics). WPP entry-point offsets are wire-domain
    (TEncGOP.cpp puiSubstreamSizes + countStartCodeEmulations)."""
    cnt = zeros = 0
    for b in data:
        if zeros >= 2 and b <= 3:
            cnt += 1
            zeros = 0
        zeros = zeros + 1 if b == 0 else 0
    return cnt


def unwire_substream_sizes(data: bytes, wire_sizes: list) -> list:
    """Map WIRE substream sizes (escaped-byte counts) back to RBSP byte
    sizes over the (already de-escaped) slice payload `data` — the
    decoder-side inverse (TDecCAVLC.cpp:1341-1353 EP-byte subtraction)."""
    out = []
    pos = 0
    for wsz in wire_sizes:
        zeros = consumed = esc = 0
        while consumed + esc < wsz:
            b = data[pos + consumed]
            if zeros >= 2 and b <= 3:
                esc += 1
                zeros = 0
            zeros = zeros + 1 if b == 0 else 0
            consumed += 1
        out.append(consumed)
        pos += consumed
    out.append(len(data) - pos)   # last substream: remainder
    return out
