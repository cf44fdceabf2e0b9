"""SEI messages: decoded picture hash + generic container.

Capability ref: SEI.h:49-74 payload registry, SEIwrite.cpp (serialization),
SEIread.cpp (parse), and the decoded-picture-hash oracle the reference uses
as its integration test (TEncGOP.cpp:1789-1794 emit,
TDecGop.cpp:230-290 verify). Payload syntax per H.265 Annex D.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

USER_DATA_UNREGISTERED = 5    # D.2.7
RECOVERY_POINT = 6            # D.2.8
ACTIVE_PARAMETER_SETS = 129   # D.2.21
PICTURE_HASH = 132      # decoded_picture_hash payload type (D.2.19)
FRAME_PACKING = 45            # D.2.16

HASH_MD5 = 0
HASH_CRC = 1
HASH_CHECKSUM = 2


@dataclasses.dataclass
class SEIMessage:
    payload_type: int
    payload: bytes


def plane_md5s(y, cb, cr, bit_depth: int = 8) -> list:
    """Per-plane MD5 digests, sample layout per D.3.19 / TComPicYuvMD5.cpp:
    each sample little-endian, 1 or 2 bytes by bit depth."""
    out = []
    for plane in (y, cb, cr):
        p = np.asarray(plane)
        md5 = hashlib.md5()
        if bit_depth <= 8:
            md5.update(p.astype(np.uint8).tobytes())
        else:
            md5.update(p.astype("<u2").tobytes())
        out.append(md5.digest())
    return out


def make_picture_hash_payload(digests: list,
                              hash_type: int = HASH_MD5) -> bytes:
    return bytes([hash_type]) + b"".join(digests)


def write_sei(messages: list) -> bytes:
    """Serialize SEI messages into one RBSP (sei_message syntax, D.1)."""
    out = bytearray()
    for msg in messages:
        t = msg.payload_type
        while t >= 255:
            out.append(255)
            t -= 255
        out.append(t)
        s = len(msg.payload)
        while s >= 255:
            out.append(255)
            s -= 255
        out.append(s)
        out += msg.payload
    out.append(0x80)    # rbsp_trailing_bits
    return bytes(out)


def parse_sei(rbsp: bytes) -> list:
    """Parse all sei_message()s in an SEI RBSP."""
    out = []
    i = 0
    while i < len(rbsp) and rbsp[i] != 0x80:
        t = 0
        while rbsp[i] == 255:
            t += 255
            i += 1
        t += rbsp[i]
        i += 1
        s = 0
        while rbsp[i] == 255:
            s += 255
            i += 1
        s += rbsp[i]
        i += 1
        out.append(SEIMessage(t, rbsp[i:i + s]))
        i += s
    return out


# ---------------------------------------------------------------------------
# Structured payloads beyond the picture hash (SEI.h:49-74 registry subset;
# SEIwrite.cpp / SEIread.cpp analogs). Each returns/accepts the raw payload
# bytes used with SEIMessage.
# ---------------------------------------------------------------------------

def make_user_data_unregistered(uuid16: bytes, data: bytes) -> bytes:
    """D.2.7: 16-byte ISO/IEC 11578 UUID + opaque payload."""
    assert len(uuid16) == 16
    return uuid16 + data


def parse_user_data_unregistered(payload: bytes):
    return payload[:16], payload[16:]


def make_recovery_point(recovery_poc_cnt: int, exact_match: bool = True,
                        broken_link: bool = False) -> bytes:
    """D.2.8 recovery_point (SEIRecoveryPoint; the random-access resume
    marker — the codec's checkpoint/restart signal)."""
    from hevc_hop_torch.bitstream.bits import BitWriter
    w = BitWriter()
    w.write_se(recovery_poc_cnt)
    w.write_flag(1 if exact_match else 0)
    w.write_flag(1 if broken_link else 0)
    w.write_byte_alignment()
    return w.get_bytes()


def parse_recovery_point(payload: bytes):
    from hevc_hop_torch.bitstream.bits import BitReader
    r = BitReader(payload)
    return dict(recovery_poc_cnt=r.read_se(),
                exact_match=bool(r.read_flag()),
                broken_link=bool(r.read_flag()))


def make_active_parameter_sets(vps_id: int = 0, sps_id: int = 0) -> bytes:
    """D.2.21 active_parameter_sets (SEIActiveParameterSets)."""
    from hevc_hop_torch.bitstream.bits import BitWriter
    w = BitWriter()
    w.write(vps_id, 4)
    w.write_flag(0)        # self_contained_cvs_flag
    w.write_flag(0)        # no_parameter_set_update_flag
    w.write_ue(0)          # num_sps_ids_minus1
    w.write_ue(sps_id)     # active_seq_parameter_set_id[0]
    w.write_byte_alignment()
    return w.get_bytes()


def parse_active_parameter_sets(payload: bytes):
    from hevc_hop_torch.bitstream.bits import BitReader
    r = BitReader(payload)
    vps_id = r.read(4)
    r.read_flag()
    r.read_flag()
    n = r.read_ue() + 1
    sps_ids = [r.read_ue() for _ in range(n)]
    return dict(vps_id=vps_id, sps_ids=sps_ids)


def make_frame_packing(arrangement_type: int = 3,
                       content_interpretation: int = 1) -> bytes:
    """D.2.16 frame_packing_arrangement (subset: no quincunx/grid args)."""
    from hevc_hop_torch.bitstream.bits import BitWriter
    w = BitWriter()
    w.write_ue(0)                       # arrangement_id
    w.write_flag(0)                     # cancel_flag
    w.write(arrangement_type, 7)
    w.write_flag(0)                     # quincunx_sampling
    w.write(content_interpretation, 6)
    w.write_flag(0)                     # spatial_flipping
    w.write_flag(0)                     # frame0_flipped
    w.write_flag(0)                     # field_views
    w.write_flag(0)                     # current_frame_is_frame0
    w.write_flag(0)                     # frame0_self_contained
    w.write_flag(0)                     # frame1_self_contained
    w.write(0, 8)                       # grid positions (non-quincunx, !=5)
    w.write(0, 8)                       # reserved byte
    w.write_flag(0)                     # persistence
    w.write_flag(0)                     # upsampled_aspect_ratio
    w.write_byte_alignment()
    return w.get_bytes()


def parse_frame_packing(payload: bytes):
    from hevc_hop_torch.bitstream.bits import BitReader
    r = BitReader(payload)
    out = dict(arrangement_id=r.read_ue(), cancel=bool(r.read_flag()))
    if not out["cancel"]:
        out["arrangement_type"] = r.read(7)
        r.read_flag()
        out["content_interpretation"] = r.read(6)
    return out


def verify_picture_hash(payload: bytes, y, cb, cr,
                        bit_depth: int = 8) -> bool:
    """True iff the decoded picture matches the hash SEI
    (TDecGop.cpp:230 calcAndPrintHashStatus). All three hash types."""
    from hevc_hop_torch.ops import hashes
    if payload[0] == HASH_MD5:
        digests = plane_md5s(y, cb, cr, bit_depth)
    elif payload[0] == HASH_CRC:
        digests = hashes.crc_digests(y, cb, cr, bit_depth)
    elif payload[0] == HASH_CHECKSUM:
        digests = hashes.checksum_digests_np(y, cb, cr, bit_depth)
    else:
        raise ValueError(f"unknown hash type {payload[0]}")
    return payload[1:] == b"".join(digests)
