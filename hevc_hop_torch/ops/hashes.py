"""Decoded-picture hashes.

``plane_checksums`` is kernel C1 (``csrc/checksum.cu``): the H.265 D.3.19
position-masked byte sum of up to three planes in one launch, so only 4
bytes per plane leave the card. On a CPU tensor it runs the plain PyTorch
version. The MD5/CRC digests and the numpy checksum stay on the host.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from hevc_hop_torch import _cuda

LAUNCHES = 0


def _checksum_plain(plane: torch.Tensor, bit_depth: int) -> int:
    """int64 accumulation masked to 32 bits (torch's uint32 ops are
    limited); the sum is the same as a uint32 sum that wraps."""
    h, w = plane.shape
    x = torch.arange(w, dtype=torch.int64, device=plane.device)[None, :]
    y = torch.arange(h, dtype=torch.int64, device=plane.device)[:, None]
    xm = ((x & 255) ^ (y & 255) ^ (x >> 8) ^ (y >> 8)) & 255
    p = plane.to(torch.int64) & 0xFFFFFFFF
    s = ((p & 255) ^ xm).sum()
    if bit_depth > 8:
        s = s + ((p >> 8) ^ xm).sum()
    return int(s) & 0xFFFFFFFF


def _checksum_cuda(planes: list, bit_depth: int) -> list:
    global LAUNCHES
    if not 1 <= len(planes) <= 3:
        raise ValueError("one launch covers one to three planes")
    dev = planes[0].device
    ps = []
    for p in planes:
        if p.device != dev or p.dtype != torch.int32 or p.dim() != 2 \
                or p.stride(1) != 1:
            raise ValueError("checksum planes: int32 [H, W] with unit "
                             "column stride on one device")
        ps.append(p)
    out = torch.zeros(3, dtype=torch.int32, device=dev)
    args = []
    for i in range(3):
        p = ps[i] if i < len(ps) else ps[0]
        args += [p.data_ptr(), p.shape[0], p.shape[1], p.stride(0)]
    fn = _cuda.bind("checksum", "hh_checksum", "piii" * 3 + "iipp")
    err = fn(*args, len(ps), bit_depth, out.data_ptr(), _cuda.stream(out))
    _cuda.check("checksum", err)
    LAUNCHES += 1
    return [v & 0xFFFFFFFF for v in out.tolist()[:len(ps)]]


def plane_checksums(planes, bit_depth: int = 8) -> list:
    """D.3.19 checksums (Python ints in [0, 2**32)) of up to three int32
    planes: one C1 launch on the card, the plain version on the CPU."""
    planes = list(planes)
    if planes[0].is_cuda:
        return _checksum_cuda(planes, bit_depth)
    return [_checksum_plain(p, bit_depth) for p in planes]


def plane_checksum(plane: torch.Tensor, bit_depth: int = 8) -> int:
    """H.265 D.3.19 checksum of one sample plane."""
    return plane_checksums([plane], bit_depth)[0]


def _digest(v: int) -> bytes:
    return bytes([(v >> 24) & 255, (v >> 16) & 255, (v >> 8) & 255, v & 255])


def checksum_digests(y, cb, cr, bit_depth: int = 8) -> list:
    """Per-plane 4-byte big-endian checksum digests of device planes."""
    return [_digest(v) for v in plane_checksums([y, cb, cr], bit_depth)]


def checksum_digests_np(y, cb, cr, bit_depth: int = 8) -> list:
    """Host (numpy) mirror of checksum_digests for decoder-side verify."""
    out = []
    for plane in (y, cb, cr):
        p = np.asarray(plane).astype(np.uint32)
        h, w = p.shape
        x = np.arange(w, dtype=np.uint32)[None, :]
        yy = np.arange(h, dtype=np.uint32)[:, None]
        xm = ((x & 255) ^ (yy & 255) ^ (x >> 8) ^ (yy >> 8)) & 255
        s = np.sum((p & 255) ^ xm, dtype=np.uint32)
        if bit_depth > 8:
            s = s + np.sum((p >> 8) ^ xm, dtype=np.uint32)
        out.append(_digest(int(s)))
    return out


def crc_digests(y, cb, cr, bit_depth: int = 8) -> list:
    """Per-plane CRC-16 digests (TComPicYuvMD5.cpp:86-133 compCRC).

    HM's variant feeds each data bit at the LSB while reducing by 0x1021 at
    the MSB: per byte B, crc' = ((crc & 0xff) << 8) ^ g[crc >> 8] ^ B with
    g[t] = 8 shift-reduce steps of (t << 8). Finishes with 16 zero bits.
    """
    tab = _crc16_table()
    out = []
    for plane in (y, cb, cr):
        p = np.asarray(plane).astype(np.uint16)
        if bit_depth > 8:
            data = np.empty(p.size * 2, np.uint8)
            data[0::2] = (p & 0xFF).ravel()
            data[1::2] = (p >> 8).ravel()
        else:
            data = (p & 0xFF).astype(np.uint8).ravel()
        crc = 0xFFFF
        for b in data.tolist():
            crc = ((crc & 0xFF) << 8) ^ int(tab[crc >> 8]) ^ b
        for _ in range(16):
            msb = (crc >> 15) & 1
            crc = ((crc << 1) & 0xFFFF) ^ (0x1021 * msb)
        out.append(bytes([(crc >> 8) & 255, crc & 255]))
    return out


@functools.lru_cache(maxsize=1)
def _crc16_table():
    tab = np.zeros(256, np.uint32)
    for b in range(256):
        v = b << 8
        for _ in range(8):
            msb = (v >> 15) & 1
            v = ((v << 1) & 0xFFFF) ^ (0x1021 * msb)
        tab[b] = v
    return tab
