"""Decoded-picture hashes.

``plane_checksums`` is kernel C1 (``csrc/checksum.cu``): the H.265 D.3.19
position-masked byte sum of up to three planes in one launch, which writes
the three sums itself into pinned host memory: only 4 bytes per plane
leave the card, with no fill before the launch and no copy after it. On a CPU
tensor it runs the plain PyTorch version. :func:`band_plan` is the kernel's
work list (bands of whole rows, a CTA stepping over them) and
:func:`checksum_bands_plain` a plain walk of it. The MD5/CRC digests and
the numpy checksum stay on the host.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from hevc_hop_torch import _cuda

LAUNCHES = 0

_M32 = 0xFFFFFFFF
# the walk's default grid: what hh_checksum_ctas reports on an H100, 132
# SMs at 6 CTAs of 256 threads (38 registers a thread)
WALK_CTAS = 792


def _checksum_plain(plane: torch.Tensor, bit_depth: int) -> int:
    """int64 accumulation masked to 32 bits (torch's uint32 ops are
    limited); the sum is the same as a uint32 sum that wraps."""
    h, w = plane.shape
    x = torch.arange(w, dtype=torch.int64, device=plane.device)[None, :]
    y = torch.arange(h, dtype=torch.int64, device=plane.device)[:, None]
    xm = ((x & 255) ^ (y & 255) ^ (x >> 8) ^ (y >> 8)) & 255
    p = plane.to(torch.int64) & _M32
    s = ((p & 255) ^ xm).sum()
    if bit_depth > 8:
        s = s + ((p >> 8) ^ xm).sum()
    return int(s) & _M32


@functools.lru_cache(maxsize=64)
def band_plan(shapes: tuple, ctas: int) -> tuple:
    """C1's work list for planes of ``shapes`` ((h, w) each) on a card
    that holds ``ctas`` CTAs at once: (the rows of a band of each plane,
    the bands of each plane, the CTAs to launch). A band holds whole rows
    and at least ceil(samples / ctas) samples, so there are at most about
    ``ctas`` bands, each of about the same size; CTA c takes bands c,
    c + grid, ... of the planes' bands in a row."""
    total = sum(h * w for h, w in shapes)
    target = max(1, -(-total // ctas))
    rows = tuple(max(1, -(-target // w)) if w else 1 for _, w in shapes)
    bands = tuple(-(-h // r) if h and w else 0
                  for (h, w), r in zip(shapes, rows))
    return rows, bands, max(1, min(sum(bands), ctas))


def _band_sum_plain(band: torch.Tensor, y0: int, bit_depth: int) -> int:
    """The masked sum of a band of rows from y0, as the kernel adds it: in
    groups of four columns, the mask formed once a group (x = 4g + j: the
    group's mask xor j), the columns past the plane's width left out."""
    rows, w = band.shape
    groups = -(-w // 4)
    x0 = 4 * torch.arange(groups, dtype=torch.int64)
    y = y0 + torch.arange(rows, dtype=torch.int64)
    m = (x0[None] ^ (x0[None] >> 8) ^ y[:, None] ^ (y[:, None] >> 8)) & 255
    xm = m[..., None] ^ torch.arange(4, dtype=torch.int64)
    v = torch.zeros((rows, 4 * groups), dtype=torch.int64)
    v[:, :w] = band.to(torch.int64) & _M32
    v = v.reshape(rows, groups, 4)
    inside = (torch.arange(4 * groups) < w).reshape(groups, 4)
    s = torch.where(inside, (v & 255) ^ xm, 0).sum()
    if bit_depth > 8:
        s = s + torch.where(inside, (v >> 8) ^ xm, 0).sum()
    return int(s) & _M32


def checksum_bands_plain(planes, bit_depth: int = 8,
                         ctas: int = WALK_CTAS) -> tuple:
    """Plain walk of C1's decomposition on one to three int32 planes:
    band_plan's bands, each summed in groups of four columns into a uint32
    partial, the partials gathered per CTA as the kernel's CTAs step over
    the bands, and the CTAs' partials added with wrap-around. Returns (the
    sums, the plan: rows, bands, grid, and per plane whether the kernel
    reads it with 16-byte loads or takes the scalar arm)."""
    planes = list(planes)
    rows, bands, grid = band_plan(tuple(tuple(p.shape) for p in planes),
                                  ctas)
    cta = [[0] * len(planes) for _ in range(grid)]
    first = 0
    for k, (p, r, nb) in enumerate(zip(planes, rows, bands)):
        for i in range(nb):
            c = (first + i) % grid
            part = _band_sum_plain(p[i * r:i * r + r], i * r, bit_depth)
            cta[c][k] = (cta[c][k] + part) & _M32
        first += nb
    sums = [sum(c[k] for c in cta) & _M32 for k in range(len(planes))]
    vec = [p.data_ptr() % 16 == 0 and p.stride(0) % 4 == 0 for p in planes]
    return sums, {"rows": rows, "bands": bands, "grid": grid, "vec": vec}


_CTAS: dict = {}
_WORKSPACE: dict = {}


def _resident_ctas(dev: torch.device) -> tuple:
    """(CTAs of C1 the card holds at once, words of a stream's workspace)
    from hh_checksum_ctas, once a device."""
    if dev.index not in _CTAS:
        n, words = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(dev):
            err = _cuda.bind("checksum", "hh_checksum_ctas", "pp")(
                ctypes.addressof(n), ctypes.addressof(words))
        _cuda.check("checksum", err)
        _CTAS[dev.index] = (n.value, words.value)
    return _CTAS[dev.index]


def _workspace(dev: torch.device, stream: int) -> torch.Tensor:
    """C1's partials and ticket counter on the card for its launches on
    one stream, zeroed once and kept for the process's life (each launch
    leaves its counter at 0 for the next; stream order keeps two launches
    on one stream from sharing them at once)."""
    key = (dev.index, stream)
    if key not in _WORKSPACE:
        _WORKSPACE[key] = torch.zeros(_resident_ctas(dev)[1],
                                      dtype=torch.int32, device=dev)
    return _WORKSPACE[key]


def checksum_launch(planes: list, bit_depth: int, out: torch.Tensor):
    """Launch C1 on one to three int32 CUDA planes on the current stream,
    its sums (uint32 in int32 storage) written by the kernel into ``out``,
    three int32 in pinned host memory, without waiting for it."""
    global LAUNCHES
    if not 1 <= len(planes) <= 3:
        raise ValueError("one launch covers one to three planes")
    dev = planes[0].device
    for p in planes:
        if p.device != dev or p.dtype != torch.int32 or p.dim() != 2 \
                or p.stride(1) != 1:
            raise ValueError("checksum planes: int32 [H, W] with unit "
                             "column stride on one device")
    if out.is_cuda or not out.is_pinned() or out.dtype != torch.int32 \
            or out.numel() < 3 or not out.is_contiguous():
        raise ValueError("checksum out: three int32 in pinned host memory")
    rows, _, grid = band_plan(tuple(tuple(p.shape) for p in planes),
                              _resident_ctas(dev)[0])
    stream = _cuda.stream(planes[0])
    ws = _workspace(dev, stream)
    args = []
    for i in range(3):
        p, r = (planes[i], rows[i]) if i < len(planes) else (planes[0], 1)
        args += [p.data_ptr(), p.shape[0], p.shape[1], p.stride(0), r]
    fn = _cuda.bind("checksum", "hh_checksum", "piiii" * 3 + "iiippp")
    err = fn(*args, len(planes), bit_depth, grid, ws.data_ptr(),
             out.data_ptr(), stream)
    _cuda.check("checksum", err)
    LAUNCHES += 1


def _checksum_cuda(planes: list, bit_depth: int) -> list:
    """One C1 launch into three pinned words of this call's own, read once
    the launch ends."""
    out = torch.empty(3, dtype=torch.int32, pin_memory=True)
    checksum_launch(planes, bit_depth, out)
    torch.cuda.current_stream(planes[0].device).synchronize()
    return [v & _M32 for v in out.tolist()[:len(planes)]]


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
