"""Planar YUV 4:2:0 file I/O + decoded-picture MD5 (the codec integration
oracle). Capability ref: TLibVideoIO/TVideoIOYuv.cpp, TComPicYuvMD5.cpp."""
from __future__ import annotations

import hashlib

import numpy as np


def read_yuv420(path: str, width: int, height: int, num_frames: int = 1,
                bit_depth: int = 8, skip: int = 0):
    """Returns list of (y, cb, cr) uint8/uint16 arrays."""
    dtype = np.uint8 if bit_depth == 8 else np.uint16
    ysz, csz = width * height, (width // 2) * (height // 2)
    frame_bytes = (ysz + 2 * csz) * dtype().itemsize
    frames = []
    with open(path, "rb") as f:
        f.seek(skip * frame_bytes)
        for _ in range(num_frames):
            buf = f.read(frame_bytes)
            if len(buf) < frame_bytes:
                break
            a = np.frombuffer(buf, dtype)
            y = a[:ysz].reshape(height, width)
            cb = a[ysz:ysz + csz].reshape(height // 2, width // 2)
            cr = a[ysz + csz:].reshape(height // 2, width // 2)
            frames.append((y, cb, cr))
    return frames


def write_yuv420(path: str, frames, bit_depth: int = 8, append: bool = False):
    dtype = np.uint8 if bit_depth == 8 else np.uint16
    with open(path, "ab" if append else "wb") as f:
        for (y, cb, cr) in frames:
            f.write(np.ascontiguousarray(y, dtype).tobytes())
            f.write(np.ascontiguousarray(cb, dtype).tobytes())
            f.write(np.ascontiguousarray(cr, dtype).tobytes())


def picture_md5(y, cb, cr, bit_depth: int = 8) -> bytes:
    """MD5 over the three planes, H.265 SEI D.3.19 convention (each sample
    little-endian, one or two bytes by bit depth); ref TComPicYuvMD5.cpp:188."""
    md5 = hashlib.md5()
    for plane in (y, cb, cr):
        p = np.asarray(plane)
        if bit_depth <= 8:
            md5.update(p.astype(np.uint8).tobytes())
        else:
            md5.update(p.astype("<u2").tobytes())
    return md5.digest()
