"""Wavefront scheduling: frame structure, z-addresses, availability.

The reference encodes CTUs strictly sequentially (TEncSlice.cpp:1000-1130 CTU
loop -> recursive z-order CU processing). On TPU we exploit the dependency
structure HEVC's WPP was designed around: blocks whose reference chains only
touch finished blocks are mutually independent, so the schedule groups them
into topological levels consumed by the single-program scan
(models/wavefront_scan.py).

Availability is the exact H.265 6.4.1 z-scan rule, evaluated via a per-4x4
z-address plane.
"""
from __future__ import annotations

import functools

import numpy as np


# ---------------------------------------------------------------------------
# Frame structure: leaves, z-addresses, wave schedule (host-side, static).
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def zaddr4_plane(w: int, h: int, ctb_log2: int) -> np.ndarray:
    """z-scan order index per 4x4 unit (global across CTUs, raster CTUs)."""
    u4w, u4h = w // 4, h // 4
    ux = np.arange(u4w)[None, :].repeat(u4h, 0)
    uy = np.arange(u4h)[:, None].repeat(u4w, 1)
    cshift = ctb_log2 - 2
    nctux = (w + (1 << ctb_log2) - 1) >> ctb_log2
    ctu = (uy >> cshift).astype(np.int64) * nctux + (ux >> cshift)
    lx, ly = ux & ((1 << cshift) - 1), uy & ((1 << cshift) - 1)
    z = np.zeros_like(lx, np.int64)
    for b in range(cshift):
        z |= ((lx >> b) & 1) << (2 * b)
        z |= ((ly >> b) & 1) << (2 * b + 1)
    return (ctu << (2 * cshift)) | z


def leaves_from_depth(depth8: np.ndarray, w: int, h: int,
                      ctb_log2: int) -> list:
    """Leaf CUs (x, y, log2) in z-order, mirroring the native codec's walk."""
    out = []

    def rec(x, y, log2):
        size = 1 << log2
        if x >= w or y >= h:
            return
        inside = x + size <= w and y + size <= h
        depth_here = depth8[y // 8, x // 8]
        my_depth = ctb_log2 - log2
        split = (depth_here > my_depth) if inside else (log2 > 3)
        if split:
            half = size // 2
            rec(x, y, log2 - 1)
            rec(x + half, y, log2 - 1)
            rec(x, y + half, log2 - 1)
            rec(x + half, y + half, log2 - 1)
        else:
            out.append((x, y, log2))

    ctb = 1 << ctb_log2
    for cy in range(0, h, ctb):
        for cx in range(0, w, ctb):
            rec(cx, cy, ctb_log2)
    return out


def chain_coords(pos: np.ndarray, n: int) -> np.ndarray:
    """[B,2] block positions -> [B, 4n+1, 2] (x, y) chain sample coords."""
    b = pos.shape[0]
    coords = np.zeros((b, 4 * n + 1, 2), np.int32)
    i = np.arange(2 * n, dtype=np.int32)
    pos = pos.astype(np.int32)
    coords[:, :2 * n, 0] = pos[:, 0:1] - 1                    # left col x
    coords[:, :2 * n, 1] = pos[:, 1:2] + 2 * n - 1 - i[None]  # bottom-up
    coords[:, 2 * n, 0] = pos[:, 0] - 1                       # corner
    coords[:, 2 * n, 1] = pos[:, 1] - 1
    coords[:, 2 * n + 1:, 0] = pos[:, 0:1] + i[None]          # top row
    coords[:, 2 * n + 1:, 1] = pos[:, 1:2] - 1
    return coords


def avail_mask(pos: np.ndarray, n: int, zplane: np.ndarray,
               w: int, h: int) -> np.ndarray:
    """Exact z-scan availability for each chain sample. [B, 4n+1] bool."""
    coords = chain_coords(pos, n)
    x, y = coords[..., 0], coords[..., 1]
    inb = (x >= 0) & (y >= 0) & (x < w) & (y < h)
    xs, ys = np.clip(x, 0, w - 1), np.clip(y, 0, h - 1)
    z = zplane[ys >> 2, xs >> 2]
    # clip for out-of-frame dummy positions (masked out by the caller)
    zcur = zplane[np.clip(pos[:, 1], 0, h - 1) >> 2,
                  np.clip(pos[:, 0], 0, w - 1) >> 2]
    return inb & (z < zcur[:, None])


def schedule_topo(blocks, w, h, ctb_log2, zplane):
    """Generic topological-level scheduler over transform blocks.

    blocks: list of (x, y, log2) in z order. A block's level is
    1 + max(level of all z-earlier blocks whose samples its reference chain
    touches) — the minimal-depth parallel schedule for the exact H.265
    z-scan dependency structure (more parallel than CTU-wave x z-slot:
    independent blocks across CTUs AND within CTUs batch together).

    Returns list of steps [(n, pos[B,2], avail[B,L], availc[B,Lc])].
    """
    from hevc_hop_torch.entropy import native as _native
    arr = np.array(blocks, np.int32)
    levels = _native.wavefront_levels(arr[:, 0], arr[:, 1], arr[:, 2],
                                      w, h, ctb_log2)

    steps = {}
    for i, (x, y, log2) in enumerate(blocks):
        steps.setdefault((int(levels[i]), log2), []).append((x, y))
    out = []
    for key in sorted(steps):
        _, log2 = key
        pos = np.array(steps[key], np.int64)
        n = 1 << log2
        out.append((n, pos,
                    avail_mask(pos, n, zplane, w, h),
                    avail_mask(pos // 2, n // 2, _chroma_zplane(zplane),
                               w // 2, h // 2)))
    return out


def tu_blocks_from_maps(depth8: np.ndarray, tu4: np.ndarray, w: int, h: int,
                        ctb_log2: int) -> list:
    """Luma transform blocks (x, y, log2) in z/coding order from the CU depth
    map + TU-size map."""
    out = []
    for (x, y, cu_log2) in leaves_from_depth(depth8, w, h, ctb_log2):
        t = int(tu4[y // 4, x // 4])
        t = min(t, cu_log2)
        size, tn = 1 << cu_log2, 1 << t
        if t == cu_log2:
            out.append((x, y, t))
            continue
        # TU z-order within the CU
        def rec(bx, by, log2):
            if log2 == t:
                out.append((bx, by, log2))
                return
            half = 1 << (log2 - 1)
            rec(bx, by, log2 - 1)
            rec(bx + half, by, log2 - 1)
            rec(bx, by + half, log2 - 1)
            rec(bx + half, by + half, log2 - 1)
        rec(x, y, cu_log2)
        del size, tn
    return out


def _chroma_zplane(zplane: np.ndarray) -> np.ndarray:
    # chroma 4x4 unit == luma 8x8 unit; availability follows luma z-order
    return zplane[::2, ::2]


def _bucket(b: int) -> int:
    r = 1
    while r < b:
        r *= 2
    return r


def _pad(arr: np.ndarray, b: int, fill=0) -> np.ndarray:
    if arr.shape[0] == b:
        return arr
    pad = np.full((b - arr.shape[0],) + arr.shape[1:], fill, arr.dtype)
    return np.concatenate([arr, pad], 0)
