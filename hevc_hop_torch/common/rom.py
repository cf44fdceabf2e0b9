"""ROM tables: transform matrices, quant scales, scan orders, chroma QP map.

All constants here are defined by ITU-T H.265 / ISO-IEC 23008-2 (the tables the
reference keeps in TLibCommon/TComRom.cpp:50-319; cited per-item below). They
are *generated* from the standard's structure where possible rather than
hard-coded as flat literals.
"""
from __future__ import annotations

import functools

import numpy as np

# ---------------------------------------------------------------------------
# Integer DCT-II matrices (H.265 8.6.4.2; ref TComRom.cpp g_aiT4/8/16/32).
#
# The 32-point HEVC transform matrix is fully determined by the quarter-wave
# table q[i] ~ 64*sqrt(2)*cos(i*pi/64) with the standard's hand-tuned integer
# values; entry M32[k][n] = sign-folded q[(k*(2n+1)) mod 128], and the N-point
# matrices are row-subsampled: M_N[k] = M32[k*(32//N)].
# ---------------------------------------------------------------------------

_QUARTER_COS = np.array(
    [64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73, 70, 67,
     64, 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22, 18, 13, 9, 4, 0],
    dtype=np.int32,
)


def _folded_cos(idx: np.ndarray) -> np.ndarray:
    """q-value of cos(idx*pi/64) with quarter-wave folding, idx in [0,128)."""
    idx = idx % 128
    val = np.zeros_like(idx)
    sign = np.ones_like(idx)
    q1 = idx <= 32
    q2 = (idx > 32) & (idx <= 64)
    q3 = (idx > 64) & (idx <= 96)
    q4 = idx > 96
    def q(i):
        return _QUARTER_COS[np.clip(i, 0, 32)]

    val = np.where(q1, q(idx), val)
    val = np.where(q2, q(64 - idx), val)
    sign = np.where(q2, -1, sign)
    val = np.where(q3, q(idx - 64), val)
    sign = np.where(q3, -1, sign)
    val = np.where(q4, q(128 - idx), val)
    return (sign * val).astype(np.int32)


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """N-point HEVC integer DCT-II matrix, rows = basis vectors (int32)."""
    assert n in (4, 8, 16, 32)
    k = np.arange(32, step=32 // n).reshape(n, 1)
    col = np.arange(n).reshape(1, n)
    return _folded_cos(k * (2 * col + 1))


# 4x4 DST-VII for intra luma 4x4 (H.265 8.6.4.1; ref TComRom g_as_DST_MAT_4).
DST4 = np.array(
    [[29, 55, 74, 84],
     [74, 74, 0, -74],
     [84, -29, -74, 55],
     [55, -84, 74, -29]],
    dtype=np.int32,
)

# ---------------------------------------------------------------------------
# Quantization scales (H.265 8.6.3 levelScale / HM QUANT_SHIFT=14 forward
# scales; ref TComRom.cpp:164-171 g_quantScales / g_invQuantScales).
# ---------------------------------------------------------------------------
QUANT_SCALES = np.array([26214, 23302, 20560, 18396, 16384, 14564], np.int32)
INV_QUANT_SCALES = np.array([40, 45, 51, 57, 64, 72], np.int32)

QUANT_SHIFT = 14
MAX_TR_DYNAMIC_RANGE = 15


# ---------------------------------------------------------------------------
# Chroma QP mapping for 4:2:0 (H.265 Table 8-10; ref TComRom g_aucChromaScale).
# ---------------------------------------------------------------------------
_CHROMA_QP_TAIL = {30: 29, 31: 30, 32: 31, 33: 32, 34: 33, 35: 33, 36: 34,
                   37: 34, 38: 35, 39: 35, 40: 36, 41: 36, 42: 37, 43: 37}


def chroma_qp_from_luma(qp_i: int) -> int:
    if qp_i < 30:
        return qp_i
    if qp_i <= 43:
        return _CHROMA_QP_TAIL[qp_i]
    return qp_i - 6


CHROMA_QP_TABLE = np.array([chroma_qp_from_luma(q) for q in range(58)], np.int32)


# ---------------------------------------------------------------------------
# Coefficient scan orders (H.265 6.5.3; ref TComRom initSigLastScan).
# Returned as [num, 2] arrays of (x, y) positions in scan order.
# ---------------------------------------------------------------------------
SCAN_DIAG, SCAN_HOR, SCAN_VER = 0, 1, 2


@functools.lru_cache(maxsize=None)
def scan_order(log2_w: int, scan_type: int) -> np.ndarray:
    """Scan positions for a (1<<log2_w)^2 block, 4x4-subblock based.

    The HEVC up-right diagonal scan iterates 4x4 coefficient groups in
    diagonal order and coefficients within each group in diagonal order
    (H.265 6.5.3); horizontal/vertical scans likewise are group-based.
    """
    n = 1 << log2_w

    def raster(sz: int, vertical: bool) -> np.ndarray:
        a, b = np.meshgrid(np.arange(sz), np.arange(sz), indexing="ij")
        if vertical:
            xy = np.stack([a.ravel(), b.ravel()], axis=1)  # x major
        else:
            xy = np.stack([b.ravel(), a.ravel()], axis=1)  # y major
        return xy.astype(np.int32)

    if scan_type in (SCAN_HOR, SCAN_VER):
        vert = scan_type == SCAN_VER
        if n == 4:
            return raster(4, vert)
        groups = raster(n // 4, vert)
        inner = raster(4, vert)
        out = groups[:, None, :] * 4 + inner[None, :, :]
        return out.reshape(-1, 2).astype(np.int32)

    def diag(sz: int) -> np.ndarray:
        # up-right diagonal scan of an sz x sz block: start top-left,
        # diagonals of increasing x+y, each traversed bottom-left -> top-right
        pos = []
        for s in range(2 * sz - 1):
            y = min(s, sz - 1)
            x = s - y
            while y >= 0 and x < sz:
                pos.append((x, y))
                y -= 1
                x += 1
        return np.array(pos, dtype=np.int32)

    if n == 4:
        return diag(4)
    groups = diag(n // 4)
    inner = diag(4)
    out = groups[:, None, :] * 4 + inner[None, :, :]
    return out.reshape(-1, 2).astype(np.int32)


@functools.lru_cache(maxsize=None)
def scan_raster_index(log2_w: int, scan_type: int) -> np.ndarray:
    """scan position -> raster index (y * w + x)."""
    pos = scan_order(log2_w, scan_type)
    return (pos[:, 1] << log2_w) + pos[:, 0]


# ---------------------------------------------------------------------------
# Intra angle tables (H.265 8.4.4.2.6; ref TComPrediction g_angTable/invAngTable)
# Index by mode 2..34.
# ---------------------------------------------------------------------------
INTRA_PRED_ANGLE = np.array(
    [32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26, -32,
     -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32],
    dtype=np.int32,
)  # modes 2..34

INTRA_INV_ANGLE = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, -4096, -1638, -910, -630, -482, -390, -315,
     -256, -315, -390, -482, -630, -910, -1638, -4096, 0, 0, 0, 0, 0, 0, 0,
     0, 0],
    dtype=np.int32,
)  # modes 2..34 (8192*32/angle for negative-angle modes 11..25)
