"""Core enums and constants (ref: TLibCommon/TypeDef.h, CommonDef.h)."""
from __future__ import annotations

import enum


class SliceType(enum.IntEnum):
    """Slice types incl. the IT holoscopic extension types.

    Ref TypeDef.h:419-427: B=0, P=1, I=2, plus ISS (intra self-similarity)
    and PSS (P + self-similarity) when the holo extension is active.
    """
    B = 0
    P = 1
    I = 2
    ISS = 3
    PSS = 4


class PredMode(enum.IntEnum):
    INTER = 0
    INTRA = 1


class PartSize(enum.IntEnum):
    SIZE_2Nx2N = 0
    SIZE_2NxN = 1
    SIZE_Nx2N = 2
    SIZE_NxN = 3


class NalUnitType(enum.IntEnum):
    """H.265 Table 7-1 (subset we emit/parse)."""
    TRAIL_N = 0
    TRAIL_R = 1
    BLA_W_LP = 16
    IDR_W_RADL = 19
    IDR_N_LP = 20
    CRA_NUT = 21
    VPS_NUT = 32
    SPS_NUT = 33
    PPS_NUT = 34
    AUD_NUT = 35
    EOS_NUT = 36
    EOB_NUT = 37
    FD_NUT = 38
    PREFIX_SEI_NUT = 39
    SUFFIX_SEI_NUT = 40


# Intra modes
PLANAR_IDX = 0
DC_IDX = 1
HOR_IDX = 10
VER_IDX = 26
DM_CHROMA_IDX = 36
NUM_INTRA_MODE = 35

# Coefficient dynamic range (HM MAX_TR_DYNAMIC_RANGE = 15 -> int16 coeffs)
COEF_MIN = -32768
COEF_MAX = 32767

MAX_CU_SIZE = 64
MAX_CU_DEPTH = 4
