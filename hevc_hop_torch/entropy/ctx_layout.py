"""Context-memory layout shared between Python and the native C++ syntax
codec (single source of truth; native/gen/ctx_layout.h is generated from this
module by tools/gen_native_headers.py).

The ordering is ours (it only has to be consistent between encoder and
decoder); the per-group counts follow H.265 / the reference's ContextTables.h
context allocation, including the IT extension's GT contexts.
"""
from __future__ import annotations

import numpy as np

from hevc_hop_torch.entropy import tables

# (name, count, init_table, column offset into init table)
_GROUPS = [
    ("SAO_MERGE", 1, tables.INIT_SAO_MERGE_FLAG, 0),
    ("SAO_TYPE", 1, tables.INIT_SAO_TYPE_IDX, 0),
    ("SPLIT_FLAG", 3, tables.INIT_SPLIT_FLAG, 0),
    ("TQ_BYPASS", 1, tables.INIT_TQ_BYPASS_FLAG, 0),
    ("SKIP", 3, tables.INIT_SKIP_FLAG, 0),
    ("MERGE_FLAG", 1, tables.INIT_MERGE_FLAG, 0),
    ("MERGE_IDX", 1, tables.INIT_MERGE_IDX, 0),
    ("PART_SIZE", 4, tables.INIT_PART_SIZE, 0),
    ("PRED_MODE", 1, tables.INIT_PRED_MODE, 0),
    ("INTRA_MODE", 1, tables.INIT_INTRA_PRED_MODE, 0),
    ("CHROMA_MODE", 2, tables.INIT_CHROMA_PRED_MODE, 0),
    ("INTER_DIR", 5, tables.INIT_INTER_DIR, 0),
    ("MVD", 2, tables.INIT_MVD, 0),
    ("REF_PIC", 2, tables.INIT_REF_PIC, 0),
    ("DQP", 3, tables.INIT_DQP, 0),
    ("QT_CBF_LUMA", 4, tables.INIT_QT_CBF, 0),
    ("QT_CBF_CHROMA", 4, tables.INIT_QT_CBF, 4),
    ("QT_ROOT_CBF", 1, tables.INIT_QT_ROOT_CBF, 0),
    ("LAST_X_LUMA", 15, tables.INIT_LAST_XY, 0),
    ("LAST_X_CHROMA", 15, tables.INIT_LAST_XY, 15),
    ("LAST_Y_LUMA", 15, tables.INIT_LAST_XY, 0),
    ("LAST_Y_CHROMA", 15, tables.INIT_LAST_XY, 15),
    ("SIG_CG_LUMA", 2, tables.INIT_SIG_CG_FLAG, 0),
    ("SIG_CG_CHROMA", 2, tables.INIT_SIG_CG_FLAG, 2),
    ("SIG_LUMA", 27, tables.INIT_SIG_FLAG, 0),
    ("SIG_CHROMA", 15, tables.INIT_SIG_FLAG, 27),
    ("ONE_LUMA", 16, tables.INIT_ONE_FLAG, 0),
    ("ONE_CHROMA", 8, tables.INIT_ONE_FLAG, 16),
    ("ABS_LUMA", 4, tables.INIT_ABS_FLAG, 0),
    ("ABS_CHROMA", 2, tables.INIT_ABS_FLAG, 4),
    ("MVP_IDX", 1, tables.INIT_MVP_IDX, 0),
    ("TRANS_SUBDIV", 3, tables.INIT_TRANS_SUBDIV_FLAG, 0),
    ("TS_LUMA", 1, tables.INIT_TRANSFORMSKIP_FLAG, 0),
    ("TS_CHROMA", 1, tables.INIT_TRANSFORMSKIP_FLAG, 1),
    ("GT_FLAG", 1, tables.INIT_GT_FLAG, 0),
    ("GT_RES", 2, tables.INIT_GT_RES, 0),
]

OFFSETS: dict[str, int] = {}
_off = 0
for _name, _cnt, _tab, _col in _GROUPS:
    OFFSETS[_name] = _off
    _off += _cnt
NUM_CTX = _off


def init_states(init_type: int, qp: int) -> np.ndarray:
    """All context states for a slice (init_type: 0=B,1=P,2=I,3=ISS,4=PSS)."""
    st = np.zeros(NUM_CTX, np.uint8)
    for name, cnt, tab, col in _GROUPS:
        base = OFFSETS[name]
        for i in range(cnt):
            st[base + i] = tables.init_state(qp, int(tab[init_type, col + i]))
    return st
