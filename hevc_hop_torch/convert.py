"""State carried across from the reference package.

The codec has no learned weights: what plays their part is its constant
tables and its configuration. :func:`config_from_reference` builds the
port's :class:`EncoderConfig` from the reference's (as the dict
``dataclasses.asdict`` gives), and :func:`device_tables` builds, from the
port's own copy of the ROM tables, the constant tensors the kernels read.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from hevc_hop_torch.common import rom
from hevc_hop_torch.ops import deblock, intra


def config_from_reference(fields: dict):
    """EncoderConfig of the port from ``dataclasses.asdict`` of the
    reference's. Raises on a field the port does not know."""
    from hevc_hop_torch.models.encoder import EncoderConfig
    known = {f.name for f in dataclasses.fields(EncoderConfig)}
    extra = set(fields) - known
    if extra:
        raise ValueError(f"unknown EncoderConfig fields: {sorted(extra)}")
    return EncoderConfig(**fields)


def host_tables() -> dict:
    """The kernels' constant tables as numpy arrays, by name."""
    out = {f"dct{n}": rom.dct_matrix(n) for n in (4, 8, 16, 32)}
    out["dst4"] = rom.DST4
    out["quant_scales"] = rom.QUANT_SCALES
    out["inv_quant_scales"] = rom.INV_QUANT_SCALES
    for n in (4, 8, 16, 32):
        for k, v in intra.static_tables(n).items():
            out[f"intra{n}_{k}"] = v
    out["hadamard4"] = intra.hadamard(4)
    out["hadamard8"] = intra.hadamard(8)
    out["tc_table"] = deblock.TC_TABLE
    out["beta_table"] = deblock.BETA_TABLE
    for log2 in (2, 3, 4, 5):
        out[f"scan{log2}"] = np.stack(
            [rom.scan_raster_index(log2, s) for s in (0, 1, 2)])
    return out


@functools.lru_cache(maxsize=None)
def _device_tables(device: str) -> dict:
    return {k: torch.as_tensor(np.ascontiguousarray(v).astype(np.int32),
                               device=device)
            for k, v in host_tables().items()}


def device_tables(device) -> dict:
    """:func:`host_tables` as int32 tensors on ``device`` (cached)."""
    return _device_tables(str(torch.device(device)))
