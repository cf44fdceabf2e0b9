"""Motion-compensation interpolation, bit-exact; kernel C8.

Counterpart of hevc_hop_tpu/ops/interp.py: the 8-tap quarter-pel luma and
4-tap eighth-pel chroma filters of H.265 8.5.3.3.3, as two separable stages
with 14-bit intermediates, run unconditionally (phase 0 is [0, 64, 0, 0],
which the two stages turn back into the sample). :func:`filter_2d`,
:func:`luma_mc` and :func:`chroma_mc_q` are the reference's functions in
plain PyTorch (the reference's dead ``chroma_mc`` is not ported).

:func:`mc_blocks` is the wrapper of kernel C8 (``csrc/interp.cu``): motion
compensation of a batch of blocks out of a recon plane, luma or the stacked
cb/cr plane (cb rows [0, hc), cr rows [hc_off, hc_off + hc)), with two
optional epilogues: write the prediction only into the blocks a mask
selects (the encoder's chroma, over C2's intra prediction), or add the
residual and write the clipped recon in place (the decoder). On a CUDA
tensor it launches the kernel; on a CPU tensor it runs
:func:`mc_blocks_plain`.
"""
from __future__ import annotations

import numpy as np
import torch

from hevc_hop_torch import _cuda

LUMA_LAUNCHES = 0
CHROMA_LAUNCHES = 0

IF_FILTER_PREC = 6
IF_INTERNAL_PREC = 14
IF_INTERNAL_OFFS = 1 << (IF_INTERNAL_PREC - 1)  # 8192

# TComInterpolationFilter.cpp:49: 8-tap luma, quarter-pel phases 0..3
LUMA_FILTER = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
], np.int32)

# TComInterpolationFilter.cpp:62: 4-tap chroma, eighth-pel phases 0..7
CHROMA_FILTER = np.array([
    [0, 64, 0, 0],
    [-2, 58, 10, -2],
    [-4, 54, 16, -2],
    [-6, 46, 28, -4],
    [-4, 36, 36, -4],
    [-4, 28, 46, -6],
    [-2, 16, 54, -4],
    [-2, 10, 58, -2],
], np.int32)


def filter_2d(window: torch.Tensor, wh: torch.Tensor, wv: torch.Tensor,
              out_n: int, bit_depth: int = 8) -> torch.Tensor:
    """Two-stage separable MC filter over batched windows [B, out_n + T - 1,
    out_n + T - 1] int32 with per-block taps wh, wv [B, T]. Returns
    [B, out_n, out_n] int32 clipped to bit_depth."""
    t = wh.shape[-1]
    headroom = IF_INTERNAL_PREC - bit_depth
    shift1 = IF_FILTER_PREC - headroom
    off1 = -(IF_INTERNAL_OFFS << shift1)
    shift2 = IF_FILTER_PREC + headroom
    off2 = (IF_INTERNAL_OFFS << IF_FILTER_PREC) + (1 << (shift2 - 1))
    window = window.to(torch.int32)
    wh, wv = wh.to(torch.int32), wv.to(torch.int32)
    cols = torch.stack([window[:, :, k:k + out_n] for k in range(t)], -1)
    mid = ((cols * wh[:, None, None, :]).sum(-1, dtype=torch.int32)
           + off1) >> shift1
    rows = torch.stack([mid[:, k:k + out_n, :] for k in range(t)], -1)
    out = ((rows * wv[:, None, None, :]).sum(-1, dtype=torch.int32)
           + off2) >> shift2
    return torch.clamp(out, 0, (1 << bit_depth) - 1)


def _window(plane, pos, mvi, t, n, row_lo, row_hi):
    """[B, n+t-1, n+t-1] samples whose top-left is pos + mvi - (t/2 - 1),
    rows clamped to [row_lo, row_hi] ([B] each), columns to the plane."""
    ar = torch.arange(n + t - 1, device=plane.device)
    y0 = (pos[:, 1] + mvi[:, 1] - (t // 2 - 1)).long()
    x0 = (pos[:, 0] + mvi[:, 0] - (t // 2 - 1)).long()
    ry = torch.minimum(torch.maximum(y0[:, None] + ar[None],
                                     row_lo.long()[:, None]),
                       row_hi.long()[:, None])
    rx = (x0[:, None] + ar[None]).clamp(0, plane.shape[1] - 1)
    return plane[ry[:, :, None], rx[:, None, :]]


def _mc(plane, pos, mv, n, chroma, row_lo, row_hi, bit_depth):
    mv = mv.to(torch.int32)
    if chroma:
        tab, t, sh, mask = CHROMA_FILTER, 4, 3, 7
    else:
        tab, t, sh, mask = LUMA_FILTER, 8, 2, 3
    taps = torch.as_tensor(tab, device=plane.device)
    frac = (mv & mask).long()
    win = _window(plane, pos, mv >> sh, t, n, row_lo, row_hi)
    return filter_2d(win, taps[frac[:, 0]], taps[frac[:, 1]], n, bit_depth)


def luma_mc(plane, pos, mv_qpel, n: int, h_clip: int, bit_depth: int = 8):
    """Luma MC at quarter-pel precision out of plane [H(+pad), W] at the
    blocks pos [B, 2] (x, y), rows read up to h_clip - 1. [B, n, n]."""
    b = pos.shape[0]
    lo = torch.zeros(b, dtype=torch.int64, device=plane.device)
    return _mc(plane, pos, mv_qpel, n, False, lo, lo + h_clip - 1,
               bit_depth)


def chroma_mc_q(plane, cpos, mv_qpel, m: int, h_clip: int,
                bit_depth: int = 8):
    """Chroma MC for quarter-pel luma MVs (in 4:2:0 the luma quarter-pel MV
    is the chroma eighth-pel MV) at the chroma blocks cpos [B, 2]."""
    b = cpos.shape[0]
    lo = torch.zeros(b, dtype=torch.int64, device=plane.device)
    return _mc(plane, cpos, mv_qpel, m, True, lo, lo + h_clip - 1,
               bit_depth)


# ---------------------------------------------------------------------------
# Kernel C8 and its plain version.
# ---------------------------------------------------------------------------

def _rows(pos, chroma, h_real, hc_off):
    """Per-block clamp rows: luma [0, h_real); on the stacked chroma plane
    the cb blocks [0, hc) and the cr blocks (y >= hc_off) [hc_off,
    hc_off + hc)."""
    y = pos[:, 1].long()
    lo = torch.where(y >= hc_off, hc_off, 0) if chroma else torch.zeros_like(y)
    return lo, lo + h_real - 1


def mc_blocks_plain(plane, pos, mv, n, chroma, h_real, bit_depth=8,
                    hc_off=0, out=None, only=None, resi=None):
    """Plain version of :func:`mc_blocks` (same arguments, same results)."""
    b = pos.shape[0]
    mv = mv if mv.shape[0] == b else mv.repeat(b // mv.shape[0], 1)
    lo, hi = _rows(pos, chroma, h_real, hc_off)
    pred = _mc(plane, pos, mv, n, chroma, lo, hi, bit_depth)
    if resi is not None:
        ar = torch.arange(n, device=plane.device)
        rows = (pos[:, 1, None, None].long() + ar[None, :, None]).expand(
            -1, n, n)
        cols = (pos[:, 0, None, None].long() + ar[None, None, :]).expand(
            -1, n, n)
        plane[rows, cols] = torch.clamp(pred + resi[rows, cols], 0,
                                        (1 << bit_depth) - 1)
        return None
    if out is None:
        return pred
    sel = only if only.shape[0] == b else only.repeat(b // only.shape[0])
    out[sel != 0] = pred[sel != 0]
    return out


def mc_blocks(plane, pos, mv, n, chroma, h_real, bit_depth=8, hc_off=0,
              out=None, only=None, resi=None):
    """Kernel C8 over B blocks of size n.

    plane [H, W] int32: the luma recon, or the stacked cb/cr recon
    (``chroma``, cr from row ``hc_off``); pos [B, 2] int32 (x, y) in the
    plane; mv [P, 2] int32 quarter-pel luma MVs, P dividing B (block i
    takes row i % P: cb and cr share theirs). Rows are read clamped to
    the block's own picture of ``h_real`` rows, columns to the plane.
    Three forms:

    - neither ``out`` nor ``resi``: returns the prediction [B, n, n];
    - ``out`` [B, n, n] and ``only`` [P] int32: writes the prediction into
      the blocks whose ``only`` is non-zero, leaves the others, and returns
      ``out``;
    - ``resi`` (plane-shaped int32): writes clip(pred + resi) into
      ``plane`` at each block and returns None.
    """
    if not plane.is_cuda:
        return mc_blocks_plain(plane, pos, mv, n, chroma, h_real, bit_depth,
                               hc_off, out, only, resi)
    return _mc_cuda(plane, pos, mv, n, chroma, h_real, bit_depth, hc_off,
                    out, only, resi)


def _check(t, dtype, name):
    if not (t.is_cuda and t.dtype == dtype and t.stride(-1) == 1):
        raise ValueError(f"mc_blocks: {name} must be a CUDA {dtype} tensor "
                         "with dense rows")


def _mc_cuda(plane, pos, mv, n, chroma, h_real, bit_depth, hc_off, out,
             only, resi):
    global LUMA_LAUNCHES, CHROMA_LAUNCHES
    b = pos.shape[0]
    _check(plane, torch.int32, "plane")
    for t, nm in ((pos, "pos"), (mv, "mv")):
        _check(t, torch.int32, nm)
        if not t.is_contiguous():
            raise ValueError(f"mc_blocks: {nm} must be contiguous")
    if b % max(mv.shape[0], 1):
        raise ValueError("mc_blocks: mv rows must divide B")
    ret = None
    if resi is not None:
        _check(resi, torch.int32, "resi")
    elif out is not None:
        _check(out, torch.int32, "out")
        _check(only, torch.int32, "only")
        if not out.is_contiguous() or b % only.shape[0]:
            raise ValueError("mc_blocks: out [B, n, n], only [P]")
        ret = out
    else:
        out = torch.empty((b, n, n), dtype=torch.int32, device=plane.device)
        ret = out
    if b == 0:
        return ret
    fn = _cuda.bind("interp", "hh_mc_blocks", "piii" "ppi" "iiiiii" "ppi"
                    "pi" "p")
    err = fn(plane.data_ptr(), plane.shape[0], plane.shape[1],
             plane.stride(0), pos.data_ptr(), mv.data_ptr(), mv.shape[0],
             b, n, int(chroma), h_real, hc_off, bit_depth,
             None if out is None else out.data_ptr(),
             None if only is None else only.data_ptr(),
             0 if only is None else only.shape[0],
             None if resi is None else resi.data_ptr(),
             0 if resi is None else resi.stride(0), _cuda.stream(plane))
    _cuda.check("interp", err)
    if chroma:
        CHROMA_LAUNCHES += 1
    else:
        LUMA_LAUNCHES += 1
    return ret
