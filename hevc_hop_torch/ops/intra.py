"""Batched intra prediction and SATD; kernel C2.

Counterpart of hevc_hop_tpu/ops/intra.py. The reference chain layout is the
same: ref[4N+1] per block, index 0..2N-1 the left column bottom-to-top,
2N the corner, 2N+1..4N the top row left-to-right.

:func:`intra_blocks` is the wrapper of kernel C2 (``csrc/intra.cu``): for a
batch of blocks it gathers each chain from the recon plane, substitutes and
filters it, and then either runs the 35-mode SATD decision (RMD) or
predicts one given mode, with an optional decode epilogue that adds the
residual and writes the recon in place. On a CUDA tensor it launches the
kernel; on a CPU tensor it runs :func:`intra_blocks_plain`, built from the
plain functions below (which run on any device).

All arithmetic is int32, bit-exact with H.265 8.4.4.2.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from hevc_hop_torch import _cuda
from hevc_hop_torch.common import rom
from hevc_hop_torch.models import wavefront
from hevc_hop_torch.ops.quant import argmin_first

LAUNCHES = 0

_FILTER_THRESH = {2: 10, 3: 7, 4: 1, 5: 0}


@functools.lru_cache(maxsize=None)
def static_tables(n: int) -> dict:
    """Per-mode gather tables for an NxN block (numpy; see the reference's
    ``_static_tables``): ext_idx [33, 3N+1], pred_idx [33, N, N],
    fact [33, N], is_hor [33], filt [33]."""
    log2 = n.bit_length() - 1
    thresh = _FILTER_THRESH[log2]
    ext_idx = np.zeros((33, 3 * n + 1), np.int32)
    pred_idx = np.zeros((33, n, n), np.int32)
    fact = np.zeros((33, n), np.int32)
    is_hor = np.zeros(33, bool)
    filt = np.zeros(33, bool)
    for mi in range(33):
        mode = mi + 2
        angle = int(rom.INTRA_PRED_ANGLE[mi])
        inv_angle = int(rom.INTRA_INV_ANGLE[mi])
        hor = mode < 18
        is_hor[mi] = hor
        filt[mi] = min(abs(mode - 26), abs(mode - 10)) > thresh

        def left_c(y):
            return 2 * n - 1 - y

        def top_c(x):
            return 2 * n + 1 + x

        for i in range(0, 2 * n + 1):
            ext_idx[mi, n + i] = top_c(i - 1) if not hor else left_c(i - 1)
        if angle < 0:
            for k in range(1, n + 1):
                j = ((-k * inv_angle + 128) >> 8) - 1
                ext_idx[mi, n - k] = left_c(j) if not hor else top_c(j)
        for y in range(n):
            off = ((y + 1) * angle) >> 5
            fact[mi, y] = ((y + 1) * angle) & 31
            pred_idx[mi, y, :] = n + 1 + np.arange(n) + off
    return dict(ext_idx=ext_idx, pred_idx=pred_idx, fact=fact,
                is_hor=is_hor, filt=filt)


@functools.lru_cache(maxsize=None)
def hadamard(k: int) -> np.ndarray:
    h = np.array([[1]], np.int32)
    while h.shape[0] < k:
        h = np.block([[h, h], [h, -h]])
    return h


def substitute_refs(chain: torch.Tensor, avail: torch.Tensor,
                    bit_depth: int = 8) -> torch.Tensor:
    """Reference substitution (H.265 8.4.4.2.2) over [B, 4N+1] chains."""
    length = chain.shape[-1]
    avail = avail.to(torch.bool)
    pos = torch.arange(length, dtype=torch.int64, device=chain.device)
    idx = torch.where(avail, pos, -1)
    prev = torch.cummax(idx, dim=-1).values
    first = torch.argmax(avail.to(torch.int32), dim=-1)
    gather = torch.where(prev >= 0, prev, first[..., None])
    out = torch.gather(chain, -1, gather)
    any_avail = avail.any(-1, keepdim=True)
    return torch.where(any_avail, out,
                       torch.full_like(out, 1 << (bit_depth - 1)))


def filter_refs(chain: torch.Tensor, strong: bool = False,
                bit_depth: int = 8) -> torch.Tensor:
    """1-2-1 smoothing (+ the 32x32 strong bilinear smoothing)."""
    n = (chain.shape[-1] - 1) // 4
    inner = (chain[..., :-2] + 2 * chain[..., 1:-1] + chain[..., 2:] + 2) >> 2
    filt = torch.cat([chain[..., :1], inner, chain[..., -1:]], dim=-1)
    if strong and n == 32:
        thr = 1 << (bit_depth - 5)
        corner = chain[..., 2 * n]
        top_last = chain[..., 4 * n]
        left_last = chain[..., 0]
        top_mid = chain[..., 3 * n]
        left_mid = chain[..., n]
        cond = ((torch.abs(corner + top_last - 2 * top_mid) < thr)
                & (torch.abs(corner + left_last - 2 * left_mid) < thr))
        i = torch.arange(63, dtype=torch.int32, device=chain.device)
        top_s = ((63 - i)[None] * corner[..., None]
                 + (i + 1)[None] * top_last[..., None] + 32) >> 6
        left_s = ((63 - i)[None] * corner[..., None]
                  + (i + 1)[None] * left_last[..., None] + 32) >> 6
        smooth = torch.cat([left_last[..., None], left_s.flip(-1),
                            corner[..., None], top_s, top_last[..., None]],
                           dim=-1)
        filt = torch.where(cond[..., None], smooth, filt)
    return filt


def _refs(chain_u, n, c_idx, bit_depth, strong_smoothing):
    use_filter = c_idx == 0 and n > 4
    chain_f = (filter_refs(chain_u, strong=strong_smoothing and c_idx == 0,
                           bit_depth=bit_depth) if use_filter else chain_u)
    return use_filter, chain_f


def _planar_dc(chain_u, chain_f, n, c_idx, use_filter):
    log2 = n.bit_length() - 1
    dev = chain_u.device
    left = chain_u[..., :2 * n].flip(-1)
    top = chain_u[..., 2 * n + 1:]
    pl = chain_f[..., :2 * n].flip(-1) if use_filter else left
    pt = chain_f[..., 2 * n + 1:] if use_filter else top
    x = torch.arange(n, dtype=torch.int32, device=dev)
    planar = ((n - 1 - x)[None, None, :] * pl[:, :n, None]
              + (x + 1)[None, None, :] * pt[:, n, None, None]
              + (n - 1 - x)[None, :, None] * pt[:, None, :n]
              + (x + 1)[None, :, None] * pl[:, n, None, None]
              + n) >> (log2 + 1)
    dc = (top[:, :n].sum(-1, dtype=torch.int32)
          + left[:, :n].sum(-1, dtype=torch.int32) + n) >> (log2 + 1)
    dc_blk = dc[:, None, None].expand(-1, n, n).clone()
    if c_idx == 0 and n < 32:
        dc_blk[:, 0, :] = (top[:, :n] + 3 * dc[:, None] + 2) >> 2
        dc_blk[:, :, 0] = (left[:, :n] + 3 * dc[:, None] + 2) >> 2
        dc_blk[:, 0, 0] = (left[:, 0] + 2 * dc + top[:, 0] + 2) >> 2
    return planar, dc_blk, left, top


def _angular(chain_u, chain_f, n, mi, use_filter):
    """Angular prediction of modes mi + 2 ([B] or [33] table rows) in the
    vertical formulation, transposed for the horizontal family."""
    tabs = static_tables(n)
    dev = chain_u.device
    t = lambda k: torch.as_tensor(tabs[k], device=dev)
    both = torch.stack([chain_u, chain_f], dim=1)            # [B, 2, L]
    sel = (t("filt")[mi] & bool(use_filter)).long()          # [B, M]
    # entries of the side reference beyond what a mode reads point outside
    # the chain; the reference's gather clamps them, and so does this one
    ei = t("ext_idx").long()[mi].clamp(0, 4 * n)             # [B, M, 3N+1]
    ext = torch.gather(both[:, None].expand(-1, mi.shape[1], -1, -1), 3,
                       ei[:, :, None].expand(-1, -1, 2, -1))
    ext = torch.gather(ext, 2, sel[..., None, None].expand(
        -1, -1, 1, ext.shape[-1]))[:, :, 0]                  # [B, M, 3N+1]
    pidx = t("pred_idx").long()[mi].reshape(*mi.shape, n * n)
    f = t("fact")[mi][..., None]                             # [B, M, N, 1]
    g0 = torch.gather(ext, 2, pidx).reshape(*mi.shape, n, n)
    # at fact == 0 the second tap has weight 0 and may point one past
    # the extended reference; clamp it (the reference's gather is masked
    # by that weight too)
    g1 = torch.gather(ext, 2, (pidx + 1).clamp(max=3 * n)).reshape(
        *mi.shape, n, n)
    ang = ((32 - f) * g0 + f * g1 + 16) >> 5
    hor = t("is_hor")[mi][..., None, None]
    return torch.where(hor, ang.transpose(-1, -2), ang)


def predict_all_modes(chain_u: torch.Tensor, n: int, c_idx: int = 0,
                      bit_depth: int = 8,
                      strong_smoothing: bool = True) -> torch.Tensor:
    """All 35 intra predictions from substituted chains: [B, 35, N, N]."""
    use_filter, chain_f = _refs(chain_u, n, c_idx, bit_depth,
                                strong_smoothing)
    planar, dc_blk, left, top = _planar_dc(chain_u, chain_f, n, c_idx,
                                           use_filter)
    b = chain_u.shape[0]
    mi = torch.arange(33, device=chain_u.device)[None].expand(b, -1)
    ang = _angular(chain_u, chain_f, n, mi, use_filter)
    if c_idx == 0 and n < 32:
        maxv = (1 << bit_depth) - 1
        corner = chain_u[..., 2 * n]
        ang[:, 24, :, 0] = torch.clamp(
            top[:, 0, None] + ((left[:, :n] - corner[:, None]) >> 1), 0, maxv)
        ang[:, 8, 0, :] = torch.clamp(
            left[:, 0, None] + ((top[:, :n] - corner[:, None]) >> 1), 0, maxv)
    out = torch.cat([planar[:, None], dc_blk[:, None], ang], dim=1)
    return torch.clamp(out, 0, (1 << bit_depth) - 1)


def predict_mode(chain_u: torch.Tensor, modes: torch.Tensor, n: int,
                 c_idx: int = 0, bit_depth: int = 8,
                 strong_smoothing: bool = True) -> torch.Tensor:
    """One intra prediction per block for a known mode vector [B]."""
    use_filter, chain_f = _refs(chain_u, n, c_idx, bit_depth,
                                strong_smoothing)
    planar, dc_blk, left, top = _planar_dc(chain_u, chain_f, n, c_idx,
                                           use_filter)
    modes = modes.to(torch.int32)
    mi = torch.clamp(modes - 2, 0, 32).long()[:, None]
    ang = _angular(chain_u, chain_f, n, mi, use_filter)[:, 0]
    if c_idx == 0 and n < 32:
        maxv = (1 << bit_depth) - 1
        corner = chain_u[..., 2 * n]
        col = torch.clamp(
            top[:, 0, None] + ((left[:, :n] - corner[:, None]) >> 1), 0, maxv)
        row = torch.clamp(
            left[:, 0, None] + ((top[:, :n] - corner[:, None]) >> 1), 0, maxv)
        v = ang.clone()
        v[:, :, 0] = col
        ang = torch.where((modes == 26)[:, None, None], v, ang)
        h = ang.clone()
        h[:, 0, :] = row
        ang = torch.where((modes == 10)[:, None, None], h, ang)
    out = torch.where((modes == 0)[:, None, None], planar,
                      torch.where((modes == 1)[:, None, None], dc_blk, ang))
    return torch.clamp(out, 0, (1 << bit_depth) - 1)


def satd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum of absolute Hadamard-transformed differences over [..., N, N]
    (8x8 Hadamard for N >= 8, 4x4 for N = 4). Returns [...] int32."""
    n = a.shape[-1]
    k = 8 if n >= 8 else 4
    h = torch.as_tensor(hadamard(k), dtype=torch.float64, device=a.device)
    d = (a - b).to(torch.int32)
    lead = d.shape[:-2]
    d = d.reshape(*lead, n // k, k, n // k, k).transpose(-3, -2)
    t = torch.matmul(torch.matmul(h, d.to(torch.float64)), h).to(torch.int32)
    s = torch.abs(t).sum((-1, -2), dtype=torch.int32)
    s = (s + 2) >> 2 if k == 8 else (s + 1) >> 1
    return s.sum((-1, -2), dtype=torch.int32)


# ---------------------------------------------------------------------------
# Kernel C2 and its plain version.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _chain_coords(n: int) -> np.ndarray:
    return wavefront.chain_coords(np.zeros((1, 2), np.int64), n)[0]


def gather_chains(plane: torch.Tensor, pos: torch.Tensor,
                  n: int) -> torch.Tensor:
    """[B, 4N+1] chains of the blocks at pos [B, 2] (x, y), coordinates
    clamped to the plane (the reference's ``_gather_chains``)."""
    co = torch.as_tensor(_chain_coords(n), dtype=torch.int64,
                         device=plane.device)
    pos = pos.to(torch.int64)
    cx = (pos[:, 0:1] + co[None, :, 0]).clamp(0, plane.shape[1] - 1)
    cy = (pos[:, 1:2] + co[None, :, 1]).clamp(0, plane.shape[0] - 1)
    return plane[cy, cx]


def block_index(pos: torch.Tensor, n: int):
    """(rows, cols) [B, N, N] index grids of the blocks at pos."""
    ar = torch.arange(n, dtype=torch.int64, device=pos.device)
    pos = pos.to(torch.int64)
    rows = (pos[:, 1, None, None] + ar[None, :, None]).expand(-1, n, n)
    cols = (pos[:, 0, None, None] + ar[None, None, :]).expand(-1, n, n)
    return rows, cols


def _period(t: torch.Tensor, count: int) -> torch.Tensor:
    """Repeat a per-block array of ``period`` rows to ``count`` rows (cb and
    cr blocks share their availability and mode)."""
    reps = count // t.shape[0]
    return t if reps == 1 else t.repeat(reps, *([1] * (t.dim() - 1)))


def intra_blocks_plain(plane, pos, avail, modes, n, c_idx, bit_depth=8,
                       strong=True, org=None, resi=None):
    """Plain version of :func:`intra_blocks` (same arguments, same
    results)."""
    b = pos.shape[0]
    avail = _period(avail, b)
    modes = _period(modes, b)
    chains = substitute_refs(gather_chains(plane, pos, n), avail, bit_depth)
    rows, cols = block_index(pos, n)
    if org is not None:
        preds = predict_all_modes(chains, n, c_idx, bit_depth, strong)
        costs = satd(org[rows, cols].to(torch.int32)[:, None], preds)
        best = argmin_first(costs).to(torch.int32)
        best = torch.where(modes >= 0, modes.to(torch.int32), best)
        pred = torch.gather(preds, 1, best.long()[:, None, None, None].expand(
            -1, 1, n, n))[:, 0]
        return pred, best
    pred = predict_mode(chains, modes, n, c_idx, bit_depth, strong)
    if resi is None:
        return pred, None
    rec = torch.clamp(pred + resi[rows, cols], 0, (1 << bit_depth) - 1)
    plane[rows, cols] = rec.to(plane.dtype)
    return None, None


def intra_blocks(plane, pos, avail, modes, n, c_idx, bit_depth=8,
                 strong=True, org=None, resi=None):
    """Kernel C2 over B blocks of size n.

    plane [H, W] int32 recon (chains are read from it; the decode epilogue
    writes it). pos [B, 2] int32 (x, y). avail [P, 4n+1] bool and modes
    [P] int32, where P divides B: block i reads row i % P (cb and cr share
    theirs). Three forms:

    - ``org`` given (RMD): returns (pred [B, n, n], best [B]); a block whose
      mode is >= 0 keeps it, -1 chooses by 35-mode SATD, ties to the lowest
      mode;
    - neither: returns (pred, None) for the given modes;
    - ``resi`` given (decode): writes clip(pred + resi) into ``plane`` at
      each block and returns (None, None).
    """
    if not plane.is_cuda:
        return intra_blocks_plain(plane, pos, avail, modes, n, c_idx,
                                  bit_depth, strong, org, resi)
    return _intra_cuda(plane, pos, avail, modes, n, c_idx, bit_depth,
                       strong, org, resi)


def _check(t, dtype, name):
    if not (t.is_cuda and t.dtype == dtype and t.is_contiguous()):
        raise ValueError(f"intra_blocks: {name} must be a contiguous CUDA "
                         f"{dtype} tensor")


def _intra_cuda(plane, pos, avail, modes, n, c_idx, bit_depth, strong, org,
                resi):
    global LAUNCHES
    from hevc_hop_torch.convert import device_tables
    b = pos.shape[0]
    _check(plane, torch.int32, "plane")
    _check(pos, torch.int32, "pos")
    _check(avail, torch.bool, "avail")
    _check(modes, torch.int32, "modes")
    if b % avail.shape[0] or b % modes.shape[0]:
        raise ValueError("intra_blocks: avail/modes rows must divide B")
    if avail.shape[1] != 4 * n + 1:
        raise ValueError("intra_blocks: avail must be [P, 4n+1]")
    for t, name in ((org, "org"), (resi, "resi")):
        if t is not None:
            _check(t, torch.int32, name)
            if t.stride(1) != 1:
                raise ValueError(f"intra_blocks: {name} rows must be dense")
    tab = device_tables(plane.device)
    pred = best = None
    if resi is None:
        pred = torch.empty((b, n, n), dtype=torch.int32, device=plane.device)
    if org is not None:
        best = torch.empty(b, dtype=torch.int32, device=plane.device)
    if b == 0:
        return pred, best
    k = f"intra{n}"
    fn = _cuda.bind("intra", "hh_intra", "piii" "pi" "pi" "ppp" "ii"
                    "iiiii" "pppppp" "ppp")
    nul = None
    err = fn(plane.data_ptr(), plane.shape[0], plane.shape[1],
             plane.stride(0), nul if org is None else org.data_ptr(),
             0 if org is None else org.stride(0),
             nul if resi is None else resi.data_ptr(),
             0 if resi is None else resi.stride(0),
             pos.data_ptr(), avail.data_ptr(), modes.data_ptr(),
             avail.shape[0], modes.shape[0],
             b, n, c_idx, bit_depth, int(strong),
             tab[k + "_ext_idx"].data_ptr(), tab[k + "_pred_idx"].data_ptr(),
             tab[k + "_fact"].data_ptr(), tab[k + "_is_hor"].data_ptr(),
             tab[k + "_filt"].data_ptr(),
             tab["hadamard4" if n == 4 else "hadamard8"].data_ptr(),
             nul if pred is None else pred.data_ptr(),
             nul if best is None else best.data_ptr(),
             _cuda.stream(plane))
    _cuda.check("intra", err)
    LAUNCHES += 1
    return pred, best
