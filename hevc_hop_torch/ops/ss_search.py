"""Self-similarity and temporal full searches and their MVD rates; kernel
C9.

Counterpart of hevc_hop_tpu/models/ss_scan.py ``_mvd_bits``,
``_min_rate_bits``, ``_dyn_rate_map``, ``_ss_search`` (with its GT anchor
ring), ``_t_search`` and ``ss_anchor_ok``, and of the search half of
hevc_hop_tpu/models/ss_partition.py ``_ss_rd_size`` (whose wrapper is in
models/ss_partition.py).

:func:`ss_search` is the wrapper of kernel C9's scan entry
(``csrc/ss_search.cu``): for every block, the masked full search over the
(2r+1)^2 full-pel displacements of the causal recon, cost = SSE + lambda *
(INTER_BITS + the least MVD rate over the block's predictors), argmin with
jnp.argmin's first-index rule, and the full-pel prediction; with the GT
on, also the anchor ring: the least cost again, over the displacements
whose whole 2n window (GT's, plus 2 samples of slack) is causal, with the
same tie rule (the reference's lax.top_k with k = 1). The predictors
come from the carried motion planes, gathered in the kernel
(:func:`hevc_hop_torch.ops.inter_arms.gather_cands` is the plain form).
:func:`pss_search` is the same entry on a PSS picture: the SS search as
above (the SS reference is L0's last entry, so its predictors are the
neighbours that name it), and in the same launch the temporal search of
the same blocks over the previous picture (``_t_search``): every
displacement inside the picture is valid, the radius is ``radius_t`` and
the predictors are the neighbours that name the temporal reference, and
zero. The pre-pass entry's wrapper is models/ss_partition.py
``ss_rd_costs``.

Float forms. The reference computes the SSE map in float32 as org^2 +
ref^2 - 2 corr, with corr and ref^2 from XLA:CPU's convolution and org^2
from a reduction. Copied from the compiled reference (ROADMAP.md queue 3,
F8): a convolution sum runs over the kernel in row-major order in blocks
of 512 products, each block as two accumulators (even and odd products,
each one rounded sum after another) added at its end, the blocks added in
order; org^2 is :func:`lane_block_sum`'s order (eight lanes over the
rows, then the lanes by halves; F11). For 8-bit
samples and n <= 16 every one of these sums is exact. The PSS program
(``scan_encode_pss``) compiles both searches' convolutions otherwise
(ROADMAP.md queue 3, F10): each sum runs over the kernel in row-major
order, one rounded add after another (``seq``); org^2 keeps
:func:`block_sum`'s order there. The rate map lam *
(INTER_BITS + bits) is rounded on its own and then added to the SSE (in
the compiled search it is a fusion of its own, unlike the refinement's
cost, a fused multiply-add).
floor(log2) of the MVD rate is the reference's float32 one, one low where
|v| / 2 is exactly 2^13 or 2^15 (R5's quirk).

On a CUDA tensor the wrappers launch the kernel; on a CPU tensor they run
the ``*_plain`` version.
"""
from __future__ import annotations

import numpy as np
import torch

from hevc_hop_torch import _cuda
from hevc_hop_torch.ops import quant
from hevc_hop_torch.ops.quant import argmin_first, seq_sum

SEARCH_LAUNCHES = 0
# launches of the scan entry that also found the GT anchor ring
RING_LAUNCHES = 0
# launches of the scan entry that also ran the temporal search (PSS)
TEMPORAL_LAUNCHES = 0

IFM = 4           # luma margin covering the chroma MC filter reach
INTRA_BITS = 8.0  # flag + mode rate proxy for the SSE-domain tournament
INTER_BITS = 6.0  # skip/merge/inter flags + refidx proxy
HUGE_PRED = 1 << 19   # sentinel predictor coordinate: never wins a min
SS_IDX_PSS = 1        # a PSS picture's L0: [previous picture, SS]
BIG = 3.0e38
# products per block of XLA:CPU's convolution sum (see the docstring)
CONV_BLOCK = 512


def f32(v: float) -> float:
    return float(np.float32(v))


def mvd_bits(v: torch.Tensor) -> torch.Tensor:
    """float32 MVD bin count per component (quarter-pel units): greater0 /
    greater1 flags, EG1 remainder and sign of codeMvd, one bit per bin.
    For |v| >= 2 that is 5 + 2 floor(log2(|v| / 2)), with the reference's
    float32 floor(log2) (one low where |v| / 2 is exactly 2^13 or 2^15)."""
    a = torch.abs(v.to(torch.int32))
    fl = (quant.bit_length(a >> 1) - 1
          - ((a == 16384) | (a == 65536)).to(torch.int32)).to(torch.float32)
    return torch.where(a == 0, 1.0, torch.where(a == 1, 3.0, 5.0 + 2.0 * fl))


def min_rate_bits(mvq: torch.Tensor, preds: torch.Tensor) -> torch.Tensor:
    """Least MVD bits of mvq [B, K, 2] (quarter-pel) over the predictors
    preds [B, P, 2]: [B, K] float32."""
    bits = (mvd_bits(mvq[:, :, None, 0] - preds[:, None, :, 0])
            + mvd_bits(mvq[:, :, None, 1] - preds[:, None, :, 1]))
    return bits.amin(2)


def rate_bits_map(preds: torch.Tensor, radius: int) -> torch.Tensor:
    """[B, D, D] (dy, dx) least MVD bits of every full-pel displacement
    over preds [B, P, 2] (invalid predictors sit at HUGE_PRED)."""
    d4 = 4 * torch.arange(-radius, radius + 1, dtype=torch.int32,
                          device=preds.device)
    bx = mvd_bits(d4[None, None, :] - preds[:, :, 0:1])     # [B, P, D]
    by = mvd_bits(d4[None, None, :] - preds[:, :, 1:2])
    return (by[:, :, :, None] + bx[:, :, None, :]).amin(1)


def search_rate(lam: float, bits: torch.Tensor):
    """float32 rate map lam * (INTER_BITS + bits), rounded on its own: the
    reference's compiled search adds it so to the SSE."""
    return torch.tensor(f32(lam), dtype=torch.float32) * (bits + INTER_BITS)


# ---------------------------------------------------------------------------
# Plain version.
# ---------------------------------------------------------------------------

def conv_sum(win: torch.Tensor, ker: torch.Tensor, n: int, d: int,
             seq: bool = False):
    """[B, d, d] float32 sums over the n x n kernel ker [B, n, n] of
    win[b, dy + ky, dx + kx] * ker[b, ky, kx] (non-negative integers), in
    XLA:CPU's order: F8's blocked order, or with ``seq`` the PSS program's
    row-major sequential one. Where a sum stays below 2^24 every partial
    sum is an exact integer in any order, so the exact float64 sum is
    taken; the ordered float32 sums run only for the blocks that pass
    2^24."""
    b = win.shape[0]
    exact = torch.nn.functional.conv2d(win.double()[None],
                                       ker.double()[:, None], groups=b)[0]
    out = exact.float()
    big = (exact >= 2.0 ** 24).flatten(1).any(1)
    if big.any():
        out[big] = _conv_sum_ordered(win[big], ker[big], n, d,
                                     n * n if seq else CONV_BLOCK,
                                     1 if seq else 2)
    return out


def _conv_sum_ordered(win, ker, n, d, block, lanes):
    total = None
    for k0 in range(0, n * n, block):
        acc = [None] * lanes
        for k in range(k0, min(k0 + block, n * n)):
            ky, kx = divmod(k, n)
            t = win[:, ky:ky + d, kx:kx + d] * ker[:, ky, kx, None, None]
            j = (k - k0) % lanes
            acc[j] = t if acc[j] is None else acc[j] + t
        s = acc[0]
        for a in acc[1:]:
            if a is not None:
                s = s + a
        total = s if total is None else total + s
    return total


def block_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum over the last two axes [..., n, n] in XLA:CPU's order of
    the reference's jnp.sum over a block: each row one rounded add after
    another, then the row sums pairwise by halves (rows [0, n/2) plus rows
    [n/2, n), recursively)."""
    rows = seq_sum(x)
    while rows.shape[-1] > 1:
        half = rows.shape[-1] // 2
        rows = rows[..., :half] + rows[..., half:]
    return rows[..., 0]


def lane_block_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum over the last two axes [..., n, n] (n a multiple of 8)
    in the order XLA:CPU compiles the jitted searches' org^2 reduction
    (``_ss_search``, ``_t_search``; read from its LLVM IR and machine code,
    ROADMAP.md queue 3, F11): eight vector lanes, lane l adding rows l,
    l + 8, ... in row-major order, one rounded add after another; then the
    lanes by halves, (l, l + 4), (k, k + 2), (0, 1). At n = 8 it is
    :func:`block_sum`'s order."""
    n = x.shape[-1]
    lanes = x.reshape(*x.shape[:-2], n // 8, 8, n).transpose(-3, -2)
    return quant.fold_lanes(seq_sum(lanes.reshape(*x.shape[:-2], 8,
                                                  n * n // 8)))


def _search_window(recon, pos, n, radius, h):
    ar = torch.arange(n + 2 * radius, device=recon.device)
    ry = (pos[:, 1, None].long() - radius + ar[None]).clamp(0, h - 1)
    rx = (pos[:, 0, None].long() - radius + ar[None]).clamp(
        0, recon.shape[1] - 1)
    return recon[ry[:, :, None], rx[:, None, :]]


def block_at(plane, pos, n):
    """[B, n, n] samples of the blocks at pos [B, 2] (x, y) of plane."""
    ar = torch.arange(n, device=plane.device)
    return plane[pos[:, 1, None, None].long() + ar[None, :, None],
                 pos[:, 0, None, None].long() + ar[None, None, :]]


def ss_anchor_ok(pos, zcur, zmax2n, disp, n, w, h):
    """[B] bool: the GT window of the block at pos displaced by disp
    [B, 2] (full pel), 2n x 2n around the target plus 2 samples of slack,
    lies in the picture and only over samples decoded before the block
    (zmax2n [h-2n+1, w-2n+1], zmax_win_px of the 2n window with a margin
    of 2)."""
    wxx = (pos[:, 0] + disp[:, 0] - n // 2).long()
    wyy = (pos[:, 1] + disp[:, 1] - n // 2).long()
    inb2 = ((wxx >= 2) & (wyy >= 2) & (wxx + 2 * n + 2 <= w)
            & (wyy + 2 * n + 2 <= h))
    zm2 = zmax2n[wyy.clamp(0, h - 2 * n), wxx.clamp(0, w - 2 * n)]
    return inb2 & (zm2 < zcur)


def _full_search(plane, org_plane, pos, mask, preds, n, radius, h, lam,
                 seq):
    """The masked full search over the window of plane around each block:
    (mv [B, 2], cost [B], pred [B, n, n] int32, sse [B], the SSE map and
    the rate map [B, D, D]); ``seq`` picks :func:`conv_sum`'s order."""
    b = pos.shape[0]
    dev = plane.device
    d = 2 * radius + 1
    win = _search_window(plane, pos, n, radius, h)
    # the sums of a block with no valid displacement decide nothing
    live = mask.flatten(1).any(1)
    wf = win[live].to(torch.float32)
    of = block_at(org_plane, pos[live], n).to(torch.float32)
    sse = torch.zeros((b, d, d), dtype=torch.float32, device=dev)
    if live.any():
        corr = conv_sum(wf, of, n, d, seq)
        ref2 = conv_sum(wf * wf, torch.ones_like(of), n, d, seq)
        org2 = (block_sum if seq else lane_block_sum)(of * of)[:, None, None]
        sse[live] = (org2 + ref2) - 2.0 * corr
    rate = search_rate(lam, rate_bits_map(preds, radius))
    cost = torch.where(mask, sse + rate, torch.full_like(sse, BIG))
    flat = cost.reshape(b, -1)
    idx = argmin_first(flat)
    best = flat.gather(1, idx[:, None])[:, 0]
    sse_best = sse.reshape(b, -1).gather(1, idx[:, None])[:, 0]
    sse_best = torch.where(best < 1e37, sse_best,
                           torch.full_like(sse_best, BIG))
    mvy = (idx // d).to(torch.int32) - radius
    mvx = (idx % d).to(torch.int32) - radius
    ar = torch.arange(n, device=dev)
    pry = (mvy + radius).long()[:, None, None] + ar[None, :, None]
    prx = (mvx + radius).long()[:, None, None] + ar[None, None, :]
    pred = win[torch.arange(b, device=dev)[:, None, None], pry, prx]
    return (torch.stack([mvx, mvy], -1), best, pred.to(torch.int32),
            sse_best, sse, rate)


def _targets(pos, n, radius, w, h):
    """(ty, tx, in the picture) [B, D, D] of every displacement."""
    dr = torch.arange(-radius, radius + 1, device=pos.device)
    ty = pos[:, 1, None, None].long() + dr[None, :, None]
    tx = pos[:, 0, None, None].long() + dr[None, None, :]
    return ty, tx, (ty >= 0) & (tx >= 0) & (ty + n <= h) & (tx + n <= w)


def _ss_masks(pos, zcur, zmaxw, zmax2n, n, radius, w, h):
    """[B, D, D] the causal displacements and, with zmax2n, those whose
    whole 2n GT window (+2 samples of slack) is causal and in the picture
    (else None)."""
    ty, tx, inb = _targets(pos, n, radius, w, h)
    zm = zmaxw[ty.clamp(0, h - n), tx.clamp(0, w - n)]
    mask = inb & (zm < zcur[:, None, None])
    if zmax2n is None:
        return mask, None
    wyy, wxx = ty - n // 2, tx - n // 2
    inb2 = ((wxx >= 2) & (wyy >= 2) & (wxx + 2 * n + 2 <= w)
            & (wyy + 2 * n + 2 <= h))
    zm2 = zmax2n[wyy.clamp(0, h - 2 * n), wxx.clamp(0, w - 2 * n)]
    return mask, inb2 & (zm2 < zcur[:, None, None])


def ss_search_plain(recon, org_plane, pos, zcur, zmaxw, preds, n, radius,
                    w, h, lam, zmax2n=None, seq=False):
    """Plain version of the search: (mv [B, 2] full-pel (x, y), cost [B],
    pred [B, n, n] int32, sse [B]) float32, and with zmax2n the GT anchor
    ring (anchor [B, 2] full pel, gt_rate [B] float32, gt_ok [B] bool).
    ``seq``: the PSS program's sum order (:func:`conv_sum`)."""
    b = pos.shape[0]
    d = 2 * radius + 1
    mask, mask2 = _ss_masks(pos, zcur, zmaxw, zmax2n, n, radius, w, h)
    *out, sse, rate = _full_search(recon, org_plane, pos, mask, preds, n,
                                   radius, h, lam, seq)
    out = tuple(out)
    if zmax2n is None:
        return out
    # the GT anchor ring: the least cost among the displacements whose
    # whole 2n window is causal; lax.top_k's k = 1 takes the lower index
    # on a tie, as argmin does
    cost2 = torch.where(mask2, sse + rate, torch.full_like(sse, BIG))
    idx2 = argmin_first(cost2.reshape(b, -1))
    gt_ok = cost2.reshape(b, -1).gather(1, idx2[:, None])[:, 0] < 1e37
    gt_rate = rate.reshape(b, -1).gather(1, idx2[:, None])[:, 0]
    anchor = torch.stack([(idx2 % d).to(torch.int32) - radius,
                          (idx2 // d).to(torch.int32) - radius], -1)
    return out + (anchor, gt_rate, gt_ok)


def t_search_plain(refp, org_plane, pos, preds, n, radius, w, h, lam,
                   seq=True):
    """Plain version of the temporal search (the reference's
    ``_t_search``): every displacement whose block lies in the picture is
    valid. Returns (mv [B, 2] full-pel, cost [B], pred [B, n, n] int32,
    sse [B]) as :func:`ss_search_plain`; ``seq``: the sum order of the
    PSS program (the default) or F8's (:func:`conv_sum`)."""
    mask = _targets(pos, n, radius, w, h)[2]
    return _full_search(refp, org_plane, pos, mask, preds, n, radius, h,
                        lam, seq)[:4]


# ---------------------------------------------------------------------------
# An emulation of kernel C9's scan-entry arithmetic, for the tests: the
# integer sums, the 2^24 rule per entry, and the cluster's partition and
# merge of the displacements.
# ---------------------------------------------------------------------------

EXACT = 1 << 24   # a non-negative integer sum below it is exact in float32


def int_sums(win: torch.Tensor, org: torch.Tensor, n: int, d: int):
    """int64 (corr, ref^2) [B, d, d] of the windows win [B, n+d-1, n+d-1]
    against the blocks org [B, n, n], as the kernel forms them: ref^2 from
    box sums of the squared window (rows of width n, then n rows), corr as
    integer products."""
    w, o = win.long(), org.long()
    c = torch.nn.functional.pad((w * w).cumsum(2), (1, 0))
    rows = c[:, :, n:n + d] - c[:, :, :d]
    c2 = torch.nn.functional.pad(rows.cumsum(1), (0, 0, 1, 0))
    ref2 = c2[:, n:n + d] - c2[:, :d]
    tiles = w.unfold(1, n, 1).unfold(2, n, 1)
    corr = (tiles * o[:, None, None]).sum((-1, -2))
    return corr, ref2


def corr_tensor_cores(win: torch.Tensor, org: torch.Tensor, n: int,
                      d: int) -> torch.Tensor:
    """int64 corr [B, d, d] of the windows win [B, n+d-1, n+d-1] against
    the blocks org [B, n, n] (samples below 256) as kernel C9's pre-pass
    forms it on the tensor cores (csrc/ss_search.cu ``RdGeom``): a product
    A . B per block whose rows are (dy, 8 xi) and whose columns are eight
    shifts j, K the kernel's rows taken as ``span`` bytes each (16 at
    n = 8, 32 at 16, 64 at 32): A[(dy, xi), (ky, k)] = win[dy + ky][8 xi
    + k] (zero past the window's width), B[(ky, k), j] = org[ky][k - j]
    (zero outside the row), so that the product's (dy, xi, j) is
    corr[dy][8 xi + j]."""
    b = win.shape[0]
    span = {8: 16, 16: 32, 32: 64}[n]
    xs = -(-d // 8)
    wdt = n + d - 1
    wp = max(8 * (xs - 1) + span, wdt)
    w8 = torch.zeros((b, wdt, wp), dtype=torch.int64, device=win.device)
    w8[:, :, :wdt] = win.long()
    g = torch.arange(n * span, device=win.device)
    ky, kk = g // span, g % span
    dy = torch.arange(d, device=win.device)
    xi = torch.arange(xs, device=win.device)
    a = w8[:, dy[:, None, None] + ky[None, None, :],
           8 * xi[None, :, None] + kk[None, None, :]]
    col = kk[:, None] - torch.arange(8, device=win.device)[None, :]
    bm = torch.where((col >= 0) & (col < n),
                     org.long()[:, ky[:, None], col.clamp(0, n - 1)],
                     torch.zeros((), dtype=torch.int64, device=win.device))
    prod = torch.einsum("bdxk,bkj->bdxj", a, bm)
    return prod.reshape(b, d, 8 * xs)[:, :, :d]


def search_split_plain(plane, org_plane, pos, mask, preds, n, radius, h,
                       lam, seq, parts, mask2=None, tensor_cores=False):
    """Kernel C9's scan-entry arithmetic on the CPU: the masked full search
    of :func:`_full_search` with its sums formed as the kernel forms them
    (:func:`int_sums`; an entry whose corr and ref^2 are below 2^24 takes
    them as float32, another the reference's ordered float sums, F8's or
    with ``seq`` F10's; with ``tensor_cores`` corr as the pre-pass forms
    it, :func:`corr_tensor_cores`, where every sample of the block's
    window and original is below 256), and its (2r+1)^2 displacements
    split into
    ``parts`` contiguous row-major parts, each part's least cost (first
    index among equals; a masked entry counts as 3e38) merged in part
    order. With mask2 [B, D, D] (the GT windows' causality) also the
    anchor ring over mask & mask2. Returns ((mv [B, 2], cost, pred, sse)
    and with mask2 (anchor, gt_rate, gt_ok), as the plain searches give
    them; a dict of the regions reached: causal entries whose sums stayed
    exact and that took the ordered form, (block, part) pairs with no
    causal displacement, blocks with none, blocks whose least cost is tied,
    blocks with a ring anchor)."""
    b = pos.shape[0]
    dev = plane.device
    d = 2 * radius + 1
    dd = d * d
    win = _search_window(plane, pos, n, radius, h)
    org = block_at(org_plane, pos, n)
    corr, ref2 = int_sums(win, org, n, d)
    if tensor_cores:
        narrow = ((win.flatten(1).amax(1) < 256)
                  & (org.flatten(1).amax(1) < 256))
        if narrow.any():
            corr[narrow] = corr_tensor_cores(win[narrow], org[narrow], n, d)
    exact = (corr < EXACT) & (ref2 < EXACT)
    fc, fr = corr.float(), ref2.float()
    rows = (~exact).flatten(1).any(1)
    if rows.any():
        wf, of = win[rows].float(), org[rows].float()
        block, lanes = (n * n, 1) if seq else (CONV_BLOCK, 2)
        oc = _conv_sum_ordered(wf, of, n, d, block, lanes)
        orf = _conv_sum_ordered(wf * wf, torch.ones_like(of), n, d, block,
                                lanes)
        keep = exact[rows]
        fc[rows] = torch.where(keep, fc[rows], oc)
        fr[rows] = torch.where(keep, fr[rows], orf)
    o2 = (org.long() ** 2).sum((1, 2))
    org2 = torch.where(o2 < EXACT, o2.float(),
                       (block_sum if seq else lane_block_sum)(
                           org.float() * org.float()))
    sse = (org2[:, None, None] + fr) - 2.0 * fc
    rate = search_rate(lam, rate_bits_map(preds, radius))
    cost = torch.where(mask, sse + rate, torch.full_like(sse, BIG))

    def split_argmin(c):
        flat = c.reshape(b, -1)
        best = torch.full((b,), BIG, dtype=torch.float32, device=dev)
        idx = torch.full((b,), dd, dtype=torch.int64, device=dev)
        for p in range(parts):
            d0, d1 = dd * p // parts, dd * (p + 1) // parts
            if d1 == d0:
                continue
            i = argmin_first(flat[:, d0:d1]) + d0
            v = flat.gather(1, i[:, None])[:, 0]
            take = (v < best) | (idx == dd)
            best = torch.where(take, v, best)
            idx = torch.where(take, i, idx)
        return best, idx

    best, idx = split_argmin(cost)
    sse_best = sse.reshape(b, -1).gather(1, idx[:, None])[:, 0]
    sse_best = torch.where(best < 1e37, sse_best,
                           torch.full_like(sse_best, BIG))
    mvy = (idx // d).to(torch.int32) - radius
    mvx = (idx % d).to(torch.int32) - radius
    ar = torch.arange(n, device=dev)
    pry = (mvy + radius).long()[:, None, None] + ar[None, :, None]
    prx = (mvx + radius).long()[:, None, None] + ar[None, None, :]
    pred = win[torch.arange(b, device=dev)[:, None, None], pry, prx]
    out = (torch.stack([mvx, mvy], -1), best, pred.to(torch.int32),
           sse_best)
    flat_mask = mask.reshape(b, -1)
    part_live = [flat_mask[:, dd * p // parts:dd * (p + 1) // parts].any(1)
                 for p in range(parts)]
    regions = {
        "exact": int((mask & exact).sum()),
        "ordered": int((mask & ~exact).sum()),
        "empty_parts": int(sum(int((~live).sum()) for live in part_live)),
        "none_valid": int((~flat_mask.any(1)).sum()),
        "tied": int(((cost.reshape(b, -1) == best[:, None]).sum(1) > 1)
                    .sum())}
    if mask2 is None:
        return out, regions
    cost2 = torch.where(mask & mask2, sse + rate, torch.full_like(sse, BIG))
    best2, idx2 = split_argmin(cost2)
    gt_ok = best2 < 1e37
    gt_rate = rate.reshape(b, -1).gather(1, idx2[:, None])[:, 0]
    anchor = torch.stack([(idx2 % d).to(torch.int32) - radius,
                          (idx2 // d).to(torch.int32) - radius], -1)
    regions["ring"] = int(gt_ok.sum())
    return out + (anchor, gt_rate, gt_ok), regions


def ss_search_split(recon, org_plane, pos, zcur, zmaxw, preds, n, radius,
                    w, h, lam, zmax2n=None, seq=False, parts=8):
    """:func:`search_split_plain` with :func:`ss_search_plain`'s masks and
    arguments (the SS search, with the ring where zmax2n is given)."""
    mask, mask2 = _ss_masks(pos, zcur, zmaxw, zmax2n, n, radius, w, h)
    return search_split_plain(recon, org_plane, pos, mask, preds, n, radius,
                              h, lam, seq, parts, mask2)


def t_search_split(refp, org_plane, pos, preds, n, radius, w, h, lam,
                   seq=True, parts=8):
    """:func:`search_split_plain` with :func:`t_search_plain`'s mask and
    arguments (the temporal search)."""
    mask = _targets(pos, n, radius, w, h)[2]
    return search_split_plain(refp, org_plane, pos, mask, preds, n, radius,
                              h, lam, seq, parts)


# ---------------------------------------------------------------------------
# Kernel C9.
# ---------------------------------------------------------------------------

def _check(t, dtype, name):
    if not (t.is_cuda and t.dtype == dtype and t.is_contiguous()):
        raise ValueError(f"ss_search: {name} must be a contiguous CUDA "
                         f"{dtype} tensor")


def _check_plane(t, name):
    if not (t.is_cuda and t.dtype == torch.int32 and t.stride(-1) == 1):
        raise ValueError(f"ss_search: {name} must be a CUDA int32 plane with "
                         "dense rows")


def ss_search(recon, org_plane, pos, zcur, zmaxw, motion, nbav, miav, n,
              radius, w, h, lam, mi_size, zmax2n=None):
    """Kernel C9, scan entry, over B blocks of size n.

    recon/org_plane [H(+pad), W] int32; pos [B, 2] int32 (x, y); zcur [B]
    int32 z-address of each block; zmaxw [h-n+1, w-n+1] int32 causality
    plane (:func:`hevc_hop_torch.models.ss_scan.zmax_win_px`); motion =
    (mvx4, mvy4, pi4, rf4) the carried [H/4, W/4] int32 motion planes;
    nbav [B, 5] and miav [B, 3] bool availability of the spatial and MI
    candidates. Returns (mv [B, 2] full-pel int32, cost [B], pred [B, n, n]
    int32, sse [B]) as the reference's ``_ss_search`` with the predictors
    of ``_gather_cands``. With zmax2n [h-2n+1, w-2n+1] int32 (the GT
    window's causality plane) it also returns the GT anchor ring: (anchor
    [B, 2] full pel, gt_rate [B] float32, gt_ok [B] bool).
    """
    if not recon.is_cuda:
        return ss_search_motion_plain(recon, org_plane, pos, zcur, zmaxw,
                                      motion, nbav, miav, n, radius, w, h,
                                      lam, mi_size, zmax2n)
    return _search_cuda(recon, org_plane, pos, zcur, zmaxw, motion, nbav,
                        miav, n, radius, w, h, lam, mi_size, zmax2n)[0]


def ss_search_motion_plain(recon, org_plane, pos, zcur, zmaxw, motion, nbav,
                           miav, n, radius, w, h, lam, mi_size, zmax2n=None):
    """Plain version of :func:`ss_search` (same arguments and results) on
    any device: the predictors gathered from the motion planes, then
    :func:`ss_search_plain`."""
    from hevc_hop_torch.ops.inter_arms import gather_cands
    preds = gather_cands(*motion, pos, nbav, miav, n, mi_size)[3]
    return ss_search_plain(recon, org_plane, pos, zcur, zmaxw, preds, n,
                           radius, w, h, lam, zmax2n)


def pss_search(recon, org_plane, pos, zcur, zmaxw, motion, nbav, miav, n,
               radius, w, h, lam, mi_size, zmax2n, ref, radius_t):
    """Kernel C9, scan entry, on a PSS picture (L0 = [ref, SS]): returns
    (the SS search's tuple as :func:`ss_search` gives it, the temporal
    search's (mv [B, 2] full-pel, cost [B], pred [B, n, n] int32, sse
    [B])) of the blocks at pos, the temporal one over ref [h, W] int32
    (the previous picture, rows of the same stride as org_plane) with
    radius ``radius_t``."""
    if not recon.is_cuda:
        return pss_search_plain(recon, org_plane, pos, zcur, zmaxw, motion,
                                nbav, miav, n, radius, w, h, lam, mi_size,
                                zmax2n, ref, radius_t)
    return _search_cuda(recon, org_plane, pos, zcur, zmaxw, motion, nbav,
                        miav, n, radius, w, h, lam, mi_size, zmax2n, ref,
                        radius_t)


def pss_search_plain(recon, org_plane, pos, zcur, zmaxw, motion, nbav, miav,
                     n, radius, w, h, lam, mi_size, zmax2n, ref, radius_t):
    """Plain version of :func:`pss_search` (same arguments and results) on
    any device: the SS and temporal predictors gathered from the motion
    planes, then both searches in the PSS program's sum order."""
    from hevc_hop_torch.ops.inter_arms import gather_cands
    p_ss, p_t = gather_cands(*motion, pos, nbav, miav, n, mi_size,
                             SS_IDX_PSS)[3:]
    return (ss_search_plain(recon, org_plane, pos, zcur, zmaxw, p_ss, n,
                            radius, w, h, lam, zmax2n, seq=True),
            t_search_plain(ref, org_plane, pos, p_t, n, radius_t, w, h, lam))


def _search_cuda(recon, org_plane, pos, zcur, zmaxw, motion, nbav, miav, n,
                 radius, w, h, lam, mi_size, zmax2n, ref=None, radius_t=0):
    global SEARCH_LAUNCHES, RING_LAUNCHES, TEMPORAL_LAUNCHES
    b = pos.shape[0]
    for t, nm in ((recon, "recon"), (org_plane, "org_plane"),
                  *(() if ref is None else ((ref, "ref"),))):
        _check_plane(t, nm)
    for t, nm in ((pos, "pos"), (zcur, "zcur"), (zmaxw, "zmaxw"),
                  *((m, "motion") for m in motion)):
        _check(t, torch.int32, nm)
    _check(nbav, torch.bool, "nbav")
    _check(miav, torch.bool, "miav")
    dev = recon.device
    mv = torch.empty((b, 2), dtype=torch.int32, device=dev)
    cost = torch.empty(b, dtype=torch.float32, device=dev)
    sse = torch.empty(b, dtype=torch.float32, device=dev)
    pred = torch.empty((b, n, n), dtype=torch.int32, device=dev)
    out = (mv, cost, pred, sse)
    ring = None
    if zmax2n is not None:
        _check(zmax2n, torch.int32, "zmax2n")
        ring = (torch.empty((b, 2), dtype=torch.int32, device=dev),
                torch.empty(b, dtype=torch.float32, device=dev),
                torch.empty(b, dtype=torch.bool, device=dev))
        out = out + ring
    tout = None
    if ref is not None:
        tout = (torch.empty((b, 2), dtype=torch.int32, device=dev),
                torch.empty(b, dtype=torch.float32, device=dev),
                torch.empty((b, n, n), dtype=torch.int32, device=dev),
                torch.empty(b, dtype=torch.float32, device=dev))
    if b == 0:
        return out, tout
    mvx4, mvy4, pi4, rf4 = motion
    if any(t.stride(0) != org_plane.stride(0)
           for t in (recon,) + (() if ref is None else (ref,))):
        raise ValueError("ss_search: recon, ref and org_plane share one "
                         "stride")
    ptr = lambda t: None if t is None else t.data_ptr()
    fn = _cuda.bind("ss_search", "hh_ss_search",
                    "ppi" "ppp" "ppppii" "pp" "iiiiiif" "pppp" "pppp"
                    "pii" "pppp" "p")
    err = fn(recon.data_ptr(), org_plane.data_ptr(), recon.stride(0),
             pos.data_ptr(), zcur.data_ptr(), zmaxw.data_ptr(),
             mvx4.data_ptr(), mvy4.data_ptr(), pi4.data_ptr(),
             rf4.data_ptr(), pi4.shape[0], pi4.shape[1],
             nbav.data_ptr(), miav.data_ptr(),
             b, n, radius, w, h, mi_size, f32(lam),
             mv.data_ptr(), cost.data_ptr(), pred.data_ptr(), sse.data_ptr(),
             ptr(zmax2n), *(ptr(t) for t in (ring or (None,) * 3)),
             ptr(ref), radius_t, 0 if ref is None else SS_IDX_PSS,
             *(ptr(t) for t in (tout or (None,) * 4)),
             _cuda.stream(recon))
    _cuda.check("ss_search", err)
    SEARCH_LAUNCHES += 1
    if ring is not None:
        RING_LAUNCHES += 1
    if ref is not None:
        TEMPORAL_LAUNCHES += 1
    return out, tout
