"""The GT (geometric transform, HOP) corner warp, bit-exact; kernel C11.

Counterpart of hevc_hop_tpu/ops/warp.py ``GRID``, ``_trunc_div_tz`` and
``warp_blocks``; the chroma and luma GT predictions from a plane are
hevc_hop_tpu/models/ss_scan.py ``gt_pred_luma`` and ``gt_pred_chroma``
(their plain forms are in ops/gt.py). The reference's projective helpers
(``calc_param_projective``, ``corners_from_offsets``, ``is_affine``) are
used by no encode or decode and are not ported.

The warp is affine (only three corner vectors are coded, the fourth is
derived), so every map coordinate is an exact rational with denominator
d = 2 (2n - 1) and the whole warp runs in integers: bilinear weights, the
clamp to the NSS window, rounding half up. ``safe`` flags the blocks where
a coordinate or the rounding lands exactly on a boundary, where the
reference decoder's float64 may round the other way.

:func:`warp_blocks` runs kernel C11's window entry (``csrc/warp.cu``) on a
CUDA tensor and :func:`warp_blocks_plain` on a CPU tensor;
:func:`gt_pred_blocks` is the wrapper of C11's two plane entries (luma, and
chroma over a DCTIF window at phase 0 or 4), with the masked-write and
add-residual epilogues of kernel C8's ``mc_blocks``.
"""
from __future__ import annotations

import torch

from hevc_hop_torch import _cuda

LAUNCHES = 0
LUMA_LAUNCHES = 0
CHROMA_LAUNCHES = 0

GRID = 2  # IT_GT_GRID_SIZE: the corner grid is twice the block size


def trunc_div_tz(a: torch.Tensor, d: int) -> torch.Tensor:
    """C-style integer division (truncate toward zero)."""
    q = torch.div(torch.abs(a), d, rounding_mode="floor")
    return torch.where(a < 0, -q, q)


def warp_blocks_plain(windows: torch.Tensor, corners: torch.Tensor, n: int,
                      bit_depth: int = 8, half: bool = False):
    """Plain version of :func:`warp_blocks` (same arguments and results)."""
    b = windows.shape[0]
    dev = windows.device
    g = GRID * n
    w = g - 1
    d = 2 * w
    s = 1 if half else 2
    base_x = torch.tensor([0, w, w, 0], dtype=torch.int64, device=dev) * 2
    base_y = torch.tensor([0, 0, w, w], dtype=torch.int64, device=dev) * 2
    cx = corners[..., 0].long() * s + base_x
    cy = corners[..., 1].long() * s + base_y
    off = g // 2 - n // 2
    xs = torch.arange(off, off + n, dtype=torch.int64, device=dev)
    yg, xg = torch.meshgrid(xs, xs, indexing="ij")
    xg, yg = xg[None], yg[None]
    c = lambda a, i: a[:, i, None, None]
    ax = ((c(cx, 1) - c(cx, 0)) * xg + (c(cx, 3) - c(cx, 0)) * yg
          + c(cx, 0) * w)
    ay = ((c(cy, 1) - c(cy, 0)) * xg + (c(cy, 3) - c(cy, 0)) * yg
          + c(cy, 0) * w)
    xt = trunc_div_tz(ax, d)
    yt = trunc_div_tz(ay, d)
    pn = ax - xt * d
    qn = ay - yt * d
    xu = xt - off
    yu = yt - off
    nssg = n // 2
    lim = nssg + n - 1
    xi = xu.clamp(-nssg, lim - 1)
    yi = yu.clamp(-nssg, lim - 1)
    bi = torch.arange(b, device=dev)[:, None, None]
    win = windows.long()
    a00 = win[bi, yi + nssg, xi + nssg]
    a01 = win[bi, yi + nssg, xi + 1 + nssg]
    a10 = win[bi, yi + 1 + nssg, xi + nssg]
    a11 = win[bi, yi + 1 + nssg, xi + 1 + nssg]
    num = ((d - qn) * ((d - pn) * a00 + pn * a01)
           + qn * ((d - pn) * a10 + pn * a11))
    maxv = (1 << bit_depth) - 1
    num = num.clamp(0, maxv * d * d)
    pred = torch.div(2 * num + d * d, 2 * d * d, rounding_mode="floor")
    kx = (pn == 0) & ((ax < 0) | (xu <= -nssg) | (xu >= lim))
    ky = (qn == 0) & ((ay < 0) | (yu <= -nssg) | (yu >= lim))
    knife = kx | ky | ((2 * num + d * d) % (2 * d * d) == 0)
    safe = ~knife.flatten(1).any(1)
    return pred.to(torch.int32), safe


def warp_blocks(windows: torch.Tensor, corners: torch.Tensor, n: int,
                bit_depth: int = 8, half: bool = False):
    """Batched GT warps, exact integer arithmetic.

    windows [B, 2n, 2n] int32 reference windows spanning grid coordinates
    [-n/2, 3n/2) per axis (the target block at the centre); corners
    [B, 4, 2] int32 corner offset vectors (TL, TR, BR, BL), full-pel, or
    half-pel with ``half`` (the chroma form: coded luma vectors over 2).
    Returns (pred [B, n, n] int32, safe [B] bool).
    """
    if not windows.is_cuda:
        return warp_blocks_plain(windows, corners, n, bit_depth, half)
    return _warp_cuda(windows, corners, n, bit_depth, half)


def _check(t, dtype, name):
    if not (t.is_cuda and t.dtype == dtype and t.is_contiguous()):
        raise ValueError(f"warp: {name} must be a contiguous CUDA {dtype} "
                         "tensor")


def _check_plane(t, name):
    if not (t.is_cuda and t.dtype == torch.int32 and t.stride(-1) == 1):
        raise ValueError(f"warp: {name} must be a CUDA int32 plane with "
                         "dense rows")


def _warp_cuda(windows, corners, n, bit_depth, half):
    global LAUNCHES
    b = windows.shape[0]
    _check(windows, torch.int32, "windows")
    _check(corners, torch.int32, "corners")
    if tuple(windows.shape[1:]) != (2 * n, 2 * n) or tuple(
            corners.shape) != (b, 4, 2):
        raise ValueError("warp: windows [B, 2n, 2n], corners [B, 4, 2]")
    pred = torch.empty((b, n, n), dtype=torch.int32, device=windows.device)
    safe = torch.empty(b, dtype=torch.int32, device=windows.device)
    if b == 0:
        return pred, safe.bool()
    fn = _cuda.bind("warp", "hh_warp_blocks", "pp" "iiii" "pp" "p")
    err = fn(windows.data_ptr(), corners.data_ptr(), b, n, bit_depth,
             int(half), pred.data_ptr(), safe.data_ptr(),
             _cuda.stream(windows))
    _cuda.check("warp", err)
    LAUNCHES += 1
    return pred, safe.bool()


def gt_pred_blocks(plane, pos, mv, gtc, n, chroma, h_real, bit_depth=8,
                   hc_off=0, out=None, only=None, resi=None):
    """Kernel C11's plane entries over B blocks of size n: the GT
    prediction of each block at pos [B, 2] (x, y) with the quarter-pel luma
    MV mv [P, 2] (its full-pel part, mv >> 2, is the anchor) and the coded
    corners gtc [P, 6] (TL, TR, BR as (x, y) pairs), P dividing B (block i
    takes row i % P: cb and cr share theirs).

    Luma (``chroma`` False): the clamped [2n, 2n] window of ``plane``
    around pos + mv, warped. Chroma: plane is the stacked cb/cr recon (cr
    from row hc_off), each block read from its own picture of ``h_real``
    rows; the (2n+3)^2 window is interpolated at the MV's chroma phase (0
    or 4 per axis) into [2n, 2n] and warped in half-pel units. Forms as
    kernel C8's ``mc_blocks``: the prediction [B, n, n]; ``out`` [B, n, n]
    written where ``only`` [P] int32 is non-zero; or ``resi`` added and
    the clipped recon written into ``plane`` where ``only`` is non-zero (or
    everywhere when ``only`` is None).
    """
    if not plane.is_cuda:
        from hevc_hop_torch.ops import gt
        return gt.gt_pred_blocks_plain(plane, pos, mv, gtc, n, chroma,
                                       h_real, bit_depth, hc_off, out, only,
                                       resi)
    return _gt_pred_cuda(plane, pos, mv, gtc, n, chroma, h_real, bit_depth,
                         hc_off, out, only, resi)


def _gt_pred_cuda(plane, pos, mv, gtc, n, chroma, h_real, bit_depth, hc_off,
                  out, only, resi):
    global LUMA_LAUNCHES, CHROMA_LAUNCHES
    b = pos.shape[0]
    _check_plane(plane, "plane")
    for t, nm in ((pos, "pos"), (mv, "mv"), (gtc, "gtc")):
        _check(t, torch.int32, nm)
    p = mv.shape[0]
    if b % max(p, 1) or gtc.shape != (p, 6):
        raise ValueError("gt_pred_blocks: mv [P, 2], gtc [P, 6], P | B")
    if only is not None:
        _check(only, torch.int32, "only")
        if only.shape[0] != p:
            raise ValueError("gt_pred_blocks: only [P]")
    ret = None
    if resi is not None:
        _check_plane(resi, "resi")
    elif out is not None:
        _check(out, torch.int32, "out")
        if only is None or tuple(out.shape) != (b, n, n):
            raise ValueError("gt_pred_blocks: out [B, n, n] with only")
        ret = out
    else:
        out = torch.empty((b, n, n), dtype=torch.int32, device=plane.device)
        ret = out
    if b == 0:
        return ret
    fn = _cuda.bind("warp", "hh_gt_pred", "pii" "pppi" "iiiiii" "pp" "pi"
                    "p")
    err = fn(plane.data_ptr(), plane.shape[1], plane.stride(0),
             pos.data_ptr(), mv.data_ptr(), gtc.data_ptr(), p,
             b, n, int(chroma), h_real, hc_off, bit_depth,
             None if out is None else out.data_ptr(),
             None if only is None else only.data_ptr(),
             None if resi is None else resi.data_ptr(),
             0 if resi is None else resi.stride(0), _cuda.stream(plane))
    _cuda.check("warp", err)
    if chroma:
        CHROMA_LAUNCHES += 1
    else:
        LUMA_LAUNCHES += 1
    return ret
