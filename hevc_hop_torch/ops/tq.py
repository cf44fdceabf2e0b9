"""Transform-quant pipelines of the wavefront step and the decoder; kernel C3.

:func:`tq_encode` takes a batch of predicted blocks through residual ->
forward DCT/DST -> quant (the dead-zone quantizer, or RDOQ, ops/rdoq.py)
-> sign-bit hiding -> dequant -> inverse transform -> clipped recon, and
writes the recon and the int16 levels straight into their planes at each
block's position (the reference runs
these as separate XLA ops in ``_enc_plane_ys`` and scatters the levels
after its scan). :func:`tq_decode_picture` is the decoder's dequant plus
inverse transform of every TU of a picture's three planes into their dense
residual planes (the reference's ``_residual_uniform`` /
``_residual_mixed``) as one launch; :func:`tq_decode` is the same for one
class of TUs (one plane, one size).

On a CUDA tensor each launches kernel C3 (``csrc/tq.cu``); on a CPU tensor
it runs the ``*_plain`` version, composed of ops/transform.py and
ops/quant.py, which run on any device.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from hevc_hop_torch import _cuda
from hevc_hop_torch.ops import quant, rdoq as _rdoq, transform
from hevc_hop_torch.ops.intra import block_index, _period

# one count per kernel of csrc/tq.cu; the encode entry counts its two arms
# apart: the dead-zone quantizer, and RDOQ
ENCODE_LAUNCHES = 0
ENCODE_RDOQ_LAUNCHES = 0
DECODE_LAUNCHES = 0


def mdcs_scan_id(modes: torch.Tensor, n: int, c_idx: int) -> torch.Tensor:
    """Mode-dependent coefficient scan (H.265 7.4.9.11): 4x4 any plane and
    8x8 luma scan horizontally for near-vertical modes, vertically for
    near-horizontal ones; diagonal otherwise."""
    if not (n == 4 or (n == 8 and c_idx == 0)):
        return torch.zeros(modes.shape, dtype=torch.int32,
                           device=modes.device)
    one = torch.ones_like(modes, dtype=torch.int32)
    return torch.where((modes >= 22) & (modes <= 30), one,
                       torch.where((modes >= 6) & (modes <= 14), 2 * one,
                                   0 * one))


def tq_encode_plain(org, pred, pos, modes, n, c_idx, qp, bit_depth, sbh,
                    rdoq, recon, coefp):
    b = pos.shape[0]
    modes = _period(modes, b)
    log2 = n.bit_length() - 1
    rows, cols = block_index(pos, n)
    use_dst = n == 4 and c_idx == 0
    resi = org[rows, cols].to(torch.int32) - pred
    coef = transform.fwd_transform(resi, bit_depth, use_dst)
    scan_id = mdcs_scan_id(modes, n, c_idx)
    if rdoq is None:
        lev = quant.quant(coef, qp, log2, bit_depth, True)
    else:
        lev = _rdoq.rdoq_quant_plain(
            coef, scan_id, qp=qp, log2_size=log2, bit_depth=bit_depth,
            c_idx=c_idx, init_type=rdoq[0], lam=rdoq[1])
    if sbh:
        lev = quant.sbh_adjust(lev, scan_id, c_idx, coef, qp, bit_depth,
                               rdoq[1] if rdoq else 0.0)
    rq = transform.inv_transform(quant.dequant(lev, qp, log2, bit_depth),
                                 bit_depth, use_dst)
    recon[rows, cols] = torch.clamp(pred + rq, 0, (1 << bit_depth) - 1)
    coefp[rows, cols] = lev.to(torch.int16)
    return (lev != 0).flatten(1).any(1).to(torch.int32)


def tq_encode(org, pred, pos, modes, n, c_idx, qp, bit_depth, sbh, rdoq,
              recon, coefp):
    """Kernel C3, encode entry, over B blocks of size n.

    org/recon [H, W] int32 planes; pred [B, n, n] int32; pos [B, 2] int32
    (x, y); modes [P] int32 with P dividing B (block i's intra mode is
    modes[i % P]; it picks the MDCS scan for RDOQ and SBH); c_idx 0 luma,
    1 chroma. rdoq: None for the dead-zone quantizer, or (init_type, lam)
    for RDOQ's level decisions, whose lam SBH then uses too (the
    reference's ``_enc_plane_ys``). Writes recon and the int16 levels into
    coefp [H, W] at each block, and returns cbf [B] int32.
    """
    if not pred.is_cuda:
        return tq_encode_plain(org, pred, pos, modes, n, c_idx, qp,
                               bit_depth, sbh, rdoq, recon, coefp)
    return _tq_encode_cuda(org, pred, pos, modes, n, c_idx, qp, bit_depth,
                           sbh, rdoq, recon, coefp)


def tq_decode_plain(coefp, pos, n, qp, bit_depth, use_dst, out):
    log2 = n.bit_length() - 1
    rows, cols = block_index(pos, n)
    deq = quant.dequant(coefp[rows, cols].to(torch.int32), qp, log2,
                        bit_depth)
    out[rows, cols] = transform.inv_transform(deq, bit_depth, use_dst)
    return out


def tq_decode(coefp, pos, n, qp, bit_depth, use_dst, out):
    """Kernel C3, decode entry: dequant + inverse transform of the blocks
    at pos [B, 2] of the int16 level plane coefp into the int32 residual
    plane out (both [H, W]); on the card, :func:`tq_decode_picture` with
    one plane and one class."""
    if not coefp.is_cuda:
        return tq_decode_plain(coefp, pos, n, qp, bit_depth, use_dst, out)
    tq_decode_picture([(coefp, out, qp, use_dst)],
                      [(0, n.bit_length() - 1, pos)], bit_depth)
    return out


def residual_classes(classes) -> tuple:
    """The decode entry's work list: the non-empty classes (plane, log2,
    pos [B, 2]) in the kernel's order, the largest size first and within a
    size by plane, each with its first warp, (plane, log2, pos, unit0);
    and the number of warps. A warp takes 32 / n TUs of one class, a group
    of n lanes each."""
    out, unit = [], 0
    for plane, log2, pos in sorted((c for c in classes if c[2].shape[0]),
                                   key=lambda c: (-c[1], c[0])):
        out.append((plane, log2, pos, unit))
        per = 32 >> log2
        unit += (pos.shape[0] + per - 1) // per
    return out, unit


def tq_decode_picture_plain(planes, classes, bit_depth):
    for plane, log2, pos, _ in residual_classes(classes)[0]:
        coefp, out, qp, dst = planes[plane]
        tq_decode_plain(coefp, pos, 1 << log2, qp, bit_depth,
                        dst and log2 == 2, out)


def tq_decode_picture(planes, classes, bit_depth):
    """Kernel C3, decode entry, over a whole picture: dequant + inverse
    transform of every TU of up to three planes in one launch. planes[i] =
    (coefp [H, W] int16 levels, out [H, W] int32 residual, qp, dst: the
    DST at 4x4); classes = (plane index, log2, pos [B, 2] int32 (x, y)).
    On a CUDA tensor it launches the kernel; on a CPU tensor it runs
    :func:`tq_decode_picture_plain`."""
    if not planes[0][0].is_cuda:
        return tq_decode_picture_plain(planes, classes, bit_depth)
    return _tq_decode_picture_cuda(planes, classes, bit_depth)


# ---------------------------------------------------------------------------
# CUDA launches.
# ---------------------------------------------------------------------------

def _check(t, dtype, name, dense_rows=False):
    ok = t.is_cuda and t.dtype == dtype
    ok = ok and (t.stride(-1) == 1 if dense_rows else t.is_contiguous())
    if not ok:
        raise ValueError(f"tq: {name} must be a CUDA {dtype} tensor with "
                         "dense rows")


def _tq_encode_cuda(org, pred, pos, modes, n, c_idx, qp, bit_depth, sbh,
                    rdoq, recon, coefp):
    global ENCODE_LAUNCHES, ENCODE_RDOQ_LAUNCHES
    b = pos.shape[0]
    _check(pred, torch.int32, "pred")
    _check(pos, torch.int32, "pos")
    _check(modes, torch.int32, "modes")
    _check(org, torch.int32, "org", True)
    _check(recon, torch.int32, "recon", True)
    _check(coefp, torch.int16, "coefp", True)
    if b % max(modes.shape[0], 1):
        raise ValueError("tq_encode: modes rows must divide B")
    cbf = torch.empty(b, dtype=torch.int32, device=pred.device)
    if b == 0:
        return cbf
    log2 = n.bit_length() - 1
    qs, qbits, qoff = quant.quant_params(qp, log2, bit_depth)
    dqs, dqsh = quant.dequant_params(qp, log2, bit_depth)
    tr_shift = 15 - bit_depth - log2
    lam = rdoq[1] if rdoq else 0.0
    lamc = float(np.float32(lam * (4.0 ** tr_shift)))
    rargs = None
    if rdoq is not None:
        rargs = _rdoq.kernel_args(log2, c_idx, qp, bit_depth, rdoq[0],
                                  rdoq[1], pred.device)
    fn = _cuda.bind("tq", "hh_tq_encode",
                    "pi" "p" "pp" "i" "iiiii" "iii" "ii" "if"
                    "pi" "pi" "p" "p" "p")
    err = fn(org.data_ptr(), org.stride(0), pred.data_ptr(),
             pos.data_ptr(), modes.data_ptr(), modes.shape[0],
             b, n, c_idx, bit_depth, (1 << bit_depth) - 1,
             qs, qbits, qoff, dqs, dqsh,
             int(sbh), lamc,
             recon.data_ptr(), recon.stride(0),
             coefp.data_ptr(), coefp.stride(0), cbf.data_ptr(),
             None if rargs is None else ctypes.addressof(rargs),
             _cuda.stream(pred))
    _cuda.check("tq", err)
    if rdoq is None:
        ENCODE_LAUNCHES += 1
    else:
        ENCODE_RDOQ_LAUNCHES += 1
    return cbf


class _ResPlane(ctypes.Structure):
    _fields_ = [("lev", ctypes.c_void_p), ("lev_stride", ctypes.c_int),
                ("out", ctypes.c_void_p), ("out_stride", ctypes.c_int),
                ("dqs", ctypes.c_int), ("dst", ctypes.c_int)]


class _ResClass(ctypes.Structure):
    _fields_ = [("pos", ctypes.c_void_p), ("count", ctypes.c_int),
                ("plane", ctypes.c_int), ("log2", ctypes.c_int),
                ("unit0", ctypes.c_int)]


# csrc/tq.cu ResArgs
_RES_CLASSES = 12


class _ResArgs(ctypes.Structure):
    _fields_ = [("pl", _ResPlane * 3), ("cls", _ResClass * _RES_CLASSES),
                ("ncls", ctypes.c_int), ("units", ctypes.c_int),
                ("bit_depth", ctypes.c_int)]


def _aligned(t, name, size):
    """The kernel reads the levels as 8-byte vectors and writes the
    residual as 16-byte ones, along each row."""
    if t.data_ptr() % size or (t.stride(0) * t.element_size()) % size:
        raise ValueError(f"tq_decode: {name} must start on {size} bytes "
                         f"and have rows a multiple of {size} bytes")


def _tq_decode_picture_cuda(planes, classes, bit_depth):
    global DECODE_LAUNCHES
    if not 1 <= len(planes) <= 3:
        raise ValueError("tq_decode_picture: one to three planes")
    a = _ResArgs()
    for i, (coefp, out, qp, dst) in enumerate(planes):
        _check(coefp, torch.int16, "coefp", True)
        _check(out, torch.int32, "out", True)
        _aligned(coefp, "coefp", 8)
        _aligned(out, "out", 16)
        # the dequantizer's scale; its shift depends on the TU size, and
        # the kernel forms it
        a.pl[i] = _ResPlane(coefp.data_ptr(), coefp.stride(0),
                            out.data_ptr(), out.stride(0),
                            quant.dequant_params(qp, 2, bit_depth)[0],
                            int(dst))
    work, a.units = residual_classes(classes)
    if not work:
        return
    if len(work) > _RES_CLASSES:
        raise ValueError("tq_decode_picture: more than 12 classes")
    for i, (plane, log2, pos, unit0) in enumerate(work):
        _check(pos, torch.int32, "pos")
        if not 0 <= plane < len(planes) or not 2 <= log2 <= 5:
            raise ValueError("tq_decode_picture: a class's plane or size")
        a.cls[i] = _ResClass(pos.data_ptr(), pos.shape[0], plane, log2,
                             unit0)
    a.ncls = len(work)
    a.bit_depth = bit_depth
    fn = _cuda.bind("tq", "hh_tq_decode", "pp")
    err = fn(ctypes.addressof(a), _cuda.stream(planes[0][0]))
    _cuda.check("tq", err)
    DECODE_LAUNCHES += 1
