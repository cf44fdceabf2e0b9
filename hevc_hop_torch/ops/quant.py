"""Scalar quantization, dequantization and sign-bit hiding, plain PyTorch.

Counterpart of hevc_hop_tpu/ops/quant.py. On the card these run inside
kernel C3 (``csrc/tq.cu``, wrapped by ``ops/tq.py``); the functions here are
its plain version and run on any device. All integer math stays int32, as
the reference's does (x64 off): Python ints never promote a tensor here.

Two float details of the reference are reproduced on purpose, because SBH's
RD choice depends on them bit for bit:

- ``floor(log2(v))`` of the rate proxy is computed by the reference in
  float32, and on the CPU it comes out one low at v = 8192 and v = 32768
  (:func:`floor_log2_ref`);
- the cost ``d_new*d_new - d_cur*d_cur + lamc*(r_new - r_cur)`` is what the
  reference's compiled scan (XLA on the CPU) makes of it: two fused
  multiply-adds, ``fma(r_new - r_cur, lamc, fma(d_new, d_new,
  -(d_cur*d_cur)))``, with ``d_cur*d_cur`` rounded on its own because both
  candidates read it (:func:`fma`); the kernel spells the same with
  ``fmaf`` and ``__fmul_rn``. (Run op by op, the reference rounds every
  product and sum; its jitted scan is what writes the streams.)
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from hevc_hop_torch.common import rom
from hevc_hop_torch.common.types import COEF_MIN, COEF_MAX


def _qp_parts(qp: int, bit_depth: int):
    qp = qp + 6 * (bit_depth - 8)   # QpBdOffset (H.265 8.6.1 QP'Y)
    return qp // 6, qp % 6


def quant_params(qp: int, log2_size: int, bit_depth: int = 8,
                 is_intra_slice: bool = True):
    """(scale, qbits, offset) of HM's dead-zone quantizer."""
    per, rem = _qp_parts(qp, bit_depth)
    qbits = (rom.QUANT_SHIFT + per
             + rom.MAX_TR_DYNAMIC_RANGE - bit_depth - log2_size)
    offset = (171 if is_intra_slice else 85) << (qbits - 9)
    return int(rom.QUANT_SCALES[rem]), qbits, offset


def dequant_params(qp: int, log2_size: int, bit_depth: int = 8):
    """(scale, shift) of the normative flat dequantizer."""
    per, rem = _qp_parts(qp, bit_depth)
    return ((int(rom.INV_QUANT_SCALES[rem]) * 16) << per,
            bit_depth + log2_size - 5)


def quant(coef: torch.Tensor, qp: int, log2_size: int, bit_depth: int = 8,
          is_intra_slice: bool = True) -> torch.Tensor:
    """HM dead-zone quantizer. coef [..., N, N] int32 -> levels int32."""
    scale, qbits, offset = quant_params(qp, log2_size, bit_depth,
                                        is_intra_slice)
    level = (torch.abs(coef) * scale + offset) >> qbits
    return torch.clamp(torch.sign(coef) * level, COEF_MIN, COEF_MAX)


def dequant(level: torch.Tensor, qp: int, log2_size: int,
            bit_depth: int = 8) -> torch.Tensor:
    """Normative dequant, flat scaling (H.265 8.6.3 with m = 16)."""
    scale, shift = dequant_params(qp, log2_size, bit_depth)
    d = (level * scale + (1 << (shift - 1))) >> shift
    return torch.clamp(d, COEF_MIN, COEF_MAX)


def bit_length(v: torch.Tensor) -> torch.Tensor:
    """Bit length of each int32 v >= 0 (0 for 0)."""
    v = v.to(torch.int32)
    bl = torch.zeros_like(v)
    for b in range(31):
        bl = bl + (v >= (1 << b)).to(torch.int32)
    return bl


def floor_log2_ref(v: torch.Tensor) -> torch.Tensor:
    """``floor(log2(float32(v)))`` as the reference computes it on the CPU,
    for integer v >= 1: the bit length less one, and one less again at
    v = 8192 and v = 32768, where its float32 log2 falls just short."""
    return (bit_length(v) - 1
            - ((v == 8192) | (v == 32768)).to(torch.int32))


def _rate(v: torch.Tensor) -> torch.Tensor:
    """The reference's golomb-ish level-rate proxy (float32)."""
    fl = floor_log2_ref(torch.clamp(v, min=1)).to(torch.float32)
    return torch.where(v > 0, 1.0 + 2.0 * fl,
                       torch.tensor(-1.5, dtype=torch.float32,
                                    device=v.device))


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a*b + c rounded once. The float64 product is exact; the
    float64 sum is rounded to odd (its exact error from TwoSum), which makes
    the final rounding to float32 correct."""
    a = a.double()
    b = b.double() if torch.is_tensor(b) else float(b)
    c = c.double() if torch.is_tensor(c) else float(c)
    p = a * b
    s = p + c
    bp = s - c
    e = (p - bp) + (c - (s - bp))
    even = (s.view(torch.int64) & 1) == 0
    inf = torch.full_like(s, float("inf"))
    toward = torch.where(e > 0, inf, -inf)
    s = torch.where((e != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _sbh_cost(d_new, d_cur, lamc: np.float32, r_new, r_cur):
    """d_new*d_new - d_cur*d_cur + lamc*(r_new - r_cur) as the reference's
    compiled scan rounds it (see the module docstring)."""
    return fma(r_new - r_cur, float(lamc), fma(d_new, d_new,
                                               -(d_cur * d_cur)))


@functools.lru_cache(maxsize=None)
def _perms_np(log2: int):
    return np.stack([rom.scan_raster_index(log2, s) for s in (0, 1, 2)])


def sbh_single_scan(log2: int, c_idx: int) -> bool:
    """True where SBH walks the diagonal scan whatever the block's MDCS
    scan (the reference's ``single`` flag)."""
    return not (log2 == 2 or (log2 == 3 and c_idx == 0))


def sbh_adjust(lev: torch.Tensor, scan_id: torch.Tensor, c_idx: int = 0,
               coef: torch.Tensor | None = None, qp: int = 0,
               bit_depth: int = 8, lam: float = 0.0) -> torch.Tensor:
    """Sign-bit-hiding parity enforcement per 4x4 coefficient group (see
    hevc_hop_tpu/ops/quant.py sbh_adjust for the rules).

    lev [B, N, N] int32; scan_id [B] MDCS scan; coef [B, N, N] the
    pre-quant coefficients (None: decrement the trailing nonzero).
    """
    b, n, _ = lev.shape
    dev = lev.device
    log2 = n.bit_length() - 1
    m = n * n
    flat = lev.reshape(b, m)
    perms = torch.as_tensor(_perms_np(log2), dtype=torch.int64, device=dev)
    if sbh_single_scan(log2, c_idx):
        perm = perms[0][None].expand(b, m)
    else:
        perm = perms[scan_id.to(torch.int64)]
    c = torch.gather(flat, 1, perm).reshape(b, m // 16, 16)
    a = torch.abs(c)
    nz = c != 0
    idx = torch.arange(16, dtype=torch.int32, device=dev)[None, None]
    first = torch.where(nz, idx, 99).amin(-1)
    last = torch.where(nz, idx, -1).amax(-1)
    hidden = (last - first) >= 4
    parity = (a.sum(-1) & 1) == 1
    vfirst = torch.gather(c, 2, first.clamp(0, 15)[..., None].long())[..., 0]
    mism = hidden & (parity != (vfirst < 0))

    sgn = torch.sign(c)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    if coef is None:
        tgt = last.clamp(0, 15).long()
        st = torch.gather(sgn, 2, tgt[..., None])[..., 0]
        delta = torch.where(mism, -st, zero)
    else:
        cq = torch.gather(coef.reshape(b, m), 1, perm).reshape(b, m // 16, 16)
        d_cur = (cq - dequant(c, qp, log2, bit_depth)).to(torch.float32)
        d_dec = (cq - dequant(c - sgn, qp, log2, bit_depth)).to(torch.float32)
        d_inc = (cq - dequant(c + sgn, qp, log2, bit_depth)).to(torch.float32)
        tr_shift = rom.MAX_TR_DYNAMIC_RANGE - bit_depth - log2
        lamc = np.float32(lam * (4.0 ** tr_shift))
        r_cur, r_dec, r_inc = _rate(a), _rate(a - 1), _rate(a + 1)
        cost_dec = _sbh_cost(d_dec, d_cur, lamc, r_dec, r_cur)
        cost_inc = _sbh_cost(d_inc, d_cur, lamc, r_inc, r_cur)
        big = torch.tensor(3e38, dtype=torch.float32, device=dev)
        is_first = idx == first[..., None]
        is_last = idx == last[..., None]
        last2 = torch.where(nz & ~is_last, idx, -1).amax(-1)
        collapse = (last2 - first) < 4
        dec_ok = nz & ~((is_first | (is_last & collapse[..., None]))
                        & (a == 1))
        cost_dec = torch.where(dec_ok, cost_dec, big)
        cost_inc = torch.where(nz, cost_inc, big)
        use_dec = cost_dec <= cost_inc
        cost = torch.minimum(cost_dec, cost_inc)
        tgt = argmin_first(cost)
        dirn = torch.gather(use_dec, 2, tgt[..., None])[..., 0]
        st = torch.gather(sgn, 2, tgt[..., None])[..., 0]
        delta = torch.where(mism, torch.where(dirn, -st, st), zero)
    c = c + delta[..., None] * (idx == tgt[..., None])
    out = torch.zeros_like(flat)
    out.scatter_(1, perm, c.reshape(b, m))
    return out.reshape(b, n, n)


def seq_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum over the last axis, one rounded add after another."""
    acc = x[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def fold_lanes(v: torch.Tensor) -> torch.Tensor:
    """float32 sum of eight vector lanes [..., 8] by halves, as XLA:CPU
    reduces a vector: ((v0 + v4) + (v2 + v6)) + ((v1 + v5) + (v3 + v7))."""
    a = v[..., :4] + v[..., 4:]
    b = a[..., :2] + a[..., 2:]
    return b[..., 0] + b[..., 1]


def argmin_first(x: torch.Tensor) -> torch.Tensor:
    """argmin over the last axis, ties to the lowest index (jnp.argmin's
    rule; torch's argmin does not promise one)."""
    k = x.shape[-1]
    ar = torch.arange(k, device=x.device)
    hit = x == x.amin(-1, keepdim=True)
    return torch.where(hit, ar, k).amin(-1)
