"""Rate-distortion optimized quantization (RDOQ); kernel C7.

Counterpart of hevc_hop_tpu/ops/rdoq.py (the reference's K3). The numpy
table builders are copied. :func:`rdoq_quant` takes a CUDA tensor to kernel
C7 (``csrc/rdoq.cu``, whose per-TU device code ``csrc/rdoq.cuh`` also runs
inside C3's encode entry) and a CPU tensor to :func:`rdoq_quant_plain`.

The level decisions compare float32 costs, so the plain body and the kernel
copy the float arithmetic of the reference's *compiled* program (XLA on the
CPU), not the order its source spells:

- fused multiply-adds where XLA's code generator contracts a product into
  the sum that follows it: ``err*err*s + lam*r`` is
  ``fma(err*err, s, lam*r)``, ``cost0 + lam*sig0`` is
  ``fma(ldf*ldf, s, lam*sig0)``, ``sum + lam*cg_bits`` is
  ``fma(cg_bits, lam, sum)``, and the per-group sum of ``cost0`` is a chain
  ``acc = fma(ldf*ldf, s, acc)`` (:func:`fma`);
- ``jnp.cumsum`` over more than 16 positions is a blocked scan: sequential
  sums inside blocks of 16, plus the exclusive scan of the block totals,
  itself blocked the same way (:func:`xla_cumsum`);
- ``jnp.sum`` over more than 32 positions adds blocks of 32 one after
  another and then the block sums (:func:`xla_sum`); shorter sums run
  from the first element to the last.

Two forms depend on the TU class (:func:`float_forms`), as XLA fuses and
vectorizes each class's program differently: at 4x4 ``total0`` is the same
fma chain as the per-group sum, and at 8x8 and 16x16 the tournament's
``cost_coeff - cost_sig`` is one fused multiply-add
``fma(-sig, lam, cost_coeff)`` (a masked vector FMA in the compiled loop).

``floor(log2(cn) + 1e-6)`` of the escape length equals the bit length of
cn less one for every cn the reference can reach (1 to 2^17 checked).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from hevc_hop_torch import _cuda
from hevc_hop_torch.common import rom
from hevc_hop_torch.entropy import cal_bits as _cal
from hevc_hop_torch.entropy import ctx_layout, tables
from hevc_hop_torch.ops.quant import bit_length, fma
from hevc_hop_torch.ops.quant import seq_sum as _seq_sum

SCALE = 32768.0  # rate unit: 2^15 per bit (SCALE_BITS)
_INF = 1e30

# kCtxMap4x4 (H.265 9.3.4.2.5 / TComTrQuant)
_CTX_MAP_4X4 = np.array([0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8],
                        np.int32)

# one count per entry of csrc/rdoq.cu
LAUNCHES = 0


def _group_idx(pos: int) -> int:
    if pos < 4:
        return pos
    k = pos.bit_length() - 1
    return 2 * k + (1 if pos >= (1 << k) + (1 << (k - 1)) else 0)


# The reference estimates rates from empirical per-context costs measured
# from realized CABAC statistics (entropy/cal_bits.py, generated by
# tools/calibrate_rdoq.py), falling back to init-state costs for unobserved
# contexts.


def _ebits(states: np.ndarray, binv) -> np.ndarray:
    """Fractional bits (2^15 units) of coding bin value(s) in state(s)."""
    return tables.ENTROPY_BITS[np.asarray(states, np.int32) ^ binv]


def _ctx_bits(st: np.ndarray, base: int, cnt: int, init_type: int,
              qp: int) -> np.ndarray:
    """[cnt, 2] fractional-bit costs for a context group: calibrated
    empirical costs where measured, init-state costs otherwise."""
    states = st[base:base + cnt]
    out = np.stack([_ebits(states, 0), _ebits(states, 1)], 1)
    cal = _cal.bits_for(init_type, qp)
    if cal is not None:
        c = cal[base:base + cnt]
        out = np.where(c >= 0, c, out)
    return out.astype(np.float32)


def _sig_ctx_table(log2: int, c_idx: int, scan: int) -> np.ndarray:
    """[4 patterns, M] sig ctx index per scan position (9.3.4.2.5)."""
    n = 1 << log2
    pos = rom.scan_order(log2, scan)
    xc, yc = pos[:, 0], pos[:, 1]
    if log2 == 2:
        t = _CTX_MAP_4X4[(yc << 2) + xc]
        return np.broadcast_to(t, (4, 16)).copy()
    out = np.zeros((4, n * n), np.int32)
    xp, yp = xc & 3, yc & 3
    for prev in range(4):
        if prev == 0:
            s = np.where(xp + yp == 0, 2, np.where(xp + yp < 3, 1, 0))
        elif prev == 1:
            s = np.where(yp == 0, 2, np.where(yp == 1, 1, 0))
        elif prev == 2:
            s = np.where(xp == 0, 2, np.where(xp == 1, 1, 0))
        else:
            s = np.full(n * n, 2, np.int32)
        if c_idx == 0:
            s = s + np.where((xc > 3) | (yc > 3), 3, 0)
            s = s + (9 if scan == 0 else 15) if log2 == 3 else s + 21
        else:
            s = s + (9 if log2 == 3 else 12)
        s = np.where((xc == 0) & (yc == 0), 0, s)
        out[prev] = s
    return out


def _last_rate_table(log2: int, c_idx: int, scan: int, bx: np.ndarray,
                     by: np.ndarray) -> np.ndarray:
    """[M] last_sig_coeff_x/y rate (2^15 units) per scan position.

    Mirrors TComTrQuant::xGetRateLast: truncated-unary ctx prefix
    (blk-size-dependent ctx spacing) + EP suffix. bx/by: [15, 2] per-ctx
    bit costs for the x/y prefix contexts.
    """
    if c_idx == 0:
        ctx_of = [((i >> ((log2 + 1) >> 2)) + ((log2 - 2) * 3
                  + ((log2 - 1) >> 2))) for i in range(2 * log2)]
    else:
        ctx_of = [(i >> (log2 - 2)) for i in range(2 * log2)]
    gmax = _group_idx((1 << log2) - 1)  # g_uiGroupIdx[n-1]

    def axis_rate(p: int, bits: np.ndarray) -> float:
        # TEncSbac::estLastSignificantPositionBit: unary prefix of g ones,
        # terminating zero unless g is the maximal group, then EP suffix
        g = _group_idx(p)
        r = 0.0
        for i in range(g):
            r += float(bits[ctx_of[i], 1])
        if g < gmax:
            r += float(bits[ctx_of[g], 0])
        if g > 3:  # EP suffix bits
            r += ((g - 2) >> 1) * SCALE
        return r

    pos = rom.scan_order(log2, scan)
    xs, ys = pos[:, 0], pos[:, 1]
    if scan == 2:  # vertical scan swaps coordinates (xGetRateLast call site)
        xs, ys = ys, xs
    rx = np.array([axis_rate(int(p), bx) for p in range(1 << log2)])
    ry = np.array([axis_rate(int(p), by) for p in range(1 << log2)])
    return (rx[xs] + ry[ys]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _tables_for(log2: int, c_idx: int, qp: int, init_type: int):
    """Static per-TU-class tables: scan perms, ctx tables, init-state rates."""
    st = ctx_layout.init_states(init_type, qp)
    n = 1 << log2
    m = n * n
    off = ctx_layout.OFFSETS
    cb = functools.partial(_ctx_bits, st, init_type=init_type, qp=qp)
    lastx_bits = cb(off["LAST_X_LUMA" if c_idx == 0 else "LAST_X_CHROMA"], 15)
    lasty_bits = cb(off["LAST_Y_LUMA" if c_idx == 0 else "LAST_Y_CHROMA"], 15)
    scans = (0, 1, 2) if log2 <= 3 else (0, 0, 0)
    perm = np.stack([rom.scan_raster_index(log2, s) for s in scans])
    sig_tab = np.stack([_sig_ctx_table(log2, c_idx, s) for s in scans])
    last_tab = np.stack([_last_rate_table(log2, c_idx, s, lastx_bits,
                                          lasty_bits) for s in scans])
    # CG scan: with CG-major scans, CG scan index = pos>>4; raster CG of the
    # first coefficient of each CG gives the CG grid position.
    ncg = max(m // 16, 1)
    side = max(n // 4, 1)
    cgpos = np.zeros((3, ncg, 2), np.int32)
    for si, s in enumerate(scans):
        r = perm[si][::16]
        cgpos[si, :, 0] = (r & (n - 1)) // 4
        cgpos[si, :, 1] = (r >> log2) // 4
    sig_bits = cb(off["SIG_LUMA" if c_idx == 0 else "SIG_CHROMA"],
                  27 if c_idx == 0 else 15)
    one_bits = cb(off["ONE_LUMA" if c_idx == 0 else "ONE_CHROMA"],
                  16 if c_idx == 0 else 8)
    abs_bits = cb(off["ABS_LUMA" if c_idx == 0 else "ABS_CHROMA"],
                  4 if c_idx == 0 else 2)
    cg_bits = cb(off["SIG_CG_LUMA" if c_idx == 0 else "SIG_CG_CHROMA"], 2)
    # cbf ctx: luma trDepth==0 -> ctx 1; chroma trDepth (0) -> ctx 0
    cbf_bits = cb(off["QT_CBF_LUMA" if c_idx == 0 else "QT_CBF_CHROMA"]
                  + (1 if c_idx == 0 else 0), 1)[0]
    return dict(perm=perm, sig_tab=sig_tab, last_tab=last_tab, cgpos=cgpos,
                side=side, ncg=ncg, sig_bits=sig_bits, one_bits=one_bits,
                abs_bits=abs_bits, cg_bits=cg_bits, cbf_bits=cbf_bits)


@functools.lru_cache(maxsize=None)
def _device_tables(log2: int, c_idx: int, qp: int, init_type: int,
                   device: str) -> dict:
    t = _tables_for(log2, c_idx, qp, init_type)
    out = {}
    for k, v in t.items():
        if isinstance(v, np.ndarray):
            dt = np.float32 if v.dtype.kind == "f" else np.int32
            out[k] = torch.as_tensor(np.ascontiguousarray(v, dt),
                                     device=device)
    return out


def device_tables(log2: int, c_idx: int, qp: int, init_type: int,
                  device) -> dict:
    """The array entries of :func:`_tables_for` as tensors on ``device``
    (int32 and float32, cached per class and device)."""
    return _device_tables(log2, c_idx, qp, init_type,
                          str(torch.device(device)))


def params(qp: int, log2_size: int, bit_depth: int, lam: float) -> dict:
    """The scalars of one TU class: qscale, qbits, and the float32
    err_scale and lam (computed in float64, cast once)."""
    qpe = qp + 6 * (bit_depth - 8)   # QpBdOffset (quant domain only;
    #                                  context tables stay on slice qp)
    per, rem = qpe // 6, qpe % 6
    tr_shift = rom.MAX_TR_DYNAMIC_RANGE - bit_depth - log2_size
    qscale = int(rom.QUANT_SCALES[rem])
    err_scale = np.float32(SCALE * (2.0 ** (-2.0 * tr_shift))
                           / (qscale * qscale)
                           / (1 << (2 * (bit_depth - 8))))
    return dict(qscale=qscale, qbits=rom.QUANT_SHIFT + per + tr_shift,
                err_scale=err_scale, lam=np.float32(lam))


def float_forms(log2: int, c_idx: int) -> dict:
    """The class-dependent float forms of the reference's compiled program:
    ``chain_total0`` total0 as an fma chain (else :func:`xla_sum` of the
    rounded cost0); ``fused_sig`` cost_coeff - cost_sig as one fma;
    ``fused_head`` lam*cbf1 + lam*last as fma(lam, last, lam*cbf1) (the
    classes whose last-position table is gathered per scan)."""
    return dict(chain_total0=log2 == 2, fused_sig=log2 in (3, 4),
                fused_head=not single_scan(log2, c_idx))


def single_scan(log2: int, c_idx: int) -> bool:
    """MDCS applies only to 4x4 TUs and 8x8 luma (H.265 8.4.4.2.7); every
    other class has the diagonal scan alone."""
    return not (log2 == 2 or (log2 == 3 and c_idx == 0))


# ---------------------------------------------------------------------------
# Float arithmetic of the reference's compiled program.
# ---------------------------------------------------------------------------

def _seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums over the last axis, one add after another."""
    out = torch.empty_like(x)
    acc = x[..., 0]
    out[..., 0] = acc
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
        out[..., j] = acc
    return out


def xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """``jnp.cumsum`` over the last axis as XLA on the CPU computes it:
    sequential inside blocks of 16, plus the exclusive scan of the block
    totals (blocked again where there are more than 16)."""
    k = x.shape[-1]
    if k <= 16:
        return _seq_cumsum(x)
    blk = _seq_cumsum(x.reshape(*x.shape[:-1], k // 16, 16))
    tot = xla_cumsum(blk[..., -1])
    excl = torch.cat([torch.zeros_like(tot[..., :1]), tot[..., :-1]], -1)
    return (blk + excl[..., None]).reshape(x.shape)


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sum`` over the last axis as XLA on the CPU computes it: blocks
    of 32 summed in order, then the block sums in order."""
    k = x.shape[-1]
    if k <= 32:
        return _seq_sum(x)
    return _seq_sum(_seq_sum(x.reshape(*x.shape[:-1], k // 32, 32)))


def last_tournament(tot: torch.Tensor) -> tuple:
    """The last-position tournament over tot [B, M] float32: the lowest
    cost and the first position that reaches it."""
    best = tot.amin(1)
    pidx = torch.arange(tot.shape[1], device=tot.device)
    return best, torch.where(tot == best[:, None], pidx,
                             tot.shape[1]).amin(1)


def fma_chain_sum(a: torch.Tensor, s) -> torch.Tensor:
    """sum_j a[..., j] * s over the last axis, as the chain
    acc = fma(a_j, s, acc) from acc = a_0 * s."""
    acc = a[..., 0] * s
    for j in range(1, a.shape[-1]):
        acc = fma(a[..., j], s, acc)
    return acc


# ---------------------------------------------------------------------------
# The plain body.
# ---------------------------------------------------------------------------

def _level_rate(lev, ob0, ob1, ab0, ab1, rice, c1idx, c2idx):
    """xGetICRate: rate (2^15 units, float32) of coding abs level `lev`
    (incl. the EP sign bit). lev==0 -> 0. Every term is an integer below
    2^24, so the float32 sums are exact in any order."""
    base = torch.where(c1idx < 8, 2 + (c2idx < 1).to(torch.int32), 1)
    sym = torch.clamp(lev - base, min=0)
    thr = 3 << rice
    r_short = ((sym >> rice) + 1 + rice).to(torch.float32) * SCALE
    # escape: len = floor(log2(cn + 2^rice)); bits = (3+len+1-rice) + len
    cn = torch.clamp(sym - thr, min=0) + (1 << rice)
    ln = bit_length(cn) - 1
    r_esc = (3 + ln + 1 - rice + ln).to(torch.float32) * SCALE
    r_rem = torch.where(sym < thr, r_short, r_esc)
    zero = torch.zeros((), dtype=torch.float32, device=lev.device)
    ge_base = lev >= base
    rate = SCALE + torch.where(ge_base, r_rem, zero)
    rate = rate + torch.where(ge_base & (c1idx < 8), ob1, zero)
    rate = rate + torch.where(ge_base & (c1idx < 8) & (c2idx < 1), ab1, zero)
    rate = rate + torch.where(~ge_base & (lev == 1), ob0, zero)
    rate = rate + torch.where(~ge_base & (lev == 2), ob1 + ab0, zero)
    return torch.where(lev > 0, rate, zero)


def _rcount(a: torch.Tensor) -> torch.Tensor:
    """Count of set entries strictly after each position of its group of
    16 (integer, so any order)."""
    return torch.flip(torch.cumsum(torch.flip(a, [-1]), -1), [-1]) - a


def rdoq_quant_plain(coef: torch.Tensor, scan_id: torch.Tensor, *, qp: int,
                     log2_size: int, bit_depth: int, c_idx: int,
                     init_type: int, lam: float) -> torch.Tensor:
    """Plain PyTorch body of :func:`rdoq_quant` (any device)."""
    dev = coef.device
    f32, i32 = torch.float32, torch.int32
    t = _tables_for(log2_size, c_idx, qp, init_type)
    dt = device_tables(log2_size, c_idx, qp, init_type, dev)
    pr = params(qp, log2_size, bit_depth, lam)
    n = 1 << log2_size
    m = n * n
    ncg, side = t["ncg"], t["side"]
    b = coef.shape[0]
    qbits, qscale = pr["qbits"], pr["qscale"]
    es = torch.tensor(pr["err_scale"], dtype=f32, device=dev)
    lam = torch.tensor(pr["lam"], dtype=f32, device=dev)
    single = single_scan(log2_size, c_idx)
    forms = float_forms(log2_size, c_idx)
    sid = (torch.zeros(b, dtype=torch.int64, device=dev) if single
           else scan_id.to(torch.int64))
    perm = dt["perm"].long()[sid]                          # [B, M]
    c = torch.gather(coef.reshape(b, m).to(i32), 1, perm)  # scan order
    sign = c < 0
    ld = torch.abs(c) * qscale                             # lLevelDouble
    max_abs = (ld + (1 << (qbits - 1))) >> qbits

    pidx = torch.arange(m, dtype=i32, device=dev)[None]
    nzp = max_abs > 0
    last_pos = torch.where(nzp, pidx, -1).amax(1)          # [B]
    active = pidx <= last_pos[:, None]

    # ---- CG sig flags (pre-decision) + neighbour pattern + sig ctx -------
    g = max_abs.reshape(b, ncg, 16)
    ga = active.reshape(b, ncg, 16)
    cg_nz = ((g > 0) & ga).any(2)                          # [B, ncg]
    cgpos = dt["cgpos"].long()[sid]                        # [B, ncg, 2]
    cgx, cgy = cgpos[..., 0], cgpos[..., 1]
    flat = torch.zeros(b, side * side + 1, dtype=torch.bool, device=dev)
    flat.scatter_(1, cgy * side + cgx, cg_nz)
    # neighbours outside the grid read the spare cell (always False)
    spare = side * side
    ridx = torch.where(cgx + 1 < side, cgy * side + cgx + 1, spare)
    bidx = torch.where(cgy + 1 < side, (cgy + 1) * side + cgx, spare)
    right = torch.gather(flat, 1, ridx)
    below = torch.gather(flat, 1, bidx)
    pattern = right.to(i32) + 2 * below.to(i32)
    pattern_p = pattern.repeat_interleave(16, 1)           # [B, M]
    sig_ctx = torch.gather(dt["sig_tab"].long()[sid], 1,
                           pattern_p.long()[:, None, :])[:, 0]
    sig0 = dt["sig_bits"][sig_ctx, 0]
    sig1 = dt["sig_bits"][sig_ctx, 1]

    # ---- context trajectories from pre-decision levels -------------------
    gz = ((g > 0) & ga).to(i32)
    g1 = ((g > 1) & ga).to(i32)
    c1idx = _rcount(gz)
    c2idx = _rcount(g1)
    ones_before = c1idx - c2idx
    c1 = torch.where(c2idx > 0, 0, torch.clamp(1 + ones_before, max=3))
    cg_has_g1 = (g1 > 0).any(2)
    cg_i = torch.arange(ncg, dtype=i32, device=dev)[None]
    prev_g1 = torch.cat([cg_has_g1[:, 1:],
                         torch.zeros(b, 1, dtype=torch.bool, device=dev)], 1)
    last_cg = last_pos >> 4
    bump = prev_g1 & (cg_i + 1 <= last_cg[:, None])
    ctx_set = (torch.where((cg_i == 0) | (c_idx > 0), 0, 2)
               + bump.to(i32))                             # [B, ncg]
    lev_g = g * ga
    base_g = torch.where(c1idx < 8, 2 + (c2idx < 1).to(i32), 1)
    ge_g = lev_g >= base_g
    r_ge = torch.ones(b, ncg, 16, dtype=torch.bool, device=dev)
    rice = torch.zeros(b, ncg, 16, dtype=i32, device=dev)
    for i in range(4):
        trig = (ge_g & (lev_g > (3 << i)) & r_ge).to(i32)
        r_ge = _rcount(trig) > 0
        rice = rice + r_ge.to(i32)

    one_bits, abs_bits = dt["one_bits"], dt["abs_bits"]
    one_ctx = torch.clamp(ctx_set[:, :, None] * 4 + c1,
                          max=one_bits.shape[0] - 1).long()
    abs_ctx = torch.clamp(ctx_set, max=abs_bits.shape[0] - 1).long()
    ob0 = one_bits[one_ctx, 0].reshape(b, m)
    ob1 = one_bits[one_ctx, 1].reshape(b, m)
    ab0 = abs_bits[abs_ctx, 0].repeat_interleave(16, 1)
    ab1 = abs_bits[abs_ctx, 1].repeat_interleave(16, 1)
    rice_f = rice.reshape(b, m)
    c1i_f = c1idx.reshape(b, m)
    c2i_f = c2idx.reshape(b, m)

    # ---- level decision (xGetCodedLevel) ---------------------------------
    zero = torch.zeros((), dtype=f32, device=dev)
    inf = torch.full((), _INF, dtype=f32, device=dev)
    is_last = pidx == last_pos[:, None]
    ldf = ld.to(f32)
    ldf2 = ldf * ldf
    cost0 = ldf2 * es                                      # uncoded

    def coded_cost(lev):
        err = ldf - (lev << qbits).to(f32)
        r = _level_rate(lev, ob0, ob1, ab0, ab1, rice_f, c1i_f, c2i_f)
        return fma(err * err, es, lam * r)

    cand1 = max_abs
    cand2 = torch.clamp(max_abs - 1, min=1)
    lsig0, lsig1 = lam * sig0, lam * sig1
    sig_cost1 = torch.where(is_last, zero, lsig1)
    cost_c1 = coded_cost(cand1) + sig_cost1
    cost_c2 = torch.where(max_abs > 1, coded_cost(cand2) + sig_cost1, inf)
    # zero option: only when not last and max_abs < 3 (HM xGetCodedLevel)
    zero_ok = (~is_last) & (max_abs < 3)
    cost_z = torch.where(zero_ok, fma(ldf2, es, lsig0), inf)
    lev = torch.where(cost_c2 < cost_c1, cand2, cand1)
    cost_best = torch.minimum(cost_c1, cost_c2)
    lev = torch.where((cost_z < cost_best) | (max_abs == 0), 0, lev)
    lev = torch.where(active, lev, 0)
    # sig-flag cost actually paid at this position (0 for last / inactive)
    sig_paid = ~(is_last | ~active)
    sig_sel = torch.where(lev > 0, sig1, sig0)
    cost_sig = torch.where(sig_paid, lam * sig_sel, zero)
    cost_coeff = torch.where(lev > 0, cost_best, cost0 + cost_sig)
    cost_coeff = torch.where(active, cost_coeff, cost0)

    # ---- CG zeroing (explicitly coded CGs only: 0 < cg < last_cg) --------
    cg_bits = dt["cg_bits"]
    cg_ctx = (right | below).long()
    cgb0, cgb1 = cg_bits[cg_ctx, 0], cg_bits[cg_ctx, 1]
    cc = cost_coeff.reshape(b, ncg, 16)
    cg_final = (lev.reshape(b, ncg, 16) > 0).any(2)
    zero_gain = (fma(cgb1, lam, _seq_sum(cc))
                 - fma(cgb0, lam, fma_chain_sum(ldf2.reshape(b, ncg, 16),
                                                es)))
    can_zero = cg_final & (cg_i > 0) & (cg_i < last_cg[:, None])
    do_zero = can_zero & (zero_gain > 0)
    zmask = do_zero.repeat_interleave(16, 1)
    lev = torch.where(zmask, 0, lev)
    cost_coeff = torch.where(zmask, cost0, cost_coeff)
    cost_sig = torch.where(zmask, zero, cost_sig)
    sig_paid = sig_paid & ~zmask
    cg_final = cg_final & ~do_zero

    # ---- last-position / cbf tournament ----------------------------------
    # rate of CG sig flags for CGs strictly below the candidate's CG
    cg_rate = torch.where((cg_i > 0) & (cg_i < last_cg[:, None]),
                          torch.where(cg_final, lam * cgb1, lam * cgb0),
                          zero)
    cg_rate_below = xla_cumsum(cg_rate) - cg_rate          # exclusive
    cg_rate_below_p = cg_rate_below.repeat_interleave(16, 1)
    pref_coded = xla_cumsum(cost_coeff) - cost_coeff
    if forms["chain_total0"]:
        total0 = fma_chain_sum(ldf2, es)[:, None]
    else:
        total0 = xla_sum(cost0)[:, None]
    suff_unc = total0 - xla_cumsum(cost0)
    cbf_bits = dt["cbf_bits"]
    lam_cbf1 = lam * cbf_bits[1]
    last_tab = dt["last_tab"][sid]                         # [B, M]
    if forms["fused_head"]:
        head = fma(last_tab, lam, lam_cbf1)
    else:
        head = lam_cbf1 + lam * last_tab
    if forms["fused_sig"]:
        coded_net = torch.where(sig_paid, fma(-sig_sel, lam, cost_coeff),
                                cost_coeff)
    else:
        coded_net = cost_coeff - cost_sig
    tot = head + cg_rate_below_p + pref_coded + coded_net + suff_unc
    p2 = torch.where(lev > 1, pidx, 0).amax(1)
    cand_mask = (lev > 0) & (pidx >= p2[:, None])
    tot = torch.where(cand_mask, tot, inf)
    best_cost, best_last = last_tournament(tot)
    cbf0_cost = lam * cbf_bits[0] + total0[:, 0]
    keep = (best_cost < cbf0_cost) & (last_pos >= 0)
    lev = torch.where(keep[:, None] & (pidx <= best_last[:, None]), lev, 0)

    signed = torch.where(sign, -lev, lev)
    out = torch.zeros(b, m, dtype=i32, device=dev)
    out.scatter_(1, perm, signed)
    return out.reshape(b, n, n)


def rdoq_quant(coef: torch.Tensor, scan_id: torch.Tensor, *, qp: int,
               log2_size: int, bit_depth: int, c_idx: int, init_type: int,
               lam: float) -> torch.Tensor:
    """RDOQ levels for a batch of TUs.

    coef: [B, N, N] int32 signed transform coefficients.
    scan_id: [B] int32 MDCS scan (0 diag, 1 hor, 2 ver; only 4x4/8x8 use 1/2).
    lam: full lambda (already chroma-weighted by the caller for chroma).
    Returns [B, N, N] int32 signed levels. A CUDA tensor launches kernel
    C7; a CPU tensor runs :func:`rdoq_quant_plain`.
    """
    if not coef.is_cuda:
        return rdoq_quant_plain(coef, scan_id, qp=qp, log2_size=log2_size,
                                bit_depth=bit_depth, c_idx=c_idx,
                                init_type=init_type, lam=lam)
    return _rdoq_cuda(coef, scan_id, qp, log2_size, bit_depth, c_idx,
                      init_type, lam)


# ---------------------------------------------------------------------------
# CUDA launches.
# ---------------------------------------------------------------------------

class RdoqArgs(ctypes.Structure):
    """csrc/rdoq.cuh RdoqArgs, field for field."""
    _fields_ = [(k, ctypes.c_void_p) for k in (
        "perm", "sig_tab", "cgpos", "last_tab", "sig_bits", "one_bits",
        "abs_bits", "cg_bits", "cbf_bits")] + [
        ("n_one", ctypes.c_int), ("n_abs", ctypes.c_int),
        ("qscale", ctypes.c_int), ("qbits", ctypes.c_int),
        ("err_scale", ctypes.c_float), ("lam", ctypes.c_float),
        ("chain_total0", ctypes.c_int), ("fused_sig", ctypes.c_int),
        ("fused_head", ctypes.c_int)]


def kernel_args(log2: int, c_idx: int, qp: int, bit_depth: int,
                init_type: int, lam: float, device) -> RdoqArgs:
    """The RdoqArgs of one TU class, pointing at its tables on ``device``
    (cached with them, so the pointers stay valid; the level loop asks
    for the same few classes at every launch)."""
    return _kernel_args(log2, c_idx, qp, bit_depth, init_type, lam,
                        str(torch.device(device)))


@functools.lru_cache(maxsize=256)
def _kernel_args(log2, c_idx, qp, bit_depth, init_type, lam, device):
    dt = device_tables(log2, c_idx, qp, init_type, device)
    pr = params(qp, log2, bit_depth, lam)
    fm = float_forms(log2, c_idx)
    ptr = {k: ctypes.c_void_p(v.data_ptr()) for k, v in dt.items()}
    return RdoqArgs(
        ptr["perm"], ptr["sig_tab"], ptr["cgpos"], ptr["last_tab"],
        ptr["sig_bits"], ptr["one_bits"], ptr["abs_bits"], ptr["cg_bits"],
        ptr["cbf_bits"], dt["one_bits"].shape[0], dt["abs_bits"].shape[0],
        pr["qscale"], pr["qbits"], float(pr["err_scale"]), float(pr["lam"]),
        int(fm["chain_total0"]), int(fm["fused_sig"]), int(fm["fused_head"]))


def _rdoq_cuda(coef, scan_id, qp, log2_size, bit_depth, c_idx, init_type,
               lam):
    global LAUNCHES
    b, n = coef.shape[0], 1 << log2_size
    for t, name in ((coef, "coef"), (scan_id, "scan_id")):
        if not (t.is_cuda and t.dtype == torch.int32 and t.is_contiguous()):
            raise ValueError(f"rdoq: {name} must be a contiguous CUDA int32 "
                             "tensor")
    if tuple(coef.shape[1:]) != (n, n) or scan_id.shape != (b,):
        raise ValueError("rdoq: coef must be [B, n, n] and scan_id [B]")
    out = torch.empty_like(coef)
    if b == 0:
        return out
    args = kernel_args(log2_size, c_idx, qp, bit_depth, init_type, lam,
                       coef.device)
    fn = _cuda.bind("rdoq", "hh_rdoq_quant", "pppiiiipp")
    err = fn(coef.data_ptr(), scan_id.data_ptr(), out.data_ptr(), b, n,
             c_idx, int(single_scan(log2_size, c_idx)),
             ctypes.addressof(args), _cuda.stream(coef))
    _cuda.check("rdoq", err)
    LAUNCHES += 1
    return out
