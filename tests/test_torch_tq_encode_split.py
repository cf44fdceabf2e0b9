"""Kernel C3's encode body (``csrc/tq.cuh`` ``tq_encode_block``, run by C3's
encode entry, C13 and C14's write phase), on the CPU.

The body runs only on the card. What it computes is held here in
renderings of its own arithmetic and order:

- the forward transform as its lanes run it: each output of a 1-D
  transform on its own by HM's partial butterfly (an odd output the dot
  product of its row's first half with x[j] - x[N-1-j], an even one the
  half-size transform of x[j] + x[N-1-j]), rows then columns with the
  reference's shifts, int32 throughout, against ``transform.fwd_transform``
  and the JAX ``fwd_transform`` at 4x4 (DCT and DST) to 32x32, 8 and 10
  bit, on random residuals and on residuals of +-maxv;
- SBH as a group's 16 lanes run it (lane i the group's scan position i:
  the first and last nonzero position from a ballot, the parity from a
  ballot of the levels' low bits, the RD move's target from the xor-shuffle
  argmin that keeps the lowest cost and among equal costs the lowest
  position), against ``quant.sbh_adjust`` and the jitted JAX
  ``sbh_adjust`` with the coefficients, as every encoder path calls it, on
  every MDCS scan and on groups built to tie;
- the whole chain in the body's order (the quantizer in the forward
  transform's epilogue, the band's groups through lane SBH, the levels
  dequantized as the inverse transform loads them, each inverse stage
  summing only up to the last nonzero row or column, and the prediction
  added), against ``tq.tq_encode_plain`` and the jitted JAX chain at QP 0,
  22, 37 and 51.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_hop_tpu.ops import quant as jquant
from hevc_hop_tpu.ops import transform as jtr
from hevc_hop_torch.common import rom
from hevc_hop_torch.ops import quant, tq, transform

T = lambda a: torch.as_tensor(np.asarray(a))
DCT32 = rom.dct_matrix(32).astype(np.int64)
DST4 = np.asarray(rom.DST4, np.int64)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many small tensor ops: one thread, so the suite's workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _wrap32(v):
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


def _round(v, shift):
    return _wrap32(_wrap32(v) + (1 << (shift - 1))) >> shift


def _clip16(v):
    return np.clip(v, -32768, 32767)


def _dequant(level, dqs, dqsh):
    """dequant1: clip16((level * dqs + 2^(dqsh-1)) >> dqsh), int32."""
    return _clip16(_wrap32(_wrap32(np.asarray(level, np.int64) * dqs)
                           + (1 << (dqsh - 1))) >> dqsh)


def _mat(n, j, k):
    """Row j, column k (< n / 2) of the n-point DCT, as the kernel reads
    kDct[j * 32 / n][k]."""
    return DCT32[j * (32 // n), k]


# ---------------------------------------------------------------------------
# The 1-D transforms, one output at a time.
# ---------------------------------------------------------------------------

def fwd_one(x, k):
    """Output k of the forward DCT of x [..., N] (fwd_one<N>)."""
    n = x.shape[-1]
    if n == 2:
        return 64 * x[..., 0] + (-64 if k else 64) * x[..., 1]
    h = n // 2
    if k & 1:
        return sum(_mat(n, k, j) * (x[..., j] - x[..., n - 1 - j])
                   for j in range(h))
    return fwd_one(x[..., :h] + x[..., ::-1][..., :h], k >> 1)


def inv_one(x, k, lim):
    """Output k of the inverse DCT of x [..., N], rows j >= lim skipped
    (inv_one<N>): E and O at kk = min(k, N-1-k), E + O or E - O."""
    n = x.shape[-1]
    if n == 2:
        return 64 * x[..., 0] + (-64 if k else 64) * x[..., 1]
    h = n // 2
    kk = k if k < h else n - 1 - k
    e = inv_one(x[..., 0::2], kk, (lim + 1) // 2)
    o = sum((_mat(n, j, kk) * x[..., j] for j in range(1, min(lim, n), 2)),
            np.zeros_like(e))
    return e + o if k < h else e - o


def fwd_out(x, k, dst):
    if dst:
        return sum(DST4[k, j] * x[..., j] for j in range(4))
    return fwd_one(x, k)


def inv_out(x, k, lim, dst):
    if dst:
        return sum(DST4[j, k] * x[..., j] for j in range(4))
    return inv_one(x, k, lim)


def forward_2d(resi, bit_depth, dst):
    """Stage one by rows (lane y, round(., log2 + bd - 9)), stage two by
    columns (round(., log2 + 6)), every output on its own."""
    n = resi.shape[-1]
    log2 = n.bit_length() - 1
    x = resi.astype(np.int64)
    t = np.stack([_round(fwd_out(x, k, dst), log2 + bit_depth - 9)
                  for k in range(n)], -1)
    cols = np.swapaxes(t, -1, -2)       # [..., column, j]
    c = np.stack([_round(fwd_out(cols, k, dst), log2 + 6)
                  for k in range(n)], -2)
    return c


@functools.lru_cache(maxsize=None)
def _jax_fwd(n, dst):
    """The jitted JAX forward transform at 8 and 10 bit."""
    return jax.jit(lambda r8, r10: (jtr.fwd_transform(r8, 8, dst),
                                    jtr.fwd_transform(r10, 10, dst)))


@pytest.mark.parametrize("n,dst", [(4, True), (4, False), (8, False),
                                   (16, False), (32, False)])
def test_forward_butterflies_match_reference(n, dst):
    rng = np.random.default_rng(n + 100 * dst)
    resi = {}
    for bd in (8, 10):
        maxv = (1 << bd) - 1
        r = rng.integers(-maxv, maxv + 1, (8, n, n))
        r[:3] = rng.choice([-maxv, maxv], (3, n, n))   # +-maxv
        r[3] = maxv
        r[4] = -maxv
        resi[bd] = r.astype(np.int32)
    want = _jax_fwd(n, dst)(resi[8], resi[10])
    for bd, ref in zip((8, 10), want):
        got = forward_2d(resi[bd], bd, dst)
        np.testing.assert_array_equal(got, np.asarray(ref))
        np.testing.assert_array_equal(
            got, transform.fwd_transform(T(resi[bd]), bd, dst).numpy())


def test_lane_assignment_covers_every_output():
    """Each 1-D stage's outputs split over the eight warps exactly once:
    rows stages w * K + q, the inverse columns w, N-1-w, N/2-1-w, N/2+w;
    the forward columns by bands of four rows, one output a lane at 8x8
    and 4x4 (no stage on fewer threads than its outputs there)."""
    for n in (4, 8, 16, 32):
        k_per = max(n // 8, 1)
        warps = [w for w in range(8) if w * k_per < n]
        rows = sorted(w * k_per + q for w in warps for q in range(k_per))
        inv = sorted([w, n - 1 - w, n // 2 - 1 - w, n // 2 + w][q]
                     for w in warps for q in range(k_per))
        assert rows == inv == list(range(n))
        if n <= 8:
            # four lanes a column, lane // n its row of the band
            lanes = [(w, lane) for w in range(n // 4) for lane in range(4 * n)]
            outs = sorted((4 * w + lane // n, lane % n) for w, lane in lanes)
            assert outs == [(k, x) for k in range(n) for x in range(n)]
            assert len(lanes) >= n * n


# ---------------------------------------------------------------------------
# SBH, a group per 16 lanes.
# ---------------------------------------------------------------------------

DIAG4 = 0xfbe7ad369c258140


def scan4_pos(sid, i):
    """The raster index within a 4x4 group of scan position i."""
    if sid == 1:
        return i
    if sid == 2:
        return ((i & 3) << 2) | (i >> 2)
    return (DIAG4 >> (4 * i)) & 15


def test_scan4_pos_is_every_scan():
    """Every group of every scan, size and MDCS choice visits its 16
    positions in scan4_pos's order."""
    for log2 in (2, 3, 4, 5):
        n = 1 << log2
        for sid in range(3):
            perm = np.asarray(rom.scan_raster_index(log2, sid))
            for g in range(n * n // 16):
                ch = perm[16 * g:16 * g + 16]
                y0, x0 = (ch // n).min(), (ch % n).min()
                got = [int((y - y0) * 4 + (x - x0))
                       for y, x in zip(ch // n, ch % n)]
                assert got == [scan4_pos(sid, i) for i in range(16)]


def lane_sbh(q, cq, lamc, dqs, dqsh):
    """sbh_band's lanes over groups q, cq [G, 16] (levels and coefficients
    in scan order): returns the adjusted levels."""
    q = q.astype(np.int64).copy()
    g, idx = q.shape[0], np.arange(16)
    nz = q != 0
    m = (nz.astype(np.int64) << idx).sum(1)                 # the ballot
    first = np.where(m > 0, np.argmax(nz, 1), 99)
    last = np.where(m > 0, 15 - np.argmax(nz[:, ::-1], 1), -1)
    odd = ((np.abs(q) & 1) << idx).sum(1)                   # low bits
    parity = np.array([bin(int(v)).count("1") & 1 for v in odd]) == 1
    vfirst = q[np.arange(g), np.minimum(first, 15)]
    mism = ((last - first) >= 4) & (parity != (vfirst < 0))
    m2 = np.where(last >= 0, m & ~(1 << np.maximum(last, 0)), 0)
    last2 = np.array([int(v).bit_length() - 1 for v in m2])
    collapse = (last2 - first) < 4
    a, s = np.abs(q), np.sign(q)
    deq = lambda v: _dequant(v, dqs, dqsh)
    f32 = lambda v: torch.as_tensor(v.astype(np.float32))
    d_cur, d_dec, d_inc = (f32(cq - deq(v)) for v in (q, q - s, q + s))
    r = lambda v: quant._rate(T(v.astype(np.int32)))
    r_cur, r_dec, r_inc = r(a), r(a - 1), r(a + 1)
    cost_dec = quant._sbh_cost(d_dec, d_cur, lamc, r_dec, r_cur).float()
    cost_inc = quant._sbh_cost(d_inc, d_cur, lamc, r_inc, r_cur).float()
    i = idx[None]
    dec_ok = nz & ~(((i == first[:, None])
                     | ((i == last[:, None]) & collapse[:, None]))
                    & (a == 1))
    big = torch.tensor(3e38, dtype=torch.float32)
    cost_dec = torch.where(T(dec_ok), cost_dec, big).numpy()
    cost_inc = torch.where(T(nz), cost_inc, big).numpy()
    use_dec = cost_dec <= cost_inc
    bc, bi = np.minimum(cost_dec, cost_inc), np.tile(idx, (g, 1))
    for o in (8, 4, 2, 1):                                  # xor shuffles
        oc, oi = bc[:, idx ^ o], bi[:, idx ^ o]
        take = (oc < bc) | ((oc == bc) & (oi < bi))
        bc, bi = np.where(take, oc, bc), np.where(take, oi, bi)
    assert (bi == bi[:, :1]).all(), "every lane holds the argmin"
    tgt = bi[:, 0]
    dec = use_dec[np.arange(g), tgt]
    st = np.sign(q[np.arange(g), tgt])
    delta = np.where(dec, -st, st)
    q[np.arange(g)[mism], tgt[mism]] += delta[mism]
    return q


def to_groups(a, sid):
    """[B, N, N] raster -> [B * N^2 / 16, 16] in each group's scan order
    (groups in raster order of their position; SBH treats each alone)."""
    b, n, _ = a.shape
    pos = [scan4_pos(sid, i) for i in range(16)]
    g = a.reshape(b, n // 4, 4, n // 4, 4).transpose(0, 1, 3, 2, 4)
    return g.reshape(-1, 16)[:, pos]


def from_groups(g, sid, b, n):
    pos = [scan4_pos(sid, i) for i in range(16)]
    out = np.empty_like(g)
    out[:, pos] = g
    return out.reshape(b, n // 4, n // 4, 4, 4).transpose(
        0, 1, 3, 2, 4).reshape(b, n, n)


def band_sbh(lev, coef, sids, qp, bit_depth, lam):
    """SBH over blocks [B, N, N], each in its scan sids[b], a group per 16
    lanes."""
    b, n, _ = lev.shape
    log2 = n.bit_length() - 1
    dqs, dqsh = quant.dequant_params(qp, log2, bit_depth)
    lamc = np.float32(lam * (4.0 ** (15 - bit_depth - log2)))
    out = np.empty_like(lev)
    for sid in np.unique(sids):
        at = np.flatnonzero(sids == sid)
        q = to_groups(lev[at], sid)
        cq = to_groups(coef[at], sid).astype(np.int64)
        out[at] = from_groups(lane_sbh(q, cq, lamc, dqs, dqsh), sid,
                              len(at), n)
    return out


_SBH_JIT = jax.jit(jquant.sbh_adjust,
                   static_argnames=("c_idx", "qp", "bit_depth", "lam"))


def _tied_groups(rng, n, qp):
    """Blocks whose groups hide a sign and tie: equal levels on equal
    coefficients at several positions, so that their RD costs are equal
    (the argmin's tie rule decides), with the parity set to disagree."""
    log2 = n.bit_length() - 1
    dqs, dqsh = quant.dequant_params(qp, log2, 8)
    lev = np.zeros((4, n, n), np.int64)
    coef = np.zeros((4, n, n), np.int64)
    for b in range(4):
        for gy in range(0, n, 4):
            for gx in range(0, n, 4):
                v = int(rng.integers(1, 4)) * (1 if rng.random() < .5 else -1)
                cells = rng.choice(16, size=int(rng.integers(3, 7)),
                                   replace=False)
                cells = np.union1d(cells, [0, 15])
                for c in cells:
                    lev[b, gy + c // 4, gx + c % 4] = v
                    coef[b, gy + c // 4, gx + c % 4] = (
                        v * dqs * 16 // (1 << dqsh) + int(np.sign(v)) * 3)
    return lev.astype(np.int32), coef.astype(np.int32)


@pytest.mark.parametrize("n,c_idx", [(4, 0), (4, 1), (8, 0), (8, 1),
                                     (16, 0), (16, 1), (32, 0), (32, 1)])
def test_lane_sbh_matches_reference(n, c_idx):
    rng = np.random.default_rng(n * 3 + c_idx + 50)
    qp, lam = 27, 57.3
    log2 = n.bit_length() - 1
    coef = rng.integers(-2000, 2000, (12, n, n)).astype(np.int32)
    coef[:4] = (coef[:4] * (rng.random((4, n, n)) < 0.3))   # sparse ones
    lev = np.asarray(jquant.quant(coef, qp, log2)).astype(np.int32)
    tl, tc = _tied_groups(rng, n, qp)
    lev, coef = np.concatenate([lev, tl]), np.concatenate([coef, tc])
    multi = n == 4 or (n == 8 and c_idx == 0)
    sids = (np.arange(lev.shape[0]) % 3 if multi
            else np.zeros(lev.shape[0], np.int64)).astype(np.int32)
    got = band_sbh(lev, coef, sids, qp, 8, lam)
    ref = _SBH_JIT(lev, sids, c_idx=c_idx, coef=coef, qp=qp, bit_depth=8,
                   lam=lam)
    plain = quant.sbh_adjust(T(lev), T(sids), c_idx, coef=T(coef), qp=qp,
                             bit_depth=8, lam=lam)
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(got, plain.numpy())
    assert (got != lev).any(), "no group needed hiding"


# ---------------------------------------------------------------------------
# The fused chain.
# ---------------------------------------------------------------------------

def body(org, pred, modes, n, c_idx, qp, bit_depth):
    """tq_block_n without RDOQ, block by block: returns (recon, levels,
    cbf)."""
    log2 = n.bit_length() - 1
    dst = n == 4 and c_idx == 0
    maxv = (1 << bit_depth) - 1
    qs, qbits, qoff = quant.quant_params(qp, log2, bit_depth)
    dqs, dqsh = quant.dequant_params(qp, log2, bit_depth)
    c = forward_2d(org.astype(np.int64) - pred, bit_depth, dst)
    # the quantizer in stage two's epilogue
    lev = np.clip(np.sign(c) * (_wrap32(_wrap32(np.abs(c) * qs) + qoff)
                                >> qbits), -32768, 32767)
    sids = tq.mdcs_scan_id(T(modes), n, c_idx).numpy()
    single = not (log2 == 2 or (log2 == 3 and c_idx == 0))
    lev = band_sbh(lev, c, np.zeros_like(sids) if single else sids, qp,
                   bit_depth, 0.0)
    recon = np.empty_like(pred)
    for b in range(lev.shape[0]):
        nzr, nzc = np.nonzero(lev[b])
        if not len(nzr):                       # no level: the prediction
            recon[b] = np.clip(pred[b], 0, maxv)
            continue
        rows, cols = nzr.max() + 1, nzc.max() + 1
        # stage one: lane x loads column x, dequantized, rows below `rows`
        d = np.where(np.arange(n)[:, None] < rows,
                     _dequant(lev[b], dqs, dqsh), 0)
        e = np.stack([_clip16(_round(inv_out(d.T, k, rows, dst), 7))
                      for k in range(n)], 0)
        e = np.where(np.arange(n)[None] < cols, e, 0)
        assert not e[:, cols:].any()
        r = np.stack([_clip16(_round(inv_out(e, k, cols, dst),
                                     20 - bit_depth)) for k in range(n)], -1)
        recon[b] = np.clip(pred[b] + r, 0, maxv)
    cbf = (lev != 0).reshape(lev.shape[0], -1).any(1).astype(np.int32)
    return recon, lev, cbf


@functools.lru_cache(maxsize=None)
def _jax_chain(n, c_idx, qp, bit_depth):
    log2 = n.bit_length() - 1
    dst = n == 4 and c_idx == 0

    def run(org, pred, sid):
        coef = jtr.fwd_transform(org - pred, bit_depth, dst)
        lev = jquant.quant(coef, qp, log2, bit_depth, True)
        lev = jquant.sbh_adjust(lev, sid, c_idx, coef, qp, bit_depth, 0.0)
        rq = jtr.inv_transform(jquant.dequant(lev, qp, log2, bit_depth),
                               bit_depth, dst)
        return jnp.clip(pred + rq, 0, (1 << bit_depth) - 1), lev
    return jax.jit(run)


# the sizes each QP's chain holds against the JAX chain (every size is held
# against tq_encode_plain at every QP)
JAX_SIZES = {0: (32,), 22: (16,), 37: (8,), 51: (4,)}


@pytest.mark.parametrize("qp", [0, 22, 37, 51])
def test_fused_chain_matches_plain_and_reference(qp):
    rng = np.random.default_rng(qp)
    for n, c_idx, bd in ((4, 0, 8), (4, 1, 10), (8, 0, 8), (16, 1, 10),
                         (32, 0, 8)):
        maxv = (1 << bd) - 1
        h, w = 2 * n, 3 * n
        org = rng.integers(0, maxv + 1, (h, w)).astype(np.int32)
        pos = np.array([[x, y] for y in range(0, h, n)
                        for x in range(0, w, n)], np.int32)
        blocks = org.reshape(h // n, n, w // n, n).transpose(
            0, 2, 1, 3).reshape(-1, n, n)
        pred = np.clip(blocks + rng.integers(-60, 61, blocks.shape), 0,
                       maxv).astype(np.int32)
        pred[0] = np.where(blocks[0] > maxv // 2, 0, maxv)   # +-maxv resi
        pred[1] = blocks[1]                                  # no residual
        modes = rng.integers(0, 35, 6).astype(np.int32)
        modes[:3] = (26, 10, 2)                              # every scan
        recon, lev, cbf = body(blocks, pred, modes, n, c_idx, qp, bd)
        rec_p = torch.zeros(h, w, dtype=torch.int32)
        cp_p = torch.zeros(h, w, dtype=torch.int16)
        cbf_p = tq.tq_encode_plain(T(org), T(pred), T(pos), T(modes), n,
                                   c_idx, qp, bd, True, None, rec_p, cp_p)
        as_blocks = lambda a: a.numpy().reshape(h // n, n, w // n, n) \
            .transpose(0, 2, 1, 3).reshape(-1, n, n)
        np.testing.assert_array_equal(recon, as_blocks(rec_p))
        np.testing.assert_array_equal(lev, as_blocks(cp_p))
        np.testing.assert_array_equal(cbf, cbf_p.numpy())
        if n in JAX_SIZES[qp]:
            sid = tq.mdcs_scan_id(T(modes), n, c_idx).numpy()
            jrec, jlev = _jax_chain(n, c_idx, qp, bd)(blocks, pred, sid)
            np.testing.assert_array_equal(recon, np.asarray(jrec))
            np.testing.assert_array_equal(lev, np.asarray(jlev))
