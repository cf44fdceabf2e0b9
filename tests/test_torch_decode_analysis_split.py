"""Kernel C3's decode entry (one launch per picture) and kernel C2's analysis
entry (the 35-mode SATD in a warp's registers), on the CPU.

Both kernels run only on the card. What they compute is held here in
renderings of their own arithmetic and order:

- the decode entry's work list (ops/tq.py ``residual_classes``: every TU
  of the three planes in classes of one plane and one size, the largest
  first, 32 / n TUs to a warp), walked unit by unit in list order and
  reversed, each unit with the warp's vote (the rows and columns that
  hold a level) and HM's partial butterflies in the kernel's even/odd
  order, bit for bit against the per-size decode (one ``tq_decode`` per
  plane and size) and the JAX decoder's ``_residual_mixed`` /
  ``_residual_uniform``;
- the butterflies alone against ``transform.inv_transform`` and the JAX
  ``inv_transform`` on extreme inputs;
- the analysis entry's chain, its angular indices (the intraPredAngle
  values and the clamped side-reference table, a horizontal mode predicted
  transposed), its Hadamard (rows by butterflies, columns by xor-partner
  stages) and its tie rule, against ``intra.predict_all_modes``,
  ``intra.satd``, ``mesh.analysis_blocks_plain`` and the JAX
  ``analysis_costs``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_hop_tpu.models import decoder as jdec
from hevc_hop_tpu.ops import transform as jtr
from hevc_hop_tpu.parallel import mesh as jmesh
from hevc_hop_torch.common import rom
from hevc_hop_torch.ops import intra, quant, tq, transform
from hevc_hop_torch.parallel import mesh

T = lambda a: torch.as_tensor(np.asarray(a))
DCT32 = rom.dct_matrix(32).astype(np.int64)


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


def _clip16(v):
    return np.clip(v, -32768, 32767)


# ---------------------------------------------------------------------------
# The decode entry.
# ---------------------------------------------------------------------------

def butterfly(x, lim):
    """out[..., k] = sum_{j < lim} T[j][k] x[..., j] over the N-point DCT T
    (N = x.shape[-1]), as the kernel's inv_butterfly: the odd rows' dot
    products below lim, the even rows recursively, out[k] = E[k] + O[k],
    out[N-1-k] = E[k] - O[k]. Every partial sum must fit in int32."""
    n = x.shape[-1]
    if n == 4:
        e0, e1 = 64 * x[..., 0] + 64 * x[..., 2], 64 * x[..., 0] - 64 * x[..., 2]
        o0 = 83 * x[..., 1] + 36 * x[..., 3]
        o1 = 36 * x[..., 1] - 83 * x[..., 3]
        out = np.stack([e0 + o0, e1 + o1, e1 - o1, e0 - o0], -1)
    else:
        e = butterfly(x[..., 0::2], (lim + 1) // 2)
        o = np.zeros(x.shape[:-1] + (n // 2,), np.int64)
        for j in range(1, n, 2):
            if j >= lim:
                break
            o = o + DCT32[j * (32 // n), :n // 2] * x[..., j:j + 1]
        out = np.concatenate([e + o, (e - o)[..., ::-1]], -1)
    assert np.abs(out).max(initial=0) < 1 << 31
    return out


def inverse_2d(coef, bit_depth, dst, rows=None, cols=None):
    """The kernel's inverse transform of [B, N, N] coefficients: stage one
    on each column over the rows below ``rows``, the first clamp, stage
    two on each row over the columns left of ``cols``, the second."""
    n = coef.shape[-1]
    rows = n if rows is None else rows
    cols = n if cols is None else cols
    if dst and n == 4:
        one_d = lambda x, lim: x @ rom.DST4.astype(np.int64)
    else:
        one_d = butterfly
    x = coef.astype(np.int64)
    e = one_d(np.swapaxes(x, -1, -2), rows)          # [B, column, k]
    e = _clip16((np.swapaxes(e, -1, -2) + 64) >> 7)  # [B, k, column]
    sh = 20 - bit_depth
    return _clip16((one_d(e, cols) + (1 << (sh - 1))) >> sh)


def dequant(levels, qp, log2, bit_depth):
    """The kernel's dequant1: int32 products that wrap, then the clamp."""
    dqs, dqsh = quant.dequant_params(qp, log2, bit_depth)
    v = _wrap32(_wrap32(levels.astype(np.int64) * dqs) + (1 << (dqsh - 1)))
    return _clip16(v >> dqsh)


def walk(planes, classes, bit_depth, reverse=False):
    """A plain walk of the decode entry's work list, warp unit by warp
    unit: the unit's 32 / n TUs, its vote (the last row and column holding
    a level over all of them; none: zeros), dequant and the butterflies
    bounded by the vote."""
    outs = [np.full(lev.shape, 12345, np.int64) for lev, _, _ in planes]
    units = []
    for plane, log2, pos, unit0 in tq.residual_classes(classes)[0]:
        per = 32 >> log2
        pos = pos.numpy()
        units += [(plane, log2, pos[i:i + per])
                  for i in range(0, len(pos), per)]
    for plane, log2, pos in (units[::-1] if reverse else units):
        lev, qp, dst = planes[plane]
        n = 1 << log2
        blocks = np.stack([lev[y:y + n, x:x + n] for x, y in pos])
        nz = blocks != 0
        rows = int(np.nonzero(nz.any((0, 2)))[0].max(initial=-1)) + 1
        cols = int(np.nonzero(nz.any((0, 1)))[0].max(initial=-1)) + 1
        if rows == 0:
            res = np.zeros(blocks.shape, np.int64)
        else:
            res = inverse_2d(dequant(blocks, qp, log2, bit_depth), bit_depth,
                             dst, rows, cols)
        for (x, y), r in zip(pos, res):
            outs[plane][y:y + n, x:x + n] = r
    return outs


def _tiling(h, w, rng, sizes):
    """TUs of the given log2 sizes tiling an h x w plane (h, w multiples
    of 32): each 32x32 area split at random down to the smallest size."""
    out = []

    def rec(x, y, lg):
        if lg > min(sizes) and (lg not in sizes or rng.random() < 0.55):
            s = 1 << (lg - 1)
            for dy in (0, s):
                for dx in (0, s):
                    rec(x + dx, y + dy, lg - 1)
        else:
            out.append((x, y, lg))
    for y in range(0, h, 32):
        for x in range(0, w, 32):
            rec(x, y, 5)
    return out


def _levels(h, w, tus, rng):
    """Levels of every kind: all-zero TUs, a low-frequency corner, sparse
    noise, and the int16 extremes."""
    lev = np.zeros((h, w), np.int16)
    for x, y, lg in tus:
        n = 1 << lg
        kind = rng.integers(0, 4)
        blk = np.zeros((n, n), np.int64)
        if kind == 1:
            k = rng.integers(1, n + 1)
            blk[:k, :rng.integers(1, n + 1)] = rng.integers(-40, 41, (k, 1))
        elif kind == 2:
            blk = rng.choice([-32768, 32767, 0, 1, -1], (n, n))
        elif kind == 3:
            blk = rng.integers(-300, 301, (n, n)) * (rng.random((n, n)) < 0.2)
        lev[y:y + n, x:x + n] = blk
    return lev


# (luma h, w, luma sizes, bit depth, DST, luma QP); chroma is half size,
# its TUs one size down, at its own QP (rom.chroma_qp_from_luma)
PICTURES = {
    "64x64-8bit-dst": (64, 64, (2, 3, 4, 5), 8, True, 32),
    "128x96-10bit": (96, 128, (2, 3, 4, 5), 10, False, 22),
    "128x96-8bit-uniform": (96, 128, (4,), 8, True, 45),
}


@functools.lru_cache(maxsize=None)
def _picture(name):
    h, w, sizes, bd, dst, qp = PICTURES[name]
    rng = np.random.default_rng(len(name))
    tus = _tiling(h, w, rng, sizes)
    ctus = [(x // 2, y // 2, lg - 1) for x, y, lg in tus if lg > 2]
    ctus += sorted({(x // 8 * 4, y // 8 * 4, 2) for x, y, lg in tus
                    if lg == 2})
    qpc = int(rom.chroma_qp_from_luma(qp))
    planes = [(_levels(h, w, tus, rng), qp, dst),
              (_levels(h // 2, w // 2, ctus, rng), qpc, False),
              (_levels(h // 2, w // 2, ctus, rng), qpc, False)]
    by = lambda ts: {lg: np.array([(x, y) for x, y, g in ts if g == lg],
                                  np.int32)
                     for lg in sorted({g for _, _, g in ts})}
    classes = [(0, lg, T(p)) for lg, p in by(tus).items()] + [
        (c, lg, T(p)) for c in (1, 2) for lg, p in by(ctus).items()]
    return planes, classes, bd, by(tus), by(ctus)


@functools.lru_cache(maxsize=None)
def _per_size(name):
    """The per-size decode: one tq_decode per plane and TU size."""
    planes, classes, bd, _, _ = _picture(name)
    outs = [torch.zeros(lev.shape, dtype=torch.int32) for lev, _, _ in planes]
    for plane, log2, pos in classes:
        lev, qp, dst = planes[plane]
        tq.tq_decode(T(lev), pos, 1 << log2, qp, bd, dst and log2 == 2,
                     outs[plane])
    return [o.numpy() for o in outs]


@functools.lru_cache(maxsize=None)
def _jax(name):
    planes, _, bd, luma, chroma = _picture(name)
    out = []
    for (lev, qp, dst), by in zip(planes, (luma, chroma, chroma)):
        if len(by) == 1:
            (log2,) = by
            out.append(np.asarray(jdec._residual_uniform(
                jnp.asarray(lev), qp, bd, log2, dst)))
        else:
            out.append(np.asarray(jdec._residual_mixed(
                jnp.asarray(lev), {k: jnp.asarray(v) for k, v in by.items()},
                qp, bd, tuple(sorted(by)), dst)))
    return out


def test_work_list_order_and_units():
    planes, classes, _, _, _ = _picture("64x64-8bit-dst")
    work, units = tq.residual_classes(classes)
    keys = [(-lg, p) for p, lg, _, _ in work]
    assert keys == sorted(keys) and len(work) == len(classes)
    unit = 0
    for plane, log2, pos, unit0 in work:
        assert unit0 == unit
        unit += -(-pos.shape[0] // (32 >> log2))
    assert units == unit
    # every TU of every plane once
    for plane, (lev, _, _) in enumerate(planes):
        cover = np.zeros(lev.shape, np.int32)
        for p, log2, pos, _ in work:
            if p == plane:
                for x, y in pos.numpy():
                    cover[y:y + (1 << log2), x:x + (1 << log2)] += 1
        assert (cover == 1).all()


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("name", list(PICTURES))
def test_work_list_walk_matches_per_size_and_reference(name, reverse):
    planes, classes, bd, _, _ = _picture(name)
    got = walk(planes, classes, bd, reverse)
    for g, p, j in zip(got, _per_size(name), _jax(name)):
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, j)


@pytest.mark.parametrize("name", list(PICTURES))
def test_decode_picture_plain_matches_per_size(name):
    planes, classes, bd, _, _ = _picture(name)
    outs = [torch.full(lev.shape, 7, dtype=torch.int32)
            for lev, _, _ in planes]
    tq.tq_decode_picture([(T(lev), o, qp, dst) for (lev, qp, dst), o
                          in zip(planes, outs)], classes, bd)
    for o, p in zip(outs, _per_size(name)):
        np.testing.assert_array_equal(o.numpy(), p)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("n,dst", [(4, True), (4, False), (8, False),
                                   (16, False), (32, False)])
def test_butterflies_match_inv_transform(n, dst, bd):
    rng = np.random.default_rng(n + 100 * bd + dst)
    coef = rng.integers(-32768, 32768, (16, n, n)).astype(np.int32)
    coef[0] = 32767
    coef[1] = -32768
    coef[2] = np.where(rng.random((n, n)) < 0.5, 32767, -32768)
    coef[3] = np.where(np.add.outer(np.arange(n), np.arange(n)) % 2,
                       -32768, 32767)
    coef[4:8] //= 64
    coef[8:12] = 0
    coef[8:12, :3, :2] = rng.integers(-32768, 32768, (4, 3, 2))
    want = transform.inv_transform(T(coef), bd, dst).numpy()
    np.testing.assert_array_equal(want,
                                  np.asarray(jtr.inv_transform(coef, bd, dst)))
    np.testing.assert_array_equal(inverse_2d(coef, bd, dst), want)
    # the vote's bounds: rows and columns beyond the last nonzero skipped
    np.testing.assert_array_equal(inverse_2d(coef[8:12], bd, dst, 3, 2),
                                  want[8:12])


# ---------------------------------------------------------------------------
# The analysis entry.
# ---------------------------------------------------------------------------

def chains(band, halo_row, n, bit_depth):
    """[B, 4n+1] chains of a band's blocks, as the kernel builds them:
    ext coordinates with the halo as row 0 and mid-grey as column 0, the
    left column clipped at the band's last row, the top row at the last
    column."""
    h, w = band.shape
    mid = 1 << (bit_depth - 1)
    ext = np.full((h + 1, w + 1), mid, np.int64)
    ext[1:, 1:] = band
    ext[0, 1:] = halo_row
    out = []
    for py in range(0, h, n):
        for px in range(0, w, n):
            ys, xs = py + 1, px + 1
            c = []
            for j in range(4 * n + 1):
                if j < 2 * n:
                    ey, ex = min(ys + 2 * n - 1 - j, h), xs - 1
                elif j == 2 * n:
                    ey, ex = ys - 1, xs - 1
                else:
                    ey, ex = ys - 1, min(xs + j - 2 * n - 1, w)
                c.append(ext[ey, ex])
            out.append(c)
    return np.array(out, np.int64)


def predictions(cu, n, bit_depth):
    """[B, 35, n, n] predictions as the kernel forms them: planar and DC in
    row form, an angular mode in vertical form from the intraPredAngle
    value, a horizontal one transposed; the side reference through the
    table clamped to the chain, with one zero entry after it (read only at
    a weight of 0)."""
    b = cu.shape[0]
    log2 = n.bit_length() - 1
    use_filter = n > 4
    cf = cu.copy()
    if use_filter:
        cf[:, 1:-1] = (cu[:, :-2] + 2 * cu[:, 1:-1] + cu[:, 2:] + 2) >> 2
    maxv = (1 << bit_depth) - 1
    e = 3 * n + 1
    ext = np.concatenate([np.clip(intra.static_tables(n)["ext_idx"], 0,
                                  4 * n).ravel(), [0]])
    thresh = {2: 10, 3: 7, 4: 1, 5: 0}[log2]
    y = np.arange(n)[:, None]
    x = np.arange(n)[None, :]
    rows = np.arange(b)[:, None, None]
    out = np.zeros((b, 35, n, n), np.int64)
    out[:, 0] = ((n - 1 - x) * cf[:, 2 * n - 1 - y]
                 + (x + 1) * cf[:, 3 * n + 1, None, None]
                 + (n - 1 - y) * cf[:, 2 * n + 1 + x]
                 + (y + 1) * cf[:, n - 1, None, None] + n) >> (log2 + 1)
    dc = (cu[:, 2 * n + 1:3 * n + 1].sum(1) + cu[:, n:2 * n].sum(1)
          + n) >> (log2 + 1)
    out[:, 1] = dc[:, None, None]
    if n < 32:
        out[:, 1, 0, :] = (cu[:, 2 * n + 1:3 * n + 1] + 3 * dc[:, None]
                           + 2) >> 2
        out[:, 1, :, 0] = (cu[:, 2 * n - 1 - np.arange(n)] + 3 * dc[:, None]
                           + 2) >> 2
        out[:, 1, 0, 0] = (cu[:, 2 * n - 1] + 2 * dc + cu[:, 2 * n + 1]
                           + 2) >> 2
    for m in range(2, 35):
        mi = m - 2
        ang = int(rom.INTRA_PRED_ANGLE[mi])
        rowv, colv = y + 0 * x, x + 0 * y     # vertical form
        pos = (rowv + 1) * ang
        off, f = pos >> 5, pos & 31
        q = mi * e + n + 1 + colv + off
        ch = cf if use_filter and min(abs(m - 26), abs(m - 10)) > thresh \
            else cu
        g0, g1 = ch[rows, ext[q]], ch[rows, ext[q + 1]]
        p = ((32 - f) * g0 + f * g1 + 16) >> 5
        corner = cu[:, 2 * n, None]
        if n < 32 and m == 26:
            p[:, :, 0] = np.clip(cu[:, 2 * n + 1, None] + (
                (cu[:, 2 * n - 1 - np.arange(n)] - corner) >> 1), 0, maxv)
        if n < 32 and m == 10:
            p[:, :, 0] = np.clip(cu[:, 2 * n - 1, None] + (
                (cu[:, 2 * n + 1 + np.arange(n)] - corner) >> 1), 0, maxv)
        out[:, m] = np.swapaxes(p, 1, 2) if m < 18 else p
    return out


def satd_lanes(d, n):
    """[..., n, n] differences -> [...] SATD as the kernel's lanes form
    it: each K x K tile's rows (a lane's K samples) through butterflies in
    registers, its columns through log2 K xor-partner stages across the
    tile's lanes, the absolute sum, its normalisation, the tiles' sum."""
    k = 8 if n >= 8 else 4
    lead = d.shape[:-2]
    t = d.reshape(*lead, n // k, k, n // k, k).swapaxes(-3, -2)
    s = 1
    while s < k:                       # rows: butterflies over i
        lo = np.array([i for i in range(k) if not i & s])
        a, c = t[..., lo].copy(), t[..., lo + s].copy()
        t[..., lo], t[..., lo + s] = a + c, a - c
        s <<= 1
    r = np.arange(k)
    s = 1
    while s < k:                       # columns: lane r and lane r ^ s
        partner = t[..., r ^ s, :]
        sign = np.where(r & s, -1, 1)[:, None]
        t = partner + sign * t
        s <<= 1
    tile = np.abs(t).sum((-1, -2))
    tile = (tile + 2) >> 2 if k == 8 else (tile + 1) >> 1
    return tile.sum((-1, -2))


def lane_costs(frame, halo_row, n, bit_depth):
    """[B, 35] costs of a band, each horizontal mode's tiles transposed
    (the kernel's column layout)."""
    h, w = frame.shape
    cu = chains(frame, halo_row, n, bit_depth)
    pred = predictions(cu, n, bit_depth)
    blocks = frame.reshape(h // n, n, w // n, n).swapaxes(1, 2).reshape(
        -1, 1, n, n).astype(np.int64)
    d = blocks - pred
    hor = np.zeros(35, bool)
    hor[2:18] = True
    d[:, hor] = np.swapaxes(d[:, hor], -1, -2)
    return cu, pred, satd_lanes(d, n)


def choose(costs):
    """The kernel's choice: the lowest cost, the first mode reaching it."""
    best = np.full(costs.shape[0], 0x7FFFFFFF, np.int64)
    mode = np.zeros(costs.shape[0], np.int64)
    for m in range(35):
        better = costs[:, m] < best
        best = np.where(better, costs[:, m], best)
        mode = np.where(better, m, mode)
    return best, mode


def _frame(h, w, bit_depth, flat, seed):
    rng = np.random.default_rng(seed)
    if flat:
        return np.full((1, h, w), 1 << (bit_depth - 1), np.int32)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = (xx * 3 + yy * 5 + 40 * np.sin(xx / 5.0)) % (1 << bit_depth)
    noise = rng.integers(0, 1 << bit_depth, (h, w))
    f = np.where(rng.random((h, w)) < 0.3, noise, smooth)
    return f.astype(np.int32)[None].clip(0, (1 << bit_depth) - 1)


# the reference's analysis_costs, jitted as analysis_step_sharded runs it
_JAX_COSTS = jax.jit(jmesh.analysis_costs, static_argnames=("n", "bit_depth"))


# (n, bit depth, flat): a 64x64 frame in two bands of 32 rows, the first
# with the mid-grey halo, the second with the first's last row; the flat
# mid-grey frame ties every mode
ANALYSIS_CASES = [(n, bd, False) for n in (4, 8, 16, 32) for bd in (8, 10)
                  ] + [(n, 8, True) for n in (4, 8, 16, 32)]


@pytest.mark.parametrize("n,bd,flat", ANALYSIS_CASES)
def test_analysis_lanes_match_reference(n, bd, flat):
    frame = _frame(64, 64, bd, flat, n + bd)
    band_h = 32
    halo = mesh.band_halos(T(frame), band_h, bd).numpy()
    costs, jax_costs = [], []
    for b in range(2):
        band = frame[0, b * band_h:(b + 1) * band_h]
        cu, pred, c = lane_costs(band, halo[0, b], n, bd)
        np.testing.assert_array_equal(
            cu, mesh._block_chains(T(band), T(halo[0, b]), n, bd).numpy())
        np.testing.assert_array_equal(pred, intra.predict_all_modes(
            T(cu).to(torch.int32), n, 0, bd, False).numpy())
        blocks = T(band).reshape(band_h // n, n, 64 // n, n).transpose(
            1, 2).reshape(-1, 1, n, n)
        np.testing.assert_array_equal(
            c, intra.satd(blocks, T(pred).to(torch.int32)).numpy())
        costs.append(c)
        jax_costs.append(np.asarray(_JAX_COSTS(
            jnp.asarray(band), n=n, bit_depth=bd,
            halo_top=jnp.asarray(halo[0, b]))).reshape(-1, 35))
    costs, jax_costs = np.concatenate(costs), np.concatenate(jax_costs)
    np.testing.assert_array_equal(costs, jax_costs)
    best, mode = choose(costs)
    np.testing.assert_array_equal(mode, np.asarray(jnp.argmin(jax_costs, -1)))
    pc, pm = mesh.analysis_blocks_plain(T(frame), T(halo), band_h, n, bd)
    np.testing.assert_array_equal(best, pc.numpy().ravel())
    np.testing.assert_array_equal(mode, pm.numpy().ravel())
    if flat:
        assert (costs == 0).all() and (mode == 0).all()
