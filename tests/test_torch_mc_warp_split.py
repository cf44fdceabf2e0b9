"""Kernels C8 and C11 as kernel C14 runs them, one pass over a CU's planes,
against the JAX reference, exact equality.

C8's body stages a window as int16, then each thread takes a column of a
run of rows and slides the first filter stage's rows down it, a phase-0
axis taken as a copy (``ops/interp.py`` ``mc_filter_walk``); C14's
decode runs a CU's luma, cb and cr in one pass on disjoint warps
(``mc_cu_walk``). C11's chroma form interpolates the window at the
anchor's phase with that body and warps it; C12's chroma check in C14
warps cb and cr in one pass and keeps the predictions, which the chroma
stage then takes for a GT CU (``ops/gt.py`` ``gt_chroma_pair_walk``);
C14's decode runs a GT CU's three planes in one pass (``gt_cu_walk``).
Every walk must give the reference's ``filter_2d``, ``luma_mc``,
``chroma_mc_q``, ``gt_pred_luma``, ``gt_pred_chroma`` and
``gt_chroma_safe`` exactly, with windows clamped at every edge of both
stacked chroma pictures, at every quarter- and eighth-pel phase, 8 and 10
bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_hop_tpu.models import ss_scan as jss
from hevc_hop_tpu.ops import interp as jinterp
from hevc_hop_torch.ops import gt, interp

T = lambda a: torch.as_tensor(np.asarray(a))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The walks run many small tensor ops; one thread keeps the suite's
    parallel workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jit(name, *static):
    """The reference function ``name`` jitted with its trailing static
    arguments ``static`` bound."""
    fns = {"filter_2d": jinterp.filter_2d, "luma_mc": jinterp.luma_mc,
           "chroma_mc_q": jinterp.chroma_mc_q,
           "gt_pred_luma": jss.gt_pred_luma,
           "gt_pred_chroma": jss.gt_pred_chroma,
           "gt_chroma_safe": jss.gt_chroma_safe}
    return jax.jit(lambda *a: fns[name](*a, *static))


# (chroma, n, threads): each thread count a body gives the filter: C8's
# entry (2 to 8 warps), C14's decode CU (luma 192, chroma 32), its read
# phase's chroma pair (128), C11's chroma window (2m = n, 64, 128, 256)
FILTER_CASES = [(False, 32, 192), (False, 16, 192), (False, 8, 192),
                (False, 4, 64), (False, 32, 256), (True, 16, 32),
                (True, 4, 32), (True, 2, 64), (True, 8, 128),
                (True, 32, 64), (True, 16, 256)]


@functools.lru_cache(maxsize=None)
def _filter_case(chroma, n, bd):
    """Windows [B, n+t-1, n+t-1] at every phase pair (one block each, the
    extreme and random windows in turn) and the reference's output."""
    rng = np.random.default_rng(n * 7 + bd + chroma)
    tab = interp.CHROMA_FILTER if chroma else interp.LUMA_FILTER
    p, t = tab.shape
    fx, fy = np.meshgrid(np.arange(p), np.arange(p), indexing="ij")
    fx, fy = fx.ravel(), fy.ravel()
    w = n + t - 1
    win = rng.integers(0, 1 << bd, (len(fx), w, w))
    win[::3] = (1 << bd) - 1
    win[1::3, :, ::2] = 0
    want = _jit("filter_2d", n, bd)(jnp.asarray(win, jnp.int32),
                                    jnp.asarray(tab[fx]),
                                    jnp.asarray(tab[fy]))
    return win, fx, fy, np.asarray(want)


@pytest.mark.parametrize("chroma,n,nthr", FILTER_CASES)
def test_mc_filter_walk_every_phase(chroma, n, nthr):
    for bd in (8, 10):
        win, fx, fy, want = _filter_case(chroma, n, bd)
        got, writes = interp.mc_filter_walk(T(win).to(torch.int16), T(fx),
                                            T(fy), n, chroma, bd, nthr)
        np.testing.assert_array_equal(got.numpy(), want)
        # every sample written by exactly one thread
        assert writes.eq(1).all()


def _stacked(rng, w, hc, pad, bd):
    """The stacked chroma plane: cb rows [0, hc), cr rows [hc_off, hc_off
    + hc), pad rows below each picture."""
    hc_off = hc + pad
    return rng.integers(0, 1 << bd, (2 * hc_off, w)).astype(np.int32), hc_off


def _edge_grid(n, w, h, step):
    """Block positions on a grid of step, its first and last rows and
    columns on the picture's edges."""
    xs = sorted(set(list(range(0, w - n + 1, step)) + [w - n]))
    ys = sorted(set(list(range(0, h - n + 1, step)) + [h - n]))
    return np.array([(x, y) for y in ys for x in xs], np.int32)


@functools.lru_cache(maxsize=None)
def _cu_case(n, bd):
    """Inter CUs of n x n luma on a grid over a picture, their residuals
    and the reference's predictions: MVs up to n + 12 samples past every
    edge of the luma picture and of both chroma pictures, every phase."""
    rng = np.random.default_rng(n + bd)
    m, w, h, pad = n // 2, 8 * n, 3 * n, 8
    y = rng.integers(0, 1 << bd, (h + pad, w)).astype(np.int32)
    c, hc_off = _stacked(rng, w // 2, h // 2, pad, bd)
    pos = _edge_grid(n, w, h, n)
    b = len(pos)
    mv = rng.integers(-4 * (n + 12), 4 * (n + 12), (b, 2)).astype(np.int32)
    mv[:8, 0] = np.arange(8) - 4
    mv[8:16, 1] = np.arange(8) - 4
    cb = pos // 2
    cr = cb + [0, hc_off]
    resi_y = rng.integers(-300, 300, y.shape).astype(np.int32)
    resi_c = rng.integers(-300, 300, c.shape).astype(np.int32)
    j = lambda a: jnp.asarray(a)
    py = _jit("luma_mc", n, h, bd)(j(y), j(pos), j(mv))
    pb = _jit("chroma_mc_q", m, h // 2, bd)(j(c[:hc_off]), j(cb), j(mv))
    pr = _jit("chroma_mc_q", m, h // 2, bd)(j(c[hc_off:]), j(cb), j(mv))
    want_y, want_c = y.copy(), c.copy()
    maxv = (1 << bd) - 1
    for k in range(b):
        (x0, y0), (bx, by), (rx, ry) = pos[k], cb[k], cr[k]
        want_y[y0:y0 + n, x0:x0 + n] = np.clip(
            np.asarray(py[k]) + resi_y[y0:y0 + n, x0:x0 + n], 0, maxv)
        want_c[by:by + m, bx:bx + m] = np.clip(
            np.asarray(pb[k]) + resi_c[by:by + m, bx:bx + m], 0, maxv)
        want_c[ry:ry + m, rx:rx + m] = np.clip(
            np.asarray(pr[k]) + resi_c[ry:ry + m, rx:rx + m], 0, maxv)
    return (y, c, resi_y, resi_c, pos, cb, cr, mv, h, hc_off, want_y,
            want_c)


@pytest.mark.parametrize("n", [8, 16, 32])
def test_mc_cu_walk_three_planes_in_one_pass(n):
    for bd in (8, 10):
        (y, c, resi_y, resi_c, pos, cb, cr, mv, h, hc_off, want_y,
         want_c) = _cu_case(n, bd)
        got_y, got_c = T(y).clone(), T(c).clone()
        writes = interp.mc_cu_walk(T(y), T(c), got_y, got_c, T(resi_y),
                                   T(resi_c), T(pos), T(cb), T(cr), T(mv), n,
                                   h, h // 2, hc_off, bd)
        np.testing.assert_array_equal(got_y.numpy(), want_y)
        np.testing.assert_array_equal(got_c.numpy(), want_c)
        assert all(wr.eq(1).all() for wr in writes)
        assert set((mv & 7).ravel().tolist()) == set(range(8))


def _corners(rng, b, m):
    """Coded corners [B, 3, 2]: a quarter zero, a quarter small integral
    moves that put samples on the knife edges, the rest up to +-2m."""
    gtc = rng.integers(-2 * m, 2 * m + 1, (b, 3, 2))
    gtc[: b // 4] = 0
    gtc[b // 4: b // 2] = rng.integers(-1, 2, (b // 2 - b // 4, 3, 2))
    return gtc.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _gt_chroma_case(m, bd):
    """m x m chroma blocks on a grid over the cb picture (cr hc_off rows
    below), full-pel anchors past every edge (odd and even: phases 0 and
    4), corners reaching the knife edges; the reference's predictions and
    safe flags per plane."""
    rng = np.random.default_rng(m * 3 + bd)
    wc, hc, pad = 8 * m, 6 * m, 4
    c, hc_off = _stacked(rng, wc, hc, pad, bd)
    cb = _edge_grid(m, wc, hc, m)
    b = len(cb)
    mv = rng.integers(-2 * m - 8, 2 * m + 9, (b, 2)).astype(np.int32)
    mv[:4] = [[0, 0], [1, 0], [0, 1], [1, 1]]
    gtc = _corners(rng, b, m)
    j = lambda a: jnp.asarray(a)
    out = {}
    for p, plane in (("cb", c[:hc_off]), ("cr", c[hc_off:])):
        out[p] = (np.asarray(_jit("gt_pred_chroma", m, hc, bd)(
            j(plane), j(cb), j(mv), j(gtc))),
            np.asarray(_jit("gt_chroma_safe", m, hc, bd)(
                j(plane), j(cb), j(mv), j(gtc))))
    return c, hc, hc_off, cb, mv, gtc, out


@pytest.mark.parametrize("m", [4, 8, 16])
def test_gt_chroma_warped_once_at_the_decision(m):
    unsafe = safe = 0
    for bd in (8, 10):
        c, hc, hc_off, cb, mv, gtc, want = _gt_chroma_case(m, bd)
        pb, pr, ok = gt.gt_chroma_pair_walk(T(c), T(cb), T(mv), T(gtc), m,
                                            hc, hc_off, bd)
        np.testing.assert_array_equal(pb.numpy(), want["cb"][0])
        np.testing.assert_array_equal(pr.numpy(), want["cr"][0])
        np.testing.assert_array_equal(ok.numpy(),
                                      want["cb"][1] & want["cr"][1])
        unsafe += int((~ok).sum())
        safe += int(ok.sum())
        assert set((mv & 1).ravel().tolist()) == {0, 1}
    assert unsafe > 0 and safe > 0


@functools.lru_cache(maxsize=None)
def _gt_cu_case(n, bd):
    """GT CUs of n x n luma on a grid, their residuals and the reference's
    recon: gt_pred_luma and gt_pred_chroma plus the residual, clipped."""
    rng = np.random.default_rng(n * 5 + bd)
    m, w, h, pad = n // 2, 4 * n, 3 * n, 8
    y = rng.integers(0, 1 << bd, (h + pad, w)).astype(np.int32)
    c, hc_off = _stacked(rng, w // 2, h // 2, pad, bd)
    pos = _edge_grid(n, w, h, n)
    b = len(pos)
    mv = rng.integers(-n - 4, n + 5, (b, 2)).astype(np.int32)
    gtc = _corners(rng, b, n)
    cb = pos // 2
    cr = cb + [0, hc_off]
    resi_y = rng.integers(-300, 300, y.shape).astype(np.int32)
    resi_c = rng.integers(-300, 300, c.shape).astype(np.int32)
    j = lambda a: jnp.asarray(a)
    py = np.asarray(_jit("gt_pred_luma", n, h, bd)(j(y), j(pos), j(mv),
                                                   j(gtc)))
    pb = np.asarray(_jit("gt_pred_chroma", m, h // 2, bd)(
        j(c[:hc_off]), j(cb), j(mv), j(gtc)))
    pr = np.asarray(_jit("gt_pred_chroma", m, h // 2, bd)(
        j(c[hc_off:]), j(cb), j(mv), j(gtc)))
    want_y, want_c = y.copy(), c.copy()
    maxv = (1 << bd) - 1
    for k in range(b):
        (x0, y0), (bx, by), (rx, ry) = pos[k], cb[k], cr[k]
        want_y[y0:y0 + n, x0:x0 + n] = np.clip(
            py[k] + resi_y[y0:y0 + n, x0:x0 + n], 0, maxv)
        want_c[by:by + m, bx:bx + m] = np.clip(
            pb[k] + resi_c[by:by + m, bx:bx + m], 0, maxv)
        want_c[ry:ry + m, rx:rx + m] = np.clip(
            pr[k] + resi_c[ry:ry + m, rx:rx + m], 0, maxv)
    return (y, c, resi_y, resi_c, pos, cb, cr, mv, gtc, h, hc_off, want_y,
            want_c)


@pytest.mark.parametrize("n", [8, 16, 32])
def test_gt_cu_walk_three_planes_in_one_pass(n):
    for bd in (8, 10):
        (y, c, resi_y, resi_c, pos, cb, cr, mv, gtc, h, hc_off, want_y,
         want_c) = _gt_cu_case(n, bd)
        got_y, got_c = T(y).clone(), T(c).clone()
        gt.gt_cu_walk(T(y), T(c), got_y, got_c, T(resi_y), T(resi_c),
                      T(pos), T(cb), T(cr), T(mv), T(gtc), n, h, h // 2,
                      hc_off, bd)
        np.testing.assert_array_equal(got_y.numpy(), want_y)
        np.testing.assert_array_equal(got_c.numpy(), want_c)


@pytest.mark.parametrize("bd", [8, 10])
def test_first_stage_fits_int16(bd):
    """The samples staged as int16 fit, and so does the plain first stage
    (the 14-bit intermediate) over the extreme windows at every phase:
    each tap on the largest sample where it is positive and 0 where it is
    negative, and the reverse."""
    maxv = (1 << bd) - 1
    assert maxv < 1 << 15
    headroom = interp.IF_INTERNAL_PREC - bd
    shift1 = interp.IF_FILTER_PREC - headroom
    off1 = -(interp.IF_INTERNAL_OFFS << shift1)
    for tab in (interp.LUMA_FILTER, interp.CHROMA_FILTER):
        for taps in tab.astype(np.int64):
            for s in ((taps > 0) * maxv, (taps < 0) * maxv,
                      np.full_like(taps, maxv), np.zeros_like(taps)):
                mid = (int((taps * s).sum()) + off1) >> shift1
                assert -(1 << 15) <= mid < 1 << 15
