"""hevc_hop_torch's GT prediction and corner search (kernel C12's plain
version, with C11's) and C9's GT anchor ring against the JAX reference as
its encoder runs it, compiled (``jax.jit``): corners, predictions and
float32 costs bit for bit; the chroma prediction and its safety mask; the
ring against ``_ss_search`` with ``zmax2n``; ``lax.top_k``'s tie rule; and
each float form the port copies, alone, against the jitted reference with
the other rounding shown to differ. The 32x32 search is held where its
SSEs stay below 2^24 (F9: above it the reference's order is not copied)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_hop_tpu.models import partition as jpartition
from hevc_hop_tpu.models import ss_scan as jss
from hevc_hop_tpu.ops import warp as jwarp
from hevc_hop_torch.models import wavefront
from hevc_hop_torch.ops import gt, quant
from hevc_hop_torch.ops import ss_search as ss
from test_e2e_iss import synth_warped_lenslet

T = lambda a: torch.as_tensor(np.array(a))
LAM = jpartition.full_lambda(32)
L32 = np.float32(LAM)

_GT_SEARCH = jax.jit(jss._gt_search, static_argnames=(
    "n", "lam", "h", "bit_depth", "iters"))
_GT_ARM = jax.jit(jss._gt_arm, static_argnames=(
    "n", "lam", "w", "h", "bit_depth"))
_SEARCH = jax.jit(jss._ss_search, static_argnames=("n", "radius", "w", "h"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module's worker: the suite runs parallel
    workers, and a thread pool each oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _warp_case(n, b, seed, noise=3.5, bd=8):
    """A smooth textured plane, b blocks each at the centre of its own 2n
    tile, and originals that are the tile warped by random corners plus
    noise: the search moves its corners, and its SSEs stay small."""
    rng = np.random.default_rng(seed)
    cols = 16
    h, w = 2 * n * (b // cols + 1), 2 * n * cols
    yy, xx = np.mgrid[0:h, 0:w]
    plane = (128 + 60 * np.sin(xx / 5.3) * np.cos(yy / 4.1)
             + 40 * np.sin((xx + 2 * yy) / 7.7)).astype(np.int32)
    plane = plane << (bd - 8)
    k = np.arange(b)
    pos = np.stack([(k % cols) * 2 * n + n // 2,
                    (k // cols) * 2 * n + n // 2], -1).astype(np.int32)
    mv = np.zeros((b, 2), np.int32)
    win = jss._gt_window(jnp.asarray(plane), pos, mv, n, h)
    corners = rng.integers(-2, 3, (b, 3, 2)).astype(np.int32)
    tgt, _ = jwarp.warp_blocks(win, jss._gt4(jnp.asarray(corners)), n, bd)
    org = np.clip(np.asarray(tgt) + rng.normal(0, noise, (b, n, n)), 0,
                  (1 << bd) - 1).astype(np.int32)
    return plane, org, pos, mv, h


@pytest.mark.parametrize("n", [8, 16, 32])
def test_gt_search_matches_reference(n):
    plane, org, pos, mv, h = _warp_case(n, 96, n)
    want = _GT_SEARCH(plane, org, pos, mv, n=n, lam=LAM, h=h, bit_depth=8)
    got = gt.gt_search_plain(T(plane), T(org), T(pos), T(mv), n, LAM, h, 8)
    for g, w_, nm in zip(got, want, ("gtc", "pred", "cost")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_), err_msg=nm)
    cost = np.asarray(want[2])
    assert (np.asarray(want[0]) != 0).any(axis=(1, 2)).mean() > 0.5
    assert cost.max() < 2 ** 24, "held below 2^24 only (F9)"


def test_gt_search_cost_is_one_fma():
    """The search cost is fma(bits, lambda, SSE): on 4096 8x8 blocks the
    reference's costs equal the fused form everywhere, and the separately
    rounded form differs on some."""
    plane, org, pos, mv, h = _warp_case(8, 4096, 1)
    gtc, pred, cost = (np.asarray(a) for a in _GT_SEARCH(
        plane, org, pos, mv, n=8, lam=LAM, h=h, bit_depth=8))
    sse = T(((org.astype(np.int64) - pred) ** 2).sum((1, 2)).astype(
        np.float32))
    bits = gt.gt_bits(T(gtc))
    fused = quant.fma(bits, float(L32), sse).numpy()
    sep = (sse + torch.tensor(L32) * bits).numpy()
    np.testing.assert_array_equal(fused, cost)
    assert int((sep != cost).sum()) > 0


def test_gt_bits_matches_reference():
    v = np.random.default_rng(0).integers(-80, 81, (512, 3, 2)).astype(
        np.int32)
    np.testing.assert_array_equal(gt.gt_bits(T(v)).numpy(),
                                  np.asarray(jax.jit(jss._gt_bits)(v)))


@pytest.mark.parametrize("bd", [8, 10])
def test_gt_predictions_match_reference(bd):
    """gt_pred_luma, gt_pred_chroma (the DCTIF window at phase 0 or 4, then
    the half-pel warp) and gt_chroma_safe, on anchors of both parities and
    windows clamped at the plane's edges."""
    rng = np.random.default_rng(bd)
    h, w, n, b = 64, 96, 16, 128
    plane = rng.integers(0, 1 << bd, (h, w)).astype(np.int32)
    cplane = rng.integers(0, 1 << bd, (h // 2, w // 2)).astype(np.int32)
    pos = np.stack([rng.integers(0, w - n + 1, b) // 8 * 8,
                    rng.integers(0, h - n + 1, b) // 8 * 8], -1).astype(
        np.int32)
    mv = rng.integers(-20, 21, (b, 2)).astype(np.int32)
    gtc = rng.integers(-n, n + 1, (b, 3, 2)).astype(np.int32)
    gtc[: b // 4] = rng.integers(-1, 2, (b // 4, 3, 2))
    want = jax.jit(jss.gt_pred_luma, static_argnums=(4, 5, 6))(
        plane, pos, mv, gtc, n, h, bd)
    np.testing.assert_array_equal(
        gt.gt_pred_luma(T(plane), T(pos), T(mv), T(gtc), n, h, bd).numpy(),
        np.asarray(want))
    cpos = pos // 2
    for ref, port in ((jss.gt_pred_chroma, gt.gt_pred_chroma),
                      (jss.gt_chroma_safe, gt.gt_chroma_safe)):
        want = jax.jit(ref, static_argnums=(4, 5, 6))(
            cplane, cpos, mv, gtc, n // 2, h // 2, bd)
        np.testing.assert_array_equal(
            port(T(cplane), T(cpos), T(mv), T(gtc), n // 2, h // 2,
                 bd).numpy(), np.asarray(want))
    safe = np.asarray(want)
    assert safe.any() and not safe.all()


def _ring_case(n, seed):
    """Warped lenslet content as recon, a noisy original, every block (the
    first rows have no causal GT window) and AMVP predictors near the
    micro-image period."""
    rng = np.random.default_rng(seed)
    w = h = 128
    y, _, _ = synth_warped_lenslet(w, h, 16, seed=seed)
    recon = np.zeros((h + 32, w), np.int32)
    recon[:h] = y
    org = recon.copy()
    org[:h] = np.clip(y + rng.normal(0, 3, y.shape), 0, 255).astype(np.int32)
    zplane = wavefront.zaddr4_plane(w, h, 5)
    ys = np.arange(0, h - n + 1, n)
    xs = np.arange(0, w - n + 1, n)
    pos = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2).astype(np.int32)
    zcur = zplane[pos[:, 1] >> 2, pos[:, 0] >> 2].astype(np.int32)
    preds = rng.integers(-70, 20, (len(pos), 6, 2)).astype(np.int32)
    preds[:, 5] = 0
    preds[::3, :2] = jss._HUGE_PRED
    return (recon, org, pos, zcur, jss.zmax_win_px(zplane, n),
            jss.zmax_win_px(zplane, 2 * n, ifm=2), preds, w, h)


@pytest.mark.parametrize("n", [8, 16])
def test_anchor_ring_matches_reference(n):
    """C9's ring (the least cost whose 2n window is causal) and
    ss_anchor_ok against _ss_search with zmax2n and the reference's
    ss_anchor_ok."""
    recon, org, pos, zcur, zmaxw, zmax2n, preds, w, h = _ring_case(n, n)
    radius = 32
    blocks = np.asarray(ss.block_at(T(org), T(pos), n))
    rate = jss._dyn_rate_map(jnp.asarray(preds), radius, LAM)
    want = _SEARCH(recon, blocks, pos, zcur, zmaxw, rate, n=n,
                   radius=radius, w=w, h=h, zmax2n=zmax2n)
    got = ss.ss_search_plain(T(recon), T(org), T(pos), T(zcur), T(zmaxw),
                             T(preds), n, radius, w, h, LAM, T(zmax2n))
    for g, w_, nm in zip(got[:4], want[:4], ("mv", "cost", "pred", "sse")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_), err_msg=nm)
    anchors, gt_rate, gt_ok = (np.asarray(a)[:, 0] for a in want[4:])
    np.testing.assert_array_equal(got[4].numpy(), anchors)
    np.testing.assert_array_equal(got[5].numpy(), gt_rate)
    np.testing.assert_array_equal(got[6].numpy(), gt_ok)
    assert gt_ok.any() and not gt_ok.all()
    disp = np.random.default_rng(1).integers(-40, 10, (len(pos), 2)).astype(
        np.int32)
    np.testing.assert_array_equal(
        ss.ss_anchor_ok(T(pos), T(zcur), T(zmax2n), T(disp), n, w,
                        h).numpy(),
        np.asarray(jss.ss_anchor_ok(pos, zcur, zmax2n, disp, n, w, h)))


def test_top_k_takes_the_lower_index_on_a_tie():
    """lax.top_k with k = 1 on -cost (the ring's choice) takes the lower
    index among equal costs, as jnp.argmin and the port's argmin_first do:
    rows of few distinct values, so that nearly every row has a tie at its
    least."""
    x = np.random.default_rng(0).integers(0, 4, (2048, 37)).astype(
        np.float32)
    x[:, -1] = 3e38
    _, idx = jax.jit(lambda a: jax.lax.top_k(-a, 1))(x)
    np.testing.assert_array_equal(np.asarray(idx)[:, 0],
                                  quant.argmin_first(T(x)).numpy())
    np.testing.assert_array_equal(np.asarray(idx)[:, 0],
                                  np.asarray(jnp.argmin(x, axis=1)))
    assert ((x == x.min(1, keepdims=True)).sum(1) > 1).mean() > 0.9


def _arm_case(n, b, seed):
    """_warp_case's blocks with both anchors causal: zcur above every z
    address, a zero zmax2n, a ring anchor near the block and an AMVP
    predictor anchor around which the original was warped."""
    rng = np.random.default_rng(seed)
    plane, org, pos, _, h = _warp_case(n, b, seed)
    pad = 3 * n
    big = np.zeros((h + 2 * pad, plane.shape[1] + 2 * pad), np.int32)
    big[pad:pad + h, pad:pad + plane.shape[1]] = plane
    hh, ww = big.shape
    pos = pos + pad
    p_ss = np.full((b, 6, 2), jss._HUGE_PRED, np.int32)
    p_ss[:, 0] = rng.integers(-10, 11, (b, 2))
    p_ss[:, 5] = 0
    p_ss[b // 8: b // 4, 0] = jss._HUGE_PRED   # no valid predictor
    anchor = rng.integers(-3, 4, (b, 1, 2)).astype(np.int32)
    prd = (p_ss[:, 0] + 2) >> 2
    anchor[b // 4: b // 2, 0] = prd[b // 4: b // 2]   # duplicates
    bits = rng.integers(8, 30, (b, 1)).astype(np.float32)
    gt_rate = (L32 * (np.float32(6) + bits)).astype(np.float32)
    gt_ok = rng.random((b, 1)) < 0.8
    gt_ok[b // 8: b // 8 + 4] = False              # no anchor at all
    zmax2n = np.zeros((hh - 2 * n + 1, ww - 2 * n + 1), np.int32)
    zcur = np.full(b, 1 << 30, np.int32)
    return big, org, pos, zcur, zmax2n, anchor, gt_rate, gt_ok, p_ss, ww, hh


@pytest.mark.parametrize("n", [8, 16])
def test_gt_arm_matches_reference(n):
    """_gt_arm's total costs bit for bit, and where an anchor was causal
    its corners, prediction and anchor."""
    (plane, org, pos, zcur, zmax2n, anchor, gt_rate, gt_ok, p_ss, w,
     h) = _arm_case(n, 128, n + 1)
    want = [np.asarray(a) for a in _GT_ARM(
        plane, org, pos, zcur, zmax2n, anchor, gt_rate, gt_ok, p_ss, n=n,
        lam=LAM, w=w, h=h, bit_depth=8)]
    got = [a.numpy() for a in gt.gt_arm_plain(
        T(plane), T(org), T(pos), T(zcur), T(zmax2n), T(anchor[:, 0]),
        T(gt_rate[:, 0]), T(gt_ok[:, 0]), T(p_ss), n, LAM, w, h, 8)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[4], want[4])
    ok = want[4]
    assert ok.mean() > 0.5 and not ok.all()
    for g, w_, nm in zip(got[1:4], want[1:4], ("gtc", "gpred", "amv")):
        np.testing.assert_array_equal(g[ok], w_[ok], err_msg=nm)
    chose_p = ok & ~np.all(want[3] == anchor[:, 0], -1)
    assert chose_p.any() and (ok & ~chose_p).any()


def test_gt_arm_float_forms():
    """The anchors' totals, each alone against the jitted _gt_arm: the ring
    anchor's (cost + rate) + lambda, two rounded adds (the other grouping,
    cost + (rate + lambda), differs on some); the predictor anchor's
    fma(6 + bits, lambda, cost) + lambda (its rate rounded on its own
    differs on some)."""
    n = 8
    (plane, org, pos, zcur, zmax2n, anchor, gt_rate, gt_ok, p_ss, w,
     h) = _arm_case(n, 4096, 3)
    gt_ok[:] = True
    gcost, gtc, gpred, amv, _ = (np.asarray(a) for a in _GT_ARM(
        plane, org, pos, zcur, zmax2n, anchor, gt_rate, gt_ok, p_ss, n=n,
        lam=LAM, w=w, h=h, bit_depth=8))
    sse = T(((org.astype(np.int64) - gpred) ** 2).sum((1, 2)).astype(
        np.float32))
    cost = quant.fma(gt.gt_bits(T(gtc)), float(L32), sse)
    lam = torch.tensor(L32)
    ring = np.all(amv == anchor[:, 0], -1)
    r = T(gt_rate[:, 0])
    two = ((cost + r) + lam).numpy()
    other = (cost + (r + lam)).numpy()
    np.testing.assert_array_equal(two[ring], gcost[ring])
    assert int((other[ring] != gcost[ring]).sum()) > 0
    bits = ss.min_rate_bits(T(amv * 4)[:, None], T(p_ss))[:, 0]
    fused = (quant.fma(bits + 6.0, float(L32), cost) + lam).numpy()
    sep = ((cost + lam * (bits + 6.0)) + lam).numpy()
    p = ~ring
    assert p.sum() > 1000
    np.testing.assert_array_equal(fused[p], gcost[p])
    assert int((sep[p] != gcost[p]).sum()) > 0
