"""hevc_hop_torch's self-similarity search (kernel C9's plain version), its
merge arms, sub-pel refinement and tournament (kernel C10's) and the ISS
pre-pass against the JAX reference as its encoder runs it: compiled
(``jax.jit``), whose float32 arithmetic the port copies (ROADMAP.md queue
3, F8). Integers and float32 costs bit for bit; each copied float form
alone against the jitted reference expression, with the other rounding
shown to differ; the pre-pass's costs, whose level-rate log2 is F1's,
within 1e-6 relative and its decision exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_hop_tpu.models import partition as jpartition
from hevc_hop_tpu.models import ss_partition as jss_partition
from hevc_hop_tpu.models import ss_scan as jss
from hevc_hop_torch.models import ss_partition, ss_scan, wavefront
from hevc_hop_torch.ops import inter_arms as ia
from hevc_hop_torch.ops import quant
from hevc_hop_torch.ops import ss_search as ss
from test_e2e_iss import synth_lenslet

T = lambda a: torch.as_tensor(np.asarray(a))
LAM = jpartition.full_lambda(32)

_SEARCH_JIT = jax.jit(jss._ss_search, static_argnames=(
    "n", "radius", "w", "h"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain bodies run many small tensor ops; with the suite's
    parallel workers, a thread pool per worker oversubscribes the cores,
    so this module's worker takes one thread while it runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _search_case(n, radius, seed, w=128, h=128, noise=3.0):
    """A lenslet plane as both original and recon (plus noise on the
    original, so SSEs are small but not zero; a quarter of the blocks
    inverted, so their SSEs pass 2^24 at 32x32), blocks from the second
    CTU row on (so that the causal area is large), and AMVP predictors near
    the micro-image period."""
    rng = np.random.default_rng(seed)
    y, _, _ = synth_lenslet(w, h, 13, seed=seed)
    recon = np.zeros((h + 32, w), np.int32)
    recon[:h] = y
    org = recon.copy()
    org[:h] = np.clip(y + rng.normal(0, noise, y.shape), 0, 255).astype(
        np.int32)
    zplane = wavefront.zaddr4_plane(w, h, 5)
    ys = np.arange(64 if n == 32 else 48, h - n + 1, n)
    xs = np.arange(64 if n == 32 else 40 // n * n, w - n + 1, n)
    pos = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2).astype(np.int32)
    for x, y_ in pos[::4]:
        org[y_:y_ + n, x:x + n] = 255 - org[y_:y_ + n, x:x + n] // 4
    zcur = zplane[pos[:, 1] >> 2, pos[:, 0] >> 2].astype(np.int32)
    zmaxw = jss.zmax_win_px(zplane, n)
    preds = rng.integers(-60, 60, (len(pos), 6, 2)).astype(np.int32)
    preds[:, 5] = 0
    preds[::3, :2] = jss._HUGE_PRED
    return recon, org, pos, zcur, zmaxw, preds, w, h


def test_mvd_bits_sweep_matches_reference():
    """Every |v| from 0 to 2^20 (the sentinel 2^19 included), both signs:
    the reference's float32 floor(log2) is one low at |v| = 2^14 and 2^16
    (|v| / 2 = 2^13, 2^15), where the exact one is not (R5's quirk)."""
    v = np.arange(0, (1 << 20) + 2, dtype=np.int32)
    ref = jax.jit(jss._mvd_bits)
    for s in (v, -v):
        np.testing.assert_array_equal(ss.mvd_bits(T(s)).numpy(),
                                      np.asarray(ref(s)))
    exact = np.where(v == 0, 1.0, np.where(v == 1, 3.0, 5.0 + 2.0 * (
        np.floor(np.log2(np.maximum(v, 2).astype(np.float64) / 2)))))
    differ = np.nonzero(np.asarray(ref(v)) != exact)[0]
    assert differ.tolist() == [16384, 65536]


@pytest.mark.parametrize("radius", [4, 16])
def test_rate_map_matches_reference(radius):
    rng = np.random.default_rng(radius)
    preds = rng.integers(-300, 300, (7, 6, 2)).astype(np.int32)
    preds[0, :3] = jss._HUGE_PRED
    # with lambda 1 the reference's map is 6 + the least bits, exactly
    want = np.asarray(jax.jit(jss._dyn_rate_map, static_argnums=(1, 2))(
        preds, radius, 1.0)) - 6.0
    np.testing.assert_array_equal(ss.rate_bits_map(T(preds), radius).numpy(),
                                  want)


def _ref_sse_map(win, org, n, parts=False):
    """The reference's float32 SSE map, as _ss_search computes it (with
    ``parts``: its correlation and ref^2 sums too)."""
    def f(win, org):
        wf = win.astype(jnp.float32)
        of = org.astype(jnp.float32)

        def corr1(wv, kv):
            return jax.lax.conv_general_dilated(
                wv[None, None], kv[None, None], (1, 1), "VALID",
                preferred_element_type=jnp.float32)[0, 0]

        corr = jax.vmap(corr1)(wf, of)
        ones = jnp.ones((n, n), jnp.float32)
        ref2 = jax.lax.conv_general_dilated(
            (wf * wf)[:, None], ones[None, None], (1, 1), "VALID",
            preferred_element_type=jnp.float32)[:, 0]
        org2 = jnp.sum(of * of, axis=(1, 2))[:, None, None]
        return org2 + ref2 - 2.0 * corr, corr, ref2
    out = [np.asarray(a) for a in jax.jit(f)(win, org)]
    return out if parts else out[0]


def _port_sse_map(win, org, n):
    wf, of = T(win).float(), T(org).float()
    d = win.shape[-1] - n + 1
    corr = ss.conv_sum(wf, of, n, d)
    ref2 = ss.conv_sum(wf * wf, torch.ones_like(of), n, d)
    org2 = ss.block_sum(of * of)[:, None, None]
    return ((org2 + ref2) - 2.0 * corr).numpy()


@pytest.mark.parametrize("n", [8, 16])
def test_sse_map_exact_and_equal_to_reference(n):
    """n <= 16 at 8 bit: the convolution sums stay below 2^24, so the
    reference's correlation and ref^2 are exact in any order; its float32
    org^2 + ref^2 - 2 corr rounds where org^2 + ref^2 passes 2^24, and the
    port's map equals it everywhere."""
    rng = np.random.default_rng(n)
    d = 65
    win = rng.integers(150, 256, (3, n + d - 1, n + d - 1)).astype(np.int32)
    org = rng.integers(150, 256, (3, n, n)).astype(np.int32)
    want, corr, ref2 = _ref_sse_map(win, org, n, parts=True)
    got = _port_sse_map(win, org, n)
    np.testing.assert_array_equal(got, want)
    sw = np.lib.stride_tricks.sliding_window_view(
        win.astype(np.int64), (n, n), axis=(1, 2))
    np.testing.assert_array_equal(
        corr, (sw * org[:, None, None].astype(np.int64)).sum((-1, -2)))
    np.testing.assert_array_equal(ref2, (sw * sw).sum((-1, -2)))


@pytest.mark.parametrize("lo,differ", [(0, 0), (200, 2)],
                         ids=["0-255", "200-255"])
def test_sse_map_32_against_reference(lo, differ):
    """n = 32: the reference's sums exceed 2^24, so its float32 map is not
    the exact SSE; the port copies XLA:CPU's order of the sums (F8). The
    copy gives every entry on 8-bit samples over the whole range; on
    samples of 200-255 (sums near 5e7) it misses 2 of 16 900 entries, where
    one convolution sum is one float32 step (4) off and the SSE, which
    takes 2 corr, 8: the count is F8's, measured here."""
    rng = np.random.default_rng(6)
    n, d, b = 32, 65, 4
    win = rng.integers(lo, 256, (b, n + d - 1, n + d - 1)).astype(np.int32)
    org = rng.integers(lo, 256, (b, n, n)).astype(np.int32)
    want = _ref_sse_map(win, org, n)
    got = _port_sse_map(win, org, n)
    assert int((got != want).sum()) == differ
    assert np.abs(got - want).max() <= 2 * np.spacing(np.float32(2 ** 26))
    sw = np.lib.stride_tricks.sliding_window_view(win, (n, n), axis=(1, 2))
    exact = ((sw.astype(np.int64) - org[:, None, None].astype(np.int64))
             ** 2).sum((-1, -2))
    assert int((want != exact).sum()) > 0


@pytest.mark.parametrize("n,radius", [(8, 16), (16, 24), (16, 32),
                                      (32, 40)])
def test_ss_search_matches_reference(n, radius):
    recon, org, pos, zcur, zmaxw, preds, w, h = _search_case(n, radius, n)
    ar = np.arange(n)
    blocks = org[pos[:, 1, None, None] + ar[None, :, None],
                 pos[:, 0, None, None] + ar[None, None, :]]
    rate = jss._dyn_rate_map(jnp.asarray(preds), radius, LAM)
    want = _SEARCH_JIT(recon, blocks, pos, zcur, zmaxw, rate, n=n,
                       radius=radius, w=w, h=h)[:4]
    got = ss.ss_search_plain(T(recon), T(org), T(pos), T(zcur), T(zmaxw),
                             T(preds), n, radius, w, h, LAM)
    for g, r_, nm in zip(got, want, ("mv", "cost", "pred", "sse")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r_), err_msg=nm)
    assert np.any(np.asarray(want[1]) < 1e37)


def _forms():
    """(name, reference expression, port form, the other rounding)."""
    l32 = np.float32(LAM)
    fma = lambda a, b, c: quant.fma(T(a), float(b), T(c)).numpy()
    sep = lambda a, b, c: (np.float32(a) * np.float32(b) + np.float32(c)
                           ).astype(np.float32)
    return [
        # the refinement: sse + lam * (6 + _min_rate_bits), one fusion
        ("refine-rate",
         lambda sse, bits: sse + LAM * (jss.INTER_BITS + bits),
         lambda sse, bits: fma(bits + 6.0, l32, sse),
         lambda sse, bits: sep(bits + 6.0, l32, sse)),
        # the merge arms: sse + lam * (4 + index bits), index bits static
        ("merge-rate",
         lambda sse, k: sse + LAM * (4.0 + jnp.minimum(
             jnp.arange(9) + 1, 4).astype(jnp.float32))[None],
         lambda sse, k: sse + np.array(
             [np.float32(l32 * np.float32(4.0 + min(i + 1, 4)))
              for i in range(9)], np.float32)[None],
         lambda sse, k: fma(np.broadcast_to(np.minimum(np.arange(9) + 1, 4)
                                            + 4.0, sse.shape), l32, sse)),
        # the pre-pass: dist + lam * level bits + the search's rate
        ("prepass-rate",
         lambda sse, bits: sse + LAM * bits + bits * 0.75,
         lambda sse, bits: fma(bits, l32, sse) + bits * np.float32(0.75),
         lambda sse, bits: sep(bits, l32, sse) + bits * np.float32(0.75)),
    ]


@pytest.mark.parametrize("form", [f[0] for f in _forms()])
def test_float_forms_match_compiled_reference(form):
    """Each float form the port copies, alone, bit for bit against the
    jitted reference expression; the other rounding differs on the same
    inputs, so the test can tell them apart."""
    name, ref, port, other = next(f for f in _forms() if f[0] == form)
    rng = np.random.default_rng(len(form))
    sse = rng.integers(0, 40000, (4096, 9)).astype(np.float32)
    bits = rng.integers(2, 60, (4096, 9)).astype(np.float32)
    want = np.asarray(jax.jit(ref)(sse, bits))
    np.testing.assert_array_equal(port(sse, bits), want)
    assert int((other(sse, bits) != want).sum()) > 0


def test_search_rate_form_matches_compiled_reference():
    """Inside the compiled search, _dyn_rate_map's lam * (6 + bits) is
    rounded in a fusion of its own and then added to the SSE map: the
    reference's least costs are sse + round(rate) at their MVs, and the
    fused multiply-add the refinement's cost has gives other costs."""
    n, radius = 16, 32
    recon, org, pos, zcur, zmaxw, preds, w, h = _search_case(n, radius, 3)
    ar = np.arange(n)
    blocks = org[pos[:, 1, None, None] + ar[None, :, None],
                 pos[:, 0, None, None] + ar[None, None, :]]
    rate = jss._dyn_rate_map(jnp.asarray(preds), radius, LAM)
    mv, cost, _, sse = (np.asarray(a) for a in _SEARCH_JIT(
        recon, blocks, pos, zcur, zmaxw, rate, n=n, radius=radius, w=w,
        h=h)[:4])
    ok = cost < 1e37
    bits = ss.min_rate_bits(T(mv[:, None] * 4), T(preds))[:, 0]
    sep = (T(sse) + ss.search_rate(LAM, bits)).numpy()
    fused = quant.fma(bits + 6.0, np.float32(LAM), T(sse)).numpy()
    np.testing.assert_array_equal(sep[ok], cost[ok])
    assert int((fused[ok] != cost[ok]).sum()) > 0


def _planes_case(seed, n):
    recon, org, pos, zcur, zmaxw, preds, w, h = _search_case(n, 16, seed)
    rng = np.random.default_rng(seed + 1)
    shape4 = (recon.shape[0] // 4, w // 4)
    inter = rng.random(shape4) < 0.6
    mvx4 = np.where(inter, rng.integers(-80, 20, shape4), 0).astype(np.int32)
    mvy4 = np.where(inter, rng.integers(-80, 20, shape4), 0).astype(np.int32)
    pi4 = inter.astype(np.int32)
    rf4 = np.zeros(shape4, np.int32)
    nbav = rng.random((len(pos), 5)) < 0.8
    miav = rng.random((len(pos), 3)) < 0.7
    return (recon, org, pos, zcur, zmaxw, (mvx4, mvy4, pi4, rf4), nbav,
            miav, w, h)


@pytest.mark.parametrize("n", [8, 16, 32])
def test_merge_and_refine_match_reference(n):
    """_gather_cands, _merge_arms and _frac_refine (jitted) against the
    port's plain versions on random carried motion: candidates, costs,
    MVs and predictions bit for bit."""
    (recon, org, pos, zcur, zmaxw, motion, nbav, miav, w, h) = \
        _planes_case(n, n)
    radius = {8: 16, 16: 24, 32: 40}[n]
    mi = 13
    ar = np.arange(n)
    blocks = org[pos[:, 1, None, None] + ar[None, :, None],
                 pos[:, 0, None, None] + ar[None, None, :]]
    of = blocks.astype(np.float32)
    want_c = jax.jit(jss._gather_cands, static_argnums=(7, 8, 9))(
        *motion, pos, nbav, miav, n, mi, 0)
    got_c = ia.gather_cands(*(T(m) for m in motion), T(pos), T(nbav),
                            T(miav), n, mi)
    for g, r_ in zip(got_c, (want_c[0], want_c[1], want_c[2], want_c[3])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r_))
    cands, _, cvalid, p_ss = (np.asarray(a) for a in want_c[:4])
    merge = jax.jit(jss._merge_arms, static_argnums=(9, 10, 11, 12, 13, 14))(
        recon, None, of, pos, zcur, zmaxw, cands, np.asarray(want_c[1]),
        cvalid, 0, n, w, h, 8, LAM)
    got_m = ia.merge_arms_plain(T(recon), T(of), T(pos), T(zcur), T(zmaxw),
                                T(cands), T(cvalid), n, w, h, 8, LAM)
    for g, r_ in zip(got_m, (merge[0], merge[1], merge[3])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r_))
    assert np.any(np.asarray(merge[0]) < 1e37)
    rate = jss._dyn_rate_map(jnp.asarray(p_ss), radius, LAM)
    mv_i, _, pred0, sse0 = _SEARCH_JIT(recon, blocks, pos, zcur, zmaxw,
                                       rate, n=n, radius=radius, w=w, h=h)[:4]
    assert np.any(np.asarray(sse0) < 1e37)
    refine = jax.jit(jss._frac_refine, static_argnums=(7, 8, 9, 10))(
        recon, of, pos, np.asarray(mv_i) * 4, pred0, sse0, p_ss, n, h, 8,
        LAM)
    got_r = ia.frac_refine_plain(T(recon), T(of), T(pos),
                                 T(np.asarray(mv_i) * 4), T(pred0), T(sse0),
                                 T(p_ss), n, h, 8, LAM)
    for g, r_ in zip(got_r, refine):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r_))


@pytest.mark.parametrize("n,radius", [(8, 32), (16, 32), (32, 32),
                                      (32, 40)])
def test_ss_rd_costs_match_reference(n, radius):
    """The pre-pass's SS arm: the search, the dead-zone round trip, dist +
    lam * level bits + the search's rate. The level rate's log2 is
    torch's against the reference's jnp.log2 (F1), so costs agree within
    1e-6 relative; the causal-less blocks' 3e38 exactly. At radius 32 no
    32x32 displacement is causal (its window with the filter margin spans
    40 samples), so every 32x32 cost is 3e38."""
    w, h, mi = 128, 96, 13
    y, _, _ = synth_lenslet(w, h, mi, seed=n)
    zplane4 = wavefront.zaddr4_plane(w, h, 5)
    ys = (np.arange(h // n) * n)[:, None].repeat(w // n, 1).ravel()
    xs = (np.arange(w // n) * n)[None, :].repeat(h // n, 0).ravel()
    pos = np.stack([xs, ys], -1).astype(np.int32)
    zcur = zplane4[ys >> 2, xs >> 2].astype(np.int32)
    zmaxw = jss.zmax_win_px(zplane4, n)
    want = np.asarray(jss_partition._ss_rd_size(
        jnp.asarray(y), jnp.asarray(y), pos, zcur, zmaxw, n, 32, 8, radius,
        radius, w, h, mi, False))
    got = ss_partition.ss_rd_costs(T(y.astype(np.int32)), T(pos), T(zcur),
                                   T(zmaxw), n, 32, 8, radius, w, h, mi,
                                   LAM).numpy()
    big = want > 1e37
    assert big.any() and big.all() == (n == 32 and radius == 32)
    np.testing.assert_array_equal(got[big], want[big])
    np.testing.assert_allclose(got[~big], want[~big], rtol=1e-6)


def test_ss_partition_decide_matches_reference():
    w, h, mi = 128, 96, 13
    y, _, _ = synth_lenslet(w, h, mi, seed=7)
    want_d, want_m = jss_partition.decide(y, 32, 5, 32, mi)
    got_d, got_m = ss_partition.decide(T(y.astype(np.int32)), 32, 5, 32, mi)
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_m, want_m)
    assert len(set(got_d.ravel().tolist())) > 1


def test_build_schedule_ss_matches_reference():
    w, h = 128, 96
    leaves = [(x, y_, 4) for y_ in range(0, h, 16) for x in range(0, w, 16)]
    want = jss.build_schedule_ss(leaves, w, h, 5, 32)
    got = ss_scan.build_schedule_ss(leaves, w, h, 5, 32)
    assert got[0] == want[0] and got[2] == want[2]
    for lg in want[0]:
        for k, v in want[1][lg].items():
            np.testing.assert_array_equal(got[1][lg][k], v, err_msg=k)
    zplane = wavefront.zaddr4_plane(w, h, 5)
    for n, ifm in ((8, 4), (32, 4), (32, 2)):
        np.testing.assert_array_equal(ss_scan.zmax_win_px(zplane, n, ifm),
                                      jss.zmax_win_px(zplane, n, ifm))
