"""Kernel C9's scan-entry arithmetic as the card runs it, emulated on the CPU
(hevc_hop_torch/ops/ss_search.py ``search_split_plain``): corr and ref^2
as integer sums (ref^2 by box sums of the squared window), an entry whose
sums stay below 2^24 taking them as float32 and another the reference's
ordered float sums (F8, or F10 with ``seq``), and the (2r+1)^2
displacements split into P contiguous parts, one per CTA of a cluster,
merged in part order. Held against the plain search
(``ss_search_plain``, ``t_search_plain``) and, in F8's order, against the
JAX reference's ``_ss_search`` and ``_t_search`` jitted as its encoder
runs them: MVs, costs, predictions, SSEs and the anchor ring bit for bit.
Each case asserts that it reaches the region it names."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_hop_tpu.models import partition as jpartition
from hevc_hop_tpu.models import ss_scan as jss
from hevc_hop_torch.models import wavefront
from hevc_hop_torch.ops import ss_search as ss
from test_e2e_iss import synth_warped_lenslet

T = lambda a: torch.as_tensor(np.asarray(a))
LAM = jpartition.full_lambda(32)
PARTS = (1, 2, 4, 8)
# radii that leave causal displacements above and left of each block
RADIUS = {8: 12, 16: 20, 32: 36}
W = H = 128

_SS = jax.jit(jss._ss_search, static_argnames=("n", "radius", "w", "h"))
_T = jax.jit(jss._t_search, static_argnames=("n", "radius", "w", "h"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain bodies run many small tensor ops; with the suite's
    parallel workers, a thread pool per worker oversubscribes the cores,
    so this module's worker takes one thread while it runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _planes(y, seed, bd, noise=3):
    """(recon [H + 32, W], original) from the picture y: the original is y
    plus uniform noise in [-noise, noise], clipped to the bit depth."""
    rng = np.random.default_rng(seed)
    recon = np.zeros((H + 32, W), np.int32)
    recon[:H] = y
    org = recon.copy()
    org[:H] = np.clip(y + rng.integers(-noise, noise + 1, y.shape), 0,
                      (1 << bd) - 1)
    return recon, org


def _causality(pos, n):
    zplane = wavefront.zaddr4_plane(W, H, 5)
    zcur = zplane[pos[:, 1] >> 2, pos[:, 0] >> 2].astype(np.int32)
    return (zcur, jss.zmax_win_px(zplane, n),
            jss.zmax_win_px(zplane, 2 * n, ifm=2))


def _preds(seed, b):
    preds = np.random.default_rng(seed).integers(-40, 40, (b, 6, 2)).astype(
        np.int32)
    preds[:, 5] = 0
    preds[::2, :2] = jss._HUGE_PRED
    return preds


@functools.lru_cache(maxsize=None)
def _case(n, bd):
    """Random samples on a grid of 8 levels, three blocks from the middle
    of the picture (whose causal area reaches the search window's first
    rows only: the last parts hold no causal displacement) and AMVP
    predictors."""
    rng = np.random.default_rng(n + bd)
    y = (rng.integers(0, 1 << bd, (H, W)) // 8 * 8).astype(np.int32)
    recon, org = _planes(y, n, bd)
    pos = np.array([[64, 64], [64 + n, 64 + n], [96 - n, 96]], np.int32)
    return recon, org, pos, *_causality(pos, n), _preds(n, len(pos))


def _jax_ss(recon, org, pos, zcur, zmaxw, preds, n, radius, zmax2n=None):
    blocks = np.asarray(ss.block_at(T(org), T(pos), n))
    rate = jss._dyn_rate_map(jnp.asarray(preds), radius, LAM)
    out = _SS(recon, blocks, pos, zcur, zmaxw, rate, n=n, radius=radius, w=W,
              h=H, zmax2n=zmax2n)
    return [np.asarray(a) for a in out]


@functools.lru_cache(maxsize=None)
def _reference(n, bd, temporal):
    recon, org, pos, zcur, zmaxw, _, preds = _case(n, bd)
    radius = RADIUS[n]
    if not temporal:
        return _jax_ss(recon, org, pos, zcur, zmaxw, preds, n, radius)[:4]
    blocks = np.asarray(ss.block_at(T(org), T(pos), n))
    rate = jss._dyn_rate_map(jnp.asarray(preds[:, 3:]), radius, LAM)
    return [np.asarray(a) for a in _T(recon, blocks, pos, rate, n=n,
                                      radius=radius, w=W, h=H)]


def _same(got, want, names=("mv", "cost", "pred", "sse", "anchor",
                            "gt_rate", "gt_ok")):
    for g, w, nm in zip(got, want, names):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=nm)


def _ss_split(case, n, radius, parts, seq=False, zmax2n=None):
    recon, org, pos, zcur, zmaxw, preds = case
    return ss.ss_search_split(T(recon), T(org), T(pos), T(zcur), T(zmaxw),
                              T(preds), n, radius, W, H, LAM,
                              None if zmax2n is None else T(zmax2n), seq,
                              parts)


def _ss_plain(case, n, radius, seq=False, zmax2n=None):
    recon, org, pos, zcur, zmaxw, preds = case
    return ss.ss_search_plain(T(recon), T(org), T(pos), T(zcur), T(zmaxw),
                              T(preds), n, radius, W, H, LAM,
                              None if zmax2n is None else T(zmax2n), seq)


def _same_as_reference(got, want, n, bd):
    """got against the jitted reference, bit for bit. Over a 32x32 block of
    full-range 10-bit samples the reference's org^2 passes 2^24 and takes
    the order XLA:CPU compiles for its reduction (F11, ROADMAP.md queue 3:
    ops/ss_search.py lane_block_sum), which the port copies."""
    _same(got, want)


def _expect_sum_regions(regions, n, bd):
    """An 8-bit block of 16x16 or less never reaches 2^24 (256 * 255^2 <
    2^24); these 32x32 and 10-bit blocks do."""
    assert regions["exact"] + regions["ordered"] > 0
    if bd == 8 and n <= 16:
        assert regions["ordered"] == 0
    else:
        assert regions["ordered"] > 0


@pytest.mark.parametrize("seq", [False, True], ids=["f8", "f10"])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("n", [8, 16, 32])
@pytest.mark.parametrize("parts", PARTS)
def test_ss_split_matches_plain_and_reference(parts, n, bd, seq):
    recon, org, pos, zcur, zmaxw, _, preds = _case(n, bd)
    case = (recon, org, pos, zcur, zmaxw, preds)
    radius = RADIUS[n]
    got, regions = _ss_split(case, n, radius, parts, seq)
    _same(got, _ss_plain(case, n, radius, seq))
    if not seq:
        _same_as_reference(got, _reference(n, bd, False), n, bd)
    _expect_sum_regions(regions, n, bd)
    # the causal displacements sit in the window's first rows, so a split
    # leaves parts with none
    assert (regions["empty_parts"] > 0) == (parts > 1)


@pytest.mark.parametrize("seq", [False, True], ids=["f8", "f10"])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("n", [8, 16, 32])
@pytest.mark.parametrize("parts", PARTS)
def test_t_split_matches_plain_and_reference(parts, n, bd, seq):
    """The temporal search: every displacement in the picture valid, the
    temporal predictors (here the last three)."""
    recon, org, pos, _, _, _, preds = _case(n, bd)
    radius = RADIUS[n]
    args = (T(recon), T(org), T(pos), T(preds[:, 3:]), n, radius, W, H, LAM)
    got, regions = ss.t_search_split(*args, seq=seq, parts=parts)
    _same(got, ss.t_search_plain(*args, seq=seq))
    if not seq:
        _same_as_reference(got, _reference(n, bd, True), n, bd)
    _expect_sum_regions(regions, n, bd)
    assert regions["none_valid"] == 0


@pytest.mark.parametrize("parts", PARTS)
def test_forced_ties_take_the_first_index(parts):
    """Flat content: every causal displacement has the same SSE, so costs
    tie wherever the rates do; the least index among equals wins, across
    parts as within one."""
    n, radius = 8, RADIUS[8]
    recon, org = _planes(np.full((H, W), 128, np.int32), 0, 8, noise=0)
    pos = np.array([[64, 64], [72, 72], [80, 64]], np.int32)
    zcur, zmaxw, _ = _causality(pos, n)
    preds = np.zeros((len(pos), 6, 2), np.int32)
    case = (recon, org, pos, zcur, zmaxw, preds)
    got, regions = _ss_split(case, n, radius, parts)
    assert regions["tied"] == len(pos)
    _same(got, _ss_plain(case, n, radius))
    _same(got, _jax_ss(recon, org, pos, zcur, zmaxw, preds, n, radius)[:4])


@pytest.mark.parametrize("parts", PARTS)
def test_nothing_causal_takes_index_zero(parts):
    """The picture's first block: no displacement is causal, so the MV is
    index 0's (-r, -r) and the cost and SSE 3e38, as argmin of all-3e38
    gives them."""
    n, radius = 8, RADIUS[8]
    recon, org, _, _, _, _, _ = _case(n, 8)
    pos = np.array([[0, 0], [8, 0]], np.int32)
    zcur, zmaxw, _ = _causality(pos, n)
    preds = _preds(1, len(pos))
    case = (recon, org, pos, zcur, zmaxw, preds)
    got, regions = _ss_split(case, n, radius, parts)
    assert regions["none_valid"] == len(pos)
    assert (got[0].numpy() == -radius).all()
    assert (got[3].numpy() == np.float32(ss.BIG)).all()
    _same(got, _ss_plain(case, n, radius))
    _same(got, _jax_ss(recon, org, pos, zcur, zmaxw, preds, n, radius)[:4])


def _ring_case(n):
    y, _, _ = synth_warped_lenslet(W, H, 16, seed=n)
    recon, org = _planes(y, n, 8)
    ys = np.arange(2 * n, H - n + 1, 2 * n)
    xs = np.arange(0, W - n + 1, 3 * n)
    pos = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2).astype(np.int32)
    zcur, zmaxw, zmax2n = _causality(pos, n)
    preds = np.random.default_rng(n).integers(-70, 20, (len(pos), 6, 2))
    preds[:, 5] = 0
    preds[::3, :2] = jss._HUGE_PRED
    return (recon, org, pos, zcur, zmaxw, preds.astype(np.int32)), zmax2n


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("parts", PARTS)
def test_anchor_ring_merges_like_top_k(parts, n):
    """The GT anchor ring (the least cost whose 2n window is causal) merged
    over the parts: equal to the plain ring and to _ss_search with zmax2n,
    found for some blocks and not for others."""
    radius = 32
    case, zmax2n = _ring_case(n)
    got, regions = _ss_split(case, n, radius, parts, zmax2n=zmax2n)
    assert 0 < regions["ring"] < len(case[2])
    _same(got, _ss_plain(case, n, radius, zmax2n=zmax2n))
    want = _jax_ss(*case, n, radius, zmax2n=zmax2n)
    _same(got, want[:4] + [a[:, 0] for a in want[4:]])


def test_all_255_16x16_stays_exact():
    """The 8-bit limit: 256 * 255^2 = 16 646 400 < 2^24, so an all-255
    16x16 block against an all-255 window sums exactly in any order."""
    n, radius = 16, RADIUS[16]
    recon, org = _planes(np.full((H, W), 255, np.int32), 0, 8, noise=0)
    pos = np.array([[64, 64], [80, 80]], np.int32)
    zcur, zmaxw, _ = _causality(pos, n)
    preds = _preds(2, len(pos))
    case = (recon, org, pos, zcur, zmaxw, preds)
    corr, ref2 = ss.int_sums(ss._search_window(T(recon), T(pos), n, radius,
                                               H),
                             ss.block_at(T(org), T(pos), n), n,
                             2 * radius + 1)
    assert int(corr.max()) == int(ref2.max()) == 16646400 < ss.EXACT
    for parts in PARTS:
        got, regions = _ss_split(case, n, radius, parts)
        assert regions["ordered"] == 0 and regions["exact"] > 0
        _same(got, _ss_plain(case, n, radius))
    _same(got, _jax_ss(recon, org, pos, zcur, zmaxw, preds, n, radius)[:4])


@pytest.mark.parametrize("n,bd,grey", [(32, 8, 128), (8, 10, 512)],
                         ids=["32x32-8bit", "8x8-10bit"])
def test_mid_grey_passes_2_24(n, bd, grey):
    """Mid-grey content sums to about 2^24 (1024 * 128^2 and 64 * 512^2 are
    2^24 exactly): with noise, some entries stay exact and others take the
    ordered form, in both orders."""
    radius = RADIUS[n]
    recon, org = _planes(np.full((H, W), grey, np.int32), n, bd, noise=2)
    recon[:H] += np.random.default_rng(bd).integers(-2, 3, (H, W)).astype(
        np.int32)
    pos = np.array([[64, 64], [96 - n, 96]], np.int32)
    zcur, zmaxw, _ = _causality(pos, n)
    preds = _preds(3, len(pos))
    case = (recon, org, pos, zcur, zmaxw, preds)
    for seq in (False, True):
        got, regions = _ss_split(case, n, radius, 8, seq)
        assert regions["ordered"] > 0 and regions["exact"] > 0
        _same(got, _ss_plain(case, n, radius, seq))
    got, _ = _ss_split(case, n, radius, 8)
    _same(got, _jax_ss(recon, org, pos, zcur, zmaxw, preds, n, radius)[:4])
