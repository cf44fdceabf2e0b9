"""Kernels C10's and C12's split arithmetic (the order the redesigned
kernels run in: a candidate per warp, C10's merge and refinement chains on
CTAs of their own with the tournament after them, C12's candidate sets'
geometry computed once per iteration, integer SSEs, the first-index argmin
by a shuffle butterfly) in plain torch (ops/inter_arms.py
``inter_arms_split``, ops/gt.py ``gt_search_split``), held bit for bit
against the plain bodies (``inter_arms_plain``, ``gt_search_plain``) and
the JAX reference compiled (``_merge_arms``, ``_frac_refine``,
``_gt_search``), ISS and PSS forms, at n = 8, 16 and 32, 8 and 10 bit, on
noise (10-bit 32x32 SSEs pass 2^24) and on flat planes (least costs tie).
Each is held against the reference where its SSEs stay below 2^24, and
past 2^24 against the plain bodies: there the GT search's order is not
copied (F9), and ``_merge_arms`` jitted alone sums in an order of its own
(ROADMAP.md queue 3, F13) where the port keeps ``block_sum``'s, the order
of the scan programs that the ISS and PSS scan tests hold."""
import functools

import jax
import numpy as np
import pytest
import torch

from hevc_hop_tpu.models import partition as jpartition
from hevc_hop_tpu.models import ss_scan as jss
from hevc_hop_torch.models import wavefront
from hevc_hop_torch.models.ss_scan import zmax_win_px
from hevc_hop_torch.ops import gt
from hevc_hop_torch.ops import inter_arms as ia
from hevc_hop_torch.ops import ss_search as ss

T = lambda a: torch.as_tensor(np.array(a))
LAM = jpartition.full_lambda(32)
W, H = 256, 128
BLOCKS = 6
CASES = [(n, bd, kind) for n in (8, 16, 32) for bd in (8, 10)
         for kind in ("noise", "flat")]

_MERGE = jax.jit(jss._merge_arms, static_argnums=(9, 10, 11, 12, 13, 14))
_REFINE = jax.jit(jss._frac_refine, static_argnums=(7, 8, 9, 10))
_GT_SEARCH = jax.jit(jss._gt_search, static_argnames=(
    "n", "lam", "h", "bit_depth", "iters"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module's worker: the suite runs parallel
    workers, and a thread pool each oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _case(n, bd, kind):
    """A W x H picture at bit depth bd: noise planes (recon, original and
    previous picture drawn independently) or flat ones (every candidate's
    prediction alike, C9's full-pel cost priced above them, half the
    blocks without their first three merge candidates: least costs tie);
    BLOCKS blocks of n x n with random carried motion, full-pel results
    and GT anchors. Returns a dict of numpy arrays and scalars."""
    rng = np.random.default_rng(1000 * n + 10 * bd + (kind == "flat"))
    maxv = (1 << bd) - 1
    flat = kind == "flat"

    def plane():
        p = np.zeros((H + 32, W), np.int32)
        p[:H] = maxv // 2 if flat else rng.integers(0, maxv + 1, (H, W))
        return p

    recon, org, ref = plane(), plane(), plane()
    zplane = wavefront.zaddr4_plane(W, H, 5)
    ys, xs = np.mgrid[H // 2:H - n + 1:n, W // 4:W - n + 1:2 * n]
    pos = np.stack([xs.ravel(), ys.ravel()], -1)[:BLOCKS].astype(np.int32)
    b = len(pos)
    shape4 = ((H + 32) // 4, W // 4)
    nbav = rng.random((b, 5)) < 0.7
    if flat:
        nbav[::2, :3] = False
    sse0 = (np.full(b, 1e6) if flat else rng.uniform(1e3, 1e8, b)).astype(
        np.float32)
    sse0[-1] = 3e38      # C9 found nothing: no refinement
    return dict(
        recon=recon, org=org, ref=ref, pos=pos,
        zcur=zplane[pos[:, 1] >> 2, pos[:, 0] >> 2].astype(np.int32),
        zmaxw=zmax_win_px(zplane, n),
        motion=(rng.integers(-200, 40, shape4).astype(np.int32),
                rng.integers(-200, 40, shape4).astype(np.int32),
                (rng.random(shape4) < 0.6).astype(np.int32),
                np.zeros(shape4, np.int32)),
        rf4_pss=rng.integers(0, 2, shape4).astype(np.int32),
        nbav=nbav, miav=rng.random((b, 3)) < 0.7,
        mv_i=rng.integers(-2 * n, n, (b, 2)).astype(np.int32),
        pred0=rng.integers(0, maxv + 1, (b, n, n)).astype(np.int32),
        sse0=sse0,
        ipred=rng.integers(0, maxv + 1, (b, n, n)).astype(np.int32),
        imode=rng.integers(0, 35, b).astype(np.int32),
        mv_t=rng.integers(-n, n, (b, 2)).astype(np.int32),
        tpred0=rng.integers(0, maxv + 1, (b, n, n)).astype(np.int32),
        tsse0=rng.uniform(1e3, 1e8, b).astype(np.float32),
        anchor=rng.integers(-2 * n, 1, (b, 2)).astype(np.int32))


def _motion(c, pss):
    """The carried motion planes: every reference index 0 on an ISS
    picture, 0 or 1 on a PSS one."""
    return tuple(T(m) for m in c["motion"][:3] + (
        c["rf4_pss"] if pss else c["motion"][3],))


def _arms_args(c, n, bd, pss=False):
    return (T(c["recon"]), T(c["org"]), T(c["pos"]), T(c["zcur"]),
            T(c["zmaxw"]), _motion(c, pss), T(c["nbav"]),
            T(c["miav"]), T(c["mv_i"]), T(c["pred0"]), T(c["sse0"]),
            T(c["ipred"]), T(c["imode"]), n, W, H, bd, LAM, 16)


def _pss(c):
    return (T(c["ref"]), T(c["mv_t"]), T(c["tpred0"]), T(c["tsse0"]))


def _assert_bits(got, want, what):
    assert len(got) == len(want), what
    for k, (g, w_) in enumerate(zip(got, want)):
        g = torch.as_tensor(np.array(g))
        w_ = torch.as_tensor(np.array(w_))
        if g.is_floating_point():
            g, w_ = g.view(torch.int32), w_.to(g.dtype).view(torch.int32)
        np.testing.assert_array_equal(g.numpy(), w_.numpy(),
                                      err_msg=f"{what}: output {k}")


@pytest.mark.parametrize("form", ["iss", "pss"])
@pytest.mark.parametrize("n,bd,kind", CASES)
def test_inter_arms_split_matches_plain(n, bd, kind, form):
    """The whole of C10's split order, the tournament after the chains,
    against the plain body: every output and the prediction written in
    place."""
    c = _case(n, bd, kind)
    extra = {} if form == "iss" else {"pss": _pss(c)}
    args = _arms_args(c, n, bd, form == "pss")
    got = ia.inter_arms_split(*args, **extra) + (args[11],)
    args = _arms_args(c, n, bd, form == "pss")
    want = ia.inter_arms_plain(*args, **extra) + (args[11],)
    _assert_bits(got, want, f"C10 {form}")


@pytest.mark.parametrize("n,bd,kind", CASES)
def test_chains_match_reference(n, bd, kind):
    """C10's merge chain (ISS: the recon; PSS: candidates naming the
    previous picture read it) and refinement chain (SS over the recon,
    temporal over the previous picture) against the jitted reference's
    _merge_arms and _frac_refine: costs, MVs, reference indices and
    predictions bit for bit; ties among the least costs on flat planes,
    SSEs past 2^24 in the 10-bit 32x32 noise."""
    c = _case(n, bd, kind)
    recon, org, pos = T(c["recon"]), T(c["org"]), T(c["pos"])
    blocks = ss.block_at(org, pos, n)
    of = blocks.numpy().astype(np.float32)
    stats = {"merge_ties": 0, "refine_ties": 0, "past_2_24": 0}
    for ss_idx, ref in ((0, None), (ss.SS_IDX_PSS, c["ref"])):
        cands, cref, cvalid, p_ss, p_t = ia.gather_cands(
            *_motion(c, ref is not None), pos, T(c["nbav"]), T(c["miav"]),
            n, 16, ss_idx)
        past = stats["past_2_24"]
        got = ia.merge_chain_split(
            recon, blocks, pos, T(c["zcur"]), T(c["zmaxw"]), cands, cref,
            cvalid, T(c["ipred"]), n, W, H, bd, LAM,
            None if ref is None else T(ref), ss_idx, stats)
        want = _MERGE(c["recon"], ref, of, c["pos"], c["zcur"], c["zmaxw"],
                      cands.numpy(), cref.numpy(), cvalid.numpy(), ss_idx,
                      n, W, H, bd, LAM)
        if stats["past_2_24"] == past:
            _assert_bits(got[:4], want, f"merge chain, reference index "
                         f"{ss_idx}")
        else:   # past 2^24: against the plain body (see the docstring)
            _assert_bits(got[:4], ia.merge_arms_plain(
                recon, blocks.to(torch.float32), pos, T(c["zcur"]),
                T(c["zmaxw"]), cands, cvalid, n, W, H, bd, LAM,
                None if ref is None else T(ref), cref, ss_idx),
                "merge chain past 2^24")
        np.testing.assert_array_equal(
            got[4].numpy(), ia.intra_cost(blocks, T(c["ipred"]), LAM).numpy())
        for plane, mv, pred0, sse0, preds in (
                (c["recon"], c["mv_i"], c["pred0"], c["sse0"], p_ss),
                (c["ref"], c["mv_t"], c["tpred0"], c["tsse0"], p_t)):
            past = stats["past_2_24"]
            got = ia.refine_chain_split(T(plane), blocks, pos, T(mv * 4),
                                        T(pred0), T(sse0), preds, n, H, bd,
                                        LAM, stats)
            want = (_REFINE(plane, of, c["pos"], mv * 4, pred0, sse0,
                            preds.numpy(), n, H, bd, LAM)
                    if stats["past_2_24"] == past else
                    ia.frac_refine_plain(T(plane), blocks.to(torch.float32),
                                         pos, T(mv * 4), T(pred0), T(sse0),
                                         preds, n, H, bd, LAM))
            _assert_bits(got, (want[0], want[1], want[3]),
                         "refinement chain")
    if kind == "flat":
        assert stats["merge_ties"] + stats["refine_ties"] > 0, stats
    if (n, bd, kind) == (32, 10, "noise"):
        assert stats["past_2_24"] > 0, stats


@pytest.mark.parametrize("n,bd,kind", CASES)
def test_gt_search_split_matches_plain_and_reference(n, bd, kind):
    """C12's search in its split order against gt_search_plain on every
    case, and against the jitted reference's _gt_search where no safe
    candidate's SSE passed 2^24 (F9); the 10-bit 32x32 noise passes it."""
    c = _case(n, bd, kind)
    recon, pos = T(c["recon"]), T(c["pos"])
    blocks = ss.block_at(T(c["org"]), pos, n)
    stats = {}
    got = gt.gt_search_split(recon, blocks, pos, T(c["anchor"]), n, LAM, H,
                             bd, stats=stats)
    want = gt.gt_search_plain(recon, blocks, pos, T(c["anchor"]), n, LAM, H,
                              bd)
    _assert_bits(got, want, "GT search against the plain body")
    if stats["past_2_24"] == 0:
        ref = _GT_SEARCH(c["recon"], blocks.numpy(), c["pos"], c["anchor"],
                         n=n, lam=LAM, h=H, bit_depth=bd)
        _assert_bits(got, ref, "GT search against the reference")
    if (n, bd, kind) == (32, 10, "noise"):
        assert stats["past_2_24"] > 0, stats


def test_lane_argmin_takes_the_first_index_among_equals():
    """The butterfly keeps the lower (cost, index) at every step: the
    first index among equal least costs wins wherever they sit, as
    argmin_first's (jnp.argmin's) rule does, and lanes past K never
    win."""
    rng = np.random.default_rng(3)
    cost = torch.as_tensor(rng.integers(0, 4, (4096, 13)).astype(
        np.float32))
    c, i = ia.lane_argmin(cost)
    np.testing.assert_array_equal(i.numpy(),
                                  ia.argmin_first(cost).numpy())
    np.testing.assert_array_equal(c.numpy(), cost.amin(-1).numpy())
    assert ((cost == c[:, None]).sum(-1) > 1).sum() > 1000


def test_warp_sse_takes_block_sums_order_past_2_24():
    """warp_sse: the integer total below 2^24; above it ss_search's
    block_sum (the reference's order), which the integer total misses on
    some blocks there."""
    rng = np.random.default_rng(4)
    org = torch.as_tensor(rng.integers(0, 1024, (256, 32, 32)))
    pred = torch.as_tensor(rng.integers(0, 1024, (256, 32, 32)))
    got, tot = ia.warp_sse(org, pred)
    d = (org - pred).to(torch.float32)
    assert bool((tot >= 2 ** 24).all())
    np.testing.assert_array_equal(got.numpy(), ss.block_sum(d * d).numpy())
    assert int((got != tot.to(torch.float32)).sum()) > 0
    small = pred.clamp(org - 3, org + 3)
    got, tot = ia.warp_sse(org, small)
    np.testing.assert_array_equal(got.numpy(), tot.to(torch.float32).numpy())
