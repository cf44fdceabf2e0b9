"""Kernel C12's decision in the form the redesigned kernel runs, and
kernel C10's plain motion write, against the JAX reference, exact
equality.

C12's decision (``csrc/gt_search.cuh`` ``gt_pick``, ``gt_chroma_check``,
``gt_decide_put``) loads a block's words a lane each and takes them by
shuffles on every warp: the cheaper anchor (the first among equals), the
candidate test in registers, and the chroma check on the candidates
alone; kernel C14 leaves a GT CU's prediction in its anchor's slot
(``ops/gt.py`` ``gt_decide_walk``). C10's motion write
(``ops/inter_arms.py`` ``motion_write_plain``, which its kernel's cells
are held against on the card) runs on random blocks of planes of even and
odd widths, and on the recorded levels. The decisions' inputs are the
port's own, recorded level by level while the port codes a 128x96
picture on the CPU: a warped lenslet plane at 16x16 where GT wins on some
CUs, and a lenslet plane where it wins on none. Each walk must give the reference's ``gt_chroma_safe``, its GT
flag, inter, MV and prediction rule (``models/ss_scan.py:796-823``, the
PSS form's temporal cost and reference index ``:965-1003``) and its
motion planes (``:829-837``, PSS ``rf4`` ``:1013``) exactly.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_hop_tpu.models import ss_scan as jss
from hevc_hop_torch.models.ss_encoder import HoloConfig, HoloEncoder
from hevc_hop_torch.ops import gt, inter_arms as ia
from hevc_hop_torch.ops.ss_search import SS_IDX_PSS
from test_e2e_iss import synth_lenslet, synth_warped_lenslet

W, H = 128, 96
# name -> (content, seed, GT CUs expected: some or none)
CASES = {"gt-some": ("warped", 6, True), "gt-none": ("lenslet", 7, False)}
# the reference's SS reference index on a PSS picture (ss_scan.py:908)
SS_REF = 1


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain bodies run many small tensor ops; one thread keeps the
    suite's parallel workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _levels(name):
    """Every GT decision of the port's encode of the case's picture on the
    CPU: the decision's inputs as C12's decide entry takes them (the
    search entry's per-anchor outputs from gt_anchors_plain), cloned
    before the decision, and the plain body's outputs."""
    content, seed, _ = CASES[name]
    frame = (synth_warped_lenslet(W, H, 16, seed=seed) if content == "warped"
             else synth_lenslet(W, H, 16, seed=seed))
    cfg = HoloConfig(width=W, height=H, qp=37, cu_log2=4, search_range=32,
                     gt=True, sao=False)
    levels, anchors = [], []
    step, search = gt.gt_step_plain, gt.gt_anchors_plain

    def rec_search(*a, **k):
        anchors.append(search(*a, **k))
        return anchors[-1]

    def rec_step(*a):
        (recon, org, rc, pos, zcur, z2, motion, nbav, miav, ring, costs,
         pred, inter, mv, smode, n, w, h, hc_off, bd, lam, mi, refsel) = a
        before = [t.clone() for t in (rc, pos, costs, pred, inter, mv,
                                      smode)]
        out = step(*a)
        levels.append(dict(zip(("rc", "pos", "costs", "pred", "inter", "mv",
                                "smode"), before),
                           anchors=anchors[-1], n=n, h=h, hc_off=hc_off,
                           bd=bd, out=tuple(t.clone() for t in out + (
                               pred, inter, mv, smode))))
        return out

    gt.gt_step_plain, gt.gt_anchors_plain = rec_step, rec_search
    try:
        HoloEncoder(cfg, device="cpu").encode_frame(*frame)
    finally:
        gt.gt_step_plain, gt.gt_anchors_plain = step, search
    return levels


def _pad(t, b):
    """t [B, ...] padded to b rows by repeating its last row."""
    return torch.cat([t, t[-1:].expand(b - t.shape[0], *t.shape[1:])])


@functools.lru_cache(maxsize=None)
def _rule(n, h, bd, pss):
    """The reference's GT decision, jitted: _gt_arm's pick over the
    per-anchor totals (ss_scan.py:668-675), then ss_scan.py:796-823 (PSS:
    :965-1003) with C10's choice (inter, mv, pred, refsel) in place of its
    arms. Returns (gtflag, gtc [B, 6], inter, mv, pred, refsel, the
    candidate test, csafe)."""
    m = n // 2

    def f(gcost_a, ok_a, amv_a, gtc_a, gpred_a, costs, rcb, rcr, pos, inter,
          mv, pred, refsel):
        gcost_a = jnp.where(ok_a, gcost_a, jnp.float32(3e38))
        ai = jnp.argmin(gcost_a, 1)
        gcost = jnp.take_along_axis(gcost_a, ai[:, None], 1)[:, 0]
        amv = jnp.take_along_axis(amv_a, ai[:, None, None], 1)[:, 0]
        gtc = jnp.take_along_axis(gtc_a, ai[:, None, None, None], 1)[:, 0]
        gpred = jnp.take_along_axis(gpred_a, ai[:, None, None, None], 1)[:, 0]
        gok = jnp.any(ok_a, 1)
        nonzero = jnp.any(gtc != 0, axis=(1, 2))
        cpos_g = pos // 2
        cpos_g = cpos_g.at[:, 1].set(
            jnp.where(pos[:, 1] >= h, h // 2, cpos_g[:, 1]))
        csafe = (jss.gt_chroma_safe(rcb, cpos_g, amv, gtc, m, h // 2, bd)
                 & jss.gt_chroma_safe(rcr, cpos_g, amv, gtc, m, h // 2, bd))
        icost, mcost, sscost = costs[:, 0], costs[:, 1], costs[:, 2]
        cand = gok & nonzero & (gcost < sscost) & (gcost < icost) & (
            gcost < mcost)
        if pss:
            cand = cand & (gcost < costs[:, 3])
        gtflag = cand & csafe
        inter = gtflag | (inter != 0)
        mv = jnp.where(gtflag[:, None], amv * 4, mv)
        pred = jnp.where(gtflag[:, None, None], gpred, pred)
        refsel = jnp.where(gtflag, SS_REF, refsel)
        return (gtflag, gtc.reshape(-1, 6), inter, mv, pred, refsel, cand,
                csafe)

    return jax.jit(f)


def _pss_costs(lv, seed):
    """C10's PSS costs for a recorded ISS level: its intra, merge and SS
    costs and a temporal cost equal to, below or far above the GT cost."""
    costs = lv["costs"]
    s_cost = lv["anchors"][2]
    g = s_cost.min(1).values
    k = torch.as_tensor(np.random.default_rng(seed).integers(
        0, 3, costs.shape[0]))
    tcost = torch.where(k == 0, g, torch.where(k == 1, g * 0.5,
                                               torch.full_like(g, 3e38)))
    return torch.cat([costs, tcost[:, None]], 1)


def _decide(lv, pss, ties):
    """The walk and the reference on one recorded level (PSS: a temporal
    cost column and reference indices added; ties: the anchors' costs and
    C10's costs set equal on some blocks)."""
    s_gtc, s_pred, s_cost, s_amv, s_ok = (t.clone() for t in lv["anchors"])
    costs = _pss_costs(lv, len(s_cost)) if pss else lv["costs"].clone()
    b = s_cost.shape[0]
    if ties:
        k = torch.arange(b)
        s_cost[k % 2 == 0, 1] = s_cost[k % 2 == 0, 0]
        g = s_cost.min(1).values
        costs[k % 3 == 1, 2] = g[k % 3 == 1]
        costs[k % 3 == 2, 0] = g[k % 3 == 2]
    n, h, hc_off, bd = lv["n"], lv["h"], lv["hc_off"], lv["bd"]
    refsel = (torch.as_tensor(np.random.default_rng(b).integers(0, 2, b),
                              dtype=torch.int32) if pss else None)
    state = [lv[k].clone() for k in ("pred", "inter", "mv", "smode")]
    r2 = None if refsel is None else refsel.clone()
    flag, gtc, cand, ai = gt.gt_decide_walk(
        lv["rc"], lv["pos"], s_gtc, s_pred, s_cost, s_amv, s_ok, costs,
        *state, n, h, hc_off, bd, r2)
    # the same walk in C14's form: the prediction left in its slot
    slot = [lv[k].clone() for k in ("pred", "inter", "mv", "smode")]
    flag_s, _, _, ai_s = gt.gt_decide_walk(
        lv["rc"], lv["pos"], s_gtc, s_pred, s_cost, s_amv, s_ok, costs,
        *slot, n, h, hc_off, bd,
        None if refsel is None else refsel.clone(), slot=True)
    pad = 4 * -(-b // 4)
    rc = lv["rc"]
    want = _rule(n, h, bd, pss)(
        *(jnp.asarray(_pad(t, pad).numpy()) for t in (
            s_cost, s_ok != 0, s_amv, s_gtc.reshape(b, 2, 3, 2), s_pred,
            costs)),
        jnp.asarray(rc[:h // 2].numpy()),
        jnp.asarray(rc[hc_off:hc_off + h // 2].numpy()),
        *(jnp.asarray(_pad(t, pad).numpy()) for t in (
            lv["pos"], lv["inter"], lv["mv"], lv["pred"],
            refsel if pss else torch.zeros(b, dtype=torch.int32))))
    want = [np.asarray(x)[:b] for x in want]
    got = dict(flag=flag.numpy() != 0, gtc=gtc.numpy(),
               inter=state[1].numpy() != 0, mv=state[2].numpy(),
               pred=state[0].numpy())
    for (k, v), w in zip(got.items(), want[:5]):
        np.testing.assert_array_equal(v, w, err_msg=k)
    if pss:
        np.testing.assert_array_equal(r2.numpy(), want[5])
    # the chroma check ran on the candidates alone, with the reference's
    # csafe there
    np.testing.assert_array_equal(cand.numpy(), want[6])
    np.testing.assert_array_equal(flag.numpy() != 0, want[6] & want[7])
    # C14's form: the same decision, the prediction untouched, the slot of
    # the chosen anchor holding the reference's prediction
    np.testing.assert_array_equal(flag_s.numpy(), flag.numpy())
    np.testing.assert_array_equal(slot[0].numpy(), lv["pred"].numpy())
    ar = torch.arange(b)
    sel = want[0]
    np.testing.assert_array_equal(s_pred[ar, ai_s].numpy()[sel],
                                  want[4][sel])
    return flag, cand


@pytest.mark.parametrize("name", sorted(CASES))
def test_decide_walk_matches_reference_and_plain_body(name):
    levels = _levels(name)
    assert levels
    flags = cands = 0
    for lv in levels:
        flag, cand = _decide(lv, pss=False, ties=False)
        # the port's plain body (gt_step_plain) decided the same
        out = lv["out"]
        np.testing.assert_array_equal(flag.numpy(), out[0].numpy())
        flags += int(flag.sum())
        cands += int(cand.sum())
    assert (flags > 0) == CASES[name][2], (name, flags)
    assert cands >= flags


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("form", ["iss-ties", "pss", "pss-ties"])
def test_decide_walk_forms_match_reference(name, form):
    for lv in _levels(name):
        _decide(lv, pss=form.startswith("pss"), ties=form.endswith("ties"))


@functools.lru_cache(maxsize=None)
def _jax_motion(n, pss):
    """The reference's motion planes' update (ss_scan.py:829-837; PSS with
    rf4, :1013), jitted."""
    def f(mvx4, mvy4, pi4, rf4, pos, inter, mv, refsel):
        r4, c4 = jss._block_idx(pos // 4, n // 4)
        u = (n // 4, n // 4)
        bcast = lambda v: jnp.broadcast_to(v[:, None, None],
                                           (v.shape[0],) + u)
        mvx4 = mvx4.at[r4, c4].set(bcast(jnp.where(inter, mv[:, 0], 0)))
        mvy4 = mvy4.at[r4, c4].set(bcast(jnp.where(inter, mv[:, 1], 0)))
        pi4 = pi4.at[r4, c4].set(bcast(inter.astype(jnp.int32)))
        if pss:
            rf4 = rf4.at[r4, c4].set(bcast(jnp.where(inter, refsel, 0)))
        return mvx4, mvy4, pi4, rf4

    return jax.jit(f)


@pytest.mark.parametrize("pss", [False, True])
@pytest.mark.parametrize("wp,off", [(32, 0), (33, 0), (34, 0), (32, 1),
                                    (36, 2)])
def test_motion_write_plain_matches_reference(wp, off, pss):
    """Blocks of 8x8, 16x16 and 32x32 at distinct random cells of planes
    wp cells wide (views at a storage offset of off words): C10's plain
    motion write, which its kernel's cells are held against on the card,
    gives the reference's planes."""
    rng = np.random.default_rng(wp * 8 + off + pss)
    hp, nb = 24, 6
    for n in (8, 16, 32):
        u = n // 4
        gx, gy = (wp - u) // u + 1, (hp - u) // u + 1
        slot = rng.choice(gx * gy, nb, replace=False)
        pos = torch.as_tensor(np.stack([slot % gx * n, slot // gx * n], -1),
                              dtype=torch.int32)
        inter = torch.as_tensor(rng.integers(0, 2, nb), dtype=torch.int32)
        mv = torch.as_tensor(rng.integers(-300, 300, (nb, 2)),
                             dtype=torch.int32)
        refsel = torch.as_tensor(rng.integers(0, 2, nb), dtype=torch.int32)
        start = rng.integers(-9, 9, (4, hp, wp)).astype(np.int32)
        planes = []
        for p in start:
            flat = torch.full((hp * wp + off,), 5, dtype=torch.int32)
            flat[off:] = torch.as_tensor(p).reshape(-1)
            planes.append(flat[off:].view(hp, wp))
        ia.motion_write_plain(*planes[:3], pos, inter, mv, n, planes[3],
                              refsel if pss else None)
        want = _jax_motion(n, pss)(*(jnp.asarray(p) for p in start),
                                   jnp.asarray(pos.numpy()),
                                   jnp.asarray(inter.numpy() != 0),
                                   jnp.asarray(mv.numpy()),
                                   jnp.asarray(refsel.numpy()))
        for g, w in zip(planes, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_motion_write_plain_on_recorded_levels():
    """The motion of every recorded level of the GT case, written level by
    level into the picture's planes with the PSS reference index, equals
    the reference's."""
    levels = _levels("gt-some")
    hp, wp = H // 4, W // 4
    planes = [torch.zeros((hp, wp), dtype=torch.int32) for _ in range(4)]
    want = [jnp.zeros((hp, wp), jnp.int32) for _ in range(4)]
    inters = 0
    for lv in levels:
        flag, _, pred, inter, mv, smode = lv["out"]
        refsel = torch.full_like(inter, SS_IDX_PSS)
        ia.motion_write_plain(*planes[:3], lv["pos"], inter, mv, lv["n"],
                              planes[3], refsel)
        inters += int((inter != 0).sum())
        want = _jax_motion(lv["n"], True)(
            *want, jnp.asarray(lv["pos"].numpy()),
            jnp.asarray(inter.numpy() != 0), jnp.asarray(mv.numpy()),
            jnp.asarray(refsel.numpy()))
    assert inters > 0
    for g, w in zip(planes, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
