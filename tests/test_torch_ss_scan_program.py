"""Kernel C14, the lenslet ISS wavefront of a picture as one launch, on the
CPU.

C14 (hevc_hop_torch/csrc/ss_scan.cu) runs only on the card. What it does
is held here in three parts: its work list (models/ss_scan.py
ss_work_list) holds each (level, CU size) group of the level loop once,
in the reference's order; a plain emulation that walks the work list
phase by phase, as C14's CTAs do (encode: every CU's read phase, C2, C9,
C10, C12 and the chroma prediction from its own decision, then every CU's
write phase, C3 and the motion write; decode: every CU's prediction plus
residual), in the kernel's order and again reversed within each phase,
gives bit for bit what the level loop and the JAX reference's
``scan_encode_iss`` and ``scan_decode_ss`` give: recon planes, level
planes and every per-CU output; and no CU of a decode group reads a sample
that another CU of its group writes, which lets C14 decode a group in one
phase. The cases: the quadtree with the GT off; the GT on where it
engages (16x16 CUs, QP 37, warped lenslet content); uniform 16x16 CUs with
the in-loop RMD, RDOQ and SBH off; 10 bit with the GT on; uniform 8x8 CUs.
RDOQ and SBH are on in the others.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_hop_tpu.models import ss_scan as jss
from hevc_hop_tpu.models.ss_encoder import HoloConfig as JaxConfig
from hevc_hop_tpu.models.ss_encoder import HoloEncoder as JaxEncoder
from hevc_hop_torch.common import rom
from hevc_hop_torch.models import ss_scan, wavefront
from hevc_hop_torch.models.decoder import Decoder
from hevc_hop_torch.models.partition import full_lambda
from hevc_hop_torch.models.ss_encoder import HoloConfig, HoloEncoder
from hevc_hop_torch.ops.gt import gt_pred_blocks_plain, gt_step_plain
from hevc_hop_torch.ops.inter_arms import inter_arms_plain, motion_write_plain
from hevc_hop_torch.ops.interp import mc_blocks_plain
from hevc_hop_torch.ops.intra import intra_blocks_plain
from hevc_hop_torch.ops.ss_search import ss_search_motion_plain
from hevc_hop_torch.ops.tq import tq_encode_plain
from test_e2e_iss import synth_lenslet, synth_warped_lenslet

# name -> (width, height, HoloConfig fields, content, seed)
CASES = {
    "quadtree": (128, 96, dict(quadtree=True, qp=32, mi_size=13,
                               search_range=32, gt=False), "lenslet", 7),
    "gt-cu16-qp37": (64, 64, dict(cu_log2=4, qp=37, mi_size=16,
                                  search_range=32, gt=True), "warped", 6),
    "rmd-cu16": (64, 64, dict(cu_log2=4, qp=30, mi_size=13, search_range=24,
                              gt=False, rdoq=False, sbh=False),
                 "lenslet", 9),
    "main10-gt": (64, 64, dict(cu_log2=4, qp=37, mi_size=16,
                               search_range=32, gt=True, bit_depth=10),
                  "warped", 6),
    "rmd-cu8": (64, 64, dict(cu_log2=3, qp=27, mi_size=8, search_range=24,
                             gt=False), "lenslet", 91),
}
OUT_NAMES = ("inter", "mv", "imode", "cbf_y", "cbf_cb", "cbf_cr", "gtflag",
             "gtc")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain bodies run many small tensor ops; with the suite's
    parallel workers, a thread pool per worker oversubscribes the cores,
    so this module's worker takes one thread while it runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frame(name):
    w, h, kw, content, seed = CASES[name]
    if content == "warped":
        y, cb, cr = synth_warped_lenslet(w, h, 16, seed=seed)
    else:
        y, cb, cr = synth_lenslet(w, h, kw["mi_size"], seed=seed)
    if kw.get("bit_depth") == 10:
        y, cb, cr = (p * 4 for p in (y, cb, cr))
    return y, cb, cr


@functools.lru_cache(maxsize=None)
def _case(name):
    """The scan's inputs as HoloEncoder hands them over on the CPU, and the
    decoder's inputs to scan_decode_ss for the encoder's stream."""
    w, h, kw, _, _ = CASES[name]
    cfg = HoloConfig(width=w, height=h, **kw)
    frame = _frame(name)
    enc = HoloEncoder(cfg, device="cpu")
    org_y, org_c = enc._upload(*frame)
    (plans, nsteps, zmaxw, zmax2n, work), mode4 = enc._frame_prep(org_y[:h])
    modes = None if mode4 is None else enc._xs_with_modes(plans, mode4)
    leaves = (None if mode4 is None else wavefront.leaves_from_depth(
        enc._depth8, w, h, cfg.ctb_log2))
    args = (org_y, org_c, plans, nsteps, zmaxw, cfg.qp,
            rom.chroma_qp_from_luma(cfg.qp), cfg.bit_depth,
            cfg.strong_intra_smoothing, w, h, cfg.search_range)
    tail = (cfg.mi_size, cfg.rdoq, cfg.sbh, modes, zmax2n)
    # the decoder's own call of scan_decode_ss on the encoder's stream
    stream = enc.encode_frame(*frame)
    seen = {}
    orig = ss_scan.scan_decode_ss

    def record(*a, **k):
        seen["args"], seen["kw"] = a, k
        return orig(*a, **k)

    ss_scan.scan_decode_ss = record
    try:
        dec = Decoder(device="cpu")
        dec.decode_stream(stream)
    finally:
        ss_scan.scan_decode_ss = orig
    assert dec.hash_ok == [True]
    return dict(cfg=cfg, frame=frame, args=args, tail=tail, work=work,
                mode4=mode4, leaves=leaves, dargs=seen["args"],
                dwork=seen["kw"]["work"], hc_off=org_c.shape[0] // 2)


@functools.lru_cache(maxsize=None)
def _loop(name):
    c = _case(name)
    enc = ss_scan.scan_encode_iss_loop(*c["args"], *c["tail"])
    dec = ss_scan.scan_decode_ss_loop(*c["dargs"])
    return enc, dec


def _emulate_encode(c, reverse):
    """C14's encode entry, group by group: the read phase's items, then
    the write phase's, each in the kernel's order or reversed, on the
    plain bodies."""
    (org_y, org_c, plans, _, zmaxw, qp, qp_c, bd, strong, w, h,
     radius) = c["args"]
    mi, rdoq, sbh, modes, zmax2n = c["tail"]
    work, hc_off = c["work"], c["hc_off"]
    lam = full_lambda(qp)
    rq_y = (3, lam) if rdoq else None
    rq_c = (3, lam * 2.0 ** ((qp_c - qp) / 3.0)) if rdoq else None
    ry, rc = torch.zeros_like(org_y), torch.zeros_like(org_c)
    coef_y = torch.zeros(org_y.shape, dtype=torch.int16)
    coef_c = torch.zeros(org_c.shape, dtype=torch.int16)
    motion = tuple(torch.zeros((org_y.shape[0] // 4, w // 4),
                               dtype=torch.int32) for _ in range(4))
    outs = {lg: [torch.full((len(p.vpos),) + s, -9, dtype=torch.int32)
                 for s in ((), (2,), (), (), (), (), (), (6,))]
            for lg, p in plans.items()}
    scratch = {}
    rmd = torch.full((1,), -1, dtype=torch.int32)
    for first, count, _ in work.host_groups:
        items = work.host_items[first:first + count]
        items = items[::-1] if reverse else items
        for lg, row, cb_row, cr_row in items:
            p, o = plans[lg], outs[lg]
            n, m = p.n, p.n // 2
            r1 = slice(row, row + 1)
            pos, zcur = p.pos[r1], p.zcur[r1]
            if modes is None:
                ipred, imode = intra_blocks_plain(ry, pos, p.avail[r1], rmd,
                                                  n, 0, bd, strong, org=org_y)
            else:
                imode = modes[lg][r1]
                ipred, _ = intra_blocks_plain(ry, pos, p.avail[r1], imode, n,
                                              0, bd, strong)
            z2 = None if zmax2n is None else zmax2n[lg]
            mv_i, _, pred0, sse0, *ring = ss_search_motion_plain(
                ry, org_y, pos, zcur, zmaxw[lg], motion, p.nbav[r1],
                p.miav[r1], n, radius, w, h, lam, mi, z2)
            inter, mv, smode, costs = inter_arms_plain(
                ry, org_y, pos, zcur, zmaxw[lg], motion, p.nbav[r1],
                p.miav[r1], mv_i, pred0, sse0, ipred, imode, n, w, h, bd,
                lam, mi)
            gtflag = torch.zeros(1, dtype=torch.int32)
            gtc = torch.zeros((1, 6), dtype=torch.int32)
            if z2 is not None:
                gtflag, gtc = gt_step_plain(
                    ry, org_y, rc, pos, zcur, z2, motion, p.nbav[r1],
                    p.miav[r1], ring, costs, ipred, inter, mv, smode, n, w, h,
                    hc_off, bd, lam, mi)
            cpreds = []
            for r in (cb_row, cr_row):
                cpos = p.cpos[r:r + 1]
                if gtflag[0]:
                    cpred = gt_pred_blocks_plain(rc, cpos, mv, gtc, m, True,
                                                 h // 2, bd, hc_off)
                elif inter[0]:
                    cpred = mc_blocks_plain(rc, cpos, mv, m, True, h // 2,
                                            bd, hc_off)
                else:
                    cpred, _ = intra_blocks_plain(rc, cpos, p.cavail[r1],
                                                  imode, m, 1, bd, strong)
                cpreds.append(cpred)
            scratch[lg, row] = (ipred, smode, inter, mv, cpreds)
            for k, v in zip((0, 1, 2, 6, 7), (inter, mv, imode, gtflag, gtc)):
                o[k][row] = v[0]
        for lg, row, cb_row, cr_row in items:
            p, o = plans[lg], outs[lg]
            n, m = p.n, p.n // 2
            ipred, smode, inter, mv, cpreds = scratch[lg, row]
            pos = p.pos[row:row + 1]
            o[3][row] = tq_encode_plain(org_y, ipred, pos, smode, n, 0, qp,
                                        bd, sbh, rq_y, ry, coef_y)[0]
            motion_write_plain(*motion[:3], pos, inter, mv, n)
            for k, r, cpred in ((4, cb_row, cpreds[0]),
                                (5, cr_row, cpreds[1])):
                o[k][row] = tq_encode_plain(
                    org_c, cpred, p.cpos[r:r + 1], smode, m, 1, qp_c, bd,
                    sbh, rq_c, rc, coef_c)[0]
    return ry, rc, coef_y, coef_c, {lg: tuple(o) for lg, o in outs.items()}


def _emulate_decode(c, reverse):
    """C14's decode entry, group by group, each group's CUs (prediction
    plus residual) in the kernel's order or reversed, on the plain
    bodies."""
    (resi_y, resi_c, plans, _, modes, cmodes, mvs, bd, strong, h,
     gt) = c["dargs"]
    hc_off = resi_c.shape[0] // 2
    ry, rc = torch.zeros_like(resi_y), torch.zeros_like(resi_c)
    work = c["dwork"]
    for first, count, n_intra in work.host_groups:
        items = list(enumerate(work.host_items[first:first + count]))
        for j, (lg, row, cb_row, cr_row) in (items[::-1] if reverse
                                             else items):
            p = plans[lg]
            n, m = p.n, p.n // 2
            r1 = slice(row, row + 1)
            pos, mv = p.pos[r1], mvs[lg][r1]
            chroma = (p.cpos[cb_row:cb_row + 1], p.cpos[cr_row:cr_row + 1])
            if j < n_intra:
                intra_blocks_plain(ry, pos, p.avail[r1], modes[lg][r1], n, 0,
                                   bd, strong, resi=resi_y)
                for cpos in chroma:
                    intra_blocks_plain(rc, cpos, p.cavail[r1],
                                       cmodes[lg][r1], m, 1, bd, strong,
                                       resi=resi_c)
            elif gt is not None and gt[lg][0][row]:
                gtv = gt[lg][1][r1]
                gt_pred_blocks_plain(ry, pos, mv, gtv, n, False, h, bd,
                                     resi=resi_y)
                for cpos in chroma:
                    gt_pred_blocks_plain(rc, cpos, mv, gtv, m, True, h // 2,
                                         bd, hc_off, resi=resi_c)
            else:
                mc_blocks_plain(ry, pos, mv, n, False, h, bd, resi=resi_y,
                                dst=ry)
                for cpos in chroma:
                    mc_blocks_plain(rc, cpos, mv, m, True, h // 2, bd,
                                    hc_off, resi=resi_c, dst=rc)
    return ry, rc


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The JAX scan_encode_iss on the case's own schedule (the reference
    encoder's _prep of the same CUs, with the same pre-pass modes), its
    outputs packed in the port's order; and the JAX scan_decode_ss on the
    decoder's inputs, its slots the port's decode plans level by level."""
    c = _case(name)
    cfg = c["cfg"]
    w, h = cfg.width, cfg.height
    jcfg = JaxConfig(**{k: getattr(cfg, k) for k in (
        "width", "height", "qp", "bit_depth", "ctb_log2", "cu_log2",
        "quadtree", "search_range", "mi_size", "gt", "rdoq", "sbh")})
    jenc = JaxEncoder(jcfg)
    sizes, data, zmaxw, zmax2n, xs, _ = jenc._prep(
        c["leaves"], key=None if c["leaves"] is None else "given")
    fixed = c["mode4"] is not None
    if fixed:
        xs = jenc._xs_with_modes(xs, data, sizes, c["mode4"])
    org_y, org_cb, org_cr = jenc._upload(*c["frame"])
    ry, rcb, rcr, cy, ccb, ccr, outs = jss.scan_encode_iss(
        org_y, org_cb, org_cr, xs, zmaxw, zmax2n, sizes=sizes, qp=cfg.qp,
        qp_c=rom.chroma_qp_from_luma(cfg.qp), bit_depth=cfg.bit_depth,
        strong=cfg.strong_intra_smoothing, w=w, h=h,
        radius=cfg.search_range, mi_size=cfg.mi_size, gt=cfg.gt,
        use_rdoq=cfg.rdoq, sbh=cfg.sbh, fixed_mode=fixed)
    plans = c["args"][2]
    packed = {}
    for lg in sizes:
        valid = data[lg]["valid"]
        np.testing.assert_array_equal(data[lg]["pos"][valid],
                                      plans[lg].vpos)
        packed[lg] = tuple(np.asarray(a)[valid].reshape(
            (int(valid.sum()),) + ((6,) if k == 7 else (2,) if k == 1
                                   else ())).astype(np.int32)
            for k, a in enumerate(outs[lg]))
    enc = tuple(np.asarray(a) for a in (ry, rcb, rcr, cy, ccb, ccr))
    return enc, packed, _reference_decode(c)


def _reference_decode(c):
    (resi_y, resi_c, plans, _, modes, cmodes, mvs, bd, strong, h,
     gt) = c["dargs"]
    hcp = resi_c.shape[0] // 2
    xs = {}
    for lg, p in plans.items():
        n = p.n
        s_n, b_n = len(p.cnt), max(1, int(p.cnt.max()))
        pos = np.zeros((s_n, b_n, 2), np.int32)
        pos[:, :, 1] = h
        avail = np.zeros((s_n, b_n, 4 * n + 1), bool)
        availc = np.zeros((s_n, b_n, 2 * n + 1), bool)
        slot = [np.zeros((s_n, b_n) + s, np.int32)
                for s in ((), (), (), (2,), (), (6,))]
        lvl = np.repeat(np.arange(s_n), p.cnt)
        j = np.arange(len(p.vpos)) - p.off[lvl]
        pos[lvl, j] = p.vpos
        avail[lvl, j] = p.avail.numpy()
        availc[lvl, j] = p.cavail.numpy()
        per_cu = (modes[lg], cmodes[lg],
                  torch.as_tensor(j >= p.cnt_a[lvl], dtype=torch.int32),
                  mvs[lg],
                  (gt[lg][0] if gt is not None
                   else torch.zeros(len(j), dtype=torch.int32)),
                  (gt[lg][1] if gt is not None
                   else torch.zeros((len(j), 6), dtype=torch.int32)))
        for a, v in zip(slot, per_cu):
            a[lvl, j] = v.numpy()
        xs[lg] = tuple(jnp.asarray(a) for a in [pos, avail, availc] + slot)
    dy, dcb, dcr = jss.scan_decode_ss(
        jnp.asarray(resi_y.numpy()), jnp.asarray(resi_c[:hcp].numpy()),
        jnp.asarray(resi_c[hcp:].numpy()), xs, sizes=tuple(plans),
        bit_depth=bd, strong=strong, h=h)
    return np.asarray(dy), np.asarray(dcb), np.asarray(dcr)


def _planes(c, ry, rc):
    h, hc_off = c["cfg"].height, c["hc_off"]
    ry, rc = np.asarray(ry), np.asarray(rc)
    return ry[:h], rc[:h // 2], rc[hc_off:hc_off + h // 2]


def _assert_encode(c, got, want, what):
    for a, b, nm in zip(_planes(c, *got[:2]) + _planes(c, *got[2:4]),
                        _planes(c, *want[:2]) + _planes(c, *want[2:4]),
                        ("ry", "rcb", "rcr", "coef_y", "coef_cb",
                         "coef_cr")):
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {nm}")
    assert set(got[4]) == set(want[4])
    for lg in want[4]:
        for a, b, nm in zip(got[4][lg], want[4][lg], OUT_NAMES):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f"{what}: {nm} {lg}")


@pytest.mark.parametrize("name", CASES)
def test_work_list_covers_each_group_once(name):
    """The encoder's and the decoder's work lists hold each (level, CU
    size) group of the loop exactly once, in the reference's order (level
    by level, within a level by size, smallest first), with the loop's CUs
    in their packed order, each CU's cb and cr rows where pack_ss put
    them, and the decoder's intra CUs first."""
    c = _case(name)
    for plans, work in ((c["args"][2], c["work"]),
                        (c["dargs"][2], c["dwork"])):
        want = [(s, lg) for s in range(len(next(iter(plans.values())).cnt))
                for lg, p in plans.items() if p.cnt[s]]
        groups = work.host_groups
        assert len(groups) == len(want)
        assert groups[0, 0] == 0 and (groups[1:, 0] == np.cumsum(
            groups[:-1, 1])).all()
        assert groups[:, 1].sum() == len(work.host_items)
        assert work.widest == int(groups[:, 1].max())
        for (s, lg), (first, count, n_a) in zip(want, groups):
            p = plans[lg]
            o, cnt, ca = int(p.off[s]), int(p.cnt[s]), int(p.cnt_a[s])
            assert (count, n_a) == (cnt, ca)
            items = work.host_items[first:first + count]
            assert (items[:, 0] == lg).all()
            np.testing.assert_array_equal(items[:, 1], np.arange(o, o + cnt))
            cpos = p.cpos.numpy()
            pos = p.vpos[items[:, 1]]
            np.testing.assert_array_equal(cpos[items[:, 2]], pos // 2)
            np.testing.assert_array_equal(cpos[items[:, 3]] - [0,
                                                               c["hc_off"]],
                                          pos // 2)
            rows = np.concatenate([items[:, 2], items[:, 3]])
            assert sorted(rows) == list(range(2 * o, 2 * o + 2 * cnt))


@pytest.mark.parametrize("reverse", [False, True],
                         ids=["kernel-order", "reversed"])
@pytest.mark.parametrize("name", CASES)
def test_encode_walk_matches_loop_and_reference(name, reverse):
    """C14's encode, item by item on the plain bodies, read phase then
    write phase per group, in the kernel's order and reversed: recon and
    level planes and every per-CU output equal the level loop's and the
    JAX scan_encode_iss's, bit for bit."""
    c = _case(name)
    got = _emulate_encode(c, reverse)
    loop = _loop(name)[0]
    _assert_encode(c, got, loop, "against the level loop")
    ref, packed, _ = _reference(name)
    h, hc = c["cfg"].height, c["cfg"].height // 2
    for a, b, nm in zip(_planes(c, *got[:2]) + _planes(c, *got[2:4]),
                        (ref[0][:h], ref[1][:hc], ref[2][:hc], ref[3][:h],
                         ref[4][:hc], ref[5][:hc]),
                        ("ry", "rcb", "rcr", "coef_y", "coef_cb",
                         "coef_cr")):
        np.testing.assert_array_equal(a, b, err_msg=f"JAX: {nm}")
    for lg, outs in packed.items():
        for a, b, nm in zip(got[4][lg], outs, OUT_NAMES):
            a = np.asarray(a)
            if nm == "gtc":
                # the coded corners are read only where the GT wins; the
                # reference leaves a searched loser's there, the port zeros
                on = outs[6] != 0
                a, b = a[on], b[on]
            np.testing.assert_array_equal(a, b, err_msg=f"JAX: {nm} {lg}")
    inter = sum(int(o[0].sum()) for o in got[4].values())
    gts = sum(int(o[6].sum()) for o in got[4].values())
    assert inter > 0, "no SS, merge or GT CU"
    assert (gts > 0) == c["cfg"].gt, f"{gts} GT CUs"


@pytest.mark.parametrize("reverse", [False, True],
                         ids=["kernel-order", "reversed"])
@pytest.mark.parametrize("name", CASES)
def test_decode_walk_matches_loop_and_reference(name, reverse):
    """C14's decode, one phase per group, CU by CU on the plain bodies in
    the kernel's order and reversed, on the decoder's own inputs for the
    case's stream: the recon equals the level loop's, the JAX
    scan_decode_ss's and the encoder's, bit for bit."""
    c = _case(name)
    got = _planes(c, *_emulate_decode(c, reverse))
    for a, b, nm in zip(got, _planes(c, *_loop(name)[1]), ("y", "cb", "cr")):
        np.testing.assert_array_equal(a, b, err_msg=f"loop: {nm}")
    h, hc = c["cfg"].height, c["cfg"].height // 2
    ref = _reference(name)[2]
    for a, b, nm in zip(got, (ref[0][:h], ref[1][:hc], ref[2][:hc]),
                        ("y", "cb", "cr")):
        np.testing.assert_array_equal(a, b, err_msg=f"JAX: {nm}")
    enc = _loop(name)[0]
    # the decoder's recon before the loop filters is the encoder's
    for a, b, nm in zip(got, _planes(c, *enc[:2]), ("y", "cb", "cr")):
        np.testing.assert_array_equal(a, b, err_msg=f"encoder: {nm}")
    gt = c["dargs"][10]
    assert (gt is not None) == c["cfg"].gt


def _footprints(c):
    """Per decode group, per CU: the samples its prediction reads (luma
    and the stacked chroma plane, as boolean planes) and the samples it
    writes. Reads are the available chain samples of an intra CU, the
    whole clamped MC window of an inter one ((n+7)^2 luma, (m+3)^2
    chroma), the clamped GT window of a GT one (2n luma; the (2m+3)^2
    chroma window of its interpolation)."""
    (resi_y, resi_c, plans, _, modes, cmodes, mvs, bd, strong, h,
     gt) = c["dargs"]
    w = resi_y.shape[1]
    hc, hc_off = h // 2, resi_c.shape[0] // 2
    work = c["dwork"]

    def win(mask, x0, y0, size, lo, hi, wmax):
        ys = np.clip(np.arange(y0, y0 + size), lo, hi)
        xs = np.clip(np.arange(x0, x0 + size), 0, wmax - 1)
        mask[np.ix_(ys, xs)] = True

    for first, count, n_intra in work.host_groups:
        cus = []
        for j, (lg, row, cb_row, cr_row) in enumerate(
                work.host_items[first:first + count]):
            p = plans[lg]
            n, m = p.n, p.n // 2
            px, py = (int(v) for v in p.vpos[row])
            ry_r = np.zeros(resi_y.shape, bool)
            rc_r = np.zeros(resi_c.shape, bool)
            ry_w = np.zeros(resi_y.shape, bool)
            rc_w = np.zeros(resi_c.shape, bool)
            ry_w[py:py + n, px:px + n] = True
            chroma = [tuple(int(v) for v in p.cpos[r]) for r in (cb_row,
                                                                 cr_row)]
            for cx, cy in chroma:
                rc_w[cy:cy + m, cx:cx + m] = True
            if j < n_intra:
                for mask, (bx, by), k, av in (
                        [(ry_r, (px, py), n, p.avail[row])]
                        + [(rc_r, xy, m, p.cavail[row]) for xy in chroma]):
                    av = av.numpy()
                    ch = np.array([(bx - 1, by + 2 * k - 1 - i) if i < 2 * k
                                   else (bx - 1, by - 1) if i == 2 * k
                                   else (bx + i - 2 * k - 1, by - 1)
                                   for i in range(4 * k + 1)])
                    pw = mask.shape[1]
                    mask[np.clip(ch[av, 1], 0, mask.shape[0] - 1),
                         np.clip(ch[av, 0], 0, pw - 1)] = True
            else:
                mvx, mvy = (int(v) for v in mvs[lg][row])
                is_gt = gt is not None and int(gt[lg][0][row])
                for cx, cy in chroma:
                    lo = hc_off if cy >= hc_off else 0
                    if is_gt:
                        vx, vy = mvx >> 2, mvy >> 2
                        win(rc_r, cx - m // 2 + ((4 * vx) >> 3) - 1,
                            cy - m // 2 + ((4 * vy) >> 3) - 1, 2 * m + 3,
                            lo, lo + hc - 1, w // 2)
                    else:
                        win(rc_r, cx + (mvx >> 3) - 1, cy + (mvy >> 3) - 1,
                            m + 3, lo, lo + hc - 1, w // 2)
                if is_gt:
                    win(ry_r, px + (mvx >> 2) - n // 2,
                        py + (mvy >> 2) - n // 2, 2 * n, 0, h - 1, w)
                else:
                    win(ry_r, px + (mvx >> 2) - 3, py + (mvy >> 2) - 3,
                        n + 7, 0, h - 1, w)
            cus.append((ry_r, rc_r, ry_w, rc_w))
        yield cus


@pytest.mark.parametrize("name", CASES)
def test_decode_group_reads_no_sample_its_group_writes(name):
    """C14 decodes a group in one phase, each CU writing its recon as soon
    as it is predicted; the reference predicts the whole group first. They
    agree because no CU of a group reads a sample that another CU of the
    same group writes: the decoder's schedule puts every block a
    prediction reads (intra chain, MC window, GT window) at an earlier
    level."""
    c = _case(name)
    groups = 0
    for cus in _footprints(c):
        groups += 1
        wy = np.zeros_like(cus[0][2], dtype=np.int32)
        wc = np.zeros_like(cus[0][3], dtype=np.int32)
        for _, _, ry_w, rc_w in cus:
            wy += ry_w
            wc += rc_w
        assert wy.max() <= 1 and wc.max() <= 1, "two CUs write one sample"
        for k, (ry_r, rc_r, ry_w, rc_w) in enumerate(cus):
            assert not (ry_r & (wy > 0) & ~ry_w).any(), f"CU {k}, luma"
            assert not (rc_r & (wc > 0) & ~rc_w).any(), f"CU {k}, chroma"
    assert groups == len(c["dwork"].host_groups)


def test_cpu_tensors_run_the_loop():
    """On CPU tensors scan_encode_iss and scan_decode_ss are the level
    loops: they launch no C14 and give the loops' results."""
    c = _case("gt-cu16-qp37")
    before = (ss_scan.SCAN_ISS_ENCODE_LAUNCHES,
              ss_scan.SCAN_ISS_DECODE_LAUNCHES)
    enc = ss_scan.scan_encode_iss(*c["args"], *c["tail"], work=c["work"])
    _assert_encode(c, enc, _loop("gt-cu16-qp37")[0], "scan_encode_iss")
    dec = ss_scan.scan_decode_ss(*c["dargs"], work=c["dwork"])
    for a, b in zip(dec, _loop("gt-cu16-qp37")[1]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (ss_scan.SCAN_ISS_ENCODE_LAUNCHES,
            ss_scan.SCAN_ISS_DECODE_LAUNCHES) == before
