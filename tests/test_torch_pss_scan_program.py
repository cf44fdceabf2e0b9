"""Kernel C14's PSS form, a PSS picture's wavefront as one launch, on the
CPU.

C14's PSS form (hevc_hop_torch/csrc/ss_scan.cu, ss_scan_pss_encode_kernel
and ss_scan_pss_decode_kernel) runs only on the card. What it does is held
here as tests/test_torch_ss_scan_program.py holds its ISS form: its work
list holds each (level, CU size) group of the PSS level loop once, in the
reference's order; a plain emulation that walks the work list phase by
phase, as C14's CTAs do (encode: every CU's read phase, C2, C9's SS search
with the anchor ring and its temporal search, C10's PSS tournament, C12's
PSS decision and the chroma prediction from the recon, the previous
picture or C2; then every CU's write phase, C3 with RDOQ's PSS init type
and the motion write with the reference index; decode: every CU's
prediction plus residual, a temporal CU's from the previous picture), in
the kernel's order and again reversed within each phase, gives bit for bit
what the level loop and the JAX reference's ``scan_encode_pss`` and
``scan_decode_pss`` give: recon planes, level planes and every per-CU
output, the reference index included; and no CU of a decode group reads a
sample that another CU of its group writes. Each case is a two-picture
sequence, an ISS picture then a PSS one, coded by the port's encoder on
the CPU; the PSS picture's scan inputs are the encoder's own, and its
reference, the ISS picture's filtered recon, is held equal to the JAX
encoder's. The cases:
the GT on, 16x16 CUs, QP 37, on warped lenslet content panned 8 samples a
picture (both GT and temporal CUs occur); the quadtree with RDOQ and SBH,
the GT off, on the panned lenslet frame; 10 bit with the GT on and 32x32
CUs on noisy micro-image texture, whose merge and temporal refinement
SSEs pass 2^24 (the PSS program's sums there, ROADMAP.md F10's unread
regions, held against the JAX program).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_hop_tpu.models import ss_scan as jss
from hevc_hop_tpu.models.ss_encoder import HoloConfig as JaxConfig
from hevc_hop_tpu.models.ss_encoder import HoloEncoder as JaxEncoder
from hevc_hop_torch.models import ss_scan, wavefront
from hevc_hop_torch.models.decoder import Decoder
from hevc_hop_torch.models.partition import full_lambda
from hevc_hop_torch.models.ss_encoder import HoloConfig, HoloEncoder
from hevc_hop_torch.ops.gt import gt_pred_blocks_plain, gt_step_plain
from hevc_hop_torch.ops.inter_arms import inter_arms_plain, motion_write_plain
from hevc_hop_torch.ops.interp import mc_blocks_plain
from hevc_hop_torch.ops.intra import intra_blocks_plain
from hevc_hop_torch.ops.ss_search import pss_search_plain
from hevc_hop_torch.ops.tq import tq_encode_plain
from test_e2e_iss import synth_lenslet, synth_warped_lenslet

SS_REF = 1     # L0 = [previous picture, SS]
# name -> (width, height, HoloConfig fields, content, pan samples a
# picture, noise amplitude at 8 bit, bit depth scale)
CASES = {
    "gt-cu16-qp37": (64, 64, dict(cu_log2=4, qp=37, mi_size=16,
                                  search_range=32, search_range_t=4,
                                  gt=True), "warped", 8, 2, 1),
    "quadtree-rdoq-sbh": (128, 96, dict(quadtree=True, qp=32, mi_size=16,
                                        search_range=32, search_range_t=16,
                                        rdoq=True, sbh=True, gt=False),
                          "lenslet", 1, 2, 1),
    # each picture's own noise (a standard deviation of 28 at 8 bit, 112
    # at 10) keeps every 32x32 inter prediction's SSE above 2^24; the
    # micro-image texture keeps intra's above the temporal one's
    "main10-gt-cu32": (64, 64, dict(cu_log2=5, qp=37, mi_size=16,
                                    search_range=32, search_range_t=4,
                                    gt=True, bit_depth=10), "textured", 1,
                       48, 4),
}
OUT_NAMES = ("inter", "refsel", "mv", "imode", "cbf_y", "cbf_cb", "cbf_cr",
             "gtflag", "gtc")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain bodies run many small tensor ops; with the suite's
    parallel workers, a thread pool per worker oversubscribes the cores,
    so this module's worker takes one thread while it runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames(name):
    """The case's two pictures: the first frame, then it rolled by the
    case's pan, each plus default_rng(7) noise in [-noise, noise] (the
    motion model of test_torch_e2e_pss.py, at 8 bit), scaled to the bit
    depth."""
    w, h, kw, content, pan, noise, scale = CASES[name]
    if content == "warped":
        y0, cb0, cr0 = synth_warped_lenslet(w, h, 16, seed=5)
    elif content == "textured":
        y0, cb0, cr0 = synth_lenslet(w, h, 16, seed=5)
    else:
        from tools.bdrate import lenslet_frame
        y0, cb0, cr0 = lenslet_frame(w, h, mi=16, seed=5)
    rng = np.random.default_rng(7)
    out = []
    for t in range(2):
        y = (np.roll(y0, t * pan, axis=1)
             + rng.integers(-noise, noise + 1, (h, w)))
        out.append(tuple(
            (p * scale).astype(np.int32)
            for p in (y.clip(0, 255), np.roll(cb0, t * pan // 2, axis=1),
                      np.roll(cr0, t * pan // 2, axis=1))))
    return out


def _recording(name):
    """A stand-in for ss_scan.<name> that records its calls' arguments and
    results."""
    orig = getattr(ss_scan, name)
    seen = []

    def record(*a, **k):
        out = orig(*a, **k)
        seen.append((a, k, out))
        return out

    return orig, record, seen


@functools.lru_cache(maxsize=None)
def _case(name):
    """The PSS scan's inputs and results as HoloEncoder's encode_sequence
    hands them over on the CPU (the level loop), and the decoder's own
    call of scan_decode_pss on the encoder's stream with its result."""
    w, h, kw = CASES[name][:3]
    cfg = HoloConfig(width=w, height=h, **kw)
    frames = _frames(name)
    enc = HoloEncoder(cfg, device="cpu")
    orig_e, rec_e, seen_e = _recording("scan_encode_pss")
    orig_d, rec_d, seen_d = _recording("scan_decode_pss")
    ss_scan.scan_encode_pss = rec_e
    try:
        stream = enc.encode_sequence(frames)
    finally:
        ss_scan.scan_encode_pss = orig_e
    ss_scan.scan_decode_pss = rec_d
    try:
        dec = Decoder(device="cpu")
        dec.decode_stream(stream)
    finally:
        ss_scan.scan_decode_pss = orig_d
    assert dec.hash_ok == [True, True]
    (args, kwargs, loop), = seen_e
    (dargs, dkwargs, dloop), = seen_d
    leaves = (None if not cfg.quadtree else wavefront.leaves_from_depth(
        enc._depth8, w, h, cfg.ctb_log2))
    mode4 = None
    if cfg.quadtree:
        # the PSS picture's pre-pass modes, as the encoder took them
        plans, modes = args[4], args[18]
        mode4 = np.zeros((h // 4, w // 4), np.int32)
        for lg, p in plans.items():
            px, py = p.vpos[:, 0], p.vpos[:, 1]
            mode4[py // 4, px // 4] = modes[lg].numpy()
    return dict(cfg=cfg, frames=frames, args=args, work=kwargs["work"],
                loop=loop, dargs=dargs, dwork=dkwargs["work"], dloop=dloop,
                leaves=leaves, mode4=mode4, hc_off=args[1].shape[0] // 2,
                ref=enc.recon_history[0])


def _emulate_encode(c, reverse, sse=None):
    """C14's PSS encode entry, group by group: the read phase's items, then
    the write phase's, each in the kernel's order or reversed, on the
    plain bodies. With ``sse`` (a list), the merge, SS and temporal
    arms' costs of each 32x32 CU are appended to it."""
    (org_y, org_c, ref_y, ref_c, plans, _, zmaxw, qp, qp_c, bd, strong, w,
     h, radius, radius_t, mi, rdoq, sbh, modes, zmax2n) = c["args"]
    work, hc_off = c["work"], c["hc_off"]
    lam = full_lambda(qp)
    rq_y = (4, lam) if rdoq else None
    rq_c = (4, lam * 2.0 ** ((qp_c - qp) / 3.0)) if rdoq else None
    ry, rc = torch.zeros_like(org_y), torch.zeros_like(org_c)
    coef_y = torch.zeros(org_y.shape, dtype=torch.int16)
    coef_c = torch.zeros(org_c.shape, dtype=torch.int16)
    motion = tuple(torch.zeros((org_y.shape[0] // 4, w // 4),
                               dtype=torch.int32) for _ in range(4))
    outs = {lg: [torch.full((len(p.vpos),) + s, -9, dtype=torch.int32)
                 for s in ((), (), (2,), (), (), (), (), (), (6,))]
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
            (mv_i, _, pred0, sse0, *ring), (mv_t, _, tpred0, tsse0) = \
                pss_search_plain(ry, org_y, pos, zcur, zmaxw[lg], motion,
                                 p.nbav[r1], p.miav[r1], n, radius, w, h,
                                 lam, mi, z2, ref_y, radius_t)
            inter, mv, smode, costs, refsel = inter_arms_plain(
                ry, org_y, pos, zcur, zmaxw[lg], motion, p.nbav[r1],
                p.miav[r1], mv_i, pred0, sse0, ipred, imode, n, w, h, bd,
                lam, mi, (ref_y, mv_t, tpred0, tsse0))
            if sse is not None and n == 32:
                sse.append(costs[0, 1:].clone())
            gtflag = torch.zeros(1, dtype=torch.int32)
            gtc = torch.zeros((1, 6), dtype=torch.int32)
            if z2 is not None:
                gtflag, gtc = gt_step_plain(
                    ry, org_y, rc, pos, zcur, z2, motion, p.nbav[r1],
                    p.miav[r1], ring, costs, ipred, inter, mv, smode, n, w, h,
                    hc_off, bd, lam, mi, refsel)
            cpreds = []
            for r in (cb_row, cr_row):
                cpos = p.cpos[r:r + 1]
                if gtflag[0]:
                    cpred = gt_pred_blocks_plain(rc, cpos, mv, gtc, m, True,
                                                 h // 2, bd, hc_off)
                elif inter[0]:
                    # an SS CU reads the recon, a temporal one the previous
                    # picture
                    src = rc if refsel[0] == SS_REF else ref_c
                    cpred = mc_blocks_plain(src, cpos, mv, m, True, h // 2,
                                            bd, hc_off)
                else:
                    cpred, _ = intra_blocks_plain(rc, cpos, p.cavail[r1],
                                                  imode, m, 1, bd, strong)
                cpreds.append(cpred)
            scratch[lg, row] = (ipred, smode, inter, mv, refsel, cpreds)
            for k, v in zip((0, 1, 2, 3, 7, 8),
                            (inter, refsel, mv, imode, gtflag, gtc)):
                o[k][row] = v[0]
        for lg, row, cb_row, cr_row in items:
            p, o = plans[lg], outs[lg]
            n, m = p.n, p.n // 2
            ipred, smode, inter, mv, refsel, cpreds = scratch[lg, row]
            pos = p.pos[row:row + 1]
            o[4][row] = tq_encode_plain(org_y, ipred, pos, smode, n, 0, qp,
                                        bd, sbh, rq_y, ry, coef_y)[0]
            motion_write_plain(*motion[:3], pos, inter, mv, n, motion[3],
                               refsel)
            for k, r, cpred in ((5, cb_row, cpreds[0]),
                                (6, cr_row, cpreds[1])):
                o[k][row] = tq_encode_plain(
                    org_c, cpred, p.cpos[r:r + 1], smode, m, 1, qp_c, bd,
                    sbh, rq_c, rc, coef_c)[0]
    return ry, rc, coef_y, coef_c, {lg: tuple(o) for lg, o in outs.items()}


def _emulate_decode(c, reverse):
    """C14's PSS decode entry, group by group, each group's CUs (prediction
    plus residual) in the kernel's order or reversed, on the plain bodies:
    GT, then SS, then temporal (from the previous picture), then intra."""
    (resi_y, resi_c, ref_y, ref_c, plans, _, modes, cmodes, mvs, tf, bd,
     strong, h, gt) = c["dargs"]
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
                temporal = bool(tf[lg][0][row])
                sy, sc = (ref_y, ref_c) if temporal else (ry, rc)
                mc_blocks_plain(sy, pos, mv, n, False, h, bd, resi=resi_y,
                                dst=ry)
                for cpos in chroma:
                    mc_blocks_plain(sc, cpos, mv, m, True, h // 2, bd,
                                    hc_off, resi=resi_c, dst=rc)
    return ry, rc


def _jax_config(cfg):
    return JaxConfig(**{k: getattr(cfg, k) for k in (
        "width", "height", "qp", "bit_depth", "ctb_log2", "cu_log2",
        "quadtree", "search_range", "search_range_t", "mi_size", "gt",
        "rdoq", "sbh")})


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The JAX scan_encode_pss on the case's own schedule (the reference
    encoder's _prep of the same CUs, with the same pre-pass modes) and the
    port encoder's previous picture, its outputs packed in the port's
    order; and the JAX scan_decode_pss on the decoder's inputs, its slots
    the port's decode plans level by level."""
    c = _case(name)
    cfg = c["cfg"]
    w, h = cfg.width, cfg.height
    jenc = JaxEncoder(_jax_config(cfg))
    sizes, data, zmaxw, zmax2n, xs, _ = jenc._prep(
        c["leaves"], key=None if c["leaves"] is None else "given")
    fixed = c["mode4"] is not None
    if fixed:
        xs = jenc._xs_with_modes(xs, data, sizes, c["mode4"])
    org = jenc._upload(*c["frames"][1])
    ref = tuple(jnp.asarray(p, jnp.int32) for p in c["ref"])
    ry, rcb, rcr, cy, ccb, ccr, outs = jss.scan_encode_pss(
        *org, *ref, xs, zmaxw, zmax2n, sizes=sizes, qp=cfg.qp,
        qp_c=c["args"][8], bit_depth=cfg.bit_depth,
        strong=cfg.strong_intra_smoothing, w=w, h=h,
        radius=cfg.search_range, radius_t=cfg.search_range_t,
        mi_size=cfg.mi_size, gt=cfg.gt, use_rdoq=cfg.rdoq, sbh=cfg.sbh,
        fixed_mode=fixed)
    plans = c["args"][4]
    packed = {}
    for lg in sizes:
        valid = data[lg]["valid"]
        np.testing.assert_array_equal(data[lg]["pos"][valid],
                                      plans[lg].vpos)
        packed[lg] = tuple(np.asarray(a)[valid].reshape(
            (int(valid.sum()),) + ((6,) if k == 8 else (2,) if k == 2
                                   else ())).astype(np.int32)
            for k, a in enumerate(outs[lg]))
    enc = tuple(np.asarray(a) for a in (ry, rcb, rcr, cy, ccb, ccr))
    return enc, packed, _reference_decode(c)


def _reference_decode(c):
    (resi_y, resi_c, ref_y, ref_c, plans, _, modes, cmodes, mvs, tf, bd,
     strong, h, gt) = c["dargs"]
    hcp = resi_c.shape[0] // 2
    xs = {}
    for lg, p in plans.items():
        n = p.n
        s_n, b_n = len(p.cnt), max(1, int(p.cnt.max()))
        pos = np.zeros((s_n, b_n, 2), np.int32)
        pos[:, :, 1] = h
        avail = np.zeros((s_n, b_n, 4 * n + 1), bool)
        availc = np.zeros((s_n, b_n, 2 * n + 1), bool)
        # modes, cmodes, ssf, tf, mv, gtflag, gtv
        slot = [np.zeros((s_n, b_n) + s, np.int32)
                for s in ((), (), (), (), (2,), (), (6,))]
        lvl = np.repeat(np.arange(s_n), p.cnt)
        j = np.arange(len(p.vpos)) - p.off[lvl]
        pos[lvl, j] = p.vpos
        avail[lvl, j] = p.avail.numpy()
        availc[lvl, j] = p.cavail.numpy()
        per_cu = (modes[lg], cmodes[lg], tf[lg][1], tf[lg][0], mvs[lg],
                  (gt[lg][0] if gt is not None
                   else torch.zeros(len(j), dtype=torch.int32)),
                  (gt[lg][1] if gt is not None
                   else torch.zeros((len(j), 6), dtype=torch.int32)))
        for a, v in zip(slot, per_cu):
            a[lvl, j] = v.numpy()
        xs[lg] = tuple(jnp.asarray(a) for a in [pos, avail, availc] + slot)
    dy, dcb, dcr = jss.scan_decode_pss(
        jnp.asarray(resi_y.numpy()), jnp.asarray(resi_c[:hcp].numpy()),
        jnp.asarray(resi_c[hcp:].numpy()), jnp.asarray(ref_y.numpy()),
        jnp.asarray(ref_c[:hcp].numpy()), jnp.asarray(ref_c[hcp:].numpy()),
        xs, sizes=tuple(plans), bit_depth=bd, strong=strong, h=h)
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
        assert len(got[4][lg]) == len(want[4][lg]) == len(OUT_NAMES)
        for a, b, nm in zip(got[4][lg], want[4][lg], OUT_NAMES):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f"{what}: {nm} {lg}")


@pytest.mark.parametrize("name", CASES)
def test_work_list_covers_each_group_once(name):
    """The PSS picture's encoder and decoder work lists hold each (level,
    CU size) group of the loop exactly once, in the reference's order
    (level by level, within a level by size, smallest first), with the
    loop's CUs in their packed order, each CU's cb and cr rows where
    pack_ss put them, and the decoder's intra CUs first."""
    c = _case(name)
    for plans, work in ((c["args"][4], c["work"]),
                        (c["dargs"][4], c["dwork"])):
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
    """C14's PSS encode, item by item on the plain bodies, read phase then
    write phase per group, in the kernel's order and reversed: recon and
    level planes and every per-CU output, the reference index included,
    equal the level loop's and the JAX scan_encode_pss's, bit for bit."""
    c = _case(name)
    sse = []
    got = _emulate_encode(c, reverse, sse)
    _assert_encode(c, got, c["loop"], "against the level loop")
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
                # The coded corners are read only where the GT wins. The
                # reference searches anchors that are not gt_ok and leaves
                # a loser's searched corners here; the port zeros them (it
                # searches no anchor a decision cannot use), and the stream
                # reads gtc only on GT CUs.
                on = outs[7] != 0
                a, b = a[on], b[on]
            np.testing.assert_array_equal(a, b, err_msg=f"JAX: {nm} {lg}")
    outs = list(got[4].values())
    temporal = sum(int(((o[0] != 0) & (o[1] == 0)).sum()) for o in outs)
    gts = sum(int(o[7].sum()) for o in outs)
    assert temporal > 0, "no temporal CU"
    if name == "gt-cu16-qp37":
        assert gts > 0, "no GT CU"
    if name == "main10-gt-cu32":
        # F10's unread regions: 10-bit PSS sums, and merge and refinement
        # SSEs above 2^24. Each arm's cost is the least SSE of its
        # candidates plus a rate far below 2^20 (3e38: no candidate)
        costs = torch.stack(sse)
        arms = costs[:, [0, 2]]           # merge, temporal refinement
        assert (arms < 1e37).all() and (arms > 2.0 ** 24 + 2.0 ** 20).all(), \
            f"a 32x32 merge or temporal SSE at or below 2^24: {arms}"


@pytest.mark.parametrize("reverse", [False, True],
                         ids=["kernel-order", "reversed"])
@pytest.mark.parametrize("name", CASES)
def test_decode_walk_matches_loop_and_reference(name, reverse):
    """C14's PSS decode, one phase per group, CU by CU on the plain bodies
    in the kernel's order and reversed, on the decoder's own inputs for
    the case's stream: the recon equals the level loop's, the JAX
    scan_decode_pss's and the encoder's, bit for bit."""
    c = _case(name)
    got = _planes(c, *_emulate_decode(c, reverse))
    for a, b, nm in zip(got, _planes(c, *c["dloop"]), ("y", "cb", "cr")):
        np.testing.assert_array_equal(a, b, err_msg=f"loop: {nm}")
    h, hc = c["cfg"].height, c["cfg"].height // 2
    ref = _reference(name)[2]
    for a, b, nm in zip(got, (ref[0][:h], ref[1][:hc], ref[2][:hc]),
                        ("y", "cb", "cr")):
        np.testing.assert_array_equal(a, b, err_msg=f"JAX: {nm}")
    # the decoder's recon before the loop filters is the encoder's
    for a, b, nm in zip(got, _planes(c, *c["loop"][:2]), ("y", "cb", "cr")):
        np.testing.assert_array_equal(a, b, err_msg=f"encoder: {nm}")
    tf = c["dargs"][9]
    assert sum(int(v[0].sum()) for v in tf.values()) > 0, "no temporal CU"


def _footprints(c):
    """Per decode group, per CU: the recon samples its prediction reads
    (luma and the stacked chroma plane, as boolean planes) and the samples
    it writes. Reads are the available chain samples of an intra CU, the
    whole clamped MC window of an SS one ((n+7)^2 luma, (m+3)^2 chroma),
    the clamped GT window of a GT one (2n luma; the (2m+3)^2 chroma window
    of its interpolation), and none for a temporal one, which reads the
    previous picture."""
    (resi_y, resi_c, _, _, plans, _, _, _, mvs, tf, _, _, h,
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
            is_gt = gt is not None and int(gt[lg][0][row])
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
            elif is_gt or not int(tf[lg][0][row]):
                mvx, mvy = (int(v) for v in mvs[lg][row])
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
    """C14's PSS form decodes a group in one phase, each CU writing its
    recon as soon as it is predicted; the reference predicts the whole
    group first. They agree because no CU of a group reads a recon sample
    that another CU of the same group writes: the decoder's schedule puts
    every block an intra, SS or GT prediction reads at an earlier level,
    and a temporal CU reads only the previous picture."""
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


def test_previous_picture_is_the_reference_encoders():
    """The PSS picture's reference, the port encoder's filtered recon of
    the ISS picture, equals the JAX encoder's recon of the same picture,
    so the JAX scans above read a previous picture the reference made."""
    c = _case("gt-cu16-qp37")
    jenc = JaxEncoder(_jax_config(c["cfg"]))
    jenc.encode_frame(*c["frames"][0])
    for a, b, nm in zip(c["ref"], jenc.recon_yuv, ("y", "cb", "cr")):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=nm)


def test_cpu_tensors_run_the_loop():
    """On CPU tensors scan_encode_pss and scan_decode_pss are the level
    loops: they launch no C14 and give the loops' results."""
    c = _case("gt-cu16-qp37")
    before = (ss_scan.SCAN_PSS_ENCODE_LAUNCHES,
              ss_scan.SCAN_PSS_DECODE_LAUNCHES)
    enc = ss_scan.scan_encode_pss(*c["args"], work=c["work"])
    _assert_encode(c, enc, ss_scan.scan_encode_pss_loop(*c["args"]),
                   "scan_encode_pss")
    dec = ss_scan.scan_decode_pss(*c["dargs"], work=c["dwork"])
    for a, b in zip(dec, ss_scan.scan_decode_pss_loop(*c["dargs"])):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (ss_scan.SCAN_PSS_ENCODE_LAUNCHES,
            ss_scan.SCAN_PSS_DECODE_LAUNCHES) == before
