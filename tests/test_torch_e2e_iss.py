"""The lenslet ISS slice as a whole on the CPU: hevc_hop_torch's HoloEncoder
against the JAX encoder, byte-identical AnnexB streams and equal recon, on
test_e2e_iss.py's configurations with the GT warp off and on (GT engaged
on warped content), and in the two regions of the search's float sums that
F8 left untested (10-bit samples, search_range 40); the JAX scan's own
decisions, GT ones included, fed to the port's level loop give the JAX
recon and levels; the port's Decoder on those streams and on the committed
JAX ISS fixtures, which its encoder also writes byte for byte; PSS
pictures raise."""
import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

from hevc_hop_tpu.common import rom as jrom
from hevc_hop_tpu.models import ss_scan as jss
from hevc_hop_tpu.models.decoder import Decoder as JaxDecoder
from hevc_hop_tpu.models.ss_encoder import HoloConfig as JaxConfig
from hevc_hop_tpu.models.ss_encoder import HoloEncoder as JaxEncoder
from hevc_hop_torch.models import ss_scan, wavefront
from hevc_hop_torch.models.decoder import Decoder
from hevc_hop_torch.models.ss_encoder import HoloConfig, HoloEncoder
from hevc_hop_torch.ops import interp
from hevc_hop_torch.ops.intra import intra_blocks
from hevc_hop_torch.ops.tq import tq_encode
from hevc_hop_torch.ops.warp import gt_pred_blocks
from test_e2e_iss import synth_lenslet, synth_warped_lenslet

FIXTURES = pathlib.Path(__file__).parent / "torch_fixtures"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain bodies run many small tensor ops; with the suite's
    parallel workers, a thread pool per worker oversubscribes the cores,
    so this module's worker takes one thread while it runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same_pictures(got, want):
    for g, w, name in zip(got, want, ("y", "cb", "cr")):
        np.testing.assert_array_equal(g, w, err_msg=name)


# test_e2e_iss.py's cases, GT off: the three round trips, the quadtree,
# deblocking off; and SAO on, RDOQ off
CASES = {
    "96x64-cu16": (96, 64, dict(cu_log2=4, qp=32, mi_size=13,
                                search_range=32)),
    "64x64-cu8": (64, 64, dict(cu_log2=3, qp=27, mi_size=8,
                               search_range=24)),
    "128x96-cu16-qp37": (128, 96, dict(cu_log2=4, qp=37, mi_size=15,
                                       search_range=32)),
    "quadtree": (128, 96, dict(quadtree=True, qp=32, mi_size=13,
                               search_range=32)),
    "no-deblock": (64, 64, dict(cu_log2=4, qp=30, mi_size=13,
                                search_range=24, deblocking=False)),
    "quadtree-sao": (128, 96, dict(quadtree=True, sao=True, qp=32,
                                   mi_size=13, search_range=32)),
    "rdoq-off": (96, 64, dict(cu_log2=4, qp=32, mi_size=13,
                              search_range=32, rdoq=False)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_iss_stream_matches_reference_and_decodes(case):
    w, h, kw = CASES[case]
    seed = {"quadtree": 7, "no-deblock": 9}.get(case, w + kw["qp"])
    y, cb, cr = synth_lenslet(w, h, kw["mi_size"], seed=seed)
    cfg = dict(width=w, height=h, gt=False, **kw)
    ref_enc = JaxEncoder(JaxConfig(**cfg))
    ref = ref_enc.encode_frame(y, cb, cr)
    enc = HoloEncoder(HoloConfig(**cfg), device="cpu")
    got = enc.encode_frame(y, cb, cr)
    assert got == ref
    _same_pictures(enc.recon_yuv, ref_enc.recon_yuv)
    assert set(enc.last_stats) >= {"decide_s", "scan_s", "loopfilter_s",
                                   "sao_s", "entropy_s", "total_s", "bytes",
                                   "levels"}
    assert (enc.last_maps.pred4 == 0).any(), "no SS or merge CU"
    dec = Decoder(device="cpu")
    (frame,) = dec.decode_stream(got)
    assert dec.hash_ok == [True]
    _same_pictures(frame, enc.recon_yuv)
    if case in ("quadtree-sao", "no-deblock"):
        jdec = JaxDecoder()
        (jframe,) = jdec.decode_stream(ref)
        _same_pictures(frame, jframe)


def test_reference_decisions_give_the_reference_planes():
    """The JAX scan's per-block decisions (inter, MV, intra mode) fed to the
    port's level loop (C2 or C8 prediction, then C3 with RDOQ and SBH),
    with the decisions' own float costs never computed: the port's recon
    and level planes equal the JAX scan's, luma and chroma."""
    _feed_reference_decisions(synth_lenslet(128, 96, 13, seed=7), 13,
                              gt=False)


def test_reference_gt_decisions_give_the_reference_planes():
    """The same with the GT warp on, on warped content: the JAX scan's GT
    flags and corners too, its GT blocks predicted by C11's plane entries
    (luma, and chroma over the C2/C8 prediction)."""
    n_gt = _feed_reference_decisions(synth_warped_lenslet(128, 96, 16,
                                                          seed=6), 16,
                                     gt=True)
    assert n_gt >= 5


def _feed_reference_decisions(frame, mi, gt):
    """Feed the JAX scan's decisions (quadtree, 128x96, QP 32) to the
    port's level loop and compare the planes; returns the GT block
    count."""
    w, h = 128, 96
    y, cb, cr = frame
    jcfg = JaxConfig(width=w, height=h, qp=32, quadtree=True, mi_size=mi,
                     search_range=32, gt=gt)
    jenc = JaxEncoder(jcfg)
    (sizes, data, zmaxw, zmax2n, xs, _), mode4 = jenc._frame_prep(y)
    xs = jenc._xs_with_modes(xs, data, sizes, mode4)
    org_y, org_cb, org_cr = jenc._upload(y, cb, cr)
    qp, qp_c = 32, jrom.chroma_qp_from_luma(32)
    ry, rcb, rcr, cy, ccb, ccr, outs = jss.scan_encode_iss(
        org_y, org_cb, org_cr, xs, zmaxw, zmax2n, sizes=sizes, qp=qp,
        qp_c=qp_c, bit_depth=8, strong=True, w=w, h=h, radius=32,
        mi_size=mi, gt=gt, use_rdoq=True, sbh=True, fixed_mode=True)
    dec = {}
    for lg in sizes:
        inter, mv, imode = (np.asarray(a) for a in outs[lg][:3])
        gtf, gtc = (np.asarray(a) for a in outs[lg][6:8])
        valid = data[lg]["valid"]
        for p, i, m, mo, f, g in zip(data[lg]["pos"][valid], inter[valid],
                                     mv[valid], imode[valid], gtf[valid],
                                     gtc[valid]):
            dec[(int(p[0]), int(p[1]))] = (bool(i), m, int(mo), bool(f),
                                           g.reshape(6))
    assert any(v[0] for v in dec.values())

    # the port's level loop with the decisions given
    enc = HoloEncoder(HoloConfig(**{k: getattr(jcfg, k) for k in (
        "width", "height", "qp", "quadtree", "mi_size", "search_range",
        "gt")}), device="cpu")
    leaves = wavefront.leaves_from_depth(jenc._depth8, w, h, 5)
    plans, nsteps = enc._prep(leaves, key="given")[:2]
    oy, oc = enc._upload(y, cb, cr)
    hc, hc_off = h // 2, h // 2 + 32
    pry, prc = torch.zeros_like(oy), torch.zeros_like(oc)
    pcy = torch.zeros(oy.shape, dtype=torch.int16)
    pcc = torch.zeros(oc.shape, dtype=torch.int16)
    lam = ss_scan.full_lambda(qp)
    rcfg = ((3, lam), (3, lam * 2.0 ** ((qp_c - qp) / 3.0)))
    n_gt = 0
    for s in range(nsteps):
        for lg, p in plans.items():
            c = int(p.cnt[s])
            if c == 0:
                continue
            o, n = int(p.off[s]), p.n
            sl = slice(o, o + c)
            pos = p.pos[sl]
            d = [dec[(int(a), int(b))] for a, b in p.vpos[sl]]
            inter = torch.tensor([v[0] for v in d])
            mv = torch.tensor(np.stack([v[1] for v in d]), dtype=torch.int32)
            imode = torch.tensor([v[2] for v in d], dtype=torch.int32)
            gtf = torch.tensor([v[3] for v in d], dtype=torch.int32)
            gtc = torch.tensor(np.stack([v[4] for v in d]),
                               dtype=torch.int32)
            n_gt += int(gtf.sum())
            pred, _ = intra_blocks(pry, pos, p.avail[sl], imode, n, 0)
            mc = interp.mc_blocks(pry, pos, mv, n, False, h)
            pred = torch.where(inter[:, None, None], mc, pred)
            if gt:
                gt_pred_blocks(pry, pos, mv, gtc, n, False, h, out=pred,
                               only=gtf)
            smode = torch.where(inter, 0, imode).to(torch.int32)
            tq_encode(oy, pred, pos, smode, n, 0, qp, 8, True, rcfg[0], pry,
                      pcy)
            cpos = p.cpos[2 * o:2 * o + 2 * c]
            cpred, _ = intra_blocks(prc, cpos, p.cavail[sl], imode, n // 2, 1)
            interp.mc_blocks(prc, cpos, mv, n // 2, True, hc, 8, hc_off,
                             out=cpred, only=inter.to(torch.int32))
            if gt:
                gt_pred_blocks(prc, cpos, mv, gtc, n // 2, True, hc, 8,
                               hc_off, out=cpred, only=gtf)
            tq_encode(oc, cpred, cpos, smode, n // 2, 1, qp_c, 8, True,
                      rcfg[1], prc, pcc)
    np.testing.assert_array_equal(pry.numpy()[:h], np.asarray(ry)[:h])
    np.testing.assert_array_equal(pcy.numpy()[:h], np.asarray(cy)[:h])
    for got, want in ((prc[:hc], rcb), (prc[hc_off:hc_off + hc], rcr)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:hc])
    for got, want in ((pcc[:hc], ccb), (pcc[hc_off:hc_off + hc], ccr)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:hc])
    return n_gt


def _fixture(name):
    stream = (FIXTURES / f"{name}.bin").read_bytes()
    meta = json.loads((FIXTURES / f"{name}.json").read_text())
    return stream, meta


def _lenslet_frame(w, h, mi, seed):
    from tools.bdrate import lenslet_frame
    return lenslet_frame(w, h, mi=mi, seed=seed)


def _fixture_frame(meta):
    cfg = HoloConfig(**meta["config"])
    if "synth_warped_lenslet" in meta["content"]:
        return synth_warped_lenslet(cfg.width, cfg.height, 16,
                                    seed=meta["seed"])
    return _lenslet_frame(cfg.width, cfg.height, 16, meta["seed"])


@pytest.mark.parametrize("name", ["jax_iss_128x96_qp32",
                                  "jax_iss_quadtree_sao_128x96_qp32",
                                  "jax_iss_gt_96x64_qp37"])
def test_port_decodes_and_writes_reference_iss_fixture(name):
    stream, meta = _fixture(name)
    dec = Decoder(device="cpu")
    (planes,) = dec.decode_stream(stream)
    assert dec.hash_ok == [True]
    md5 = {k: hashlib.md5(p.astype(np.uint8).tobytes()).hexdigest()
           for k, p in zip(("y", "cb", "cr"), planes)}
    assert md5 == meta["md5"]
    cfg = HoloConfig(**meta["config"])
    enc = HoloEncoder(cfg, device="cpu")
    assert enc.encode_frame(*_fixture_frame(meta)) == stream
    assert bool(enc.last_maps.gt8.any()) == cfg.gt


def test_unported_lenslet_parts_raise():
    """PSS pictures (slice 4) are not ported: encode_sequence refuses two
    frames, naming ROADMAP.md (one frame is its ISS picture)."""
    enc = HoloEncoder(HoloConfig(), device="cpu")
    frame = synth_lenslet(64, 64, 13)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        enc.encode_sequence([frame, frame])


# GT on (the reference's default): test_e2e_iss.py's GT configuration, the
# quadtree with SAO, and 10-bit samples, on warped lenslet content (seed),
# where GT engages; encode_sequence of the one frame
GT_CASES = {
    "96x64-cu16-qp37": (96, 64, 5, 8, dict(cu_log2=4, qp=37)),
    "quadtree-sao-128x96": (128, 96, 6, 8, dict(quadtree=True, sao=True,
                                                 qp=32)),
    "10bit-96x64-cu16": (96, 64, 5, 10, dict(cu_log2=4, qp=37)),
}


@pytest.mark.parametrize("case", list(GT_CASES))
def test_gt_stream_matches_reference_and_decodes(case):
    w, h, seed, bd, kw = GT_CASES[case]
    y, cb, cr = synth_warped_lenslet(w, h, 16, seed=seed)
    if bd == 10:
        y, cb, cr = (p * 4 for p in (y, cb, cr))
    cfg = dict(width=w, height=h, mi_size=16, search_range=32, gt=True,
               bit_depth=bd, **kw)
    ref_enc = JaxEncoder(JaxConfig(**cfg))
    ref = ref_enc.encode_frame(y, cb, cr)
    enc = HoloEncoder(HoloConfig(**cfg), device="cpu")
    got = enc.encode_sequence([(y, cb, cr)])
    assert got == ref
    _same_pictures(enc.recon_history[0], ref_enc.recon_yuv)
    assert int(enc.last_maps.gt8.sum()) >= 1, "GT never chosen"
    np.testing.assert_array_equal(enc.last_maps.gtv8, ref_enc.last_maps.gtv8)
    dec = Decoder(device="cpu")
    (frame,) = dec.decode_stream(got)
    assert dec.hash_ok == [True]
    _same_pictures(frame, enc.recon_yuv)


# the regions of the SS search's float32 sums that F8 left untested: 10-bit
# samples (sums pass 2^24 from 8x8; the bench's content x 4) and a radius
# of 40, at which 32x32 displacements are causal (the quadtree); the GT on
F8_CASES = {
    "10bit-96x64-cu16": (96, 64, 128, dict(cu_log2=4, bit_depth=10)),
    "quadtree-128x96-sr40": (128, 96, 7, dict(quadtree=True,
                                              search_range=40)),
}


@pytest.mark.parametrize("case", list(F8_CASES))
def test_search_sum_regions_match_reference(case):
    w, h, seed, kw = F8_CASES[case]
    y, cb, cr = synth_lenslet(w, h, 13, seed=seed)
    if kw.get("bit_depth") == 10:
        y, cb, cr = (p * 4 for p in (y, cb, cr))
    cfg = dict(dict(width=w, height=h, qp=32, mi_size=13, search_range=32),
               **kw)
    ref = JaxEncoder(JaxConfig(**cfg)).encode_frame(y, cb, cr)
    enc = HoloEncoder(HoloConfig(**cfg), device="cpu")
    assert enc.encode_frame(y, cb, cr) == ref
    assert (enc.last_maps.pred4 == 0).any(), "no SS or merge CU"
    if case.startswith("quadtree"):
        assert (enc.last_maps.tu4 == 5).any(), "no 32x32 CU"


def test_holo_config_matches_reference():
    import dataclasses
    assert dataclasses.asdict(HoloConfig()) == dataclasses.asdict(
        JaxConfig())
