"""The PSS slice on the CPU: the low-delay holoscopic GOP (an ISS picture,
then P pictures whose L0 is [the previous picture, the SS reference]) of
hevc_hop_torch's HoloEncoder against the JAX encoder as it runs, compiled.

- The streams byte for byte, the recon history and the port decoder's
  pictures equal, on test_e2e_iss.py's test_pss_sequence_roundtrip case
  and on the quadtree with SAO, RDOQ (init type 4) and SBH, 32x32 CUs.
- The JAX scan's decisions fed to the port's level loop give the JAX
  planes (ROADMAP.md's first check for float decisions).
- The float forms, each read from the compiled program that runs it: the
  PSS scan sums both searches' convolutions in row-major order, one add
  after another (F10), the pre-pass keeps F8's order in both arms; the
  temporal search's results against the PSS program's own, level by
  level; the pre-pass's temporal arm and decision against the reference.
- The PSS forms of the merge arms, refinements and tournament, and C8's
  masked add-residual form into another plane.
- Lost-reference concealment: the same pictures and ``concealed`` as the
  JAX decoder."""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_hop_tpu.bitstream import nal as jnal
from hevc_hop_tpu.bitstream.bits import rbsp_to_ebsp
from hevc_hop_tpu.common import rom as jrom
from hevc_hop_tpu.common.types import NalUnitType
from hevc_hop_tpu.models import ss_partition as jss_partition
from hevc_hop_tpu.models import ss_scan as jss
from hevc_hop_tpu.models.decoder import Decoder as JaxDecoder
from hevc_hop_tpu.models.ss_encoder import HoloConfig as JaxConfig
from hevc_hop_tpu.models.ss_encoder import HoloEncoder as JaxEncoder
from hevc_hop_torch.common.types import SliceType
from hevc_hop_torch.models import ss_partition, wavefront
from hevc_hop_torch.models.decoder import Decoder
from hevc_hop_torch.models.partition import full_lambda
from hevc_hop_torch.models.ss_encoder import HoloConfig, HoloEncoder
from hevc_hop_torch.ops import inter_arms as ia
from hevc_hop_torch.ops import interp
from hevc_hop_torch.ops import ss_search as ss
from hevc_hop_torch.ops.intra import intra_blocks
from hevc_hop_torch.ops.tq import tq_encode
from hevc_hop_torch.ops.warp import gt_pred_blocks
from test_e2e_iss import synth_lenslet

T = lambda a: torch.as_tensor(np.ascontiguousarray(np.asarray(a)))
LAM = full_lambda(32)
_SCAN_ARGS = ("sizes", "qp", "qp_c", "bit_depth", "strong", "w", "h",
              "radius", "radius_t", "mi_size", "gt", "use_rdoq", "sbh",
              "fixed_mode")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain bodies run many small tensor ops; with the suite's
    parallel workers, a thread pool per worker oversubscribes the cores,
    so this module's worker takes one thread while it runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _panned(y0, cb0, cr0, count):
    """test_pss_sequence_roundtrip's motion model: frame t is the luma
    rolled by t samples plus default_rng(7) noise in [-2, 2], clipped; the
    chroma rolled by t // 2."""
    rng = np.random.default_rng(7)
    h, w = y0.shape
    frames = []
    for t in range(count):
        y = np.roll(y0, t, axis=1) + rng.integers(-2, 3, (h, w))
        frames.append((y.clip(0, 255).astype(np.int32),
                       np.roll(cb0, t // 2, axis=1).astype(np.int32),
                       np.roll(cr0, t // 2, axis=1).astype(np.int32)))
    return frames


def _lenslet(w, h):
    from tools.bdrate import lenslet_frame
    return lenslet_frame(w, h, mi=16, seed=5)


# name -> (first frame, frames, HoloConfig fields); the first is
# test_pss_sequence_roundtrip's own, the second bench.py's lenslet cell at
# 128x96 (its PSS picture codes 32x32 CUs)
CASES = {
    "96x64-gt": (lambda: synth_lenslet(96, 64, 13), 3, dict(
        width=96, height=64, qp=32, cu_log2=4, search_range=24,
        search_range_t=8, mi_size=13, gt=True)),
    "quadtree-sao-rdoq-128x96": (lambda: _lenslet(128, 96), 2, dict(
        width=128, height=96, qp=32, quadtree=True, sao=True, rdoq=True,
        sbh=True, mi_size=16, search_range=32, search_range_t=16,
        gt=True)),
}
_RUNS = {}


def _reference(case):
    """(frames, the JAX encoder after encode_sequence, its stream), once
    per case and worker."""
    if case not in _RUNS:
        first, count, cfg = CASES[case]
        frames = _panned(*first(), count)
        enc = JaxEncoder(JaxConfig(**cfg))
        _RUNS[case] = (frames, enc, enc.encode_sequence(frames))
    return _RUNS[case]


def _same_pictures(got, want, what=""):
    for g, w, name in zip(got, want, ("y", "cb", "cr")):
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")


@pytest.mark.parametrize("case", list(CASES))
def test_pss_stream_matches_reference_and_decodes(case):
    frames, ref_enc, ref = _reference(case)
    cfg = CASES[case][2]
    enc = HoloEncoder(HoloConfig(**cfg), device="cpu")
    got = enc.encode_sequence(frames)
    assert got == ref
    assert len(enc.recon_history) == len(frames)
    for i, (g, w) in enumerate(zip(enc.recon_history,
                                   ref_enc.recon_history)):
        _same_pictures(g, w, f"recon {i}")
    m = enc.last_maps
    assert ((m.pred4 == 0) & (m.ref4 == 0)).mean() > 0.3, \
        "temporal prediction never chosen"
    if case.startswith("quadtree"):
        assert (m.tu4 == 5).any(), "no 32x32 CU in the PSS picture"
        assert enc.cfg.rdoq and m.slice_type == int(SliceType.PSS)
    dec = Decoder(device="cpu")
    pics = dec.decode_stream(got)
    assert dec.hash_ok == [True] * len(frames)
    assert dec.concealed == []
    for i, (p, r) in enumerate(zip(pics, enc.recon_history)):
        _same_pictures(p, r, f"decoded {i}")


def _pss_scan_inputs(case):
    """The JAX encoder's inputs to scan_encode_pss for the case's second
    picture (after its ISS picture), and the port's packed plans of the
    same partition."""
    frames, _, _ = _reference(case)
    cfg = CASES[case][2]
    jenc = JaxEncoder(JaxConfig(**cfg))
    jenc.encode_frame(*frames[0])
    y, cb, cr = frames[1]
    (sizes, data, zmaxw, zmax2n, xs, _), mode4 = jenc._frame_prep(
        y, ref_y=np.asarray(jenc.recon_yuv[0]))
    if mode4 is not None:
        xs = jenc._xs_with_modes(xs, data, sizes, mode4)
    org = jenc._upload(y, cb, cr)
    ref = tuple(jnp.asarray(p, jnp.int32) for p in jenc._recon_dev)
    args = org + ref + (xs, zmaxw, zmax2n)
    kws = dict(sizes=sizes, qp=cfg["qp"],
               qp_c=jrom.chroma_qp_from_luma(cfg["qp"]), bit_depth=8,
               strong=True, w=cfg["width"], h=cfg["height"],
               radius=cfg["search_range"], radius_t=cfg["search_range_t"],
               mi_size=cfg["mi_size"], gt=cfg["gt"], use_rdoq=cfg["rdoq"],
               sbh=cfg["sbh"], fixed_mode=mode4 is not None)
    return jenc, data, args, kws


def test_reference_pss_decisions_give_the_reference_planes():
    """The JAX PSS scan's per-block decisions (inter, reference index, MV,
    intra mode, GT flag and corners) fed to the port's level loop: C2, or
    C8 out of the recon (SS) or the previous picture (temporal), C11 for
    GT, then C3 with RDOQ's PSS init type and SBH, luma and chroma. The
    port's recon and level planes equal the JAX scan's."""
    case = "quadtree-sao-rdoq-128x96"
    jenc, data, args, kws = _pss_scan_inputs(case)
    ry, rcb, rcr, cy, ccb, ccr, outs = jss.scan_encode_pss(*args, **kws)
    w, h, qp = kws["w"], kws["h"], kws["qp"]
    dec = {}
    for lg in kws["sizes"]:
        o = [np.asarray(a) for a in outs[lg]]
        valid = data[lg]["valid"]
        for p, i, r, m, mo, f, g in zip(data[lg]["pos"][valid], o[0][valid],
                                        o[1][valid], o[2][valid],
                                        o[3][valid], o[7][valid],
                                        o[8][valid]):
            dec[(int(p[0]), int(p[1]))] = (bool(i), int(r), m, int(mo),
                                           int(f), g.reshape(6))
    assert any(v[0] and v[1] == 0 for v in dec.values()), "no temporal CU"
    enc = HoloEncoder(HoloConfig(**CASES[case][2]), device="cpu")
    leaves = wavefront.leaves_from_depth(jenc._depth8, w, h, 5)
    plans, nsteps = enc._prep(leaves, key="given")[:2]
    oy, oc = enc._upload(*_reference(case)[0][1])
    hc, hc_off = h // 2, h // 2 + 32
    ref_y = T(np.asarray(args[3])).to(torch.int32)
    ref_c = torch.zeros_like(oc)
    ref_c[:hc] = T(np.asarray(args[4]))
    ref_c[hc_off:hc_off + hc] = T(np.asarray(args[5]))
    pry, prc = torch.zeros_like(oy), torch.zeros_like(oc)
    pcy = torch.zeros(oy.shape, dtype=torch.int16)
    pcc = torch.zeros(oc.shape, dtype=torch.int16)
    qp_c = kws["qp_c"]
    rcfg = ((4, LAM), (4, LAM * 2.0 ** ((qp_c - qp) / 3.0)))
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
            use_ss = torch.tensor([v[0] and v[1] == 1 for v in d]).to(
                torch.int32)
            use_t = inter.to(torch.int32) - use_ss
            mv = torch.tensor(np.stack([v[2] for v in d]), dtype=torch.int32)
            imode = torch.tensor([v[3] for v in d], dtype=torch.int32)
            gtf = torch.tensor([v[4] for v in d], dtype=torch.int32)
            gtc = torch.tensor(np.stack([v[5] for v in d]),
                               dtype=torch.int32)
            pred, _ = intra_blocks(pry, pos, p.avail[sl], imode, n, 0)
            interp.mc_blocks(pry, pos, mv, n, False, h, out=pred,
                             only=use_ss)
            interp.mc_blocks(ref_y, pos, mv, n, False, h, out=pred,
                             only=use_t)
            gt_pred_blocks(pry, pos, mv, gtc, n, False, h, out=pred,
                           only=gtf)
            smode = torch.where(inter, 0, imode).to(torch.int32)
            tq_encode(oy, pred, pos, smode, n, 0, qp, 8, True, rcfg[0], pry,
                      pcy)
            cpos = p.cpos[2 * o:2 * o + 2 * c]
            cpred, _ = intra_blocks(prc, cpos, p.cavail[sl], imode, n // 2, 1)
            interp.mc_blocks(prc, cpos, mv, n // 2, True, hc, 8, hc_off,
                             out=cpred, only=use_ss)
            interp.mc_blocks(ref_c, cpos, mv, n // 2, True, hc, 8, hc_off,
                             out=cpred, only=use_t)
            gt_pred_blocks(prc, cpos, mv, gtc, n // 2, True, hc, 8, hc_off,
                           out=cpred, only=gtf)
            tq_encode(oc, cpred, cpos, smode, n // 2, 1, qp_c, 8, True,
                      rcfg[1], prc, pcc)
    np.testing.assert_array_equal(pry.numpy()[:h], np.asarray(ry)[:h])
    np.testing.assert_array_equal(pcy.numpy()[:h], np.asarray(cy)[:h])
    for got, want in ((prc[:hc], rcb), (prc[hc_off:hc_off + hc], rcr)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:hc])
    for got, want in ((pcc[:hc], ccb), (pcc[hc_off:hc_off + hc], ccr)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:hc])


# ---------------------------------------------------------------------------
# The float forms, read from the compiled programs that run them: copies of
# the reference's functions whose only change is that they also return the
# searches' correlation and ref^2 maps, compiled as the reference compiles
# them.

def _instrumented(fn_names, replaces):
    """The reference's ss_scan/ss_partition namespace with the named
    functions re-made from their source, each text replaced as given."""
    ns = dict(jss.__dict__)
    ns.update(jss_partition.__dict__)
    ns["ss_scan"] = jss
    for mod, name in fn_names:
        fn = getattr(mod, name)
        src = inspect.getsource(getattr(fn, "__wrapped__", fn))
        for a, b in replaces:
            src = src.replace(a, b)
        exec(compile(src, f"<instrumented {name}>", "exec"), ns)
    return ns


_T_RET = ("    return jnp.stack([mvx, mvy], -1), best, pred, sse_best",
          "    return (jnp.stack([mvx, mvy], -1), best, pred, sse_best, corr,"
          " ref2, win)")
_SS_RET = ("    if zmax2n is None:\n        zero2",
           "    global _SSX\n    _SSX = (corr, ref2, win)\n"
           "    if zmax2n is None:\n        zero2")
_SCAN_FORMS = {}


def _scan_forms():
    """The PSS program's temporal and SS search maps of every 32x32 level
    of the quadtree case, with the program's own temporal results."""
    if _SCAN_FORMS:
        return _SCAN_FORMS
    case = "quadtree-sao-rdoq-128x96"
    _, data, args, kws = _pss_scan_inputs(case)
    ns = _instrumented(
        [(jss, "_t_search"), (jss, "_ss_search"), (jss, "scan_encode_pss")],
        [_T_RET, _SS_RET,
         ("            mv_ti, _, tpred0, tsse0 = _t_search(",
          "            ssx = _SSX\n"
          "            mv_ti, tbest, tpred0, tsse0, tcorr, tref2, twin = "
          "_t_search("),
         ("            outs[log2] = (inter, refsel, mv, imode, cbf, cbf_b, "
          "cbf_r,\n                          gtflag, gtc)",
          "            outs[log2] = (inter, refsel, mv, imode, cbf, cbf_b, "
          "cbf_r,\n                          gtflag, gtc, tcorr, tref2, "
          "twin, org, mv_ti, tbest, tsse0, p_t) + ssx")])
    scan = jax.jit(ns["scan_encode_pss"], static_argnames=_SCAN_ARGS)
    out = scan(*args, **kws)
    real = jss.scan_encode_pss(*args, **kws)
    # the instrumented program decides as the reference does
    for lg in kws["sizes"]:
        for a, b in zip(out[6][lg][:9], real[6][lg]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(out[0]), np.asarray(real[0]))
    for lg in kws["sizes"]:
        v = data[lg]["valid"]
        o = [np.asarray(a)[v] for a in out[6][lg][9:]]
        _SCAN_FORMS[lg] = dict(zip(
            ("tcorr", "tref2", "twin", "org", "mv_t", "tcost", "tsse", "p_t",
             "scorr", "sref2", "swin"), o), pos=data[lg]["pos"][v])
    _SCAN_FORMS["kws"] = kws
    _SCAN_FORMS["ref"] = np.asarray(args[3])
    return _SCAN_FORMS


def _prepass_forms():
    """The pre-pass program's (``_ss_rd_size`` with the temporal arm) maps
    of both arms on every 32x32 block of the quadtree case's PSS
    picture."""
    frames = _reference("quadtree-sao-rdoq-128x96")[0]
    y, ref = frames[1][0], frames[0][0]
    h, w = y.shape
    ns = _instrumented(
        [(jss, "_t_search"), (jss, "_ss_search"),
         (jss_partition, "_ss_rd_size")],
        [_T_RET, _SS_RET,
         ("ss_scan._t_search(", "_t_search("),
         ("ss_scan._ss_search(", "_ss_search("),
         ("        mv_t, tcost, tpred, tsse = _t_search(",
          "        ssx = _SSX\n"
          "        mv_t, tcost, tpred, tsse, tcorr, tref2, twin = _t_search("),
         ("    return jnp.where(best_cost < jnp.float32(1e37), out, "
          "jnp.float32(3e38))",
          "    return (jnp.where(best_cost < jnp.float32(1e37), out, "
          "jnp.float32(3e38)), tcorr, tref2, twin, org) + ssx")])
    f = jax.jit(ns["_ss_rd_size"], static_argnames=(
        "n", "qp", "bit_depth", "radius", "radius_t", "w", "h", "mi_size",
        "temporal"))
    n = 32
    pos, zcur, zmaxw = _grid(w, h, n)
    args = (jnp.asarray(y), jnp.asarray(ref), pos, zcur, zmaxw)
    kw = dict(n=n, qp=32, bit_depth=8, radius=32, radius_t=16, w=w, h=h,
              mi_size=16, temporal=True)
    out = f(*args, **kw)
    np.testing.assert_array_equal(np.asarray(out[0]), np.asarray(
        jss_partition._ss_rd_size(*args, **kw)))
    return dict(zip(("tcorr", "tref2", "twin", "org", "scorr", "sref2",
                     "swin"), (np.asarray(a) for a in out[1:])))


def _grid(w, h, n):
    zplane4 = wavefront.zaddr4_plane(w, h, 5)
    ys = (np.arange(h // n) * n)[:, None].repeat(w // n, 1).ravel()
    xs = (np.arange(w // n) * n)[None, :].repeat(h // n, 0).ravel()
    pos = np.stack([xs, ys], -1).astype(np.int32)
    zcur = zplane4[ys >> 2, xs >> 2].astype(np.int32)
    return pos, zcur, jss.zmax_win_px(zplane4, n)


def _port_maps(win, org, seq):
    """The port's (corr, ref2) of windows [B, W, W] against blocks
    [B, n, n] in conv_sum's order."""
    n = org.shape[-1]
    d = win.shape[-1] - n + 1
    wf, of = T(win).float(), T(org).float()
    return (ss.conv_sum(wf, of, n, d, seq),
            ss.conv_sum(wf * wf, torch.ones_like(of), n, d, seq))


@pytest.mark.parametrize("program,arm", [
    ("scan", "t"), ("scan", "s"), ("prepass", "t"), ("prepass", "s")])
def test_search_sum_forms_match_compiled_program(program, arm):
    """F10: inside the compiled PSS scan both searches' correlation and
    ref^2 are row-major sequential sums (``conv_sum(seq=True)``); inside
    the pre-pass program with its temporal arm both arms keep F8's blocked
    order. Each bit for bit on every 32x32 map of the quadtree case (its
    sums pass 2^24), and the other order differs on the same maps."""
    maps = (_scan_forms()[5] if program == "scan" else _prepass_forms())
    seq = program == "scan"
    win = maps[f"{arm}win"]
    org = maps["org"]
    corr, ref2 = _port_maps(win, org, seq)
    np.testing.assert_array_equal(corr.numpy(), maps[f"{arm}corr"])
    np.testing.assert_array_equal(ref2.numpy(), maps[f"{arm}ref2"])
    assert (ref2.numpy() >= 2 ** 24).any(), "no sum passes 2^24"
    other = _port_maps(win, org, not seq)
    assert (other[1].numpy() != maps[f"{arm}ref2"]).any()


@pytest.mark.parametrize("lg", [4, 5])
def test_t_search_matches_compiled_program(lg):
    """t_search_plain on the PSS program's own inputs (the previous
    picture, the block, its temporal predictors) gives the program's
    temporal MV, cost and SSE, level by level (16x16 sums are exact; the
    32x32 ones hold F10's order)."""
    forms = _scan_forms()
    if lg not in forms:
        pytest.skip(f"no {1 << lg}x{1 << lg} CU in the PSS picture")
    m, kws = forms[lg], forms["kws"]
    n = 1 << lg
    org = np.zeros((kws["h"] + 32, kws["w"]), np.int32)
    for (x, y), blk in zip(m["pos"], m["org"]):
        org[y:y + n, x:x + n] = blk
    got = ss.t_search_plain(T(forms["ref"]), T(org), T(m["pos"]),
                            T(m["p_t"]), n, kws["radius_t"], kws["w"],
                            kws["h"], LAM)
    np.testing.assert_array_equal(got[0].numpy(), m["mv_t"])
    np.testing.assert_array_equal(got[1].numpy(), m["tcost"])
    np.testing.assert_array_equal(got[3].numpy(), m["tsse"])
    assert (m["tcost"] < 1e37).all()


@pytest.mark.parametrize("n", [8, 16, 32])
def test_prepass_temporal_arm_matches_reference(n):
    """The pre-pass's inter cost with the temporal arm (the reference's
    ``_ss_rd_size``, temporal=True, compiled): the level rate's log2 is
    torch's against the reference's (F1), so costs agree within 1e-6
    relative, the blocks with no valid displacement exactly; and the
    temporal arm is what wins most blocks."""
    frames = _reference("quadtree-sao-rdoq-128x96")[0]
    y, ref = frames[1][0], frames[0][0]
    h, w = y.shape
    pos, zcur, zmaxw = _grid(w, h, n)
    want = np.asarray(jss_partition._ss_rd_size(
        jnp.asarray(y), jnp.asarray(ref), pos, zcur, zmaxw, n, 32, 8, 32, 16,
        w, h, 16, True))
    got = ss_partition.ss_rd_costs(T(y), T(pos), T(zcur), T(zmaxw), n, 32, 8,
                                   32, w, h, 16, LAM, T(ref), 16).numpy()
    ss_only = ss_partition.ss_rd_costs(T(y), T(pos), T(zcur), T(zmaxw), n,
                                       32, 8, 32, w, h, 16, LAM).numpy()
    big = want > 1e37
    np.testing.assert_array_equal(got[big], want[big])
    np.testing.assert_allclose(got[~big], want[~big], rtol=1e-6)
    assert (got < ss_only).mean() > 0.5


def test_prepass_decide_with_reference_matches():
    frames = _reference("quadtree-sao-rdoq-128x96")[0]
    y, ref = frames[1][0], frames[0][0]
    want_d, want_m = jss_partition.decide(y, 32, 5, 32, 16, 8, ref, 16)
    got_d, got_m = ss_partition.decide(T(y), 32, 5, 32, 16, 8, T(ref), 16)
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_m, want_m)
    assert (want_d == 0).any(), "no 32x32 CU"


# ---------------------------------------------------------------------------
# The PSS arms: merge candidates on either plane, the two refinements and
# the tournament, against the reference's jitted functions.

def _pss_planes_case(n, seed):
    """Recon (the picture so far) and a previous picture, an original
    close to both, random carried motion naming either reference, and
    blocks from the second CTU row on."""
    rng = np.random.default_rng(seed)
    w, h = 128, 128
    y, _, _ = synth_lenslet(w, h, 13, seed=seed)
    recon = np.zeros((h + 32, w), np.int32)
    recon[:h] = y
    ref = np.clip(np.roll(y, 1, axis=1) + rng.integers(-2, 3, y.shape), 0,
                  255).astype(np.int32)
    org = recon.copy()
    org[:h] = np.clip(y + rng.normal(0, 3.0, y.shape), 0, 255)
    zplane = wavefront.zaddr4_plane(w, h, 5)
    ys = np.arange(64 if n == 32 else 48, h - n + 1, n)
    xs = np.arange(64 if n == 32 else 40 // n * n, w - n + 1, n)
    pos = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2).astype(np.int32)
    zcur = zplane[pos[:, 1] >> 2, pos[:, 0] >> 2].astype(np.int32)
    zmaxw = jss.zmax_win_px(zplane, n)
    shape4 = (recon.shape[0] // 4, w // 4)
    inter = rng.random(shape4) < 0.7
    motion = (np.where(inter, rng.integers(-80, 20, shape4), 0),
              np.where(inter, rng.integers(-12, 12, shape4), 0),
              inter.astype(np.int32),
              np.where(inter, rng.integers(0, 2, shape4), 0))
    motion = tuple(m.astype(np.int32) for m in motion)
    nbav = rng.random((len(pos), 5)) < 0.8
    miav = rng.random((len(pos), 3)) < 0.7
    return recon, ref, org, pos, zcur, zmaxw, motion, nbav, miav, w, h


@pytest.mark.parametrize("n", [8, 16, 32])
def test_pss_arms_match_reference(n):
    """_gather_cands with the SS reference last (its temporal predictors
    too), _merge_arms over both planes, _frac_refine on each plane with
    its predictors, all jitted, against the port's plain versions; and
    inter_arms_plain's PSS form against scan_encode_pss's tournament
    (ss_scan.py:982-1003) written out on those results."""
    (recon, ref, org, pos, zcur, zmaxw, motion, nbav, miav, w,
     h) = _pss_planes_case(n, 40 + n)
    mi, rad, rad_t = 13, 24, 8
    ar = np.arange(n)
    blocks = org[pos[:, 1, None, None] + ar[None, :, None],
                 pos[:, 0, None, None] + ar[None, None, :]]
    of = blocks.astype(np.float32)
    want_c = jax.jit(jss._gather_cands, static_argnums=(7, 8, 9))(
        *motion, pos, nbav, miav, n, mi, 1)
    got_c = ia.gather_cands(*(T(m) for m in motion), T(pos), T(nbav),
                            T(miav), n, mi, 1)
    for g, r_ in zip(got_c, want_c):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r_))
    cands, cref, cvalid, p_ss, p_t = (np.asarray(a) for a in want_c)
    assert (cvalid & (cref == 0)).any() and (cvalid & (cref == 1)).any()
    merge = jax.jit(jss._merge_arms, static_argnums=(9, 10, 11, 12, 13, 14))(
        recon, ref, of, pos, zcur, zmaxw, cands, cref, cvalid, 1, n, w, h, 8,
        LAM)
    got_m = ia.merge_arms_plain(T(recon), T(of), T(pos), T(zcur), T(zmaxw),
                                T(cands), T(cvalid), n, w, h, 8, LAM, T(ref),
                                T(cref), 1)
    for g, r_ in zip(got_m, merge):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r_))
    search = jax.jit(jss._ss_search, static_argnames=("n", "radius", "w",
                                                      "h"))
    s_rate = jss._dyn_rate_map(jnp.asarray(p_ss), rad, LAM)
    mv_i, _, pred0, sse0 = search(recon, blocks, pos, zcur, zmaxw, s_rate,
                                  n=n, radius=rad, w=w, h=h)[:4]
    t_rate = jss._dyn_rate_map(jnp.asarray(p_t), rad_t, LAM)
    mv_t, _, tpred0, tsse0 = jax.jit(jss._t_search, static_argnums=(
        4, 5, 6, 7))(ref, blocks, pos, t_rate, n, rad_t, w, h)
    refine = jax.jit(jss._frac_refine, static_argnums=(7, 8, 9, 10))
    want_s = refine(recon, of, pos, np.asarray(mv_i) * 4, pred0, sse0, p_ss,
                    n, h, 8, LAM)
    want_t = refine(ref, of, pos, np.asarray(mv_t) * 4, tpred0, tsse0, p_t,
                    n, h, 8, LAM)
    for pl, mv0, pr0, s0, pp, want in (
            (recon, mv_i, pred0, sse0, p_ss, want_s),
            (ref, mv_t, tpred0, tsse0, p_t, want_t)):
        got = ia.frac_refine_plain(T(pl), T(of), T(pos), T(np.asarray(mv0)
                                                           * 4),
                                   T(pr0), T(s0), T(pp), n, h, 8, LAM)
        for g, r_ in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r_))
    # the tournament against a planar intra prediction
    ipred = np.full(blocks.shape, 128, np.int32)
    icost = ia.intra_cost(T(blocks), T(ipred), LAM)
    mcost, mmv, mref, mpred = (np.asarray(a) for a in merge)
    sscost, tcost = np.asarray(want_s[3]), np.asarray(want_t[3])
    ss_beats_t = sscost < tcost
    intercost = np.minimum(sscost, tcost)
    merge_win = (mcost < intercost) & (mcost < icost.numpy())
    amvp_win = ~merge_win & (intercost < icost.numpy())
    mv = np.where(merge_win[:, None], mmv,
                  np.where(ss_beats_t[:, None], want_s[0], want_t[0]))
    refsel = np.where(merge_win, mref, np.where(ss_beats_t, 1, 0))
    pred = np.where(merge_win[:, None, None], mpred, np.where(
        amvp_win[:, None, None], np.where(ss_beats_t[:, None, None],
                                          want_s[1], want_t[1]), ipred))
    buf = T(ipred).clone()
    inter, gmv, smode, costs, grefsel = ia.inter_arms_plain(
        T(recon), T(org), T(pos), T(zcur), T(zmaxw),
        tuple(T(m) for m in motion), T(nbav), T(miav), T(np.asarray(mv_i)),
        T(pred0), T(sse0), buf, torch.zeros(len(pos), dtype=torch.int32), n,
        w, h, 8, LAM, mi, pss=(T(ref), T(np.asarray(mv_t)), T(tpred0),
                               T(tsse0)))
    on = merge_win | amvp_win
    np.testing.assert_array_equal(inter.numpy(), on)
    np.testing.assert_array_equal(gmv.numpy(), mv)
    np.testing.assert_array_equal(grefsel.numpy(), refsel)
    np.testing.assert_array_equal(buf.numpy(), pred)
    np.testing.assert_array_equal(
        costs.numpy(), np.stack([icost.numpy(), mcost, sscost, tcost], -1))
    assert (on & (refsel == 0)).any(), "no temporal winner"


def test_mc_blocks_masked_residual_into_another_plane():
    """C8's decode form for a PSS picture's temporal blocks: the blocks
    ``only`` selects read one plane and write clip(pred + resi) into
    another; the others are left."""
    rng = np.random.default_rng(3)
    src = T(rng.integers(0, 256, (72, 64)).astype(np.int32))
    dst = T(rng.integers(0, 256, (72, 64)).astype(np.int32))
    resi = T(rng.integers(-40, 40, (72, 64)).astype(np.int32))
    pos = torch.tensor([[0, 0], [16, 16], [32, 48], [48, 0]],
                       dtype=torch.int32)
    mv = torch.tensor([[5, -3], [-9, 2], [0, 0], [7, 7]], dtype=torch.int32)
    only = torch.tensor([1, 0, 1, 1], dtype=torch.int32)
    want = dst.clone()
    pred = interp.luma_mc(src, pos, mv, 16, 64)
    for i in range(4):
        if only[i]:
            x, y = pos[i].tolist()
            want[y:y + 16, x:x + 16] = torch.clamp(
                pred[i] + resi[y:y + 16, x:x + 16], 0, 255)
    keep = src.clone()
    interp.mc_blocks(src, pos, mv, 16, False, 64, resi=resi, only=only,
                     dst=dst)
    np.testing.assert_array_equal(dst.numpy(), want.numpy())
    np.testing.assert_array_equal(src.numpy(), keep.numpy())


def test_lost_reference_concealment_matches_reference():
    """tests/test_sei_ext.py's lost IDR: the ISS+PSS stream with its IDR
    slice dropped. The port decoder conceals with a mid-grey picture, as
    the JAX decoder does: the same pictures, ``concealed`` and hash
    results (the PSS picture's hash fails, honestly)."""
    w, h = 64, 64
    rng = np.random.default_rng(4)
    y = rng.integers(0, 256, (h, w)).astype(np.int32)
    cb = np.full((h // 2, w // 2), 128, np.int32)
    cr = np.full((h // 2, w // 2), 128, np.int32)
    cfg = dict(width=w, height=h, qp=32, mi_size=16, gt=False,
               search_range=8)
    frames = [(y, cb, cr), (np.clip(y + 1, 0, 255), cb, cr)]
    full = JaxEncoder(JaxConfig(**cfg)).encode_sequence(frames)
    assert HoloEncoder(HoloConfig(**cfg),
                       device="cpu").encode_sequence(frames) == full
    kept = []
    for (t, rbsp) in jnal.annexb_split(full):
        if t == int(NalUnitType.IDR_W_RADL):
            continue
        kept.append(b"\x00\x00\x00\x01" + bytes([(t << 1) & 0xFF, 1])
                    + rbsp_to_ebsp(rbsp))
    broken = b"".join(kept)
    ref = JaxDecoder()
    want = ref.decode_stream(broken)
    dec = Decoder(device="cpu")
    got = dec.decode_stream(broken)
    assert dec.concealed == ref.concealed == [0]
    assert dec.hash_ok == ref.hash_ok and dec.hash_ok[-1] is False
    assert len(got) == len(want) == 2
    for i, (g, r) in enumerate(zip(got, want)):
        _same_pictures(g, r, f"picture {i}")
