"""Kernel C13, the whole-frame intra wavefront as one launch, on the CPU.

C13 (hevc_hop_torch/csrc/scan.cu) runs only on the card. What it does is
held here in two parts: its work list (models/wavefront_scan.py
work_list) covers every block of the level loop exactly once, level by
level, with no empty level; and a plain emulation that walks the work
list item by item, as a C13 CTA does (luma prediction, transform and
recon, then cb and cr), in the kernel's order and again reversed within
each level, gives bit for bit what the level loop and the JAX reference's
``scan_encode`` and ``scan_decode`` give: recon planes, level planes,
modes and cbfs. The cases: uniform CUs at cu_log2 3, 4 and 5 with the
in-loop RMD, the production quadtree (NxN, the residual quadtree, RDOQ,
SBH) and a 10-bit frame.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_hop_tpu.models import wavefront_scan as jws
from hevc_hop_torch.common import rom
from hevc_hop_torch.models import wavefront_scan as ws
from hevc_hop_torch.models.encoder import EncoderConfig, IntraEncoder
from hevc_hop_torch.models.partition import full_lambda
from hevc_hop_torch.ops.intra import intra_blocks_plain
from hevc_hop_torch.ops.tq import tq_encode_plain
from test_e2e_intra import synth_frame

CASES = {
    "cu8-rmd": (64, 64, dict(qp=32, cu_log2=3, rdoq=False)),
    "cu16-rmd": (64, 64, dict(qp=32, cu_log2=4, rdoq=False)),
    "cu32-rmd": (64, 64, dict(qp=32, cu_log2=5, rdoq=False)),
    # the RD pre-pass with NxN, the residual quadtree, RDOQ and SBH on a
    # frame of noise, texture and edges: TUs of every size, 4x4 carriers
    "production": (128, 64, dict(qp=17)),
    "main10": (64, 64, dict(qp=27, bit_depth=10, cu_log2=4)),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain bodies run many small tensor ops; with the suite's
    parallel workers, a thread pool per worker oversubscribes the cores,
    so this module's worker takes one thread while it runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frame(name, w, h, bit_depth):
    y, cb, cr = synth_frame(w, h, seed=len(name), kind="mix")
    if name == "production":
        y, _, _ = synth_frame(w, h, seed=1, kind="edges")
        noise, _, _ = synth_frame(w, h, seed=2, kind="noise")
        mix, _, _ = synth_frame(w, h, seed=3, kind="mix")
        y = y.copy()
        y[:32, :32] = noise[:32, :32]
        y[32:, :32] = mix[32:, :32]
    if bit_depth == 10:
        y, cb, cr = (p.astype(np.int32) * 4 + 1 for p in (y, cb, cr))
    return y, cb, cr


@functools.lru_cache(maxsize=None)
def _case(name):
    """The scan's inputs as IntraEncoder hands them over on the CPU: the
    padded planes, the schedule and the given modes (None: RMD)."""
    w, h, kw = CASES[name]
    cfg = EncoderConfig(width=w, height=h, **kw)
    y, cb, cr = _frame(name, w, h, cfg.bit_depth)
    enc = IntraEncoder(cfg, device="cpu")
    pad = 1 << cfg.ctb_log2
    hc, hc_off = h // 2, h // 2 + pad
    org_y = torch.zeros((h + pad, w), dtype=torch.int32)
    org_y[:h] = torch.as_tensor(y)
    org_c = torch.zeros((2 * hc_off, w // 2), dtype=torch.int32)
    org_c[:hc] = torch.as_tensor(cb)
    org_c[hc_off:hc_off + hc] = torch.as_tensor(cr)
    depth8, mode4, tulog8 = enc._decide(org_y[:h], None)
    sched = enc._schedule(depth8, tulog8)
    modes = None if mode4 is None else enc._given_modes(sched, mode4)
    return dict(cfg=cfg, w=w, h=h, hc_off=hc_off, org_y=org_y, org_c=org_c,
                sched=sched, mode4=mode4, modes=modes,
                qp_c=rom.chroma_qp_from_luma(cfg.qp))


def _loop_encode(c):
    cfg = c["cfg"]
    return ws.scan_encode(c["org_y"], c["org_c"], c["sched"].plans,
                          c["sched"].nsteps, cfg.qp, c["qp_c"],
                          cfg.bit_depth, cfg.strong_intra_smoothing, cfg.sbh,
                          c["modes"], use_rdoq=cfg.rdoq, init_type=2)


@functools.lru_cache(maxsize=None)
def _loop(name):
    """The level loop's encode, and its decode of a seeded residual with
    the encode's modes."""
    c = _case(name)
    enc = _loop_encode(c)
    resi_y, resi_c, modes, cmodes = _decode_inputs(name, enc)
    dec = ws.scan_decode(resi_y, resi_c, c["sched"].plans, c["sched"].nsteps,
                         modes, cmodes, c["cfg"].bit_depth,
                         c["cfg"].strong_intra_smoothing)
    return enc, dec


def _decode_inputs(name, enc):
    """A seeded residual for every plane, the luma modes the encode chose
    and the chroma modes it coded, in the plans' packed order."""
    c = _case(name)
    rng = np.random.default_rng(len(name))
    lim = 40 << (c["cfg"].bit_depth - 8)
    resi_y = torch.as_tensor(rng.integers(-lim, lim + 1, c["org_y"].shape),
                             dtype=torch.int32)
    resi_c = torch.as_tensor(rng.integers(-lim, lim + 1, c["org_c"].shape),
                             dtype=torch.int32)
    modes, cmodes = {}, {}
    for log2, p in c["sched"].plans.items():
        modes[log2] = enc[4][log2][0]
        given = c["modes"][log2][1] if c["modes"] is not None else None
        cmodes[log2] = (given if given is not None else
                        modes[log2][torch.as_tensor(p.cidx, dtype=torch.long)])
    return resi_y, resi_c, modes, cmodes


def _items(work, reverse):
    """The work list's items level by level, each level's in the kernel's
    order or reversed."""
    for s in range(len(work.host_off) - 1):
        items = work.host_items[work.host_off[s]:work.host_off[s + 1]]
        yield from (items[::-1] if reverse else items)


def _emulate_encode(c, reverse):
    """C13's encode entry, item by item, on the plain bodies."""
    cfg, plans, work = c["cfg"], c["sched"].plans, c["sched"].work
    org_y, org_c, modes = c["org_y"], c["org_c"], c["modes"]
    bd, strong = cfg.bit_depth, cfg.strong_intra_smoothing
    lam = full_lambda(cfg.qp)
    rq_y = (2, lam) if cfg.rdoq else None
    rq_c = (2, lam * 2.0 ** ((c["qp_c"] - cfg.qp) / 3.0)) if cfg.rdoq else None
    ry, rc = torch.zeros_like(org_y), torch.zeros_like(org_c)
    coef_y = torch.zeros(org_y.shape, dtype=torch.int16)
    coef_c = torch.zeros(org_c.shape, dtype=torch.int16)
    outs = {lg: tuple(torch.full((k,), -9, dtype=torch.int32)
                      for k in (len(p.vpos), len(p.vpos), 2 * len(p.cidx)))
            for lg, p in plans.items()}
    ask = torch.full((1,), -1, dtype=torch.int32)
    for log2, row, crow, cb_row, cr_row in _items(work, reverse):
        p = plans[log2]
        pos, av = p.pos[row:row + 1], p.avail[row:row + 1]
        if modes is None:
            pred, best = intra_blocks_plain(ry, pos, av, ask, p.n, 0, bd,
                                            strong, org=org_y)
        else:
            best = modes[log2][0][row:row + 1]
            pred, _ = intra_blocks_plain(ry, pos, av, best, p.n, 0, bd,
                                         strong)
        cbf = tq_encode_plain(org_y, pred, pos, best, p.n, 0, cfg.qp, bd,
                              cfg.sbh, rq_y, ry, coef_y)
        outs[log2][0][row], outs[log2][1][row] = best[0], cbf[0]
        if crow < 0:
            continue
        cmode = best
        if modes is not None and modes[log2][1] is not None:
            cmode = modes[log2][1][crow:crow + 1]
        nc = 4 if log2 == 2 else p.n // 2
        for r in (cb_row, cr_row):
            cpos = p.cpos[r:r + 1]
            predc, _ = intra_blocks_plain(rc, cpos, p.cavail[crow:crow + 1],
                                          cmode, nc, 1, bd, strong)
            outs[log2][2][r] = tq_encode_plain(
                org_c, predc, cpos, cmode, nc, 1, c["qp_c"], bd, cfg.sbh,
                rq_c, rc, coef_c)[0]
    return ry, rc, coef_y, coef_c, outs


def _emulate_decode(c, resi_y, resi_c, modes, cmodes, reverse):
    """C13's decode entry, item by item, on C2's plain body."""
    cfg, plans = c["cfg"], c["sched"].plans
    bd, strong = cfg.bit_depth, cfg.strong_intra_smoothing
    ry, rc = torch.zeros_like(resi_y), torch.zeros_like(resi_c)
    for log2, row, crow, cb_row, cr_row in _items(c["sched"].work, reverse):
        p = plans[log2]
        intra_blocks_plain(ry, p.pos[row:row + 1], p.avail[row:row + 1],
                           modes[log2][row:row + 1], p.n, 0, bd, strong,
                           resi=resi_y)
        if crow < 0:
            continue
        for r in (cb_row, cr_row):
            intra_blocks_plain(rc, p.cpos[r:r + 1], p.cavail[crow:crow + 1],
                               cmodes[log2][crow:crow + 1],
                               4 if log2 == 2 else p.n // 2, 1, bd, strong,
                               resi=resi_c)
    return ry, rc


def _jax_xs(c, dec_modes=None):
    """The JAX scan's xs from the reference's own build_schedule of the
    same transform blocks, as its encoder builds them, or with
    ``dec_modes`` = (modes, cmodes) in the plans' packed order, as its
    decoder does."""
    cfg, sched = c["cfg"], c["sched"]
    sizes, data, _ = jws.build_schedule(sched.leaves, c["w"], c["h"],
                                        cfg.ctb_log2)
    assert tuple(sizes) == tuple(sched.plans)
    xs = {}
    for log2 in sizes:
        d = data[log2]
        valid = d["valid"]
        px = np.where(valid, d["pos"][..., 0], 0)
        py = np.where(valid, d["pos"][..., 1], 0)
        common = (jnp.asarray(d["pos"]), jnp.asarray(d["avail"]),
                  jnp.asarray(d["availc"]))
        if dec_modes is not None:
            m = np.zeros(valid.shape, np.int32)
            m[valid] = dec_modes[0][log2].numpy()
            cm = np.zeros(valid.shape, np.int32)
            cm[valid & _carriers(log2, d)] = dec_modes[1][log2].numpy()
            xs[log2] = common + (jnp.asarray(m), jnp.asarray(cm))
            continue
        if c["mode4"] is None:
            m = np.full(valid.shape, -1, np.int32)
        else:
            m = np.where(valid, c["mode4"][py // 4, px // 4], 0)
        xs[log2] = common + (jnp.asarray(m.astype(np.int32)),)
        if log2 == 2:
            cm = np.where(valid, c["mode4"][(py // 8) * 2, (px // 8) * 2], 0)
            xs[log2] = xs[log2] + (jnp.asarray(cm.astype(np.int32)),)
    return sizes, data, xs


def _carriers(log2, d):
    """The slots of build_schedule's data that carry chroma."""
    if log2 != 2:
        return np.ones(d["valid"].shape, bool)
    pos = d["pos"]
    return (pos[..., 0] % 8 == 4) & (pos[..., 1] % 8 == 4)


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The JAX scan_encode on the case, and scan_decode on the same
    seeded residual and the encode's modes; as numpy, packed in the port's
    order."""
    c = _case(name)
    cfg, h, hc_off = c["cfg"], c["h"], c["hc_off"]
    sizes, data, xs = _jax_xs(c)
    ry, rc, coef_y, coef_c, _, _, outs = jws.scan_encode(
        jnp.asarray(c["org_y"].numpy()), jnp.asarray(c["org_c"].numpy()), xs,
        sizes=sizes, qp=cfg.qp, qp_c=c["qp_c"], bit_depth=cfg.bit_depth,
        strong=cfg.strong_intra_smoothing, h=h, hc_off=hc_off,
        use_rdoq=cfg.rdoq, init_type=2, sbh=cfg.sbh,
        rmd=c["mode4"] is None)
    packed = {}
    for log2 in sizes:
        d = data[log2]
        valid, car = d["valid"], d["valid"] & _carriers(log2, d)
        best, cbf, cbf_c = (np.asarray(a) for a in outs[log2])
        b = valid.shape[1]
        cc = np.concatenate([np.concatenate([cbf_c[s, :b][car[s]],
                                             cbf_c[s, b:][car[s]]])
                             for s in range(valid.shape[0])])
        packed[log2] = (best[valid], cbf[valid].astype(np.int32),
                        cc.astype(np.int32))
    enc = (np.asarray(ry), np.asarray(rc), np.asarray(coef_y),
           np.asarray(coef_c), packed)
    resi_y, resi_c, modes, cmodes = _decode_inputs(name, _loop(name)[0])
    hcp = c["org_c"].shape[0] // 2
    _, _, dxs = _jax_xs(c, (modes, cmodes))
    dy, dcb, dcr = jws.scan_decode(
        jnp.asarray(resi_y.numpy()), jnp.asarray(resi_c[:hcp].numpy()),
        jnp.asarray(resi_c[hcp:].numpy()), dxs, sizes=sizes,
        bit_depth=cfg.bit_depth, strong=cfg.strong_intra_smoothing, h=h)
    return enc, (np.asarray(dy), np.asarray(dcb), np.asarray(dcr))


def _planes(c, ry, rc):
    """The real regions of a luma and a stacked chroma plane."""
    h, hc_off = c["h"], c["hc_off"]
    ry, rc = np.asarray(ry), np.asarray(rc)
    return ry[:h], rc[:h // 2], rc[hc_off:hc_off + h // 2]


def _assert_encode_equal(c, got, want, what):
    for a, b, nm in zip(_planes(c, got[0], got[1]),
                        _planes(c, want[0], want[1]), ("ry", "rcb", "rcr")):
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {nm}")
    for a, b, nm in zip(_planes(c, got[2], got[3]),
                        _planes(c, want[2], want[3]),
                        ("coef_y", "coef_cb", "coef_cr")):
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {nm}")
    assert set(got[4]) == set(want[4])
    for log2 in want[4]:
        for a, b, nm in zip(got[4][log2], want[4][log2],
                            ("best", "cbf_y", "cbf_c")):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f"{what}: {nm} {log2}")


@pytest.mark.parametrize("name", CASES)
def test_work_list_covers_each_level_once(name):
    """Each non-empty level of the loop holds, in the work list, exactly
    the loop's blocks of that level (every size), each with its chroma
    pair where the loop codes one (at 4x4 only the NxN carriers), and no
    level of the work list is empty."""
    c = _case(name)
    plans, work = c["sched"].plans, c["sched"].work
    off = work.host_off
    assert off[0] == 0 and off[-1] == len(work.host_items)
    assert (np.diff(off) > 0).all(), "an empty level costs a barrier"
    assert work.widest == int(np.diff(off).max())
    levels = [s for s in range(c["sched"].nsteps)
              if any(p.cnt[s] for p in plans.values())]
    assert len(levels) == len(off) - 1 < c["sched"].nsteps
    for k, s in enumerate(levels):
        got = {tuple(int(v) for v in it)
               for it in work.host_items[off[k]:off[k + 1]]}
        assert len(got) == off[k + 1] - off[k]
        want = set()
        for log2, p in plans.items():
            cc, co = int(p.ccnt[s]), int(p.coff[s])
            crows = {int(p.cidx[co // 2 + j]): co // 2 + j
                     for j in range(cc)}
            for row in range(int(p.off[s]), int(p.off[s] + p.cnt[s])):
                tc = crows.get(row, -1)
                if tc < 0:
                    want.add((log2, row, -1, -1, -1))
                    continue
                j = tc - co // 2
                want.add((log2, row, tc, co + j, co + cc + j))
        assert got == want, f"level {s}"
    assert (2 in plans) == (name == "production")
    if name == "production":
        assert set(plans) == {2, 3, 4, 5}
        assert 0 < len(plans[2].cidx) < len(plans[2].vpos)


@pytest.mark.parametrize("reverse", [False, True],
                         ids=["kernel-order", "reversed"])
@pytest.mark.parametrize("name", CASES)
def test_work_list_emulation_matches_loop_and_reference(name, reverse):
    """C13's item walk, on the plain bodies, in the kernel's order and
    reversed within each level: encode and decode equal the level loop's
    and the JAX scan_encode's and scan_decode's, bit for bit."""
    c = _case(name)
    loop_enc, loop_dec = _loop(name)
    ref_enc, ref_dec = _reference(name)
    got = _emulate_encode(c, reverse)
    _assert_encode_equal(c, got, loop_enc, "against the level loop")
    _assert_encode_equal(c, got, ref_enc, "against the JAX scan_encode")
    resi_y, resi_c, modes, cmodes = _decode_inputs(name, loop_enc)
    dy, dc = _emulate_decode(c, resi_y, resi_c, modes, cmodes, reverse)
    for a, b, nm in zip(_planes(c, dy, dc), _planes(c, *loop_dec),
                        ("y", "cb", "cr")):
        np.testing.assert_array_equal(a, b, err_msg=f"decode {nm}, loop")
    h = c["h"]
    for a, b, nm in zip(_planes(c, dy, dc),
                        (ref_dec[0][:h], ref_dec[1][:h // 2],
                         ref_dec[2][:h // 2]), ("y", "cb", "cr")):
        np.testing.assert_array_equal(a, b, err_msg=f"decode {nm}, JAX")


def test_cpu_tensors_run_the_loop():
    """On CPU tensors scan_encode and scan_decode are the level loop: they
    launch no C13 and give the loop's results."""
    c = _case("cu16-rmd")
    before = (ws.SCAN_ENCODE_LAUNCHES, ws.SCAN_DECODE_LAUNCHES)
    enc = _loop_encode(c)
    _assert_encode_equal(c, enc, _loop("cu16-rmd")[0], "scan_encode")
    assert (ws.SCAN_ENCODE_LAUNCHES, ws.SCAN_DECODE_LAUNCHES) == before
