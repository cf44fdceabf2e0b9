"""Kernel C13's banded form, the mesh encode as one launch, on the CPU.

On a virtual mesh on the card, MeshIntraEncoder codes every (frame, band)
cell's slab, stacked into one plane, in one launch of C13 over the work
list of the banded plans, with a halo table: the block whose bottom row is
its band's last row also writes that row into the next band's halo
(parallel/shard_encode.py ``halo_table``). What it does is held here:

- the work list covers every real slot of ``build_banded_schedule`` once,
  level by level;
- every halo destination is the next band's row 0 (luma, cb) or hcoff
  (cr) of the same frame, set exactly where a block ends on its band's
  last row, never from a frame's last band;
- a plain emulation that walks the items as a C13 CTA does (luma, cb, cr,
  each block's recon then its bottom row into the halo), in the kernel's
  order and reversed within each level, equals bit for bit the level loop
  with its halo refresh after every level (``scan_encode_loop`` with
  ``after_level``): recon, levels, modes and cbfs; and with the emulation
  in place of the scan, MeshIntraEncoder writes the JAX MeshIntraEncoder's
  streams (whose slice data carries the levels, modes and cbfs) and recon
  on the same mesh of the 8 virtual host devices of tests/conftest.py.

Cases: (2, 2) and (1, 4) meshes, 8x8 and 16x16 CUs, one 10-bit.
"""
import functools

import numpy as np
import pytest
import torch

from hevc_hop_tpu.models.encoder import EncoderConfig as JaxConfig
from hevc_hop_tpu.parallel import shard_encode as jshard
from hevc_hop_torch.common import rom
from hevc_hop_torch.common.types import SliceType
from hevc_hop_torch.models import wavefront_scan as ws
from hevc_hop_torch.models.encoder import EncoderConfig
from hevc_hop_torch.models.partition import full_lambda
from hevc_hop_torch.ops.intra import intra_blocks_plain
from hevc_hop_torch.ops.tq import tq_encode_plain
from hevc_hop_torch.parallel import shard_encode

# name -> (mesh (frames, bands), width, height, EncoderConfig fields)
CASES = {
    "2x2-64x64-cu8": ((2, 2), 64, 64, dict(cu_log2=3)),
    "2x2-128x64-cu16-10bit": ((2, 2), 128, 64, dict(cu_log2=4,
                                                    bit_depth=10)),
    "1x4-64x128-cu16": ((1, 4), 64, 128, dict(cu_log2=4)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain bodies run many small tensor ops; with the suite's
    parallel workers, a thread pool per worker oversubscribes the cores,
    so this module's worker takes one thread while it runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _kw(name):
    (_, _), w, h, extra = CASES[name]
    return dict(width=w, height=h, qp=30, sao=False, **extra)


def _frames(name):
    (nf, _), w, h, extra = CASES[name]
    rng = np.random.default_rng(len(name))
    top = 1 << extra.get("bit_depth", 8)
    # smooth ramps with noise: the RMD picks modes other than DC
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for f in range(nf):
        base = (xx * (3 + f) + yy * 2) % top
        noise = rng.integers(0, top // 8, (h, w))
        y = ((base + noise) % top).astype(np.int32)
        cb = rng.integers(0, top, (h // 2, w // 2)).astype(np.int32)
        cr = ((yy[::2, ::2] * 5) % top).astype(np.int32)
        out.append((y, cb, cr))
    return out


@functools.lru_cache(maxsize=None)
def _case(name):
    """The encoder on a virtual CPU mesh, its layout and banded plans, the
    stacked originals, the work list and its halo table."""
    (nf, nb), *_ = CASES[name]
    mesh = shard_encode.make_mesh(nf * nb, band_par=nb, device="cpu")
    assert mesh.virtual and mesh.shape == (nf, nb)
    enc = shard_encode.MeshIntraEncoder(EncoderConfig(**_kw(name)), mesh)
    lay, plans, _, nsteps, _ = enc._build()
    org_y, org_c = enc.slabs(_frames(name), lay)
    work = ws.work_list(plans, "cpu")
    halo = shard_encode.halo_table(work, plans, lay, nb)
    return dict(enc=enc, lay=lay, plans=plans, nsteps=nsteps, org_y=org_y,
                org_c=org_c, work=work, halo=halo)


def _scan_kw(enc):
    cfg = enc.cfg
    return dict(qp=cfg.qp, qp_c=rom.chroma_qp_from_luma(cfg.qp),
                bit_depth=cfg.bit_depth,
                strong=cfg.strong_intra_smoothing, sbh=cfg.sbh,
                use_rdoq=cfg.rdoq, init_type=int(SliceType.I))


@functools.lru_cache(maxsize=None)
def _loop(name):
    """The level loop with the virtual mesh's halo refresh after every
    level: C13's plain version for the mesh."""
    c = _case(name)
    k = _scan_kw(c["enc"])
    return ws.scan_encode_loop(
        c["org_y"], c["org_c"], c["plans"], c["nsteps"], k["qp"], k["qp_c"],
        k["bit_depth"], k["strong"], k["sbh"], None, use_rdoq=k["use_rdoq"],
        init_type=k["init_type"],
        after_level=c["enc"]._halo_refresh(c["lay"]))


@functools.lru_cache(maxsize=None)
def _jax(name):
    """The JAX MeshIntraEncoder's streams and recon on the same mesh."""
    (nf, nb), *_ = CASES[name]
    ref = jshard.MeshIntraEncoder(JaxConfig(**_kw(name)),
                                  jshard.make_mesh(nf * nb, band_par=nb))
    streams = ref.encode_frames(_frames(name))
    return streams, [tuple(np.asarray(p) for p in r)
                     for r in ref.last_recons]


def emulate_banded(org_y, org_c, plans, work, halo, qp, qp_c, bit_depth,
                   strong, sbh, use_rdoq, init_type, reverse=False):
    """C13's banded encode, item by item, on the plain bodies: per item the
    luma block (the RMD, the transform round trip, the recon), then cb and
    cr with the luma's mode; after each block's recon its bottom row goes
    into the halo row the table gives. Levels in order, each level's items
    in the kernel's order or reversed. Returns scan_encode's results."""
    lam = full_lambda(qp)
    rq_y = (init_type, lam) if use_rdoq else None
    rq_c = ((init_type, lam * 2.0 ** ((qp_c - qp) / 3.0)) if use_rdoq
            else None)
    ry, rc = torch.zeros_like(org_y), torch.zeros_like(org_c)
    coef_y = torch.zeros(org_y.shape, dtype=torch.int16)
    coef_c = torch.zeros(org_c.shape, dtype=torch.int16)
    outs = {lg: tuple(torch.full((k,), -9, dtype=torch.int32)
                      for k in (len(p.vpos), len(p.vpos), 2 * len(p.cidx)))
            for lg, p in plans.items()}
    ask = torch.full((1,), -1, dtype=torch.int32)

    def to_halo(plane, pos, n, row):
        if row >= 0:
            x, y = int(pos[0, 0]), int(pos[0, 1])
            plane[row, x:x + n] = plane[y + n - 1, x:x + n]

    for s in range(len(work.host_off) - 1):
        lo, hi = work.host_off[s], work.host_off[s + 1]
        order = range(hi - 1, lo - 1, -1) if reverse else range(lo, hi)
        for i in order:
            log2, row, crow, cb_row, cr_row = work.host_items[i]
            p = plans[log2]
            pos, av = p.pos[row:row + 1], p.avail[row:row + 1]
            pred, best = intra_blocks_plain(ry, pos, av, ask, p.n, 0,
                                            bit_depth, strong, org=org_y)
            cbf = tq_encode_plain(org_y, pred, pos, best, p.n, 0, qp,
                                  bit_depth, sbh, rq_y, ry, coef_y)
            to_halo(ry, pos, p.n, int(halo[i, 0]))
            outs[log2][0][row], outs[log2][1][row] = best[0], cbf[0]
            if crow < 0:
                continue
            nc = 4 if log2 == 2 else p.n // 2
            for k, r in ((1, cb_row), (2, cr_row)):
                cpos = p.cpos[r:r + 1]
                predc, _ = intra_blocks_plain(
                    rc, cpos, p.cavail[crow:crow + 1], best, nc, 1,
                    bit_depth, strong)
                outs[log2][2][r] = tq_encode_plain(
                    org_c, predc, cpos, best, nc, 1, qp_c, bit_depth, sbh,
                    rq_c, rc, coef_c)[0]
                to_halo(rc, cpos, nc, int(halo[i, k]))
    return ry, rc, coef_y, coef_c, outs


def _equal(got, want):
    for g, w_, nm in zip(got[:4], want[:4], ("ry", "rc", "coef_y",
                                             "coef_c")):
        assert torch.equal(g, w_), nm
    assert got[4].keys() == want[4].keys()
    for log2 in want[4]:
        for g, w_, nm in zip(got[4][log2], want[4][log2],
                             ("modes", "cbf_y", "cbf_c")):
            assert torch.equal(g, w_), f"{nm} {1 << log2}x{1 << log2}"


@pytest.mark.parametrize("name", list(CASES))
def test_work_list_covers_every_banded_slot_once_per_level(name):
    c = _case(name)
    lay, plans, work = c["lay"], c["plans"], c["work"]
    nb = c["enc"].nbands
    w, h = c["enc"].cfg.width, c["enc"].cfg.height
    depth8 = np.full((h // 8, w // 8), c["enc"].cfg.ctb_log2
                     - c["enc"].cfg.cu_log2, np.uint8)
    from hevc_hop_torch.models import wavefront
    leaves = wavefront.leaves_from_depth(depth8, w, h, c["enc"].cfg.ctb_log2)
    sizes, data, nsteps, hb = shard_encode.build_banded_schedule(
        leaves, w, h, c["enc"].cfg.ctb_log2, nb)
    assert len(work.host_off) - 1 == nsteps
    for s in range(nsteps):
        items = work.host_items[work.host_off[s]:work.host_off[s + 1]]
        got = sorted((int(lg), *map(int, plans[lg].vpos[row]))
                     for lg, row, *_ in items)
        want = []
        for log2 in sizes:
            d = data[log2]
            for ci, (f, r) in enumerate(lay.cells):
                for b in np.nonzero(d["valid"][s, r])[0]:
                    x, y = d["pos"][s, r, b]
                    want.append((log2, int(x), int(y) + ci * lay.slab))
        assert got == sorted(want), f"level {s}"
        # every item names its chroma pair
        assert (items[:, 2] >= 0).all()


@pytest.mark.parametrize("name", list(CASES))
def test_halo_destinations_are_the_next_bands_rows(name):
    c = _case(name)
    lay, plans, work, halo = c["lay"], c["plans"], c["work"], c["halo"]
    nb = c["enc"].nbands
    cell_of = {cl: i for i, cl in enumerate(lay.cells)}
    seen = np.zeros((len(lay.cells), 3), np.int64)
    for i, (log2, row, crow, cb_row, cr_row) in enumerate(work.host_items):
        p = plans[log2]
        n, nc = p.n, p.n // 2
        y = int(p.vpos[row, 1])
        ci = y // lay.slab
        f, r = lay.cells[ci]
        last = r + 1 == nb
        nxt = None if last else cell_of[(f, r + 1)]
        cy = p.cpos[[cb_row, cr_row], 1].numpy() - ci * lay.cslab
        ends = (y - ci * lay.slab + n - 1 == lay.hb,
                int(cy[0]) + nc - 1 == lay.hcb,
                int(cy[1]) + nc - 1 == lay.hcoff + lay.hcb)
        dest = (None if last else nxt * lay.slab,
                None if last else nxt * lay.cslab,
                None if last else nxt * lay.cslab + lay.hcoff)
        for k in range(3):
            if ends[k] and not last:
                assert halo[i, k] == dest[k], (i, k)
                seen[ci, k] += 1
            else:
                assert halo[i, k] == -1, (i, k)
    for ci, (f, r) in enumerate(lay.cells):
        n = c["enc"].cfg.width >> c["enc"].cfg.cu_log2
        # a band's bottom row of blocks, luma and chroma, once each
        assert tuple(seen[ci]) == ((0, 0, 0) if r + 1 == nb else (n,) * 3)


def _banded_encode(name):
    """MeshIntraEncoder with the emulation in the scan's place: (streams,
    recons, the emulation's scan results)."""
    c = _case(name)
    box = {}

    def banded(org_y, org_c, plans, nsteps, qp, qp_c, bit_depth, strong,
               sbh, modes, use_rdoq, init_type, after_level):
        assert modes is None and after_level is not None
        box["scan"] = emulate_banded(org_y, org_c, plans, c["work"],
                                     c["halo"], qp, qp_c, bit_depth, strong,
                                     sbh, use_rdoq, init_type)
        return box["scan"]

    saved = ws.scan_encode
    ws.scan_encode = banded
    try:
        streams = c["enc"].encode_frames(_frames(name))
    finally:
        ws.scan_encode = saved
    return streams, c["enc"].last_recons, box["scan"]


@pytest.mark.parametrize("reverse", [False, True], ids=["order", "reversed"])
@pytest.mark.parametrize("name", list(CASES))
def test_emulation_equals_level_loop_and_reference(name, reverse):
    c = _case(name)
    if reverse:
        _equal(emulate_banded(c["org_y"], c["org_c"], c["plans"], c["work"],
                              c["halo"], reverse=True,
                              **_scan_kw(c["enc"])), _loop(name))
        return
    streams, recons, scan = _banded_encode(name)
    _equal(scan, _loop(name))
    want, jrecons = _jax(name)
    assert streams == want
    for f, rec in enumerate(jrecons):
        for g, r, nm in zip(recons[f], rec, ("y", "cb", "cr")):
            np.testing.assert_array_equal(g.numpy(), r, err_msg=nm)
