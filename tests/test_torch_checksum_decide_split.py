"""Kernel C1's work list and kernel C5's decide entry against the JAX
reference, exact equality.

C1 cuts the planes into bands of whole rows (``ops/hashes.py``
``band_plan``), a CTA stepping over them, and sums each band in groups of
four columns with the mask formed once a group; ``checksum_bands_plain``
walks that decomposition and must give the JAX ``plane_checksum`` on odd
widths, on strided views of wider buffers (with a base offset: the
kernel's scalar arm), and on one, two and three planes of different sizes.
C5's decide entry runs a thread per 8x8 cell and combines the 16x16 and
32x32 levels from its cells; the decision's inputs here are built from a
few values so that every comparison is an exact float32 tie somewhere
(``nxn8 == cu8``, ``cu == split``, ``cut == cu``), on an odd CTU grid.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import _tie_costs
from hevc_hop_tpu.models import partition as jpart
from hevc_hop_tpu.ops import hashes as jhash
from hevc_hop_torch.models import partition as tpart
from hevc_hop_torch.ops import hashes


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain bodies run many small tensor ops; one thread keeps the
    suite's parallel workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# name -> (plane shapes, view layout): "contiguous" (the 16-byte loads
# where the width is a multiple of 4 samples, else the scalar arm);
# "offset": views of wider, taller buffers from row 1, column 3 (base and
# row stride not multiples of 16 bytes: the scalar arm); "aligned": views
# from the origin of buffers whose rows are a multiple of 4 samples and
# wider than the view (the 16-byte loads, the scalar arm on a row's last
# group where it is narrower than four)
CHECKSUM_CASES = {
    "three-odd": (((34, 66), (17, 33), (17, 33)), "contiguous"),
    "three-offset": (((34, 66), (17, 33), (17, 33)), "offset"),
    "three-aligned": (((34, 66), (17, 33), (17, 33)), "aligned"),
    "two-sizes": (((20, 40), (7, 9)), "offset"),
    "one": (((9, 132),), "contiguous"),
}


def _planes(name, bd):
    shapes, layout = CHECKSUM_CASES[name]
    rng = np.random.default_rng(len(name) + bd)
    planes = []
    for h, w in shapes:
        if layout == "contiguous":
            buf = rng.integers(0, 1 << bd, (h, w))
            view = torch.as_tensor(buf.astype(np.int32))
        elif layout == "offset":
            buf = torch.as_tensor(rng.integers(
                0, 1 << bd, (h + 2, w + 5)).astype(np.int32))
            view = buf[1:1 + h, 3:3 + w]
        else:
            buf = torch.as_tensor(rng.integers(
                0, 1 << bd, (h, (w + 3) // 4 * 4 + 4)).astype(np.int32))
            view = buf[:, :w]
        planes.append(view)
    vec = [layout == "aligned" or (layout == "contiguous" and w % 4 == 0)
           for _, w in shapes]
    return planes, vec


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("name", list(CHECKSUM_CASES))
def test_checksum_band_walk_matches_reference(name, bd):
    planes, vec = _planes(name, bd)
    want = [int(jhash.plane_checksum(jnp.asarray(p.numpy()), bd))
            for p in planes]
    # grids of one CTA, of a few CTAs stepping over many bands each, and
    # of the card's
    for ctas in (1, 5, hashes.WALK_CTAS):
        got, plan = hashes.checksum_bands_plain(planes, bd, ctas)
        assert got == want, (ctas, plan)
        assert plan["vec"] == vec
    assert hashes.plane_checksums(planes, bd) == want
    if len(planes) == 3:
        assert hashes.checksum_digests(*planes, bit_depth=bd) == \
            jhash.checksum_digests(*(p.numpy() for p in planes),
                                   bit_depth=bd)


@pytest.mark.parametrize("shapes, ctas", [
    (((1088, 1920), (544, 960), (544, 960)), 792),
    (((2176, 4096), (1088, 2048), (1088, 2048)), 792),
    (((34, 66), (17, 33), (17, 33)), 5),
    (((3, 1), (1, 5)), 2048)])
def test_band_plan_covers_every_row_once(shapes, ctas):
    """Every row of every plane lies in exactly one band; a band holds at
    least samples / ctas samples, so the bands number about ctas; the grid
    is at most ctas and at most the bands."""
    rows, bands, grid = hashes.band_plan(shapes, ctas)
    total = sum(h * w for h, w in shapes)
    assert 1 <= grid <= min(ctas, max(1, sum(bands)))
    for (h, w), r, nb in zip(shapes, rows, bands):
        assert nb == -(-h // r)
        assert (nb - 1) * r < h <= nb * r
        assert r * w >= -(-total // ctas)
    assert sum(bands) <= ctas + len(shapes)


@pytest.mark.parametrize("qp", [22, 27])
@pytest.mark.parametrize("arm", ["plain", "nxn", "rqt"])
def test_decide_on_exact_ties_matches_reference(arm, qp):
    """On a 5x3 CTU grid: the port's decision (the kernel's plain version
    on the CPU) equals the JAX decide, decide_nxn and decide_rqt cell for
    cell, with NxN against 2Nx2N, the TU split against one TU, and the CU
    against its split each tied exactly somewhere."""
    rng = np.random.default_rng(qp)
    nxn, rqt = arm != "plain", arm == "rqt"
    costs, modes, ties = _tie_costs(rng, 3, 5, tpart._decide_costs(qp),
                                    nxn, rqt)
    assert ties["nxn8 == cu8"] or not nxn, ties
    assert ties["cut16 == cu16"] + ties["cut32 == cu32"] or not rqt, ties
    assert ties["cu16 == split16"] + ties["cu32 == split32"], ties
    rd4, rd8, rd16, rd32, f16, f32_ = costs
    j = [jnp.asarray(a) for a in costs]
    jm = [jnp.asarray(m) for m in modes]
    t = [torch.as_tensor(a) for a in costs]
    tm = [torch.as_tensor(m) for m in modes]
    if arm == "plain":
        want = jpart.decide(*j[1:4], *jm[1:], qp)
        got = tpart.decide(*t[1:4], *tm[1:], qp)
    elif arm == "nxn":
        want = jpart.decide_nxn(*j[:4], *jm, qp)
        got = tpart.decide_nxn(*t[:4], *tm, qp)
    else:
        want = jpart.decide_rqt(*j, *jm, qp)
        got = tpart.decide_rqt(*t, *tm, qp)
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert len(np.unique(got[0].numpy())) >= 2, "the case mixes CU sizes"
