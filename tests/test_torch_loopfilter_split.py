"""The loop filters' one-launch forms (kernels C4 and C6) against the JAX
reference, exact equality.

C4 runs a picture as tiles of 32x32 luma samples, each staged with a halo
of 4 samples, its vertical edges filtered on every staged row, then its
horizontal edges on its own columns: ``ops/deblock.py``
``deblock_tiles_plain`` walks that decomposition (at other tile sizes
too, with edges on the tile borders and partial last tiles) and must give
the jitted ``deblock_frame``'s two picture-wide passes. C6 takes a
picture's three planes in one launch each way: the three-plane forms
(packed statistics, packed parameters), ``stats_dispatch`` with its
one-copy fetch, and ``apply_sao_frame`` with its one packed upload must
give the reference's per-plane results. ``deblock_frame`` reads strided
views of taller buffers and leaves them as they were.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_hop_tpu.ops import deblock as jdb
from hevc_hop_tpu.ops import sao as jsao
from hevc_hop_torch.ops import deblock, sao

T = lambda a: torch.as_tensor(np.asarray(a))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain bodies run many small tensor ops; one thread keeps the
    suite's parallel workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _blocky(rng, h, w, bd):
    """Flat 8x8 blocks with steps between them on a ramp, plus a little
    noise: the on, strong and weak decisions all get taken."""
    steps = rng.integers(-12, 13, (h // 8, w // 8)) * (1 << (bd - 8))
    steps = np.repeat(np.repeat(steps, 8, 0), 8, 1)
    ramp = (60 + (np.arange(w)[None] + np.arange(h)[:, None]) // 16) \
        << (bd - 8)
    noise = rng.integers(-2, 3, (h, w))
    return np.clip(ramp + steps + noise, 0, (1 << bd) - 1).astype(np.int32)


# (name, inter maps, bit depth, QP, (beta_off, tc_off))
DEBLOCK_CASES = {"intra-8bit-qp22": (False, 8, 22, (0, 0)),
                 "inter-10bit-qp37-offsets": (True, 10, 37, (2, -1))}
DB_W, DB_H = 128, 96


@functools.lru_cache(maxsize=None)
def _deblock_case(name):
    """(planes, tu4, maps, the jitted reference's output) of a case."""
    inter, bd, qp, (beta_off, tc_off) = DEBLOCK_CASES[name]
    rng = np.random.default_rng(len(name))
    h, w = DB_H, DB_W
    planes = tuple(_blocky(rng, hh, ww, bd) for hh, ww in
                   ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
    tu4 = rng.integers(2, 6, (h // 4, w // 4)).astype(np.uint8)
    u = (h // 4, w // 4)
    maps = {}
    if inter:
        maps = dict(pred4=(rng.random(u) < 0.3).astype(np.uint8),
                    cbf4=(rng.random(u) < 0.3).astype(np.uint8),
                    ref4=(rng.random(u) < 0.1).astype(np.uint8),
                    mv4x=rng.integers(-6, 7, u).astype(np.int16),
                    mv4y=rng.integers(-6, 7, u).astype(np.int16))
    want = jdb.deblock_frame(*planes, tu4, qp=qp, qp_c=qp - 2,
                             bit_depth=bd, beta_off=beta_off,
                             tc_off=tc_off, **maps)
    return planes, tu4, maps, tuple(np.asarray(p) for p in want)


@pytest.mark.parametrize("tile", [(32, 32), (24, 40), (8, 16)],
                         ids=["kernel-32x32", "24x40-partial", "8x16"])
@pytest.mark.parametrize("name", sorted(DEBLOCK_CASES))
def test_tile_walk_equals_jax_deblock(name, tile):
    """Every tile size is a multiple of 8, so the 8-grid's edges lie on
    tile borders too; 128 / 40 leaves a partial last column of tiles."""
    inter, bd, qp, (beta_off, tc_off) = DEBLOCK_CASES[name]
    planes, tu4, maps, want = _deblock_case(name)
    got = deblock.deblock_tiles_plain(
        *(T(p) for p in planes), T(tu4), qp, qp - 2, bd, beta_off, tc_off,
        **{k: T(v) for k, v in maps.items()}, tile=tile)
    for g, w_, p, nm in zip(got, want, planes, ("y", "cb", "cr")):
        np.testing.assert_array_equal(g.numpy(), w_, err_msg=nm)
        assert (w_ != p).any(), f"{nm}: the case filters nothing"
    if inter:
        bs = deblock.edge_bs_v(T(tu4).long(), DB_W, tuple(
            T(maps[k]) for k in ("pred4", "cbf4", "ref4", "mv4x", "mv4y")))
        assert set(bs.unique().tolist()) == {0, 1, 2}


# (ctb_log2, bit depth): a 128x64 picture holds whole CTUs of every size;
# the chroma planes run at ctb_log2 - 1, so 3, 4, 5 and 6 all occur
SAO_CASES = ((4, 10), (6, 8))
SAO_W, SAO_H = 128, 64


@functools.lru_cache(maxsize=None)
def _sao_case(lg, bd):
    """(orgs, pres, type3, off, band) of a 4:2:0 picture: noise around
    the original, a flat CTU whose samples all fall in one band with the
    largest differences, and maps of every type with bands that wrap past
    31."""
    rng = np.random.default_rng(lg * 16 + bd)
    maxv = (1 << bd) - 1
    shapes = ((SAO_H, SAO_W), (SAO_H // 2, SAO_W // 2),
              (SAO_H // 2, SAO_W // 2))
    orgs = [rng.integers(0, maxv + 1, s).astype(np.int32) for s in shapes]
    pres = [np.clip(o + rng.integers(-6, 7, o.shape) * (1 << (bd - 8)), 0,
                    maxv).astype(np.int32) for o in orgs]
    for i in range(3):
        c = (1 << lg) >> (i > 0)
        pres[i][:c, c:2 * c] = maxv // 3
        orgs[i][:c, c:2 * c] = rng.choice([0, maxv], (c, c))
    n = (SAO_H >> lg, SAO_W >> lg)
    # CTU k of plane i takes type (k + 2 i + 1) mod 6: every plane turns
    # SAO on somewhere, and every type occurs
    type3 = ((np.arange(n[0] * n[1])[:, None] + 2 * np.arange(3) + 1) % 6
             ).reshape(n + (3,)).astype(np.uint8)
    band = rng.integers(26, 32, n + (3,)).astype(np.uint8)
    off = rng.integers(-7, 8, n + (3, 4)).astype(np.int16)
    return orgs, pres, type3, off, band


def _jax_stats(orgs, pres, lg, bd):
    return [tuple(np.asarray(a) for a in jsao.sao_stats_plane(
        jnp.asarray(o), jnp.asarray(p), lg - (i > 0), bd))
        for i, (o, p) in enumerate(zip(orgs, pres))]


@pytest.mark.parametrize("lg,bd", SAO_CASES)
def test_three_plane_sao_forms_equal_jax(lg, bd):
    orgs, pres, type3, off, band = _sao_case(lg, bd)
    want = _jax_stats(orgs, pres, lg, bd)
    packed = sao.stats_dispatch([T(o) for o in orgs], [T(p) for p in pres],
                                lg, bd).packed
    assert tuple(packed.shape) == (SAO_H >> lg, SAO_W >> lg, 3, 96)
    for i in range(3):
        flat = np.concatenate([want[i][0].reshape(packed.shape[:2] + (16,)),
                               want[i][1].reshape(packed.shape[:2] + (16,)),
                               want[i][2], want[i][3]], -1)
        np.testing.assert_array_equal(packed[:, :, i].numpy(), flat)
    # the flat CTU's samples all fall in one band
    assert (want[0][2][0, 1] == (1 << (2 * lg))).any()
    params = np.concatenate([type3[..., None], band[..., None], off], -1)
    got = sao.apply_sao_frame_plain(tuple(T(p) for p in pres),
                                    T(params.astype(np.int32)), lg, bd)
    for i, (g, p) in enumerate(zip(got, pres)):
        w_ = jsao.apply_sao_plane(
            jnp.asarray(p), jnp.asarray(type3[:, :, i].astype(np.int32)),
            jnp.asarray(off[:, :, i].astype(np.int32)),
            jnp.asarray(band[:, :, i].astype(np.int32)), lg - (i > 0), bd)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
        assert (g.numpy() != p).any()


@pytest.mark.parametrize("lg,bd", SAO_CASES)
def test_dispatch_fetch_and_packed_apply_equal_jax(lg, bd):
    """stats_dispatch's per-plane arrays are views of its one buffer,
    which fetch_stats copies at once; apply_sao_frame packs the decided
    maps as the decoder holds them (uint8 types and bands, int16
    offsets) into one tensor."""
    orgs, pres, type3, off, band = _sao_case(lg, bd)
    st = sao.stats_dispatch(tuple(T(o) for o in orgs),
                            tuple(T(p) for p in pres), lg, bd)
    base = st.packed.untyped_storage().data_ptr()
    assert all(a.untyped_storage().data_ptr() == base
               for plane in st for a in plane)
    got = sao.fetch_stats(st)
    want = jax.device_get(jsao.stats_dispatch(orgs, pres, lg, bd))
    for g, w_ in zip(got, want):
        for a, b in zip(g, w_):
            np.testing.assert_array_equal(a, np.asarray(b))
    out = sao.apply_sao_frame(*(T(p) for p in pres), type3, off, band, lg,
                              bd)
    ref = jsao.apply_sao_frame(*(jnp.asarray(p) for p in pres), type3, off,
                               band, lg, bd)
    for g, w_ in zip(out, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


@pytest.mark.parametrize("inter", [False, True], ids=["intra", "inter"])
def test_deblock_frame_on_strided_views(inter):
    """The encoder passes rows of its stacked recon buffers: luma above
    padding rows, cb and cr as two row ranges of one buffer."""
    rng = np.random.default_rng(7 + inter)
    h, w, hc = 96, 128, 48
    by = T(np.zeros((h + 16, w), np.int32))
    bc = T(np.zeros((2 * hc + 24, w // 2), np.int32))
    by[:h] = T(_blocky(rng, h, w, 8))
    bc[:hc] = T(_blocky(rng, hc, w // 2, 8))
    bc[hc + 8:2 * hc + 8] = T(_blocky(rng, hc, w // 2, 8))
    by[h:] = 7
    bc[hc:hc + 8] = 9
    views = (by[:h], bc[:hc], bc[hc + 8:2 * hc + 8])
    tu4 = T(rng.integers(2, 6, (h // 4, w // 4)).astype(np.uint8))
    u = (h // 4, w // 4)
    maps = {}
    if inter:
        maps = dict(pred4=T((rng.random(u) < 0.3).astype(np.uint8)),
                    cbf4=T((rng.random(u) < 0.3).astype(np.uint8)),
                    ref4=T((rng.random(u) < 0.1).astype(np.uint8)),
                    mv4x=T(rng.integers(-6, 7, u).astype(np.int16)),
                    mv4y=T(rng.integers(-6, 7, u).astype(np.int16)))
    keep = (by.clone(), bc.clone())
    got = deblock.deblock_frame(*views, tu4, 37, 35, 8, 2, -1, **maps)
    want = deblock.deblock_frame(*(v.contiguous() for v in views), tu4, 37,
                                 35, 8, 2, -1, **maps)
    assert torch.equal(by, keep[0]) and torch.equal(bc, keep[1])
    for g, w_, v in zip(got, want, views):
        assert torch.equal(g, w_)
        assert g.data_ptr() != v.data_ptr() and (g != v).any()
