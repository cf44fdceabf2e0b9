"""hevc_hop_torch.ops.sao (the plain versions of kernel C6, and the copied
host RDO) against hevc_hop_tpu.ops.sao on the same numpy inputs: every
integer equal."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_hop_tpu.ops import sao as jsao
from hevc_hop_torch.ops import sao as tsao


def _planes(seed, h, w, bit_depth):
    """A smooth ramp with noise (so that every EO category and a run of
    bands occur) and a noisier 'original'."""
    rng = np.random.default_rng(seed)
    maxv = (1 << bit_depth) - 1
    yy, xx = np.mgrid[0:h, 0:w]
    base = (xx * 3 + yy * 5) % (maxv + 1)
    pre = np.clip(base + rng.integers(-6, 7, (h, w)), 0, maxv)
    org = np.clip(pre + rng.integers(-9, 10, (h, w)), 0, maxv)
    return org.astype(np.int32), pre.astype(np.int32)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32)


@pytest.mark.parametrize("ctb_log2", [5, 4])
@pytest.mark.parametrize("bit_depth", [8, 10])
def test_sao_stats_plane_equals_reference(ctb_log2, bit_depth):
    c = 1 << ctb_log2
    org, pre = _planes(ctb_log2 + bit_depth, 3 * c, 4 * c, bit_depth)
    want = jsao.sao_stats_plane(jnp.asarray(org), jnp.asarray(pre), ctb_log2,
                                bit_depth)
    got = tsao.sao_stats_plane(_t(org), _t(pre), ctb_log2, bit_depth)
    for g, w_, name in zip(got, want, ("eo_cnt", "eo_sum", "bo_cnt",
                                       "bo_sum")):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_), err_msg=name)
    # every EO class and category, and several bands, are exercised
    assert (got[0].numpy().sum((0, 1)) > 0).all()
    assert (got[2].numpy().sum((0, 1)) > 0).sum() >= 8


def _params(seed, ncty, nctx):
    """Per-CTU maps that hold every type (off, BO, the four EO classes),
    with BO bands that wrap past 31."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 6, (ncty, nctx))
    t.flat[:6] = np.arange(6)
    offs = rng.integers(-7, 8, (ncty, nctx, 4))
    band = rng.integers(0, 32, (ncty, nctx))
    band.flat[1] = 30          # a BO CTU whose four bands wrap: 30, 31, 0, 1
    return t.astype(np.int32), offs.astype(np.int32), band.astype(np.int32)


@pytest.mark.parametrize("ctb_log2,bit_depth,h,w", [
    (5, 8, 96, 128), (4, 8, 48, 64), (5, 10, 96, 128), (4, 10, 48, 64),
    (5, 8, 72, 104),           # a picture that is not CTU-aligned (decoder)
])
def test_apply_sao_plane_equals_reference(ctb_log2, bit_depth, h, w):
    c = 1 << ctb_log2
    _, pre = _planes(h + bit_depth, h, w, bit_depth)
    if bit_depth == 8:
        pre[:8, :40] = np.arange(40)[None] * 6 + 3   # bands 0.. beside 30, 31
    t, offs, band = _params(w, -(-h // c), -(-w // c))
    want = jsao.apply_sao_plane(jnp.asarray(pre), jnp.asarray(t),
                                jnp.asarray(offs), jnp.asarray(band),
                                ctb_log2, bit_depth)
    got = tsao.apply_sao_plane(_t(pre), _t(t), _t(offs), _t(band), ctb_log2,
                               bit_depth)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != pre).any()


def test_apply_sao_plane_rejects_maps_of_another_shape():
    _, pre = _planes(0, 64, 64, 8)
    t, offs, band = _params(0, 3, 2)
    with pytest.raises(ValueError, match="per-CTU maps"):
        tsao.apply_sao_plane(_t(pre), _t(t), _t(offs), _t(band), 5, 8)
    with pytest.raises(ValueError, match="CTU-aligned"):
        tsao.sao_stats_plane(_t(pre[:40]), _t(pre[:40]), 5, 8)


def _stats(seed, bit_depth=8, h=96, w=128):
    org, pre = _planes(seed, h, w, bit_depth)
    sub = lambda a: a[::2, ::2]
    y = jsao.sao_stats_plane(jnp.asarray(org), jnp.asarray(pre), 5, bit_depth)
    cb = jsao.sao_stats_plane(jnp.asarray(sub(org)), jnp.asarray(sub(pre)),
                              4, bit_depth)
    cr = jsao.sao_stats_plane(jnp.asarray(sub(pre)), jnp.asarray(sub(org)),
                              4, bit_depth)
    return tuple(tuple(np.asarray(a) for a in s) for s in (y, cb, cr))


@pytest.mark.parametrize("seed,lam", [(1, 0.5), (2, 57.9), (3, 4.0)])
def test_choose_sao_params_equals_reference(seed, lam):
    stats = _stats(seed)
    want = jsao.choose_sao_params(*stats, lam)
    got = tsao.choose_sao_params(*stats, lam)
    for g, w_, name in zip(got, want, ("merge", "type3", "off", "band")):
        assert g.dtype == w_.dtype
        np.testing.assert_array_equal(g, w_, err_msg=name)
    if lam < 5:
        assert got[1].any(), "some CTU should turn SAO on"


@pytest.mark.parametrize("bit_depth", [8, 10])
def test_rdo_and_apply_equals_reference(bit_depth):
    """Stats, RDO, maps and apply of a whole 4:2:0 frame."""
    h, w = 64, 96
    org, pre = _planes(11, h, w, bit_depth)
    orgs = (org, org[::2, ::2] ^ 1, org[1::2, ::2])
    pres = (pre, pre[::2, ::2], pre[1::2, ::2] ^ 2)
    lam = 3.0

    def fresh_maps():
        return types.SimpleNamespace(
            sao_on=0, sao_merge=np.zeros((2, 3), np.uint8),
            sao_type=np.zeros((2, 3, 3), np.uint8),
            sao_off=np.zeros((2, 3, 3, 4), np.int16),
            sao_band=np.zeros((2, 3, 3), np.uint8))

    jm, tm = fresh_maps(), fresh_maps()
    want = jsao.rdo_and_apply(orgs, pres, jm, 5, lam, bit_depth)
    got = tsao.rdo_and_apply(tuple(_t(p) for p in orgs),
                             tuple(_t(p) for p in pres), tm, 5, lam,
                             bit_depth)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert tm.sao_on == jm.sao_on == 1
    for k in ("sao_merge", "sao_type", "sao_off", "sao_band"):
        np.testing.assert_array_equal(getattr(tm, k), getattr(jm, k),
                                      err_msg=k)
    assert tm.sao_type.any()
