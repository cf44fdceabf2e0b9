"""hevc_hop_torch deblocking (kernel C4's plain version) and the
decoded-picture checksum (kernel C1's plain version) against the JAX
reference, exact equality."""
import numpy as np
import pytest
import torch

from hevc_hop_tpu.ops import deblock as jdb
from hevc_hop_tpu.ops import hashes as jhash
from hevc_hop_torch.ops import deblock, hashes

T = lambda a: torch.as_tensor(np.asarray(a))


def _blocky(rng, h, w, bd=8):
    """Piecewise-flat 8x8 blocks plus a little noise: most edges are real
    steps, so the on/strong/weak decisions all get taken."""
    steps = rng.integers(0, 1 << bd, (h // 8, w // 8))
    steps = np.repeat(np.repeat(steps, 8, 0), 8, 1)
    ramp = rng.integers(-3, 4, (h // 8, w // 8))
    ramp = np.repeat(np.repeat(ramp, 8, 0), 8, 1) * (np.arange(w)[None] % 8)
    base = np.where(rng.random((h // 8, w // 8)) < 0.5, 0, 1)
    base = np.repeat(np.repeat(base, 8, 0), 8, 1)
    smooth = 100 + (np.arange(w)[None] + np.arange(h)[:, None]) // 3
    p = np.where(base == 1, steps // 4 + smooth // 2, smooth + ramp)
    p = p + rng.integers(-2, 3, (h, w))
    return np.clip(p, 0, (1 << bd) - 1).astype(np.int32)


@pytest.mark.parametrize("offsets", [(0, 0), (2, -1), (-3, 4)])
@pytest.mark.parametrize("qp", [22, 37])
@pytest.mark.parametrize("w,h", [(64, 64), (96, 64)])
def test_deblock_frame_matches_reference(w, h, qp, offsets):
    beta_off, tc_off = offsets
    rng = np.random.default_rng(w + h + qp + 7 * beta_off + tc_off)
    y = _blocky(rng, h, w)
    cb = _blocky(rng, h // 2, w // 2)
    cr = _blocky(rng, h // 2, w // 2)
    tu4 = rng.integers(2, 6, (h // 4, w // 4)).astype(np.uint8)
    qp_c = qp - 2
    ref = jdb.deblock_frame(y, cb, cr, tu4, qp=qp, qp_c=qp_c,
                            beta_off=beta_off, tc_off=tc_off)
    got = deblock.deblock_frame(T(y), T(cb), T(cr), T(tu4), qp, qp_c,
                                beta_off=beta_off, tc_off=tc_off)
    for g, r, name in zip(got, ref, ("y", "cb", "cr")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                      err_msg=name)
    assert (got[0].numpy() != y).any()


@pytest.mark.parametrize("tc_off", [0, -2, 3])
@pytest.mark.parametrize("qp", [27, 37])
def test_deblock_inter_boundary_strength_matches_reference(qp, tc_off):
    """The inter arm (ISS slices): BS 2 where either side is intra, 1 where
    either codes luma levels or the references or MVs differ by a full pel,
    else 0, from random dense maps with MVs that straddle the threshold."""
    w, h = 96, 64
    rng = np.random.default_rng(qp + tc_off)
    y = _blocky(rng, h, w)
    cb = _blocky(rng, h // 2, w // 2)
    cr = _blocky(rng, h // 2, w // 2)
    tu4 = rng.integers(3, 6, (h // 4, w // 4)).astype(np.uint8)
    u = (h // 4, w // 4)
    maps = dict(pred4=(rng.random(u) < 0.3).astype(np.uint8),
                cbf4=(rng.random(u) < 0.3).astype(np.uint8),
                ref4=(rng.random(u) < 0.1).astype(np.uint8),
                mv4x=rng.integers(-6, 7, u).astype(np.int16),
                mv4y=rng.integers(-6, 7, u).astype(np.int16))
    ref = jdb.deblock_frame(y, cb, cr, tu4, qp=qp, qp_c=qp - 2,
                            tc_off=tc_off, **maps)
    got = deblock.deblock_frame(T(y), T(cb), T(cr), T(tu4), qp, qp - 2,
                                tc_off=tc_off,
                                **{k: T(v) for k, v in maps.items()})
    for g, r, name in zip(got, ref, ("y", "cb", "cr")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                      err_msg=name)
    bs = deblock.edge_bs_v(T(tu4).long(), w, tuple(
        T(maps[k]) for k in ("pred4", "cbf4", "ref4", "mv4x", "mv4y")))
    assert set(bs.unique().tolist()) == {0, 1, 2}


@pytest.mark.parametrize("bd", [8, 10])
def test_plane_checksum_matches_reference(bd):
    rng = np.random.default_rng(bd)
    planes = [rng.integers(0, 1 << bd, s).astype(np.int32)
              for s in ((72, 600), (36, 300), (36, 300))]
    for p in planes:
        assert hashes.plane_checksum(T(p), bd) == int(
            jhash.plane_checksum(p, bd))
    np.testing.assert_equal(
        hashes.checksum_digests(*[T(p) for p in planes], bit_depth=bd),
        jhash.checksum_digests(*planes, bit_depth=bd))
