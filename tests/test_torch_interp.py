"""hevc_hop_torch motion compensation (kernel C8's plain version) against
the JAX reference's ops/interp.py, exact equality: every quarter-pel luma
and eighth-pel chroma phase, 8 and 10 bit, windows clamped at every edge."""
import numpy as np
import pytest
import torch

from hevc_hop_tpu.ops import interp as jinterp
from hevc_hop_torch.ops import interp

T = lambda a: torch.as_tensor(np.asarray(a))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain bodies run many small tensor ops; with the suite's
    parallel workers, a thread pool per worker oversubscribes the cores,
    so this module's worker takes one thread while it runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(rng, n, bd, b=64, w=48, h=40, pad=8):
    """A plane with pad rows below the picture (as the scans keep them),
    blocks anywhere in the picture, and MVs reaching past every edge."""
    plane = rng.integers(0, 1 << bd, (h + pad, w)).astype(np.int32)
    pos = np.stack([rng.integers(0, w - n + 1, b),
                    rng.integers(0, h - n + 1, b)], -1).astype(np.int32)
    mv = rng.integers(-4 * (n + 12), 4 * (n + 12), (b, 2)).astype(np.int32)
    mv[:16, 0] = np.arange(16) - 8      # every phase near zero
    mv[16:32, 1] = np.arange(16) - 8
    return plane, pos, mv, h


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_luma_mc_matches_reference(n, bd):
    rng = np.random.default_rng(n * 10 + bd)
    plane, pos, mv, h = _case(rng, n, bd)
    want = np.asarray(jinterp.luma_mc(plane, pos, mv, n, h, bd))
    got = interp.luma_mc(T(plane), T(pos), T(mv), n, h, bd)
    np.testing.assert_array_equal(got.numpy(), want)
    assert set((mv & 3).ravel().tolist()) == {0, 1, 2, 3}


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("m", [2, 4, 8, 16])
def test_chroma_mc_q_matches_reference(m, bd):
    rng = np.random.default_rng(m * 10 + bd + 1)
    plane, pos, mv, h = _case(rng, m, bd, w=24, h=20)
    want = np.asarray(jinterp.chroma_mc_q(plane, pos, mv, m, h, bd))
    got = interp.chroma_mc_q(T(plane), T(pos), T(mv), m, h, bd)
    np.testing.assert_array_equal(got.numpy(), want)
    assert set((mv & 7).ravel().tolist()) == set(range(8))


@pytest.mark.parametrize("bd", [8, 10])
def test_filter_2d_matches_reference(bd):
    rng = np.random.default_rng(bd)
    for taps, t in ((jinterp.LUMA_FILTER, 8), (jinterp.CHROMA_FILTER, 4)):
        win = rng.integers(0, 1 << bd, (32, 8 + t - 1, 8 + t - 1)).astype(
            np.int32)
        wh = taps[rng.integers(0, len(taps), 32)]
        wv = taps[rng.integers(0, len(taps), 32)]
        want = np.asarray(jinterp.filter_2d(win, wh, wv, 8, bd))
        got = interp.filter_2d(T(win), T(wh), T(wv), 8, bd)
        np.testing.assert_array_equal(got.numpy(), want)


def test_mc_blocks_forms_match_reference():
    """The wrapper's three forms on the stacked chroma plane and on luma:
    the prediction, the masked write over another prediction, and the
    add-residual epilogue, each against the reference's MC on the block's
    own picture."""
    rng = np.random.default_rng(7)
    w, hc, pad, m, b = 32, 24, 8, 8, 12
    hc_off = hc + pad
    cb = rng.integers(0, 256, (hc, w)).astype(np.int32)
    cr = rng.integers(0, 256, (hc, w)).astype(np.int32)
    stacked = np.zeros((2 * hc_off, w), np.int32)
    stacked[:hc], stacked[hc_off:hc_off + hc] = cb, cr
    pc = np.stack([rng.integers(0, w - m + 1, b) // m * m,
                   rng.integers(0, hc - m + 1, b) // m * m], -1).astype(
        np.int32)
    mv = rng.integers(-60, 60, (b, 2)).astype(np.int32)
    want = np.concatenate([
        np.asarray(jinterp.chroma_mc_q(np.pad(p, ((0, pad), (0, 0))), pc,
                                       mv, m, hc, 8)) for p in (cb, cr)])
    cpos = np.concatenate([pc, pc + np.array([0, hc_off], np.int32)])
    got = interp.mc_blocks(T(stacked), T(cpos), T(mv), m, True, hc, 8, hc_off)
    np.testing.assert_array_equal(got.numpy(), want)

    only = (np.arange(b) % 3 == 0).astype(np.int32)
    base = rng.integers(0, 256, (2 * b, m, m)).astype(np.int32)
    out = interp.mc_blocks(T(stacked), T(cpos), T(mv), m, True, hc, 8,
                           hc_off, out=T(base.copy()), only=T(only))
    sel = np.concatenate([only, only]) != 0
    np.testing.assert_array_equal(out.numpy(), np.where(
        sel[:, None, None], want, base))

    # luma decode epilogue: clip(pred + resi) written in place
    h, n = 32, 8
    luma = rng.integers(0, 256, (h + pad, w)).astype(np.int32)
    resi = rng.integers(-300, 300, (h + pad, w)).astype(np.int32)
    pos = np.array([[0, 0], [8, 16], [24, 24]], np.int32)
    lmv = np.array([[5, -3], [-7, 2], [0, 0]], np.int32)
    pred = np.asarray(jinterp.luma_mc(luma, pos, lmv, n, h, 8))
    plane = T(luma.copy())
    interp.mc_blocks(plane, T(pos), T(lmv), n, False, h, 8, resi=T(resi))
    want_plane = luma.copy()
    for (x, y), p in zip(pos, pred):
        want_plane[y:y + n, x:x + n] = np.clip(
            p + resi[y:y + n, x:x + n], 0, 255)
    np.testing.assert_array_equal(plane.numpy(), want_plane)
