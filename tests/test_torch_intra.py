"""hevc_hop_torch intra prediction, SATD and the wavefront step of kernel
C2 (plain version) against the JAX reference, exact equality."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_hop_tpu.models import wavefront_scan as jws
from hevc_hop_tpu.ops import intra as jintra
from hevc_hop_torch.ops import intra

T = lambda a: torch.as_tensor(np.asarray(a))
SIZES = [4, 8, 16, 32]


def _chains(rng, b, n, bd=8, smooth=False):
    length = 4 * n + 1
    if smooth:
        # ramps flat enough for the 32x32 strong (bilinear) smoothing
        base = rng.integers(40, 200, (b, 1))
        slope = rng.integers(-1, 2, (b, 1))
        c = base + slope * np.arange(length)[None] // 8
        c = c + rng.integers(0, 2, (b, length))
    else:
        c = rng.integers(0, 1 << bd, (b, length))
    return c.astype(np.int32)


@pytest.mark.parametrize("n", SIZES)
def test_substitute_refs_matches_reference(n):
    rng = np.random.default_rng(n)
    chains = _chains(rng, 24, n)
    avail = rng.random((24, 4 * n + 1)) < rng.random((24, 1))
    avail[0] = False                      # nothing available
    avail[1] = True
    avail[2, :] = False
    avail[2, -1] = True                   # only the last sample
    np.testing.assert_array_equal(
        intra.substitute_refs(T(chains), T(avail)).numpy(),
        np.asarray(jintra.substitute_refs(chains, avail)))


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("n", [8, 32])
def test_filter_refs_matches_reference(n, strong):
    rng = np.random.default_rng(n + strong)
    chains = np.concatenate([_chains(rng, 16, n),
                             _chains(rng, 16, n, smooth=True)])
    got = intra.filter_refs(T(chains), strong=strong).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jintra.filter_refs(chains, strong=strong)))
    if strong and n == 32:   # the bilinear branch was taken somewhere
        plain = intra.filter_refs(T(chains), strong=False).numpy()
        assert (got != plain).any()


@pytest.mark.parametrize("c_idx", [0, 1])
@pytest.mark.parametrize("n", SIZES)
def test_predict_all_modes_and_predict_mode_match_reference(n, c_idx):
    rng = np.random.default_rng(n * 3 + c_idx)
    chains = np.concatenate([_chains(rng, 6, n), _chains(rng, 6, n, True)])
    ref = np.asarray(jintra.predict_all_modes(chains, n, c_idx))
    np.testing.assert_array_equal(
        intra.predict_all_modes(T(chains), n, c_idx).numpy(), ref)
    modes = np.concatenate([np.arange(35), rng.integers(0, 35, 13)])
    ch = chains[np.arange(48) % 12]
    md = modes.astype(np.int32)
    np.testing.assert_array_equal(
        intra.predict_mode(T(ch), T(md), n, c_idx).numpy(),
        np.asarray(jintra.predict_mode(ch, md, n, c_idx)))


@pytest.mark.parametrize("n", SIZES)
def test_satd_matches_reference(n):
    rng = np.random.default_rng(n)
    a = rng.integers(0, 256, (7, 3, n, n)).astype(np.int32)
    b = rng.integers(0, 256, (7, 3, n, n)).astype(np.int32)
    np.testing.assert_array_equal(intra.satd(T(a), T(b)).numpy(),
                                  np.asarray(jintra.satd(a, b)))


def _ref_rmd(plane, org, pos, avail, n, c_idx):
    """The reference's RMD: gather, substitute, 35 modes, SATD, argmin."""
    chains = jintra.substitute_refs(
        jws._gather_chains(jnp.asarray(plane), jnp.asarray(pos), n), avail)
    preds = jintra.predict_all_modes(chains, n, c_idx)
    rows, cols = jws._block_idx(jnp.asarray(pos), n)
    costs = jintra.satd(jnp.asarray(org)[rows, cols][:, None], preds)
    best = jnp.argmin(costs, axis=1)
    pred = jnp.take_along_axis(preds, best[:, None, None, None], 1)[:, 0]
    return np.asarray(pred), np.asarray(best)


@pytest.mark.parametrize("n", SIZES)
def test_rmd_step_matches_reference(n):
    rng = np.random.default_rng(n + 100)
    h, w = 3 * n, 4 * n
    plane = rng.integers(0, 256, (h, w)).astype(np.int32)
    org = np.clip(plane + rng.integers(-9, 9, (h, w)), 0, 255).astype(
        np.int32)
    pos = np.array([[n, n], [2 * n, n], [3 * n, 2 * n], [0, 0]], np.int32)
    avail = rng.random((4, 4 * n + 1)) < 0.7
    ref_pred, ref_best = _ref_rmd(plane, org, pos, avail, n, 0)
    pred, best = intra.intra_blocks(T(plane), T(pos), T(avail),
                                    torch.full((4,), -1, dtype=torch.int32),
                                    n, 0, org=T(org))
    np.testing.assert_array_equal(best.numpy(), ref_best)
    np.testing.assert_array_equal(pred.numpy(), ref_pred)


@pytest.mark.parametrize("n", [4, 8])
def test_rmd_ties_go_to_the_lowest_mode(n):
    """Flat references and a flat original: every mode predicts the same
    block, the 35 costs tie, and both the port and the reference pick
    mode 0."""
    plane = np.full((2 * n, 2 * n), 90, np.int32)
    org = np.full((2 * n, 2 * n), 90, np.int32)
    pos = np.array([[n, n], [0, n]], np.int32)
    avail = np.ones((2, 4 * n + 1), bool)
    ref_pred, ref_best = _ref_rmd(plane, org, pos, avail, n, 1)
    pred, best = intra.intra_blocks(T(plane), T(pos), T(avail),
                                    torch.full((2,), -1, dtype=torch.int32),
                                    n, 1, org=T(org))
    np.testing.assert_array_equal(best.numpy(), ref_best)
    assert list(best.numpy()) == [0, 0]
    flat = torch.full((1, 4 * n + 1), 90, dtype=torch.int32)
    costs = intra.satd(T(org[:n, :n])[None, None],
                       intra.predict_all_modes(flat, n, 1)).numpy()
    assert (costs == costs.min()).sum() > 1


@pytest.mark.parametrize("c_idx", [0, 1])
@pytest.mark.parametrize("n", SIZES)
def test_single_mode_and_decode_step_match_reference(n, c_idx):
    rng = np.random.default_rng(n * 5 + c_idx)
    h, w = 3 * n, 3 * n
    plane = rng.integers(0, 256, (h, w)).astype(np.int32)
    resi = rng.integers(-60, 60, (h, w)).astype(np.int32)
    pos = np.array([[n, n], [2 * n, 0], [0, 2 * n]], np.int32)
    avail = rng.random((3, 4 * n + 1)) < 0.8
    modes = rng.integers(0, 35, 3).astype(np.int32)
    chains = jintra.substitute_refs(
        jws._gather_chains(jnp.asarray(plane), jnp.asarray(pos), n), avail)
    ref = np.asarray(jintra.predict_mode(chains, modes, n, c_idx))
    pred, _ = intra.intra_blocks(T(plane), T(pos), T(avail), T(modes), n,
                                 c_idx)
    np.testing.assert_array_equal(pred.numpy(), ref)
    rows, cols = jws._block_idx(jnp.asarray(pos), n)
    ref_plane = np.asarray(jnp.asarray(plane).at[rows, cols].set(
        jnp.clip(ref + jnp.asarray(resi)[rows, cols], 0, 255)))
    got = T(plane).clone()
    intra.intra_blocks(got, T(pos), T(avail), T(modes), n, c_idx,
                       resi=T(resi))
    np.testing.assert_array_equal(got.numpy(), ref_plane)
