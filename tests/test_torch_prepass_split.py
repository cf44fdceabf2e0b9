"""Kernel C9's pre-pass entry, its sum forms, on the CPU.

The entry (hevc_hop_torch/csrc/ss_search.cu ``ss_rd_kernel``) runs only on
the card. Its arithmetic is held here through an emulation
(models/ss_partition.py ``ss_rd_costs_split``, ops/ss_search.py
``corr_tensor_cores``):

- the correlation as the tensor cores form it (a product of the window's
  rows by eight shifts of the original, summed over the kernel's rows)
  equals the direct correlation;
- the tail's sums (the SSE as an exact integer below 2^24, the level bits
  over the nonzero levels only) equal the raster walks of the plain body
  (models/partition.py ``_tq_cost``) bit for bit, past 2^24 too;
- on 8-bit 8x8, 16x16 and 32x32 blocks, 32x32 entries on both sides of
  2^24 (the integer arm taken exactly where both sums stay below it, F8's
  order past it), 10-bit blocks and the temporal arm: each arm's search
  equals the jitted JAX search bit for bit where every sum is exact, the
  costs equal the plain
  body's bit for bit and the JAX ``_ss_rd_size``'s within the plain
  body's 1e-6 relative (ROADMAP.md queue 3, F14: the reference's level
  bits are summed in an order of its own).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_hop_tpu.models import partition as jpartition
from hevc_hop_tpu.models import ss_partition as jss_partition
from hevc_hop_tpu.models import ss_scan as jss
from hevc_hop_torch.models import partition, ss_partition, wavefront
from hevc_hop_torch.ops import ss_search as ss
from test_e2e_iss import synth_lenslet

T = lambda a: torch.as_tensor(np.asarray(a))
LAM = jpartition.full_lambda(32)
W, H, MI = 128, 96, 13


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain bodies run many small tensor ops; with the suite's
    parallel workers, a thread pool per worker oversubscribes the cores,
    so this module's worker takes one thread while it runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("n,d", [(8, 65), (16, 65), (32, 65), (16, 33),
                                 (32, 33)])
def test_tensor_core_correlation_equals_direct(n, d):
    rng = np.random.default_rng(n + d)
    win = T(rng.integers(0, 256, (3, n + d - 1, n + d - 1)))
    org = T(rng.integers(0, 256, (3, n, n)))
    corr, _ = ss.int_sums(win, org, n, d)
    assert torch.equal(ss.corr_tensor_cores(win, org, n, d), corr)


@pytest.mark.parametrize("n,bit_depth,scale", [
    (8, 8, 20), (16, 8, 60), (32, 8, 30), (32, 8, 255), (16, 10, 1023)],
    ids=["8x8", "16x16", "32x32", "32x32-past-2^24", "16x16-10bit"])
def test_tail_sums_equal_raster_walks(n, bit_depth, scale):
    """Residuals whose round trip's SSE stays below 2^24 and, at the
    larger scales, passes it; levels from none to many nonzero."""
    rng = np.random.default_rng(n * scale)
    resi = T(rng.integers(-scale, scale + 1, (24, n, n)).astype(np.int32))
    resi[0] = 0
    got = ss_partition.tail_cost_split(resi, n, 32, bit_depth)
    want = partition._tq_cost(resi, n, 32, bit_depth)
    assert torch.equal(got, want)
    if scale == 255:
        err = resi.long() ** 2
        assert (err.flatten(1).sum(1) >= ss.EXACT).any()


def _plane(kind, bit_depth=8):
    y, _, _ = synth_lenslet(W, H, MI, seed=3)
    y = y.astype(np.int32)
    if kind == "bright":
        # the left half bright: 32x32 corr and ref^2 past 2^24 there,
        # below it on the dark right half
        y[:, :W // 2] = np.clip(y[:, :W // 2] // 3 + 170, 0, 255)
        y[:, W // 2:] = y[:, W // 2:] // 3
    if bit_depth == 10:
        y = y * 4 + 1
    return y


CASES = {
    # name -> (n, radius, bit depth, plane, temporal radius or None)
    "8x8": (8, 32, 8, "lenslet", None),
    "16x16": (16, 32, 8, "lenslet", None),
    "32x32-both-sides-of-2^24": (32, 40, 8, "bright", None),
    "16x16-10bit": (16, 32, 10, "lenslet", None),
    "16x16-temporal": (16, 32, 8, "lenslet", 8),
}


@functools.lru_cache(maxsize=None)
def _inputs(name):
    n, radius, bd, kind, rt = CASES[name]
    y = _plane(kind, bd)
    ref = None
    if rt is not None:
        rng = np.random.default_rng(5)
        ref = np.clip(np.roll(y, 3, axis=1) + rng.integers(-2, 3, y.shape),
                      0, 255).astype(np.int32)
    zplane4 = wavefront.zaddr4_plane(W, H, 5)
    ys = (np.arange(H // n) * n)[:, None].repeat(W // n, 1).ravel()
    xs = (np.arange(W // n) * n)[None, :].repeat(H // n, 0).ravel()
    pos = np.stack([xs, ys], -1).astype(np.int32)
    zcur = zplane4[ys >> 2, xs >> 2].astype(np.int32)
    zmaxw = jss.zmax_win_px(zplane4, n)
    return y, ref, pos, zcur, zmaxw


_SEARCH = jax.jit(jss._ss_search, static_argnames=("n", "radius", "w", "h"))
_T_SEARCH = jax.jit(jss._t_search, static_argnames=("n", "radius", "w",
                                                    "h"))


def _jax_searches(name):
    """Each arm's (mv, cost, pred, sse) from the jitted JAX searches, with
    the inputs _ss_rd_size gives them."""
    n, radius, bd, kind, rt = CASES[name]
    y, ref, pos, zcur, zmaxw = _inputs(name)
    ar = np.arange(n)
    org = y[pos[:, 1, None, None] + ar[None, :, None],
            pos[:, 0, None, None] + ar[None, None, :]]
    dmi = -(((n + MI - 1) // MI) * MI) * 4
    preds = np.broadcast_to(np.array([[0, 0], [dmi, 0], [0, dmi],
                                      [dmi, dmi]], np.int32),
                            (len(pos), 4, 2))
    rate = jss._dyn_rate_map(jnp.asarray(preds), radius, LAM)
    out = [_SEARCH(y, org, pos, zcur, zmaxw, rate, n=n, radius=radius, w=W,
                   h=H)[:4]]
    if ref is not None:
        trate = jss._dyn_rate_map(jnp.zeros((len(pos), 1, 2), jnp.int32),
                                  rt, LAM)
        out.append(_T_SEARCH(ref, org, pos, trate, n=n, radius=rt, w=W,
                             h=H))
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_costs_equal_reference(name):
    """Bit for bit: each arm's search against the jitted JAX search where
    every sum is exact (past 2^24 the search compiled alone takes another
    order than inside _ss_rd_size), and the costs against the plain body.
    Against _ss_rd_size itself the costs agree within 1e-6 relative (the
    plain body's tolerance): its compiled fusion adds the level bits in an
    order that is neither the raster walk nor F11's lanes, and its log2 is
    F1's (ROADMAP.md queue 3, F14)."""
    n, radius, bd, kind, rt = CASES[name]
    y, ref, pos, zcur, zmaxw = _inputs(name)
    args = (T(y), T(pos), T(zcur), T(zmaxw), n, 32, bd, radius, W, H, MI,
            LAM, None if ref is None else T(ref), rt or 0)
    got, regions, arms = ss_partition.ss_rd_costs_split(*args)
    if regions["ordered"] == 0:
        # every sum exact: any compiled order gives these floats
        for arm, want in zip(arms, _jax_searches(name)):
            for g, r_, nm in zip(arm, want, ("mv", "cost", "pred", "sse")):
                np.testing.assert_array_equal(g.numpy(), np.asarray(r_),
                                              err_msg=nm)
    assert torch.equal(got, ss_partition.ss_rd_costs_plain(*args))
    want = np.asarray(jss_partition._ss_rd_size(
        jnp.asarray(y), jnp.asarray(ref if ref is not None else y), pos,
        zcur, zmaxw, n, 32, bd, radius, rt or radius, W, H, MI,
        ref is not None))
    big = want > 1e37
    assert (~big).any()
    np.testing.assert_array_equal(got.numpy()[big], want[big])
    np.testing.assert_allclose(got.numpy()[~big], want[~big], rtol=1e-6)
    # the integer arm wherever the reference's sums stay below 2^24 (every
    # 8-bit entry at n <= 16), F8's order past it (the bright half's 32x32
    # entries, the 10-bit plane's)
    if bd == 8:
        assert regions["exact"] > 0
    if bd == 8 and n <= 16:
        assert regions["ordered"] == 0
    if kind == "bright" or bd == 10:
        assert regions["ordered"] > 0
