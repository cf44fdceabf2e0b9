"""hevc_hop_torch.models.partition (the plain versions of kernel C5) against
hevc_hop_tpu.models.partition on the same numpy inputs.

The integer part (predictions, SATD, the top three, transform and quantizer)
must agree exactly; the float32 costs agree within COST_RTOL, because the
reference's log2 is not the correctly rounded one (see the sweep below); the
bottom-up decision is exact on the reference's own cost tensors, also where
two arms lie one float32 step apart."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_hop_tpu.models import partition as jpart
from hevc_hop_torch.models import partition as tpart
from hevc_hop_torch.ops import intra as tintra

# float32 costs: the reference's log2 is off by one unit in the last place
# at about a third of the integers, and its sum over a block is taken in
# another order; both move a cost by a few units in the last place
COST_RTOL = 1e-6
QP = 27


def _plane(seed, h, w, bit_depth):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = (120 + 60 * np.sin(xx / 23.0) * np.cos(yy / 31.0)
         + 25 * np.sin((xx + yy) / 7.0) + rng.normal(0, 9, (h, w)))
    y = y.clip(0, 255).astype(np.int32)
    return y * 4 + 1 if bit_depth == 10 else y


def _ref_plane(y, bit_depth):
    return jnp.asarray(y.astype(np.uint8 if bit_depth == 8 else np.uint16))


@pytest.mark.parametrize("bit_depth", [8, 10])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_rd_costs_equal_reference(n, bit_depth):
    y = _plane(n + bit_depth, 64, 96, bit_depth)
    want_c, want_m = jpart.rd_costs(_ref_plane(y, bit_depth), n, QP,
                                    bit_depth)
    got_c, got_m = tpart.rd_costs(torch.as_tensor(y), n, QP, bit_depth)
    assert got_c.dtype == torch.float32 and got_m.dtype == torch.int32
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                               rtol=COST_RTOL, atol=0)
    rel = np.abs(got_c.numpy() - np.asarray(want_c)) / np.asarray(want_c)
    print(f"rd_costs n={n} bit_depth={bit_depth}: "
          f"{int((rel > 0).sum())} of {rel.size} costs not bit-equal, "
          f"max relative difference {rel.max():.3g}")
    assert len(np.unique(got_m.numpy())) > (1 if n == 32 else 3)


@pytest.mark.parametrize("bit_depth", [8, 10])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_rd_costs_forced_equal_reference(n, bit_depth):
    y = _plane(2 * n + bit_depth, 64, 96, bit_depth)
    rng = np.random.default_rng(n)
    modes = rng.integers(0, 35, (64 // n, 96 // n)).astype(np.int32)
    modes.flat[:3] = (0, 1, 26)
    want = jpart.rd_costs_forced(_ref_plane(y, bit_depth),
                                 jnp.asarray(modes), n, QP, bit_depth)
    got = tpart.rd_costs_forced(torch.as_tensor(y), torch.as_tensor(modes),
                                n, QP, bit_depth)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=COST_RTOL, atol=0)


def _satd_all(y, n):
    yt = torch.as_tensor(y)
    idx = torch.arange((y.shape[0] // n) * (y.shape[1] // n))
    chains, blocks = tpart._chains(yt, idx, n, 8)
    preds = tintra.predict_all_modes(chains, n, 0, 8, False)
    return tintra.satd(blocks[:, None], preds).numpy()


@pytest.mark.parametrize("kind", ["flat", "columns", "rows"])
@pytest.mark.parametrize("n", [4, 8, 16])
def test_equal_satds_keep_the_lower_mode_first(n, kind):
    """Constructed ties: a flat plane (every mode predicts it exactly), and
    planes constant along columns or rows (several modes tie). The top
    three, and the winner among equal costs, follow the reference's order:
    the lower mode first."""
    h, w = 32, 48
    ramp = (np.arange(w) * 37 % 200 + 20).astype(np.int32)
    y = {"flat": np.full((h, w), 128, np.int32),
         "columns": np.broadcast_to(ramp[None], (h, w)).copy(),
         "rows": np.broadcast_to(ramp[:h, None], (h, w)).copy()}[kind]
    satd = np.sort(_satd_all(y, n), 1)
    assert (satd[:, 0] == satd[:, 1]).any(), "the case should hold ties"
    want_c, want_m = jpart.rd_costs(jnp.asarray(y.astype(np.uint8)), n, QP, 8)
    got_c, got_m = tpart.rd_costs(torch.as_tensor(y), n, QP, 8)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                               rtol=COST_RTOL, atol=0)


def test_log2_rate_term_against_the_reference_sweep():
    """3 + 2*log2(a + 1) for every level magnitude a = 0 ... 32768. The
    port's log2 (torch.log2; log2f in the kernel) is the correctly rounded
    one. The reference's, on the CPU, is not: it differs from it at about a
    third of the integers, never by more than one unit in the last place of
    the term. Nothing floors the term, so a cost moves by about
    lam * 2**-22 and only a near-tie can change sides."""
    a = np.arange(0, 32769, dtype=np.float32)
    want = np.asarray(jax.jit(lambda v: jnp.where(
        v > 0, 3.0 + 2.0 * jnp.log2(v + 1.0), 0.0))(jnp.asarray(a)))
    t = torch.as_tensor(a)
    got = torch.where(t > 0, 3.0 + 2.0 * torch.log2(t + 1.0),
                      torch.zeros(())).numpy()
    exact = np.float32(3.0) + np.float32(2.0) * np.log2(
        a.astype(np.float64) + 1.0).astype(np.float32)
    exact[0] = 0.0
    np.testing.assert_array_equal(got, exact)
    assert got[0] == want[0] == 0.0
    ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    assert np.all(np.abs(got - want) <= ulp)
    differ = int((got != want).sum())
    print(f"log2 sweep: the rate term differs at {differ} of {a.size} "
          "magnitudes, by one unit in the last place at most")
    assert differ < 0.45 * a.size, differ


@pytest.mark.parametrize("qp", [22, 27, 32, 37])
def test_decision_expressions_round_as_the_reference(qp):
    """The float32 expressions of the decision, bit for bit, on a grid as
    wide as 1920x1088's 16x16 blocks: the 2x2 sum is
    ((a00 + a01) + a10) + a11, and two constants added one after the other
    are folded into one float32 constant first. (On a grid whose width is a
    power of two the reference's compiler sums (a00 + a01) + (a10 + a11)
    instead; the port keeps one order.)"""
    rng = np.random.default_rng(qp)
    a = (rng.random((68, 120)) * 3000).astype(np.float32)
    lam = jpart.full_lambda(qp)
    mode_cost, tu_cost = lam * jpart.MODE_BITS, lam * jpart.TUSPLIT_BITS
    t = torch.as_tensor(a)
    f32 = tpart._f32
    for ref, got in (
            (lambda v: jpart._sum4(v), tpart._sum4(t)),
            (lambda v: jpart._sum4(v) + 4.0 * mode_cost + lam * 4.0,
             tpart._sum4(t) + f32(f32(4.0 * mode_cost) + f32(lam * 4.0))),
            (lambda v: jpart._sum4(v) + mode_cost + tu_cost,
             tpart._sum4(t) + f32(f32(mode_cost) + f32(tu_cost))),
            (lambda v: v + mode_cost, t + mode_cost)):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jax.jit(ref)(jnp.asarray(a))))


def _reference_costs(seed, qp, near_ties):
    """The reference's own cost and mode tensors of a noisy 64x96 plane.
    With near_ties, each arm's cost is moved to within a few float32 steps
    of the arm it is compared with, on both sides and onto it."""
    rng = np.random.default_rng(seed)
    y = _plane(seed, 64, 96, 8)
    # strong texture on the left third and a few hard edges, so that every
    # CU size wins somewhere
    y[:, :32] = (y[:, :32] + rng.normal(0, 40, (64, 32))).clip(0, 255)
    y[20:23, 40:70] = 250
    y[40:64, 50:53] = 5
    y = _ref_plane(y, 8)
    rd, m = {}, {}
    for n in (4, 8, 16, 32):
        c, mm = jpart.rd_costs(y, n, qp, 8)
        rd[n], m[n] = np.asarray(c), np.asarray(mm)
    up2 = lambda a: np.repeat(np.repeat(a, 2, 0), 2, 1)
    rd["8f16"] = np.asarray(jpart.rd_costs_forced(
        y, jnp.asarray(up2(m[16])), 8, qp, 8))
    rd["16f32"] = np.asarray(jpart.rd_costs_forced(
        y, jnp.asarray(up2(m[32])), 16, qp, 8))
    if near_ties:
        lam = jpart.full_lambda(qp)

        def nudge(target, steps):
            out = target.astype(np.float32)
            for _ in range(3):
                up = np.nextafter(out, np.float32(np.inf))
                dn = np.nextafter(out, np.float32(-np.inf))
                out = np.where(steps > 0, up, np.where(steps < 0, dn, out))
                steps = steps - np.sign(steps)
            return out

        s4 = lambda a: np.asarray(jpart._sum4(jnp.asarray(a)))
        steps = lambda a: rng.integers(-3, 4, a.shape)
        # 2Nx2N at 8x8 against NxN; one 16x16 TU against four 8x8 TUs;
        # one 32x32 TU against four 16x16 TUs
        rd[8] = nudge(s4(rd[4]) + np.float32(lam * 22.0), steps(rd[8]))
        rd[16] = nudge(s4(rd["8f16"]) + np.float32(lam * 4.0),
                       steps(rd[16]))
        rd[32] = nudge(s4(rd["16f32"]) + np.float32(lam * 4.0),
                       steps(rd[32]))
    return rd, m


@pytest.mark.parametrize("near_ties", [False, True], ids=["costs", "ties"])
@pytest.mark.parametrize("arm", ["plain", "nxn", "rqt"])
def test_decide_equals_reference_on_its_costs(arm, near_ties):
    qp = 24
    rd, m = _reference_costs(7, qp, near_ties)
    j = lambda a: jnp.asarray(a)
    t = lambda a: torch.as_tensor(np.array(a))
    if arm == "plain":
        want = jpart.decide(j(rd[8]), j(rd[16]), j(rd[32]), j(m[8]),
                            j(m[16]), j(m[32]), qp)
        got = tpart.decide(t(rd[8]), t(rd[16]), t(rd[32]), t(m[8]),
                           t(m[16]), t(m[32]), qp)
    elif arm == "nxn":
        want = jpart.decide_nxn(*(j(rd[n]) for n in (4, 8, 16, 32)),
                                *(j(m[n]) for n in (4, 8, 16, 32)), qp)
        got = tpart.decide_nxn(*(t(rd[n]) for n in (4, 8, 16, 32)),
                               *(t(m[n]) for n in (4, 8, 16, 32)), qp)
    else:
        ks = (4, 8, 16, 32, "8f16", "16f32")
        want = jpart.decide_rqt(*(j(rd[n]) for n in ks),
                                *(j(m[n]) for n in (4, 8, 16, 32)), qp)
        got = tpart.decide_rqt(*(t(rd[n]) for n in ks),
                               *(t(m[n]) for n in (4, 8, 16, 32)), qp)
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    depth = got[0].numpy()
    assert len(np.unique(depth)) >= 2, "the case should mix CU sizes"
    if arm == "rqt" and near_ties:
        tulog = got[2].numpy()
        assert ((tulog == 3) & (depth == 1)).any(), "a split 16x16 TU"


def test_decide_without_nxn_under_rqt():
    """nxn=False under the residual quadtree: the encoder adds 1e18 to the
    4x4 costs, and no cell comes out NxN."""
    qp = 30
    rd, m = _reference_costs(3, qp, False)
    rd4 = rd[4] + np.float32(1e18)
    ks = (8, 16, 32, "8f16", "16f32")
    want = jpart.decide_rqt(jnp.asarray(rd4), *(jnp.asarray(rd[n])
                                                for n in ks),
                            *(jnp.asarray(m[n]) for n in (4, 8, 16, 32)), qp)
    got = tpart.decide_rqt(torch.as_tensor(rd4), *(torch.as_tensor(rd[n])
                                                   for n in ks),
                           *(torch.as_tensor(m[n]) for n in (4, 8, 16, 32)),
                           qp)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert not (got[0].numpy() == 3).any()


def test_lambdas_and_constants_equal_reference():
    for qp in range(0, 52):
        assert tpart.full_lambda(qp) == jpart.full_lambda(qp)
        assert tpart.rmd_lambda(qp) == jpart.rmd_lambda(qp)
    assert (tpart.MODE_BITS, tpart.SPLIT_BITS, tpart.TUSPLIT_BITS) == (
        jpart.MODE_BITS, jpart.SPLIT_BITS, jpart.TUSPLIT_BITS)


def test_rd_costs_rejects_partial_blocks():
    with pytest.raises(ValueError, match="whole n x n"):
        tpart.rd_costs(torch.zeros((60, 64), dtype=torch.int32), 8, QP)
    with pytest.raises(ValueError, match="one mode per"):
        tpart.rd_costs_forced(torch.zeros((64, 64), dtype=torch.int32),
                              torch.zeros((3, 3), dtype=torch.int32), 8, QP)
