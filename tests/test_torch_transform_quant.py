"""hevc_hop_torch transform, quant and SBH (kernel C3's plain version)
against the JAX reference, exact equality on seeded inputs."""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_hop_tpu.models import decoder as jdec
from hevc_hop_tpu.ops import quant as jquant
from hevc_hop_tpu.ops import transform as jtr
from hevc_hop_torch.ops import quant, tq, transform

GOLDEN = pathlib.Path(__file__).parent / "golden" / "hm_golden.json"
T = lambda a: torch.as_tensor(np.asarray(a))
# SBH as the reference's encoder runs it: compiled (XLA contracts its RD
# cost into fused multiply-adds, which op-by-op execution does not)
_SBH_JIT = jax.jit(jquant.sbh_adjust,
                   static_argnames=("c_idx", "qp", "bit_depth", "lam"))


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("n,dst", [(4, True), (4, False), (8, False),
                                   (16, False), (32, False)])
def test_transforms_match_reference(n, dst, bd):
    rng = np.random.default_rng(n * 10 + bd + dst)
    lim = (1 << bd) - 1
    resi = rng.integers(-lim, lim + 1, (12, n, n)).astype(np.int32)
    np.testing.assert_array_equal(
        transform.fwd_transform(T(resi), bd, dst).numpy(),
        np.asarray(jtr.fwd_transform(resi, bd, dst)))
    coef = rng.integers(-32768, 32768, (12, n, n)).astype(np.int32)
    coef[:4] //= 64          # some blocks below the clamps, some at them
    np.testing.assert_array_equal(
        transform.inv_transform(T(coef), bd, dst).numpy(),
        np.asarray(jtr.inv_transform(coef, bd, dst)))


def test_transforms_match_hm_golden():
    with open(GOLDEN) as f:
        g = json.load(f)
    for case in g["transforms"]:
        n, bd, dst = case["n"], case["bd"], bool(case["dst"])
        resi = np.array(case["resi"], np.int32).reshape(1, n, n)
        coeff = transform.fwd_transform(T(resi), bd, dst).numpy()
        np.testing.assert_array_equal(coeff.ravel(), case["coeff"])
        cin = np.array(case["coeff_in"], np.int32).reshape(1, n, n)
        rout = transform.inv_transform(T(cin), bd, dst).numpy()
        np.testing.assert_array_equal(rout.ravel(), case["resi_out"])


@pytest.mark.parametrize("qp", [0, 22, 37, 51])
@pytest.mark.parametrize("bd", [8, 10])
def test_quant_dequant_match_reference(qp, bd):
    rng = np.random.default_rng(qp + bd)
    for log2 in (2, 3, 4, 5):
        n = 1 << log2
        coef = rng.integers(-32768, 32768, (8, n, n)).astype(np.int32)
        np.testing.assert_array_equal(
            quant.quant(T(coef), qp, log2, bd).numpy(),
            np.asarray(jquant.quant(coef, qp, log2, bd)))
        lev = rng.integers(-32768, 32768, (8, n, n)).astype(np.int32)
        lev[:4] //= 512      # mostly in range, some that wrap as int32
        np.testing.assert_array_equal(
            quant.dequant(T(lev), qp, log2, bd).numpy(),
            np.asarray(jquant.dequant(lev, qp, log2, bd)))


def _sbh_inputs(rng, n, qp, big):
    """Levels from quantized random coefficients, dense enough that most
    4x4 groups hide a sign; ``big`` puts levels next to 8192 and 32768,
    where the reference's float32 floor(log2) comes out one low."""
    coef = (rng.normal(0, 900, (16, n, n))
            * rng.random((16, 1, 1))).astype(np.int32)
    if big:
        mag = rng.choice([8191, 8192, 8193, 32766, 32767], (16, n, n))
        pick = rng.random((16, n, n)) < 0.3
        coef = np.where(pick, np.sign(coef + 0.5) * mag, coef).astype(
            np.int32)
        lev = coef.copy()
    else:
        lev = np.asarray(jquant.quant(coef, qp, n.bit_length() - 1))
    scan = rng.integers(0, 3, 16).astype(np.int32)
    return coef, lev.astype(np.int32), scan


@pytest.mark.parametrize("mode", ["no_coef", "lam0", "lam"])
@pytest.mark.parametrize("c_idx", [0, 1])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_sbh_adjust_matches_reference(n, c_idx, mode):
    rng = np.random.default_rng(n * 7 + c_idx)
    qp = 27
    for big in (False, True):
        coef, lev, scan = _sbh_inputs(rng, n, qp, big)
        kw = dict(c_idx=c_idx, qp=qp, bit_depth=8)
        if mode == "no_coef":
            ref = _SBH_JIT(lev, scan, c_idx)
            got = quant.sbh_adjust(T(lev), T(scan), c_idx)
        else:
            lam = 0.0 if mode == "lam0" else 57.3
            ref = _SBH_JIT(lev, scan, coef=coef, lam=lam, **kw)
            got = quant.sbh_adjust(T(lev), T(scan), coef=T(coef), lam=lam,
                                   **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert (got.numpy() != lev).any(), "no group needed hiding"


def test_floor_log2_sweep_matches_reference():
    v = np.arange(1, 65537, dtype=np.int32)
    ref = np.asarray(jnp.floor(jnp.log2(jnp.maximum(v, 1).astype(
        jnp.float32)))).astype(np.int32)
    got = quant.floor_log2_ref(T(v)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert set(v[got != np.floor(np.log2(v))]) == {8192, 32768}


def _ref_tq(org, pred, modes, n, c_idx, qp, sbh):
    """The reference's chain after prediction (_enc_plane_ys)."""
    from hevc_hop_tpu.models.wavefront_scan import _mdcs_scan_id
    log2 = n.bit_length() - 1
    dst = n == 4 and c_idx == 0
    coef = jtr.fwd_transform(org - pred, 8, dst)
    lev = jquant.quant(coef, qp, log2, 8, True)
    if sbh:
        lev = jquant.sbh_adjust(lev, _mdcs_scan_id(modes, n, c_idx), c_idx,
                                coef, qp, 8, lam=0.0)
    rq = jtr.inv_transform(jquant.dequant(lev, qp, log2, 8), 8, dst)
    return np.asarray(jnp.clip(pred + rq, 0, 255)), np.asarray(lev)


@pytest.mark.parametrize("c_idx", [0, 1])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_tq_encode_plain_matches_reference_chain(n, c_idx):
    rng = np.random.default_rng(n + c_idx)
    h, w, qp = 2 * n, 3 * n, 30
    org = rng.integers(0, 256, (h, w)).astype(np.int32)
    pos = np.array([[x, y] for y in range(0, h, n)
                    for x in range(0, w, n)], np.int32)
    pred = np.clip(org.reshape(h // n, n, w // n, n).transpose(0, 2, 1, 3)
                   .reshape(-1, n, n) + rng.integers(-40, 40, (6, n, n)),
                   0, 255).astype(np.int32)
    modes = rng.integers(0, 35, 6).astype(np.int32)
    recon = torch.zeros(h, w, dtype=torch.int32)
    coefp = torch.zeros(h, w, dtype=torch.int16)
    cbf = tq.tq_encode(T(org), T(pred), T(pos), T(modes), n, c_idx, qp, 8,
                       True, None, recon, coefp)
    rec, lev = _ref_tq(org.reshape(h // n, n, w // n, n).transpose(
        0, 2, 1, 3).reshape(-1, n, n), pred, modes, n, c_idx, qp, True)
    blocks = lambda p: p.reshape(h // n, n, w // n, n).transpose(
        0, 2, 1, 3).reshape(-1, n, n)
    np.testing.assert_array_equal(blocks(recon.numpy()), rec)
    np.testing.assert_array_equal(blocks(coefp.numpy()), lev)
    np.testing.assert_array_equal(cbf.numpy(),
                                  (lev != 0).any((1, 2)).astype(np.int32))


@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_tq_decode_plain_matches_reference(log2):
    rng = np.random.default_rng(log2)
    n = 1 << log2
    h = w = 64
    lev = (rng.integers(-300, 300, (h, w))
           * (rng.random((h, w)) < 0.2)).astype(np.int16)
    out = torch.zeros(h, w, dtype=torch.int32)
    grid = np.array([[x, y] for y in range(0, h, n) for x in range(0, w, n)],
                    np.int32)
    tq.tq_decode(T(lev), T(grid), n, 33, 8, log2 == 2, out)
    ref = jdec._residual_uniform(jnp.asarray(lev), 33, 8, log2, True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # mixed sizes: this size on the left half, 8x8 on the right
    pos = {log2: np.array([[x, y] for y in range(0, h, n)
                           for x in range(0, w // 2, n)], np.int32)}
    pos.setdefault(3, np.zeros((0, 2), np.int32))
    pos[3] = np.concatenate([pos[3], np.array(
        [[x, y] for y in range(0, h, 8) for x in range(w // 2, w, 8)],
        np.int32)])
    out = torch.zeros(h, w, dtype=torch.int32)
    for lg, p in sorted(pos.items()):
        tq.tq_decode(T(lev), T(p), 1 << lg, 33, 8, lg == 2, out)
    ref = jdec._residual_mixed(jnp.asarray(lev),
                               {k: jnp.asarray(v) for k, v in pos.items()},
                               33, 8, tuple(sorted(pos)), True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
