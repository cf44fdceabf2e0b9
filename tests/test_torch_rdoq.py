"""hevc_hop_torch RDOQ (kernel C7's plain body, ops/rdoq.py) against the
JAX reference as its encoder runs it: compiled (``jax.jit``), whose float
arithmetic differs from op-by-op execution. Levels, tables and the level
loop exactly; each float form the port copies from the compiled program,
bit for bit; and the encoder's streams with RDOQ on, byte for byte."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hevc_hop_tpu.models.encoder import EncoderConfig as JaxConfig
from hevc_hop_tpu.models.encoder import IntraEncoder as JaxEncoder
from hevc_hop_tpu.ops import quant as jquant
from hevc_hop_tpu.ops import rdoq as jrdoq
from hevc_hop_torch.models.decoder import Decoder
from hevc_hop_torch.models.encoder import EncoderConfig, IntraEncoder
from hevc_hop_torch.ops import quant, rdoq
from chip_smoke import rdoq_coefs
from test_torch_e2e_intra import _assert_same_pictures, _textured

T = lambda a: torch.as_tensor(np.asarray(a))
_RDOQ_JIT = jax.jit(jrdoq.rdoq_quant, static_argnames=(
    "qp", "log2_size", "bit_depth", "c_idx", "init_type", "lam"))


def _lam(qp, c_idx):
    lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
    return lam if c_idx == 0 else lam * 2.0 ** (-1.0 / 3.0)


@pytest.mark.parametrize("qp", [22, 30, 37])
@pytest.mark.parametrize("init_type", [2, 3, 4])
@pytest.mark.parametrize("c_idx", [0, 1])
@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_tables_match_reference(log2, c_idx, init_type, qp):
    got = rdoq._tables_for(log2, c_idx, qp, init_type)
    want = jrdoq._tables_for(log2, c_idx, qp, init_type)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k


@pytest.mark.parametrize("bit_depth", [8, 10])
@pytest.mark.parametrize("c_idx", [0, 1])
@pytest.mark.parametrize("log2", [2, 3, 4, 5])
def test_rdoq_plain_matches_jitted_reference(log2, c_idx, bit_depth):
    """Every class (all three MDCS scans where the class has them) at three
    QPs and the three init types (I, ISS and PSS slices), level for
    level."""
    n = 1 << log2
    b = {2: 1024, 3: 512, 4: 128, 5: 48}[log2]
    for qp, init_type in ((22, 2), (37, 3), (30, 4)):
        rng = np.random.default_rng(log2 * 100 + c_idx * 10 + bit_depth + qp)
        coef = rdoq_coefs(rng, b, n)
        scan = rng.integers(0, 3, b).astype(np.int32)
        kw = dict(qp=qp, log2_size=log2, bit_depth=bit_depth, c_idx=c_idx,
                  init_type=init_type, lam=_lam(qp, c_idx))
        want = np.asarray(_RDOQ_JIT(coef, scan, **kw))
        got = rdoq.rdoq_quant(T(coef), T(scan), **kw).numpy()
        np.testing.assert_array_equal(got, want)
        # the decisions moved levels off the dead-zone quantizer's
        dz = np.asarray(jquant.quant(coef, qp, log2, bit_depth, True))
        assert (got != dz).any() and (got != 0).any()


def test_level_rate_log2_sweep_matches_reference():
    """floor(log2(cn) + 1e-6) of the escape length, compiled, over every
    cn the rates can reach: the bit length less one, with no exception."""
    cn = np.arange(1, (1 << 17) + 1, dtype=np.int32)
    ref = np.asarray(jax.jit(lambda c: jnp.floor(jnp.log2(jnp.maximum(
        c, 1).astype(jnp.float32)) + 1e-6).astype(jnp.int32))(cn))
    got = (quant.bit_length(T(cn)) - 1).numpy()
    np.testing.assert_array_equal(got, ref)


def test_level_rate_matches_reference():
    rng = np.random.default_rng(3)
    k = 200_000
    lev = rng.integers(0, 3000, k).astype(np.int32)
    lev[: k // 2] = rng.integers(0, 6, k // 2)
    rice = rng.integers(0, 5, k).astype(np.int32)
    c1, c2 = (rng.integers(0, 16, k).astype(np.int32) for _ in range(2))
    bits = [rng.integers(0, 300_000, k).astype(np.float32) for _ in range(4)]
    ref = np.asarray(jax.jit(jrdoq._level_rate)(lev, *bits, rice, c1, c2))
    got = rdoq._level_rate(T(lev), *map(T, bits), T(rice), T(c1), T(c2))
    np.testing.assert_array_equal(got.numpy(), ref)


def _floats(rng, shape, lo=-2.0, hi=9.0):
    """float32 values over many magnitudes (10^lo .. 10^hi)."""
    return (10.0 ** rng.uniform(lo, hi, shape)).astype(np.float32)


def _forms():
    """(id, reference expression compiled by XLA, the port's form, the form
    the source spells rounded op by op, inputs)."""
    rng = np.random.default_rng(11)
    f32 = np.float32
    lam, es, cbf1 = f32(57.9), f32(4.8448878e-06), f32(39437.0)
    out = []
    for k in (16, 64, 256, 1024):
        x = _floats(rng, (64, k), 0, 8)
        out.append((f"cumsum-{k}", lambda a: jnp.cumsum(a, axis=-1),
                    lambda a: rdoq.xla_cumsum(T(a)),
                    lambda a: T(np.cumsum(a, -1, dtype=np.float32)), (x,)))
        out.append((f"sum-{k}", lambda a: jnp.sum(a, axis=-1),
                    lambda a: rdoq.xla_sum(T(a)),
                    lambda a: rdoq._seq_sum(T(a)), (x,)))
    e, r = _floats(rng, (4096,), 3, 7.5), _floats(rng, (4096,), 4.5, 6.5)
    out.append(("coded_cost", lambda e, r: e * e * es + lam * r,
                lambda e, r: quant.fma(T(e) * T(e), float(es), lam * T(r)),
                lambda e, r: T(e) * T(e) * es + lam * T(r), (e, r)))
    out.append(("cost_z", lambda x, s: x * x * es + lam * s,
                lambda x, s: quant.fma(T(x) * T(x), float(es), lam * T(s)),
                lambda x, s: T(x) * T(x) * es + lam * T(s),
                (_floats(rng, (4096,), 3, 7.5), r)))
    ld = _floats(rng, (256, 4, 16), 1, 5)
    out.append(("cg_sum_chain",
                lambda x: jnp.sum(x * x * es, axis=-1),
                lambda x: rdoq.fma_chain_sum(T(x) * T(x), float(es)),
                lambda x: rdoq._seq_sum(T(x) * T(x) * es), (ld,)))
    s1, s0 = _floats(rng, (4096,), 5, 9), _floats(rng, (4096,), 5, 9)
    b1, b0 = _floats(rng, (4096,), 2, 5), _floats(rng, (4096,), 2, 5)
    out.append(("zero_gain",
                lambda s1, s0, b1, b0: (s1 + lam * b1) - (s0 + lam * b0),
                lambda s1, s0, b1, b0: (quant.fma(T(b1), float(lam), T(s1))
                                        - quant.fma(T(b0), float(lam),
                                                    T(s0))),
                lambda s1, s0, b1, b0: ((T(s1) + lam * T(b1))
                                        - (T(s0) + lam * T(b0))),
                (s1, s0, b1, b0)))
    cc, sg = _floats(rng, (512, 64), 5, 8), _floats(rng, (512, 64), 3, 6)
    paid = rng.random((512, 64)) < 0.7
    out.append(("masked_sig_net",
                lambda c, m, g: c - jnp.where(m, lam * g, 0.0),
                lambda c, m, g: torch.where(T(m), quant.fma(
                    -T(g), float(lam), T(c)), T(c)),
                lambda c, m, g: T(c) - torch.where(T(m), lam * T(g), 0.0),
                (cc, paid, sg)))
    lt = _floats(rng, (4096,), 4, 6)
    out.append(("gathered_head", lambda t: lam * cbf1 + lam * t,
                lambda t: quant.fma(T(t), float(lam), f32(lam * cbf1)),
                lambda t: f32(lam * cbf1) + lam * T(t), (lt,)))
    d = [rng.integers(-9000, 9000, 4096).astype(f32) for _ in range(2)]
    rr = [rng.integers(-3, 30, 4096).astype(f32) for _ in range(2)]
    lamc = f32(57.3 * 4.0 ** 3)
    out.append(("sbh_cost",
                lambda dn, dc, rn, rc: dn * dn - dc * dc + lamc * (rn - rc),
                lambda dn, dc, rn, rc: quant._sbh_cost(T(dn), T(dc), lamc,
                                                       T(rn), T(rc)),
                lambda dn, dc, rn, rc: ((T(dn) * T(dn) - T(dc) * T(dc))
                                        + lamc * (T(rn) - T(rc))),
                (*d, *rr)))
    return out


FORMS = _forms()


@pytest.mark.parametrize("form", FORMS, ids=[f[0] for f in FORMS])
def test_float_forms_match_compiled_reference(form):
    """Each summation order and fused multiply-add the port copies, against
    XLA's compiled program of the same expression, bit for bit; and the
    order the source spells, rounded op by op, differs somewhere on these
    inputs, so the case tells the two apart."""
    _, ref_fn, port_fn, naive_fn, args = form
    want = np.asarray(jax.jit(ref_fn)(*args))
    got = port_fn(*args).numpy()
    np.testing.assert_array_equal(got, want)
    if not form[0].endswith("-16"):
        assert (naive_fn(*args).numpy() != want).any()


@pytest.mark.parametrize("extra", [
    dict(), dict(bit_depth=10), dict(nxn=False, rqt=False)],
    ids=["quadtree", "main10", "plain"])
def test_scan_encode_rdoq_gives_reference_levels_and_recon(extra):
    """The level loop with RDOQ on every TU, deblocking and SAO off: the
    port's coefficient planes, modes and recon are the JAX scan's."""
    w, h = 64, 96
    bd = extra.get("bit_depth", 8)
    y, cb, cr = _textured(w, h, 31, bd)
    kw = dict(width=w, height=h, qp=22, deblocking=False, **extra)
    ref = JaxEncoder(JaxConfig(**kw))
    rst = ref._stage1(y, cb, cr)
    ref_stream = ref._stage2(rst)
    enc = IntraEncoder(EncoderConfig(**kw), device="cpu")
    st = enc._stage1(y, cb, cr)
    assert enc._stage2(st) == ref_stream
    for k in ("coef_y", "coef_cb", "coef_cr", "mode4", "tu4"):
        np.testing.assert_array_equal(getattr(st["maps"], k),
                                      getattr(rst["maps"], k), err_msg=k)
    _assert_same_pictures(enc.recon_yuv, ref.recon_yuv)
    if extra.get("nxn", True):
        assert (st["maps"].tu4 == 2).any(), "the case should hold 4x4 TUs"


@pytest.mark.parametrize("w,h,extra", [
    (64, 96, dict(sao=True)),
    (64, 96, dict(sao=True, bit_depth=10)),                   # Main10
    (96, 96, dict(sao=True, wpp=True)),                       # WPP
    (100, 60, dict()),                                        # conf. window
    (64, 64, dict(cu_log2=4, mode_decision="rmd")),           # RMD, uniform
], ids=["sao", "main10", "wpp-sao", "confwin", "cu16-rmd"])
def test_default_rdoq_stream_matches_reference_and_decodes(w, h, extra):
    """The encoder's default rdoq=True, byte for byte with the JAX
    encoder's stream, and decoded by the port with hash_ok."""
    y, cb, cr = _textured(w, h, w + h + len(extra),
                          extra.get("bit_depth", 8))
    kw = dict(width=w, height=h, qp=27, **extra)
    ref_enc = JaxEncoder(JaxConfig(**kw))
    ref = ref_enc.encode_frame(y, cb, cr)
    enc = IntraEncoder(EncoderConfig(**kw), device="cpu")
    assert enc.cfg.rdoq
    got = enc.encode_frame(y, cb, cr)
    assert got == ref
    _assert_same_pictures(enc.recon_yuv, ref_enc.recon_yuv)
    dec = Decoder(device="cpu")
    (frame,) = dec.decode_stream(got)
    assert dec.hash_ok == [True]
    _assert_same_pictures(frame, ref_enc.recon_yuv)
