"""The port's slices as a whole on the CPU: hevc_hop_torch's IntraEncoder
against the JAX encoder (byte-identical AnnexB streams), with uniform CUs
and with the quadtree RD pre-pass, NxN, the residual quadtree and SAO; its
Decoder on those streams, on JAX default-configuration streams (RDOQ
levels), and on the committed reference fixtures, which its encoder also
writes byte for byte (RDOQ on and off)."""
import hashlib
import json
import pathlib

import numpy as np
import pytest
import torch

from hevc_hop_tpu.models.decoder import Decoder as JaxDecoder
from hevc_hop_tpu.models.encoder import EncoderConfig as JaxConfig
from hevc_hop_tpu.models.encoder import IntraEncoder as JaxEncoder
from hevc_hop_torch import convert
from hevc_hop_torch.models import wavefront_scan
from hevc_hop_torch.models.decoder import Decoder
from hevc_hop_torch.models.encoder import EncoderConfig, IntraEncoder
from test_e2e_intra import synth_frame

FIXTURES = pathlib.Path(__file__).parent / "torch_fixtures"


def _assert_same_pictures(got, want):
    for g, w, name in zip(got, want, ("y", "cb", "cr")):
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("w,h,extra", [
    (64, 64, dict(cu_log2=3)), (64, 64, dict(cu_log2=4)),
    (64, 64, dict(cu_log2=5)),
    (100, 60, dict(cu_log2=4)),                      # conformance window
    (64, 64, dict(cu_log2=4, bit_depth=10)),         # Main10
    (64, 64, dict(cu_log2=4, wpp=True)),             # WPP substreams
    (64, 64, dict(mode_decision="rmd")),             # 8x8 CUs, in-loop RMD
], ids=["cu8", "cu16", "cu32", "confwin", "main10", "wpp", "rmd"])
def test_port_stream_matches_reference_and_decodes(w, h, extra):
    y, cb, cr = synth_frame(w, h, seed=w + len(extra) * 10
                            + extra.get("cu_log2", 0))
    if extra.get("bit_depth") == 10:
        y, cb, cr = (p.astype(np.int32) * 4 + 1 for p in (y, cb, cr))
    kw = dict(width=w, height=h, qp=32, rdoq=False, **extra)
    ref_enc = JaxEncoder(JaxConfig(**kw))
    ref = ref_enc.encode_frame(y, cb, cr)
    enc = IntraEncoder(EncoderConfig(**kw), device="cpu")
    got = enc.encode_frame(y, cb, cr)
    assert got == ref
    _assert_same_pictures(enc.recon_yuv, ref_enc.recon_yuv)
    assert set(enc.last_stats) >= {"decide_s", "scan_s", "loopfilter_s",
                                   "fetch_s", "sao_s", "maps_s",
                                   "entropy_s", "total_s", "bytes"}
    dec = Decoder(device="cpu")
    (frame,) = dec.decode_stream(got)
    assert dec.hash_ok == [True]
    _assert_same_pictures(frame, ref_enc.recon_yuv)


def test_port_decodes_reference_default_config_stream():
    """Quadtree + NxN (4x4 DST) + RQT + RDOQ + SBH + deblocking, SAO off:
    every decode-side kernel at every TU size."""
    y, cb, cr = synth_frame(64, 64, seed=5, kind="noise")
    stream = JaxEncoder(JaxConfig(width=64, height=64, qp=12)).encode_frame(
        y, cb, cr)
    ref_dec = JaxDecoder()
    (want,) = ref_dec.decode_stream(stream)
    dec = Decoder(device="cpu")
    (got,) = dec.decode_stream(stream)
    assert dec.hash_ok == [True] == ref_dec.hash_ok
    _assert_same_pictures(got, want)
    sizes = {lg for sched in wavefront_scan._SCHEDULES.values()
             for lg in sched.plans}
    assert 2 in sizes, "the stream should carry NxN 4x4 TUs"


def _decode_fixture(name):
    stream = (FIXTURES / f"{name}.bin").read_bytes()
    meta = json.loads((FIXTURES / f"{name}.json").read_text())
    dec = Decoder(device="cpu")
    (planes,) = dec.decode_stream(stream)
    assert dec.hash_ok == [True]
    md5 = {k: hashlib.md5(p.astype(np.uint8).tobytes()).hexdigest()
           for k, p in zip(("y", "cb", "cr"), planes)}
    assert md5 == meta["md5"]
    return stream, meta


def _encode_fixture(stream, meta):
    """The port's encoder writes the reference's committed stream from the
    same seeded frame (as the card's encoder must, in chip_smoke.py)."""
    from chip_smoke import synth_class_b
    cfg = convert.config_from_reference(meta["config"])
    frame = synth_class_b(cfg.width, cfg.height, seed=meta["seed"])
    assert IntraEncoder(cfg, device="cpu").encode_frame(*frame) == stream


def test_port_decodes_committed_reference_fixture():
    stream, meta = _decode_fixture("jax_intra_416x240_qp32")
    assert meta["config"]["rdoq"]
    _encode_fixture(stream, meta)


@pytest.mark.parametrize("name", ["jax_intra_sao_256x192_qp32",
                                  "jax_intra_sao_nordoq_256x192_qp32"])
def test_port_decodes_committed_sao_fixture(name):
    stream, meta = _decode_fixture(name)
    assert meta["config"]["sao"]
    _encode_fixture(stream, meta)


# ---------------------------------------------------------------------------
# The quadtree path: RD pre-pass, NxN, residual quadtree, SAO (RDOQ off).
# ---------------------------------------------------------------------------

def _textured(w, h, seed, bit_depth=8):
    """Smooth waves, a strongly textured quarter and two hard edges: every
    CU size, NxN and split TUs all win somewhere."""
    rng = np.random.default_rng(seed)
    y, cb, cr = synth_frame(w, h, seed=seed)
    y = y.copy()
    y[:h // 2, :w // 2] = rng.integers(0, 256, (h // 2, w // 2))
    y[h // 2 + 5:h // 2 + 8, w // 4:] = 250
    y[h // 2:, w - 21:w - 18] = 5
    if bit_depth == 10:
        y, cb, cr = (p.astype(np.int32) * 4 + 1 for p in (y, cb, cr))
    return y, cb, cr


QUADTREE_CASES = [
    (64, 96, dict(sao=True)),
    (64, 96, dict(sao=True, rqt=False)),
    (64, 96, dict(nxn=False)),
    (64, 96, dict(rqt=False, nxn=False)),
    (64, 96, dict(sao=True, bit_depth=10)),                   # Main10
    (96, 96, dict(sao=True, wpp=True)),                       # WPP with SAO
    (160, 128, dict(sao=True, wpp=True, qp=27)),
    (100, 60, dict()),                                        # conf. window
    (90, 66, dict(qp=30)),
]
QUADTREE_IDS = ["sao", "sao-nortq", "nonxn", "plain", "main10", "wpp-sao",
                "wpp-sao-160x128", "confwin", "confwin-90x66"]


@pytest.mark.parametrize("w,h,extra", QUADTREE_CASES, ids=QUADTREE_IDS)
def test_quadtree_stream_matches_reference_and_decodes(w, h, extra):
    """The second check of a float-based decision: whole streams, byte for
    byte."""
    y, cb, cr = _textured(w, h, w + h + len(extra),
                          extra.get("bit_depth", 8))
    kw = dict(dict(width=w, height=h, qp=24, rdoq=False), **extra)
    ref_enc = JaxEncoder(JaxConfig(**kw))
    ref = ref_enc.encode_frame(y, cb, cr)
    enc = IntraEncoder(EncoderConfig(**kw), device="cpu")
    got = enc.encode_frame(y, cb, cr)
    assert got == ref
    _assert_same_pictures(enc.recon_yuv, ref_enc.recon_yuv)
    assert enc.last_stats["decide_s"] > 0
    assert enc.sps.sao_enabled == bool(extra.get("sao"))
    dec = Decoder(device="cpu")
    (frame,) = dec.decode_stream(got)
    assert dec.hash_ok == [True]
    _assert_same_pictures(frame, ref_enc.recon_yuv)


@pytest.mark.parametrize("extra", [dict(sao=True), dict(rqt=False),
                                   dict(nxn=False),
                                   dict(rqt=False, nxn=False)],
                         ids=["rqt", "nxn", "rqt-nonxn", "plain"])
def test_reference_decisions_give_the_reference_stream(extra):
    """The first check of a float-based decision: the port's encoder fed
    the reference's depth8, mode4 and tulog8 writes the reference's stream,
    and the port's own pre-pass decides the same."""
    w, h = 96, 64
    y, cb, cr = _textured(w, h, 11)
    kw = dict(width=w, height=h, qp=22, rdoq=False, **extra)
    ref_enc = JaxEncoder(JaxConfig(**kw))
    ref = ref_enc.encode_frame(y, cb, cr)
    decisions = ref_enc._decide(y)
    enc = IntraEncoder(EncoderConfig(**kw), device="cpu")
    assert enc._stage2(enc._stage1(y, cb, cr, decisions)) == ref
    own = enc._decide(torch.as_tensor(y))
    for g, w_, name in zip(own, decisions, ("depth8", "mode4", "tulog8")):
        if w_ is None:
            assert g is None, name
        else:
            np.testing.assert_array_equal(g, w_, err_msg=name)
    depth8, _, tulog8 = decisions
    assert len(np.unique(depth8)) >= 3, "the case should mix CU sizes"
    if extra.get("nxn", True):
        assert (depth8 == 3).any(), "the case should hold NxN CUs"
    if extra.get("rqt", True):
        if extra.get("nxn", True):
            assert (tulog8 < 5 - np.minimum(depth8, 2)).any(), "a split TU"
        assert enc.sps.max_transform_hierarchy_depth_intra == 1
    else:
        assert enc.sps.max_transform_hierarchy_depth_intra == 0


@pytest.mark.parametrize("bit_depth", [8, 10])
def test_port_decodes_reference_default_config_sao_stream(bit_depth):
    """The JAX encoder's default configuration with SAO (RDOQ on): the
    port's decoder gives the JAX decoder's pictures."""
    y, cb, cr = _textured(96, 64, 21, bit_depth)
    stream = JaxEncoder(JaxConfig(width=96, height=64, qp=27, sao=True,
                                  bit_depth=bit_depth)).encode_frame(
        y, cb, cr)
    ref_dec = JaxDecoder()
    (want,) = ref_dec.decode_stream(stream)
    dec = Decoder(device="cpu")
    (got,) = dec.decode_stream(stream)
    assert dec.hash_ok == [True] == ref_dec.hash_ok
    _assert_same_pictures(got, want)


def test_sao_changes_the_picture_and_needs_aligned_dimensions():
    y, cb, cr = _textured(64, 64, 5)
    kw = dict(width=64, height=64, qp=32, rdoq=False)
    on = IntraEncoder(EncoderConfig(sao=True, **kw), device="cpu")
    off = IntraEncoder(EncoderConfig(sao=False, **kw), device="cpu")
    on.encode_frame(y, cb, cr)
    off.encode_frame(y, cb, cr)
    assert any((a != b).any() for a, b in zip(on.recon_yuv, off.recon_yuv))
    with pytest.raises(ValueError, match="CTU-aligned"):
        IntraEncoder(EncoderConfig(width=72, height=64, sao=True,
                                   rdoq=False), device="cpu")
