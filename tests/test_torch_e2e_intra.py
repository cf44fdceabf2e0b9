"""The port's slice as a whole on the CPU: hevc_hop_torch's IntraEncoder
against the JAX encoder (byte-identical AnnexB streams), and its Decoder on
those streams, on a JAX default-configuration stream, and on the committed
reference fixture."""
import hashlib
import json
import pathlib

import numpy as np
import pytest

from hevc_hop_tpu.models.decoder import Decoder as JaxDecoder
from hevc_hop_tpu.models.encoder import EncoderConfig as JaxConfig
from hevc_hop_tpu.models.encoder import IntraEncoder as JaxEncoder
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


def test_port_decodes_committed_reference_fixture():
    name = "jax_intra_416x240_qp32"
    stream = (FIXTURES / f"{name}.bin").read_bytes()
    meta = json.loads((FIXTURES / f"{name}.json").read_text())
    dec = Decoder(device="cpu")
    (planes,) = dec.decode_stream(stream)
    assert dec.hash_ok == [True]
    md5 = {k: hashlib.md5(p.astype(np.uint8).tobytes()).hexdigest()
           for k, p in zip(("y", "cb", "cr"), planes)}
    assert md5 == meta["md5"]
