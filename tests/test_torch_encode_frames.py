"""hevc_hop_torch's IntraEncoder.encode_frames, the two-stage pipeline (frame
i+1's device programs enqueued before frame i's host work), on the CPU:
three distinct 64x64 frames under the production defaults (RD pre-pass,
NxN, RQT, RDOQ, SBH, deblocking, SAO, the checksum SEI) give the streams of
three encode_frame calls and of the JAX encoder's encode_frames byte for
byte, leave the last frame's reconstruction in recon_yuv, and run the
stages in the reference's order."""
import functools

import numpy as np
import pytest
import torch

from hevc_hop_tpu.models.encoder import EncoderConfig as JaxConfig
from hevc_hop_tpu.models.encoder import IntraEncoder as JaxEncoder
from hevc_hop_torch.models.encoder import EncoderConfig, IntraEncoder
from test_e2e_intra import synth_frame

CFG = dict(width=64, height=64, qp=32, sao=True)
SEEDS = (1, 2, 3)
STATS_KEYS = {"upload_s", "decide_s", "scan_s", "loopfilter_s", "fetch_s",
              "sao_s", "maps_s", "entropy_s", "checksum_s", "total_s",
              "bytes"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain bodies run many small tensor ops; with the suite's
    parallel workers, a thread pool per worker oversubscribes the cores,
    so this module's worker takes one thread while it runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames():
    return [synth_frame(CFG["width"], CFG["height"], seed=s) for s in SEEDS]


@functools.lru_cache(maxsize=None)
def _pipelined():
    """(streams, recon_yuv, last_stats, stage calls) of the port's
    encode_frames on the three frames; each stage call is (stage, frame)."""
    enc = IntraEncoder(EncoderConfig(**CFG), device="cpu")
    stage1, stage2 = enc._stage1, enc._stage2
    index, calls = {}, []

    def spy1(*a, **k):
        st = stage1(*a, **k)
        index[id(st)] = len(index)
        calls.append(("s1", index[id(st)]))
        return st

    def spy2(st):
        calls.append(("s2", index[id(st)]))
        return stage2(st)

    enc._stage1, enc._stage2 = spy1, spy2
    streams = enc.encode_frames(_frames())
    return streams, enc.recon_yuv, dict(enc.last_stats), calls


@functools.lru_cache(maxsize=None)
def _per_frame():
    """(streams, recon_yuv after the last) of encode_frame calls on a fresh
    encoder."""
    enc = IntraEncoder(EncoderConfig(**CFG), device="cpu")
    streams = [enc.encode_frame(*f) for f in _frames()]
    return streams, enc.recon_yuv


@functools.lru_cache(maxsize=None)
def _reference():
    """(streams, recon_yuv) of the JAX encoder's encode_frames."""
    enc = JaxEncoder(JaxConfig(**CFG))
    return enc.encode_frames(_frames()), enc.recon_yuv


def _same_pictures(got, want):
    for g, w, name in zip(got, want, ("y", "cb", "cr")):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_encode_frames_equals_encode_frame():
    got = _pipelined()[0]
    want = _per_frame()[0]
    assert len(got) == len(SEEDS) and len(set(got)) == len(SEEDS)
    assert got == want


def test_encode_frames_equals_reference():
    assert _pipelined()[0] == _reference()[0]


def test_recon_yuv_is_the_last_frames():
    recon = _pipelined()[1]
    _same_pictures(recon, _per_frame()[1])
    _same_pictures(recon, _reference()[1])


def test_stage_order():
    assert _pipelined()[3] == [("s1", 0), ("s1", 1), ("s2", 0), ("s1", 2),
                               ("s2", 1), ("s2", 2)]


def test_last_stats_keys():
    stats = _pipelined()[2]
    assert set(stats) >= STATS_KEYS
    assert all(stats[k] >= 0 for k in STATS_KEYS)
    assert stats["bytes"] == len(_pipelined()[0][-1])
