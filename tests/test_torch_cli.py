"""The port's HM-style CLI (hevc_hop_torch/utils/cli.py) and rate control
(models/ratectrl.py) against the JAX package's, on the CPU: the same
bitstream, recon file, decoded file and bytecount report."""
import os

import numpy as np
import pytest

from hevc_hop_tpu.models import ratectrl as jrc
from hevc_hop_tpu.utils import cli as jcli
from hevc_hop_torch.io import yuv as yuvio
from hevc_hop_torch.models import ratectrl
from hevc_hop_torch.utils import cli
from test_e2e_intra import synth_frame

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "cfg", "encoder_intra_main.cfg")


def _source(tmp_path, w, h, frames):
    src = tmp_path / "in.yuv"
    yuvio.write_yuv420(str(src), [synth_frame(w, h, seed=7 + i)
                                  for i in range(frames)])
    return src


def _run(main, tmp_path, tag, src, w, h, frames, capsys, **kw):
    """encode, decode and bytecount through one CLI; returns the files'
    bytes and the bytecount report."""
    bs, rec, dec = (tmp_path / f"{tag}.{ext}" for ext in ("bin", "rec",
                                                          "dec"))
    assert main(["encode", "-c", CFG, "-i", str(src), "-b", str(bs),
                 "-o", str(rec), "-wdt", str(w), "-hgt", str(h),
                 "-f", str(frames)], **kw) == 0
    assert main(["decode", "-b", str(bs), "-o", str(dec)], **kw) == 0
    assert "[OK]" in capsys.readouterr().out
    assert main(["bytecount", "-b", str(bs)]) == 0
    report = capsys.readouterr().out
    return bs.read_bytes(), rec.read_bytes(), dec.read_bytes(), report


@pytest.mark.parametrize("frames", [1, 2], ids=["f1", "f2-holds-R1"])
def test_cli_matches_reference(tmp_path, capsys, frames):
    """The default cfg (RDOQ, SBH, SAO, quadtree) through both CLIs. With
    two frames both recon files hold the last frame twice (fault R1 of
    ROADMAP.md queue 3, kept in both packages alike)."""
    w, h = 64, 64
    src = _source(tmp_path, w, h, frames)
    ref = _run(jcli.main, tmp_path, "jax", src, w, h, frames, capsys)
    got = _run(cli.main, tmp_path, "port", src, w, h, frames, capsys,
               device="cpu")
    for g, r, what in zip(got, ref, ("bitstream", "recon", "decoded",
                                     "bytecount report")):
        assert g == r, what
    fsize = w * h * 3 // 2
    assert len(got[1]) == frames * fsize
    if frames == 2:
        # R1: the recon file repeats the last frame; the decoded file holds
        # both
        assert got[1][:fsize] == got[1][fsize:]
        assert got[2][:fsize] != got[2][fsize:]


def test_cli_convert_matches_reference(tmp_path, capsys):
    src = _source(tmp_path, 32, 16, 2)
    outs = []
    for main, tag in ((jcli.main, "jax"), (cli.main, "port")):
        out = tmp_path / f"{tag}.yuv"
        assert main(["convert", "-i", str(src), "-o", str(out), "-wdt", "32",
                     "-hgt", "16", "--InputBitDepth", "8",
                     "--OutputBitDepth", "10"]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]


def test_cli_holoscopic_raises(tmp_path):
    src = _source(tmp_path, 64, 64, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        cli.main(["encode", "-c", CFG, "-i", str(src), "-b",
                  str(tmp_path / "o.bin"), "-wdt", "64", "-hgt", "64",
                  "-hi", "1", "-mir", "16"], device="cpu")


def test_rate_control_matches_reference():
    w, h = 64, 64
    frames = [synth_frame(w, h, seed=s) for s in (1, 2, 3)]
    ref, rrc = jrc.encode_rate_controlled(frames, w, h, 60_000, sao=True)
    got, prc = ratectrl.encode_rate_controlled(frames, w, h, 60_000,
                                               device="cpu", sao=True)
    assert got == ref
    assert prc.history == rrc.history
    assert len({q for q, *_ in prc.history}) > 1, "the QP should move"
