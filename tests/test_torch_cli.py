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


HOLO_CFG = os.path.join(REPO, "cfg", "3DHencoder_intra_main.cfg")


def _lenslet_source(tmp_path, frames):
    """tests/test_cli.py's holoscopic content: a 16x16 micro-image tiled
    over 64x64, flat chroma."""
    mi, w, h = 16, 64, 64
    base = np.random.default_rng(2).integers(60, 200, (mi, mi))
    y = np.tile(base, (h // mi, w // mi)).astype(np.int32)
    c = np.full((h // 2, w // 2), 128, np.int32)
    src = tmp_path / "lens.yuv"
    yuvio.write_yuv420(str(src), [(y, c, c)] * frames)
    return src


def test_cli_holoscopic_matches_reference(tmp_path, capsys):
    """-hi with cfg/3DHencoder_intra_main.cfg (the quadtree pre-pass, GT,
    MI merge candidates, SAO, RDOQ, the checksum SEI) on one frame through
    both CLIs: the same bitstream, recon file, decoded file and bytecount
    report."""
    src = _lenslet_source(tmp_path, 1)
    outs = []
    for main, tag, kw in ((jcli.main, "jax", {}),
                          (cli.main, "port", dict(device="cpu"))):
        bs, rec, dec = (tmp_path / f"{tag}.{ext}" for ext in ("bin", "rec",
                                                              "dec"))
        assert main(["encode", "-c", HOLO_CFG, "-i", str(src), "-b",
                     str(bs), "-o", str(rec), "-wdt", "64", "-hgt", "64",
                     "-f", "1", "-sr", "16"], **kw) == 0
        encode_log = capsys.readouterr().out
        assert main(["decode", "-b", str(bs), "-o", str(dec)], **kw) == 0
        assert "[OK]" in capsys.readouterr().out
        assert main(["bytecount", "-b", str(bs)]) == 0
        outs.append((bs.read_bytes(), rec.read_bytes(), dec.read_bytes(),
                     capsys.readouterr().out))
        assert "ISS" in encode_log
    for g, r, what in zip(outs[1], outs[0], ("bitstream", "recon",
                                             "decoded", "bytecount")):
        assert g == r, what
    assert outs[1][1] == outs[1][2]


def test_cli_holoscopic_raises(tmp_path):
    """-hi with two frames needs PSS pictures, not ported yet."""
    src = _lenslet_source(tmp_path, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        cli.main(["encode", "-c", HOLO_CFG, "-i", str(src), "-b",
                  str(tmp_path / "o.bin"), "-wdt", "64", "-hgt", "64",
                  "-f", "2", "-sr", "16"], device="cpu")


def test_rate_control_matches_reference():
    w, h = 64, 64
    frames = [synth_frame(w, h, seed=s) for s in (1, 2, 3)]
    ref, rrc = jrc.encode_rate_controlled(frames, w, h, 60_000, sao=True)
    got, prc = ratectrl.encode_rate_controlled(frames, w, h, 60_000,
                                               device="cpu", sao=True)
    assert got == ref
    assert prc.history == rrc.history
    assert len({q for q, *_ in prc.history}) > 1, "the QP should move"
