"""Command-line encoder/decoder apps with HM-compatible option names.

Counterpart of hevc_hop_tpu/utils/cli.py on the port's encoder and decoder,
which run on the CUDA card. Capability ref: TAppEncoder (encmain.cpp:53,
TAppEncCfg.cpp:335-700 option registry incl. HoloscopicIntra/-hi:408,
MIsize/-mir:513, SearchRange) and TAppDecoder (decmain.cpp,
TAppDecTop.cpp). Usage:

    python -m hevc_hop_torch.utils.cli encode -c encoder_intra_main.cfg \
        -i in.yuv -b out.bin -o rec.yuv -wdt 1920 -hgt 1088 -f 10
    python -m hevc_hop_torch.utils.cli decode -b out.bin -o dec.yuv
    python -m hevc_hop_torch.utils.cli bytecount -b out.bin
    python -m hevc_hop_torch.utils.cli convert -i in8.yuv -o out10.yuv \
        -wdt 1920 -hgt 1088 --InputBitDepth 8 --OutputBitDepth 10

From Python, ``main(argv, device="cpu")`` runs the same on the CPU (the
kernels' plain versions); that is a keyword, not a command-line option.
The holoscopic mode (-hi, e.g. with -c 3DHencoder_intra_main.cfg) codes
the frames as the low-delay holoscopic GOP (an ISS picture, then PSS
pictures) with the quadtree pre-pass and, by default, the GT warp; its
recon file holds each picture's recon. -g is read and unused, as in the
reference.
"""
from __future__ import annotations

import sys
import time

import numpy as np

from hevc_hop_torch.utils.options import Options


def _encoder_options() -> Options:
    o = Options()
    o.add("InputFile,-i", "input", "", "source YUV420 file")
    o.add("BitstreamFile,-b", "bitstream", "str.bin", "output AnnexB")
    o.add("ReconFile,-o", "recon", "", "reconstructed YUV output")
    o.add("SourceWidth,-wdt", "width", 0, "source width")
    o.add("SourceHeight,-hgt", "height", 0, "source height")
    o.add("FramesToBeEncoded,-f", "frames", 1, "number of frames")
    o.add("FrameSkip,-fs", "skip", 0, "frames to skip at start")
    o.add("QP,-q", "qp", 32, "base quantization parameter")
    o.add("InternalBitDepth", "bit_depth", 8, "8 or 10 (Main/Main10)")
    o.add("MaxCUSize,-s", "ctb", 32, "CTU size")
    o.add("SAO", "sao", True, "sample adaptive offset")
    o.add("LoopFilterDisable", "no_deblock", False, "disable deblocking")
    o.add("RDOQ", "rdoq", True, "rate-distortion optimized quant")
    o.add("SignHideFlag,-SBH", "sbh", True, "sign bit hiding")
    o.add("WaveFrontSynchro,-wpp", "wpp", False,
          "WPP: one CABAC substream per CTU row")
    o.add("SEIDecodedPictureHash", "hash_type", 2,
          "1=MD5 2=CRC 3=checksum (HM numbering)")
    # IT holoscopic extension (TAppEncCfg.cpp:408-513)
    o.add("HoloscopicIntra,-hi", "holo", False, "ISS self-similarity mode")
    o.add("MIMergeCand,-mi", "mi_merge", False, "micro-image merge cands")
    o.add("MIsize,-mir", "mi_size", 0, "micro-image size in pixels")
    o.add("SearchRange,-sr", "search_range", 32, "SS/ME search range")
    o.add("GT", "gt", True, "geometric-transform (HOP) prediction")
    o.add("GOPSize,-g", "gop", 1, "1 = all-intra/all-ISS; >1 = low-delay")
    return o


def _hash_type_cfg(hm_code: int) -> int:
    # HM: 1=MD5, 2=CRC, 3=checksum; ours: sei.HASH_MD5=0, CRC=1, CHECKSUM=2
    return {1: 0, 2: 1, 3: 2}.get(hm_code, 2)


def encode_main(argv: list, device=None) -> int:
    from hevc_hop_torch.io import yuv as yuvio
    o = _encoder_options()
    if not argv or argv[0] in ("--help", "-h"):
        print("encode options:\n" + o.help_text())
        return 0
    o.parse(argv)
    v = o.values
    assert v["input"] and v["width"] and v["height"], \
        "need -i/-wdt/-hgt (or a cfg file)"
    frames = yuvio.read_yuv420(v["input"], v["width"], v["height"],
                               v["frames"], v["bit_depth"], v["skip"])
    assert frames, "no frames read"
    t0 = time.time()
    if v["holo"]:
        from hevc_hop_torch.models.ss_encoder import HoloConfig, HoloEncoder
        cfg = HoloConfig(
            width=v["width"], height=v["height"], qp=v["qp"],
            bit_depth=v["bit_depth"],
            mi_size=v["mi_size"] if v["mi_merge"] or v["mi_size"] else 0,
            gt=v["gt"], search_range=v["search_range"],
            quadtree=True, sao=v["sao"], rdoq=v["rdoq"], sbh=v["sbh"],
            deblocking=not v["no_deblock"],
            hash_type=_hash_type_cfg(v["hash_type"]))
        enc = HoloEncoder(cfg, device=device)
        stream = enc.encode_sequence([tuple(np.asarray(p, np.int32)
                                            for p in f) for f in frames])
        recons = enc.recon_history
        streams = None
    else:
        from hevc_hop_torch.models.encoder import EncoderConfig, IntraEncoder
        cfg = EncoderConfig(
            width=v["width"], height=v["height"], qp=v["qp"],
            bit_depth=v["bit_depth"], sao=v["sao"], rdoq=v["rdoq"],
            sbh=v["sbh"], wpp=v["wpp"],
            deblocking=not v["no_deblock"],
            hash_type=_hash_type_cfg(v["hash_type"]))
        enc = IntraEncoder(cfg, device=device)
        # the reference's recon file: encode_frames codes every frame
        # first, so each entry is the last frame's recon (R1 in ROADMAP.md
        # queue 3, kept so that the two files agree)
        streams, recons = [], []
        for f in enc.encode_frames([tuple(np.asarray(p, np.int32)
                                          for p in fr) for fr in frames]):
            streams.append(f)
            recons.append(enc.recon_yuv)
        stream = b"".join(streams)
    dt = time.time() - t0
    with open(v["bitstream"], "wb") as f:
        f.write(stream)
    if v["recon"]:
        yuvio.write_yuv420(v["recon"], recons, v["bit_depth"])
    # per-picture telemetry + summary (TEncGOP.cpp:2383 xCalculateAddPSNR,
    # printOutSummary)
    from hevc_hop_torch.utils.analyze import Analyzer
    an = Analyzer()
    # the holoscopic stream is not split per picture: each gets its share
    per = ([len(s) * 8 for s in streams] if streams is not None
           else [len(stream) * 8 // max(len(frames), 1)] * len(recons))
    for i, (fr, rec) in enumerate(zip(frames, recons)):
        an.add_picture(i, "ISS" if v["holo"] else "I", v["qp"], per[i], fr,
                       rec, v["bit_depth"], verbose=True)
    an.print_summary()
    kbps = len(stream) * 8 / 1000.0 / max(len(frames), 1)
    print(f"encoded {len(frames)} frame(s): {len(stream)} bytes "
          f"({kbps:.1f} kbit/pic), {dt:.2f} s "
          f"({len(frames) / dt:.3f} fps)")    # encmain.cpp:92 Total Time
    return 0


def decode_main(argv: list, device=None) -> int:
    from hevc_hop_torch.io import yuv as yuvio
    from hevc_hop_torch.models.decoder import Decoder
    o = Options()
    o.add("BitstreamFile,-b", "bitstream", "", "input AnnexB stream")
    o.add("ReconFile,-o", "recon", "", "decoded YUV output")
    o.add("SEIDecodedPictureHash,-dph", "verify", True,
          "verify decoded-picture-hash SEI")
    if not argv or argv[0] in ("--help", "-h"):
        print("decode options:\n" + o.help_text())
        return 0
    o.parse(argv)
    v = o.values
    with open(v["bitstream"], "rb") as f:
        stream = f.read()
    t0 = time.time()
    dec = Decoder(device=device)
    pics = dec.decode_stream(stream)
    dt = time.time() - t0
    if v["recon"]:
        yuvio.write_yuv420(v["recon"], pics, dec.sps.bit_depth)
    status = ""
    if dec.hash_ok:
        ok = all(dec.hash_ok)
        status = " [OK]" if ok else " [HASH MISMATCH]"   # TDecGop.cpp:280
    print(f"decoded {len(pics)} picture(s) in {dt:.2f} s"
          f" ({len(pics) / max(dt, 1e-9):.3f} fps){status}")
    return 0 if (not dec.hash_ok or all(dec.hash_ok)) else 1


def bytecount_main(argv: list) -> int:
    """Per-NAL-type byte statistics (utils/annexBbytecount.cpp analog)."""
    from hevc_hop_torch.bitstream import nal as nalmod
    o = Options()
    o.add("BitstreamFile,-b", "bitstream", "", "input AnnexB stream")
    o.parse(argv)
    with open(o.values["bitstream"], "rb") as f:
        stream = f.read()
    stats: dict = {}
    for (nal_type, rbsp) in nalmod.annexb_split(stream):
        c, b = stats.get(nal_type, (0, 0))
        stats[nal_type] = (c + 1, b + len(rbsp) + 2)
    total = 0
    for t in sorted(stats):
        c, b = stats[t]
        total += b
        print(f"nal_unit_type {t:2d}: {c:4d} NALs, {b:8d} bytes")
    print(f"total payload {total} bytes (stream {len(stream)} bytes "
          f"incl. start codes)")
    return 0


def convert_main(argv: list) -> int:
    """Raw YUV bit-depth conversion (utils/convert_NtoMbit_YCbCr.cpp)."""
    from hevc_hop_torch.io import yuv as yuvio
    o = Options()
    o.add("InputFile,-i", "input", "", "source YUV")
    o.add("OutputFile,-o", "output", "", "converted YUV")
    o.add("SourceWidth,-wdt", "width", 0, "")
    o.add("SourceHeight,-hgt", "height", 0, "")
    o.add("InputBitDepth", "in_bd", 8, "")
    o.add("OutputBitDepth", "out_bd", 10, "")
    o.add("NumFrames,-f", "frames", 1 << 30, "")
    o.parse(argv)
    v = o.values
    frames = yuvio.read_yuv420(v["input"], v["width"], v["height"],
                               v["frames"], v["in_bd"])
    shift = v["out_bd"] - v["in_bd"]
    out = []
    for (y, cb, cr) in frames:
        conv = []
        for p in (y, cb, cr):
            p = p.astype(np.int32)
            if shift >= 0:
                conv.append(p << shift)
            else:   # rounding down-shift (convert_NtoMbit_YCbCr.cpp)
                conv.append(np.clip((p + (1 << (-shift - 1))) >> -shift,
                                    0, (1 << v["out_bd"]) - 1))
        out.append(tuple(conv))
    yuvio.write_yuv420(v["output"], out, v["out_bd"])
    print(f"converted {len(out)} frame(s) {v['in_bd']} -> {v['out_bd']} bit")
    return 0


def main(argv=None, device=None) -> int:
    """Run one command; ``device`` is where the encoder and decoder run
    (the card when None)."""
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 2
    cmd, rest = argv[0], argv[1:]
    if cmd == "encode":
        return encode_main(rest, device)
    if cmd == "decode":
        return decode_main(rest, device)
    if cmd == "bytecount":
        return bytecount_main(rest)
    if cmd == "convert":
        return convert_main(rest)
    print(__doc__)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
