"""Write the committed reference streams and their .json with the reference
package (hevc_hop_tpu, JAX on the CPU), on bench.py's synthetic class-B
content:

- jax_intra_416x240_qp32: the JAX encoder's default configuration (quadtree
  RD pre-pass, NxN, RQT, RDOQ, SBH, deblocking, checksum SEI; SAO off) at
  416x240, seed 0; a stream for the decoder.
- jax_intra_sao_256x192_qp32: the default configuration with SAO on (RDOQ
  on) at the CTU-aligned 256x192, seed 1; a stream for the decoder.
- jax_intra_sao_nordoq_256x192_qp32: SAO on and RDOQ off, 256x192, seed 2.
  Its .json names the seed, so that an encoder fed the same frame can be
  held byte for byte against the stream.
- jax_iss_128x96_qp32 and jax_iss_quadtree_sao_128x96_qp32: the lenslet
  ISS encoder (HoloEncoder, GT off) on tools/bdrate.py's
  lenslet_frame(128, 96, mi=16, seed=5), uniform 16x16 CUs, and the
  quadtree pre-pass with SAO; RDOQ and SBH on.
- jax_iss_gt_96x64_qp37: the ISS encoder with the GT warp on, on
  tests/test_e2e_iss.py's warped lenslet content (seed 5), 16x16 CUs.
- jax_iss_gt_1920x1088_qp32: bench.py's lenslet cell (the quadtree
  pre-pass, SAO, RDOQ, SBH, the GT warp) at full size on
  lenslet_frame(1920, 1088, mi=16, seed=5), where GT takes 0.1 % of the
  picture; about 90 s on a CPU.
- jax_iss_gt_warped_1920x1088_qp37: the 96x64 GT configuration at full
  size on synth_warped_lenslet(1920, 1088, 16, seed=5), where GT takes
  2.4 %; about 50 s.

Each .json records the generator, seed, configuration and the per-plane MD5
of the JAX decoder's output. Run from the repository root, with the names
of the fixtures to write (all of them when none is given):

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_jax_fixture.py \
        [name ...]
"""
import dataclasses
import hashlib
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from bench import synth_class_b  # noqa: E402
from hevc_hop_tpu.models.decoder import Decoder  # noqa: E402
from hevc_hop_tpu.models.encoder import EncoderConfig, IntraEncoder  # noqa: E402
from hevc_hop_tpu.models.ss_encoder import HoloConfig, HoloEncoder  # noqa: E402
from tests.test_e2e_iss import synth_warped_lenslet  # noqa: E402
from tools.bdrate import lenslet_frame  # noqa: E402

# name -> (width, height, seed, configuration beyond width, height and qp)
FIXTURES = {
    "jax_intra_416x240_qp32": (416, 240, 0, {}),
    "jax_intra_sao_256x192_qp32": (256, 192, 1, dict(sao=True)),
    "jax_intra_sao_nordoq_256x192_qp32": (256, 192, 2,
                                          dict(sao=True, rdoq=False)),
}


def plane_md5(p) -> str:
    return hashlib.md5(np.asarray(p).astype(np.uint8).tobytes()).hexdigest()


def write(name: str, w: int, h: int, seed: int, extra: dict) -> None:
    cfg = EncoderConfig(width=w, height=h, qp=32, **extra)
    stream = IntraEncoder(cfg).encode_frame(*synth_class_b(w, h, seed=seed))
    dec = Decoder()
    (y, cb, cr), = dec.decode_stream(stream)
    assert dec.hash_ok == [True]
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, name + ".bin"), "wb") as f:
        f.write(stream)
    meta = dict(
        generator="tests/torch_fixtures/make_jax_fixture.py "
                  "(hevc_hop_tpu IntraEncoder, JAX on the CPU)",
        content=f"bench.py synth_class_b({w}, {h}, seed={seed})",
        seed=seed, config=dataclasses.asdict(cfg), bytes=len(stream),
        md5={"y": plane_md5(y), "cb": plane_md5(cb), "cr": plane_md5(cr)})
    with open(os.path.join(here, name + ".json"), "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")


# name -> (width, height, seed, HoloConfig fields beyond the size); the
# content is the warped lenslet grid for the GT configurations with 16x16
# CUs, tools/bdrate.py's lenslet frame otherwise
ISS_FIXTURES = {
    "jax_iss_128x96_qp32": (128, 96, 5, dict(
        qp=32, cu_log2=4, mi_size=16, search_range=32, gt=False)),
    "jax_iss_quadtree_sao_128x96_qp32": (128, 96, 5, dict(
        qp=32, quadtree=True, sao=True, mi_size=16, search_range=32,
        gt=False)),
    "jax_iss_gt_96x64_qp37": (96, 64, 5, dict(
        qp=37, cu_log2=4, mi_size=16, search_range=32, gt=True)),
    "jax_iss_gt_1920x1088_qp32": (1920, 1088, 5, dict(
        qp=32, quadtree=True, sao=True, rdoq=True, sbh=True, mi_size=16,
        search_range=32, gt=True)),
    "jax_iss_gt_warped_1920x1088_qp37": (1920, 1088, 5, dict(
        qp=37, cu_log2=4, mi_size=16, search_range=32, gt=True)),
}


def write_iss(name: str, w: int, h: int, seed: int, extra: dict) -> None:
    cfg = HoloConfig(width=w, height=h, **extra)
    if cfg.gt and not cfg.quadtree:
        frame, content = (synth_warped_lenslet(w, h, 16, seed=seed),
                          f"tests/test_e2e_iss.py synth_warped_lenslet({w}, "
                          f"{h}, 16, seed={seed})")
    else:
        frame, content = (lenslet_frame(w, h, mi=16, seed=seed),
                          f"tools/bdrate.py lenslet_frame({w}, {h}, mi=16, "
                          f"seed={seed})")
    enc = HoloEncoder(cfg)
    stream = enc.encode_frame(*frame)
    assert bool(enc.last_maps.gt8.any()) == cfg.gt
    dec = Decoder()
    (y, cb, cr), = dec.decode_stream(stream)
    assert dec.hash_ok == [True]
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, name + ".bin"), "wb") as f:
        f.write(stream)
    meta = dict(
        generator="tests/torch_fixtures/make_jax_fixture.py "
                  "(hevc_hop_tpu HoloEncoder, JAX on the CPU)",
        content=content, seed=seed, config=dataclasses.asdict(cfg),
        bytes=len(stream),
        md5={"y": plane_md5(y), "cb": plane_md5(cb), "cr": plane_md5(cr)})
    with open(os.path.join(here, name + ".json"), "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")


def main(names) -> None:
    for name, (w, h, seed, extra) in FIXTURES.items():
        if not names or name in names:
            write(name, w, h, seed, extra)
    for name, (w, h, seed, extra) in ISS_FIXTURES.items():
        if not names or name in names:
            write_iss(name, w, h, seed, extra)


if __name__ == "__main__":
    main(sys.argv[1:])
