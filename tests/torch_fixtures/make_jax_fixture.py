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
- jax_pss_gt_1920x1088_qp32: bench.py's lenslet cell on a short low-delay
  holoscopic sequence (HoloEncoder.encode_sequence: one ISS picture, then
  two PSS pictures): lenslet_frame(1920, 1088, mi=16, seed=5) panned by one
  sample per frame with +-2 noise (tests/test_e2e_iss.py
  test_pss_sequence_roundtrip's motion model, :func:`pss_frames`); its
  .json holds each picture's MD5.
- jax_mesh_1920x1088_qp32: the mesh-sharded intra encoder
  (hevc_hop_tpu.parallel.shard_encode.MeshIntraEncoder) on a (2 frames,
  2 bands) virtual CPU mesh, 16x16 CUs with in-loop RMD, RDOQ, SBH and
  deblocking, SAO off, on synth_class_b(1920, 1088) seeds 0 and 1: the
  .bin holds the two streams one after the other, the .json each one's
  length and MD5s; about a minute on a CPU.

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

# the mesh fixture's (2, 2) mesh needs four host devices, which XLA reads
# when its CPU backend starts
if "xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4"
                               ).strip()

import numpy as np  # noqa: E402

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


def pss_frames(w: int, h: int, count: int = 3, seed: int = 5):
    """test_pss_sequence_roundtrip's motion model on lenslet_frame(w, h,
    mi=16, seed): frame t is the luma rolled by t samples plus
    default_rng(7) noise in [-2, 2], clipped; the chroma rolled by t // 2."""
    y0, cb0, cr0 = lenslet_frame(w, h, mi=16, seed=seed)
    rng = np.random.default_rng(7)
    frames = []
    for t in range(count):
        y = np.roll(y0, t, axis=1) + rng.integers(-2, 3, (h, w))
        frames.append((y.clip(0, 255).astype(np.int32),
                       np.roll(cb0, t // 2, axis=1).astype(np.int32),
                       np.roll(cr0, t // 2, axis=1).astype(np.int32)))
    return frames


# name -> (width, height, seed, frames, HoloConfig fields beyond the size)
PSS_FIXTURES = {
    "jax_pss_gt_1920x1088_qp32": (1920, 1088, 5, 3, dict(
        qp=32, quadtree=True, sao=True, rdoq=True, sbh=True, mi_size=16,
        search_range=32, search_range_t=16, gt=True)),
}


def write_pss(name: str, w: int, h: int, seed: int, count: int,
              extra: dict) -> None:
    cfg = HoloConfig(width=w, height=h, **extra)
    enc = HoloEncoder(cfg)
    stream = enc.encode_sequence(pss_frames(w, h, count, seed))
    dec = Decoder()
    pics = dec.decode_stream(stream)
    assert dec.hash_ok == [True] * count
    for got, want in zip(pics, enc.recon_history):
        assert all(np.array_equal(g, e) for g, e in zip(got, want))
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, name + ".bin"), "wb") as f:
        f.write(stream)
    meta = dict(
        generator="tests/torch_fixtures/make_jax_fixture.py "
                  "(hevc_hop_tpu HoloEncoder.encode_sequence, JAX on the "
                  "CPU)",
        content=f"make_jax_fixture.py pss_frames({w}, {h}, {count}, "
                f"seed={seed}) on tools/bdrate.py lenslet_frame",
        seed=seed, frames=count, config=dataclasses.asdict(cfg),
        bytes=len(stream),
        md5=[{"y": plane_md5(y), "cb": plane_md5(cb), "cr": plane_md5(cr)}
             for (y, cb, cr) in pics])
    with open(os.path.join(here, name + ".json"), "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")


# name -> (width, height, seeds of the frames, mesh (frames, bands),
# EncoderConfig fields beyond the size)
MESH_FIXTURES = {
    "jax_mesh_1920x1088_qp32": (1920, 1088, (0, 1), (2, 2), dict(
        qp=32, cu_log2=4, sao=False)),
}


def write_mesh(name: str, w: int, h: int, seeds: tuple, shape: tuple,
               extra: dict) -> None:
    from hevc_hop_tpu.parallel import shard_encode
    cfg = EncoderConfig(width=w, height=h, **extra)
    mesh = shard_encode.make_mesh(shape[0] * shape[1], band_par=shape[1])
    assert mesh.devices.shape == shape
    streams = shard_encode.MeshIntraEncoder(cfg, mesh).encode_frames(
        [synth_class_b(w, h, seed=s) for s in seeds])
    md5 = []
    for stream in streams:
        dec = Decoder()
        (y, cb, cr), = dec.decode_stream(stream)
        assert dec.hash_ok == [True]
        md5.append({"y": plane_md5(y), "cb": plane_md5(cb),
                    "cr": plane_md5(cr)})
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, name + ".bin"), "wb") as f:
        f.write(b"".join(streams))
    meta = dict(
        generator="tests/torch_fixtures/make_jax_fixture.py "
                  "(hevc_hop_tpu MeshIntraEncoder, JAX on the CPU, "
                  f"a ({shape[0]}, {shape[1]}) mesh of host devices)",
        content=[f"bench.py synth_class_b({w}, {h}, seed={s})"
                 for s in seeds],
        seeds=list(seeds), mesh=list(shape), config=dataclasses.asdict(cfg),
        bytes=[len(s) for s in streams], md5=md5)
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
    for name, (w, h, seed, count, extra) in PSS_FIXTURES.items():
        if not names or name in names:
            write_pss(name, w, h, seed, count, extra)
    for name, (w, h, seeds, shape, extra) in MESH_FIXTURES.items():
        if not names or name in names:
            write_mesh(name, w, h, seeds, shape, extra)


if __name__ == "__main__":
    main(sys.argv[1:])
