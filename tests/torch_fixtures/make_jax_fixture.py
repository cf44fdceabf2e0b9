"""Write jax_intra_416x240_qp32.bin and its .json with the reference package.

The stream is the JAX encoder's default configuration (quadtree RD
pre-pass, NxN, RQT, RDOQ, SBH, deblocking, checksum SEI; SAO off) on
bench.py's synthetic class-B content at 416x240, seed 0. The .json records
the generator, seed, configuration and the per-plane MD5 of the JAX
decoder's output. Run from the repository root:

    JAX_PLATFORMS=cpu python tests/torch_fixtures/make_jax_fixture.py
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

NAME = "jax_intra_416x240_qp32"


def plane_md5(p) -> str:
    return hashlib.md5(np.asarray(p).astype(np.uint8).tobytes()).hexdigest()


def main() -> None:
    w, h, seed = 416, 240, 0
    cfg = EncoderConfig(width=w, height=h, qp=32)
    stream = IntraEncoder(cfg).encode_frame(*synth_class_b(w, h, seed=seed))
    dec = Decoder()
    (y, cb, cr), = dec.decode_stream(stream)
    assert dec.hash_ok == [True]
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, NAME + ".bin"), "wb") as f:
        f.write(stream)
    meta = dict(
        generator="tests/torch_fixtures/make_jax_fixture.py "
                  "(hevc_hop_tpu IntraEncoder, JAX on the CPU)",
        content="bench.py synth_class_b(416, 240, seed=0)",
        seed=seed, config=dataclasses.asdict(cfg), bytes=len(stream),
        md5={"y": plane_md5(y), "cb": plane_md5(cb), "cr": plane_md5(cr)})
    with open(os.path.join(here, NAME + ".json"), "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
