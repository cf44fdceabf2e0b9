"""hevc_hop_torch — the PyTorch and CUDA port of hevc_hop_tpu.

An HEVC Main and Main10 encoder and decoder whose device work runs as CUDA
kernels written by hand for Hopper (``csrc/``, built by ``nvcc`` for sm_90a
at first use into ``build/``). The JAX package ``hevc_hop_tpu`` beside it is the
reference every part of this package is tested against; nothing here
imports it or JAX.

Layout (mirrors hevc_hop_tpu):
  common/    ROM tables, constants, enums (copied)
  bitstream/ NAL / RBSP / parameter sets / SEI (copied)
  entropy/   ctypes bindings of the native CABAC runtime, RDOQ's
             calibrated bit costs (copied)
  native/    C++ CABAC runtime sources, built into libhevc_hop.so
  io/        YUV file I/O, picture MD5 (copied)
  ops/       kernel wrappers and their plain PyTorch versions:
               hashes.py  C1 checksum.cu  (decoded-picture checksum)
               intra.py   C2 intra.cu     (prediction, RMD, decode recon)
               tq.py      C3 tq.cu        (transform, quant or RDOQ, SBH)
               rdoq.py    C7 rdoq.cu      (RDOQ; its device code also
                                           runs in C3's RDOQ arm)
               deblock.py C4 deblock.cu   (all-intra deblocking)
               sao.py     C6 sao.cu       (SAO statistics and apply)
  models/    wavefront level loop, IntraEncoder, Decoder, rate control,
             and partition.py C5 partition.cu (RD pre-pass and decision)
  parallel/  frames x row-band meshes: MeshIntraEncoder and the sharded
             mode analysis (C2's analysis entry), on one device or over
             torch.distributed ranks
  utils/     the HM-style command line, its options and report (copied)
  convert.py configuration and constant tables from the reference

Entry points run on the card unless the caller passes ``device="cpu"``,
which runs every kernel's plain version instead.
"""

__version__ = "0.1.0"
