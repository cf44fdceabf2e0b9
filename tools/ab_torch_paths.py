#!/usr/bin/env python3
"""Compare the end-to-end times of two trees of hevc_hop_torch on one card.

    python3 tools/ab_torch_paths.py PARENT_TREE CHANGED_TREE \
        [uniform|quadtree|production]

Each tree is a checkout of the repository (the parent unpacked with
``git archive`` beside the working tree). The host sets most of a frame's
time, and it moves by tens of percent between processes, so the trees run
in turns, one process each: parent, change, change, parent, twice over.
Every process builds its tree's kernels if they are stale, encodes and
decodes one 1920x1088 frame to warm up, then times 10 encodes and 10
decodes of it, each ending in a synchronize, and prints one JSON line with
the medians (with the encoder's ``scan_s`` and ``entropy_s`` and, where the
tree's decoder keeps stage times, the decoder's ``scan_s``), beside the
medians of chip_smoke.host_probes() (two fixed pieces of host work, where
the tree's chip_smoke.py has them). The last line holds, per tree, the
median over its four processes. ``uniform`` is cu_log2=4 with RDOQ off (a
path both trees of any pair have); ``quadtree`` is the RD pre-pass with SAO
and RDOQ off; ``production`` is bench.py's configuration (SAO and RDOQ on).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

PATHS = {"uniform": dict(cu_log2=4, rdoq=False),
         "quadtree": dict(sao=True, rdoq=False),
         "production": dict(sao=True)}
TIMED = 10


def one_process(tree: str, path: str) -> None:
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch
    import chip_smoke
    from hevc_hop_torch import _cuda
    from hevc_hop_torch.entropy import native
    from hevc_hop_torch.models.decoder import Decoder
    from hevc_hop_torch.models.encoder import EncoderConfig, IntraEncoder
    _cuda.build_all()
    native.get_lib()
    frame = chip_smoke.synth_class_b(1920, 1088, seed=0)
    enc = IntraEncoder(EncoderConfig(width=1920, height=1088, qp=32,
                                     **PATHS[path]))
    stream = enc.encode_frame(*frame)
    Decoder().decode_stream(stream)
    torch.cuda.synchronize()
    enc_s, dec_s, ent_s, scan_s, dscan_s, probes = [], [], [], [], [], []
    for _ in range(TIMED):
        if hasattr(chip_smoke, "host_probes"):
            probes.append(chip_smoke.host_probes())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc.encode_frame(*frame)
        torch.cuda.synchronize()
        enc_s.append(time.perf_counter() - t0)
        ent_s.append(enc.last_stats["entropy_s"])
        scan_s.append(enc.last_stats["scan_s"])
        t0 = time.perf_counter()
        dec = Decoder()
        dec.decode_stream(stream)
        torch.cuda.synchronize()
        dec_s.append(time.perf_counter() - t0)
        dscan_s.append(getattr(dec, "last_stats", {}).get("scan_s"))
        if dec.hash_ok != [True]:
            raise SystemExit("the decoded picture's hash does not verify")
    print(json.dumps({"tree": tree, "path": path,
                      "card": torch.cuda.get_device_name(0),
                      "encode_s": float(np.median(enc_s)),
                      "decode_s": float(np.median(dec_s)),
                      "entropy_s": float(np.median(ent_s)),
                      "scan_s": float(np.median(scan_s)),
                      "decode_scan_s": (float(np.median(dscan_s))
                                        if None not in dscan_s else None),
                      "python_probe_ms": float(np.median(
                          [p[0] for p in probes])) if probes else None,
                      "launch_probe_ms": float(np.median(
                          [p[1] for p in probes])) if probes else None,
                      "encode_all": enc_s, "decode_all": dec_s}), flush=True)


def main() -> int:
    if len(sys.argv) >= 2 and sys.argv[1] == "--one":
        one_process(sys.argv[2], sys.argv[3])
        return 0
    if len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    parent, change = sys.argv[1], sys.argv[2]
    path = sys.argv[3] if len(sys.argv) > 3 else "uniform"
    runs = {parent: [], change: []}
    for tree in (parent, change, change, parent) * 2:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", tree, path], capture_output=True,
                             text=True, timeout=900)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs[tree].append(json.loads(line))
    med = lambda rs, k: float(np.median([r[k] for r in rs]))
    print(json.dumps({name: {k: med(runs[tree], k)
                             for k in ("encode_s", "decode_s", "entropy_s",
                                       "scan_s")}
                      for name, tree in (("parent", parent),
                                         ("change", change))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
