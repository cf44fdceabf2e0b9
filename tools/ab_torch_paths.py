#!/usr/bin/env python3
"""Compare the end-to-end times of two trees of hevc_hop_torch on one card.

    python3 tools/ab_torch_paths.py PARENT_TREE CHANGED_TREE \
        [uniform|quadtree|production|mesh|analysis|loopfilter|
         checksum_decide|tq_encode|frames]

Each tree is a checkout of the repository (the parent unpacked with
``git archive`` beside the working tree). The host sets most of a frame's
time, and it moves by tens of percent between processes, so the trees run
in turns, one process each: parent, change, change, parent, twice over.
Every process builds its tree's kernels if they are stale, encodes and
decodes one 1920x1088 frame to warm up, then times 10 encodes and 10
decodes of it, each ending in a synchronize, and prints one JSON line with
the medians (with the encoder's ``scan_s`` and ``entropy_s`` and, where the
tree's decoder keeps stage times, the decoder's ``scan_s`` and
``residual_s``), beside the medians of chip_smoke.host_probes() (two fixed
pieces of host work, where the tree's chip_smoke.py has them), and one
more decode traced under torch.profiler after a warm-up trace: the device
ms and the records of kernel C3's decode entry (``tq_decode_kernel``) in
it. The last line holds, per tree, the
median over its four processes. ``uniform`` is cu_log2=4 with RDOQ off (a
path both trees of any pair have); ``quadtree`` is the RD pre-pass with SAO
and RDOQ off; ``production`` is bench.py's configuration (SAO and RDOQ on).

``mesh`` is chip_smoke's mesh-intra-1080p cell (``MESH_CONFIG`` on a
virtual ``MESH_SHAPE`` mesh over ``synth_class_b`` seeds ``MESH_SEEDS``):
each process checks the mesh's streams against the single-device
encoder's, then times 10 ``encode_frames`` calls (``encode_s``, per
frame) beside the single-device encoder on the same frames in the same
turns (``single_s``), times one more call's stages on the host, each
between two synchronizes (``host_ms``: ``scan_encode``, which is the
level loop on a tree that still runs it and C13 on one that does not,
the payload, the gather, each frame's stream), and traces one more call
under torch.profiler after a warm-up trace (``busy_ms``, ``idle_share``
and every device record's ms and count by name).

``analysis`` times the mesh cell's sharded mode analysis (C2's analysis
entry): ``analysis_step_sharded`` at n = 16 on ``synth_class_b`` seeds
``MESH_SEEDS`` on a virtual (2, 2) mesh, held against its plain version
once, then CUDA events around runs of 10 calls, the median of 7 runs
(``step_ms``); the same for ``analysis_blocks`` alone (``kernel_ms``).
Each process builds only csrc/intra.cu.

``checksum_decide`` times kernel C1 and C5's decide entry on the
production frame's own inputs, caught from one encode: the encoder's
``hashes.plane_checksums`` call (its three recon planes) and its
``partition._decide`` call (the decision's cost and mode grids, NxN and
TU-split arms). For each call, as in ``loopfilter``: the device ms of a
profiler trace of 10 calls counting every record (``device_ms``),
``records`` a call, each record's ms by name, and the host ms of a call
that ends in a synchronize (median of 20, and its quartiles); for C1 also
its kernel's own device ms with the 50 MB L2 flushed before each call
(``flushed_ms``: 256 MB written between calls); for the decide entry also an empty kernel
launched on its grid, 8 CTUs of a CTU row a CTA of 128 threads
(``empty_launch_ms``: the floor of a launch of that shape, built by this
tool with nvcc into the tree's build directory). Beside them the
production mode's medians of 10 encodes and decodes: ``encode_s``,
``decode_s``, the encoder's ``decide_s`` and the decoder's
``checksum_s``.

``tq_encode`` times kernel C3's encode entry (``tq.tq_encode``), both
arms, on the production path's own blocks of its noisy frame
(chip_smoke's ``NOISY`` content, whose partition reaches 4x4): one encode
of the production path gives its schedule, modes and recon; per TU size 4
to 32, the fullest
level of the luma plan, its blocks predicted from that recon with their
given modes (C2), coded with the dead-zone quantizer (``dz<n>``) and with
RDOQ at the level loop's luma configuration (``rdoq<n>``), each held once
against the plain body on the card, then timed as in ``loopfilter``
(device ms and records of a profiler trace of 10 calls, the host ms of a
call that ends in a synchronize), with the blocks' count and the kernel's
own record (``kernel_ms``; a call's other two records are the fills of
its recon and level planes).

``frames`` times ``IntraEncoder.encode_frames`` on bench.py's four
distinct class-B frames (``synth_class_b`` seeds 0 to 3, the production
configuration) beside four ``encode_frame`` calls on them, in turns in one
process (encode s a frame: ``encode_frames_s``, ``encode_frame_s``), with
the medians of the encode_frame calls' ``last_stats`` stages (``fetch_s``,
``sao_s``, ``maps_s``, ``entropy_s`` and the device stages); the streams
of both forms must agree.

``loopfilter`` times the loop filters' public calls on the production
frame's own inputs, caught from one encode: ``deblock_frame`` on the
encoder's views of its recon with its tu4 map, and again with a seeded set
of inter maps; ``stats_dispatch`` on the encoder's originals and deblocked
planes; ``apply_sao_frame`` with the RDO's maps. For each call, the device
ms from a profiler trace of 10 calls after a warm-up trace, counting every
record (copies and uploads too: ``device_ms``, ``records`` a call, and
each record's ms by name), and the host ms of a call that ends in a
synchronize (median of 20). Beside them, the production mode's medians of
10 encodes and decodes: ``encode_s``, ``decode_s``, the encoder's
``loopfilter_s``, ``fetch_s`` and ``sao_s`` and the decoder's
``loopfilter_s``.
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


def profile(fn):
    """Wall ms, busy ms, idle share and {record name: [ms, count]} of fn()
    on the card, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile as prof_
    torch.cuda.synchronize()
    with prof_(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    per, busy = {}, 0.0
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "CUDA")):
            continue
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = getattr(e, "self_cuda_time_total", 0.0)
        if dt:
            busy += dt / 1e3
            per[e.key[:90]] = [dt / 1e3, e.count]
    return {"wall_ms": wall, "busy_ms": busy,
            "idle_share": 1 - busy / wall if busy else None,
            "records": dict(sorted(per.items(), key=lambda kv: -kv[1][0]))}


def mesh_process() -> dict:
    """The mesh cell's times on this process's tree (see the header)."""
    import torch
    import chip_smoke as cs
    from hevc_hop_torch.models import wavefront_scan as ws
    from hevc_hop_torch.models.encoder import EncoderConfig, IntraEncoder
    from hevc_hop_torch.parallel import shard_encode
    cfg = EncoderConfig(width=cs.W, height=cs.H, **cs.MESH_CONFIG)
    frames = [cs.synth_class_b(cs.W, cs.H, seed=s) for s in cs.MESH_SEEDS]
    enc = shard_encode.MeshIntraEncoder(cfg, shard_encode.make_mesh(
        cs.MESH_SHAPE[0] * cs.MESH_SHAPE[1], band_par=cs.MESH_SHAPE[1]))
    single = IntraEncoder(cfg)
    want = enc.encode_frames(frames)
    if [single.encode_frame(*f) for f in frames] != want:
        raise SystemExit("the mesh's streams differ from the single-device "
                         "encoder's")
    mesh_s, single_s = [], []
    for _ in range(TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = enc.encode_frames(frames)
        torch.cuda.synchronize()
        mesh_s.append((time.perf_counter() - t0) / len(frames))
        if out != want:
            raise SystemExit("a later mesh encode differs")
        t0 = time.perf_counter()
        for f in frames:
            single.encode_frame(*f)
        torch.cuda.synchronize()
        single_s.append((time.perf_counter() - t0) / len(frames))
    host = {}

    def timed(name, fn):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            host[name] = host.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return call

    saved = ws.scan_encode
    ws.scan_encode = timed("scan_encode", saved)
    stages = ("_payload", "_gather", "_frame_stream")
    for k in stages:
        setattr(enc, k, timed(k, getattr(enc, k)))
    try:
        timed("total", enc.encode_frames)(frames)
    finally:
        ws.scan_encode = saved
        for k in stages:
            delattr(enc, k)
    profile(lambda: enc.encode_frames(frames))
    prof = profile(lambda: enc.encode_frames(frames))
    return {"encode_s": float(np.median(mesh_s)),
            "single_s": float(np.median(single_s)),
            "busy_ms": prof["busy_ms"], "idle_share": prof["idle_share"],
            "host_ms": host, "c13_launch": ws.LAST_LAUNCH,
            "encode_all": mesh_s, "single_all": single_s,
            "records": prof["records"]}


def analysis_process() -> dict:
    """The analysis cell's times on this process's tree (see the header)."""
    import torch
    import chip_smoke as cs
    from hevc_hop_torch.parallel import mesh as pmesh
    frames = torch.as_tensor(np.stack(
        [cs.synth_class_b(cs.W, cs.H, seed=s)[0] for s in cs.MESH_SEEDS])
        ).to("cuda")
    amesh = pmesh.make_mesh(4, row_par=2)
    n, band_h = 16, cs.H // 2
    halo = pmesh.band_halos(frames, band_h, 8)
    got = pmesh.analysis_step_sharded(frames, amesh, n)
    want = pmesh.analysis_blocks_plain(frames, halo, band_h, n)
    if any(not torch.equal(g, w) for g, w in zip(got, want)):
        raise SystemExit("the analysis differs from its plain version")
    return {"step_ms": cs.time_ms(
                lambda: pmesh.analysis_step_sharded(frames, amesh, n)),
            "kernel_ms": cs.time_ms(
                lambda: pmesh.analysis_blocks(frames, halo, band_h, n)),
            "blocks": int(got[0].numel())}


def loopfilter_process() -> dict:
    """The loopfilter mode's times on this process's tree (see the
    header)."""
    import torch
    import chip_smoke as cs
    from hevc_hop_torch.models import encoder as emod
    from hevc_hop_torch.models.decoder import Decoder
    from hevc_hop_torch.models.encoder import EncoderConfig, IntraEncoder
    from hevc_hop_torch.ops import sao
    frame = cs.synth_class_b(1920, 1088, seed=0)
    enc = IntraEncoder(EncoderConfig(width=1920, height=1088, qp=32,
                                     **PATHS["production"]))
    caught = {}

    def catch(mod, name):
        fn = getattr(mod, name)

        def call(*a, **k):
            caught[name] = (a, k)
            return fn(*a, **k)
        setattr(mod, name, call)
        return fn

    saved = [(emod.deblock, "deblock_frame"), (emod.sao, "stats_dispatch"),
             (sao, "apply_sao_frame")]
    saved = [(m, n, catch(m, n)) for m, n in saved]
    try:
        stream = enc.encode_frame(*frame)
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
    torch.cuda.synchronize()
    (da, dk), (sa, sk), (aa, ak) = (caught[n] for n in (
        "deblock_frame", "stats_dispatch", "apply_sao_frame"))
    dev = da[0].device
    rng = np.random.default_rng(17)
    u = (1088 // 4, 1920 // 4)
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)
    inter = dict(pred4=t(rng.random(u) < 0.3, torch.uint8),
                 cbf4=t(rng.random(u) < 0.3, torch.uint8),
                 ref4=t(rng.random(u) < 0.1, torch.uint8),
                 mv4x=t(rng.integers(-6, 7, u), torch.int16),
                 mv4y=t(rng.integers(-6, 7, u), torch.int16))
    calls = {
        "deblock_intra": lambda: emod.deblock.deblock_frame(*da, **dk),
        "deblock_inter": lambda: emod.deblock.deblock_frame(*da, **dk,
                                                            **inter),
        "stats_dispatch": lambda: sao.stats_dispatch(*sa, **sk),
        "apply_sao_frame": lambda: sao.apply_sao_frame(*aa, **ak)}
    out = _timed_calls(calls)
    Decoder().decode_stream(stream)
    keys = ("encode_s", "decode_s", "enc_loopfilter_s", "fetch_s", "sao_s",
            "dec_loopfilter_s")
    vals = {k: [] for k in keys}
    for _ in range(TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc.encode_frame(*frame)
        torch.cuda.synchronize()
        vals["encode_s"].append(time.perf_counter() - t0)
        for k in ("fetch_s", "sao_s"):
            vals[k].append(enc.last_stats[k])
        vals["enc_loopfilter_s"].append(enc.last_stats["loopfilter_s"])
        t0 = time.perf_counter()
        dec = Decoder()
        dec.decode_stream(stream)
        torch.cuda.synchronize()
        vals["decode_s"].append(time.perf_counter() - t0)
        vals["dec_loopfilter_s"].append(dec.last_stats["loopfilter_s"])
        if dec.hash_ok != [True]:
            raise SystemExit("the decoded picture's hash does not verify")
    out.update({k: float(np.median(v)) for k, v in vals.items()})
    out["all"] = vals
    return out


FRAMES_STAGES = ("upload_s", "decide_s", "scan_s", "loopfilter_s",
                 "fetch_s", "sao_s", "maps_s", "entropy_s", "checksum_s")


def frames_process() -> dict:
    """The frames mode's times on this process's tree (see the header)."""
    import torch
    import chip_smoke as cs
    from hevc_hop_torch.models.encoder import EncoderConfig, IntraEncoder
    frames = [cs.synth_class_b(1920, 1088, seed=s) for s in range(4)]
    enc = IntraEncoder(EncoderConfig(width=1920, height=1088, qp=32,
                                     **PATHS["production"]))
    want = [enc.encode_frame(*f) for f in frames]
    if enc.encode_frames(frames) != want:
        raise SystemExit("encode_frames differs from encode_frame")
    times = {"encode_frames_s": [], "encode_frame_s": []}
    split = {k: [] for k in FRAMES_STAGES}
    for turn in range(TIMED):
        order = ("encode_frames_s", "encode_frame_s")
        for form in (order if turn % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if form == "encode_frames_s":
                out = enc.encode_frames(frames)
            else:
                out = []
                for f in frames:
                    out.append(enc.encode_frame(*f))
                    for k in split:
                        split[k].append(enc.last_stats.get(k))
            torch.cuda.synchronize()
            times[form].append((time.perf_counter() - t0) / len(frames))
            if out != want:
                raise SystemExit(f"a later {form[:-2]} turn differs")
    med = lambda xs: (float(np.median(xs)) if None not in xs else None)
    return {**{k: med(v) for k, v in times.items()},
            **{k: med(v) for k, v in split.items()},
            "all": times}


def _timed_calls(calls: dict) -> dict:
    """Each call's device ms and records from a profiler trace of 10 calls
    after a warm-up trace (every record counted), its records' ms by
    name, and the host ms of a call that ends in a synchronize (median of
    20 after 2, and their quartiles)."""
    import torch
    out = {}
    for name, fn in calls.items():
        host = []
        for _ in range(22):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        profile(lambda: [fn() for _ in range(10)])
        prof = profile(lambda: [fn() for _ in range(10)])
        out[name] = {"device_ms": prof["busy_ms"] / 10,
                     "records": sum(c for _, c in prof["records"].values())
                     / 10,
                     "host_ms": float(np.median(host[2:])),
                     "host_quartiles": [float(q) for q in np.percentile(
                         host[2:], (25, 75))],
                     "by_record": {k: [v[0] / 10, v[1] / 10]
                                   for k, v in prof["records"].items()}}
    return out


_EMPTY_SRC = r"""
__global__ void __launch_bounds__(128) empty_kernel() {}
extern "C" int ab_empty_launch(int gx, int gy, void *stream) {
  empty_kernel<<<dim3(gx, gy), 128, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
"""


def empty_launch(gx: int, gy: int):
    """A call that launches an empty kernel of gx x gy CTAs of 128 threads
    on the current stream, built once with the tree's nvcc flags."""
    import ctypes
    import torch
    from hevc_hop_torch import _cuda
    os.makedirs(_cuda.BUILD, exist_ok=True)
    src = os.path.join(_cuda.BUILD, "ab_empty.cu")
    lib = os.path.join(_cuda.BUILD, "libab_empty.so")
    with open(src, "w") as f:
        f.write(_EMPTY_SRC)
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", lib, src],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(lib).ab_empty_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

    def launch():
        err = fn(gx, gy, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"empty launch: CUDA error {err}")
    return launch


def checksum_decide_process() -> dict:
    """The checksum_decide mode's times on this process's tree (see the
    header)."""
    import torch
    import chip_smoke as cs
    from hevc_hop_torch.models import partition
    from hevc_hop_torch.models.decoder import Decoder
    from hevc_hop_torch.models.encoder import EncoderConfig, IntraEncoder
    from hevc_hop_torch.ops import hashes
    frame = cs.synth_class_b(1920, 1088, seed=0)
    enc = IntraEncoder(EncoderConfig(width=1920, height=1088, qp=32,
                                     **PATHS["production"]))
    caught = {}
    saved = [(hashes, "plane_checksums"), (partition, "_decide")]

    def catch(mod, name):
        fn = getattr(mod, name)

        def call(*a, **k):
            caught.setdefault(name, (a, k))
            return fn(*a, **k)
        setattr(mod, name, call)
        return fn

    saved = [(m, n, catch(m, n)) for m, n in saved]
    try:
        stream = enc.encode_frame(*frame)
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
    torch.cuda.synchronize()
    (ca, ck), (da, dk) = caught["plane_checksums"], caught["_decide"]
    calls = {"checksum": lambda: hashes.plane_checksums(*ca, **ck),
             "decide": lambda: partition._decide(*da, **dk)}
    out = _timed_calls(calls)
    # C1's kernel alone with the L2 flushed before each call
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")

    def cold():
        for _ in range(10):
            flush.fill_(0)
            calls["checksum"]()
    profile(cold)
    recs = [v for k, v in profile(cold)["records"].items()
            if "checksum_kernel" in k]
    out["checksum"]["flushed_ms"] = (sum(v[0] for v in recs)
                                     / sum(v[1] for v in recs))
    by, bx = da[3].shape
    empty = empty_launch((bx + 7) // 8, by)
    profile(empty)
    floor = profile(lambda: [empty() for _ in range(10)])
    out["decide"]["empty_launch_ms"] = floor["busy_ms"] / 10
    Decoder().decode_stream(stream)
    keys = ("encode_s", "decode_s", "decide_s", "checksum_s")
    vals = {k: [] for k in keys}
    for _ in range(TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        enc.encode_frame(*frame)
        torch.cuda.synchronize()
        vals["encode_s"].append(time.perf_counter() - t0)
        vals["decide_s"].append(enc.last_stats["decide_s"])
        t0 = time.perf_counter()
        dec = Decoder()
        dec.decode_stream(stream)
        torch.cuda.synchronize()
        vals["decode_s"].append(time.perf_counter() - t0)
        vals["checksum_s"].append(dec.last_stats["checksum_s"])
        if dec.hash_ok != [True]:
            raise SystemExit("the decoded picture's hash does not verify")
    out.update({k: float(np.median(v)) for k, v in vals.items()})
    out["all"] = vals
    return out


def tq_encode_process() -> dict:
    """The tq_encode mode's times on this process's tree (see the
    header)."""
    import torch
    import chip_smoke as cs
    from hevc_hop_torch.models.encoder import EncoderConfig, IntraEncoder
    from hevc_hop_torch.ops import intra, tq
    frame = cs.synth_class_b(1920, 1088, **cs.NOISY)
    enc = IntraEncoder(EncoderConfig(width=1920, height=1088, qp=32,
                                     **PATHS["production"]))
    st = enc._stage1(*frame)
    enc._stage2(st)
    sched = st["sched"]
    modes = enc._given_modes(sched, st["maps"].mode4.astype(np.int32))
    plane, _, org, _ = cs._padded_planes(enc, frame, st["recon"])
    rcfg = cs.rdoq_configs(True)[0]
    calls, blocks, mism = {}, {}, 0
    for log2, p in sorted(sched.plans.items()):
        s = int(np.argmax(p.cnt))
        o, c = int(p.off[s]), int(p.cnt[s])
        if c == 0:
            continue
        n = 1 << log2
        pos, best = p.pos[o:o + c], modes[log2][0][o:o + c]
        pred = intra.intra_blocks(plane, pos, p.avail[o:o + c], best, n,
                                  0)[0]
        for arm, rq in (("dz", None), ("rdoq", rcfg)):
            def call(fn=tq.tq_encode, n=n, pos=pos, best=best, pred=pred,
                     rq=rq):
                rec = torch.zeros_like(org)
                cp = torch.zeros(org.shape, dtype=torch.int16,
                                 device=org.device)
                return fn(org, pred, pos, best, n, 0, 32, 8, True, rq, rec,
                          cp), rec, cp
            got, want = call(), call(tq.tq_encode_plain)
            mism += sum(int((a != b).sum()) for a, b in zip(got, want))
            calls[f"{arm}{n}"] = call
            blocks[f"{arm}{n}"] = c
    if mism:
        raise SystemExit(f"tq_encode: {mism} elements differ from the "
                         "plain body")
    out = _timed_calls(calls)
    for k, v in out.items():
        v["blocks"] = blocks[k]
        v["kernel_ms"] = sum(ms for name, (ms, _) in v["by_record"].items()
                             if "tq_encode" in name)
    return out


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
    if path == "analysis":
        _cuda.lib("intra")
        print(json.dumps({"tree": tree, "path": path,
                          "card": torch.cuda.get_device_name(0),
                          **analysis_process()}), flush=True)
        return
    _cuda.build_all()
    native.get_lib()
    if path in ("mesh", "loopfilter", "checksum_decide", "tq_encode",
                "frames"):
        run = {"mesh": mesh_process, "loopfilter": loopfilter_process,
               "checksum_decide": checksum_decide_process,
               "tq_encode": tq_encode_process,
               "frames": frames_process}[path]
        print(json.dumps({"tree": tree, "path": path,
                          "card": torch.cuda.get_device_name(0),
                          **run()}), flush=True)
        return
    frame = chip_smoke.synth_class_b(1920, 1088, seed=0)
    enc = IntraEncoder(EncoderConfig(width=1920, height=1088, qp=32,
                                     **PATHS[path]))
    stream = enc.encode_frame(*frame)
    Decoder().decode_stream(stream)
    torch.cuda.synchronize()
    enc_s, dec_s, ent_s, scan_s, dscan_s, resi_s, probes = ([] for _ in
                                                           range(7))
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
        resi_s.append(getattr(dec, "last_stats", {}).get("residual_s"))
        if dec.hash_ok != [True]:
            raise SystemExit("the decoded picture's hash does not verify")
    profile(lambda: Decoder().decode_stream(stream))
    c3 = [v for k, v in profile(lambda: Decoder().decode_stream(stream))[
        "records"].items() if "tq_decode_kernel" in k]
    med = lambda xs: (float(np.median(xs)) if xs and None not in xs
                      else None)
    print(json.dumps({"tree": tree, "path": path,
                      "card": torch.cuda.get_device_name(0),
                      "encode_s": float(np.median(enc_s)),
                      "decode_s": float(np.median(dec_s)),
                      "entropy_s": float(np.median(ent_s)),
                      "scan_s": float(np.median(scan_s)),
                      "decode_scan_s": med(dscan_s),
                      "residual_s": med(resi_s),
                      "c3_decode_device_ms": sum(v[0] for v in c3),
                      "c3_decode_records": sum(v[1] for v in c3),
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
    calls = {"loopfilter": ("deblock_intra", "deblock_inter",
                            "stats_dispatch", "apply_sao_frame"),
             "checksum_decide": ("checksum", "decide"),
             "tq_encode": tuple(f"{a}{n}" for a in ("dz", "rdoq")
                                for n in (4, 8, 16, 32))}.get(path, ())
    # a TU size the frame lacks has no call
    calls = tuple(c for c in calls
                  if all(c in r for rs in runs.values() for r in rs))
    fields = {c: ("device_ms", "records", "host_ms") for c in calls}
    if path == "checksum_decide":
        fields["checksum"] += ("flushed_ms",)
        fields["decide"] += ("empty_launch_ms",)
    if path == "tq_encode":
        fields = {c: f + ("kernel_ms",) for c, f in fields.items()}
    # each call's device ms, records and host ms as keys of their own
    for rs in runs.values():
        for r in rs:
            for c in calls:
                for k in fields[c]:
                    r[f"{c}.{k}"] = r[c][k]
    med = lambda rs, k: float(np.median([r[k] for r in rs]))
    keys = {"mesh": ("encode_s", "single_s", "busy_ms"),
            "analysis": ("step_ms", "kernel_ms"),
            "loopfilter": tuple(f"{c}.{k}" for c in calls
                                for k in fields[c]) + (
                "encode_s", "decode_s", "enc_loopfilter_s", "fetch_s",
                "sao_s", "dec_loopfilter_s"),
            "checksum_decide": tuple(f"{c}.{k}" for c in calls
                                     for k in fields[c]) + (
                "encode_s", "decode_s", "decide_s", "checksum_s"),
            "tq_encode": tuple(f"{c}.{k}" for c in calls
                               for k in fields[c]),
            # checksum_s is absent from a tree whose encoder lacks it
            "frames": ("encode_frames_s", "encode_frame_s")
            + FRAMES_STAGES[:-1]}.get(
        path, ("encode_s", "decode_s", "residual_s", "c3_decode_device_ms",
               "entropy_s", "scan_s"))
    print(json.dumps({name: {k: med(runs[tree], k) for k in keys}
                      for name, tree in (("parent", parent),
                                         ("change", change))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
