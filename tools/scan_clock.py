"""Kernel C13's, kernel C5's and C2's analysis entry's device times on one
tree, and C13's stage split, on the card.

    python3 tools/scan_clock.py <tree> [out.json]

imports <tree>'s chip_smoke and hevc_hop_torch (a checkout, or one
unpacked with git archive), builds its kernels, and on chip_smoke's
production, quadtree and uniform 1920x1088 frames times C13's encode (and
the production decode) with CUDA events, and the host's time per encode
call; where <tree>'s chip_smoke has C13's stage clocks
(scan_stage_split) it builds them (-DHH_STAGE_CLOCK), runs the encode
once more with them (chip_smoke._ClockLibrary), and prints the split
(chip_smoke.scan_stage_split) and, on the given-mode paths, one block's
latency in C3's body (block_latency). Then C5's RD entry per block size and its
two forced arms, and C2's analysis entry on the mesh path's two frames.
Prints the card's name and power limit, and the results as one JSON
object on its last line (also written to out.json where given). Run two
trees in turns in one call to compare them.
"""
import ctypes
import json
import os
import subprocess
import sys
import time

tree = os.path.abspath(sys.argv[1])
OUT = os.path.abspath(sys.argv[2]) if len(sys.argv) > 2 else None
sys.path.insert(0, tree)
os.chdir(tree)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from hevc_hop_torch import _cuda  # noqa: E402
from hevc_hop_torch.models import partition  # noqa: E402
from hevc_hop_torch.models import wavefront_scan as ws  # noqa: E402
from hevc_hop_torch.models.encoder import EncoderConfig, IntraEncoder  # noqa
from hevc_hop_torch.parallel import mesh as pmesh  # noqa: E402


def events_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return float(np.median(out)), out


def host_us(fn, reps=10):
    """The host's time per call, in us, over reps calls enqueued one after
    another (read before the device has finished them)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def block_latency(clk, work, grid):
    """One block's ns in C3's encode body (the stages from the forward
    transform to the recon, chip_smoke.C13_MARKS), median over the blocks
    of each plane kind and size, from C13's clocks clk [levels, CTAs,
    C13_CLOCK] of a given-mode encode: in a level whose three tasks per
    item fit the grid, CTA t ran task t (item t % items, plane t //
    items) alone."""
    marks = list(cs.C13_MARKS)
    nm, lo = len(marks), marks.index("fwd")
    off, items = work.host_off, work.host_items
    per = {}
    for s in range(len(off) - 1):
        lv = items[off[s]:off[s + 1]]
        cnt = len(lv)
        if 3 * cnt > grid:
            continue
        for t in range(3 * cnt):
            it, plane = lv[t % cnt], t // cnt
            if plane and it[2] < 0:
                continue
            log2 = int(it[0])
            n = 1 << (log2 if plane == 0 else max(log2 - 1, 2))
            ns = int(clk[s, t, plane * nm + lo:plane * nm + nm].sum())
            per.setdefault(f"{'chroma' if plane else 'luma'} {n}",
                           []).append(ns)
    return {k: {"median_ns": float(np.median(v)), "blocks": len(v)}
            for k, v in sorted(per.items())}


def main():
    t0 = time.perf_counter()
    _cuda.build_all()
    so = (_cuda.variant("scan", "clock", cs.CLOCK_FLAGS)
          if hasattr(cs, "scan_stage_split") else None)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    if so is not None:
        set_clock = so.hh_scan_clock
        set_clock.argtypes = [ctypes.c_void_p, ctypes.c_int]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    res = {"card": smi, "tree": tree}
    for name, extra in (("production", dict(sao=True)),
                        ("quadtree", dict(sao=True, rdoq=False)),
                        ("uniform", dict(cu_log2=4, rdoq=False))):
        enc = IntraEncoder(EncoderConfig(width=cs.W, height=cs.H, qp=cs.QP,
                                         **extra))
        frame = cs.synth_class_b(cs.W, cs.H, seed=0)
        args, kws, sched = cs._scan_inputs(enc, frame)
        work = sched.work
        want = ws.scan_encode(*args, **kws, work=work)
        ems, eall = events_ms(lambda: ws.scan_encode(*args, **kws, work=work))
        rec = {"encode_ms": ems, "encode_all": eall,
               "host_us": host_us(lambda: ws.scan_encode(*args, **kws,
                                                         work=work)),
               "launch": ws.LAST_LAUNCH, "items": len(work.host_items),
               "levels": len(work.host_off) - 1, "widest": work.widest}
        if name == "production":
            dec_in = cs._scan_decode_inputs(args, sched, want)
            dargs = (*dec_in[:2], sched.plans, sched.nsteps, *dec_in[2:],
                     args[6], args[7])
            dms, dall = events_ms(lambda: ws.scan_decode(*dargs, work=work))
            rec.update(decode_ms=dms, decode_all=dall)
        if so is None:
            print(name, json.dumps(rec), flush=True)
            res[name] = rec
            continue
        levels = len(work.host_off) - 1
        ctas = torch.cuda.get_device_properties(0).multi_processor_count * 8
        buf = torch.zeros((levels, ctas, cs.C13_CLOCK), dtype=torch.int64,
                          device="cuda")
        with cs._ClockLibrary(so, "scan"):
            torch.cuda.synchronize()
            _cuda.check("scan", set_clock(buf.data_ptr(), ctas))
            got = ws.scan_encode(*args, **kws, work=work)
            torch.cuda.synchronize()
            _cuda.check("scan", set_clock(None, 0))
        mism = sum(int((a.to(torch.int64) != b.to(torch.int64)).sum())
                   for a, b in zip(got[:4], want[:4]))
        rec["clock_build_mismatches"] = mism
        rec["clock_launch"] = ws.LAST_LAUNCH
        clk = buf[:, :ws.LAST_LAUNCH[0]].cpu().numpy()
        rec["split"] = cs.scan_stage_split(clk)
        if name != "uniform" and "fwd" in cs.C13_MARKS:
            rec["block_latency"] = block_latency(clk, work,
                                                 ws.LAST_LAUNCH[0])
        print(name, json.dumps(rec), flush=True)
        res[name] = rec
    # C5 per size on the production frame's luma
    y = torch.as_tensor(np.asarray(cs.synth_class_b(cs.W, cs.H, seed=0)[0],
                                   np.int32), device="cuda")
    c5 = {}
    for n in (4, 8, 16, 32):
        c5[n] = events_ms(lambda: partition.rd_costs(y, n, cs.QP, 8))[0]
    m16 = partition.rd_costs(y, 16, cs.QP, 8)[1]
    forced = m16.repeat_interleave(2, 0).repeat_interleave(2, 1).contiguous()
    c5["8f"] = events_ms(lambda: partition.rd_costs_forced(
        y, forced, 8, cs.QP, 8))[0]
    m32 = partition.rd_costs(y, 32, cs.QP, 8)[1]
    f16 = m32.repeat_interleave(2, 0).repeat_interleave(2, 1).contiguous()
    c5["16f"] = events_ms(lambda: partition.rd_costs_forced(
        y, f16, 16, cs.QP, 8))[0]
    res["c5_ms"] = c5
    print("c5", json.dumps(c5), flush=True)
    # C2's analysis entry (K20) on the mesh path's two frames
    fr = torch.as_tensor(np.stack([cs.synth_class_b(cs.W, cs.H, seed=s)[0]
                                   for s in cs.MESH_SEEDS]).astype(np.int32),
                         device="cuda")
    halo = pmesh.band_halos(fr, cs.H // 2, 8)
    res["k20_ms"] = events_ms(lambda: pmesh.analysis_blocks(
        fr, halo, cs.H // 2, cs.ANALYSIS_N))
    print("k20", json.dumps(res["k20_ms"]), flush=True)
    if OUT is not None:
        with open(OUT, "w") as f:
            json.dump(res, f)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
