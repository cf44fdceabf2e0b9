"""Kernel C14's device times and stage split on one tree, kernels C10's
and C12's entries, and kernel C9's pre-pass entry, on the card.

    python3 tools/ss_clock.py <tree> [out.json] [c14] [prepass]

(both parts where none is named)

imports <tree>'s chip_smoke and hevc_hop_torch (a checkout, or one
unpacked with git archive) and builds its kernels. On chip_smoke's iss,
iss-uniform, iss-gt and iss-gt-warped 1920x1088 frames and on the last PSS
picture of pss-gt it times C14's encode with CUDA events (median of 5),
and iss-gt-warped's encode s through the encoder (median of 3); it times
C14's decode of each picture (the decoder's own inputs for the encoder's
stream) with CUDA events too (median of 5) and, where the tree's clock
build stamps the decode (ss_scan.cu DecStamp), splits one clocked decode
per group into its intra and inter CUs (decode_split). With
C14's stage clocks (chip_smoke.stage_split; the library built with
-DHH_STAGE_CLOCK) it runs each encode once more, counts the elements that
differ from the production library's, and prints the split: per stage
the longest CTA of each group summed over the groups, and the arms step
(the stages between cluster syncs 2 and 3), per group its longest CTA,
its longest C10 chain and its longest C12 anchor, summed; and the decide
and chroma stages by CU kind (kinds): each group's leader CTAs (rank 0
of a cluster) stamp the last CU their cluster read in the group, a GT
candidate (its GT cost beats C10's and its corners are not all zero, as
the scratch that C14's argument block names shows after the launch:
ScratchTap), another inter CU or an intra one, with the count and share
of each kind in the picture. Then C10's arms entry and C12's search and
decide entries on the inputs the level
loop gives them at the fullest level (iss-gt-warped 16x16; pss-gt's
last PSS picture), timed with CUDA events (median of 21) and held against
their plain bodies on the card.

``prepass``: C9's pre-pass entry at the three sizes (8, 16, 32) on two
pictures at 1920x1088, QP 32, radius 32, MI 16: ``iss``, chip_smoke's
``lenslet_frame`` luma with the SS arm alone, and ``pss``, the second
picture of chip_smoke's ``pss_frames`` with the temporal arm (radius 16)
over the first picture's recon as the pss-gt configuration codes it. Per
(picture, size): the launch's CUDA-event ms (median of 7), the costs not
bit-equal to the plain body's on the card, a grouped ``conv2d`` of the
same blocks' correlations alone (float32, windows cut out beforehand;
``conv_ms``) and, where the tree's ``csrc/ss_search.cu`` has the
pre-pass's stage clocks (``hh_ss_rd_clock`` in the -DHH_STAGE_CLOCK
build), one clocked launch: per stage (staging, org^2, the SS search, the
temporal search, the transform round trip, the tail) the CTAs' summed
nanoseconds and that share of the launch's ms; the clocked costs must
equal the production build's.

ptxas's report of C14's four encode kernels (registers, stack, spill
stores and loads; ptxas_encode) is printed after the build.

Prints the card's name and power limit, and the results as one JSON
object on its last line (also written to out.json where given). Run two
trees in turns in one call to compare them.
"""
import ctypes
import json
import os
import re
import subprocess
import sys
import time

tree = os.path.abspath(sys.argv[1])
OUT = next((os.path.abspath(a) for a in sys.argv[2:] if a.endswith(".json")),
           None)
PARTS = [a for a in sys.argv[2:] if a in ("c14", "prepass")] or ["c14",
                                                                 "prepass"]
sys.path.insert(0, tree)
os.chdir(tree)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from hevc_hop_torch import _cuda  # noqa: E402
from hevc_hop_torch.models import partition, ss_partition  # noqa: E402
from hevc_hop_torch.models import ss_scan, wavefront  # noqa: E402
from hevc_hop_torch.models.ss_encoder import HoloConfig, HoloEncoder  # noqa
from hevc_hop_torch.ops import gt, inter_arms as ia  # noqa: E402

PATHS = ("iss", "iss-uniform", "iss-gt", "iss-gt-warped")
ENTRY_REPS = 21
# the pre-pass's stage-clock slots (ss_search.cu RdStage): the stages, then
# the CTA's whole time and its SM + 1
RD_STAGES = ("staging", "org2", "ss_search", "temporal_search", "transform",
             "tail")
RD_SLOTS = 8


def events_ms(fn, reps=5, setup=None):
    """Median ms of fn() over reps calls, each timed with CUDA events
    (setup() before each, outside the events); every time."""
    (setup or (lambda: None))()
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        if setup is not None:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return float(np.median(out)), out


def durations(clk):
    """Per stage of chip_smoke.CLOCK_STAGES, the ns each CTA of each group
    spent in it ([groups, CTAs], from its previous stamp)."""
    last = clk[:, :, 0].copy()
    out = {}
    for name, k in cs.CLOCK_STAGES:
        s = clk[:, :, k]
        out[name] = np.where(s > 0, s - last, 0)
        last = np.where(s > 0, s, last)
    return out


def arms_step(clk):
    """The arms step from the stamps: the stages between cluster syncs 2
    and 3, per group the longest CTA (step), the longest CTA's C10 stages
    (c10) and C12 anchor stages (c12), us summed over the groups; and C10's
    stages after cluster sync 3 (the tournament where it runs there)."""
    d = durations(clk)
    names = [nm for nm, _ in cs.CLOCK_STAGES]
    lo, hi = names.index("cluster sync 2"), names.index("cluster sync 3")
    step = names[lo + 1:hi]
    tot = lambda sel: sum(d[nm] for nm in sel) if sel else 0 * d[names[0]]
    us = lambda v: float(v.max(axis=1).sum() / 1e3)
    c10 = [nm for nm in step if nm.startswith("C10")]
    c12 = [nm for nm in step if nm.startswith("C12")]
    after = [nm for nm in names[hi + 1:] if nm.startswith("C10")]
    return {"step_us": us(tot(step)), "c10_us": us(tot(c10)),
            "c12_us": us(tot(c12)), "c10_after_sync3_us": us(tot(after)),
            "stages": step}


def decode_split(clk):
    """C14's decode from its stamps clk [groups, CTAs, CLOCK_STAMPS]
    (ss_scan.cu DecStamp: slot 0 the group's start, 1 and 2 the ns a CTA
    spent in its intra and its inter CUs, 3 its way out of the grid sync),
    us summed over the groups: the groups' time (first start to the last
    CTA out), the slowest CTA's (the most ns in CUs) intra and inter ns,
    the longest intra and the longest inter CTA, and the count of groups
    whose slowest CTA spent more in intra CUs than in inter ones."""
    clk = np.asarray(clk, dtype=np.int64)
    intra, inter = clk[:, :, 1], clk[:, :, 2]
    slow = (intra + inter).argmax(axis=1)
    gi = np.arange(clk.shape[0])
    si, se = intra[gi, slow], inter[gi, slow]
    start = np.where(clk[:, :, 0] > 0, clk[:, :, 0],
                     np.iinfo(np.int64).max).min(axis=1)
    end = clk[:, :, 3].max(axis=1)
    us = lambda v: float(np.asarray(v).sum() / 1e3)
    return {"groups": int(clk.shape[0]), "groups_us": us(end - start),
            "slowest_cta_intra_us": us(si), "slowest_cta_inter_us": us(se),
            "intra_cta_max_us": us(intra.max(axis=1)),
            "inter_cta_max_us": us(inter.max(axis=1)),
            "intra_led_groups": int((si > se).sum()),
            "inter_groups": int((inter.max(axis=1) > 0).sum())}


def decode_part(so, fn, groups):
    """C14's decode of one picture: CUDA-event ms (median of 5) and, where
    the clock build stamps the decode, one clocked run held against the
    production library's and split (decode_split)."""
    want = fn()
    ms, allms = events_ms(fn)
    rec = {"decode_ms": ms, "decode_all": allms}
    got, clk, launch = clocked(so, fn, groups)
    if clk[:, :, 1:3].any():
        rec["decode_clock_build_mismatches"] = mism(got, want)
        rec["decode_split"] = decode_split(clk)
    return rec


def placement(clk, per_cu):
    """Where the launch's CTAs ran (chip_smoke.CLOCK_SM): the SMs used, and
    per pair of ranks of a cluster the clusters that put both on one SM."""
    sm = clk[:, :, cs.CLOCK_SM].max(axis=0) - 1
    ranks = sm.reshape(-1, per_cu)
    mates = [[int((ranks[:, r] == ranks[:, q]).sum()) if r != q else 0
              for q in range(per_cu)] for r in range(per_cu)]
    return {"sms": int(len(set(sm.tolist()))), "ctas": int(len(sm)),
            "same_sm_rank_pairs": mates}


def clone(v):
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, tuple):
        return tuple(clone(x) for x in v)
    return v


class Recorder:
    """Within it, ss_scan's calls of C10's arms entry and C12's step keep
    a copy of the arguments of the call with the most blocks."""

    def __enter__(self):
        self.saved = (ss_scan.inter_arms, ss_scan.gt_step)
        self.calls = {}

        def wrap(key, fn):
            def call(*a, **k):
                b = a[3].shape[0] if key == "C12" else a[2].shape[0]
                if b > self.calls.get(key, (0,))[0]:
                    self.calls[key] = (b, clone(a), clone(k))
                return fn(*a, **k)
            return call

        ss_scan.inter_arms = wrap("C10", self.saved[0])
        ss_scan.gt_step = wrap("C12", self.saved[1])
        return self

    def __exit__(self, *exc):
        ss_scan.inter_arms, ss_scan.gt_step = self.saved


def mism(a, b):
    return sum(int((x.to(torch.int64) != y.to(torch.int64)).sum())
               if x.dtype != torch.float32 else
               int((x.view(torch.int32) != y.view(torch.int32)).sum())
               for x, y in zip(a, b))


def entries(calls):
    """C10 and C12 on the recorded arguments: ms, and elements that differ
    from the plain bodies (outputs and in-place planes, floats bit for
    bit)."""
    out = {}
    b, a, k = calls["C10"]
    n = a[13]

    def run(fn):
        x = clone(a)
        r = fn(*x, **clone(k))
        return tuple(r) + (x[11],)

    got, want = run(ia.inter_arms), run(ia.inter_arms_plain)
    arg = {}
    ms, allms = events_ms(lambda: ia.inter_arms(*arg["a"], **arg["k"]),
                          reps=ENTRY_REPS,
                          setup=lambda: arg.update(a=clone(a), k=clone(k)))
    out["C10"] = {"blocks": b, "n": n, "ms": ms, "all": allms,
                  "mismatches": mism(got, want)}
    b, a, k = calls["C12"]

    def run12(fn):
        x = clone(a)
        r = fn(*x, **clone(k))
        return tuple(r) + tuple(t for t in x[11:15] + x[22:]
                                if t is not None)

    got, want = run12(gt.gt_step), run12(gt.gt_step_plain)
    ms, allms = events_ms(lambda: gt.gt_step(*arg["a"], **arg["k"]),
                          reps=ENTRY_REPS,
                          setup=lambda: arg.update(a=clone(a), k=clone(k)))
    out["C12"] = {"blocks": b, "n": a[15], "ms": ms, "all": allms,
                  "mismatches": mism(got, want),
                  "gt_won": int(got[0].sum())}
    return out


class ScratchTap:
    """Within it, each launch of C14's encode (models/ss_scan.py _launch
    with hh_ss_scan_encode) keeps a copy of the decision's inputs that the
    launch's argument block names per size (_SsSizeIn: costs, s_cost,
    s_ok, s_gtc; the GT words only on a size with GT), read once the
    launch has run: {log2: {name: tensor}}. ``outs`` gives the sizes and
    their CU counts (the encode's outputs by log2, inter first)."""

    # name -> (shape after the CU count, typestr); costs' width by PSS
    WORDS = {"s_cost": ((2,), "<f4"), "s_ok": ((2,), "<i4"),
             "s_gtc": ((2, 6), "<i4")}

    def __init__(self, outs, pss):
        self.cus = {lg: int(o[0].shape[0]) for lg, o in outs.items()}
        self.words = dict(self.WORDS, costs=((4 if pss else 3,), "<f4"))

    def read(self, z, t):
        out = {}
        for nm, (shape, typestr) in self.words.items():
            ptr = getattr(z, nm)
            if ptr:
                view = type("View", (), {"__cuda_array_interface__": {
                    "shape": (t,) + shape, "typestr": typestr,
                    "data": (ptr, False), "version": 2}})()
                out[nm] = torch.as_tensor(view, device="cuda").clone()
        return out

    def __enter__(self):
        self.orig, self.sizes = ss_scan._launch, None

        def launch(entry, sig, a, *extra, **k):
            r = self.orig(entry, sig, a, *extra, **k)
            if entry == "hh_ss_scan_encode":
                torch.cuda.synchronize()
                self.sizes = {lg: self.read(a.size[lg - 3], t)
                              for lg, t in self.cus.items()}
            return r

        ss_scan._launch = launch
        return self

    def __exit__(self, *exc):
        ss_scan._launch = self.orig


def candidates(s, pss):
    """GT candidates [T] bool from one size's scratch: the cheaper anchor
    (the first among equals), a causal one, its corners not all zero, its
    cost below C10's intra, merge, SS (and temporal) costs."""
    if "s_cost" not in s:
        return torch.zeros(s["costs"].shape[0], dtype=torch.bool,
                           device=s["costs"].device)
    c0, c1 = s["s_cost"].unbind(1)
    ai = (c1 < c0).long()
    ar = torch.arange(c0.shape[0], device=c0.device)
    g = torch.where(c1 < c0, c1, c0)
    cand = (s["s_ok"] != 0).any(1) & (s["s_gtc"][ar, ai] != 0).any(1)
    for k in ((2, 0, 1, 3) if pss else (2, 0, 1)):
        cand &= g < s["costs"][:, k]
    return cand


def kinds(clk, sizes, outs, work, per_cu, pss):
    """The decide and chroma stages by CU kind (see the header): per kind
    the CUs of the picture, their share, the CUs whose leader stamps were
    read (the last of their cluster in a group), and those CUs' mean and
    summed decide and chroma us."""
    d = durations(clk)
    items = np.asarray(work.host_items)
    groups = np.asarray(work.host_groups)
    kind = {}
    for lg, s in sizes.items():
        cand = candidates(s, pss).cpu().numpy()
        inter = outs[lg][0].cpu().numpy() != 0
        kind[lg] = np.where(cand, 0, np.where(inter, 1, 2))
    names = ("gt_candidate", "other_inter", "intra")
    total = np.bincount(np.concatenate(list(kind.values())), minlength=3)
    rows = {k: [] for k in range(3)}
    clusters = clk.shape[1] // per_cu
    for g, (first, cnt, _) in enumerate(groups):
        for c in range(min(clusters, cnt)):
            last = first + c + (cnt - 1 - c) // clusters * clusters
            lg, row = int(items[last, 0]), int(items[last, 1])
            rows[int(kind[lg][row])].append(
                (d["C12 decide"][g, c * per_cu], d["chroma"][g, c * per_cu]))
    out = {}
    for k, nm in enumerate(names):
        v = np.asarray(rows[k], dtype=np.float64).reshape(-1, 2) / 1e3
        out[nm] = {"cus": int(total[k]),
                   "share": float(total[k] / max(total.sum(), 1)),
                   "stamped": int(len(v)),
                   "decide_us_mean": float(v[:, 0].mean()) if len(v) else 0.0,
                   "chroma_us_mean": float(v[:, 1].mean()) if len(v) else 0.0,
                   "decide_us_sum": float(v[:, 0].sum()),
                   "chroma_us_sum": float(v[:, 1].sum())}
    return out


def clocked(so, fn, groups):
    set_clock = so.hh_ss_scan_clock
    set_clock.argtypes = [ctypes.c_void_p, ctypes.c_int]
    ctas = torch.cuda.get_device_properties(0).multi_processor_count * 8
    buf = torch.zeros((groups, ctas, cs.CLOCK_STAMPS), dtype=torch.int64,
                      device="cuda")
    with cs._ClockLibrary(so):
        torch.cuda.synchronize()
        _cuda.check("ss_scan", set_clock(buf.data_ptr(), ctas))
        got = fn()
        torch.cuda.synchronize()
        _cuda.check("ss_scan", set_clock(None, 0))
        launch = ss_scan.LAST_LAUNCH
    grid = launch["grid"] if isinstance(launch, dict) else launch[0]
    return got, buf[:, :grid].cpu().numpy(), launch


def split(so, fn, want, work, pss=False):
    with ScratchTap(want[4], pss) as tap:
        got, clk, launch = clocked(so, fn, len(work.host_groups))
    rec = {"clock_build_mismatches": mism(got[:4], want[:4]),
           "clock_launch": launch, **cs.stage_split(clk), **arms_step(clk),
           "kinds": kinds(clk, tap.sizes, want[4], work,
                          launch["ctas_per_cu"], pss)}
    if hasattr(cs, "CLOCK_SM"):
        rec["placement"] = placement(clk, launch["ctas_per_cu"])
    return rec


def conv_ms(plane, y, pos, n, radius):
    """Device ms of a grouped conv2d of every block's window of plane
    against its n x n original of y (float32), the windows cut out
    beforehand."""
    ar = torch.arange(n + 2 * radius, device=y.device)
    ry = (pos[:, 1, None].long() - radius + ar).clamp(0, cs.H - 1)
    rx = (pos[:, 0, None].long() - radius + ar).clamp(0, cs.W - 1)
    win = plane[ry[:, :, None], rx[:, None, :]].float()[None]
    ak = torch.arange(n, device=y.device)
    org = y[pos[:, 1, None, None].long() + ak[:, None],
            pos[:, 0, None, None].long() + ak[None]].float()[:, None]
    return events_ms(lambda: torch.nn.functional.conv2d(
        win, org, groups=pos.shape[0]), reps=7)[0]


def rd_split(so, args, want, ms, blocks):
    """One launch of the pre-pass's clock build: the stages' summed CTA
    ns, each stage's share of the launch's ms, and where the CTAs ran."""
    clock = so.hh_ss_rd_clock
    clock.argtypes = [ctypes.c_void_p, ctypes.c_int]
    ctas = blocks * (2 if len(args) > 12 else 1)
    buf = torch.zeros((ctas, RD_SLOTS), dtype=torch.int64, device="cuda")
    with cs._ClockLibrary(so, "ss_search"):
        torch.cuda.synchronize()
        _cuda.check("ss_search", clock(buf.data_ptr(), ctas))
        got = ss_partition.ss_rd_costs(*args)
        torch.cuda.synchronize()
        _cuda.check("ss_search", clock(None, 0))
    sums = buf[:, :len(RD_STAGES)].sum(0).double().cpu().numpy()
    whole = float(sums.sum())
    ran = buf[:, 7] > 0
    return {"clock_build_equal": bool(torch.equal(got, want)),
            "split": {k: {"cta_ns": float(v), "share": float(v / whole),
                          "ms": float(ms * v / whole)}
                      for k, v in zip(RD_STAGES, sums)},
            "ctas": int(ran.sum()),
            "cta_us_mean": float(buf[ran, 6].double().mean().item() / 1e3),
            "sms": int(torch.unique(buf[ran, 7]).numel())}


def prepass():
    """The pre-pass part (see the header): {picture: {n: row}}."""
    so = _cuda.variant("ss_search", "clock", cs.CLOCK_FLAGS)
    has_clock = hasattr(so, "hh_ss_rd_clock")
    dev = torch.device("cuda")
    frames = cs.pss_frames(cs.W, cs.H, 2)
    enc = HoloEncoder(HoloConfig(width=cs.W, height=cs.H,
                                 **cs.ISS_PATHS["pss-gt"][0]))
    enc.encode_frame(*frames[0])
    ref = torch.as_tensor(np.ascontiguousarray(enc.recon_yuv[0], np.int32),
                          device=dev)
    pics = {"iss": (torch.as_tensor(cs.lenslet_frame(cs.W, cs.H, mi=16)[0],
                                    device=dev), None),
            "pss": (torch.as_tensor(frames[1][0], device=dev), ref)}
    lam = partition.full_lambda(cs.QP)
    zplane4 = wavefront.zaddr4_plane(cs.W, cs.H, 5)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                  device=dev)
    res = {"clock": has_clock}
    for name, (y, r) in pics.items():
        rec = {}
        for n in (8, 16, 32):
            ys, xs = np.mgrid[0:cs.H:n, 0:cs.W:n]
            ys, xs = ys.ravel(), xs.ravel()
            pos = t(np.stack([xs, ys], -1))
            args = (y, pos, t(zplane4[ys >> 2, xs >> 2]),
                    t(ss_scan.zmax_win_px(zplane4, n)), n, cs.QP, 8, 32,
                    cs.W, cs.H, 16, lam) + ((r, 16) if r is not None else ())
            want = ss_partition.ss_rd_costs(*args)
            ms, every = events_ms(lambda: ss_partition.ss_rd_costs(*args),
                                  reps=7)
            plain = ss_partition.ss_rd_costs_plain(*args)
            row = {"blocks": len(xs), "ms": ms, "all": every,
                   "not_bit_equal": int((want != plain).sum()),
                   "max_rel_err": float(((want.double() - plain.double())
                                         .abs() / plain.double().abs())
                                        .max()),
                   "conv_ms": conv_ms(y, y, pos, n, 32)}
            if r is not None:
                row["conv_ms"] += conv_ms(r, y, pos, n, 16)
            if has_clock:
                row.update(rd_split(so, args, want, ms, len(xs)))
            rec[n] = row
            print(name, n, json.dumps(row), flush=True)
        rec["picture_ms"] = sum(rec[n]["ms"] for n in (8, 16, 32))
        res[name] = rec
    return res


def c14(res):
    """The C14 part (see the header), into res by path."""
    so = _cuda.variant("ss_scan", "clock", cs.CLOCK_FLAGS)
    for name in PATHS:
        extra, _, _, content = cs.ISS_PATHS[name]
        frame, _ = cs.path_frame(content)
        enc = HoloEncoder(HoloConfig(width=cs.W, height=cs.H, **extra))
        stream = enc.encode_frame(*frame)
        args, work = cs._ss_scan_inputs(enc, frame)
        dargs, dwork = cs._ss_decode_inputs(stream)
        fn = lambda: ss_scan.scan_encode_iss(*args, work=work)
        want = fn()
        ms, allms = events_ms(fn)
        rec = {"encode_ms": ms, "encode_all": allms,
               "launch": ss_scan.LAST_LAUNCH,
               "groups": len(work.host_groups)}
        if name == "iss-gt-warped":
            secs = []
            for _ in range(3):
                torch.cuda.synchronize()
                t = time.perf_counter()
                enc.encode_frame(*frame)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t)
            rec["encode_s"] = float(np.median(secs))
            rec["encode_s_all"] = secs
            with Recorder() as r:
                ss_scan.scan_encode_iss_loop(*args)
            rec["entries"] = entries(r.calls)
        rec.update(split(so, fn, want, work))
        rec.update(decode_part(
            so, lambda: ss_scan.scan_decode_ss(*dargs, work=dwork),
            len(dwork.host_groups)))
        print(name, json.dumps(rec), flush=True)
        res[name] = rec
    extra = cs.ISS_PATHS["pss-gt"][0]
    enc = HoloEncoder(HoloConfig(width=cs.W, height=cs.H, **extra))
    (args, work), (dargs, dwork) = cs._pss_calls(
        enc, cs.pss_frames(cs.W, cs.H, cs.PSS_FRAMES))[-1]
    fn = lambda: ss_scan.scan_encode_pss(*args, work=work)
    want = fn()
    ms, allms = events_ms(fn)
    rec = {"encode_ms": ms, "encode_all": allms,
           "launch": ss_scan.LAST_LAUNCH, "groups": len(work.host_groups)}
    with Recorder() as r:
        ss_scan.scan_encode_pss_loop(*args)
    rec["entries"] = entries(r.calls)
    rec.update(split(so, fn, want, work, pss=True))
    rec.update(decode_part(
        so, lambda: ss_scan.scan_decode_pss(*dargs, work=dwork),
        len(dwork.host_groups)))
    print("pss-gt", json.dumps(rec), flush=True)
    res["pss-gt"] = rec


def ptxas_encode(log):
    """ptxas's report of C14's four encode kernels from the build log:
    {kernel: {registers, stack, spill_stores, spill_loads}}."""
    names = {"ss_scan_encode_kernelILb0": "iss", "ss_scan_encode_kernelILb1":
             "iss_rdoq", "ss_scan_pss_encode_kernelILb0": "pss",
             "ss_scan_pss_encode_kernelILb1": "pss_rdoq"}
    out, cur = {}, None
    for ln in log.splitlines():
        if "Function properties for" in ln or "Compiling entry" in ln:
            cur = next((v for k, v in names.items() if k in ln), None)
        elif cur is not None and "stack frame" in ln:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", ln)]
            out.setdefault(cur, {}).update(
                stack=nums[0], spill_stores=nums[1], spill_loads=nums[2])
        elif cur is not None and "Used" in ln and "registers" in ln:
            out.setdefault(cur, {})["registers"] = int(
                re.search(r"Used (\d+) registers", ln).group(1))
            cur = None
    return out


def main():
    t0 = time.perf_counter()
    _cuda.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    # ptxas's report of C14's kernels: registers, stack and spills
    report = [ln.strip() for ln in _cuda.BUILD_LOGS.get("ss_scan",
                                                        "").splitlines()
              if "ss_scan" in ln or "Used" in ln or "spill" in ln]
    print("\n".join(report), flush=True)
    ptx = ptxas_encode(_cuda.BUILD_LOGS.get("ss_scan", ""))
    print("ptxas encode kernels", json.dumps(ptx), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    res = {"card": smi, "tree": tree, "ptxas_ss_scan": report,
           "ptxas_encode": ptx}
    if "prepass" in PARTS:
        res["prepass"] = prepass()
    if "c14" in PARTS:
        c14(res)
    if OUT is not None:
        with open(OUT, "w") as f:
            json.dump(res, f)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
